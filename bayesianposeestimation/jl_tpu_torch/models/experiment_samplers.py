"""Sampler factories: the named sampler configurations of the experiments.

Counterpart of ``jl_tpu/models/experiment_samplers.py``. Each composes
per-variable proposals (t symmetric random walk, r symmetric tangent-space
walk, r independent QuaternionUniform draws for exploration) through a
``ComposedSampler`` with the ``Parameters`` weights:

* ``mh_sampler`` / ``mh_local_sampler``: Metropolis-Hastings chains (with
  and without the independent r moves);
* ``mtm_sampler`` / ``mtm_local_sampler``: multiple-try chains with
  ``params.n_particles`` tries;
* ``smc_forward``, ``smc_bootstrap`` and ``smc_mh`` (the main path):
  tempered SMC with forward-proposal, bootstrap and MH kernels.
"""

from __future__ import annotations

import math

from ..distributions import Normal, QuaternionUniform
from ..graph import BroadcastedNode, sequentialize
from ..proposals import independent_proposal, symmetric_proposal
from ..samplers import (
    AdaptiveKernel,
    BootstrapKernel,
    ComposedSampler,
    ForwardProposalKernel,
    MetropolisHastings,
    MhKernel,
    MultipleTry,
    SequentialMonteCarlo,
)
from ..parameters import sigma_row
from ..tempering import LinearSchedule

__all__ = ["mh_sampler", "mh_local_sampler", "mtm_sampler", "mtm_local_sampler",
           "smc_forward", "smc_bootstrap", "smc_mh"]


def _sym_proposals(params, posterior):
    """t and r symmetric random-walk proposals (tangent space for r)."""
    t_sym = sequentialize(BroadcastedNode("t", Normal, 0.0,
                                          sigma_row(params.proposal_sigma_t, posterior.device)))
    r_sym = sequentialize(BroadcastedNode("r", Normal, 0.0,
                                          sigma_row(params.proposal_sigma_r, posterior.device)))
    return symmetric_proposal(t_sym, posterior), symmetric_proposal(r_sym, posterior)


def _r_independent(params, posterior):
    return independent_proposal(sequentialize(BroadcastedNode("r", QuaternionUniform)),
                                posterior)


def _weights(params, local):
    return ((params.w_t_sym, params.w_r_sym) if local
            else (params.w_t_sym, params.w_r_sym, params.w_r_ind))


def _proposals(params, posterior, local):
    props = _sym_proposals(params, posterior)
    return props if local else (*props, _r_independent(params, posterior))


def mh_sampler(params, posterior):
    """MH moves: t symmetric, r symmetric and r independent."""
    schedule = LinearSchedule(params.n_steps)
    return ComposedSampler(tuple(MetropolisHastings(p, schedule)
                                 for p in _proposals(params, posterior, False)),
                           _weights(params, False))


def mh_local_sampler(params, posterior):
    """MH with the local (symmetric) moves only."""
    schedule = LinearSchedule(params.n_steps)
    return ComposedSampler(tuple(MetropolisHastings(p, schedule)
                                 for p in _proposals(params, posterior, True)),
                           _weights(params, True))


def mtm_sampler(params, posterior):
    """Multiple-try moves (n_tries = params.n_particles) with independent
    exploration moves."""
    schedule = LinearSchedule(params.n_steps)
    return ComposedSampler(tuple(MultipleTry(p, params.n_particles, schedule)
                                 for p in _proposals(params, posterior, False)),
                           _weights(params, False))


def mtm_local_sampler(params, posterior):
    """Multiple-try with the local moves only."""
    schedule = LinearSchedule(params.n_steps)
    return ComposedSampler(tuple(MultipleTry(p, params.n_particles, schedule)
                                 for p in _proposals(params, posterior, True)),
                           _weights(params, True))


def _smc(params, kernel):
    return SequentialMonteCarlo(kernel, LinearSchedule(params.n_steps), params.n_particles,
                                math.log(params.relative_ess))


def _adaptive_sigmas(params, proposal, posterior):
    return {name: sigma_row(params.proposal_sigma_t, posterior.device) for name in proposal.names}


def smc_forward(params, posterior):
    """Forward-proposal kernels: adaptive t, symmetric r."""
    t_prop, r_prop = _sym_proposals(params, posterior)
    t_kernel = AdaptiveKernel(ForwardProposalKernel(t_prop),
                              _adaptive_sigmas(params, t_prop, posterior))
    samplers = tuple(_smc(params, k) for k in (t_kernel, ForwardProposalKernel(r_prop)))
    return ComposedSampler(samplers, _weights(params, True))


def smc_bootstrap(params, posterior):
    """Bootstrap kernels (the likelihood as the weight increment) for t and r."""
    samplers = tuple(_smc(params, BootstrapKernel(p))
                     for p in _sym_proposals(params, posterior))
    return ComposedSampler(samplers, _weights(params, True))


def smc_mh(params, posterior):
    """Tempered SMC with MH kernels: adaptive t, symmetric r, independent r."""
    t_prop, r_prop, r_ind = _proposals(params, posterior, False)
    t_kernel = AdaptiveKernel(MhKernel(t_prop), _adaptive_sigmas(params, t_prop, posterior))
    samplers = tuple(_smc(params, k) for k in (t_kernel, MhKernel(r_prop), MhKernel(r_ind)))
    return ComposedSampler(samplers, _weights(params, False))
