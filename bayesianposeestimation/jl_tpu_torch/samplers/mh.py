"""Metropolis-Hastings: accept/reject over the chain batch, and the MH sampler.

Counterpart of ``jl_tpu/samplers/mh.py``. The uniforms are an argument of
``mh_kernel``, ``mh_transition`` and ``MetropolisHastings.transition``, so a
test can hand both packages the same numbers; ``step`` draws them (and the
proposal) from the chain's device generator. Rejection is a branch-free
``torch.where``.

The move after its draws (``mh_transition``: the proposal's densities, the
previous sample re-tempered, the MH test and its select, and for SMC the
weight increment) is on the card one hand-written kernel after the render
(``ops/mh_move.py``) in place of 39-49 small ones, where the step can see
that the kernel computes what the plain version (``mh_transition_plain``)
would: CUDA tensors, no shard, a ``FusedPosterior`` with the point prior and
the npixel likelihood (``FusedPosterior.move_prior``), a proposal whose
transition terms are constants (symmetric, or independent QuaternionUniform
draws), t and r alone. Every other move runs the plain version.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Any

import torch

from .. import telemetry
from ..distributions import QuaternionUniform
from ..graph import BroadcastedNode
from ..ops.mh_move import mh_move
from ..posterior import retemper
from ..proposals import Proposal, propose, transition_probability
from ..samples import Sample

__all__ = ["MCMCState", "MetropolisHastings", "acceptance_ratio", "select_sample",
           "mh_kernel", "mh_transition", "mh_transition_plain", "mh_move_path"]


@dataclass(frozen=True)
class MCMCState:
    sample: Sample
    temperature: Any  # scalar tensor


def acceptance_ratio(proposal, proposed: Sample, previous: Sample):
    """log α = ℓ(prop) - ℓ(prev) + q(prev|prop) - q(prop|prev)."""
    return (proposed.log_prob - previous.log_prob
            + transition_probability(proposal, previous, proposed)
            - transition_probability(proposal, proposed, previous))


def select_sample(accept: torch.Tensor, proposed: Sample, previous: Sample) -> Sample:
    """Per-particle select: proposed where ``accept`` [N], else previous."""

    def sel(prop, prev):
        return torch.where(accept.reshape(accept.shape + (1,) * (prop.dim() - accept.dim())),
                           prop, prev)

    variables = {k: (sel(v, previous.variables[k]) if k in previous.variables else v)
                 for k, v in proposed.variables.items()}
    return Sample(variables, torch.where(accept, proposed.log_prob, previous.log_prob),
                  torch.where(accept, proposed.log_like, previous.log_like))


def mh_kernel(u: torch.Tensor, proposal, proposed: Sample, previous: Sample) -> Sample:
    """MH transition given uniforms ``u`` [N]: accept where log u <= log α."""
    return select_sample(torch.log(u) <= acceptance_ratio(proposal, proposed, previous),
                         proposed, previous)


def mh_transition_plain(model, proposal, proposed: Sample, previous: Sample, old_temp, new_temp,
                        u, increment=False):
    """The MH move after its draws in plain PyTorch: ``proposed`` (no
    densities yet) evaluated at ``new_temp``, ``previous`` (evaluated at
    ``old_temp``) re-tempered to it, ``mh_kernel`` with the uniforms ``u``
    [N]. Returns (the accepted sample, the SMC weight increment (ϕ' - ϕ) ·
    ℓ_like(previous) with ``increment``, else None)."""
    proposed = model.tempered_logdensity_sample(proposed, new_temp)
    result = mh_kernel(u, proposal, proposed, retemper(previous, old_temp, new_temp))
    return result, ((new_temp - old_temp) * previous.log_like if increment else None)


# proposal -> its constant transition terms (log q(prev | prop), log q(prop | prev)),
# or None where they vary from particle to particle
_CONSTANT_TERMS = weakref.WeakKeyDictionary()


def _constant_terms(proposal):
    """The two transition terms of ``acceptance_ratio`` as host numbers where
    they are the same for every particle: 0 for a symmetric proposal, the
    density for independent QuaternionUniform draws (the plain function's
    own fp32 value); None for any other proposal."""
    if not isinstance(proposal, Proposal):
        return None
    if proposal.kind == "symmetric":
        return 0.0, 0.0
    if proposal.kind != "independent" or not all(
            type(node) is BroadcastedNode and node.dist_fn is QuaternionUniform
            and not node.args and node._bijector is None for node in proposal.model.values()):
        return None
    if proposal not in _CONSTANT_TERMS:
        one = Sample({name: torch.tensor([[1.0, 0.0, 0.0, 0.0]]) for name in proposal.names})
        q = float(transition_probability(proposal, one, one)[0])
        _CONSTANT_TERMS[proposal] = (q, q)
    return _CONSTANT_TERMS[proposal]


def mh_move_path(model, proposal, proposed: Sample, previous: Sample, u, shard=None) -> str:
    """``"kernel"`` where ``ops/mh_move.mh_move`` computes this move as the
    plain version would (see the module's docstring), else ``"plain"``."""
    prior = getattr(model, "move_prior", None)
    if (shard is not None or u.device.type != "cuda" or prior is None
            or _constant_terms(proposal) is None
            or set(proposed.variables) != {"t", "r"} or set(previous.variables) != {"t", "r"}):
        return "plain"
    tensors = (*proposed.variables.values(), *previous.variables.values(),
               previous.log_prob, previous.log_like, u, *prior)
    if any(x.dtype != torch.float32 or x.device != u.device for x in tensors):
        return "plain"
    return "kernel"


def mh_transition(model, proposal, proposed: Sample, previous: Sample, old_temp, new_temp, u,
                  increment=False, shard=None):
    """``mh_transition_plain``'s move, on the card as one launch of
    ``ops/mh_move.mh_move`` after the render where ``mh_move_path`` allows it.
    Counts ``("mh_move_path", "kernel" | "plain")`` through
    ``telemetry.count``, which ``mh_move.launches`` counts the kernel's
    launches from."""
    if mh_move_path(model, proposal, proposed, previous, u, shard) == "plain":
        telemetry.count(("mh_move_path", "plain"))
        return mh_transition_plain(model, proposal, proposed, previous, old_temp, new_temp, u,
                                   increment)
    ell_raw, sum_o = model.render(proposed)
    prior_t, sigma_t = model.move_prior
    q_backward, q_forward = _constant_terms(proposal)
    prop, prev = proposed.variables, previous.variables
    t, r, log_prob, log_like, incr = mh_move(
        ell_raw, sum_o, prop["t"].contiguous(), prop["r"].contiguous(),
        prev["t"].contiguous(), prev["r"].contiguous(), previous.log_prob.contiguous(),
        previous.log_like.contiguous(), u, old_temp, new_temp, prior_t, sigma_t,
        model.params.c_reg, q_backward, q_forward, increment)
    telemetry.count(("mh_move_path", "kernel"))
    out = {"t": t, "r": r}
    return Sample({k: out[k] for k in proposed.variables}, log_prob, log_like), incr


def init_at_zero(rngs, model, n_particles: int):
    """A prior sample evaluated at temperature 0, and its MCMC state."""
    zero = torch.zeros((), dtype=torch.float32, device=rngs.device.device)
    sample = model.tempered_logdensity_sample(model.sample_prior(rngs.device, n_particles), zero)
    return sample, MCMCState(sample, zero)


@dataclass(frozen=True, eq=False)
class MetropolisHastings:
    """A batch of independent MH chains that differ only in their proposal."""

    proposal: Any
    temp_schedule: Any

    def init(self, rngs, model, n_particles: int):
        return init_at_zero(rngs, model, n_particles)

    def step(self, rngs, model, state: MCMCState):
        gen = rngs.device
        new_temp = self.temp_schedule.increment(state.temperature)
        previous = state.sample
        proposed = propose(gen, self.proposal, previous)
        u = torch.rand(previous.log_prob.shape, generator=gen, dtype=previous.log_prob.dtype,
                       device=gen.device)
        return self.transition(model, previous, proposed, u, state.temperature, new_temp)

    def transition(self, model, previous: Sample, proposed: Sample, u, old_temp, new_temp):
        """The step after its draws: ``proposed`` (no densities yet) from
        ``previous`` (at ``old_temp``), accepted against the uniforms ``u``
        [N]; the previous sample's density is re-tempered to ``new_temp``, so
        both sides of the ratio target the same tempered posterior."""
        result, _ = mh_transition(model, self.proposal, proposed, previous, old_temp, new_temp,
                                  u)
        return result, MCMCState(result, new_temp)
