"""Chain runner: init plus ``n_steps - 1`` steps, outputs stacked per step.

Counterpart of ``jl_tpu/samplers/chain.py``, where the whole chain is one
compiled device program. Here ``sample_chain`` runs the chain through a
``capture.ChainRunner``: on the card each step is one replay of a captured
CUDA graph (one per branch of a ``ComposedSampler``), cached on the model
per (sampler, particle count, collected variables) as ``jax.jit`` caches a
compile, so a second chain on the same model and sampler captures nothing.
On the CPU the same static-buffer step runs eagerly. ``captured=False``
runs the plain eager loop instead: each step a Python call whose tensors
stay on the device (the host only picks sub-samplers), which a chain whose
step cannot be captured (the sharded chain's collectives) and the
captured-versus-eager checks use.
"""

from __future__ import annotations

import weakref

import torch

from ..capture import ChainRunner
from ..devices import resolve_device
from ..rngs import Rngs
from .mh import MCMCState
from .smc import SmcState

__all__ = ["sample_chain", "smc_inference", "collect_variables", "chain_runner"]


def collect_variables(sample_or_state, var_names=("t", "r")):
    """Thin a sample or state to the named variables and the densities, plus
    the weights, evidence and temperature of an SMC state."""
    state = sample_or_state
    s = state.sample if isinstance(state, (SmcState, MCMCState)) else state
    out = {**{k: s.variables[k] for k in var_names if k in s.variables},
           "log_prob": s.log_prob, "log_like": s.log_like}
    if isinstance(state, SmcState):
        out.update(log_weights=state.log_weights, log_evidence=state.log_evidence,
                   log_relative_ess=state.log_relative_ess, temperature=state.temperature)
    return out


def chain_runner(model, sampler, n_particles=None, collect_vars=("t", "r"), device=None):
    """The captured runner of ``sampler`` on ``model`` (on the model's
    device), made once per (sampler, n_particles, collect_vars) and cached on
    the model, whose lifetime it shares."""
    dev = resolve_device(model.device if device is None else device)
    key = (sampler, n_particles, tuple(collect_vars))
    cache = vars(model).setdefault("_chain_runners", {})
    if key not in cache:  # the model held weakly: the model holds the runner
        cache[key] = ChainRunner(sampler, weakref.ref(model), dev, n_particles, collect_vars)
    return cache[key]


def sample_chain(seed: int, model, sampler, n_steps, n_particles=None,
                 collect_vars=("t", "r"), device="cuda", collect_every=1, n_burn_in=0,
                 captured=True):
    """Run init + (n_steps-1) steps; returns (collected, final_state).

    ``collected`` stacks ``collect_variables`` outputs along a leading axis:
    of the n_steps-1 steps, the first ``n_burn_in`` are dropped and then every
    ``collect_every``-th is kept. Random numbers come from
    ``Rngs.from_seed(seed, device)``; ``model`` must live on ``device``.
    ``captured`` (the default) steps through the cached ``chain_runner``;
    ``captured=False`` runs the eager loop. Both draw the same numbers."""
    dev = resolve_device(device)
    if torch.device(model.device).type != dev.type:
        raise ValueError(f"model is on {model.device}, chain asked for {dev}")
    if captured:
        return chain_runner(model, sampler, n_particles, collect_vars, dev).run(
            seed, n_steps, collect_every, n_burn_in)
    rngs = Rngs.from_seed(seed, dev)
    _, state = sampler.init(rngs, model, n_particles)
    outs = []
    for i in range(n_steps - 1):
        _, state = sampler.step(rngs, model, state)
        if i >= n_burn_in and (i - n_burn_in) % collect_every == 0:
            outs.append(collect_variables(state, collect_vars))
    keys = outs[0].keys() if outs else ()
    return {k: torch.stack([o[k] for o in outs]) for k in keys}, state


def smc_inference(seed: int, posterior, sampler, params, collect_vars=("t", "r"),
                  device="cuda"):
    """``sample_chain`` for ``params.n_steps`` steps of ``params.n_particles``."""
    return sample_chain(seed, posterior, sampler, params.n_steps, params.n_particles,
                        collect_vars, device)
