"""Particle sharding: one SMC population split over the processes of a
``torch.distributed`` group, one device each.

Counterpart of ``jl_tpu/parallel/sharded.py``. JAX annotates the particle
axis of the state and lets GSPMD place the collectives; here they are
explicit, in ``samplers/smc.py`` behind a ``ParticleShard``: each process
renders and scores its slice of the particles, the weight reductions
(evidence, normalization, ESS) and the adaptive kernel's moments are
all-reduces, and resampling all-gathers the weights and the particles (a
few floats per particle). Every process draws the whole population's random
numbers from the same seed and keeps its rows, so the sharded chain is the
unsharded one, draw for draw, up to the order of the reductions.

The backend follows the device: NCCL for CUDA tensors, gloo for CPU
tensors, and a chain refuses a group of the other backend. A particle count
the world size does not divide raises (JAX would replicate such arrays
instead). The sharded chain runs the eager step loop (``sample_chain(...,
captured=False)``): its collectives are not captured into CUDA graphs yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..samplers.chain import sample_chain
from ..samplers.composed import ComposedSampler, CoordinateSampler
from ..samplers.smc import ParticleShard, SequentialMonteCarlo, SmcState
from ..samples import Sample

__all__ = ["backend_for", "particle_group", "shard_state", "shard_sampler",
           "sharded_sample_chain"]


def backend_for(device) -> str:
    """The collective backend for tensors on ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def particle_group(device, init_method=None, rank=0, world_size=1):
    """The default process group for ``device``'s backend, initialized with
    ``init_method`` (e.g. ``tcp://localhost:<port>`` or ``file://<path>``),
    ``rank`` and ``world_size`` unless it already exists, in which case its
    backend must be the device's."""
    backend = backend_for(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, tensors on "
                           f"{device} need {backend}")
    return dist.group.WORLD


def shard_state(state: SmcState, rank: int, world: int) -> SmcState:
    """Process ``rank``'s slice of a whole population's SMC state (the
    leading particle axis of every per-particle tensor; scalars kept)."""
    shard = ParticleShard(None, rank, world, state.log_weights.shape[0])
    s = state.sample
    sample = Sample({k: shard.rows(v) for k, v in s.variables.items()},
                    None if s.log_prob is None else shard.rows(s.log_prob),
                    None if s.log_like is None else shard.rows(s.log_like))
    return SmcState(sample, shard.rows(state.log_weights), state.log_evidence,
                    state.temperature, state.log_relative_ess)


def shard_sampler(sampler, shard: ParticleShard):
    """``sampler`` with every SMC sampler in it running on ``shard``."""
    if isinstance(sampler, SequentialMonteCarlo):
        return dataclasses.replace(sampler, shard=shard)
    if isinstance(sampler, (ComposedSampler, CoordinateSampler)):
        return dataclasses.replace(
            sampler, samplers=tuple(shard_sampler(s, shard) for s in sampler.samplers))
    raise TypeError(f"{type(sampler).__name__} has no particle axis to shard")


def _gathered_state(state: SmcState, shard: ParticleShard) -> SmcState:
    s = state.sample
    sample = Sample({k: shard.gather(v) for k, v in s.variables.items()},
                    shard.gather(s.log_prob), shard.gather(s.log_like))
    return SmcState(sample, shard.gather(state.log_weights), state.log_evidence,
                    state.temperature, state.log_relative_ess)


def sharded_sample_chain(seed: int, model, sampler, n_steps, n_particles, group,
                         collect_vars=("t", "r")):
    """``sample_chain`` with the particle axis split over ``group`` (this
    process's rank and the group's size; ``model`` on this process's
    device). Returns what ``sample_chain`` returns for the whole population,
    gathered on every process: (collected per step, final state)."""
    backend = dist.get_backend(group)
    if backend != backend_for(model.device):
        raise RuntimeError(f"a {backend} group cannot reduce tensors on {model.device}")
    shard = ParticleShard(group, dist.get_rank(group), dist.get_world_size(group), n_particles)
    # eager: a step's all-reduces and all-gathers are not captured yet (the
    # NCCL collectives need a capture of their own)
    outs, state = sample_chain(seed, model, shard_sampler(sampler, shard), n_steps,
                               n_particles, collect_vars, device=model.device, captured=False)
    # per-particle outputs are [steps, particles, ...]; evidence, ESS and
    # temperature [steps] are the same on every process
    outs = {k: shard.gather(v, 1) if v.dim() >= 2 else v for k, v in outs.items()}
    return outs, _gathered_state(state, shard)
