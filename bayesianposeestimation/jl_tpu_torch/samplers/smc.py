"""Sequential Monte Carlo with likelihood tempering and systematic resampling.

Counterpart of ``jl_tpu/samplers/smc.py`` (``MhKernel``, ``AdaptiveKernel``,
``BootstrapKernel``, ``ForwardProposalKernel``, ``SequentialMonteCarlo``). Every step stays on the
device with no host synchronisation:

* systematic resampling is cumsum + ``searchsorted`` against stratified
  positions (u + i)/N, and the ESS-triggered resampling computes both paths
  and selects with ``torch.where``;
* on the card the population update after the likelihood (reweight,
  evidence, ESS, resampling and its select: ``update_population``) is one
  hand-written kernel (``ops/smc_update.py``) in place of 77-81 small ones;
  the plain version (``update_population_plain``) runs for CPU tensors and
  for a sharded step;
* an MH kernel's move after its draws (the densities, the MH test and
  select, the increment) goes through ``mh.mh_transition``, on the card one
  hand-written kernel after the render where the move allows it; the other
  kernels' moves run as they always did;
* the adaptive proposal's weighted covariance and Cholesky factor are device
  tensors; a failed factorization (``info != 0`` or non-finite) selects the
  configured σ without a branch on the host.

The functions that consume random numbers take them as arguments (``u``,
``normals``) so tests can inject the JAX package's draws; the kernels draw
them from the chain's device generator.

A ``SequentialMonteCarlo`` with a ``ParticleShard`` runs one slice of the
particle axis in each process of a ``torch.distributed`` group (see
``parallel/sharded.py``). The reductions over particles become collectives:
the log-sum-exps of the weights (evidence, normalization, ESS) an all-reduce
of the maximum and then of the sum, the adaptive kernel's weighted moments
an all-reduce of the sums, and resampling an all-gather of the weights and
particles, from which every process takes the same indices and keeps its
own slice. Every per-particle draw is made at the full N on every process
and sliced, so with the same seed the sharded chain makes the unsharded
chain's draws. Without a shard (the default) nothing of this runs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from .. import telemetry
from ..graph import sample_graph
from ..ops.smc_update import smc_update
from ..posterior import retemper
from ..proposals import Proposal, apply_draws, propose, transition_probability
from ..samples import Sample, sample_plus
from .mh import mh_kernel, mh_transition

__all__ = [
    "SmcState",
    "ParticleShard",
    "SequentialMonteCarlo",
    "MhKernel",
    "BootstrapKernel",
    "ForwardProposalKernel",
    "AdaptiveKernel",
    "adaptive_deltas",
    "systematic_resampling_indices",
    "resample_systematic",
    "maybe_resample",
    "update_population",
    "update_population_plain",
    "log_relative_ess",
    "logevidence",
    "normalize_log_weights",
]


@dataclass(frozen=True)
class SmcState:
    sample: Sample
    log_weights: Any  # [N] normalized
    log_evidence: Any  # scalar
    temperature: Any  # scalar
    log_relative_ess: Any  # scalar, log(ESS / N)


@dataclass(frozen=True)
class ParticleShard:
    """The slice [start, start + size) of an ``n_particles`` population that
    process ``rank`` of a ``torch.distributed`` group of ``world`` processes
    holds (``world`` divides ``n_particles``), and the collectives over the
    group that the SMC step needs."""

    group: Any
    rank: int
    world: int
    n_particles: int

    def __post_init__(self):
        if self.n_particles % self.world:
            raise ValueError(f"{self.n_particles} particles do not split evenly over "
                             f"{self.world} processes")

    @property
    def size(self) -> int:
        return self.n_particles // self.world

    @property
    def start(self) -> int:
        return self.rank * self.size

    def rows(self, x, axis=0):
        """This process's particles of ``x``, a tensor over all of them."""
        return x.narrow(axis, self.start, self.size)

    def all_sum(self, x):
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def logsumexp(self, x):
        """logsumexp over the last axis of ``x`` across all processes: an
        all-reduce of the maximum, then of the sum of exp(x - max)."""
        m = x.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.group)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        total = self.all_sum(torch.exp(x - m.unsqueeze(-1)).sum(-1))
        return m + torch.log(total)

    def gather(self, x, axis=0):
        """``x`` of every process, concatenated along ``axis`` in rank order."""
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=axis)


def _logsumexp(x, shard):
    return torch.logsumexp(x, dim=-1) if shard is None else shard.logsumexp(x)


def logevidence(state: SmcState):
    return state.log_evidence


def normalize_log_weights(log_weights, shard=None):
    """Log-domain normalization; an all--inf vector is left as it is."""
    denom = _logsumexp(log_weights, shard)
    return torch.where(torch.isfinite(denom), log_weights - denom, log_weights)


def log_relative_ess(log_weights, shard=None):
    """log(ESS/N) = -logsumexp(2w) - log N for normalized weights."""
    n = log_weights.shape[-1] if shard is None else shard.n_particles
    return -_logsumexp(2.0 * log_weights, shard) - math.log(n)


def systematic_resampling_indices(log_weights, u, shard=None):
    """Indices [N] (int64) for positions (u + i)/N against the normalized
    weight CDF; all-zero weights resample uniformly. ``u``: a uniform scalar.
    With a ``shard``: this process's slice of the indices into the gathered
    population, which every process computes alike."""
    if shard is not None:
        return shard.rows(systematic_resampling_indices(shard.gather(log_weights, -1), u), -1)
    n = log_weights.shape[-1]
    w = torch.exp(normalize_log_weights(log_weights))
    w = torch.where((w == 0).all(), torch.full_like(w, 1.0 / n), w)
    cdf = torch.cumsum(w, dim=-1)
    cdf = cdf / cdf[-1]
    positions = (u + torch.arange(n, dtype=w.dtype, device=w.device)) / n
    idx = torch.searchsorted(cdf, positions, side="left")
    return torch.clamp(idx, 0, n - 1)


def _gather_sample(sample: Sample, idx) -> Sample:
    return Sample({k: v[idx] for k, v in sample.variables.items()},
                  sample.log_prob[idx], sample.log_like[idx])


def _gathered_sample(sample: Sample, shard: ParticleShard) -> Sample:
    """The whole population of a sharded sample on every process: its
    per-particle tensors packed into one [n, d] tensor, gathered once."""
    fields = [*sample.variables.values(), sample.log_prob, sample.log_like]
    dtype = sample.log_like.dtype
    packed = torch.cat([f.reshape(f.shape[0], -1).to(dtype) for f in fields], dim=1)
    full = shard.gather(packed)
    out, col = [], 0
    for f in fields:
        width = f[0].numel()
        out.append(full[:, col:col + width].reshape(-1, *f.shape[1:]).to(f.dtype))
        col += width
    return Sample(dict(zip(sample.variables, out[:-2])), out[-2], out[-1])


def resample_systematic(u, state: SmcState, shard=None) -> SmcState:
    """Resample the particles with uniform ``u``; weights reset to uniform.
    With a ``shard`` each process draws its particles from the gathered
    population."""
    idx = systematic_resampling_indices(state.log_weights, u, shard)
    n = state.log_weights.shape[-1] if shard is None else shard.n_particles
    source = state.sample if shard is None else _gathered_sample(state.sample, shard)
    return SmcState(_gather_sample(source, idx),
                    torch.full_like(state.log_weights, -math.log(n)),
                    state.log_evidence, state.temperature, state.log_relative_ess)


def maybe_resample(u, state: SmcState, log_relative_ess_threshold, shard=None) -> SmcState:
    """Resample where log ESS/N is below the threshold: both paths are
    computed and selected per field, so no value leaves the device."""
    res = resample_systematic(u, state, shard)
    do = state.log_relative_ess < log_relative_ess_threshold

    def sel(a, b):
        return torch.where(do, a, b)

    sample = Sample({k: sel(res.sample.variables[k], v) for k, v in state.sample.variables.items()},
                    sel(res.sample.log_prob, state.sample.log_prob),
                    sel(res.sample.log_like, state.sample.log_like))
    return SmcState(sample, sel(res.log_weights, state.log_weights), state.log_evidence,
                    state.temperature, state.log_relative_ess)


def update_population_plain(old_state: SmcState, incr, new_sample: Sample, new_temp, u,
                            threshold, shard=None) -> SmcState:
    """The population update in plain PyTorch: the new weights (old +
    ``incr``), the evidence, the normalized weights and log(ESS/N), then
    ``maybe_resample`` with the uniform ``u`` below ``threshold``."""
    extra = {} if shard is None else {"shard": shard}
    new_weights = old_state.log_weights + incr
    new_evidence = old_state.log_evidence + _logsumexp(new_weights, shard)
    normalized = normalize_log_weights(new_weights, shard)
    new_state = SmcState(new_sample, normalized, new_evidence, new_temp,
                         log_relative_ess(normalized, shard))
    return maybe_resample(u, new_state, threshold, **extra)


def update_population(old_state: SmcState, incr, new_sample: Sample, new_temp, u, threshold,
                      shard=None) -> SmcState:
    """The SMC step's population update after the likelihood: on the card one
    launch of ``ops/smc_update.smc_update``, for CPU tensors and for a
    sharded step (collectives) ``update_population_plain``. Counts
    ``("smc_update_path", "kernel" | "plain")`` through ``telemetry.count``,
    which ``smc_update.launches`` counts the kernel's launches from."""
    if shard is not None or incr.device.type == "cpu":
        telemetry.count(("smc_update_path", "plain"))
        return update_population_plain(old_state, incr, new_sample, new_temp, u, threshold,
                                       shard)
    names = list(new_sample.variables)
    fields = [*new_sample.variables.values(), new_sample.log_prob, new_sample.log_like]
    log_weights, evidence, ess, out = smc_update(old_state.log_weights, incr,
                                                 old_state.log_evidence, u, fields, threshold)
    telemetry.count(("smc_update_path", "kernel"))
    sample = Sample(dict(zip(names, out[:-2])), out[-2], out[-1])
    return SmcState(sample, log_weights, evidence, new_temp, ess)


def _propose(generator, proposal, sample: Sample, shard):
    """``propose``; with a ``shard``, the draws of the whole population made
    and this process's rows of them applied."""
    if shard is None:
        return propose(generator, proposal, sample)
    if not isinstance(proposal, Proposal):
        raise TypeError(f"a sharded chain draws through Proposal graphs, not {proposal!r}")
    draws = sample_graph(proposal.model, generator, (shard.n_particles,))
    return apply_draws(proposal, sample, {k: shard.rows(v) for k, v in draws.items()})


def _draw(fn, shape, generator, dtype, shard):
    """``fn(shape)`` from ``generator`` with a particle axis first; with a
    ``shard``, drawn for the whole population and this process's rows kept."""
    if shard is not None:
        shape = (shard.n_particles, *shape[1:])
    x = fn(shape, generator=generator, dtype=dtype, device=generator.device)
    return x if shard is None else shard.rows(x)


class MhKernel:
    """MCMC forward kernel with the tempered-target increment (ϕ₂-ϕ₁)·ℓ_like(old)."""

    def __init__(self, proposal):
        self.proposal = proposal

    def propose(self, generator, state: SmcState, shard=None):
        return _propose(generator, self.proposal, state.sample, shard)

    def forward(self, generator, new_sample, old_sample, shard=None):
        u = _draw(torch.rand, new_sample.log_prob.shape, generator, new_sample.log_prob.dtype,
                  shard)
        return mh_kernel(u, self.proposal, new_sample, old_sample)

    def incremental_weights(self, new_sample, new_temp, old_state: SmcState):
        return (new_temp - old_state.temperature) * old_state.sample.log_like


class BootstrapKernel:
    """SIR bootstrap-filter kernel: the proposal is the prior transition, the
    proposed sample is kept, and the weight increment is its likelihood."""

    def __init__(self, proposal):
        self.proposal = proposal

    def propose(self, generator, state: SmcState, shard=None):
        return _propose(generator, self.proposal, state.sample, shard)

    def forward(self, generator, new_sample, old_sample, shard=None):
        return new_sample

    def incremental_weights(self, new_sample, new_temp, old_state: SmcState):
        return new_sample.log_like


class ForwardProposalKernel:
    """Forward-proposal L-kernel: the proposed sample is kept and the weight
    increment is the MH-ratio-like ℓ(new) + q(old|new) - ℓ(old) - q(new|old)."""

    def __init__(self, proposal):
        self.proposal = proposal

    def propose(self, generator, state: SmcState, shard=None):
        return _propose(generator, self.proposal, state.sample, shard)

    def forward(self, generator, new_sample, old_sample, shard=None):
        return new_sample

    def incremental_weights(self, new_sample, new_temp, old_state: SmcState):
        fwd = transition_probability(self.proposal, new_sample, old_state.sample)
        bwd = transition_probability(self.proposal, old_state.sample, new_sample)
        return new_sample.log_prob + bwd - old_state.sample.log_prob - fwd


def _mh_kernel_of(kernel):
    """The ``MhKernel`` that makes ``kernel``'s moves (itself, or the one an
    ``AdaptiveKernel`` proposes for), or None."""
    inner = kernel.kernel if isinstance(kernel, AdaptiveKernel) else kernel
    return inner if isinstance(inner, MhKernel) else None


def adaptive_deltas(state: SmcState, names, sigmas, quaternion_names, normals: dict,
                    shard=None):
    """Zero-centred perturbations whose covariance is the weighted particle
    covariance (AnalyticWeights correction 1/(1-Σw²), floor 1e-6), from
    standard normals ``normals[name]`` [N, d]. Quaternion variables keep the
    isotropic σ; a covariance whose Cholesky factorization fails falls back
    to diag(σ). With a ``shard`` the weighted sums run over every process."""
    w = torch.exp(normalize_log_weights(state.log_weights, shard))
    out = {}
    for name in names:
        x = state.sample.variables[name]
        sigma = torch.as_tensor(sigmas[name], dtype=x.dtype, device=x.device)
        eps = normals[name]
        if name in quaternion_names:
            out[name] = sigma * eps
            continue
        d = x.shape[-1]
        mean, sum_w2 = (w[:, None] * x).sum(0), (w * w).sum()
        if shard is not None:  # the weighted mean and Σw² in one all-reduce
            sums = shard.all_sum(torch.cat([mean, sum_w2[None]]))
            mean, sum_w2 = sums[:d], sums[d]
        xc = x - mean
        cov = (w[:, None, None] * xc[:, :, None] * xc[:, None, :]).sum(0)
        if shard is not None:
            cov = shard.all_sum(cov)
        cov = cov / torch.clamp(1.0 - sum_w2, min=1e-6)
        chol, info = torch.linalg.cholesky_ex(cov)
        ok = (info == 0) & torch.isfinite(chol).all()
        fallback = torch.eye(d, dtype=x.dtype, device=x.device) * sigma
        chol = torch.where(ok, chol, fallback)
        # eps @ chol.T, elementwise: no matrix product on the path
        out[name] = (eps[:, None, :] * chol[None, :, :]).sum(-1)
    return out


class AdaptiveKernel:
    """A kernel whose symmetric proposal step is replaced by the weighted
    particle covariance (fallback σ per variable in ``sigmas``)."""

    def __init__(self, kernel, sigmas):
        self.kernel = kernel
        self.sigmas = sigmas

    def propose(self, generator, state: SmcState, shard=None):
        proposal = self.kernel.proposal
        normals = {}
        for name in proposal.names:
            x = state.sample.variables[name]
            d = 3 if name in proposal.quaternion_names else x.shape[-1]
            normals[name] = _draw(torch.randn, (x.shape[0], d), generator, x.dtype, shard)
        extra = {} if shard is None else {"shard": shard}
        deltas = adaptive_deltas(state, proposal.names, self.sigmas,
                                 proposal.quaternion_names, normals, **extra)
        return sample_plus(state.sample, deltas, proposal.quaternion_names)

    def forward(self, generator, new_sample, old_sample, shard=None):
        return self.kernel.forward(generator, new_sample, old_sample, shard)

    def incremental_weights(self, new_sample, new_temp, old_state):
        return self.kernel.incremental_weights(new_sample, new_temp, old_state)


@dataclass(frozen=True, eq=False)
class SequentialMonteCarlo:
    kernel: Any
    temp_schedule: Any
    n_particles: int
    log_relative_ess_threshold: float
    shard: Any = None  # a ParticleShard: this process's slice of the particles

    def init(self, rngs, model, n_particles=None):
        """Importance-sampling init at ϕ₀ = 0: uniform weights, evidence 0."""
        n = self.n_particles if n_particles is None else n_particles
        shard = self.shard
        zero = torch.zeros((), dtype=torch.float32, device=rngs.device.device)
        prior = model.sample_prior(rngs.device, n)
        if shard is not None:
            if n != shard.n_particles:
                raise ValueError(f"the shard splits {shard.n_particles} particles, not {n}")
            prior = Sample({k: shard.rows(v) for k, v in prior.variables.items()})
        sample = model.tempered_logdensity_sample(prior, zero)
        log_weights = torch.full((sample.log_like.shape[0],), -math.log(n),
                                 dtype=torch.float32, device=rngs.device.device)
        state = SmcState(sample, log_weights, zero, zero, log_relative_ess(log_weights, shard))
        return state.sample, state

    def step(self, rngs, model, old_state: SmcState):
        gen = rngs.device
        shard = self.shard
        # the unsharded step calls each kernel and helper as it always did
        extra = {} if shard is None else {"shard": shard}
        new_temp = self.temp_schedule.increment(old_state.temperature)
        proposed = self.kernel.propose(gen, old_state, **extra)
        mh = _mh_kernel_of(self.kernel)
        if mh is not None:
            # the MH move and its increment (ϕ₂-ϕ₁)·ℓ_like(old), which
            # MhKernel.forward and incremental_weights compute
            old = old_state.sample
            u = _draw(torch.rand, old.log_prob.shape, gen, old.log_prob.dtype, shard)
            new_sample, incr = mh_transition(model, mh.proposal, proposed, old,
                                             old_state.temperature, new_temp, u,
                                             increment=True, shard=shard)
        else:
            proposed = model.tempered_logdensity_sample(proposed, new_temp)
            # the forward kernel targets π_ϕnew: re-temper the old sample's
            # carried density (no re-render)
            old_retempered = retemper(old_state.sample, old_state.temperature, new_temp)
            new_sample = self.kernel.forward(gen, proposed, old_retempered, **extra)
            incr = self.kernel.incremental_weights(new_sample, new_temp, old_state)
        dtype = torch.result_type(old_state.log_weights, incr)
        u = torch.rand((), generator=gen, dtype=dtype, device=gen.device)
        resampled = update_population(old_state, incr, new_sample, new_temp, u,
                                      self.log_relative_ess_threshold, shard)
        return resampled.sample, resampled
