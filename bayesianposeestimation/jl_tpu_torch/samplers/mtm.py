"""Multiple-Try Metropolis: an importance-weighted pick among n_tries.

Counterpart of ``jl_tpu/samplers/mtm.py``. Tensors are [n_tries, n_chains,
...]: the tries of every chain go through one kernel launch (the posterior
flattens the two batch dims). Martino's random try count m in [2, n_tries]
is a device draw that becomes a mask (tries >= m get weight -inf), so the
step never waits for the host. The auxiliary (reference) set is n_tries - 1
tries from the selected sample plus the previous sample.

``step`` draws every random number of the step from the chain's device
generator up front (the proposal graph's draws do not depend on the sample
they move) and hands them to ``move``, which a test can call with given
numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..graph import sample_graph
from ..posterior import retemper
from ..proposals import apply_draws, transition_probability
from ..samples import Sample
from .mh import MCMCState, init_at_zero

__all__ = ["MultipleTry", "gumbel_index", "gumbel_noise"]


def gumbel_noise(generator: torch.Generator, shape, dtype=torch.float32):
    """Standard Gumbel draws -log(-log u), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(dtype).tiny)))


def gumbel_index(noise, log_weights, axis=0):
    """Gumbel-max categorical draw in the log domain, given the Gumbel
    ``noise`` of ``log_weights``' shape."""
    return torch.argmax(log_weights + noise, dim=axis)


@dataclass(frozen=True, eq=False)
class MultipleTry:
    proposal: Any
    n_tries: int
    temp_schedule: Any

    def init(self, rngs, model, n_particles: int):
        return init_at_zero(rngs, model, n_particles)

    def _broadcast_untouched(self, s: Sample, t: int) -> Sample:
        """The proposed variables carry the try axis [T, N, ...]; the others
        are broadcast to it (a view, once)."""
        names = self.proposal.names
        return Sample({k: (v if k in names else v.expand(t, *v.shape))
                       for k, v in s.variables.items()})

    def step(self, rngs, model, state: MCMCState):
        gen = rngs.device
        t = self.n_tries
        n = state.sample.log_prob.shape[0]
        dtype = state.sample.log_prob.dtype
        m = torch.randint(2, t + 1, (), generator=gen, device=gen.device)
        tries = sample_graph(self.proposal.model, gen, (t, n))
        gumbel = gumbel_noise(gen, (t, n), dtype)
        aux = sample_graph(self.proposal.model, gen, (t - 1, n))
        u = torch.rand((n,), generator=gen, dtype=dtype, device=gen.device)
        return self.move(model, state, m, tries, gumbel, aux, u)

    def move(self, model, state: MCMCState, m, tries: dict, gumbel, aux: dict, u):
        """One MTM step given its draws: the try count ``m`` (a device
        scalar), the proposal graph's values for the tries [T, N, ...] and
        for the auxiliary tries [T-1, N, ...], Gumbel noise [T, N] and
        uniforms [N]."""
        new_temp = self.temp_schedule.increment(state.temperature)
        prev = retemper(state.sample, state.temperature, new_temp)
        selected, log_alpha = self.select(model, prev, new_temp, m, tries, gumbel, aux)
        accept = torch.log(u) <= log_alpha

        def sel(a, b):
            return torch.where(accept.reshape(accept.shape + (1,) * (a.dim() - 1)), a, b)

        result = Sample({k: sel(selected.variables[k], v) for k, v in prev.variables.items()},
                        torch.where(accept, selected.log_prob, prev.log_prob),
                        torch.where(accept, selected.log_like, prev.log_like))
        return result, MCMCState(result, new_temp)

    def select(self, model, prev: Sample, new_temp, m, tries: dict, gumbel, aux: dict):
        """(selected sample [N], log α [N]) of a step from the re-tempered
        previous sample, given the step's draws as ``move`` takes them."""
        t = self.n_tries
        proposal = self.proposal
        names = proposal.names
        dev = prev.log_prob.device
        chain = torch.arange(prev.log_prob.shape[0], device=dev)
        steps = torch.arange(t, device=dev)
        neg_inf = torch.full((), -torch.inf, device=dev)
        zero = torch.zeros((), device=dev)

        # T tries per chain, weighted; tries >= m are masked out
        pro = self._broadcast_untouched(apply_draws(proposal, prev, tries), t)
        pro = model.tempered_logdensity_sample(pro, new_temp, batch_ndim=2)
        pro_weights = (pro.log_prob - transition_probability(proposal, pro, prev, batch_ndim=2)
                       + torch.where(steps < m, zero, neg_inf)[:, None])  # [T, N]

        # one try per chain, drawn in proportion to its weight
        idx = gumbel_index(gumbel, pro_weights, axis=0)  # [N]
        selected = Sample({k: (pro.variables[k][idx, chain] if k in names else v)
                           for k, v in prev.variables.items()},
                          pro.log_prob[idx, chain], pro.log_like[idx, chain])

        # the reference set: T-1 tries from the selected sample, and the
        # previous sample in the last slot
        ref = self._broadcast_untouched(apply_draws(proposal, selected, aux), t - 1)
        ref = model.tempered_logdensity_sample(ref, new_temp, batch_ndim=2)
        ref_weights = (ref.log_prob
                       - transition_probability(proposal, ref, selected, batch_ndim=2)
                       + torch.where(steps[:-1] < m - 1, zero, neg_inf)[:, None])
        state_weight = prev.log_prob - transition_probability(proposal, prev, selected)
        ref_full = torch.cat([ref_weights, state_weight[None, :]], dim=0)  # [T, N]
        log_alpha = torch.logsumexp(pro_weights, dim=0) - torch.logsumexp(ref_full, dim=0)
        return selected, log_alpha
