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

A multiple-try step returns an ``MtmState``: the state, and beside it the
record of the move that made it (``MtmState.record``). The record is not
part of what the next step reads: a chain runner keeps ``carried()`` (the
plain ``MCMCState``) in its buffers, so a chain of multiple-try and MH
branches carries one structure whichever branch steps. A chain whose
collected variables name ``RECORD`` also collects the record each step, as
``mtm_<field>`` rows (``MtmState.rows``), so that a check can judge every
move's selection and acceptance from what the chain produced; every step of
such a chain has to be a multiple-try move.

While telemetry counts, a move reports ``("mtm_move", <proposal>)`` once
and ``("mtm_poses", "tries" | "reference")`` with the poses each of its
two launches scores; under the profiler the selection and the reference
set are the ranges ``bpe.mtm.select`` and ``bpe.mtm.reference``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .. import telemetry
from ..graph import sample_graph
from ..posterior import retemper
from ..proposals import apply_draws, transition_probability
from ..samples import Sample
from .mh import MCMCState, init_at_zero

__all__ = ["MultipleTry", "MtmState", "RECORD", "gumbel_index", "gumbel_noise",
           "multiple_try_ratio", "accepts"]

RECORD = "mtm"  # named among a chain's collected variables, it collects the move record


@dataclass(frozen=True)
class MtmState(MCMCState):
    """An MCMC state with the record of the move that made it: ``record``
    maps ``try_<variable>`` [T, N, ...] and ``try_log_prob`` [T, N] (the
    tries and their tempered log densities), ``ref_<variable>`` and
    ``ref_log_prob`` (the reference set's T - 1 auxiliary tries, without the
    previous state), ``m`` [] (the try count), ``gumbel`` [T, N], ``index``
    [N] (the selected try), ``log_alpha`` [N] and ``u`` [N] (the uniforms)
    to tensors; zeros before the first move."""

    record: dict

    def carried(self) -> MCMCState:
        """What the next step reads: the state without the record."""
        return MCMCState(self.sample, self.temperature)

    def rows(self, var_names) -> dict:
        """The record as collected rows ``mtm_<key>`` where ``var_names``
        names ``RECORD`` (the tries' and the reference set's variables only
        where it names them), else none."""
        if RECORD not in var_names:
            return {}
        out = {}
        for k, v in self.record.items():
            head, _, name = k.partition("_")
            if head in ("try", "ref") and name != "log_prob" and name not in var_names:
                continue
            out["mtm_" + k] = v
        return out


def gumbel_noise(generator: torch.Generator, shape, dtype=torch.float32):
    """Standard Gumbel draws -log(-log u), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(dtype).tiny)))


def gumbel_index(noise, log_weights, axis=0):
    """Gumbel-max categorical draw in the log domain, given the Gumbel
    ``noise`` of ``log_weights``' shape."""
    return torch.argmax(log_weights + noise, dim=axis)


def multiple_try_ratio(try_weights, reference_weights):
    """log α [N] = LSE over the tries' weights [T, N] - LSE over the
    reference set's [T, N] (the previous state in its last row)."""
    return torch.logsumexp(try_weights, dim=0) - torch.logsumexp(reference_weights, dim=0)


def accepts(u, log_alpha):
    """The MH test of the move: log u <= log α, per chain."""
    return torch.log(u) <= log_alpha


def _label(proposal) -> str:
    names = getattr(proposal, "names", ())
    return " ".join(("+".join(names), getattr(proposal, "kind", type(proposal).__name__)))


@dataclass(frozen=True, eq=False)
class MultipleTry:
    proposal: Any
    n_tries: int
    temp_schedule: Any

    def init(self, rngs, model, n_particles: int):
        sample, state = init_at_zero(rngs, model, n_particles)
        return sample, MtmState(state.sample, state.temperature, self.empty_record(sample))

    def empty_record(self, sample: Sample) -> dict:
        """A move's record of zeros for chains in the state of ``sample``."""
        t, lp = self.n_tries, sample.log_prob
        rec = {}
        for head, k in (("try", t), ("ref", t - 1)):
            rec.update({f"{head}_{name}": v.new_zeros((k, *v.shape))
                        for name, v in sample.variables.items()})
            rec[f"{head}_log_prob"] = lp.new_zeros((k, *lp.shape))
        idx = torch.zeros(lp.shape, dtype=torch.int64, device=lp.device)
        rec.update(m=idx.new_zeros(()), gumbel=lp.new_zeros((t, *lp.shape)), index=idx,
                   log_alpha=lp.new_zeros(lp.shape), u=lp.new_zeros(lp.shape))
        return rec

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
        uniforms [N]. Returns the new sample and an ``MtmState`` with this
        move's record."""
        new_temp = self.temp_schedule.increment(state.temperature)
        prev = retemper(state.sample, state.temperature, new_temp)
        record = {}
        selected, log_alpha = self.select(model, prev, new_temp, m, tries, gumbel, aux, record)
        accept = accepts(u, log_alpha)

        def sel(a, b):
            return torch.where(accept.reshape(accept.shape + (1,) * (a.dim() - 1)), a, b)

        result = Sample({k: sel(selected.variables[k], v) for k, v in prev.variables.items()},
                        torch.where(accept, selected.log_prob, prev.log_prob),
                        torch.where(accept, selected.log_like, prev.log_like))
        record.update(m=m, gumbel=gumbel, log_alpha=log_alpha, u=u)
        return result, MtmState(result, new_temp, record)

    def select(self, model, prev: Sample, new_temp, m, tries: dict, gumbel, aux: dict,
               record=None):
        """(selected sample [N], log α [N]) of a step from the re-tempered
        previous sample, given the step's draws as ``move`` takes them;
        ``record``, a dict, receives the tries, the reference set and the
        selected index."""
        t = self.n_tries
        proposal = self.proposal
        names = proposal.names
        dev = prev.log_prob.device
        n = prev.log_prob.shape[0]
        chain = torch.arange(n, device=dev)
        steps = torch.arange(t, device=dev)
        neg_inf = torch.full((), -torch.inf, device=dev)
        zero = torch.zeros((), device=dev)
        telemetry.count(("mtm_move", _label(proposal)))

        with telemetry.profiled("mtm.select"):
            # T tries per chain, weighted; tries >= m are masked out
            pro = self._broadcast_untouched(apply_draws(proposal, prev, tries), t)
            telemetry.count(("mtm_poses", "tries"), t * n)
            pro = model.tempered_logdensity_sample(pro, new_temp, batch_ndim=2)
            pro_weights = (pro.log_prob
                           - transition_probability(proposal, pro, prev, batch_ndim=2)
                           + torch.where(steps < m, zero, neg_inf)[:, None])  # [T, N]

            # one try per chain, drawn in proportion to its weight
            idx = gumbel_index(gumbel, pro_weights, axis=0)  # [N]
            selected = Sample({k: (pro.variables[k][idx, chain] if k in names else v)
                               for k, v in prev.variables.items()},
                              pro.log_prob[idx, chain], pro.log_like[idx, chain])

        with telemetry.profiled("mtm.reference"):
            # the reference set: T-1 tries from the selected sample, and the
            # previous sample in the last slot
            ref = self._broadcast_untouched(apply_draws(proposal, selected, aux), t - 1)
            telemetry.count(("mtm_poses", "reference"), (t - 1) * n)
            ref = model.tempered_logdensity_sample(ref, new_temp, batch_ndim=2)
            ref_weights = (ref.log_prob
                           - transition_probability(proposal, ref, selected, batch_ndim=2)
                           + torch.where(steps[:-1] < m - 1, zero, neg_inf)[:, None])
            state_weight = prev.log_prob - transition_probability(proposal, prev, selected)
            ref_full = torch.cat([ref_weights, state_weight[None, :]], dim=0)  # [T, N]
            log_alpha = multiple_try_ratio(pro_weights, ref_full)
        if record is not None:
            for head, s in (("try", pro), ("ref", ref)):
                record.update({f"{head}_{k}": v for k, v in s.variables.items()})
                record[f"{head}_log_prob"] = s.log_prob
            record["index"] = idx
        return selected, log_alpha
