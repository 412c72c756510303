"""Tracked frames of a bootstrap particle filter, one record per checked
frame: the numbers of ``track`` (``checks/track.py``) and one that judges
the frame's resample.

A bootstrap step moves each particle by the dynamics, weighs it by the
previous log-weight plus its log-likelihood ℓ, and, where the log relative
ESS falls below log(relative_ess), resamples systematically and sets every
weight to 1/N. After a resample the weights are uniform, so ``weights``
reads 0 and ``estimate`` is the plain mean on both sides whatever was drawn:
neither sees which particles the draw kept. A record holds the population
after the step, the log-weights the step started from and the step's log
relative ESS before its resample (the program's; it says whether the frame
resampled).

* ``loglike``, ``weights``, ``estimate``: as ``track``, on every checked
  frame;
* ``resample``, in nats, the largest over the checked frames of:

  - a frame that resampled: the N particles after the step are S
    distinct survivors, survivor i drawn m_i times. A systematic draw on
    weights w_i ∝ exp(p_i + ℓ_i), p_i the previous log-weight of the
    particle it came from, gives |m_i - N·w_i| < 1, and each particle that
    did not survive had N·w < 1, so the survivors' N·w sum to more than S
    and at most N. So one scale c must give m_i - 1 < c·exp(p_i + ℓ_i) <
    m_i + 1 for every survivor and S < Σ c·exp(p_i + ℓ_i) <= N; in logs,
    every bound an interval for log c. The reading is the smallest
    violation over log c of the tightest of them: half the gap between the
    largest lower and the smallest upper bound, 0 where they meet. The draw
    keeps its survivors in the order of the particles they came from, so
    p_i is known where the previous weights are uniform, or where every
    particle survived once (S = N: each at its own place); elsewhere the
    frame reads 0. A sound draw reads 0 up to ℓ's rounding; a draw that
    ignores the weights, or weights reset without a draw (each particle
    once), reads half of log(N/2) - log(1/max w), above 0 wherever the
    relative ESS was below 1/2. Weights after it not all equal read inf;
  - a frame that did not resample: how far the relative ESS of the weights
    the step must have made, normalize(previous + ℓ), falls below
    log(relative_ess), where the program kept the population.

  ℓ is the reference's likelihood of the record's particles, in float64;
  for the control, the control's own (its reading is how far the program's
  draw lies from a draw driven by the lower precision).
"""

from __future__ import annotations

import math

import torch

from .. import smc
from . import track

NUMBERS = (*track.NUMBERS, "resample")


def draw_gap(t, r, ell, previous) -> float:
    """The violation, in nats, of a systematic draw of the N particles
    ``t`` [N, 3], ``r`` [N, 4] on weights ∝ exp(``previous`` + ``ell``)
    [N] (float64). A systematic draw keeps its survivors in the order of the
    particles they came from, so where each particle survived once they
    stand at their own places; otherwise which previous weight a survivor
    carried is known only where the previous weights are uniform, and the
    reading is 0 where they are not."""
    n = t.shape[0]
    rows = torch.cat([t, r], -1).double().cpu()
    _, owner, counts = torch.unique(rows, dim=0, return_inverse=True, return_counts=True)
    m, s = counts.double(), counts.numel()
    previous = previous.double().cpu()
    if s < n and not bool((previous == previous[0]).all()):
        return 0.0
    first = torch.full((s,), n, dtype=torch.long)
    first.scatter_reduce_(0, owner, torch.arange(n), reduce="amin")
    x = (previous + ell.double().cpu())[first]
    if bool(torch.isneginf(x).all()):  # no weight at all: the draw is uniform
        x = torch.zeros_like(x)
    if not bool(torch.isfinite(x).all()):
        return math.inf
    lse = torch.logsumexp(x, 0)
    lower = torch.cat([torch.log(m - 1.0) - x, (math.log(s) - lse).reshape(1)])
    upper = torch.cat([torch.log(m + 1.0) - x, (math.log(n) - lse).reshape(1)])
    return max(0.0, 0.5 * float(lower.max() - upper.min()))


def resample_gap(rec, ell, relative_ess) -> float:
    """The ``resample`` reading of one record for the likelihoods ``ell``."""
    pop = rec["population"]
    lw, prev = pop["log_weights"].float().cpu(), rec["previous_log_weights"].float().cpu()
    threshold = torch.tensor(math.log(relative_ess), dtype=torch.float32)
    if bool(torch.as_tensor(rec["log_relative_ess"]).float().cpu() < threshold):
        if not bool((lw == lw[0]).all()):
            return math.inf
        return draw_gap(pop["t"], pop["r"], ell, prev)
    w = smc.normalize(prev.double() + ell.double().cpu())
    short = math.log(relative_ess) - float(smc.log_relative_ess(w))
    return math.inf if math.isnan(short) else max(0.0, short)


def reference(rec, mesh, cfg, device, control=False):
    """``track``'s outputs of one frame, and its resample judged by the
    reference's (or the control's) likelihoods."""
    out = track.reference(rec, mesh, cfg, device, control)
    out["resample"] = resample_gap(rec, out["ll"], cfg["relative_ess"])
    return out


def numbers(cand, ref, rec):
    """``track``'s numbers, and ``resample``: the control's own reading, the
    reference's for the program."""
    return {**track.numbers(cand, ref, rec), "resample": cand.get("resample", ref["resample"])}


def program(rec):
    return track.program(rec)
