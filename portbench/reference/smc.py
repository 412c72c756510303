"""What an SMC step does to the weights, re-derived from the likelihoods.

The tempering schedule adds fp32(1/n_steps) to the temperature each step,
capped at 1. A step of tempered SMC with MH moves reweights the previous
population by (ϕ_new - ϕ_old) times its log-likelihood; a bootstrap step by
the new population's log-likelihood. The weights are then normalized, and
where log(ESS/N) falls below log(relative_ess) the population is resampled
and every weight set to 1/N."""

from __future__ import annotations

import math

import numpy as np
import torch


def temperatures(n_steps: int, count: int) -> np.ndarray:
    """The temperature after each of the first ``count`` steps (float32)."""
    inc = np.float32(1.0 / n_steps)
    out, t = np.empty(count, np.float32), np.float32(0.0)
    for k in range(count):
        t = np.float32(min(np.float32(t + inc), np.float32(1.0)))
        out[k] = t
    return out


def normalize(lw):
    denom = torch.logsumexp(lw, -1, keepdim=True)
    return torch.where(torch.isfinite(denom), lw - denom, lw)


def log_relative_ess(lw):
    return -torch.logsumexp(2.0 * lw, -1) - math.log(lw.shape[-1])


def reweight(prev_lw, increment, relative_ess):
    """(normalized weights after the step, whether the step resamples)."""
    w = normalize(prev_lw.float() + increment.float())
    resampled = bool(log_relative_ess(w) < math.log(relative_ess))
    if resampled:
        w = torch.full_like(w, -math.log(w.shape[-1]))
    return w, resampled
