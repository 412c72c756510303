"""Tracked frames: a particle filter over a clip, one record per checked
frame.

* ``loglike``: the frame's log-likelihoods against its observation,
  relative to max(|reference|, 1);
* ``weights``: the frame's log-weights with the reference's likelihood put
  in place of the step's last increment (uniform weights, a resampled
  frame, are taken as they are);
* ``estimate``: the reported estimate against the weighted mean and chordal
  mean of the reference weights: the larger of the translation gap relative
  to the estimate's distance and the rotation gap in radians.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import estimate as est
from .. import smc
from . import finite_gap, loglike, observation

NUMBERS = ("loglike", "weights", "estimate")


def reference(rec, mesh, cfg, device, control=False):
    """The reference's (or control's) likelihoods, weights and estimate of one
    tracked frame."""
    dtype = torch.bfloat16 if control else torch.float32
    cam = cfg["camera"]
    z = observation(rec["obs"], device)
    pop = rec["population"]
    ll = loglike(mesh, cam, pop["t"], pop["r"], z, cfg["o_prior"], cfg, "fixed_o",
                 dtype).float()
    lw = pop["log_weights"].float()
    uniform = bool((lw == lw[0]).all())
    w = lw if uniform else smc.normalize(lw - pop["log_like"].float() + ll)
    est_t, est_q = est.weighted_pose(w, pop["t"], pop["r"])
    return dict(ll=ll, weights=w, estimate=(est_t, est_q))


def numbers(cand, ref, rec):
    t_c, q_c = cand["estimate"]
    t_r, q_r = ref["estimate"]
    t_c = torch.as_tensor(np.asarray(t_c, np.float64) if not torch.is_tensor(t_c) else t_c)
    q_c = torch.as_tensor(np.asarray(q_c, np.float64) if not torch.is_tensor(q_c) else q_c)
    t_gap = float((t_c.double().cpu() - t_r.double().cpu()).norm()
                  / t_r.double().cpu().norm().clamp(min=1e-12))
    r_gap = est.rotation_gap(q_c.cpu(), q_r.cpu())
    gap = max(t_gap, r_gap)
    return {"loglike": finite_gap(cand["ll"], ref["ll"]),
            "weights": finite_gap(cand["weights"], ref["weights"], rel=False),
            "estimate": gap if math.isfinite(gap) else math.inf}


def program(rec):
    pop = rec["population"]
    return dict(ll=pop["log_like"], weights=pop["log_weights"], estimate=rec["estimate"])
