"""BOP requests: one pose per image, tempered SMC on a crop; the estimate is
the final population's particle of highest log-likelihood.

* ``prep``: crop camera (relative), prior point (relative), and the share of
  observation and mask-prior pixels that differ;
* ``loglike``: the final population's log-likelihoods, relative to
  max(|reference|, 1);
* ``weights``: the final step's log-weights, with the reference's own
  schedule and its likelihood of the population before the step, from the
  weights that population carried (absolute, in nats); inf where the
  temperatures of the last two steps are not the schedule's;
* ``estimate``: how far the reference's likelihood of the particle the
  candidate reported falls below the reference's best, relative, or inf
  where the reported pose is not that particle.

The likelihood's epilogue is the configuration's (``cfg["epilogue"]``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import prep as prep_ref
from .. import smc
from . import crop_cam, finite_gap, loglike, observation

NUMBERS = ("prep", "loglike", "weights", "estimate")


def prepared(rec, cfg, device, rnd):
    """The request's host prep worked out again: (crop camera fields, the
    raster's camera, observation [h, w], mask prior [h, w], prior point [3],
    the observation and mask prior as the likelihood reads them)."""
    w, h = cfg["width"], cfg["height"]
    cam_f, obs, prior_o, point = prep_ref.prep(rec["depth"], rec["mask"], rec["K"],
                                               rec["diameter"], w, h, cfg["o_mask_is"],
                                               cfg["o_mask_not"], rnd)
    cam = crop_cam(cam_f, w, h, cfg["near"], cfg["far"])
    z = observation(obs, device)
    prior = torch.as_tensor(prior_o, device=device).reshape(-1)
    return cam_f, cam, obs, prior_o, point, z, prior


def prep_gap(cand, ref):
    """The ``prep`` number: crop camera and prior point (relative), and the
    share of observation and mask-prior pixels that differ."""
    cam_gap = max(abs(cand["cam"][k] - ref["cam"][k]) / max(abs(ref["cam"][k]), 1.0)
                  for k in ref["cam"])
    point_gap = float(np.max(np.abs(np.asarray(cand["point"], np.float64) - ref["point"]))
                      / max(np.max(np.abs(ref["point"])), 1e-12))
    obs_gap = float(np.mean(~((cand["obs"] == ref["obs"])
                              | (np.isnan(cand["obs"]) & np.isnan(ref["obs"])))))
    prior_gap = float(np.mean(cand["prior_o"] != ref["prior_o"]))
    return max(cam_gap, point_gap, obs_gap, prior_gap)


def reference(rec, mesh, cfg, device, control=False):
    """The reference's (or, in bfloat16, the control's) outputs for one BOP
    request record: prep, both populations' log-likelihoods, the final
    weights and the picked particle."""
    dtype, rnd = (torch.bfloat16, prep_ref.bf16) if control else (torch.float32,
                                                                  prep_ref.exact)
    cam_f, cam, obs, prior_o, point, z, prior = prepared(rec, cfg, device, rnd)
    pops = rec["populations"]
    ll = {k: loglike(mesh, cam, pops[k]["t"], pops[k]["r"], z, prior, cfg, cfg["epilogue"],
                     dtype).float() for k in ("prev", "final")}
    temps = smc.temperatures(cfg["n_steps"], rec["n_rows"])
    dphi = torch.tensor(temps[-1] - temps[-2], dtype=torch.float32, device=device)
    weights, resampled = smc.reweight(pops["prev"]["log_weights"], dphi * ll["prev"],
                                      cfg["relative_ess"])
    pick = int(torch.argmax(ll["final"]))
    return dict(cam=cam_f, obs=obs, prior_o=prior_o, point=point, ll=ll["final"],
                weights=weights, pick=pick, temperatures=temps[-2:],
                estimate=(pops["final"]["t"][pick], pops["final"]["r"][pick]))


def numbers(cand, ref, rec):
    """The four numbers of one request for a candidate's outputs."""
    final = rec["populations"]["final"]
    t, q = cand["estimate"]
    same_pose = (torch.equal(t.cpu().float(), final["t"][cand["pick"]].cpu().float())
                 and torch.equal(q.cpu().float(), final["r"][cand["pick"]].cpu().float()))
    best = float(ref["ll"][ref["pick"]])
    gap = (best - float(ref["ll"][cand["pick"]])) / max(abs(best), 1.0)
    same_schedule = np.array_equal(np.asarray(cand["temperatures"], np.float32),
                                   ref["temperatures"])
    return {"prep": prep_gap(cand, ref),
            "loglike": finite_gap(cand["ll"], ref["ll"]),
            "weights": (finite_gap(cand["weights"], ref["weights"], rel=False)
                        if same_schedule else math.inf),
            "estimate": gap if same_pose else math.inf}


def program(rec):
    """The port's outputs of one request, as the record holds them."""
    final = rec["populations"]["final"]
    return dict(cam=rec["prep"]["cam"], obs=rec["prep"]["obs"], prior_o=rec["prep"]["prior_o"],
                point=rec["prep"]["point"], ll=final["log_like"], weights=final["log_weights"],
                pick=rec["pick"], estimate=rec["estimate"], temperatures=rec["temperatures"])
