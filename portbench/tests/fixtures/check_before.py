"""``portbench/reference/check.py`` as it was before each check kind became a
file of its own (its imports made absolute), kept frozen: the ``bop`` and
``track`` kinds' numbers are held equal to this arithmetic's
(``test_portbench_check_kinds.py``).

The numbers that decide ``correct``: what the timed path produced, held
against the plain reference worked out again from the same raw inputs.

A candidate is either the port (its outputs as the window produced them) or
the lower-precision control (the reference in bfloat16 put in the port's
place). Every number is a largest gap over the requests checked; a
non-finite value where the reference is finite (or the reverse) reads inf.

BOP requests (one pose per image, SMC on a crop):

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

Tracked frames (a particle filter over a clip):

* ``loglike`` as above, against the frame's observation;
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

from portbench.reference import estimate as est
from portbench.reference import prep as prep_ref
from portbench.reference import raster, smc
from portbench.reference.score import image_loglike

NUMBERS = {"bop": ("prep", "loglike", "weights", "estimate"),
           "track": ("loglike", "weights", "estimate")}


def _finite_gap(a, b, rel=True):
    a, b = a.double(), b.double()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        return math.inf
    if not bool(fa.any()):
        return 0.0
    d = (a - b).abs()[fa]
    if rel:
        d = d / b.abs()[fa].clamp(min=1.0)
    return float(d.max())


def _crop_cam(cam_fields, width, height, near, far):
    return raster.camera_scalars(cam_fields["f_x"], cam_fields["f_y"], cam_fields["c_x"],
                                 cam_fields["c_y"], cam_fields["s"], width, height, near, far)


def _loglike(mesh, cam, t, q, z, prior_o, p, epilogue, dtype):
    verts, faces = mesh
    mu = raster.render_depth(verts, faces, cam, t, q, dtype=dtype)
    return image_loglike(mu, z, prior_o, p, epilogue, dtype)


def _observation(obs, device):
    z = torch.as_tensor(np.asarray(obs, np.float32), device=device).reshape(-1)
    return torch.where(z <= 0, torch.full_like(z, torch.inf), z)


def bop_outputs(rec, mesh, cfg, device, dtype=torch.float32, rnd=prep_ref.exact):
    """The reference's (or, in bfloat16, the control's) outputs for one BOP
    request record: prep, both populations' log-likelihoods, the final
    weights and the picked particle."""
    w, h = cfg["width"], cfg["height"]
    cam_f, obs, prior_o, point = prep_ref.prep(rec["depth"], rec["mask"], rec["K"],
                                               rec["diameter"], w, h, cfg["o_mask_is"],
                                               cfg["o_mask_not"], rnd)
    cam = _crop_cam(cam_f, w, h, cfg["near"], cfg["far"])
    z = _observation(obs, device)
    prior = torch.as_tensor(prior_o, device=device).reshape(-1)
    pops = rec["populations"]
    ll = {k: _loglike(mesh, cam, pops[k]["t"], pops[k]["r"], z, prior, cfg, "association",
                      dtype).float() for k in ("prev", "final")}
    temps = smc.temperatures(cfg["n_steps"], rec["n_rows"])
    dphi = torch.tensor(temps[-1] - temps[-2], dtype=torch.float32, device=device)
    weights, resampled = smc.reweight(pops["prev"]["log_weights"], dphi * ll["prev"],
                                      cfg["relative_ess"])
    pick = int(torch.argmax(ll["final"]))
    return dict(cam=cam_f, obs=obs, prior_o=prior_o, point=point, ll=ll["final"],
                weights=weights, pick=pick, temperatures=temps[-2:],
                estimate=(pops["final"]["t"][pick], pops["final"]["r"][pick]))


def bop_numbers(cand, ref, rec):
    """The four numbers of one request for a candidate's outputs."""
    cam_gap = max(abs(cand["cam"][k] - ref["cam"][k]) / max(abs(ref["cam"][k]), 1.0)
                  for k in ref["cam"])
    point_gap = float(np.max(np.abs(np.asarray(cand["point"], np.float64) - ref["point"]))
                      / max(np.max(np.abs(ref["point"])), 1e-12))
    obs_gap = float(np.mean(~((cand["obs"] == ref["obs"])
                              | (np.isnan(cand["obs"]) & np.isnan(ref["obs"])))))
    prior_gap = float(np.mean(cand["prior_o"] != ref["prior_o"]))
    final = rec["populations"]["final"]
    t, q = cand["estimate"]
    same_pose = (torch.equal(t.cpu().float(), final["t"][cand["pick"]].cpu().float())
                 and torch.equal(q.cpu().float(), final["r"][cand["pick"]].cpu().float()))
    best = float(ref["ll"][ref["pick"]])
    gap = (best - float(ref["ll"][cand["pick"]])) / max(abs(best), 1.0)
    same_schedule = np.array_equal(np.asarray(cand["temperatures"], np.float32),
                                   ref["temperatures"])
    return {"prep": max(cam_gap, point_gap, obs_gap, prior_gap),
            "loglike": _finite_gap(cand["ll"], ref["ll"]),
            "weights": (_finite_gap(cand["weights"], ref["weights"], rel=False)
                        if same_schedule else math.inf),
            "estimate": gap if same_pose else math.inf}


def bop_program_outputs(rec):
    """The port's outputs of one request, as the record holds them."""
    final = rec["populations"]["final"]
    return dict(cam=rec["prep"]["cam"], obs=rec["prep"]["obs"], prior_o=rec["prep"]["prior_o"],
                point=rec["prep"]["point"], ll=final["log_like"], weights=final["log_weights"],
                pick=rec["pick"], estimate=rec["estimate"], temperatures=rec["temperatures"])


def track_outputs(rec, mesh, cfg, device, dtype=torch.float32, prog_ll=None, prog_w=None):
    """The reference's (or control's) likelihoods, weights and estimate of one
    tracked frame."""
    cam = cfg["camera"]
    z = _observation(rec["obs"], device)
    pop = rec["population"]
    ll = _loglike(mesh, cam, pop["t"], pop["r"], z, cfg["o_prior"], cfg, "fixed_o",
                  dtype).float()
    lw = pop["log_weights"].float()
    uniform = bool((lw == lw[0]).all())
    w = lw if uniform else smc.normalize(lw - pop["log_like"].float() + ll)
    est_t, est_q = est.weighted_pose(w, pop["t"], pop["r"])
    return dict(ll=ll, weights=w, estimate=(est_t, est_q))


def track_numbers(cand, ref):
    t_c, q_c = cand["estimate"]
    t_r, q_r = ref["estimate"]
    t_c = torch.as_tensor(np.asarray(t_c, np.float64) if not torch.is_tensor(t_c) else t_c)
    q_c = torch.as_tensor(np.asarray(q_c, np.float64) if not torch.is_tensor(q_c) else q_c)
    t_gap = float((t_c.double().cpu() - t_r.double().cpu()).norm()
                  / t_r.double().cpu().norm().clamp(min=1e-12))
    r_gap = est.rotation_gap(q_c.cpu(), q_r.cpu())
    gap = max(t_gap, r_gap)
    return {"loglike": _finite_gap(cand["ll"], ref["ll"]),
            "weights": _finite_gap(cand["weights"], ref["weights"], rel=False),
            "estimate": gap if math.isfinite(gap) else math.inf}


def track_program_outputs(rec):
    pop = rec["population"]
    return dict(ll=pop["log_like"], weights=pop["log_weights"], estimate=rec["estimate"])


def judge(kind, records, meshes, cfg, device, control=False):
    """{"program": numbers, "control": numbers or None}: the largest of each
    number over the records."""
    names = NUMBERS[kind]
    worst = {"program": dict.fromkeys(names, 0.0)}
    if control:
        worst["control"] = dict.fromkeys(names, 0.0)
    for rec in records:
        mesh = meshes[rec["mesh"]]
        if kind == "bop":
            ref = bop_outputs(rec, mesh, cfg, device)
            reads = {"program": bop_numbers(bop_program_outputs(rec), ref, rec)}
            if control:
                ctl = bop_outputs(rec, mesh, cfg, device, torch.bfloat16, prep_ref.bf16)
                reads["control"] = bop_numbers(ctl, ref, rec)
        else:
            ref = track_outputs(rec, mesh, cfg, device)
            reads = {"program": track_numbers(track_program_outputs(rec), ref)}
            if control:
                reads["control"] = track_numbers(
                    track_outputs(rec, mesh, cfg, device, torch.bfloat16), ref)
        for side, nums in reads.items():
            for k, v in nums.items():
                worst[side][k] = max(worst[side][k], v if not math.isnan(v) else math.inf)
    worst.setdefault("control", None)
    return worst
