"""BOP pose-error metrics, greedy matching, recall, and step-time calibration.

Counterpart of ``jl_tpu/utils/evaluation.py``:

* ADD-S: the mean nearest-neighbour distance between the model points under
  the estimated and the true pose, on an evenly strided subsample of 2,048
  points (the same indices as the JAX package's) with a chunked running
  minimum for larger clouds;
* VSD (BOP18, one absolute tau) and VSDBOP (BOP19, taus as fractions of the
  diameter) on 100x100 crops: every estimate and the ground truth of one
  image render in one call. On the card that call is the hand-written
  ``ops.cuda_raster.render_depth`` kernel (every face drawn, as a dense
  z-buffer draws them); on the CPU it is ``ops.rasterize.render_depth_batch``,
  the dense rasteriser the JAX package evaluates with;
* greedy BOP matching, thresholds, recall and Wilson intervals (host NumPy);
* the step-time calibration that turns a per-pose time budget into a step
  count. The port's chain is an eager loop of device work, so a step is
  timed with the host clock around a run of steps that ends in
  ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import quaternions as quat
from ..camera import depth_to_distance
from ..ops.cuda_raster import render_depth
from ..ops.rasterize import render_depth_batch
from ..rngs import Rngs

__all__ = [
    "ADDS_THETA",
    "BOP18_THETA",
    "BOP19_THRESHOLDS",
    "BOP_DELTA",
    "ITODD_DELTA",
    "subsample_indices",
    "adds_error",
    "normalized_adds_error",
    "vsd_error",
    "normalized_vsd_error",
    "vsd_errors_batch",
    "match_errors",
    "match_bop19_errors",
    "match_scene_errors",
    "threshold_errors",
    "recall",
    "recall_ci",
    "mean_step_time",
    "steps_for_time_budget",
    "realized_step_time",
]

ADDS_THETA = 0.1
BOP18_THETA = 0.3
BOP19_THRESHOLDS = tuple(np.arange(0.05, 0.501, 0.05))
BOP_DELTA = 0.015  # 15 mm visibility tolerance
ITODD_DELTA = 0.005  # 5 mm for ITODD / Steri


def subsample_indices(n: int, count: int) -> np.ndarray:
    """``count`` evenly strided indices into ``n`` points, equal to the JAX
    package's ``jnp.linspace(0, n - 1, count).astype(int32)``: XLA computes
    that in float32 as i * ((n - 1) * fl(1 / (count - 1))) for i < count - 1
    (the division by the constant becomes a product with its reciprocal),
    truncated, then n - 1. A test holds the two equal."""
    div = count - 1
    out = np.arange(div, dtype=np.float32) * (np.float32(n - 1) * np.float32(1 / div))
    return np.concatenate([out, [np.float32(n - 1)]]).astype(np.int32)


def _as_f32(x, device):
    if not isinstance(x, torch.Tensor):
        x = np.array(x, np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def adds_error(points, es_t, es_q, gt_t, gt_q, max_points=2048, chunk=4096):
    """ADD-S: mean over the ground-truth-posed points of the distance to the
    nearest estimate-posed point. ``max_points``: the evenly strided
    subsample taken first (None = every point); ``chunk``: above this many
    points the estimate cloud is walked in chunks with a running minimum,
    so memory stays at O(V * chunk). Runs on ``points``' device."""
    points = _as_f32(points, getattr(points, "device", "cpu"))
    dev = points.device
    n = points.shape[0]
    if max_points is not None and n > max_points:
        points = points[torch.as_tensor(subsample_indices(n, max_points), device=dev).long()]
        n = max_points
    pe = quat.qrotate(_as_f32(es_q, dev), points) + _as_f32(es_t, dev)
    pg = quat.qrotate(_as_f32(gt_q, dev), points) + _as_f32(gt_t, dev)
    if n <= chunk:
        d2 = ((pg[:, None, :] - pe[None, :, :]) ** 2).sum(-1)
        return torch.sqrt(d2.amin(dim=1)).mean()
    best = torch.full((n,), torch.inf, dtype=pg.dtype, device=dev)
    for s in range(0, n, chunk):
        d2 = ((pg[:, None, :] - pe[None, s:s + chunk, :]) ** 2).sum(-1)
        best = torch.minimum(best, d2.amin(dim=1))
    return torch.sqrt(best).mean()


def normalized_adds_error(points, es_t, es_q, gt_t, gt_q, diameter, max_points=2048):
    """ADD-S / diameter (correct below ADDS_THETA = 0.1)."""
    return adds_error(points, es_t, es_q, gt_t, gt_q, max_points=max_points) / diameter


def _render_depths(verts, faces, cam, t, q):
    """Depth images [N, H, W] of N poses, 0 = background, every face drawn:
    the ``render_depth`` kernel for CUDA tensors (which raises rather than
    fall back), the dense rasteriser for CPU tensors."""
    if verts.device.type == "cpu":
        return render_depth_batch(verts, faces, cam, t, q)
    return render_depth(verts.contiguous(), faces.to(torch.int32).contiguous(), cam,
                        t.contiguous(), q.contiguous(), backface_cull=False,
                        device=verts.device)


def _scene_distance(scene_depth_img, cam, device):
    scene_z = _as_f32(scene_depth_img, device)
    scene_z = torch.where(scene_z <= 0, torch.full_like(scene_z, torch.inf), scene_z)
    return depth_to_distance(scene_z, cam)


def _visibility(render_d, scene_dist, delta):
    """Rendered surface not occluded beyond ``delta`` by the observed scene
    (BOP's visibility); invalid scene pixels count as visible."""
    rendered = render_d > 0
    occluded = torch.isfinite(scene_dist) & (render_d > scene_dist + delta)
    return rendered & ~occluded


def _vsd(dists, scene_dist, delta, taus_m):
    """[N, T] VSD errors of the first N distance images against the last."""
    d_es, d_gt = dists[:-1], dists[-1]
    vis_gt = _visibility(d_gt, scene_dist, delta)
    vis_es = _visibility(d_es, scene_dist[None], delta)
    n_union = (vis_es | vis_gt[None]).sum(dim=(1, 2))
    both = vis_es & vis_gt[None]
    diff = torch.abs(d_es - d_gt[None])
    ok = both[None] & (diff[None] < taus_m[:, None, None, None])
    err = 1.0 - ok.sum(dim=(2, 3)) / torch.clamp(n_union[None], min=1)
    return torch.where(n_union[None] > 0, err, torch.ones_like(err)).T


def vsd_error(scene, cam, scene_depth_img, es_t, es_q, gt_t, gt_q,
              delta=BOP_DELTA, tau=0.02, diameter=None, normalized=False):
    """Visible Surface Discrepancy of one estimate. BOP18 (``normalized``
    False): one absolute tau in meters, correct below BOP18_THETA. BOP19
    (``normalized``): taus as fractions of ``diameter``, one error per tau.
    ``scene_depth_img``: the observed depth (invalid = 0), turned into ray
    distances for the visibility masks."""
    verts, faces = scene["verts"], scene["faces"]
    dev = verts.device
    t = torch.stack([_as_f32(es_t, dev), _as_f32(gt_t, dev)])
    q = torch.stack([_as_f32(es_q, dev), _as_f32(gt_q, dev)])
    dists = depth_to_distance(_render_depths(verts, faces, cam, t, q), cam)
    taus = torch.atleast_1d(torch.as_tensor(np.asarray(tau, np.float32), device=dev))
    if normalized:
        taus = taus * float(np.float32(diameter))
    errs = _vsd(dists, _scene_distance(scene_depth_img, cam, dev), delta, taus)[0]
    return errs if np.ndim(tau) or normalized else errs[0]


def normalized_vsd_error(scene, cam, scene_depth_img, es_t, es_q, gt_t, gt_q, diameter,
                         delta=BOP_DELTA, tau=BOP19_THRESHOLDS):
    """BOP19 VSD: errors for tau in ``tau`` * diameter."""
    return vsd_error(scene, cam, scene_depth_img, es_t, es_q, gt_t, gt_q, delta=delta,
                     tau=np.asarray(tau, np.float32), diameter=diameter, normalized=True)


def vsd_errors_batch(scene, cam, scene_depth_img, es_ts, es_qs, gt_t, gt_q, diameter,
                     delta=BOP_DELTA, tau=0.02, taus_bop=BOP19_THRESHOLDS):
    """BOP18 and BOP19 VSD of N estimates against one ground truth: the N
    estimate poses and the ground truth render in one call, every tau is
    scored from those images. Returns NumPy (vsd [N], vsdbop [N, n_tau])."""
    verts, faces = scene["verts"], scene["faces"]
    dev = verts.device
    t = torch.cat([_as_f32(es_ts, dev), _as_f32(gt_t, dev)[None]])
    q = torch.cat([_as_f32(es_qs, dev), _as_f32(gt_q, dev)[None]])
    dists = depth_to_distance(_render_depths(verts, faces, cam, t, q), cam)
    taus_m = torch.cat([torch.tensor([tau], dtype=torch.float32),
                        torch.tensor(np.asarray(taus_bop, np.float32))
                        * float(np.float32(diameter))]).to(dev)
    errs = _vsd(dists, _scene_distance(scene_depth_img, cam, dev), float(np.float32(delta)),
                taus_m).cpu().numpy()
    return errs[:, 0], errs[:, 1:]


def match_errors(scores, errors_per_estimate):
    """Greedily match estimates (best score first) to ground truths.
    ``errors_per_estimate``: [n_est, n_gt]. Returns [n_gt] matched errors,
    inf where a gt is unmatched; an estimate with no finite error against a
    free gt takes no gt."""
    errors = np.asarray(errors_per_estimate, float)
    n_est, n_gt = errors.shape
    out = np.full(n_gt, np.inf)
    taken_gt = np.zeros(n_gt, bool)
    for e in np.argsort(-np.asarray(scores, float)):
        free = ~taken_gt
        if not free.any():
            break
        cand = np.where(free, errors[e], np.inf)
        g = int(np.argmin(cand))
        if np.isfinite(cand[g]):
            out[g] = errors[e, g]
            taken_gt[g] = True
    return out


def match_bop19_errors(scores, errors_per_estimate):
    """Greedy matching of per-tau error vectors: [n_est, n_gt, n_tau] ->
    [n_gt, n_tau], assigned by the mean over tau."""
    errors = np.asarray(errors_per_estimate, float)
    mean_err = errors.mean(axis=-1)
    n_est, n_gt, n_tau = errors.shape
    out = np.full((n_gt, n_tau), np.inf)
    taken_gt = np.zeros(n_gt, bool)
    for e in np.argsort(-np.asarray(scores, float)):
        free = ~taken_gt
        if not free.any():
            break
        cand = np.where(free, mean_err[e], np.inf)
        g = int(np.argmin(cand))
        if np.isfinite(cand[g]):
            out[g] = errors[e, g]
            taken_gt[g] = True
    return out


def match_scene_errors(result_rows, errors_fn, min_visib=0.1, gt_rows=None):
    """BOP evaluation of one scene: estimates grouped per (scene_id, img_id,
    obj_id), each scored by ``errors_fn(est_rows, gt_group) -> dict`` of
    'adds' / 'vsd' [n_est, n_gt] and 'vsdbop' [n_est, n_gt, n_tau] against
    every ground truth of its object in its image with ``visib_fract >=
    min_visib``, then greedily matched (best score first).

    ``gt_rows`` (dicts with scene_id, img_id, obj_id, gt_id, visib_fract):
    the recall denominator, an outer join: a gt without any estimate counts
    as a failure (inf). Without it the gts are read off the estimate rows.

    Returns the matched per-gt errors concatenated over groups, and 'visib'
    aligned with them."""
    groups: dict = {}
    for r in result_rows:
        groups.setdefault((int(r["scene_id"]), int(r["img_id"]), int(r["obj_id"])), []).append(r)

    if gt_rows is not None:
        gt_groups: dict = {}
        for g in gt_rows:
            gt_groups.setdefault((int(g["scene_id"]), int(g["img_id"]), int(g["obj_id"])),
                                 {}).setdefault(int(g["gt_id"]), g)
        group_keys = list(gt_groups)
    else:
        gt_groups = {k: {int(r["gt_id"]): r for r in ests} for k, ests in groups.items()}
        group_keys = list(groups)

    out = {"adds": [], "vsd": [], "vsdbop": []}
    visib = []
    unmatched = []  # visibilities of gt groups without any estimate
    for key in group_keys:
        gt_group = [g for g in gt_groups[key].values()
                    if float(g.get("visib_fract", 1.0)) >= min_visib]
        if not gt_group:
            continue
        gt_visibs = [float(g.get("visib_fract", 1.0)) for g in gt_group]
        ests = groups.get(key, [])
        if not ests:
            # padded below, for the metrics errors_fn actually produces
            unmatched.append(gt_visibs)
            continue
        errs = errors_fn(ests, gt_group)
        scores = [float(r["score"]) for r in ests]
        if "adds" in errs:
            out["adds"].append(match_errors(scores, errs["adds"]))
        if "vsd" in errs:
            out["vsd"].append(match_errors(scores, errs["vsd"]))
        if "vsdbop" in errs:
            out["vsdbop"].append(match_bop19_errors(scores, errs["vsdbop"]))
        visib.append(np.asarray(gt_visibs))
    n_tau = len(BOP19_THRESHOLDS)
    active = [m for m in out if out[m]] or list(out)
    for gt_visibs in unmatched:
        n_gt = len(gt_visibs)
        if "adds" in active:
            out["adds"].append(np.full(n_gt, np.inf))
        if "vsd" in active:
            out["vsd"].append(np.full(n_gt, np.inf))
        if "vsdbop" in active:
            out["vsdbop"].append(np.full((n_gt, n_tau), np.inf))
        visib.append(np.asarray(gt_visibs))
    return {
        "adds": np.concatenate(out["adds"]) if out["adds"] else np.zeros(0),
        "vsd": np.concatenate(out["vsd"]) if out["vsd"] else np.zeros(0),
        "vsdbop": np.concatenate(out["vsdbop"]) if out["vsdbop"] else np.zeros((0, n_tau)),
        "visib": np.concatenate(visib) if visib else np.zeros(0),
    }


def threshold_errors(errors, theta):
    """(n_correct, n_total) for error < theta; theta may be the BOP19 tau
    grid, against errors [..., n_tau]."""
    errors = np.asarray(errors, float)
    theta = np.asarray(theta, float)
    if theta.ndim == 0:
        return int(np.sum(errors < theta)), errors.size
    correct = int(np.sum(errors < theta.reshape((1,) * (errors.ndim - 1) + (-1,))))
    return correct, errors.size


def recall(n_correct, n_total):
    return n_correct / n_total if n_total else 0.0


def recall_ci(n_correct, n_total, z=1.96):
    """Wilson score interval (lo, hi) of a binomial recall at ~95 %, held to
    contain the point recall through float rounding."""
    if not n_total:
        return 0.0, 0.0
    p = n_correct / n_total
    denom = 1.0 + z * z / n_total
    center = (p + z * z / (2 * n_total)) / denom
    half = (z / denom) * np.sqrt(p * (1 - p) / n_total + z * z / (4 * n_total * n_total))
    return max(0.0, min(p, center - half)), min(1.0, max(p, center + half))


def mean_step_time(seed, model, sampler, n_particles=None, max_seconds=0.5,
                   steps_per_probe=(8, 48), return_overhead=False):
    """Mean wall time of one sampler step on ``model``'s device.

    Two run lengths are timed (the minimum over repeats, within
    ``max_seconds`` in all) and differenced, t_step = (T(n_long) -
    T(n_short)) / (n_long - n_short), which cancels the per-run constant
    (the final synchronisation and the first launches). The first run of
    each length is a warm-up and is not timed. Where the difference holds
    less than 20 ms of work, a longer run (>= 50 ms of steps) re-measures
    the slope. ``return_overhead``: also return the per-run constant, from
    the mean of the short runs."""
    n_short, n_long = steps_per_probe
    dev = torch.device(model.device)
    rngs = Rngs.from_seed(seed, dev)
    _, state = sampler.init(rngs, model, n_particles)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def probe(n):
        s = state
        for _ in range(n):
            s = sampler.step(rngs, model, s)[1]
        sync()

    def timed(n, reps_max=20):
        probe(n)  # warm-up
        t_end = time.perf_counter() + max_seconds / 2
        times = []
        while time.perf_counter() < t_end and len(times) < reps_max:
            t0 = time.perf_counter()
            probe(n)
            times.append(time.perf_counter() - t0)
        return times

    runs = {n: timed(n) for n in (n_short, n_long)}
    mins = {n: min(v) for n, v in runs.items()}
    t_step = (mins[n_long] - mins[n_short]) / (n_long - n_short)
    # the difference can be non-positive under interference; the long run's
    # average is then a conservative (over-) estimate
    if not np.isfinite(t_step) or t_step <= 0:
        t_step = mins[n_long] / n_long
    if (mins[n_long] - mins[n_short]) < 0.02:
        n2 = int(np.clip(0.05 / max(t_step, 1e-7), 2 * n_long, 4096))
        slope = (min(timed(n2)) - mins[n_long]) / (n2 - n_long)
        if np.isfinite(slope) and slope > 0:
            t_step = slope
    overhead = max(float(np.mean(runs[n_short])) - n_short * t_step, 0.0)
    if return_overhead:
        return float(t_step), float(overhead)
    return float(t_step)


def realized_step_time(wall, n_steps, overhead=0.0):
    """The time per step one run of ``n_steps`` realized: its wall time less
    the per-run ``overhead``, per step (the run's own costs beyond the
    overhead fall on its steps)."""
    return max(wall - overhead, 0.0) / max(n_steps, 1)


def steps_for_time_budget(step_time, time_budget, minimum=2, overhead=0.0, safety=0.92):
    """n_steps = floor(safety * (budget - overhead) / step_time), at least
    ``minimum``. ``overhead``: the per-run constant, excluded from the step
    budget; ``safety`` absorbs run-to-run step-time variance so the realized
    wall time stays within the budget."""
    budget = max(time_budget - overhead, 0.0) * safety
    return max(int(budget / step_time), minimum)
