"""Cases and comparisons that hold the PyTorch/CUDA port to the JAX
package's runs, shared by the CPU tests (``tests/test_torch_*.py``) and the
card's checks (``chip_smoke.py``, ``chip_profile.py``):

* the JAX package's checked-in runs and the port's arguments for them: the
  experiment sweeps (``SWEEP_EXPERIMENTS``), the hyperparameter searches
  (``HYPEROPT_EXPERIMENTS``) and the BOP runs (``BOP_RUNS``), with the JAX
  package's re-evaluated errors where the checked-in ones are stale;
* the port's BOP errors against the JAX package's (``compare_errors``) and
  the tolerances of each set;
* a scene of the synthetic BOP generator against a checked-in one
  (``compare_generated_scene``);
* the (live triangle, pixel) pairs a z-buffer tests (``live_pairs``), which
  the kernel bounds of ``chip_smoke.py`` and ``chip_profile.py`` count;
* the SMC population update: inputs from a seed, the plain version, the
  kernel and their comparison (``smc_update_cases``);
* the MH move after the render: inputs from a seed, the plain version, the
  kernel's path and their comparison (``mh_move_cases``);
* one benchmark cell served with the port's telemetry on
  (``telemetry_cell``, which ``chip_profile.py telemetry`` prints), until the
  benchmark reads the telemetry itself.

The standard library only at import: torch, the port and the benchmark are
imported inside the functions that use them, so importing this module leaves
the card alone. It imports neither ``chip_smoke.py``, ``chip_profile.py`` nor ``bench_torch``.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent


def bop_val_script():
    sys.path.insert(0, str(REPO / "scripts"))
    import torch_smc_bop_val

    return torch_smc_bop_val


def live_pairs(verts, faces, cam, t, q, backface_cull=True):
    """(live triangle, pixel) pairs a z-buffer must test on these poses: for
    each live triangle (back faces too where ``backface_cull`` is off), the
    pixel centres inside its bounding box clipped to the viewport."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
        project_vertices,
        triangle_forms,
    )

    valid, _ = triangle_forms(verts, faces, cam, t, q, backface_cull=backface_cull)
    u, v, _ = project_vertices(verts, faces, cam, t, q)

    def extent(c, size):
        # pixel centres lie at k - (size - 1) / 2 for k in [0, size)
        off = (size - 1) / 2.0
        lo = torch.ceil(torch.minimum(torch.minimum(c[0], c[1]), c[2]) + off).clamp(min=0)
        hi = torch.floor(torch.maximum(torch.maximum(c[0], c[1]), c[2]) + off).clamp(max=size - 1)
        return (hi - lo + 1).clamp(min=0)

    area = extent(u, cam.width) * extent(v, cam.height)
    return int(torch.where(valid, area, torch.zeros_like(area)).sum())


# -- the JAX package's BOP runs, and the port's errors against theirs ----------

ADDS_REL_TOL = 1e-4  # ADD-S, relative
VSD_ABS_TOL = 0.01  # VSD and every VSDBOP tau, absolute (a few pixels of a crop)
THETA_MARGIN = 0.01  # entries this close to a threshold may pass on one side only


def compare_errors(ours, ref, adds_tol=ADDS_REL_TOL, vsd_tol=VSD_ABS_TOL):
    """The port's matched errors of one scene against the JAX package's:
    (list of failed checks, max ADD-S relative |d|, max VSD / VSDBOP |d|, the
    number of entries within THETA_MARGIN of a threshold). Visibilities are
    compared where the JAX errors store them."""
    import numpy as np

    from bayesianposeestimation.jl_tpu_torch.utils import evaluation as ev

    bad = []
    if "visib" in ref and not np.array_equal(ours["visib"], ref["visib"]):
        bad.append("visib")
    worst = {"adds": 0.0, "vsd": 0.0}
    near_total = 0
    for key, theta in (("adds", ev.ADDS_THETA), ("vsd", ev.BOP18_THETA),
                       ("vsdbop", np.asarray(ev.BOP19_THRESHOLDS))):
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        if a.shape != b.shape or not np.array_equal(np.isinf(a), np.isinf(b)):
            bad.append(f"{key} shape or unmatched gts")
            continue
        fin = np.isfinite(b)
        d = np.abs(a - b)[fin]
        if key == "adds":
            rel = d / np.maximum(np.abs(b[fin]), 1e-30)
            worst["adds"] = max(worst["adds"], float(rel.max(initial=0.0)))
            if rel.max(initial=0.0) > adds_tol:
                bad.append(f"adds relative {rel.max():.3g}")
        else:
            worst["vsd"] = max(worst["vsd"], float(d.max(initial=0.0)))
            if d.max(initial=0.0) > vsd_tol:
                bad.append(f"{key} |d| {d.max():.3g}")
        near = np.abs(b - theta) < THETA_MARGIN
        near_total += int(near.sum())
        if ((a < theta) != (b < theta))[~near].any():
            bad.append(f"{key} counts under the threshold")
    return bad, worst["adds"], worst["vsd"], near_total


# the experiment sweeps' JAX runs whose estimates and errors are checked in
# (data/exp_raw/<name>, data/exp_pro/<name>): each experiment's script and the
# arguments the JAX run used (read off its artifacts' __config__), and the
# table it wrote
SWEEP_EXPERIMENTS = {
    "smc_benchmark": ("torch_smc_benchmark", [], "recall_vs_budget.csv"),
    "smc_benchmark_cad": ("torch_smc_benchmark", ["--dataset", "synthcad", "--particles", "10",
                                                  "--experiment-name", "smc_benchmark_cad"],
                          None),
    "smc_benchmark_steri": ("torch_smc_benchmark_steri", ["--particles", "100", "--budgets",
                                                          "0.25", "0.5"],
                            "recall_vs_budget.csv"),
    "mcmc_benchmark": ("torch_mcmc_benchmark", [], "recall_vs_time.csv"),
    "mcmc_baseline": ("torch_mcmc_baseline", [], "sampler_recall.csv"),
    "smc_mh_baseline": ("torch_smc_mh_baseline", [], "baseline_recall.csv"),
    "smc_mh_resolution": ("torch_smc_mh_resolution", ["--resolutions", "15", "30", "60"],
                          "resolution_recall.csv"),
    "smc_observation": ("torch_smc_observation", ["--variants", "association", "smooth",
                                                  "simple", "--o-priors", "mask"],
                        "observation_recall.csv"),
    "smc_priors": ("torch_smc_priors", [], "priors_recall.csv"),
}
# the JAX package's errors of the artifacts whose checked-in errors its
# evaluation does not reproduce today (scripts/reevaluate_errors.py)
REEVALUATED = REPO / "tests/fixtures/reevaluated_errors.npz"
SWEEP_ADDS_REL_TOL = ADDS_REL_TOL  # phase 7a's (the card sums in another order: ~2e-5)
SWEEP_VSD_ABS_TOL = 0.005


def sweep_reference(name, file, fixture=REEVALUATED):
    """The JAX errors an artifact is held to: the JAX package's evaluation
    of today (in ``fixture``) where it does not reproduce the checked-in
    errors, else those. Returns (errors, whether they are the re-evaluation)."""
    import numpy as np

    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import load_artifact

    key = f"{name}/{file}"
    with np.load(fixture) as f:
        if f"{key}/vsd" in f.files:
            return {k: f[f"{key}/{k}"] for k in ("adds", "vsd", "vsdbop", "visib")}, True
    return load_artifact(REPO / "data/exp_pro" / name / "errors" / file), False


# the JAX package's checked-in searches (data/exp_raw/<name>, data/exp_pro/<name>):
# each search's script and the arguments its run used, read off its artifacts
# (dataset, split and scenes from the configs, the trial count from
# trials.csv, the time budget from n_steps x step_time: 0.22 s of 0.25 s on
# synth, 0.38-0.44 s of 0.5 s on synthcad); --seed 0 reproduces every
# candidate of its trials.csv
HYPEROPT_EXPERIMENTS = {
    "smc_mh_hyperopt": ("torch_smc_mh_hyperopt", ["--trials", "30", "--scenes", "1"]),
    "smc_mh_hyperopt_cad": ("torch_smc_mh_hyperopt",
                            ["--dataset", "synthcad", "--testset", "train", "--scenes", "1", "2",
                             "3", "--trials", "10", "--time-budget", "0.5",
                             "--experiment-name", "smc_mh_hyperopt_cad"]),
    "mcmc_hyperopt_mh_sampler": ("torch_mcmc_baseline_hyperopt",
                                 ["--trials", "8", "--samplers", "mh_sampler"]),
    "mcmc_hyperopt_mtm_sampler": ("torch_mcmc_baseline_hyperopt",
                                  ["--trials", "8", "--samplers", "mtm_sampler"]),
    "mcmc_hyperopt_cad_mh": ("torch_mcmc_baseline_hyperopt",
                             ["--dataset", "synthcad", "--testset", "train", "--scenes", "1", "2",
                              "--trials", "8", "--time-budget", "0.5", "--samplers",
                              "mh_sampler", "--experiment-names", "mcmc_hyperopt_cad_mh"]),
    "mcmc_hyperopt_cad_mtm": ("torch_mcmc_baseline_hyperopt",
                              ["--dataset", "synthcad", "--testset", "train", "--scenes", "1",
                               "2", "--trials", "8", "--time-budget", "0.5", "--samplers",
                               "mtm_sampler", "--experiment-names", "mcmc_hyperopt_cad_mtm"]),
}
REEVALUATED_HYPEROPT = REPO / "tests/fixtures/reevaluated_errors_hyperopt.npz"


def hyperopt_argv(name, extra=()):
    """``torch_smc_mh_hyperopt.py``'s arguments of a checked-in search at
    --seed 0 (the MCMC script's through its ``search_argvs``), then
    ``extra`` (later options win)."""
    import importlib

    sys.path.insert(0, str(REPO / "scripts"))
    script, argv = HYPEROPT_EXPERIMENTS[name]
    argv = [*argv, "--seed", "0"]
    if script == "torch_mcmc_baseline_hyperopt":
        mcmc = importlib.import_module(script)
        [argv] = mcmc.search_argvs(mcmc.parse_args(argv))
    return [*argv, *extra]


def read_trials(path):
    """A trials.csv as a list of dicts of floats (trial as int)."""
    import csv

    with open(path, newline="") as fh:
        return [{k: (int(v) if k == "trial" else float(v)) for k, v in r.items()}
                for r in csv.DictReader(fh)]


# the JAX package's runs of scripts/smc_bop_val.py (data/exp_raw/<name>,
# data/exp_pro/<name>), all smc_mh: each run's arguments, read off its
# artifacts (split and scenes from the configs; the budget from n_steps x
# step_time: 0.43-0.47 s of 0.5 s, 0.024 s of 0.05 s and 0.072 s of 0.10 s
# after the 0.92 safety factor)
BOP_RUNS = {
    "smc_bop_val": ["--dataset", "synth", "--testset", "val", "--scenes", "1"],
    "smc_bop_val2": ["--dataset", "synth", "--testset", "val2", "--scenes", "1", "2", "3"],
    "smc_bop_val2_b005": ["--dataset", "synth", "--testset", "val2", "--scenes", "1",
                          "--time-budget", "0.05"],
    "smc_bop_val2_b010": ["--dataset", "synth", "--testset", "val2", "--scenes", "1",
                          "--time-budget", "0.1"],
    "smc_bop_cad_val2": ["--dataset", "synthcad", "--testset", "val2", "--scenes", "1", "2"],
    "hard_cases": ["--dataset", "synth", "--testset", "hard", "--scenes", "1"],
}
# the JAX package's errors of today where the checked-in errors are stale (the
# six synth artifacts of the val / val2 runs; scripts/reevaluate_errors.py)
REEVALUATED_BOP_RUNS = REPO / "tests/fixtures/reevaluated_errors_bop_runs.npz"


def bop_run_args(name, device="cpu", extra=()):
    """scripts/torch_smc_bop_val.py's arguments and configs for a JAX run of
    BOP_RUNS (the configs name its artifacts)."""
    bopval = bop_val_script()
    args = bopval.parse_args([*BOP_RUNS[name], "--samplers", "smc_mh", "--experiment-name",
                              name, "--device", device, *extra])
    return args, bopval.sweep_configs(args)



# -- the synthetic BOP generator against the checked-in scenes -----------------

# the JAX script's rotation draws at --seed 77 (synthcad train), for phase 15d
JAX_QUATERNIONS = REPO / "tests/fixtures/jax_generator_quaternions.json"
# generated scenes against the checked-in ones: per-mask IoU, visible
# fraction, depth PNG units where both scenes' masks agree
GEN_MASK_IOU = 0.98
GEN_VISIB_TOL = 0.01
GEN_DEPTH_UNITS = 1


def compare_generated_scene(out_dir, ref_dir, img_ids):
    """A generated scene directory against a checked-in one, image by image:
    (failed checks, measured differences). Obj ids and instance counts must
    be equal, cam_t_m2c within 1e-9 mm, cam_R_m2c within 1e-5, the cameras
    equal, each mask_visib within GEN_MASK_IOU, each visib_fract within
    GEN_VISIB_TOL, each depth PNG within GEN_DEPTH_UNITS wherever both
    scenes' masks (the union over the image's instances) agree."""
    import numpy as np

    from bayesianposeestimation.jl_tpu_torch.utils.png import read_png

    out_dir, ref_dir = Path(out_dir), Path(ref_dir)

    def load(d, name):
        return json.loads((d / name).read_text())

    gt_o, gt_r = load(out_dir, "scene_gt.json"), load(ref_dir, "scene_gt.json")
    info_o, info_r = load(out_dir, "scene_gt_info.json"), load(ref_dir, "scene_gt_info.json")
    cam_o, cam_r = load(out_dir, "scene_camera.json"), load(ref_dir, "scene_camera.json")
    bad = []
    stats = dict(t_mm=0.0, R=0.0, min_iou=1.0, mask_px=0, visib=0.0, depth_units=0,
                 depth_px_over=0, depth_units_all=0)
    for k in (str(i) for i in img_ids):
        if [g["obj_id"] for g in gt_o[k]] != [g["obj_id"] for g in gt_r[k]]:
            bad.append(f"image {k}: obj ids or instance count")
            continue
        if cam_o[k] != cam_r[k]:
            bad.append(f"image {k}: camera")
        union_o = union_r = 0
        for j, (a, b) in enumerate(zip(gt_o[k], gt_r[k])):
            stats["t_mm"] = max(stats["t_mm"], float(np.abs(
                np.subtract(a["cam_t_m2c"], b["cam_t_m2c"])).max()))
            stats["R"] = max(stats["R"], float(np.abs(
                np.subtract(a["cam_R_m2c"], b["cam_R_m2c"])).max()))
            m_o = read_png(out_dir / "mask_visib" / f"{int(k):06d}_{j:06d}.png") > 0
            m_r = read_png(ref_dir / "mask_visib" / f"{int(k):06d}_{j:06d}.png") > 0
            iou = (m_o & m_r).sum() / max((m_o | m_r).sum(), 1)
            stats["min_iou"] = min(stats["min_iou"], float(iou))
            stats["mask_px"] = max(stats["mask_px"], int((m_o ^ m_r).sum()))
            stats["visib"] = max(stats["visib"], abs(info_o[k][j]["visib_fract"]
                                                     - info_r[k][j]["visib_fract"]))
            union_o, union_r = union_o | m_o, union_r | m_r
        d_o = read_png(out_dir / "depth" / f"{int(k):06d}.png").astype(np.int64)
        d_r = read_png(ref_dir / "depth" / f"{int(k):06d}.png").astype(np.int64)
        diff = np.abs(d_o - d_r)
        agree = union_o == union_r
        stats["depth_units"] = max(stats["depth_units"], int(diff[agree].max()))
        stats["depth_px_over"] += int((diff[agree] > GEN_DEPTH_UNITS).sum())
        stats["depth_units_all"] = max(stats["depth_units_all"], int(diff.max()))
    if cam_o.keys() != {str(i) for i in img_ids} or gt_o.keys() != cam_o.keys():
        bad.append(f"images {sorted(gt_o)} written, not {list(img_ids)}")
    if stats["t_mm"] > 1e-9:
        bad.append(f"cam_t_m2c |d| {stats['t_mm']} mm")
    if stats["R"] > 1e-5:
        bad.append(f"cam_R_m2c |d| {stats['R']}")
    if stats["min_iou"] < GEN_MASK_IOU:
        bad.append(f"mask IoU {stats['min_iou']:.4f}")
    if stats["visib"] > GEN_VISIB_TOL:
        bad.append(f"visib_fract |d| {stats['visib']:.4f}")
    if stats["depth_px_over"]:
        bad.append(f"{stats['depth_px_over']} depth pixels over {GEN_DEPTH_UNITS} unit where the "
                   f"masks agree")
    return bad, stats


def gt_quaternions(scene_dir):
    """The rotations of a scene's annotations as quaternions [4], in the
    order the generator draws them (image by image, instance by instance)."""
    import torch

    from bayesianposeestimation.jl_tpu_torch import quaternions as quat

    gt = json.loads((Path(scene_dir) / "scene_gt.json").read_text())
    return [quat.matrix_to_quat(torch.tensor(g["cam_R_m2c"], dtype=torch.float32)
                                .reshape(3, 3)).numpy()
            for k in sorted(gt, key=int) for g in gt[k]]


# -- the SMC population update, kernel against plain version -------------------

# Applied by chip_smoke.py's phase 19 and the card tests: the field sets, the
# four SMC cells' shapes (particles, field set), the cases the kernel is held
# against its plain version in, and the tolerance: each weight, the evidence and the ESS
# within SMC_UPDATE_TOL of the inputs' largest magnitude (fp32 rounds the
# log-sum-exp at that scale, and the normalized weights and the ESS inherit
# its last bit); an index may differ only where its position lies within
# SMC_UPDATE_CDF_TOL of the plain cdf (the two scans sum in other orders)
SMC_UPDATE_FIELDS = {"bop": {"t": 3, "r": 4},
                     "tracker": {"t": 3, "r": 4, "t_dot": 3, "r_dot": 3}}
SMC_UPDATE_SHAPES = {"synthcad_smc_mh.bop": (100, "bop"),
                     "track_coordinate.synth120": (600, "tracker"),
                     "synthcad_smc_mh.res100_p1000": (1000, "bop"),
                     "track_bootstrap.synth120": (1250, "tracker")}
SMC_UPDATE_SIZES = (1, 31, 100, 600, 1000, 1024, 1025, 1250)
SMC_UPDATE_CASES = ("random", "above", "below", "one_finite", "all_neg_inf", "nan_loglike",
                    "u_zero", "u_top")
SMC_UPDATE_TOL = 1e-6
SMC_UPDATE_CDF_TOL = 2.0 ** -20


def smc_update_inputs(device, n, field_set, case, seed=0):
    """One population update's inputs from a seed, f32 on ``device``: the old
    normalized log-weights and evidence, the increment, the uniform, the
    fields and the threshold, as a dict. BOP: increments of a tempered
    step, ~-6 ± 1 nats; tracker: a bootstrap filter's log-likelihoods,
    ~-4,000 ± 3. ``case`` (``SMC_UPDATE_CASES``): ``above`` / ``below`` put
    the threshold just under / over the plain ESS (10 tolerances away),
    ``one_finite`` leaves one increment finite, ``all_neg_inf`` none,
    ``nan_loglike`` makes one log-likelihood (and its increment) NaN,
    ``u_zero`` / ``u_top`` draw the uniform 0 / 1 - 2^-24."""
    import numpy as np
    import torch

    rng = np.random.default_rng([seed, n, SMC_UPDATE_CASES.index(case),
                                 list(SMC_UPDATE_FIELDS).index(field_set)])
    f32 = np.float32
    offset, scale = (-6.0, 1.0) if field_set == "bop" else (-4000.0, 3.0)
    old = rng.normal(0.0, 1.0, n)
    old = old - np.logaddexp.reduce(old)
    incr = rng.normal(offset, scale, n)
    log_like = incr.copy() if field_set == "tracker" else rng.normal(-3000.0, 300.0, n)
    k = int(rng.integers(n))
    if case == "one_finite":
        incr[np.arange(n) != k] = -np.inf
    elif case == "all_neg_inf":
        incr[:] = -np.inf
    elif case == "nan_loglike":
        incr[k] = log_like[k] = np.nan
    u = {"u_zero": 0.0, "u_top": 1.0 - 2.0 ** -24}.get(case, rng.uniform())

    def on(x):
        return torch.as_tensor(np.asarray(x, f32)).to(device)

    names = list(SMC_UPDATE_FIELDS[field_set])
    fields = [on(rng.normal(0.0, 1.0, (n, w))) for w in SMC_UPDATE_FIELDS[field_set].values()]
    fields += [on(rng.normal(-10.0, 2.0, n)), on(log_like)]
    inp = {"old_log_weights": on(old), "incr": on(incr), "old_evidence": on(rng.normal(-50.0, 5.0)),
           "u": on(u), "fields": fields, "names": names, "threshold": math.log(0.5)}
    if case in ("above", "below"):
        ess = float(smc_update_plain(inp)[0].log_relative_ess)
        margin = 10 * SMC_UPDATE_TOL * smc_update_scale(inp)
        inp["threshold"] = ess - margin if case == "above" else ess + margin
    return inp


def smc_update_scale(inp):
    """The largest magnitude among an update's inputs (the finite new weights
    and the old evidence), at least 1: what its tolerance is relative to."""
    import torch

    w = (inp["old_log_weights"] + inp["incr"]).double()
    w = w[torch.isfinite(w)]
    top = float(w.abs().max()) if w.numel() else 0.0
    return max(1.0, top, abs(float(inp["old_evidence"])))


def smc_update_state(inp):
    """(old SmcState, new Sample) of an update's inputs."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.samplers.smc import SmcState
    from bayesianposeestimation.jl_tpu_torch.samples import Sample

    fields = inp["fields"]
    sample = Sample(dict(zip(inp["names"], fields[:-2])), fields[-2], fields[-1])
    zero = torch.zeros((), dtype=torch.float32, device=inp["incr"].device)
    return SmcState(sample, inp["old_log_weights"], inp["old_evidence"], zero, zero), sample


def smc_update_plain(inp):
    """The plain version of one update and what the kernel is checked
    against: (the new SmcState, the systematic draw's indices, the cdf they
    were drawn from, the positions)."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.samplers import smc

    old, sample = smc_update_state(inp)
    one = torch.ones((), dtype=torch.float32, device=inp["incr"].device)
    state = smc.update_population_plain(old, inp["incr"], sample, one, inp["u"],
                                        inp["threshold"])
    normalized = smc.normalize_log_weights(inp["old_log_weights"] + inp["incr"])
    idx = smc.systematic_resampling_indices(normalized, inp["u"])
    n = normalized.shape[0]
    w = torch.exp(smc.normalize_log_weights(normalized))
    w = torch.where((w == 0).all(), torch.full_like(w, 1.0 / n), w)
    cdf = torch.cumsum(w, dim=-1)
    cdf = cdf / cdf[-1]
    positions = (inp["u"] + torch.arange(n, dtype=w.dtype, device=w.device)) / n
    return state, idx, cdf, positions


def smc_update_kernel(inp):
    """``ops/smc_update.smc_update`` on an update's inputs, with the indices:
    (log_weights, evidence, ESS, fields, indices)."""
    from bayesianposeestimation.jl_tpu_torch.ops.smc_update import smc_update

    return smc_update(inp["old_log_weights"], inp["incr"], inp["old_evidence"], inp["u"],
                      inp["fields"], inp["threshold"], return_indices=True)


def compare_smc_update(inp, out, plain):
    """The kernel's update ``out`` (``smc_update_kernel``) against the plain
    one (``smc_update_plain``) on the same inputs, as a dict with ``ok``:
    log-weights, evidence and log(ESS/N) within SMC_UPDATE_TOL of the inputs'
    largest magnitude (NaN and inf where the plain version has them), the
    same resampling decision, indices equal but where the position lies
    within SMC_UPDATE_CDF_TOL of the plain cdf, and every field bitwise the
    rows the kernel's own decision and indices select, equal to the plain
    version's where the indices agree."""
    import numpy as np
    import torch

    lw, ev, ess, fields, idx = out
    state, p_idx, cdf, pos = plain
    tol = SMC_UPDATE_TOL * smc_update_scale(inp)

    def gap(a, b):
        a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
        same = (np.isnan(a) == np.isnan(b)) & (np.isinf(a) == np.isinf(b))
        fin = np.isfinite(b) & np.isfinite(a)
        if not same.all() or not np.array_equal(a[np.isinf(b)], b[np.isinf(b)]):
            return math.inf
        return float(np.max(np.abs(a[fin] - b[fin]), initial=0.0))

    gaps = {"weights": gap(lw, state.log_weights), "evidence": gap(ev, state.log_evidence),
            "ess": gap(ess, state.log_relative_ess)}
    thr = torch.tensor(inp["threshold"], dtype=torch.float32)
    do, p_do = bool(ess.cpu() < thr), bool(state.log_relative_ess.cpu() < thr)
    differ = (idx != p_idx).cpu()
    c = cdf.double().cpu()
    near = ((c[None, :] - pos.double().cpu()[:, None]).abs() < SMC_UPDATE_CDF_TOL).any(1)
    off_cdf = int((differ & ~near).sum())
    rows = idx if do else torch.arange(idx.shape[0], device=idx.device)
    agree = ~differ.to(idx.device) | (not do)
    bitwise = all(torch.equal(f.view(torch.int32), x[rows].view(torch.int32))
                  for f, x in zip(fields, inp["fields"]))
    p_fields = [*state.sample.variables.values(), state.sample.log_prob, state.sample.log_like]
    plain_equal = all(torch.equal(f[agree].view(torch.int32), g[agree].view(torch.int32))
                      for f, g in zip(fields, p_fields))
    ok = (all(g <= tol for g in gaps.values()) and do == p_do and off_cdf == 0 and bitwise
          and plain_equal)
    return {"ok": ok, "tol": tol, **{f"{k}_gap": v for k, v in gaps.items()},
            "resampled": do, "plain_resampled": p_do, "indices_differ": int(differ.sum()),
            "indices_differ_off_cdf": off_cdf, "fields_bitwise": bitwise,
            "fields_equal_plain": plain_equal}


def smc_update_cases(device, n, field_set):
    """The kernel against its plain version in every case of
    ``SMC_UPDATE_CASES`` at ``n`` particles with ``field_set``'s fields:
    (case, ``compare_smc_update``'s dict) a case."""
    out = []
    for case in SMC_UPDATE_CASES:
        inp = smc_update_inputs(device, n, field_set, case)
        out.append((case, compare_smc_update(inp, smc_update_kernel(inp),
                                             smc_update_plain(inp))))
    return out


# -- the MH move after the render ----------------------------------------------
# Applied by chip_smoke.py's phase 20 and the card tests: the particle counts,
# the three proposals of smc_mh and mh_sampler, the cases, and the tolerance:
# the kernel follows the plain version's operation order, so every field, both
# log-densities and the increment are held bitwise (MH_MOVE_ULP = 0), and an
# accept decision may differ nowhere
MH_MOVE_SIZES = (1, 100, 1000)
MH_MOVE_PROPOSALS = ("t_walk", "r_walk", "r_independent")
MH_MOVE_CASES = ("random", "first", "last", "constant", "sum_o_zero", "u_zero")
MH_MOVE_SHAPES = {"synthcad_smc_mh.bop": 100, "synthcad_smc_mh.res100_p1000": 1000,
                  "synthcad_mh.bop": 1}
MH_MOVE_ULP = 0


def cube_posterior(device, n_particles=8, n_steps=7, variant="association", prior_t=None,
                   observed=False, **fields):
    """A 10 cm cube 1 m away behind a 16x16 camera and its fused posterior:
    (params, posterior), with ``fields`` of ``Parameters``. ``prior_t``
    defaults to 1 cm off the cube's centre; the observation is empty, or
    with ``observed`` the cube's depth image with 5 mm noise."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch import convert
    from bayesianposeestimation.jl_tpu_torch.models.fused import fused_posterior
    from bayesianposeestimation.jl_tpu_torch.ops import cuda_raster
    from bayesianposeestimation.jl_tpu_torch.utils import mesh_io

    params = convert.parameters_from_fields(
        width=16, height=16, n_particles=n_particles, n_steps=n_steps,
        **{"proposal_sigma_r": (0.5, 0.5, 0.5), **fields}, device=device)
    mesh = mesh_io.cube_mesh(0.1)
    cam = convert.camera_from_fields(width=16, height=16, f_x=20.0, f_y=20.0, c_x=7.5,
                                     c_y=7.5, near=0.01, far=10.0)
    t = torch.tensor([[0.01, -0.02, 1.0]])
    obs = np.zeros((16, 16), np.float32)
    if observed:
        q = torch.tensor([[0.9, 0.1, 0.3, -0.2]])
        clean = cuda_raster.render_depth(torch.as_tensor(mesh.vertices, dtype=torch.float32),
                                         torch.as_tensor(mesh.faces, dtype=torch.int32), cam, t,
                                         q / q.norm(), device="cpu")[0]
        noise = 0.005 * torch.randn(clean.shape, generator=torch.Generator().manual_seed(0))
        obs = torch.where(clean > 0, clean + noise, torch.zeros_like(clean)).numpy()
    prior_t = t[0].numpy() + 0.01 if prior_t is None else prior_t
    exp = convert.experiment_from_numpy(cam, mesh.vertices, mesh.faces, 0.7, prior_t, obs)
    return params, fused_posterior(params, exp, variant, device=device)


def mh_move_inputs(device, n, proposal, case, seed=0):
    """One MH move's inputs from a seed, f32 on ``device``, as a dict: a
    fused association posterior (a 10 cm cube, 16x16) whose ``render``
    returns the case's sums (``ell_raw``, ``sum_o``: ~-0.3 ± 0.5 nats a
    visible pixel, 20-300 pixels), ``proposal`` (``MH_MOVE_PROPOSALS``) and
    its proposed and previous samples, the temperatures and the uniforms
    ``u``. ``case`` (``MH_MOVE_CASES``): ``random`` ϕ 0.4 → 0.41; ``first``
    0 → 1/480; ``last`` 479/480 → 1; ``constant`` 1 → 1 (no re-tempering, an
    increment of 0, NaN at a -inf likelihood); ``sum_o_zero`` a quarter of
    the proposals with Σo = 0 (likelihood -inf) and an eighth of the previous
    samples at -inf; ``u_zero`` a quarter of the uniforms 0 and one 1 - 2^-24."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch.models import experiment_samplers
    from bayesianposeestimation.jl_tpu_torch.samples import Sample

    rng = np.random.default_rng([seed, n, MH_MOVE_PROPOSALS.index(proposal),
                                 MH_MOVE_CASES.index(case)])
    f32 = np.float32

    def on(x):
        return torch.as_tensor(np.asarray(x, f32)).to(device)

    def quaternions():
        q = rng.normal(0.0, 1.0, (n, 4))
        return q / np.linalg.norm(q, axis=1, keepdims=True)

    prior_t = np.array([0.01, -0.02, 1.0]) + rng.normal(0.0, 0.01, 3)
    sigma_t = (0.02, 0.03, 0.05)
    params, post = cube_posterior(device, n, 480, prior_t=prior_t, sigma_t=sigma_t)
    props = dict(zip(MH_MOVE_PROPOSALS, experiment_samplers._proposals(params, post, False)))

    prev_t = prior_t + rng.normal(0.0, 1.0, (n, 3)) * np.asarray(sigma_t)
    prev_r = quaternions()
    prop_t = prev_t + rng.normal(0.0, 0.01, (n, 3)) if proposal == "t_walk" else prev_t
    prop_r = (prev_r if proposal == "t_walk"
              else quaternions() if proposal == "r_independent"
              else prev_r + rng.normal(0.0, 0.05, (n, 4)))
    phi, phi_new = {"first": (0.0, 1.0 / 480), "last": (479.0 / 480, 1.0),
                    "constant": (1.0, 1.0)}.get(case, (0.4, 0.41))
    sum_o = rng.uniform(20.0, 300.0, n).round()
    ell_raw = sum_o * rng.normal(-0.3, 0.5, n)
    prev_like = 50.0 * rng.normal(-0.3, 0.5, n)
    z = (prev_t - prior_t) / np.asarray(sigma_t)
    prev_prior = (-0.5 * z * z - np.log(sigma_t) - 0.5 * math.log(2.0 * math.pi)).sum(1)
    prev_prob = prev_prior - math.log(2.0 * math.pi ** 2) + phi * prev_like
    u = rng.uniform(0.0, 1.0, n)
    if case in ("sum_o_zero", "constant"):
        sum_o[rng.uniform(size=n) < 0.25] = 0.0
        down = rng.uniform(size=n) < 0.125
        prev_like[down] = prev_prob[down] = -np.inf
    if case == "u_zero":
        u[rng.uniform(size=n) < 0.25] = 0.0
        u[int(rng.integers(n))] = 1.0 - 2.0 ** -24
    ell_raw, sum_o = on(ell_raw), on(sum_o)
    post.render = lambda sample, batch_ndim=1: (ell_raw, sum_o)
    prop_t, prev_t = on(prop_t), on(prev_t)
    if proposal != "t_walk":  # the proposal moves r alone: t is the previous tensor
        prop_t = prev_t
    prev_r = on(prev_r)
    prop_r = prev_r if proposal == "t_walk" else on(prop_r)
    return {"posterior": post, "proposal": props[proposal], "ell_raw": ell_raw, "sum_o": sum_o,
            "proposed": Sample({"t": prop_t, "r": prop_r}),
            "previous": Sample({"t": prev_t, "r": prev_r}, on(prev_prob), on(prev_like)),
            "old_temp": on(phi), "new_temp": on(phi_new), "u": on(u)}


def mh_move_plain(inp):
    """The plain version of one move (``mh_transition_plain`` with the
    increment): (the accepted Sample, the increment, log α, log u)."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.posterior import retemper
    from bayesianposeestimation.jl_tpu_torch.samplers import mh

    args = (inp["posterior"], inp["proposal"], inp["proposed"], inp["previous"],
            inp["old_temp"], inp["new_temp"], inp["u"])
    out, incr = mh.mh_transition_plain(*args, increment=True)
    proposed = inp["posterior"].tempered_logdensity_sample(inp["proposed"], inp["new_temp"])
    alpha = mh.acceptance_ratio(inp["proposal"], proposed,
                                retemper(inp["previous"], inp["old_temp"], inp["new_temp"]))
    return out, incr, alpha, torch.log(inp["u"])


def mh_move_kernel(inp):
    """The move through ``samplers/mh.mh_transition`` with the increment, as
    an SMC step calls it: (the accepted Sample, the increment, the path
    ``mh_move_path`` chose)."""
    from bayesianposeestimation.jl_tpu_torch.samplers import mh

    args = (inp["posterior"], inp["proposal"], inp["proposed"], inp["previous"],
            inp["old_temp"], inp["new_temp"], inp["u"])
    path = mh.mh_move_path(*args[:4], inp["u"])
    out, incr = mh.mh_transition(*args, increment=True)
    return out, incr, path


def compare_mh_move(inp, out, plain, path="kernel"):
    """The kernel's move ``out`` (``mh_move_kernel``) against the plain one
    (``mh_move_plain``) on the same inputs, as a dict with ``ok``: the path
    taken is ``path``; t, r, log_prob, log_like and the increment within
    ``MH_MOVE_ULP`` units in the last place (NaN where NaN, infinities
    equal); the accept decisions, read as which log_prob was kept, equal
    but where |log u - log α| lies within that bound."""
    import numpy as np
    import torch

    sample, incr, taken = out
    p_sample, p_incr, alpha, log_u = plain

    def ulps(a, b):
        a, b = a.detach().cpu().numpy().astype(np.float32), b.detach().cpu().numpy()
        same_nan = np.isnan(a) == np.isnan(b)
        ia = a.view(np.int32).astype(np.int64)
        ib = b.view(np.int32).astype(np.int64)
        ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)  # a line of floats: -0 == +0
        ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
        gap = np.where(np.isnan(a) & np.isnan(b), 0, np.abs(ia - ib))
        return int(gap.max(initial=0)) if same_nan.all() else 2 ** 31

    names = ("t", "r")
    gaps = {k: ulps(sample.variables[k], p_sample.variables[k]) for k in names}
    gaps.update(log_prob=ulps(sample.log_prob, p_sample.log_prob),
                log_like=ulps(sample.log_like, p_sample.log_like), incr=ulps(incr, p_incr))
    prev = inp["previous"].variables

    def moved(s):  # which particles took their proposal
        return ~(torch.all(s.variables["t"] == prev["t"], dim=1)
                 & torch.all(s.variables["r"] == prev["r"], dim=1))

    accepted, p_accepted = moved(sample), moved(p_sample)
    differ = (accepted != p_accepted).cpu()
    margin = (log_u - alpha).abs().cpu()
    spacing = torch.finfo(torch.float32).eps * torch.maximum(alpha.abs().cpu(),
                                                             torch.ones_like(margin))
    off = int((differ & ~(margin <= MH_MOVE_ULP * spacing)).sum())
    ok = taken == path and all(g <= MH_MOVE_ULP for g in gaps.values()) and off == 0
    return {"ok": ok, "path": taken, **{f"{k}_ulps": v for k, v in gaps.items()},
            "accepted": int(p_accepted.sum()), "decisions_differ": int(differ.sum()),
            "decisions_differ_off_bound": off}


def mh_move_cases(device, n, proposal, path="kernel"):
    """The move through ``mh_transition`` against the plain version in every
    case of ``MH_MOVE_CASES`` at ``n`` particles with ``proposal``: (case,
    ``compare_mh_move``'s dict) a case."""
    out = []
    for case in MH_MOVE_CASES:
        inp = mh_move_inputs(device, n, proposal, case)
        out.append((case, compare_mh_move(inp, mh_move_kernel(inp), mh_move_plain(inp), path)))
    return out


# -- one benchmark cell with the port's telemetry on ---------------------------

ROOTS = ("image.call", "pf.run")  # the port's request roots


def _span_totals(spans):
    """{name: [spans, total s, self s]} of the closed spans."""
    out = {}
    for sp in spans:
        if sp["end_ns"] is not None:
            row = out.setdefault(sp["name"], [0, 0.0, 0.0])
            row[0] += 1
            row[1] += (sp["end_ns"] - sp["start_ns"]) * 1e-9
            row[2] += sp["self_ns"] * 1e-9
    return out


def telemetry_numbers(setup, window):
    """The host loop's split from two telemetry snapshots, the set-up's and
    the window's: µs a step (a tracked frame) outside the replay call
    (``runner.advance`` less the replay nanoseconds) and inside it, each
    counted part of a step and their share of the loop, mean spans of a
    request in ms, the set-up's span totals (s) and capture self time, the
    window's ``render_score`` launches beside their plans' paths, the SMC
    population updates by path, and its
    particle filters' runs, frames and scored poses by kind."""
    counts, spans = window["counts"], _span_totals(window["spans"])
    steps = counts[("runner", "steps")]
    requests = sum(1 for sp in window["spans"] if sp["parent"] == -1 and sp["name"] in ROOTS)
    advance_ns = spans.get("runner.advance", [0, 0.0, 0.0])[1] * 1e9
    parts = {k: counts[("runner", f"{k}_ns")] for k in ("pick", "replay", "report", "feed", "chunk")}
    setup_spans = _span_totals(setup["spans"])
    return {
        "requests": requests, "steps": steps,
        "runner_host_us": (advance_ns - parts["replay"]) / steps * 1e-3 if steps else None,
        "replay_call_us": parts["replay"] / steps * 1e-3 if steps else None,
        "parts_us": {k: v / steps * 1e-3 for k, v in parts.items()} if steps else {},
        "parts_share_of_loop": sum(parts.values()) / advance_ns if advance_ns else None,
        "picks": {k[2]: v for k, v in counts.items() if k[:2] == ("runner", "picks")},
        "request_ms": {k: v[1] / requests * 1e3 for k, v in spans.items()} if requests else {},
        "setup_s": setup_spans,
        "setup_capture_s": setup_spans.get("runner.capture", [0, 0.0, 0.0])[2],
        "setup_counts": {"/".join(k): v for k, v in setup["counts"].items()
                         if k[0] in ("graph", "library")},
        "render_score_launches": sum(v for k, v in counts.items() if k[0] == "render_score"),
        "render_score_paths": {k[1]: v for k, v in counts.items()
                               if k[0] == "render_score_path"},
        "smc_update_paths": {k[1]: v for k, v in counts.items() if k[0] == "smc_update_path"},
        "mh_move_paths": {k[1]: v for k, v in counts.items() if k[0] == "mh_move_path"},
        "pf": {"/".join(k[1:]): v for k, v in counts.items() if k[0] == "pf"},
        "dropped": setup["dropped"] + window["dropped"],
    }


def telemetry_cell(name, seed, seconds, device="cuda", cell=None, config=None):
    """One benchmark cell served as its untraced runs serve it, with the
    port's telemetry on from before the set-up to the end of the window (the
    set-up's spans taken apart by a snapshot after ``Entry.setup``): the
    cell's end-to-end metrics, ``correct`` and ``telemetry_numbers``.
    ``cell`` / ``config`` in place of the cell files' (a test size)."""
    import torch

    from bayesianposeestimation.jl_tpu_torch import telemetry
    from portbench import cells
    from portbench.run import run_cell

    if cell is None:
        cell, config = cells.load(name)
    entry = cells.entry_module(config).Entry
    setup, snaps = entry.setup, {}

    def setup_then_snapshot(self):
        setup(self)
        if device != "cpu":
            torch.cuda.synchronize()
        snaps["setup"] = telemetry.snapshot()
        telemetry.reset()

    entry.setup = setup_then_snapshot
    telemetry.reset()
    telemetry.enable()
    try:
        result, _, _ = run_cell(cell, config, seed, seconds, False, device)
        window = telemetry.snapshot()  # the check after the window calls nothing of the port
    finally:
        telemetry.disable()
        telemetry.reset()
        entry.setup = setup
    return {"cell": name, "seed": seed, "correct": result["correct"],
            "failed": result["failed"], "attempted": result["attempted"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "telemetry": telemetry_numbers(snaps["setup"], window)}
