"""BOP validation sweep through the PyTorch/CUDA port (counterpart of
``scripts/smc_bop_val.py``): time-budgeted pose estimation on a BOP split,
then VSD / VSDBOP / ADD-S evaluation, greedy matching and recall.

Per target row: a position prior from the visible mask, a 30x30 crop camera
around it, and a chain on the decimated model (1,800 faces) with the step
count calibrated per object to the per-pose time budget. SMC (``smc_mh``,
100 particles) reports the final population's best particle; the MCMC
baselines (``mh_sampler``, ``mtm_sampler``: one chain, 10 tries) the best
sample of the whole chain. Evaluation renders every estimate and the ground
truth of an image on the undecimated model in 100x100 crops around the
ground truth.

    python scripts/torch_smc_bop_val.py --dataset synthcad --testset val \\
        --scenes 1 2 3 --samplers smc_mh mh_sampler mtm_sampler

Artifacts go to data/exp_raw/<experiment-name>_cuda/ (estimates) and
data/exp_pro/<experiment-name>_cuda/ (errors/, sampler_recall.csv,
recall_vs_visibility.csv) under the current directory, beside the JAX
package's own artifacts, which stay the reference; the data set is read from
--bop-dir. ``--mode steps --n-steps N`` runs every chain for N steps instead
of the time budget. No plots are drawn (the card's machine has no
matplotlib); the CSVs hold the numbers. Runs on the CUDA device unless
``--device cpu`` is given (slow: the CPU runs the kernels' plain versions).
"""

import argparse
import csv
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# The tuned parameters of scripts/smc_bop_val.py. TUNED_PARAMETERS: the
# hyperopt optimum on the VGA multi-instance synthetic set; its tight
# position prior keeps an occluded instance's chain off its occluder.
TUNED_PARAMETERS = dict(
    pixel_sigma=0.0019, association_sigma=0.0019, o_mask_is=0.87,
    o_mask_not=0.20, sigma_t=(0.0108, 0.0108, 0.0108),
    proposal_sigma_r=(1.48, 1.48, 1.48),
)
# Per-(dataset, sampler) optima: each sampler is compared at its own
# synthcad-train optimum (the three hyperopts selected the same candidate).
CAD_TUNED = dict(
    pixel_sigma=0.002488, association_sigma=0.002488, o_mask_is=0.9564,
    o_mask_not=0.3708, sigma_t=(0.01579, 0.01579, 0.01579),
    proposal_sigma_r=(2.2945, 2.2945, 2.2945),
)
DATASET_TUNED = {
    ("synth", None): TUNED_PARAMETERS,
    ("synthcad", "smc_mh"): CAD_TUNED,
    ("synthcad", "mh_sampler"): CAD_TUNED,
    ("synthcad", "mtm_sampler"): CAD_TUNED,
    ("synthcad", None): CAD_TUNED,
}
# the likelihood and proposal settings of the dissertation's ablation and
# MCMC sweeps (scripts/smc_mh_baseline.py, smc_observation.py, smc_priors.py,
# smc_mh_resolution.py, mcmc_benchmark.py)
SWEEP_TUNED = dict(pixel_sigma=0.005, association_sigma=0.005, o_mask_is=0.9,
                   proposal_sigma_r=(math.pi,) * 3)
SAMPLERS = ("smc_mh", "smc_forward", "smc_bootstrap", "mh_sampler", "mtm_sampler")
MCMC_TRIES = 10  # the try count the MCMC baselines were tuned at
EVAL_CROP = 100  # evaluation crops around each ground truth, in pixels


def tuned_parameters(dataset, sampler=None):
    """Most specific tuned set: (dataset, sampler), then (dataset, None),
    then TUNED_PARAMETERS."""
    return DATASET_TUNED.get((dataset, sampler),
                             DATASET_TUNED.get((dataset, None), TUNED_PARAMETERS))


def _quantize_steps(n):
    """Floor a calibrated step count onto a coarse grid (~6 % granularity),
    exact below 64 steps. Kept from the JAX script (where equal counts reuse
    compiled programs), so both packages run the same step counts."""
    if n < 64:
        return n
    grid = 32
    while grid * 16 <= n:
        grid *= 2
    return (n // grid) * grid


PACE_RUNS = 3  # an object's step count follows the mean pace of its last runs


def _paced_steps(obj, pace, budget):
    """Record a run's realized ``pace`` (seconds per step) for the object
    and return its next step count: the budget's at the mean pace of its
    last PACE_RUNS runs, quantized, never above its calibrated count."""
    from bayesianposeestimation.jl_tpu_torch.utils.evaluation import steps_for_time_budget

    if pace > 0:  # a run within its overhead says nothing of the pace
        obj["paces"].append(pace)
    if not obj["paces"]:
        return obj["n_cal"]
    return min(obj["n_cal"], _quantize_steps(steps_for_time_budget(
        float(np.mean(obj["paces"][-PACE_RUNS:])), budget, overhead=obj["overhead"])))


def is_mcmc(sampler_name):
    return sampler_name.startswith(("mh", "mtm"))


def image_inputs(row, parameters, prior_mode, o_mode, noise_rng):
    """One target row's inference inputs: (crop camera, cropped observation,
    prior_o [H, W], prior_t [3]), with the script's prior modes."""
    from bayesianposeestimation.jl_tpu_torch.camera import crop_camera, crop_image
    from bayesianposeestimation.jl_tpu_torch.models.experiment_models import (
        point_from_segmentation,
    )
    from bayesianposeestimation.jl_tpu_torch.utils import bop

    diameter = bop.model_diameter(row)
    full_cam = bop.camera_for_row(row)
    full_depth = bop.load_depth_image(row)
    full_mask = bop.load_mask_image(row)
    if prior_mode in ("point", "point_mask"):
        # RFID-tag-style position prior: the ground truth + 5 mm noise
        prior_t = np.asarray(row["gt_t"], np.float32) + noise_rng.normal(
            0.0, 0.005, 3).astype(np.float32)
    else:
        ys, xs = np.nonzero(full_mask)
        bbox = (xs.min(), xs.max(), ys.min(), ys.max()) if xs.size else (0, 1, 0, 1)
        prior_t = point_from_segmentation(bbox, full_depth, full_mask, full_cam,
                                          diameter=diameter)
    cam = crop_camera(full_cam, prior_t, diameter, width=parameters.width,
                      height=parameters.height)
    obs = crop_image(full_depth, full_cam, cam)
    if o_mode in ("flat", "flat_is"):
        fill = 0.5 if o_mode == "flat" else float(parameters.o_mask_is)
        prior_o = np.full((parameters.height, parameters.width), fill, np.float32)
    else:
        mask_crop = crop_image(full_mask, full_cam, cam)
        prior_o = np.where(mask_crop, parameters.o_mask_is, parameters.o_mask_not)
    return cam, obs, np.asarray(prior_o, np.float32), prior_t


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(run, device, *args, **kw):
    t0 = time.perf_counter()
    out = run(*args, **kw)
    _sync(device)
    return out, time.perf_counter() - t0


def scene_inference(config, bop_dir, parameters, device="cuda", fixed_steps=False):
    """Estimate a pose for every target row of one scene. Config keys:
    dataset, testset, scene_id, sampler, and optionally variant (the score
    variant), prior (mask | point | point_mask), o_prior (mask | flat |
    flat_is), resolution (crop side) and mode ("steps": run
    ``parameters.n_steps`` steps instead of the time budget; ``fixed_steps``
    does the same for a config that keeps the time budget's name).

    Under the time budget each object's step count comes from its
    calibrated step time (``mean_step_time``, the fastest of its probes),
    then follows the pace its runs realize: after the warm-up, three probe
    runs, then each timed run, the next run's count is the budget's at the
    mean pace (``realized_step_time``) of the object's last three runs,
    never above the calibrated count. A run is never cut short: its steps
    are fixed when it starts. One chain runner per object serves every step
    count, so its steps are captured once, by the warm-up, before any run
    is timed."""
    from bayesianposeestimation.jl_tpu_torch.models import experiment_samplers as es
    from bayesianposeestimation.jl_tpu_torch.models.fused import (
        fused_posterior,
        make_conditioned_chain,
    )
    from bayesianposeestimation.jl_tpu_torch.parameters import Experiment
    from bayesianposeestimation.jl_tpu_torch.utils import bop
    from bayesianposeestimation.jl_tpu_torch.utils.evaluation import (
        mean_step_time,
        realized_step_time,
        steps_for_time_budget,
    )
    from bayesianposeestimation.jl_tpu_torch.utils.experiment_io import load_img_mesh

    sampler_name = config["sampler"]
    variant = config.get("variant", "association")
    prior_mode = config.get("prior", "mask")
    o_mode = config.get("o_prior", "flat_is" if prior_mode == "point" else "mask")
    if "resolution" in config:
        res = int(config["resolution"])
        parameters = parameters.replace(width=res, height=res)
    fixed_steps = fixed_steps or config.get("mode") == "steps"
    budget = parameters.time_budget
    rows_in = bop.bop_test_or_train(bop_dir, config["dataset"], config["testset"],
                                    config["scene_id"])
    seed = parameters.seed % (2**31)
    noise_rng = np.random.default_rng()  # unseeded, as the JAX script's
    sampler_factory = getattr(es, sampler_name)
    # the MCMC baselines run one chain; n_particles is their try count
    n_chains = 1 if is_mcmc(sampler_name) else parameters.n_particles

    rows = []
    first_steps = first_step_time = None
    calibration = {}
    objects, meshes = {}, {}  # per object: its calibration and paces; its mesh
    runners = {}  # per object: its chain runner, which takes each run's step count

    def runner(obj_key, n):
        if obj_key not in runners:
            mesh = meshes[obj_key[0]]
            runners[obj_key] = make_conditioned_chain(
                parameters.replace(n_steps=n), mesh.vertices, mesh.faces, variant,
                sampler_factory, n, n_chains=n_chains, device=device)
        return runners[obj_key]

    for i, row in enumerate(rows_in):
        args = image_inputs(row, parameters, prior_mode, o_mode, noise_rng)
        cam, obs, prior_o, prior_t = args
        if int(row["obj_id"]) not in meshes:
            meshes[int(row["obj_id"])] = load_img_mesh(row, parameters)[2]
        mesh = meshes[int(row["obj_id"])]
        obj_key = (int(row["obj_id"]), mesh.n_faces)
        if obj_key not in objects:
            # calibrated per object: the step time grows with the mesh
            experiment = Experiment(
                scene={"camera": cam, "verts": mesh.vertices, "faces": mesh.faces},
                prior_o=torch.as_tensor(prior_o), prior_t=prior_t,
                depth_image=torch.as_tensor(obs))
            posterior = fused_posterior(parameters, experiment, variant, device=device)
            step_time, overhead = mean_step_time(seed, posterior,
                                                 sampler_factory(parameters, posterior),
                                                 n_chains, max_seconds=0.5,
                                                 return_overhead=True)
            if fixed_steps:
                n_cal = parameters.n_steps
            else:
                n_cal = _quantize_steps(steps_for_time_budget(step_time, budget,
                                                              overhead=overhead))
            obj = dict(n_cal=n_cal, n=n_cal, overhead=overhead, paces=[])
            _timed(runner(obj_key, n_cal), device, seed + 10**6, *args, n_steps=n_cal)  # warm-up
            if not fixed_steps:
                # probe runs: the pace the real runner realizes, per-run
                # costs included, sets the first timed run's count
                for k in range(1, 4):
                    wall = _timed(runner(obj_key, n_cal), device, seed + 10**6 + k, *args,
                                  n_steps=n_cal)[1]
                    obj["n"] = _paced_steps(obj, realized_step_time(wall, n_cal, overhead),
                                            budget)
            print(f"  obj {obj_key[0]} step time {step_time * 1e3:.3f} ms "
                  f"(+{overhead * 1e3:.1f} ms per run) -> {n_cal} steps per {budget} s budget"
                  + ("" if fixed_steps else f"; at the probes' pace {obj['n']} steps"))
            if first_steps is None:
                first_steps, first_step_time = obj["n"], step_time
            calibration[str(obj_key[0])] = dict(n_steps=int(obj["n"]), step_time=float(step_time))
            objects[obj_key] = obj

        obj = objects[obj_key]
        n_run = obj["n"]
        (outs, _), wall = _timed(runner(obj_key, n_run), device, seed + i, *args,
                                 n_steps=n_run)
        if not fixed_steps:
            obj["n"] = _paced_steps(obj, realized_step_time(wall, n_run, obj["overhead"]),
                                    budget)
        ll_all = outs["log_like"].cpu().numpy()  # [steps, chains]
        if is_mcmc(sampler_name):
            # the best sample over the whole chain
            step_i, chain_i = np.unravel_index(np.argmax(ll_all), ll_all.shape)
        else:
            # the best particle of the final population
            step_i, chain_i = ll_all.shape[0] - 1, int(np.argmax(ll_all[-1]))
        rows.append(dict(
            scene_id=int(row["scene_id"]), img_id=int(row["img_id"]),
            gt_id=int(row["gt_id"]), obj_id=int(row["obj_id"]),
            t=outs["t"][step_i, chain_i].cpu().numpy(),
            q=outs["r"][step_i, chain_i].cpu().numpy(),
            score=float(ll_all[step_i, chain_i]), time=wall, n_steps=int(n_run),
            gt_t=np.asarray(row["gt_t"]), gt_R=np.asarray(row["gt_R"]),
            cam_K=np.asarray(row["cam_K"]), depth_scale=float(row["depth_scale"]),
            visib_fract=float(row.get("visib_fract", 1.0)),
        ))
        print(f"  scene {row['scene_id']} img {row['img_id']} obj {row['obj_id']}: "
              f"{wall:.3f}s {n_run} steps score {rows[-1]['score']:.1f}")
    return {"result_rows": rows, "n_steps": first_steps, "step_time": first_step_time,
            "calibration": calibration}


def evaluate_scene(config, bop_dir, parameters, result_rows, device="cuda", cache=None):
    """VSD / VSDBOP / ADD-S of one scene's estimates with BOP matching:
    estimates grouped per (scene, img, obj) are scored against every ground
    truth of their object in the image (those with visib_fract >= 0.1), on
    the undecimated model, in 100x100 crops around each ground truth, and
    greedily matched by score; the ground-truth annotations are the recall
    denominator. Each depth image is decoded and each model loaded once per
    ``cache``, a dict a sweep passes to every call (one per call without)."""
    from bayesianposeestimation.jl_tpu_torch import quaternions as quat
    from bayesianposeestimation.jl_tpu_torch.camera import crop_camera, crop_image
    from bayesianposeestimation.jl_tpu_torch.devices import resolve_device
    from bayesianposeestimation.jl_tpu_torch.utils import bop
    from bayesianposeestimation.jl_tpu_torch.utils import evaluation as ev

    dev = resolve_device(device)
    dataset = config["dataset"]
    vsd_delta = ev.ITODD_DELTA if ("itodd" in dataset or "steri" in dataset) else ev.BOP_DELTA
    datasubset = str(Path(bop_dir) / dataset / config["testset"])
    cache = {} if cache is None else cache

    def eval_scene_tensors(r):
        key = ("mesh", datasubset, int(r["obj_id"]), str(dev))
        if key not in cache:
            mesh = bop.load_mesh(r)  # undecimated
            cache[key] = {"verts": torch.as_tensor(mesh.vertices, device=dev),
                          "faces": torch.as_tensor(mesh.faces, device=dev)}
        return cache[key]

    def depth_image(r):
        key = ("depth", datasubset, int(r["scene_id"]), int(r["img_id"]))
        if key not in cache:
            cache[key] = bop.load_depth_image(r)
        return cache[key]

    def errors_fn(ests, gt_group):
        r0 = {**ests[0], "datasubset_path": datasubset}
        scene = eval_scene_tensors(r0)
        diameter = bop.model_diameter(r0)
        full_cam = bop.camera_for_row(r0)
        full_depth = depth_image(r0)
        n_est, n_gt = len(ests), len(gt_group)
        adds = np.zeros((n_est, n_gt))
        vsd = np.zeros((n_est, n_gt))
        vsdbop = np.zeros((n_est, n_gt, len(ev.BOP19_THRESHOLDS)))
        es_ts = np.stack([np.asarray(e["t"], np.float32) for e in ests])
        es_qs = np.stack([np.asarray(e["q"], np.float32) for e in ests])
        for j, g in enumerate(gt_group):
            gt_t = torch.as_tensor(np.asarray(g["gt_t"], np.float32), device=dev)
            gt_q = quat.matrix_to_quat(torch.as_tensor(np.asarray(g["gt_R"], np.float32),
                                                       device=dev))
            cam = crop_camera(full_cam, np.asarray(g["gt_t"], np.float32), diameter,
                              width=EVAL_CROP, height=EVAL_CROP)
            crop = crop_image(full_depth, full_cam, cam)
            vsd[:, j], vsdbop[:, j] = ev.vsd_errors_batch(scene, cam, crop, es_ts, es_qs, gt_t,
                                                          gt_q, diameter, delta=vsd_delta)
            for i in range(n_est):
                adds[i, j] = float(ev.normalized_adds_error(scene["verts"], es_ts[i], es_qs[i],
                                                            gt_t, gt_q, diameter))
        return {"adds": adds, "vsd": vsd, "vsdbop": vsdbop}

    gt_rows = bop.bop_test_or_train(bop_dir, dataset, config["testset"], config["scene_id"])
    return ev.match_scene_errors(result_rows, errors_fn, gt_rows=gt_rows)


def recall_rows(all_errors):
    """Per sampler: ADD-S, VSD and VSDBOP recall with Wilson intervals, and
    VSD recall per visibility bin."""
    from bayesianposeestimation.jl_tpu_torch.utils import evaluation as ev

    rows, visib_rows = [], []
    for sampler_name, errs in all_errors.items():
        adds = np.concatenate([e["adds"] for e in errs])
        vsd = np.concatenate([e["vsd"] for e in errs])
        vsdbop = np.concatenate([e["vsdbop"] for e in errs])
        n_adds = ev.threshold_errors(adds, ev.ADDS_THETA)
        n_vsd = ev.threshold_errors(vsd, ev.BOP18_THETA)
        n_vsdbop = ev.threshold_errors(vsdbop, np.asarray(ev.BOP19_THRESHOLDS))
        adds_lo, adds_hi = ev.recall_ci(*n_adds)
        vsd_lo, vsd_hi = ev.recall_ci(*n_vsd)
        rows.append(dict(sampler=sampler_name, adds_recall=ev.recall(*n_adds),
                         vsd_recall=ev.recall(*n_vsd), vsdbop_recall=ev.recall(*n_vsdbop),
                         n_gt=n_vsd[1], adds_ci_lo=adds_lo, adds_ci_hi=adds_hi,
                         vsd_ci_lo=vsd_lo, vsd_ci_hi=vsd_hi))
        visib = np.concatenate([e.get("visib", np.ones(len(e["vsd"]))) for e in errs])
        for lo, hi in [(0.1, 0.3), (0.3, 0.5), (0.5, 0.7), (0.7, 0.9), (0.9, 1.01)]:
            sel = (visib >= lo) & (visib < hi)
            if not sel.any():
                continue
            nc, nt = ev.threshold_errors(vsd[sel], ev.BOP18_THETA)
            ci = ev.recall_ci(nc, nt)
            visib_rows.append(dict(sampler=sampler_name, visib_lo=lo, visib_hi=min(hi, 1.0),
                                   n_gt=nt, vsd_recall=ev.recall(nc, nt), ci_lo=ci[0],
                                   ci_hi=ci[1]))
    return rows, visib_rows


def write_csv(path, rows):
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def card_line(device):
    """The card's name and power limit as nvidia-smi gives them, printed
    (None on the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False, timeout=60).stdout.strip()
    print(f"card: {smi}")
    return smi


def common_args(description, dataset="synth"):
    """The arguments every BOP sweep script takes."""
    ap = argparse.ArgumentParser(description=description,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--bop-dir", default="data/bop")
    ap.add_argument("--dataset", default=dataset)
    ap.add_argument("--testset", default="val")
    ap.add_argument("--scenes", type=int, nargs="+", default=[1])
    ap.add_argument("--device", default="cuda")
    return ap


def scene_recalls(errors):
    """ADD-S, VSD and VSDBOP recall of one config's errors."""
    from bayesianposeestimation.jl_tpu_torch.utils import evaluation as ev

    return dict(
        adds_recall=ev.recall(*ev.threshold_errors(errors["adds"], ev.ADDS_THETA)),
        vsd_recall=ev.recall(*ev.threshold_errors(errors["vsd"], ev.BOP18_THETA)),
        vsdbop_recall=ev.recall(*ev.threshold_errors(errors["vsdbop"],
                                                     np.asarray(ev.BOP19_THRESHOLDS))))


def run_config(name, config, parameters, bop_dir, device, signature=None, cache=None,
               data_root="data", fixed_steps=False):
    """``scene_inference`` and ``evaluate_scene`` of one config, each through
    ``produce_or_load``: the estimates under <data_root>/exp_raw/<name>_cuda,
    the errors under <data_root>/exp_pro/<name>_cuda/errors. ``fixed_steps``:
    every chain runs ``parameters.n_steps`` steps. Returns (result, errors)."""
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import produce_or_load, savename

    root = Path(data_root)
    print(f"config: {config}")
    result, _ = produce_or_load(
        lambda c: scene_inference(c, bop_dir, parameters, device, fixed_steps),
        config, root / "exp_raw" / f"{name}_cuda", filename=savename(config),
        signature=signature)
    t0 = time.perf_counter()
    errors, _ = produce_or_load(
        lambda c: evaluate_scene(c, bop_dir, parameters, result["result_rows"], device, cache),
        config, root / "exp_pro" / f"{name}_cuda" / "errors", filename=savename(config),
        signature=signature)
    walls = [float(r["time"]) for r in result["result_rows"]]
    fixed_steps = fixed_steps or config.get("mode") == "steps"
    print(f"  evaluation {time.perf_counter() - t0:.2f} s; {int(result['n_steps'])} steps "
          f"per run of the first object ({float(result['step_time']) * 1e3:.4f} ms per step); "
          f"wall per pose mean {np.mean(walls):.4f} s, max {np.max(walls):.4f} s ("
          + (f"{parameters.n_steps} steps each)" if fixed_steps else
             f"budget {parameters.time_budget} s)"))
    return result, errors


def write_table(name, filename, rows, data_root="data"):
    """``rows`` as <data_root>/exp_pro/<name>_cuda/<filename>, printed."""
    out_dir = Path(data_root) / "exp_pro" / f"{name}_cuda"
    out_dir.mkdir(parents=True, exist_ok=True)
    write_csv(out_dir / filename, rows)
    for r in rows:
        print(", ".join(f"{k}={v}" for k, v in r.items()))
    print(f"wrote {out_dir / filename}")
    return out_dir / filename


def sweep_main(script, args, name, table_name=None):
    """An experiment script's sweep: each of ``script.configs(args)`` through
    ``script.run``, then ``script.table`` of the results written as
    <name>_cuda/<table_name> (default ``script.TABLE``); rows over their
    budget are flagged."""
    from bayesianposeestimation.jl_tpu_torch.devices import resolve_device

    card_line(resolve_device(args.device))
    cache = {}
    results = [(c, *script.run(c, args, cache)) for c in script.configs(args)]
    rows = script.table(results, args)
    for r in rows:
        if not r.get("budget_ok", True):
            print(f"  WARN over budget: {r}")
    return write_table(name, table_name or script.TABLE, rows)


def parse_args(argv=None):
    ap = common_args(__doc__)
    ap.add_argument("--samplers", nargs="+", default=["smc_mh"], choices=SAMPLERS)
    ap.add_argument("--time-budget", type=float, default=0.5)
    ap.add_argument("--n-particles", type=int, default=100)
    ap.add_argument("--mode", choices=("time", "steps"), default="time")
    ap.add_argument("--n-steps", type=int, default=None,
                    help="steps per chain with --mode steps")
    ap.add_argument("--experiment-name", default="smc_bop_val")
    args = ap.parse_args(argv)
    if args.mode == "steps" and args.n_steps is None:
        ap.error("--mode steps needs --n-steps")
    return args


def sweep_configs(args):
    """The configs of the sweep, in the order the sweep runs them."""
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import dict_list

    sweep = {"sampler": list(args.samplers), "dataset": args.dataset,
             "testset": args.testset, "scene_id": list(args.scenes)}
    if args.mode == "steps":
        sweep["mode"] = "steps"
    return dict_list(sweep)


def main(argv=None):
    args = parse_args(argv)

    from bayesianposeestimation.jl_tpu_torch.devices import resolve_device
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import datadir

    device = resolve_device(args.device)
    card_line(device)
    name = f"{args.experiment_name}_cuda"
    all_errors, steps, cache = {}, {}, {}
    for config in sweep_configs(args):
        eff_particles = MCMC_TRIES if is_mcmc(config["sampler"]) else args.n_particles
        tuned = tuned_parameters(args.dataset, config["sampler"])
        parameters = Parameters(n_particles=eff_particles, time_budget=args.time_budget,
                                device=device.type, **tuned,
                                **({"n_steps": args.n_steps} if args.n_steps else {}))
        signature = dict(n_particles=eff_particles, time_budget=args.time_budget, **tuned)
        if args.mode == "steps":
            signature["n_steps"] = args.n_steps
        result, errors = run_config(args.experiment_name, config, parameters, args.bop_dir,
                                    device, signature, cache)
        all_errors.setdefault(config["sampler"], []).append(errors)
        steps.setdefault(config["sampler"], []).extend(
            int(c["n_steps"]) for c in dict(result["calibration"]).values())

    rows, visib_rows = recall_rows(all_errors)
    for r in rows:
        s = steps[r["sampler"]]
        print(f"{r['sampler']}: ADDS recall {r['adds_recall']:.3f} [{r['adds_ci_lo']:.3f},"
              f"{r['adds_ci_hi']:.3f}], VSD recall {r['vsd_recall']:.3f} [{r['vsd_ci_lo']:.3f},"
              f"{r['vsd_ci_hi']:.3f}] (n={r['n_gt']}), VSDBOP recall "
              f"{r['vsdbop_recall']:.3f}; steps per budget min {min(s)} median "
              f"{int(np.median(s))} max {max(s)}")
    out_dir = datadir("exp_pro", name)
    out_dir.mkdir(parents=True, exist_ok=True)
    write_csv(out_dir / "sampler_recall.csv", rows)
    if visib_rows:
        write_csv(out_dir / "recall_vs_visibility.csv", visib_rows)
    print(f"wrote {out_dir / 'sampler_recall.csv'}")


if __name__ == "__main__":
    main()
