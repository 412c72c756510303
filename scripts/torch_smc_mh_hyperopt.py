"""Hyperparameter search for the SMC-MH sampler (or an MCMC baseline)
through the PyTorch/CUDA port (counterpart of ``scripts/smc_mh_hyperopt.py``).

The search minimises 1 - VSD recall over the scenes of a split, across five
parameters: o_mask_is, pixel_sigma, sigma_r (the reference's space), sigma_t
and o_mask_not. Trial 0 is the reference's tuned optimum; a quasi-random
batch explores; then a cross-entropy refinement exploits it (a Gaussian fit
to the best 30 % in unit space, with an exploration floor and an occasional
global restart).

Per scene, each target row is prepared once (position prior from the
visible mask, 30x30 crop, cropped observation and mask). Per object, one
chain is calibrated to the time budget once and built with
``make_tuned_chain``. A trial passes its candidate as the ``hyper`` dict:
the likelihood sigmas reach the kernel as a device row, so every trial runs
the same kernel and step count. SMC reports the best particle of the final
population; the MCMC baselines (one chain, 10 tries) the best sample of the
whole chain. Candidates within one train gt of the best cost are replayed on
the --tiebreak-scenes of --tiebreak-testset when given.

    python scripts/torch_smc_mh_hyperopt.py --dataset synthcad --testset train \\
        --scenes 1 2 3 --trials 10 --time-budget 0.5 --seed 0 \\
        --experiment-name smc_mh_hyperopt_cad

Estimates go to data/exp_raw/<experiment-name>_cuda/ (with the first
object's step count and step time, and every object's), errors to
data/exp_pro/<experiment-name>_cuda/errors/ and the search to
data/exp_pro/<experiment-name>_cuda/trials.csv under the current directory
(cached per trial and scene: a resumed search replays at once). The search
seed defaults to crc32(sampler) & 0xFFFF, as the JAX script's; the JAX
package's checked-in searches ran with --seed 0. Runs on the CUDA device
unless ``--device cpu`` is given.
"""

import sys
import time
import zlib
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch_smc_bop_val as bopval  # noqa: E402

# (name, low, high, log-scale): the reference's three parameters, then the
# position prior's sigma and the prior of "object" outside the visible mask
SPACE = [
    ("o_mask_is", 0.5, 1.0, False),
    ("pixel_sigma", 1e-4, 0.02, True),
    ("sigma_r", 0.01, 3.14159265, False),
    ("sigma_t", 0.004, 0.05, True),
    ("o_mask_not", 0.005, 0.5, True),
]


def _to_unit(cand):
    u = []
    for name, lo, hi, log in SPACE:
        v = cand[name]
        u.append((np.log(v) - np.log(lo)) / (np.log(hi) - np.log(lo)) if log
                 else (v - lo) / (hi - lo))
    return np.asarray(u)


def _from_unit(u):
    cand = {}
    for (name, lo, hi, log), x in zip(SPACE, np.clip(u, 0.0, 1.0)):
        cand[name] = float(np.exp(np.log(lo) + x * (np.log(hi) - np.log(lo)))
                           if log else lo + x * (hi - lo))
    return cand


def next_candidate(history, rng, n_explore=6):
    """Seeded optimum -> quasi-random exploration -> cross-entropy refinement."""
    if not history:
        return dict(o_mask_is=0.9, pixel_sigma=0.005, sigma_r=float(np.pi),
                    sigma_t=0.03, o_mask_not=0.3)
    n = len(history)
    if n < n_explore:  # exploration batch
        return _from_unit(rng.uniform(size=len(SPACE)))
    # CEM: fit a Gaussian to the top-30% trials in unit space
    ranked = sorted(history, key=lambda h: h["cost"])
    elite = np.stack([_to_unit(h) for h in ranked[:max(2, int(0.3 * n))]])
    mean, std = elite.mean(0), elite.std(0) + 0.05  # exploration floor
    if rng.uniform() < 0.2:  # occasional global restart
        return _from_unit(rng.uniform(size=len(SPACE)))
    return _from_unit(rng.normal(mean, std))


def hyper_of(cand):
    """A candidate as ``make_tuned_chain``'s ``hyper`` dict."""
    return dict(pixel_sigma=cand["pixel_sigma"], association_sigma=cand["pixel_sigma"],
                sigma_t=(cand["sigma_t"],) * 3, proposal_sigma_r=(cand["sigma_r"],) * 3)


def build_scene_runner(scene_id, args, parameters, testset=None, device="cuda"):
    """Prepare one scene's rows once, calibrate and build one tuned chain per
    object, and return ``run_trial(cand, seed) -> result rows``
    (``scene_inference``'s rows; the candidate changes no shape, so trials
    share the calibration and the runners). ``run_trial.calibration``: per
    object, the step count and the calibrated step time."""
    from bayesianposeestimation.jl_tpu_torch.camera import crop_camera, crop_image
    from bayesianposeestimation.jl_tpu_torch.models import experiment_samplers as es
    from bayesianposeestimation.jl_tpu_torch.models.experiment_models import (
        point_from_segmentation,
    )
    from bayesianposeestimation.jl_tpu_torch.models.fused import (
        fused_posterior,
        make_tuned_chain,
    )
    from bayesianposeestimation.jl_tpu_torch.parameters import Experiment
    from bayesianposeestimation.jl_tpu_torch.utils import bop, evaluation
    from bayesianposeestimation.jl_tpu_torch.utils.experiment_io import load_img_mesh

    testset = testset or args.testset
    rows_in = bop.bop_test_or_train(args.bop_dir, args.dataset, testset, scene_id)
    sampler_factory = getattr(es, args.sampler)
    mcmc = bopval.is_mcmc(args.sampler)
    n_chains = 1 if mcmc else parameters.n_particles
    seed0 = parameters.seed % (2**31)

    items, runners, meshes, calibration = [], {}, {}, {}
    for row in rows_in:
        obj_id = int(row["obj_id"])
        if obj_id not in meshes:
            meshes[obj_id] = load_img_mesh(row, parameters)[2]
        mesh = meshes[obj_id]
        diameter = bop.model_diameter(row)
        full_cam = bop.camera_for_row(row)
        full_depth = bop.load_depth_image(row)
        full_mask = bop.load_mask_image(row)
        ys, xs = np.nonzero(full_mask)
        bbox = (xs.min(), xs.max(), ys.min(), ys.max()) if xs.size else (0, 1, 0, 1)
        prior_t = point_from_segmentation(bbox, full_depth, full_mask, full_cam,
                                          diameter=diameter)
        cam = crop_camera(full_cam, prior_t, diameter, width=parameters.width,
                          height=parameters.height)
        obs = np.asarray(crop_image(full_depth, full_cam, cam), np.float32)
        mask_crop = np.asarray(crop_image(full_mask, full_cam, cam))
        obj_key = (obj_id, mesh.n_faces)
        if obj_key not in runners:
            # calibrated once per object: the step time does not depend on the
            # candidate (same kernel, same shapes)
            experiment = Experiment(
                scene={"camera": cam, "verts": mesh.vertices, "faces": mesh.faces},
                prior_o=torch.full((parameters.height, parameters.width),
                                   float(parameters.o_mask_is)),
                prior_t=prior_t, depth_image=torch.as_tensor(obs))
            posterior = fused_posterior(parameters, experiment, "association", device=device)
            step_time, overhead = evaluation.mean_step_time(
                seed0, posterior, sampler_factory(parameters, posterior), n_chains,
                max_seconds=0.5, return_overhead=True)
            n_steps = bopval._quantize_steps(evaluation.steps_for_time_budget(
                step_time, parameters.time_budget, overhead=overhead))
            print(f"  scene {scene_id} obj {obj_id}: step {step_time * 1e3:.3f} ms "
                  f"(+{overhead * 1e3:.1f} ms per run) -> {n_steps} steps per "
                  f"{parameters.time_budget} s budget")
            runners[obj_key] = (make_tuned_chain(
                parameters.replace(n_steps=n_steps), mesh.vertices, mesh.faces, "association",
                sampler_factory, n_steps, n_chains=n_chains, device=device), n_steps)
            calibration[str(obj_id)] = dict(n_steps=int(n_steps), step_time=float(step_time))
        items.append(dict(row=row, cam=cam, obs=obs, mask_crop=mask_crop,
                          prior_t=np.asarray(prior_t, np.float32), obj_key=obj_key))

    def run_trial(cand, seed):
        hyper = hyper_of(cand)
        rows = []
        for i, it in enumerate(items):
            run_fn, _ = runners[it["obj_key"]]
            prior_o = np.where(it["mask_crop"], cand["o_mask_is"],
                               cand["o_mask_not"]).astype(np.float32)
            (outs, _), wall = bopval._timed(run_fn, device, seed + i, it["cam"], it["obs"],
                                            prior_o, it["prior_t"], hyper)
            ll_all = outs["log_like"].cpu().numpy()  # [steps, chains]
            if mcmc:  # the best sample over the whole chain
                step_i, chain_i = np.unravel_index(np.argmax(ll_all), ll_all.shape)
            else:  # the best particle of the final population
                step_i, chain_i = ll_all.shape[0] - 1, int(np.argmax(ll_all[-1]))
            row = it["row"]
            rows.append(dict(
                scene_id=int(row["scene_id"]), img_id=int(row["img_id"]),
                gt_id=int(row["gt_id"]), obj_id=int(row["obj_id"]),
                t=outs["t"][step_i, chain_i].cpu().numpy(),
                q=outs["r"][step_i, chain_i].cpu().numpy(),
                score=float(ll_all[step_i, chain_i]), time=wall,
                gt_t=np.asarray(row["gt_t"]), gt_R=np.asarray(row["gt_R"]),
                cam_K=np.asarray(row["cam_K"]), depth_scale=float(row["depth_scale"]),
                visib_fract=float(row.get("visib_fract", 1.0))))
        return rows

    run_trial.calibration = calibration
    return run_trial


def parse_args(argv=None):
    ap = bopval.common_args(__doc__)
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--time-budget", type=float, default=0.25)
    ap.add_argument("--n-particles", type=int, default=100)
    ap.add_argument("--sampler", default="smc_mh", choices=bopval.SAMPLERS)
    ap.add_argument("--experiment-name", default="smc_mh_hyperopt")
    ap.add_argument("--seed", type=int, default=None,
                    help="search RNG seed; default derives from the sampler name so the "
                         "per-sampler searches are independent")
    ap.add_argument("--tiebreak-testset", default="val")
    ap.add_argument("--tiebreak-scenes", type=int, nargs="+", default=None,
                    help="scenes for replaying near-tied candidates (default: none, "
                         "ties reported, not broken)")
    return ap.parse_args(argv)


def search_seed(args):
    return args.seed if args.seed is not None else zlib.crc32(args.sampler.encode()) & 0xFFFF


def search_parameters(args):
    """The search's Parameters (MCMC: 10 tries) and artifact signature."""
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters

    n_particles = bopval.MCMC_TRIES if bopval.is_mcmc(args.sampler) else args.n_particles
    return (Parameters(n_particles=n_particles, time_budget=args.time_budget,
                       device=args.device),
            dict(n_particles=n_particles, time_budget=args.time_budget))


def trial_config(args, cand, trial_tag, scene_id, testset):
    """The JAX script's artifact config of one trial on one scene."""
    return {"sampler": args.sampler, "dataset": args.dataset, "testset": testset,
            "scene_id": scene_id, "trial": trial_tag,
            **{k: round(v, 6) for k, v in cand.items()}}


def main(argv=None, data_root="data"):
    args = parse_args(argv)

    from bayesianposeestimation.jl_tpu_torch.devices import resolve_device
    from bayesianposeestimation.jl_tpu_torch.utils import evaluation as ev
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import produce_or_load, savename

    device = resolve_device(args.device)
    bopval.card_line(device)
    seed = search_seed(args)
    rng = np.random.default_rng(seed)
    print(f"search seed {seed} ({args.sampler}), {args.trials} trials, scenes {args.scenes}")
    parameters, signature = search_parameters(args)
    root = Path(data_root)
    raw_dir = root / "exp_raw" / f"{args.experiment_name}_cuda"
    pro_dir = root / "exp_pro" / f"{args.experiment_name}_cuda"
    cache = {}  # depth images and models for evaluate_scene, shared by every trial

    def runners_for(scenes, testset):
        return {s: build_scene_runner(s, args, parameters, testset, device) for s in scenes}

    def trial_cost(cand, trial_tag, scenes, runner_map, testset):
        """1 - VSD recall of a candidate over ``scenes`` (cached per scene)."""
        n_correct = n_total = 0
        for scene_id in scenes:
            config = trial_config(args, cand, trial_tag, scene_id, testset)
            run_seed = (parameters.seed + scene_id * 7919) % (2**31)
            runner = runner_map[scene_id]

            def estimate(c):
                first = next(iter(runner.calibration.values()))
                return {"result_rows": runner(cand, run_seed), "n_steps": first["n_steps"],
                        "step_time": first["step_time"], "calibration": runner.calibration}

            result, _ = produce_or_load(estimate, config, raw_dir, filename=savename(config),
                                        signature=signature)
            errors, _ = produce_or_load(
                lambda c: bopval.evaluate_scene(c, args.bop_dir, parameters,
                                                result["result_rows"], device, cache),
                config, pro_dir / "errors", filename=savename(config), signature=signature)
            nc, nt = ev.threshold_errors(errors["vsd"], ev.BOP18_THETA)
            n_correct += nc
            n_total += nt
        return 1.0 - (n_correct / max(n_total, 1)), n_total

    runners = runners_for(args.scenes, args.testset)
    out = pro_dir / "trials.csv"
    out.parent.mkdir(parents=True, exist_ok=True)
    n_explore = max(6, args.trials // 5)
    history = []
    n_gt_train = 1
    for trial in range(args.trials):
        t0 = time.perf_counter()
        cand = next_candidate(history, rng, n_explore)
        cost, n_gt_train = trial_cost(cand, trial, args.scenes, runners, args.testset)
        history.append(dict(trial=trial, **cand, cost=cost))
        # written after every trial: a cut-off run leaves a usable partial search
        bopval.write_csv(out, history)
        print(f"trial {trial}: {({k: round(v, 4) for k, v in cand.items()})} -> cost "
              f"{cost:.4f} (n={n_gt_train}), {time.perf_counter() - t0:.2f} s", flush=True)

    # candidates within one train gt of the best are statistical ties: broken
    # on held-out scenes when given, else reported
    best_cost = min(h["cost"] for h in history)
    print(f"best train cost {best_cost:.4f} over {n_gt_train} gts")
    near = [h for h in history if h["cost"] <= best_cost + 1.0 / max(n_gt_train, 1) + 1e-9]
    print(f"{len(near)} candidate(s) within one train gt of the best")
    chosen = sorted(near, key=lambda h: h["cost"])[0]
    if args.tiebreak_scenes and len(near) > 1:
        print(f"replaying {len(near)} tied candidates on {args.tiebreak_testset} scenes "
              f"{args.tiebreak_scenes}")
        val_runners = runners_for(args.tiebreak_scenes, args.tiebreak_testset)
        scored = []
        for h in near:
            cand = {name: h[name] for name, *_ in SPACE}
            vcost, vn = trial_cost(cand, f"val{h['trial']}", args.tiebreak_scenes,
                                   val_runners, args.tiebreak_testset)
            scored.append((vcost, h["cost"], h))
            print(f"  trial {h['trial']}: val cost {vcost:.4f} (n={vn})")
        scored.sort(key=lambda x: (x[0], x[1]))
        chosen = scored[0][2]
        bopval.write_csv(out.parent / "tiebreak_val.csv",
                         [dict(trial=h["trial"], val_cost=v, train_cost=t) for v, t, h in scored])
    cand = {name: chosen[name] for name, *_ in SPACE}
    print(f"chosen: trial {chosen['trial']} cost {chosen['cost']:.4f} {cand}")
    print(f"wrote {out}")
    return dict(history=history, chosen=chosen, calibration={
        s: r.calibration for s, r in runners.items()})


if __name__ == "__main__":
    main()
