"""Port parity of the hyperparameter searches, scripts/torch_smc_mh_hyperopt.py
and scripts/torch_mcmc_baseline_hyperopt.py, against the JAX package's six
checked-in searches (``parity_cases.HYPEROPT_EXPERIMENTS``: 108 estimate
artifacts under data/exp_raw/, their errors and trials.csv under
data/exp_pro/).

* Search replay: at --seed 0, fed each trial's recorded cost, the port's
  ``next_candidate`` proposes every candidate of the six trials.csv files
  (72 trials) within 1e-12, and the JAX script's ``next_candidate`` the same.
* Config parity: at each run's arguments the port names exactly the JAX
  run's artifact files.
* Evaluation parity on the CPU, one artifact of each synth search: the
  port's ``evaluate_scene`` on the JAX estimates against the JAX errors
  (ADD-S within 1e-5 relative, VSD and VSDBOP within 0.005, visibilities
  equal). Where the checked-in errors are stale, the reference is the JAX
  package's re-evaluation in tests/fixtures/reevaluated_errors_hyperopt.npz
  (``scripts/reevaluate_errors.py``), one entry of which is recomputed here
  by the JAX package. The synthcad artifacts are evaluated on the card only
  (chip_smoke.py phase 15a).
* The search's bookkeeping: ``main`` with a runner that returns the JAX
  estimates writes trials.csv with the JAX search's candidates and the costs
  of the reference errors, and caches each trial's artifacts.
* Tuned-chain parity at a small size: a candidate's ``hyper`` dict, as the
  tuned runner passes it, gives the log-likelihoods and log-priors of the
  JAX ``FusedPosterior(traced_hyper=True)`` within rtol 1e-3 / atol 0.2.
* The scripts refuse --device cuda without a card.
"""

import csv
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch_mcmc_baseline_hyperopt as mcmc_hyp  # noqa: E402
import torch_smc_mh_hyperopt as hyp  # noqa: E402
from parity_cases import (  # noqa: E402
    HYPEROPT_EXPERIMENTS,
    REEVALUATED_HYPEROPT,
    hyperopt_argv,
    read_trials,
)

from bayesianposeestimation.jl_tpu_torch.parameters import Parameters  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils import evaluation as ev  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils.artifacts import (  # noqa: E402
    load_artifact,
    savename,
)

RAW, PRO = ROOT / "data/exp_raw", ROOT / "data/exp_pro"
ADDS_REL_TOL = 1e-5
VSD_ABS_TOL = 0.005
SYNTH = [n for n in HYPEROPT_EXPERIMENTS if "cad" not in n]


def _trials(name):
    return read_trials(PRO / name / "trials.csv")


def _args(name, extra=()):
    return hyp.parse_args(hyperopt_argv(name, ["--device", "cpu", *extra]))


def _reference(name, file):
    with np.load(REEVALUATED_HYPEROPT) as f:
        key = f"{name}/{file}"
        if f"{key}/vsd" in f.files:
            return {k: f[f"{key}/{k}"] for k in ("adds", "vsd", "vsdbop", "visib")}, True
    return load_artifact(PRO / name / "errors" / file), False


def _cost(errors_per_scene):
    n_c = n_t = 0
    for e in errors_per_scene:
        c, t = ev.threshold_errors(e["vsd"], ev.BOP18_THETA)
        n_c, n_t = n_c + c, n_t + t
    return 1.0 - n_c / max(n_t, 1)


def _replay(args, costs):
    """The port's candidates when trial k costs ``costs[k]``: the search is
    deterministic given its seed and the costs."""
    rng = np.random.default_rng(hyp.search_seed(args))
    history = []
    for cost in costs:
        history.append(dict(**hyp.next_candidate(history, rng, max(6, args.trials // 5)),
                            cost=cost))
    return history


def test_six_searches_hold_72_trials_and_108_artifacts():
    assert sum(len(_trials(n)) for n in HYPEROPT_EXPERIMENTS) == 72
    assert sum(len(list((RAW / n).glob("*.npz"))) for n in HYPEROPT_EXPERIMENTS) == 108


@pytest.mark.parametrize("name", list(HYPEROPT_EXPERIMENTS))
def test_search_replays_every_candidate(name):
    """The port's and the JAX script's next_candidate at seed 0 on the
    recorded costs propose each trials.csv row."""
    import smc_mh_hyperopt as jax_hyp

    args = _args(name)
    trials = _trials(name)
    assert args.trials == len(trials) and args.seed == 0
    ours = _replay(args, [t["cost"] for t in trials])
    rng = np.random.default_rng(0)
    history = []
    for t, mine in zip(trials, ours):
        theirs = jax_hyp.next_candidate(history, rng, max(6, args.trials // 5))
        history.append(dict(**theirs, cost=t["cost"]))
        for key, *_ in hyp.SPACE:
            assert abs(mine[key] - t[key]) <= 1e-12, (t["trial"], key)
            assert mine[key] == theirs[key]


def test_default_seed_is_the_jax_scripts():
    for sampler in ("smc_mh", "mh_sampler", "mtm_sampler"):
        args = hyp.parse_args(["--sampler", sampler])
        assert hyp.search_seed(args) == zlib.crc32(sampler.encode()) & 0xFFFF
    assert hyp.search_seed(hyp.parse_args(["--seed", "0"])) == 0


@pytest.mark.parametrize("name", list(HYPEROPT_EXPERIMENTS))
def test_configs_name_the_jax_artifacts(name):
    """Every (trial, scene) config of the replayed search names one JAX
    artifact file, and every file is named; the run's time budget is the
    one its step counts were calibrated to."""
    args = _args(name)
    trials = _trials(name)
    cands = _replay(args, [t["cost"] for t in trials])
    ours = {savename(hyp.trial_config(args, {k: c[k] for k, *_ in hyp.SPACE}, k, s,
                                      args.testset)) + ".npz"
            for k, c in enumerate(cands) for s in args.scenes}
    files = {p.name for p in (RAW / name).glob("*.npz")}
    assert ours == files
    assert args.experiment_name == name
    for p in sorted(RAW / name / f for f in files)[:4]:
        raw = load_artifact(p)
        used = float(raw["n_steps"]) * float(raw["step_time"])
        assert 0.7 * args.time_budget < used <= 0.92 * args.time_budget
        assert {k: raw["__config__"][k] for k in ("sampler", "dataset", "testset")} == {
            "sampler": args.sampler, "dataset": args.dataset, "testset": args.testset}


def test_mcmc_script_runs_one_search_per_sampler():
    args = mcmc_hyp.parse_args(["--samplers", "mh_sampler", "mtm_sampler", "--seed", "0",
                                "--device", "cpu"])
    argvs = mcmc_hyp.search_argvs(args)
    parsed = [hyp.parse_args(a) for a in argvs]
    assert [(p.sampler, p.experiment_name, p.n_particles, p.seed, p.trials, p.time_budget)
            for p in parsed] == [("mh_sampler", "mcmc_hyperopt_mh_sampler", 10, 0, 4, 0.25),
                                 ("mtm_sampler", "mcmc_hyperopt_mtm_sampler", 10, 0, 4, 0.25)]
    assert hyp.search_parameters(parsed[0])[1] == {"n_particles": 10, "time_budget": 0.25}
    with pytest.raises(SystemExit):
        mcmc_hyp.parse_args(["--samplers", "mh_sampler", "--experiment-names", "a", "b"])


def _cpu_artifact(name):
    """The first trial's first-scene artifact of a synth search."""
    return next(p.name for p in sorted((RAW / name).glob("*.npz"))
                if ",trial=0." in p.name)


BOOKKEEPING = "mcmc_hyperopt_mh_sampler"  # all 8 of its checked-in errors are stale


@pytest.fixture(scope="module")
def search_run(tmp_path_factory):
    """``main`` at BOOKKEEPING's arguments with 2 trials, the chain runs
    replaced by the JAX estimates of the candidate's trial (so the port
    evaluates the JAX estimates): (argv, data root, main's result, the seeds
    of the runner calls)."""
    name = BOOKKEEPING
    files = {p.name: p for p in (RAW / name).glob("*.npz")}
    calls = []

    def fake_runner(scene_id, args, parameters, testset=None, device="cuda"):
        def run_trial(cand, seed):
            config = hyp.trial_config(args, cand, len(calls), scene_id, testset)
            calls.append(seed)
            return list(load_artifact(files[savename(config) + ".npz"])["result_rows"])

        run_trial.calibration = {"1": dict(n_steps=2, step_time=0.1)}
        return run_trial

    root = tmp_path_factory.mktemp("search")
    argv = hyperopt_argv(name, ["--trials", "2", "--device", "cpu", "--bop-dir",
                                str(ROOT / "data/bop")])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hyp, "build_scene_runner", fake_runner)
        result = hyp.main(argv, data_root=root)
        n_first = len(calls)
        hyp.main(argv, data_root=root)  # cached: no chain runs
    return argv, root, result, calls, n_first


@pytest.fixture(scope="module")
def port_errors(search_run):
    """The port's errors of each synth search's trial-0 artifact (the
    bookkeeping search's from its own run)."""
    import torch_smc_bop_val as bopval

    cache, out = {}, {}
    for name in SYNTH:
        file = _cpu_artifact(name)
        if name == BOOKKEEPING:
            out[name] = load_artifact(search_run[1] / "exp_pro" / f"{name}_cuda" / "errors" /
                                      file)
            continue
        raw = load_artifact(RAW / name / file)
        out[name] = bopval.evaluate_scene(raw["__config__"], str(ROOT / "data/bop"),
                                          Parameters(device="cpu"), list(raw["result_rows"]),
                                          "cpu", cache)
    return out


@pytest.mark.parametrize("name", SYNTH)
def test_evaluate_scene_matches_jax_errors(port_errors, name):
    ours = port_errors[name]
    ref, _ = _reference(name, _cpu_artifact(name))
    np.testing.assert_array_equal(ours["visib"], ref["visib"])
    for key in ("adds", "vsd", "vsdbop"):
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        assert a.shape == b.shape, key
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
        fin = np.isfinite(b)
        if key == "adds":
            np.testing.assert_allclose(a[fin], b[fin], rtol=ADDS_REL_TOL, atol=0)
        else:
            np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=VSD_ABS_TOL)


def test_reevaluated_errors_are_the_jax_package_today():
    """A fixture entry of mcmc_hyperopt_mh_sampler against the JAX package's
    evaluate_scene run now; the checked-in errors agree in ADD-S (the same
    estimates), not in VSD."""
    import smc_bop_val

    from bayesianposeestimation.jl_tpu.parameters import Parameters as JParameters

    name = BOOKKEEPING
    file = _cpu_artifact(name)
    ref, reevaluated = _reference(name, file)
    assert reevaluated
    raw = load_artifact(RAW / name / file)
    jax_now = smc_bop_val.evaluate_scene(raw["__config__"], str(ROOT / "data/bop"),
                                         JParameters(), list(raw["result_rows"]))
    for key in ("adds", "vsd", "vsdbop", "visib"):
        np.testing.assert_allclose(np.asarray(jax_now[key]), ref[key], rtol=1e-6, atol=1e-6)
    stale = load_artifact(PRO / name / "errors" / file)
    np.testing.assert_allclose(stale["adds"], ref["adds"], rtol=ADDS_REL_TOL)
    assert np.abs(stale["vsd"] - ref["vsd"]).max() > VSD_ABS_TOL


def test_main_writes_trials_and_artifacts(search_run):
    """trials.csv holds the JAX search's first two candidates with the costs
    of the JAX errors of today, the artifacts carry the JAX file names, the
    step counts and the signature, and a second run replays from the cache."""
    argv, root, result, calls, n_first = search_run
    name = BOOKKEEPING
    assert n_first == len(calls) == 2
    with open(root / "exp_pro" / f"{name}_cuda" / "trials.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert list(rows[0]) == ["trial", "o_mask_is", "pixel_sigma", "sigma_r", "sigma_t",
                             "o_mask_not", "cost"]
    jax_trials = _trials(name)[:2]
    for r, t in zip(rows, jax_trials):
        for key, *_ in hyp.SPACE:
            assert float(r[key]) == t[key]
    args = hyp.parse_args(argv)
    for r, t in zip(rows, jax_trials):
        file = savename(hyp.trial_config(args, {k: t[k] for k, *_ in hyp.SPACE},
                                         int(t["trial"]), 1, "val")) + ".npz"
        assert float(r["cost"]) == pytest.approx(_cost([_reference(name, file)[0]]), abs=1e-12)
    files = {p.name for p in (RAW / name).glob("*.npz")}
    raws = sorted((root / "exp_raw" / f"{name}_cuda").glob("*.npz"))
    assert {p.name for p in raws} <= files and len(raws) == 2
    stored = load_artifact(raws[0])
    assert stored["__signature__"] == '{"n_particles": 10, "time_budget": 0.25}'
    assert int(stored["n_steps"]) == 2 and stored["calibration"] == {
        "1": dict(n_steps=2, step_time=0.1)}
    assert result["chosen"]["trial"] in (0, 1)


def test_tuned_posterior_matches_jax_traced_hyper(monkeypatch):
    """The 16x16 cube with a mask-like prior image: the posterior the tuned
    runner builds for a candidate (hyper row and replaced sigmas) against
    the JAX FusedPosterior(traced_hyper=True) with the candidate's params."""
    import jax
    import jax.numpy as jnp

    from bayesianposeestimation.jl_tpu import quaternions as JQ
    from bayesianposeestimation.jl_tpu.camera import CvCamera as JCam
    from bayesianposeestimation.jl_tpu.camera import crop_camera
    from bayesianposeestimation.jl_tpu.models.fused import FusedPosterior as JFused
    from bayesianposeestimation.jl_tpu.ops.rasterize import render_depth
    from bayesianposeestimation.jl_tpu.parameters import Experiment as JExperiment
    from bayesianposeestimation.jl_tpu.parameters import Parameters as JParameters
    from bayesianposeestimation.jl_tpu.utils import mesh_io as J
    from bayesianposeestimation.jl_tpu_torch import convert
    from bayesianposeestimation.jl_tpu_torch.models import experiment_samplers as es
    from bayesianposeestimation.jl_tpu_torch.models import fused as TF

    cand = {k: v for k, v in _trials("smc_mh_hyperopt_cad")[2].items()
            if k not in ("trial", "cost")}
    params = JParameters(width=16, height=16, raster_chunk=64)
    mesh = J.cube_mesh(0.1)
    base = JCam(width=64, height=64, f_x=64.0, f_y=64.0, c_x=31.5, c_y=31.5, near=0.01,
                far=10.0)
    cam = crop_camera(base, np.array([0.0, 0.0, 1.0]), 0.1 * np.sqrt(3), width=16, height=16)
    gt_t, gt_q = jnp.array([0.0, 0.0, 1.0]), JQ.quat_identity()
    clean = np.asarray(render_depth(jnp.asarray(mesh.vertices), jnp.asarray(mesh.faces), cam,
                                    gt_t, gt_q))
    obs = np.where(clean > 0, clean + 0.002 * np.random.default_rng(5).normal(
        size=clean.shape), 0.0).astype(np.float32)
    prior_o = np.where(clean > 0, cand["o_mask_is"], cand["o_mask_not"]).astype(np.float32)
    hyper = hyp.hyper_of(cand)
    jparams = params.replace(pixel_sigma=hyper["pixel_sigma"],
                             association_sigma=hyper["association_sigma"],
                             sigma_t=hyper["sigma_t"], proposal_sigma_r=hyper["proposal_sigma_r"])
    scene = {"camera": cam, "verts": jnp.asarray(mesh.vertices),
             "faces": jnp.asarray(mesh.faces)}
    jpost = JFused(jparams, JExperiment(scene=scene, prior_o=jnp.asarray(prior_o),
                                        prior_t=gt_t, depth_image=jnp.asarray(obs)),
                   "association", traced_hyper=True)

    # the port's posterior as the tuned runner builds it for this candidate
    tparams = convert.parameters_from_fields(**{f: getattr(params, f) for f in (
        "width", "height", "pixel_sigma", "association_sigma", "sigma_t", "proposal_sigma_r",
        "o_mask_is", "o_mask_not", "n_particles")})
    tcam = convert.camera_from_fields(**{f: float(getattr(cam, f)) for f in (
        "width", "height", "f_x", "f_y", "c_x", "c_y", "s", "near", "far")})
    built = []
    inner = TF.FusedPosterior

    def capture(*a, **kw):
        built.append(inner(*a, **kw))
        return built[-1]

    monkeypatch.setattr(TF, "FusedPosterior", capture)
    run = TF.make_tuned_chain(tparams, mesh.vertices, mesh.faces, "association", es.smc_mh, 2,
                              n_chains=4, device="cpu")
    run(0, tcam, obs, prior_o, np.array(gt_t), hyper)
    tpost = built[-1]
    assert tpost.hyper is not None
    np.testing.assert_allclose(tpost.hyper.numpy(), [cand["pixel_sigma"]] * 2, rtol=1e-7)

    s = jpost.sample_prior(jax.random.PRNGKey(3), 12)
    t = np.array(s.variables["t"])
    r = np.array(s.variables["r"])
    t[:4] = np.asarray(gt_t) + 0.003 * np.random.default_rng(0).normal(size=(4, 3))
    draws = {"t": t.astype(np.float32), "r": r.astype(np.float32)}
    a = jpost.logdensity_sample(s.merge({k: jnp.asarray(v) for k, v in draws.items()}))
    b = tpost.logdensity_sample(convert.sample_from_numpy(draws))
    for k in ("log_like", "log_prob"):
        np.testing.assert_allclose(getattr(b, k).numpy(), np.asarray(getattr(a, k)),
                                   rtol=1e-3, atol=0.2, err_msg=k)
    # the candidate's sigmas, not the defaults, set the densities
    assert float(np.abs(np.asarray(a.log_like) - np.asarray(JFused(
        params, JExperiment(scene=scene, prior_o=jnp.asarray(prior_o), prior_t=gt_t,
                            depth_image=jnp.asarray(obs)), "association").logdensity_sample(
        s.merge({k: jnp.asarray(v) for k, v in draws.items()})).log_like)).max()) > 1.0


@pytest.mark.parametrize("main", [hyp.main, mcmc_hyp.main], ids=["smc_mh", "mcmc"])
def test_search_scripts_refuse_cuda_without_a_card(main, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--scenes", "1", "--bop-dir", str(ROOT / "data/bop")], data_root=tmp_path)
    assert not any(tmp_path.iterdir())
