"""Port parity on the JAX package's BOP runs of ``scripts/smc_bop_val.py``
that had no port counterpart (``parity_cases.BOP_RUNS``: smc_bop_val,
smc_bop_val2, smc_bop_val2_b005, smc_bop_val2_b010, smc_bop_cad_val2,
hard_cases), and the hard-case pin on the port.

* Config parity: ``scripts/torch_smc_bop_val.py`` at each run's arguments
  names exactly the run's estimate artifacts.
* Evaluation parity on the CPU, the seven synth artifacts whole: the port's
  ``evaluate_scene`` on the JAX estimates against the JAX errors under
  ``chip_smoke.py`` phase 14a's gates (visibilities equal, ADD-S within
  1e-4 relative, VSD and VSDBOP within 0.005, counts under each threshold
  equal but for entries within 0.01 of it). Six of the seven carry
  checked-in errors that the JAX package's evaluation of today does not
  reproduce (an earlier VSD); ``scripts/reevaluate_errors.py`` keeps its
  errors of today in ``tests/fixtures/reevaluated_errors_bop_runs.npz``,
  which is then the reference, and one entry is recomputed here by the JAX
  package. The VSD recall at theta 0.3 is the same under both sets of
  errors, so the checked-in sampler_recall.csv stands. The synthcad
  artifacts are evaluated on two rows on the CPU
  (``tests/test_torch_bop_runs_cad.py``) and whole on the card (phase 16a).
* The hard-case pin (``tests/test_hard_case.py``) on the port's fused
  association posterior: two 0.04 m icospheres, the rear one about 45 %
  visible behind the front one, the two rotations drawn by JAX and
  injected; the occluder's pose out-scores the true rear pose, the true
  pose beats a 20 cm offset by more than 10, and the three log-likelihoods
  equal JAX's.
"""

import csv
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch_smc_bop_val as bopval  # noqa: E402
from parity_cases import (  # noqa: E402
    BOP_RUNS,
    REEVALUATED_BOP_RUNS,
    SWEEP_ADDS_REL_TOL,
    SWEEP_VSD_ABS_TOL,
    bop_run_args,
    compare_errors,
    sweep_reference,
)

from bayesianposeestimation.jl_tpu_torch.parameters import Parameters  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils import evaluation as ev  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils.artifacts import (  # noqa: E402
    load_artifact,
    savename,
)

RAW, PRO = ROOT / "data/exp_raw", ROOT / "data/exp_pro"
SYNTH_RUNS = [n for n in BOP_RUNS if n != "smc_bop_cad_val2"]
SYNTH_ARTIFACTS = [(n, savename(c) + ".npz") for n in SYNTH_RUNS for c in bop_run_args(n)[1]]
_PORT_ERRORS = {}


def _port_errors(name, file):
    if (name, file) not in _PORT_ERRORS:
        raw = load_artifact(RAW / name / file)
        _PORT_ERRORS[name, file] = bopval.evaluate_scene(
            raw["__config__"], str(ROOT / "data/bop"), Parameters(device="cpu"),
            list(raw["result_rows"]), device="cpu")
    return _PORT_ERRORS[name, file]


@pytest.mark.parametrize("name", list(BOP_RUNS))
def test_configs_name_the_jax_artifacts(name):
    args, configs = bop_run_args(name)
    jax = {p.name: load_artifact(p) for p in (RAW / name).glob("*.npz")}
    assert {savename(c) + ".npz" for c in configs} == set(jax)
    for config in configs:
        assert jax[savename(config) + ".npz"]["__config__"] == config
    assert args.experiment_name == name and args.samplers == ["smc_mh"]
    # the budget: the JAX run's steps at its calibrated step time fill
    # 40-100 % of it
    for raw in jax.values():
        used = float(raw["n_steps"]) * float(raw["step_time"])
        assert 0.4 * args.time_budget < used < args.time_budget


def test_all_nine_artifacts_and_six_stale():
    assert len(SYNTH_ARTIFACTS) == 7
    assert sum(len(bop_run_args(n)[1]) for n in BOP_RUNS) == 9
    with np.load(REEVALUATED_BOP_RUNS) as f:
        stale = {k.rsplit("/", 1)[0] for k in f.files}
    assert stale == {f"{n}/{file}" for n, file in SYNTH_ARTIFACTS if n != "hard_cases"}


@pytest.mark.parametrize("name,file", SYNTH_ARTIFACTS)
def test_evaluate_scene_matches_jax_errors(name, file):
    ours = _port_errors(name, file)
    ref, reevaluated = sweep_reference(name, file, REEVALUATED_BOP_RUNS)
    assert reevaluated == (name != "hard_cases")
    bad, worst_adds, worst_vsd, _ = compare_errors(ours, ref, SWEEP_ADDS_REL_TOL,
                                                   SWEEP_VSD_ABS_TOL)
    assert not bad, (bad, worst_adds, worst_vsd)
    assert ("visib" in ref) == reevaluated  # hard_cases' errors predate the visib key


@pytest.mark.parametrize("name", SYNTH_RUNS)
def test_recall_matches_sampler_recall_csv(name):
    """The port's recall on its errors of the JAX estimates equals the
    checked-in sampler_recall.csv (VSD and ADD-S; built on the stale errors,
    which move no gt across theta)."""
    _, configs = bop_run_args(name)
    errs = [_port_errors(name, savename(c) + ".npz") for c in configs]
    [row], _ = bopval.recall_rows({"smc_mh": errs})
    with open(PRO / name / "sampler_recall.csv", newline="") as fh:
        [want] = [r for r in csv.DictReader(fh) if r["sampler"] == "smc_mh"]
    assert row["n_gt"] == sum(len(e["vsd"]) for e in errs)
    for key in ("vsd_recall", "adds_recall"):
        assert row[key] == pytest.approx(float(want[key]), abs=1e-12), key


def test_reevaluated_errors_are_the_jax_package_today():
    """The fixture's entry of the 0.05 s val2 run against the JAX package's
    evaluate_scene run now, and the checked-in errors it replaces against
    both: ADD-S (the same estimates) agrees, VSD does not."""
    import smc_bop_val

    from bayesianposeestimation.jl_tpu.parameters import Parameters as JParameters

    name = "smc_bop_val2_b005"
    file = savename(bop_run_args(name)[1][0]) + ".npz"
    ref, reevaluated = sweep_reference(name, file, REEVALUATED_BOP_RUNS)
    assert reevaluated
    raw = load_artifact(RAW / name / file)
    jax_now = smc_bop_val.evaluate_scene(raw["__config__"], str(ROOT / "data/bop"),
                                         JParameters(), list(raw["result_rows"]))
    for key in ("adds", "vsd", "vsdbop", "visib"):
        np.testing.assert_allclose(np.asarray(jax_now[key]), ref[key], rtol=1e-6, atol=1e-6)
    stale = load_artifact(PRO / name / "errors" / file)
    np.testing.assert_allclose(stale["adds"], ref["adds"], rtol=1e-5)
    assert np.abs(stale["vsd"] - ref["vsd"]).max() > SWEEP_VSD_ABS_TOL
    # gt by gt, the VSD outcome at theta 0.3 is the same under both
    np.testing.assert_array_equal(stale["vsd"] < ev.BOP18_THETA, ref["vsd"] < ev.BOP18_THETA)


# -- the hard-case pin on the port ------------------------------------------------------


@pytest.fixture(scope="module")
def hard_scenes():
    """The scene of tests/test_hard_case.py built by both packages: the
    port's on its own renders, crop and prior; JAX's from that test's
    fixture. The rotations are JAX's draws."""
    import jax

    import test_hard_case as J
    from bayesianposeestimation.jl_tpu import quaternions as jquat
    from bayesianposeestimation.jl_tpu_torch.camera import CvCamera, crop_camera, crop_image
    from bayesianposeestimation.jl_tpu_torch.models.fused import fused_posterior
    from bayesianposeestimation.jl_tpu_torch.ops.rasterize import render_depth
    from bayesianposeestimation.jl_tpu_torch.parameters import Experiment
    from bayesianposeestimation.jl_tpu_torch.utils import mesh_io

    mesh = mesh_io.icosphere_mesh(0.04, 2)
    diam = mesh_io.mesh_diameter(mesh)
    full_cam = CvCamera(width=640, height=480, f_x=580.0, f_y=580.0, c_x=319.5, c_y=239.5,
                        near=0.01, far=10.0)
    verts, faces = torch.as_tensor(mesh.vertices), torch.as_tensor(mesh.faces)
    t_front = torch.tensor([0.0, 0.0, 1.0])
    q_front = torch.tensor(np.asarray(jquat.rand_quaternion(jax.random.PRNGKey(3))))
    t_rear = torch.tensor([0.38 * diam, 0.0, 1.0 + 0.45 * diam], dtype=torch.float32)
    q_rear = torch.tensor(np.asarray(jquat.rand_quaternion(jax.random.PRNGKey(4))))
    d_front = render_depth(verts, faces, full_cam, t_front, q_front).numpy()
    d_rear = render_depth(verts, faces, full_cam, t_rear, q_rear).numpy()
    f_inf = np.where(d_front > 0, d_front, np.inf)
    r_inf = np.where(d_rear > 0, d_rear, np.inf)
    composite = np.minimum(f_inf, r_inf)
    obs_full = np.where(np.isfinite(composite), composite, 1.5)
    rear_visible = (d_rear > 0) & (r_inf <= composite + 1e-3)
    visib = rear_visible.sum() / max((d_rear > 0).sum(), 1)

    params = Parameters(width=30, height=30, device="cpu")
    cam = crop_camera(full_cam, t_rear.numpy(), diam, width=30, height=30)
    obs = crop_image(obs_full, full_cam, cam)
    mask_crop = crop_image(rear_visible.astype(np.float32), full_cam, cam)
    prior_o = np.where(mask_crop > 0.5, params.o_mask_is, params.o_mask_not)
    experiment = Experiment(scene={"camera": cam, "verts": verts, "faces": faces},
                            prior_o=torch.as_tensor(prior_o, dtype=torch.float32),
                            prior_t=t_rear, depth_image=torch.as_tensor(obs, dtype=torch.float32))
    poses = {"true": (t_rear, q_rear), "occluder": (t_front, q_front),
             "offset": (t_rear + torch.tensor([0.2, 0.0, 0.0]), q_rear)}
    return dict(posterior=fused_posterior(params, experiment, "association", device="cpu"),
                poses=poses, visib=float(visib), jax=J.hard_scene.__wrapped__(),
                jax_loglike=J._loglike)


def _loglike(posterior, t, q):
    from bayesianposeestimation.jl_tpu_torch.samples import Sample

    return float(posterior.logdensity_sample(Sample({"t": t[None], "r": q[None]})).log_like[0])


def test_hard_case_regime_and_wrong_mode(hard_scenes):
    """The rear sphere is ~45 % visible, and its occluder's pose out-scores
    its true pose on the port too: the pinned failure mechanism."""
    assert 0.35 < hard_scenes["visib"] < 0.55, hard_scenes["visib"]
    assert hard_scenes["visib"] == pytest.approx(hard_scenes["jax"]["visib"], abs=1e-12)
    p, poses = hard_scenes["posterior"], hard_scenes["poses"]
    assert _loglike(p, *poses["occluder"]) > _loglike(p, *poses["true"])


def test_hard_case_true_pose_beats_an_offset(hard_scenes):
    p, poses = hard_scenes["posterior"], hard_scenes["poses"]
    assert _loglike(p, *poses["true"]) > _loglike(p, *poses["offset"]) + 10.0


def test_hard_case_log_likes_equal_jax(hard_scenes):
    """At the three poses, the port's log-likelihood equals the JAX
    posterior's on its own scene (tests/test_torch_fused.py's tolerance)."""
    import jax.numpy as jnp

    jp, jll = hard_scenes["jax"]["posterior"], hard_scenes["jax_loglike"]
    for label, (t, q) in hard_scenes["poses"].items():
        ours = _loglike(hard_scenes["posterior"], t, q)
        theirs = jll(jp, jnp.asarray(t.numpy()), jnp.asarray(q.numpy()))
        assert ours == pytest.approx(theirs, rel=1e-3, abs=0.1), label
