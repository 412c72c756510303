"""Port parity: the per-image slice — fused posteriors of every variant, the
conditioned and tuned chain runners, and the host helpers that prepare an
image (crop, reprojection, segmentation prior, step-time calibration).

One setup is made with ``jl_tpu`` (a cube at 16x16, as in
tests/test_torch_fused.py, with a segmentation-mask prior image), carried
across with ``jl_tpu_torch.convert`` and run through both packages on the
CPU; the JAX side's Pallas kernel runs in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianposeestimation.jl_tpu import quaternions as JQ
from bayesianposeestimation.jl_tpu.camera import CvCamera as JCam
from bayesianposeestimation.jl_tpu.camera import crop_camera as j_crop_camera
from bayesianposeestimation.jl_tpu.camera import crop_image as j_crop_image
from bayesianposeestimation.jl_tpu.camera import reproject_3d as j_reproject
from bayesianposeestimation.jl_tpu.models import experiment_samplers as JES
from bayesianposeestimation.jl_tpu.models.experiment_models import (
    point_from_segmentation as j_point,
)
from bayesianposeestimation.jl_tpu.models.fused import FusedPosterior as JFused
from bayesianposeestimation.jl_tpu.models.fused import fused_posterior as j_fused
from bayesianposeestimation.jl_tpu.models.fused import make_conditioned_chain as j_cond
from bayesianposeestimation.jl_tpu.ops.rasterize import render_depth
from bayesianposeestimation.jl_tpu.parameters import Experiment, Parameters
from bayesianposeestimation.jl_tpu.samples import Sample as JSample
from bayesianposeestimation.jl_tpu.utils import evaluation as JEV
from bayesianposeestimation.jl_tpu.utils import mesh_io
from bayesianposeestimation.jl_tpu_torch import convert
from bayesianposeestimation.jl_tpu_torch.camera import crop_image as t_crop_image
from bayesianposeestimation.jl_tpu_torch.camera import reproject_3d as t_reproject
from bayesianposeestimation.jl_tpu_torch.models import experiment_samplers as TES
from bayesianposeestimation.jl_tpu_torch.models import fused as TF
from bayesianposeestimation.jl_tpu_torch.models.experiment_models import (
    point_from_segmentation as t_point,
)
from bayesianposeestimation.jl_tpu_torch.ops import cuda_raster
from bayesianposeestimation.jl_tpu_torch.samples import Sample as TSample
from bayesianposeestimation.jl_tpu_torch.utils import evaluation as TEV

VARIANTS = ("simple", "smooth_simple", "association", "association_simple_reg", "smooth",
            "smooth_simple_reg", "no_exp", "no_exp_association")
N_PARTICLES = 32
BASE = JCam(width=640, height=480, f_x=600.0, f_y=600.0, c_x=319.5, c_y=239.5,
            near=0.01, far=10.0)


def _t_cam(cam):
    return convert.camera_from_fields(**{f.name: float(getattr(cam, f.name))
                                         for f in dataclasses.fields(cam)})


@pytest.fixture(scope="module")
def scene():
    """A cube at 1 m behind a 16x16 crop, its noisy observation and an
    o_mask_is / o_mask_not prior image from its silhouette."""
    params = Parameters(width=16, height=16, n_particles=N_PARTICLES, n_steps=6,
                        proposal_sigma_r=(0.5, 0.5, 0.5))
    mesh = mesh_io.cube_mesh(0.1)
    gt_t = np.array([0.01, -0.02, 1.0], np.float32)
    cam = j_crop_camera(BASE, gt_t, mesh_io.mesh_diameter(mesh), width=16, height=16)
    k_gt, k_noise = jax.random.split(jax.random.PRNGKey(3))
    gt_q = JQ.rand_quaternion(k_gt)
    clean = np.asarray(render_depth(jnp.asarray(mesh.vertices), jnp.asarray(mesh.faces), cam,
                                    jnp.asarray(gt_t), gt_q))
    obs = np.where(clean > 0, clean + 0.005 * np.asarray(jax.random.normal(k_noise, clean.shape)),
                   0.0).astype(np.float32)
    prior_o = np.where(clean > 0, params.o_mask_is, params.o_mask_not).astype(np.float32)
    return dict(params=params, mesh=mesh, cam=cam, gt_t=gt_t, gt_q=np.asarray(gt_q),
                obs=obs, prior_o=prior_o,
                t_params=convert.parameters_from_fields(
                    **{f.name: getattr(params, f.name) for f in dataclasses.fields(params)}))


def _particles(scene, n=N_PARTICLES, seed=0):
    rng = np.random.default_rng(seed)
    t = (scene["gt_t"] + 0.01 * rng.normal(size=(n, 3))).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q[:8] = scene["gt_q"] + 0.05 * rng.normal(size=(8, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return t, q


def _densities(j_post, t_post, t, q):
    a = j_post.logdensity_sample(JSample({"t": jnp.asarray(t), "r": jnp.asarray(q)}))
    b = t_post.logdensity_sample(TSample({"t": torch.as_tensor(t), "r": torch.as_tensor(q)}))
    return a, b


@pytest.mark.parametrize("variant", VARIANTS)
def test_fused_posterior_densities_match(scene, variant):
    """log_prob and log_like of the same particles, per variant (the simple
    regularizer c_reg / n_pix for six of them). Tolerance as in
    tests/test_torch_fused.py: the sums' atol of 0.2 scaled by c_reg / Σo or
    c_reg / n_pix (<= 1/2 here) gives 0.1, rtol 1e-3."""
    exp = Experiment(scene={"camera": scene["cam"], "verts": jnp.asarray(scene["mesh"].vertices),
                            "faces": jnp.asarray(scene["mesh"].faces)},
                     prior_o=jnp.asarray(scene["prior_o"]), prior_t=jnp.asarray(scene["gt_t"]),
                     depth_image=jnp.asarray(scene["obs"]))
    t_exp = convert.experiment_from_numpy(_t_cam(scene["cam"]), scene["mesh"].vertices,
                                          scene["mesh"].faces, scene["prior_o"], scene["gt_t"],
                                          scene["obs"])
    t_post = TF.fused_posterior(scene["t_params"], t_exp, variant, device="cpu")
    a, b = _densities(j_fused(scene["params"], exp, variant), t_post, *_particles(scene))
    for k in ("log_prob", "log_like"):
        ja, tb = np.asarray(getattr(a, k)), getattr(b, k).numpy()
        assert np.all(np.isfinite(tb))
        np.testing.assert_allclose(tb, ja, rtol=1e-3, atol=0.1)
    assert np.ptp(b.log_like.numpy()) > 1.0


def test_fused_posterior_hyper_row_matches_traced_hyper(scene):
    """The port's device hyper row against the JAX package's traced hyper
    (FusedPosterior(traced_hyper=True)) at sigmas unlike the params'."""
    p2 = scene["params"].replace(pixel_sigma=0.004, association_sigma=0.006)
    exp = Experiment(scene={"camera": scene["cam"], "verts": jnp.asarray(scene["mesh"].vertices),
                            "faces": jnp.asarray(scene["mesh"].faces)},
                     prior_o=jnp.asarray(scene["prior_o"]), prior_t=jnp.asarray(scene["gt_t"]),
                     depth_image=jnp.asarray(scene["obs"]))
    t_exp = convert.experiment_from_numpy(_t_cam(scene["cam"]), scene["mesh"].vertices,
                                          scene["mesh"].faces, scene["prior_o"], scene["gt_t"],
                                          scene["obs"])
    row = torch.tensor([0.004, 0.006], dtype=torch.float32)
    t_post = TF.fused_posterior(scene["t_params"], t_exp, "smooth", device="cpu", hyper=row)
    t, q = _particles(scene)
    a, b = _densities(JFused(p2, exp, "smooth", traced_hyper=True), t_post, t, q)
    np.testing.assert_allclose(b.log_like.numpy(), np.asarray(a.log_like), rtol=1e-3, atol=0.1)
    plain = TF.fused_posterior(scene["t_params"], t_exp, "smooth", device="cpu")
    c = plain.logdensity_sample(TSample({"t": torch.as_tensor(t), "r": torch.as_tensor(q)}))
    assert np.max(np.abs(c.log_like.numpy() - b.log_like.numpy())) > 1.0


def test_fused_posterior_rejects_bad_faces(scene):
    t_exp = convert.experiment_from_numpy(_t_cam(scene["cam"]), scene["mesh"].vertices,
                                          scene["mesh"].faces + 100, 0.7, scene["gt_t"],
                                          scene["obs"])
    with pytest.raises(ValueError):
        TF.fused_posterior(scene["t_params"], t_exp, "association", device="cpu")
    with pytest.raises(ValueError):
        TF.FusedPosterior(scene["t_params"], t_exp, "association", device="cpu")
    with pytest.raises(ValueError):
        TF.fused_posterior(scene["t_params"], t_exp, "bogus", device="cpu")


def _runner_params():
    return convert.parameters_from_fields(
        width=16, height=16, n_particles=16, n_steps=4, pixel_sigma=0.004,
        association_sigma=0.004, sigma_t=(0.02, 0.02, 0.02), proposal_sigma_r=(0.5, 0.5, 0.5))


@pytest.mark.parametrize("variant", VARIANTS)
def test_tuned_chain_matches_conditioned(variant):
    """The port's analog of tests/test_infra.py test_tuned_chain_matches_conditioned
    (smc_mh): with hyper equal to the params the tuned runner reproduces the
    conditioned runner at the same seed, and another candidate changes the
    likelihoods."""
    params = _runner_params()
    mesh = mesh_io.cube_mesh(0.1)
    ref = TF.make_conditioned_chain(params, mesh.vertices, mesh.faces, variant, TES.smc_mh, 4,
                                    device="cpu")
    tuned = TF.make_tuned_chain(params, mesh.vertices, mesh.faces, variant, TES.smc_mh, 4,
                                device="cpu")
    cam = convert.camera_from_fields(width=16, height=16, f_x=20.0, f_y=20.0, c_x=7.5, c_y=7.5)
    z, o, t0 = np.ones((16, 16)), np.full((16, 16), 0.7), np.array([0.0, 0.0, 1.0])
    hyper = convert.hyper_from_fields(params.pixel_sigma, params.association_sigma,
                                      params.sigma_t, params.proposal_sigma_r)
    outs_ref, _ = ref(5, cam, z, o, t0)
    outs_tuned, _ = tuned(5, cam, z, o, t0, hyper)
    for k in ("t", "r", "log_like"):
        np.testing.assert_allclose(outs_tuned[k].numpy(), outs_ref[k].numpy(), rtol=1e-6,
                                   atol=1e-6)
    hyper2 = dict(hyper, pixel_sigma=0.012, association_sigma=0.012,
                  sigma_t=(0.04, 0.04, 0.04), proposal_sigma_r=(1.5, 1.5, 1.5))
    outs2, _ = tuned(5, cam, z, o, t0, hyper2)
    assert not np.allclose(outs2["log_like"].numpy(), outs_tuned["log_like"].numpy())


def test_conditioned_chain_uploads_mesh_once(monkeypatch):
    """Two cameras and images through one runner (tests/test_infra.py
    test_conditioned_chain_no_recompile): the mesh is uploaded and checked
    once, and the runner's one posterior, whose buffers each call refills,
    holds it."""
    calls, checks, faces_ptrs = [], [], []
    mesh_tensors, check_faces = TF.mesh_tensors, cuda_raster._check_faces
    monkeypatch.setattr(TF, "mesh_tensors", lambda *a: calls.append(1) or mesh_tensors(*a))
    monkeypatch.setattr(cuda_raster, "_check_faces", lambda *a: checks.append(1) or check_faces(*a))
    init = TF.FusedPosterior.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        faces_ptrs.append(self.faces.data_ptr())

    monkeypatch.setattr(TF.FusedPosterior, "__init__", spy)
    params = _runner_params()
    mesh = mesh_io.cube_mesh(0.1)
    run = TF.make_conditioned_chain(params, mesh.vertices, mesh.faces, "association",
                                    TES.smc_mh, 3, device="cpu")
    cam1 = convert.camera_from_fields(width=16, height=16, f_x=20.0, f_y=20.0, c_x=7.5, c_y=7.5)
    cam2 = convert.camera_from_fields(width=16, height=16, f_x=25.0, f_y=24.0, c_x=8.1, c_y=7.2)
    t0 = np.array([0.0, 0.0, 1.0], np.float32)
    outs1, _ = run(0, cam1, np.full((16, 16), np.inf), np.full((16, 16), 0.7), t0)
    outs2, _ = run(0, cam2, np.ones((16, 16)), 0.7, t0 + 0.01)
    assert outs1["t"].shape == (2, 16, 3) and outs1["log_like"].shape == (2, 16)
    assert torch.isfinite(outs2["log_prob"]).all()
    assert len(calls) == 1 and len(faces_ptrs) == 1
    assert len(checks) == 1


def test_conditioned_chain_matches_jax_in_distribution(scene):
    """The slice as a whole: both packages' conditioned runners (smooth
    variant, smc_mh) on the same per-image inputs. Same output layout and
    temperatures; since JAX threefry and torch generators draw different
    streams, the chains are compared in distribution. The position prior
    lies 5 cm beside the truth (σ_t = 3 cm), so a draw from the prior alone
    is within 2.5 cm of the truth with probability 0.04 (median distance
    6.6 cm): over six seeds, each package's median best-particle error must
    fall inside 2.5 cm, which only the likelihood can bring about."""
    params, n_steps = scene["params"], 6
    mesh = scene["mesh"]
    j_run = j_cond(params, mesh.vertices, mesh.faces, "smooth", JES.smc_mh, n_steps)
    t_run = TF.make_conditioned_chain(scene["t_params"], mesh.vertices, mesh.faces, "smooth",
                                      TES.smc_mh, n_steps, device="cpu")
    offset_t = scene["gt_t"] + np.array([0.05, 0.0, 0.0], np.float32)
    depth, prior_o, prior_t = convert.image_from_numpy(scene["obs"], scene["prior_o"], offset_t)
    errors = {"jax": [], "torch": []}
    for seed in range(6):
        outs_j, _ = j_run(jax.random.PRNGKey(seed), scene["cam"], scene["obs"],
                          scene["prior_o"], offset_t)
        outs_t, _ = t_run(seed, _t_cam(scene["cam"]), depth, prior_o, prior_t)
        assert set(outs_j) == set(outs_t)
        for k in outs_j:
            assert tuple(outs_j[k].shape) == tuple(outs_t[k].shape), k
        np.testing.assert_array_equal(np.asarray(outs_j["temperature"]),
                                      outs_t["temperature"].numpy())
        for name, outs in (("jax", outs_j), ("torch", outs_t)):
            ll = np.asarray(outs["log_like"][-1])
            assert np.all(np.isfinite(ll))
            best_t = np.asarray(outs["t"][-1])[int(np.argmax(ll))]
            errors[name].append(np.linalg.norm(best_t - scene["gt_t"]))
    for name, errs in errors.items():
        assert np.median(errs) < 0.025, (name, errs)


def test_crop_image_and_reprojection_match(rng):
    img = rng.uniform(0.5, 1.5, size=(480, 640)).astype(np.float32)
    img[rng.uniform(size=img.shape) < 0.1] = 0.0
    center = np.array([0.05, -0.03, 0.9], np.float32)
    crop = j_crop_camera(BASE, center, 0.12, width=30, height=30)
    a = j_crop_image(img, BASE, crop)
    b = t_crop_image(img, _t_cam(BASE), _t_cam(crop))
    np.testing.assert_array_equal(b, a)
    skewed = dataclasses.replace(BASE, s=2.0)
    u, v, z = rng.uniform(0, 640, 50), rng.uniform(0, 480, 50), rng.uniform(0.5, 2.0, 50)
    np.testing.assert_allclose(np.stack(t_reproject(u, v, z, _t_cam(skewed))),
                               np.stack(j_reproject(u, v, z, skewed)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("diameter", [None, 0.15])
def test_point_from_segmentation_matches(rng, diameter):
    depth = rng.uniform(0.8, 1.2, size=(480, 640)).astype(np.float32)
    depth[:, :10] = 0.0
    depth[5, 300] = np.inf
    mask = np.zeros((480, 640), np.uint8)
    mask[200:260, 280:360] = 255
    bbox = (280, 359, 200, 259)
    a = j_point(bbox, depth, mask, BASE, diameter=diameter)
    b = t_point(bbox, depth, mask, _t_cam(BASE), diameter=diameter)
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    empty = np.zeros_like(mask)
    np.testing.assert_allclose(t_point(bbox, depth, empty, _t_cam(BASE)),
                               j_point(bbox, depth, empty, BASE), rtol=1e-6, atol=1e-6)


def test_steps_for_time_budget_and_step_time(scene):
    """tests/test_evaluation.py's budget arithmetic, and a positive measured
    step time of the port's smc_mh on the CPU."""
    for args, kw in [((10.0, 0.5), {}), ((0.001, 0.5), {}), ((0.001, 0.5), {"overhead": 0.1}),
                     ((0.0031, 0.25), {"minimum": 5})]:
        assert TEV.steps_for_time_budget(*args, **kw) == JEV.steps_for_time_budget(*args, **kw)
    assert TEV.steps_for_time_budget(10.0, 0.5) == 2
    assert TEV.steps_for_time_budget(0.001, 0.5) == int(0.92 * 500)
    assert TEV.steps_for_time_budget(0.001, 0.5, overhead=0.1) == int(0.92 * 400)
    t_exp = convert.experiment_from_numpy(_t_cam(scene["cam"]), scene["mesh"].vertices,
                                          scene["mesh"].faces, scene["prior_o"], scene["gt_t"],
                                          scene["obs"])
    post = TF.fused_posterior(scene["t_params"], t_exp, "association", device="cpu")
    st, overhead = TEV.mean_step_time(0, post, TES.smc_mh(scene["t_params"], post), 8,
                                      max_seconds=0.2, steps_per_probe=(2, 6),
                                      return_overhead=True)
    assert 0 < st < 0.2 and overhead >= 0.0
    assert TEV.steps_for_time_budget(st, 0.5) >= 2
