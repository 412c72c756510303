"""The port's compile-once per-image runners on the CPU: static buffers that
each call refills, the camera as a device row, sigmas as device rows.

``make_conditioned_chain`` / ``make_tuned_chain`` build their posterior and
sampler once and capture their steps (on the card; on the CPU the same
static-buffer step runs eagerly). One runner called on several images,
cameras, seeds, candidates and step counts must give what fresh runners and
the eager per-call build (``captured=False``) give, bitwise: a stale buffer
would show here. The tuned runner is also held against the JAX package's
``make_tuned_chain`` in distribution, as the conditioned runner is in
tests/test_torch_conditioned_chain.py.
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
from bayesianposeestimation.jl_tpu.models import experiment_samplers as JES
from bayesianposeestimation.jl_tpu.models.fused import make_tuned_chain as j_tuned
from bayesianposeestimation.jl_tpu.ops.rasterize import render_depth as j_render_depth
from bayesianposeestimation.jl_tpu.parameters import Parameters as JParams
from bayesianposeestimation.jl_tpu.utils import mesh_io
from bayesianposeestimation.jl_tpu_torch import capture, convert
from bayesianposeestimation.jl_tpu_torch.models import experiment_samplers as TES
from bayesianposeestimation.jl_tpu_torch.models import fused as TF
from bayesianposeestimation.jl_tpu_torch.ops import cuda_raster
from bayesianposeestimation.jl_tpu_torch.parameters import Experiment, sigma_row
from bayesianposeestimation.jl_tpu_torch.rngs import Rngs

CAMS = (dict(width=16, height=16, f_x=20.0, f_y=20.0, c_x=7.5, c_y=7.5),
        dict(width=16, height=16, f_x=25.0, f_y=24.0, c_x=8.1, c_y=7.2, s=0.3))


def _params(**kw):
    return convert.parameters_from_fields(
        width=16, height=16, n_particles=12, n_steps=5, pixel_sigma=0.004,
        association_sigma=0.004, sigma_t=(0.02, 0.02, 0.02), proposal_sigma_r=(0.5, 0.5, 0.5),
        device="cpu", **kw)


def _images():
    """Two cameras and two observations of a 10 cm cube near 1 m."""
    mesh = mesh_io.cube_mesh(0.1)
    out = []
    for k, cam in enumerate(CAMS):
        cam = convert.camera_from_fields(**cam)
        t = torch.tensor([[0.01 * k, -0.01, 1.0]])
        q = torch.tensor([[0.95, 0.1 * k, 0.2, -0.1]])
        q = q / q.norm()
        clean = cuda_raster.render_depth(torch.as_tensor(mesh.vertices, dtype=torch.float32),
                                         torch.as_tensor(mesh.faces, dtype=torch.int32), cam,
                                         t, q, device="cpu")[0].numpy()
        noise = np.random.default_rng(k).normal(0.0, 0.004, clean.shape)
        obs = np.where(clean > 0, clean + noise, 0.0).astype(np.float32)
        prior_o = np.where(clean > 0, 0.8, 0.3).astype(np.float32)
        out.append((cam, obs, prior_o if k == 0 else 0.7,
                    np.array([0.01 * k + 0.01, -0.005, 1.01], np.float32)))
    return mesh, out


def _equal(a, b):
    sa, la = capture.tree_leaves(a)
    sb, lb = capture.tree_leaves(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert torch.equal(x, y) or torch.allclose(x, y, rtol=0, atol=0, equal_nan=True)


HYPERS = ({"pixel_sigma": 0.006, "association_sigma": 0.005, "sigma_t": (0.03, 0.02, 0.025),
           "proposal_sigma_r": (0.4, 0.6, 0.5)},
          {"pixel_sigma": 0.012, "association_sigma": 0.01, "sigma_t": (0.04, 0.04, 0.04),
           "proposal_sigma_r": (1.5, 1.5, 1.5)})


@pytest.mark.parametrize("sampler", ["smc_mh", "mh_sampler"])
def test_one_conditioned_runner_equals_fresh_runners(sampler):
    """Two images, two cameras (one skewed), two seeds and two step counts
    through one runner, each call against a fresh runner and the eager
    per-call build."""
    params, (mesh, images) = _params(), _images()
    factory = getattr(TES, sampler)
    n = 1 if sampler == "mh_sampler" else None

    def make(**kw):
        return TF.make_conditioned_chain(params, mesh.vertices, mesh.faces, "association",
                                         factory, 5, n_chains=n, device="cpu", **kw)

    shared = make()
    for (image, seed, steps) in ((images[0], 3, None), (images[1], 4, 7), (images[0], 5, 4)):
        got = shared(seed, *image, n_steps=steps)
        _equal(got, make()(seed, *image, n_steps=steps))
        _equal(got, make(captured=False)(seed, *image, n_steps=steps))
        assert got[0]["t"].shape[0] == (steps or 5) - 1
    assert list(shared.runners) == [False]


def test_one_tuned_runner_equals_fresh_runners():
    """Two candidates through one tuned runner (one posterior and sampler,
    the sigmas in device rows) against fresh runners and the eager build;
    the candidates' chains differ."""
    params, (mesh, images) = _params(), _images()

    def make(**kw):
        return TF.make_tuned_chain(params, mesh.vertices, mesh.faces, "association",
                                   TES.smc_mh, 5, device="cpu", **kw)

    shared = make()
    outs = []
    for k, hyper in enumerate(HYPERS):
        got = shared(7, *images[k], hyper)
        _equal(got, make()(7, *images[k], hyper))
        _equal(got, make(captured=False)(7, *images[k], hyper))
        outs.append(got)
    post = shared.runners[True].posterior
    assert post.params.sigma_t is shared.runners[True].rows["sigma_t"]
    assert post.hyper is shared.runners[True].rows["hyper"]
    assert not torch.equal(outs[0][0]["log_like"], outs[1][0]["log_like"])


def test_tuned_runner_with_the_params_equals_the_conditioned_runner():
    """Device rows holding the params' own sigmas give the conditioned
    runner's chain bitwise (the kernel's hyper row against its launch
    arguments, the prior's and proposals' rows against host tuples)."""
    params, (mesh, images) = _params(), _images()
    hyper = convert.hyper_from_fields(params.pixel_sigma, params.association_sigma,
                                      params.sigma_t, params.proposal_sigma_r)
    ref = TF.make_conditioned_chain(params, mesh.vertices, mesh.faces, "association",
                                    TES.smc_mh, 5, device="cpu")
    tuned = TF.make_tuned_chain(params, mesh.vertices, mesh.faces, "association", TES.smc_mh,
                                5, device="cpu")
    for image in images:
        _equal(tuned(9, *image, hyper), ref(9, *image))


def test_runner_refuses_a_camera_of_another_size():
    params, (mesh, images) = _params(), _images()
    run = TF.make_conditioned_chain(params, mesh.vertices, mesh.faces, "association",
                                    TES.smc_mh, 3, device="cpu")
    cam, obs, prior_o, prior_t = images[0]
    with pytest.raises(ValueError):
        run(0, dataclasses.replace(cam, width=20), obs, prior_o, prior_t)


@pytest.mark.parametrize("cam", CAMS)
def test_camera_row_in_the_plain_versions(cam):
    """``render_score_reference`` and ``render_depth_reference`` read from
    the camera row what they read from the camera's host scalars, bitwise,
    for every epilogue; a row of another camera gives that camera's image."""
    cam = convert.camera_from_fields(**cam, near=0.3)
    mesh = mesh_io.cube_mesh(0.1)
    verts = torch.as_tensor(mesh.vertices, dtype=torch.float32)
    faces = torch.as_tensor(mesh.faces, dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    t = torch.tensor([0.0, 0.0, 1.0]) + 0.02 * torch.randn(6, 3, generator=gen)
    q = torch.randn(6, 4, generator=gen)
    q = q / q.norm(dim=1, keepdim=True)
    row = torch.as_tensor(cuda_raster.camera_row(cam))
    z = cuda_raster.render_depth_reference(verts, faces, cam, t[:1], q[:1])[0]
    z = torch.where(z > 0, z, torch.full_like(z, torch.inf))
    params = _params()
    for variant in ("simple", "association", "smooth", "no_exp", "no_exp_association"):
        a = cuda_raster.render_score_reference(verts, faces, cam, t, q, z, 0.7, params, variant,
                                               return_mu=True)
        b = cuda_raster.render_score_reference(verts, faces, cam, t, q, z, 0.7, params, variant,
                                               return_mu=True, cam_row=row)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), variant
    for cull in (True, False):
        assert torch.equal(
            cuda_raster.render_depth_reference(verts, faces, cam, t, q, cull),
            cuda_raster.render_depth_reference(verts, faces, cam, t, q, cull, cam_row=row))
    other = dataclasses.replace(cam, f_x=cam.f_x * 1.2, c_y=cam.c_y + 1.0)
    assert torch.equal(
        cuda_raster.render_depth(verts, faces, cam, t, q, device="cpu",
                                 cam_row=torch.as_tensor(cuda_raster.camera_row(other))),
        cuda_raster.render_depth(verts, faces, other, t, q, device="cpu"))
    with pytest.raises(ValueError):
        cuda_raster.render_depth(verts, faces, cam, t, q, device="cpu", cam_row=row[:6])
    with pytest.raises(TypeError):
        cuda_raster.render_depth(verts, faces, cam, t, q, device="cpu", cam_row=row.double())


def test_sigma_rows_equal_host_sigmas():
    """sigma_t and proposal_sigma_r as device rows (``sigma_row`` passes them
    through) give the prior densities and the proposals' draws of the host
    tuples, bitwise."""
    params, (mesh, images) = _params(), _images()
    cam, obs, prior_o, prior_t = images[0]
    rows = params.replace(sigma_t=torch.tensor(params.sigma_t, dtype=torch.float32),
                          proposal_sigma_r=torch.tensor(params.proposal_sigma_r,
                                                        dtype=torch.float32))
    assert sigma_row(rows.sigma_t, "cpu") is rows.sigma_t
    exp = Experiment(scene={"camera": cam, "verts": torch.as_tensor(mesh.vertices),
                            "faces": torch.as_tensor(mesh.faces, dtype=torch.int32)},
                     prior_o=0.7, prior_t=prior_t, depth_image=obs)
    host, dev = (TF.fused_posterior(p, exp, "association", device="cpu") for p in (params, rows))
    s_host = host.sample_prior(Rngs.from_seed(0, "cpu").device, 16)
    s_dev = dev.sample_prior(Rngs.from_seed(0, "cpu").device, 16)
    _equal(s_host, s_dev)
    _equal(host.logdensity_sample(s_host), dev.logdensity_sample(s_host))
    for a, b in zip(TES.smc_mh(params, host).samplers, TES.smc_mh(rows, dev).samplers):
        da = a.kernel.propose(Rngs.from_seed(1, "cpu").device, _state(host, s_host))
        db = b.kernel.propose(Rngs.from_seed(1, "cpu").device, _state(dev, s_host))
        _equal(da, db)


def _state(post, sample):
    from bayesianposeestimation.jl_tpu_torch.samplers.smc import SmcState

    s = post.logdensity_sample(sample)
    n = s.log_like.shape[0]
    w = torch.full((n,), -float(np.log(n)))
    zero = torch.zeros(())
    return SmcState(s, w, zero, zero, zero)


@pytest.fixture(scope="module")
def jax_scene():
    """A 10 cm cube at 1 m behind a 16x16 crop, its noisy observation and a
    silhouette prior image (the scene of tests/test_torch_conditioned_chain.py)."""
    params = JParams(width=16, height=16, n_particles=32, n_steps=6,
                     proposal_sigma_r=(0.5, 0.5, 0.5))
    mesh = mesh_io.cube_mesh(0.1)
    gt_t = np.array([0.01, -0.02, 1.0], np.float32)
    base = JCam(width=640, height=480, f_x=600.0, f_y=600.0, c_x=319.5, c_y=239.5,
                near=0.01, far=10.0)
    cam = j_crop_camera(base, gt_t, mesh_io.mesh_diameter(mesh), width=16, height=16)
    k_gt, k_noise = jax.random.split(jax.random.PRNGKey(3))
    gt_q = JQ.rand_quaternion(k_gt)
    clean = np.asarray(j_render_depth(jnp.asarray(mesh.vertices), jnp.asarray(mesh.faces), cam,
                                      jnp.asarray(gt_t), gt_q))
    obs = np.where(clean > 0, clean + 0.005 * np.asarray(jax.random.normal(k_noise, clean.shape)),
                   0.0).astype(np.float32)
    prior_o = np.where(clean > 0, 0.85, 0.25).astype(np.float32)
    t_params = convert.parameters_from_fields(
        **{f.name: getattr(params, f.name) for f in dataclasses.fields(params)})
    t_cam = convert.camera_from_fields(**{f.name: float(getattr(cam, f.name))
                                          for f in dataclasses.fields(cam)})
    return dict(params=params, t_params=t_params, mesh=mesh, cam=cam, t_cam=t_cam, gt_t=gt_t,
                obs=obs, prior_o=prior_o)


def test_tuned_runner_matches_jax_in_distribution(jax_scene):
    """One candidate through both packages' tuned runners (smc_mh, the
    association variant): same output layout and temperatures, and, as the
    threefry and torch streams differ, each package's median best-particle
    error over six seeds within 2.5 cm of the truth from a position prior 5
    cm beside it (σ_t = 2.5 cm: the prior alone gets there with probability
    ~0.06)."""
    sc, n_steps = jax_scene, 6
    mesh = sc["mesh"]
    hyper = {"pixel_sigma": 0.006, "association_sigma": 0.006, "sigma_t": (0.025,) * 3,
             "proposal_sigma_r": (0.5,) * 3}
    j_run = j_tuned(sc["params"], mesh.vertices, mesh.faces, "association", JES.smc_mh, n_steps)
    t_run = TF.make_tuned_chain(sc["t_params"], mesh.vertices, mesh.faces, "association",
                                TES.smc_mh, n_steps, device="cpu")
    offset_t = sc["gt_t"] + np.array([0.05, 0.0, 0.0], np.float32)
    errors = {"jax": [], "torch": []}
    for seed in range(6):
        outs_j, _ = j_run(jax.random.PRNGKey(seed), sc["cam"], sc["obs"], sc["prior_o"],
                          offset_t, hyper)
        outs_t, _ = t_run(seed, sc["t_cam"], sc["obs"], sc["prior_o"], offset_t, hyper)
        assert set(outs_j) == set(outs_t)
        for k in outs_j:
            assert tuple(outs_j[k].shape) == tuple(outs_t[k].shape), k
        np.testing.assert_array_equal(np.asarray(outs_j["temperature"]),
                                      outs_t["temperature"].numpy())
        for name, outs in (("jax", outs_j), ("torch", outs_t)):
            ll = np.asarray(outs["log_like"][-1])
            assert np.all(np.isfinite(ll))
            best_t = np.asarray(outs["t"][-1])[int(np.argmax(ll))]
            errors[name].append(np.linalg.norm(best_t - sc["gt_t"]))
    for name, errs in errors.items():
        assert np.median(errs) < 0.025, (name, errs)
