"""Port parity: the six graph posteriors and the render node.

Each factory of ``models.experiment_models`` is built in both packages on
the same experiment (``convert.experiment_from_numpy``) and evaluated on the
same particles (the JAX prior's draws, ``convert.sample_from_numpy``): on
the 16x16 cube of tests/test_pallas_raster.py's graph-vs-fused test and at
the demo's full shape (scripts/demo_inference.py: the 1,280-face monkey, the
VGA camera cropped to 30x30, the noisy observation; 16 particles). The JAX
graph renders with its dense XLA rasteriser, the port's with the plain
version of the ``render_depth`` kernel. Tolerance rtol 1e-3, atol 0.05: the
JAX package's own graph and fused posteriors differ by up to 0.0043 at the
demo's shape.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianposeestimation.jl_tpu import quaternions as JQ
from bayesianposeestimation.jl_tpu.camera import CvCamera as JCam
from bayesianposeestimation.jl_tpu.camera import crop_camera
from bayesianposeestimation.jl_tpu.models import experiment_models as JEM
from bayesianposeestimation.jl_tpu.ops.rasterize import render_depth
from bayesianposeestimation.jl_tpu.parameters import Experiment, Parameters
from bayesianposeestimation.jl_tpu.render import render as j_render
from bayesianposeestimation.jl_tpu.render import render_context as j_render_context
from bayesianposeestimation.jl_tpu.render import render_crop_fn as j_render_crop_fn
from bayesianposeestimation.jl_tpu.utils import mesh_io
from bayesianposeestimation.jl_tpu_torch import convert
from bayesianposeestimation.jl_tpu_torch.models import experiment_models as TEM
from bayesianposeestimation.jl_tpu_torch.models import fused as TF
from bayesianposeestimation.jl_tpu_torch.ops import cuda_raster
from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_depth as t_render_depth

# the module: the package's name render is the function render.render
TR = importlib.import_module("bayesianposeestimation.jl_tpu_torch.render")
TOL = dict(rtol=1e-3, atol=0.05)
# graph factory -> the fused variant that computes the same densities
FACTORIES = {"simple_posterior": "simple", "association_posterior": "association",
             "association_simple_reg": "association_simple_reg", "smooth_posterior": "smooth",
             "smooth_simple_reg": "smooth_simple_reg",
             "smooth_simple_posterior": "smooth_simple"}


def _convert(params, cam, mesh, exp_args):
    tp = convert.parameters_from_fields(
        **{f.name: getattr(params, f.name) for f in dataclasses.fields(params)})
    tcam = convert.camera_from_fields(**{f.name: float(getattr(cam, f.name))
                                         for f in dataclasses.fields(cam)})
    texp = convert.experiment_from_numpy(tcam, mesh.vertices, mesh.faces, *exp_args)
    return tp, texp


def _scene(name):
    """(JAX params, experiment, prior μ node), (port ...), n particles."""
    if name == "cube16":  # tests/test_pallas_raster.py test_fused_posterior_matches_graph
        params = Parameters(width=16, height=16, raster_chunk=64)
        mesh = mesh_io.cube_mesh(0.1)
        base = JCam(width=64, height=64, f_x=64.0, f_y=64.0, c_x=31.5, c_y=31.5, near=0.01,
                    far=10.0)
        cam = crop_camera(base, np.array([0.0, 0.0, 1.0]), 0.1 * np.sqrt(3), width=16, height=16)
        gt_t, gt_q = jnp.array([0.0, 0.0, 1.0]), JQ.quat_identity()
        noise = 0.0
    else:  # scripts/demo_inference.py at its defaults
        params = Parameters(proposal_sigma_r=(0.5, 0.5, 0.5))
        mesh = mesh_io.monkey_mesh(0.08)
        base = JCam(width=640, height=480, f_x=600.0, f_y=600.0, c_x=319.5, c_y=239.5,
                    near=0.01, far=10.0)
        cam = crop_camera(base, np.array([0.01, -0.02, 1.0]), mesh_io.mesh_diameter(mesh),
                          width=30, height=30)
        k_gt, _ = jax.random.split(jax.random.PRNGKey(0))
        gt_t, gt_q = jnp.array([0.01, -0.02, 1.0]), JQ.rand_quaternion(k_gt)
        noise = params.pixel_sigma
    scene = {"camera": cam, "verts": jnp.asarray(mesh.vertices), "faces": jnp.asarray(mesh.faces)}
    clean = render_depth(scene["verts"], scene["faces"], cam, gt_t, gt_q)
    obs = jnp.where(clean > 0, clean + noise * jax.random.normal(jax.random.PRNGKey(5),
                                                                 clean.shape), 0.0)
    exp = Experiment(scene=scene, prior_o=params.o_mask_is, prior_t=gt_t, depth_image=obs)
    tp, texp = _convert(params, cam, mesh, (params.o_mask_is, np.asarray(gt_t), np.asarray(obs)))
    return dict(params=params, exp=exp, prior=JEM.point_prior(params, exp), tparams=tp,
                texp=texp, tprior=TEM.point_prior(tp, texp, device="cpu"),
                n=8 if name == "cube16" else 16, gt_t=np.asarray(gt_t), gt_q=np.asarray(gt_q))


@pytest.fixture(scope="module")
def scenes():
    return {name: _scene(name) for name in ("cube16", "demo")}


def _particles(jmodel, n, gt_t, gt_q):
    """The JAX prior's draws, a quarter of them moved next to the truth."""
    s = jmodel.sample_prior(jax.random.PRNGKey(3), n)
    t, r = np.array(s.variables["t"]), np.array(s.variables["r"])
    k = n // 4
    t[:k] = gt_t + 0.003 * np.random.default_rng(0).normal(size=(k, 3))
    r[:k] = np.asarray(JQ.qplus(jnp.asarray(gt_q), 0.05 * np.random.default_rng(1).normal(
        size=(k, 3)).astype(np.float32)))
    return {"t": t.astype(np.float32), "r": r.astype(np.float32)}


@pytest.mark.parametrize("factory", list(FACTORIES))
@pytest.mark.parametrize("scene", ["cube16", "demo"])
def test_graph_posterior_matches_jax_and_fused(scenes, scene, factory):
    """log_like and log_prob of the same particles: the port's graph
    posterior against the JAX package's, and against the port's fused
    posterior of the matching variant."""
    sc = scenes[scene]
    jpost = getattr(JEM, factory)(sc["params"], sc["exp"], sc["prior"])
    tpost = getattr(TEM, factory)(sc["tparams"], sc["texp"], sc["tprior"])
    fpost = TF.fused_posterior(sc["tparams"], sc["texp"], FACTORIES[factory], device="cpu")
    draws = _particles(jpost, sc["n"], sc["gt_t"], sc["gt_q"])
    a = jpost.logdensity_sample(jpost.sample_prior(jax.random.PRNGKey(0), 1).merge(
        {k: jnp.asarray(v) for k, v in draws.items()}))
    b = tpost.logdensity_sample(convert.sample_from_numpy(draws))
    f = fpost.logdensity_sample(convert.sample_from_numpy(draws))
    for k in ("log_like", "log_prob"):
        ja, tb, fb = np.asarray(getattr(a, k)), getattr(b, k).numpy(), getattr(f, k).numpy()
        assert tb.shape == (sc["n"],) and np.all(np.isfinite(tb))
        np.testing.assert_allclose(tb, ja, **TOL)
        np.testing.assert_allclose(tb, fb, **TOL)
    assert np.ptp(b.log_like.numpy()) > 1.0  # the particles are told apart
    assert tpost.device == torch.device("cpu") and set(tpost.prior_stochastic) == {"t", "r"}
    assert set(tpost.likelihood) == {"z"} and tpost.quaternion_names == ("r",)


def test_tries_by_chains_batch(scenes):
    """The multiple-try batch [tries, chains]: flattened into one render and
    shaped back, equal to the rows evaluated one by one and to JAX's
    batch_ndim=2 evaluation."""
    sc = scenes["cube16"]
    jpost = JEM.association_posterior(sc["params"], sc["exp"], sc["prior"])
    tpost = TEM.association_posterior(sc["tparams"], sc["texp"], sc["tprior"])
    draws = _particles(jpost, 12, sc["gt_t"], sc["gt_q"])
    batched = {k: v.reshape(3, 4, -1) for k, v in draws.items()}
    b2 = tpost.logdensity_sample(convert.sample_from_numpy(batched), batch_ndim=2)
    b1 = tpost.logdensity_sample(convert.sample_from_numpy(draws))
    a2 = jpost.logdensity_sample(jpost.sample_prior(jax.random.PRNGKey(0), 1).merge(
        {k: jnp.asarray(v) for k, v in batched.items()}), batch_ndim=2)
    assert b2.log_like.shape == (3, 4)
    torch.testing.assert_close(b2.log_like.reshape(-1), b1.log_like)
    torch.testing.assert_close(b2.log_prob.reshape(-1), b1.log_prob)
    np.testing.assert_allclose(b2.log_like.numpy(), np.asarray(a2.log_like), **TOL)
    np.testing.assert_allclose(b2.log_prob.numpy(), np.asarray(a2.log_prob), **TOL)


def _assert_same_image(a, b, min_cover=0.05):
    """tests/test_torch_render_depth.py's gates: coverage differs on fewer
    than 5e-3 of the pixels, p99 relative depth below 1e-4."""
    assert a.shape == b.shape
    assert (b > 0).mean() > min_cover
    both = (a > 0) & (b > 0)
    assert np.mean((a > 0) != (b > 0)) < 5e-3
    assert np.percentile(np.abs(a[both] - b[both]) / b[both], 99) < 1e-4


def test_render_fn_matches_jax(scenes):
    """render_fn on a [2, 3] batch of poses near the truth: one render, the
    batch dims restored, the image JAX's render_fn gives; no launch on the
    CPU."""
    sc = scenes["demo"]
    rng = np.random.default_rng(2)
    t = (sc["gt_t"] + 0.005 * rng.normal(size=(2, 3, 3))).astype(np.float32)
    r = np.array(JQ.qplus(jnp.asarray(sc["gt_q"]), 0.2 * rng.normal(size=(2, 3, 3)).astype(
        np.float32)))
    ctx_j, ctx_t = j_render_context(sc["params"]), TR.render_context(sc["tparams"])
    assert (ctx_t.width, ctx_t.height, ctx_t.depth) == (ctx_j.width, ctx_j.height, ctx_j.depth)
    launches = t_render_depth.launches
    scene = TR.render_scene(sc["texp"].scene, "cpu")
    mu_t = TR.render(ctx_t, scene, torch.as_tensor(t), torch.as_tensor(r)).numpy()
    mu_j = np.asarray(j_render(ctx_j, sc["exp"].scene, jnp.asarray(t), jnp.asarray(r)))
    assert mu_t.shape == (2, 3, 30, 30) and t_render_depth.launches == launches
    _assert_same_image(mu_t, mu_j)


def test_render_crop_fn_matches_jax():
    """tests/test_default_config.py's crop render: the camera cropped around
    the first position frames the cube (5-30 % of the pixels)."""
    params = Parameters(width=16, height=16)
    mesh = mesh_io.cube_mesh(0.1)
    cam = JCam(width=16, height=16, f_x=19.2, f_y=19.2, c_x=7.5, c_y=7.5)
    scene = {"camera": cam, "verts": jnp.asarray(mesh.vertices), "faces": jnp.asarray(mesh.faces)}
    t = np.array([[0.0, 0.0, 1.0], [0.01, 0.0, 1.0]], np.float32)
    r = np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (2, 1))
    mu_j = np.asarray(j_render_crop_fn(j_render_context(params), scene, 0.2, jnp.asarray(t),
                                       jnp.asarray(r)))
    tp, texp = _convert(params, cam, mesh, (0.7, t[0], np.ones((16, 16), np.float32)))
    mu_t = TR.render_crop_fn(TR.render_context(tp), TR.render_scene(texp.scene, "cpu"), 0.2,
                             torch.as_tensor(t), torch.as_tensor(r)).numpy()
    assert 0.05 < float((mu_t[0] > 0).mean()) < 0.3
    _assert_same_image(mu_t, mu_j)


def test_faces_checked_again_against_fewer_vertices(scenes, monkeypatch):
    """A faces tensor checked once is checked again, and refused, beside a
    vertex array too short for its indices."""
    sc = scenes["cube16"]
    checks = []
    inner = cuda_raster._check_faces
    monkeypatch.setattr(cuda_raster, "_check_faces", lambda *a: checks.append(1) or inner(*a))
    mesh = mesh_io.cube_mesh(0.1)
    verts, faces = cuda_raster.mesh_tensors(mesh.vertices, mesh.faces, "cpu")
    cuda_raster.check_faces(faces, verts.shape[0])
    assert len(checks) == 1
    with pytest.raises(ValueError):
        cuda_raster.check_faces(faces, verts.shape[0] - 1)
    texp = sc["texp"]
    short = type(texp)({**texp.scene, "verts": verts[:-1], "faces": faces}, texp.prior_o,
                       texp.prior_t, texp.prior_r, texp.depth_image)
    with pytest.raises(ValueError):
        TF.FusedPosterior(sc["tparams"], short, "simple", device="cpu")
    assert len(checks) == 3


def test_mesh_checked_once_and_no_cpu_launches(scenes, monkeypatch):
    """Building priors and posteriors again on the same mesh checks its faces
    once; CPU evaluations launch nothing; asking for the card without one
    raises."""
    sc = scenes["cube16"]
    checks = []
    inner = cuda_raster._check_faces
    monkeypatch.setattr(cuda_raster, "_check_faces", lambda *a: checks.append(1) or inner(*a))
    launches = t_render_depth.launches
    for _ in range(3):
        prior = TEM.point_prior(sc["tparams"], sc["texp"], device="cpu")
        post = TEM.smooth_posterior(sc["tparams"], sc["texp"], prior)
        post.logdensity_sample(post.sample_prior(torch.Generator().manual_seed(0), 4))
    assert len(checks) <= 1 and t_render_depth.launches == launches
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TEM.point_prior(sc["tparams"], sc["texp"])
