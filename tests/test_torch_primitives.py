"""Port parity: math primitives, camera, distributions, pixel models, rasterizer.

The same NumPy inputs (fixed seed) go through ``jl_tpu`` (JAX, CPU) and
``jl_tpu_torch`` (PyTorch, CPU); outputs are compared as NumPy. Tolerances
are fp32-level (1e-5) unless a test says why it needs more.
"""

import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianposeestimation.jl_tpu import distributions as JD
from bayesianposeestimation.jl_tpu import quaternions as JQ
from bayesianposeestimation.jl_tpu.camera import CvCamera as JCam
from bayesianposeestimation.jl_tpu.camera import crop_camera as j_crop
from bayesianposeestimation.jl_tpu.models import pixel as JP
from bayesianposeestimation.jl_tpu.ops.rasterize import render_depth_batch as j_render
from bayesianposeestimation.jl_tpu.parameters import Parameters as JParams
from bayesianposeestimation.jl_tpu.utils import mesh_io as j_mesh
from bayesianposeestimation.jl_tpu_torch import convert
from bayesianposeestimation.jl_tpu_torch import distributions as TD
from bayesianposeestimation.jl_tpu_torch import quaternions as TQ
from bayesianposeestimation.jl_tpu_torch.camera import crop_camera as t_crop
from bayesianposeestimation.jl_tpu_torch.models import pixel as TP
from bayesianposeestimation.jl_tpu_torch.ops.rasterize import render_depth_batch as t_render
from bayesianposeestimation.jl_tpu_torch.utils import mesh_io as t_mesh

PORT = Path(__file__).resolve().parent.parent / "bayesianposeestimation" / "jl_tpu_torch"
INF = np.inf


def J(x):
    return jnp.asarray(np.asarray(x, np.float32))


def T(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("fn", ["qmul", "qminus", "quat_dist"])
def test_quaternion_binary_ops(fn, rng):
    a, b = _quats(rng, 64), _quats(rng, 64)
    close(getattr(JQ, fn)(J(a), J(b)), getattr(TQ, fn)(T(a), T(b)), atol=3e-5)


def test_quaternion_maps_and_rotation(rng):
    q = _quats(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v[:4] *= 1e-8  # the small-angle branches of exp and log
    close(JQ.qexp(J(v)), TQ.qexp(T(v)))
    close(JQ.qlog(J(q)), TQ.qlog(T(q)), atol=3e-5)
    close(JQ.qplus(J(q), J(v)), TQ.qplus(T(q), T(v)))
    close(JQ.qrotate(J(q), J(v)), TQ.qrotate(T(q), T(v)))
    close(JQ.quat_to_matrix(J(q)), TQ.quat_to_matrix(T(q)))
    close(JQ.qconj(J(q)), TQ.qconj(T(q)))


def test_rand_quaternion_is_unit_and_uniform():
    g = torch.Generator().manual_seed(3)
    q = TQ.rand_quaternion(g, (4000,))
    close(torch.linalg.vector_norm(q, dim=-1), np.ones(4000))
    # Haar measure: E[w^2] = 1/4 for every component
    close(q.square().mean(0), np.full(4, 0.25), atol=0.02)


def test_crop_camera_matches():
    base = dict(width=640, height=480, f_x=600.0, f_y=600.0, c_x=319.5, c_y=239.5,
                near=0.01, far=10.0)
    center = np.array([0.01, -0.02, 1.0])
    a = j_crop(JCam(**base), center, 0.08, width=30, height=30)
    b = t_crop(convert.camera_from_fields(**base), center, 0.08, width=30, height=30)
    for f in dataclasses.fields(a):
        close(float(getattr(a, f.name)), getattr(b, f.name), rtol=1e-6, atol=1e-6)


def test_mesh_copy_is_identical():
    for name, args in [("cube_mesh", (0.1,)), ("icosphere_mesh", (0.06, 2)),
                       ("monkey_mesh", (0.08,))]:
        a, b = getattr(j_mesh, name)(*args), getattr(t_mesh, name)(*args)
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.faces, b.faces)
        assert j_mesh.mesh_diameter(a) == t_mesh.mesh_diameter(b)
    assert t_mesh.monkey_mesh(0.08).n_faces == 1280


def _depths(rng):
    z = rng.uniform(-0.2, 2.0, size=64).astype(np.float32)
    z[:3] = [INF, 0.0, -1.0]
    return z


def test_distributions_match_with_infinities(rng):
    z = _depths(rng)
    mu = rng.uniform(0.0, 1.5, size=64).astype(np.float32)
    cases = [
        (JD.Normal(J(mu), 0.01), TD.Normal(T(mu), 0.01)),
        (JD.Exponential(1.0), TD.Exponential(1.0)),
        (JD.TailUniform(0.5, 1.5), TD.TailUniform(0.5, 1.5)),
        (JD.BinaryMixture(JD.Normal(J(mu), 0.01), JD.Exponential(1.0), 0.3, 0.7),
         TD.BinaryMixture(TD.Normal(T(mu), 0.01), TD.Exponential(1.0), 0.3, 0.7)),
    ]
    for dj, dt in cases:
        a, b = np.asarray(dj.logpdf(J(z))), dt.logpdf(T(z)).numpy()
        np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
        assert not np.isnan(b).any()
        fin = np.isfinite(a)
        close(a[fin], b[fin], rtol=1e-5, atol=1e-3)  # |logpdf| ~ 1e4 at 0.01 scale
    # +inf observation: Normal and Exponential give -inf
    assert np.isneginf(TD.Normal(0.5, 0.01).logpdf(T([INF])).numpy()).all()
    assert np.isneginf(TD.Exponential(1.0).logpdf(T([INF])).numpy()).all()
    # logaddexp(-inf, -inf) = -inf, no NaN, in the mixture
    both = TD.BinaryMixture(TD.Normal(0.5, 0.01), TD.Exponential(1.0), 0.5, 0.5)
    assert np.isneginf(both.logpdf(T([INF])).numpy()).all()
    q = _quats(rng, 8)
    close(JD.QuaternionUniform().logpdf(J(q)), TD.QuaternionUniform().logpdf(T(q)))


@pytest.mark.parametrize("prior", [0.0, 0.7, 1.0, "image"])
def test_pixel_association_and_mixture(prior, rng):
    z = _depths(rng).reshape(8, 8)
    mu = rng.uniform(0.4, 1.6, size=(8, 8)).astype(np.float32)
    mu[0, :4] = 0.0  # background pixels return the prior
    mu[1, :4] = z[1, :4] = 1.0  # exact fits
    if prior == "image":
        prior = rng.uniform(0.0, 1.0, size=(8, 8)).astype(np.float32)
        prior[2, :2] = [0.0, 1.0]
    jp = JParams(width=8, height=8)
    tp = convert.parameters_from_fields(**{f.name: getattr(jp, f.name)
                                           for f in dataclasses.fields(jp)})
    oj = JP.pixel_association_fn(jp)(J(prior), J(mu), J(z))
    ot = TP.pixel_association_fn(tp)(T(prior), T(mu), T(z))
    close(oj, ot)
    lj = JP.pixel_mixture(jp.min_depth, jp.max_depth, jp.pixel_theta, jp.pixel_sigma,
                          J(mu), oj).logpdf(J(z))
    lt = TP.pixel_mixture(tp.min_depth, tp.max_depth, tp.pixel_theta, tp.pixel_sigma,
                          T(mu), ot).logpdf(T(z))
    lj, lt = np.asarray(lj), lt.numpy()
    # prior 1 at z = +inf leaves no tail weight: -inf in both, never NaN
    np.testing.assert_array_equal(np.isneginf(lj), np.isneginf(lt))
    assert not np.isnan(lt).any()
    fin = np.isfinite(lj)
    close(lj[fin], lt[fin], rtol=1e-5, atol=1e-3)


def test_regularizers(rng):
    ell = rng.normal(size=6).astype(np.float32) * 100
    n = np.array([0, 1, 5, 10, 0, 300], np.float32)
    a = np.asarray(JP.logdensity_npixel(J(ell), 50.0, J(n)))
    b = TP.logdensity_npixel(T(ell), 50.0, T(n)).numpy()
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    close(a[np.isfinite(a)], b[np.isfinite(b)])
    close(JP.simple_image_regularization(50.0, J(ell), 900),
          TP.simple_image_regularization(50.0, T(ell), 900))


def test_parameters_from_fields_maps_types():
    jp = JParams(sigma_t=(0.1, 0.2, 0.3), raster_chunk=64)
    tp = convert.parameters_from_fields(**{f.name: getattr(jp, f.name)
                                           for f in dataclasses.fields(jp)})
    assert tp.float_type is torch.float32 and tp.device == "cuda"
    assert tp.sigma_t == pytest.approx((0.1, 0.2, 0.3))
    with pytest.raises(TypeError):
        convert.parameters_from_fields(no_such_field=1)


@pytest.mark.parametrize("mesh_name,w,h", [("cube", 16, 16), ("icosphere", 24, 10)])
def test_render_depth_batch_matches(mesh_name, w, h, rng):
    """Coverage and interior depths as tests/test_pallas_raster.py compares
    two rasterizers: rare silhouette winner flips are allowed (1% of pixels)."""
    mesh = j_mesh.cube_mesh(0.1) if mesh_name == "cube" else j_mesh.icosphere_mesh(0.06, 1)
    cam = dict(width=w, height=h, f_x=100.0, f_y=100.0, c_x=(w - 1) / 2, c_y=(h - 1) / 2,
               near=0.01, far=10.0)
    q = _quats(rng, 5)
    t = (np.array([0.0, 0.0, 1.0]) + 0.03 * rng.normal(size=(5, 3))).astype(np.float32)
    a = np.asarray(j_render(J(mesh.vertices), jnp.asarray(mesh.faces), JCam(**cam), J(t), J(q)))
    b = t_render(T(mesh.vertices), torch.as_tensor(mesh.faces),
                 convert.camera_from_fields(**cam), T(t), T(q)).numpy()
    assert a.shape == b.shape == (5, h, w)
    assert (a > 0).mean() > 0.05
    assert np.mean((a > 0) != (b > 0)) < 0.01
    both = (a > 0) & (b > 0)
    np.testing.assert_allclose(a[both], b[both], atol=2e-3)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


PORT_FILES = sorted(PORT.rglob("*.py")) + [
    PORT.parents[1] / "chip_smoke.py", PORT.parents[1] / "chip_profile.py",
    PORT.parents[1] / "parity_cases.py", PORT.parents[1] / "bench_torch.py"] + sorted((PORT.parents[1] / "scripts").glob("torch_*.py"))


def test_import_check_covers_the_sweeps_and_sharding():
    names = {str(p.relative_to(PORT.parents[1])) for p in PORT_FILES}
    wanted = {f"bayesianposeestimation/jl_tpu_torch/parallel/{m}.py"
              for m in ("__init__", "sharded", "sweep")}
    wanted |= {f"scripts/torch_{m}.py" for m in (
        "smc_benchmark", "smc_benchmark_steri", "mcmc_benchmark", "mcmc_baseline",
        "smc_mh_baseline", "smc_mh_resolution", "smc_observation", "smc_priors",
        "trajectory_error")}
    assert wanted <= names, wanted - names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(PORT.parents[1])))
def test_port_imports_no_jax(path):
    """Checked on the source text, so it does not depend on what some other
    test happened to import already."""
    for name in _imports(path):
        assert name.split(".")[0] not in ("jax", "jaxlib"), (path, name)
        assert "jl_tpu" not in name.replace("jl_tpu_torch", ""), (path, name)
        # a relative import may not climb out of the port package
        if name.startswith("."):
            depth = len(name) - len(name.lstrip("."))
            rel = path.relative_to(PORT).parts
            assert depth <= len(rel), (path, name)
