"""The port's figure scripts against the JAX scripts' computations.

``scripts/torch_plot_depth_imgs.py``, ``torch_visualize_crop.py`` and
``torch_visualize_full_scene.py`` at ``device="cpu"`` (the plain render) on
synth val scene 1 against the same JAX calls: ``point_from_segmentation``,
``crop_camera`` / ``crop_image``, ``rasterize.render_depth_batch`` (the
tolerances of tests/test_torch_render_depth.py; the JAX dense rasteriser
holds an [F, H·W] buffer, so the 640x480 frame is compared on a window
around the object) and ``pixel_association_fn``; the generated image in
distribution. ``torch_simple_logjac`` at 2,000 steps recovers θ in both
packages within the script's stated bound. ``torch_plots.py`` draws every
``_cuda`` experiment, each figure's data equal to its CSV's values; the
save / draw round trip writes the figures, and drawing without matplotlib
raises.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesianposeestimation.jl_tpu import quaternions as jquat
from bayesianposeestimation.jl_tpu.camera import crop_camera as jcrop_camera
from bayesianposeestimation.jl_tpu.camera import crop_image as jcrop_image
from bayesianposeestimation.jl_tpu.distributions import Normal as JNormal
from bayesianposeestimation.jl_tpu.graph import BroadcastedNode as JNode
from bayesianposeestimation.jl_tpu.graph import sequentialize as jsequentialize
from bayesianposeestimation.jl_tpu.models import pixel as jpixel
from bayesianposeestimation.jl_tpu.models.experiment_models import (
    point_from_segmentation as jpoint_from_segmentation,
)
from bayesianposeestimation.jl_tpu.ops.rasterize import render_depth_batch as jrender
from bayesianposeestimation.jl_tpu.parameters import Parameters as JParams
from bayesianposeestimation.jl_tpu.proposals import independent_proposal as jindependent
from bayesianposeestimation.jl_tpu.proposals import symmetric_proposal as jsymmetric
from bayesianposeestimation.jl_tpu.samplers import ComposedSampler as JComposed
from bayesianposeestimation.jl_tpu.samplers import MetropolisHastings as JMH
from bayesianposeestimation.jl_tpu.samplers import sample_chain as jsample_chain
from bayesianposeestimation.jl_tpu.tempering import ConstantSchedule as JConstant
from bayesianposeestimation.jl_tpu.utils import bop as jbop

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import simple_logjac as jlogjac  # noqa: E402
import torch_plot_depth_imgs as depth_imgs  # noqa: E402
import torch_plots  # noqa: E402
import torch_simple_logjac as logjac  # noqa: E402
import torch_visualize_crop as crop  # noqa: E402
import torch_visualize_full_scene as full  # noqa: E402

BOP_ARGV = ["--bop-dir", str(REPO / "data/bop")]
ARGV = BOP_ARGV + ["--device", "cpu"]


def _assert_same_image(a, b):
    """tests/test_torch_render_depth.py's image gate."""
    assert a.shape == b.shape
    assert (b > 0).mean() > 0.05  # the object is in view
    mismatch = np.mean((a > 0) != (b > 0))
    both = (a > 0) & (b > 0)
    rel = np.abs(a[both] - b[both]) / b[both]
    assert mismatch < 5e-3, f"coverage mismatch {mismatch}"
    assert np.percentile(rel, 99) < 1e-4, f"p99 relative depth {np.percentile(rel, 99)}"


@pytest.fixture(scope="module")
def jax_setup():
    """The JAX scripts' set-up of synth val scene 1's first row."""
    row = jbop.bop_test_or_train(str(REPO / "data/bop"), "synth", "val", 1).iloc[0]
    cam = jbop.camera_for_row(row)
    depth = jbop.load_depth_image(row)
    mask = jbop.load_mask_image(row)
    ys, xs = np.nonzero(np.asarray(mask))
    prior_t = jpoint_from_segmentation((xs.min(), xs.max(), ys.min(), ys.max()), depth, mask,
                                       cam)
    gt_t = jnp.asarray(row.gt_t, jnp.float32)[None]
    gt_q = jquat.matrix_to_quat(jnp.asarray(row.gt_R, jnp.float32))[None]
    return dict(row=row, cam=cam, depth=np.asarray(depth), diameter=jbop.model_diameter(row),
                prior_t=np.asarray(prior_t), gt_t=gt_t, gt_q=gt_q)


@pytest.fixture(scope="module")
def depth_panels():
    args = depth_imgs.parse_args(ARGV)
    return args, depth_imgs.panels(args, "cpu")


def test_set_up_matches_jax(jax_setup):
    ours = depth_imgs.first_row(depth_imgs.parse_args(ARGV))
    # JAX scales the depth by a float64 depth_scale from its DataFrame row
    np.testing.assert_allclose(ours["depth"], jax_setup["depth"], rtol=1e-6)
    np.testing.assert_allclose(ours["prior_t"], jax_setup["prior_t"], rtol=1e-6)
    assert ours["diameter"] == pytest.approx(jax_setup["diameter"])
    assert {f: getattr(ours["cam"], f) for f in ("width", "height", "f_x", "f_y", "c_x", "c_y")} \
        == pytest.approx({f: getattr(jax_setup["cam"], f)
                          for f in ("width", "height", "f_x", "f_y", "c_x", "c_y")})


def test_plot_depth_imgs_panels_match_jax(jax_setup, depth_panels):
    """z equal to JAX's crop, mu within the render gate of JAX's dense
    rasteriser (back faces drawn), o equal to JAX's association on the same
    mu and z; every panel [R, R] float32."""
    args, p = depth_panels
    s = jax_setup
    res = args.resolution
    cam = jcrop_camera(s["cam"], s["prior_t"], s["diameter"], width=res, height=res)
    z = np.asarray(jcrop_image(s["depth"], s["cam"], cam))
    np.testing.assert_allclose(p["z"], z, rtol=1e-6)
    mesh = jbop.load_mesh(s["row"])
    mu = np.asarray(jrender(jnp.asarray(mesh.vertices), jnp.asarray(mesh.faces), cam,
                            s["gt_t"], s["gt_q"])[0])
    _assert_same_image(p["mu"], mu)
    o = jpixel.pixel_association_fn(JParams(width=res, height=res))(
        jnp.float32(0.5), jnp.asarray(p["mu"]), jnp.asarray(p["z"]))
    np.testing.assert_allclose(p["o"], np.asarray(o), rtol=1e-5, atol=1e-5)
    for k in ("z", "mu", "gen", "o"):
        assert p[k].shape == (res, res) and p[k].dtype == np.float32


def test_generated_image_in_distribution(jax_setup, depth_panels):
    """gen ~ N(mu, pixel_sigma) on the object, 0 off it, in both packages:
    the share within 3 sigma above its binomial bound, the mean standardised
    residual within 5 of its standard errors of 0."""
    _, p = depth_panels
    sigma = JParams().pixel_sigma
    mu = p["mu"]
    dist = jpixel.pixel_mixture(JParams().min_depth, JParams().max_depth, JParams().pixel_theta,
                                sigma, jnp.asarray(mu), jnp.float32(1.0))
    jgen = np.where(mu > 0, np.asarray(dist.sample(jax.random.PRNGKey(8))), 0.0)
    for gen in (p["gen"], jgen):
        k, n, least = depth_imgs.within_3_sigma(gen, mu, sigma)
        assert n > 1000 and k >= least, (k, n, least)
        assert (gen[mu == 0] == 0).all()
        resid = (gen[mu > 0] - mu[mu > 0]) / sigma
        assert abs(resid.mean()) < 5 / np.sqrt(n)


def test_crops_match_jax(jax_setup):
    s = jax_setup
    crops = crop.panels(crop.parse_args(BOP_ARGV))
    assert sorted(crops) == ["crop_15", "crop_30", "crop_60"]
    for res in (15, 30, 60):
        cam = jcrop_camera(s["cam"], s["prior_t"], s["diameter"], width=res, height=res)
        np.testing.assert_allclose(crops[f"crop_{res}"],
                                   np.asarray(jcrop_image(s["depth"], s["cam"], cam)), rtol=1e-6)


def test_full_scene_matches_jax_on_a_window(jax_setup):
    """The 640x480 render (plain version, every face drawn) against JAX's
    dense rasteriser on a window 8 px around the object (the whole frame
    would take JAX an [F, 307,200] buffer): the same image; the frame
    outside the window empty."""
    s = jax_setup
    p = full.panels(full.parse_args(ARGV), "cpu")
    np.testing.assert_allclose(p["depth"], s["depth"], rtol=1e-6)
    ys, xs = np.nonzero(p["render"])
    y0, y1 = max(ys.min() - 8, 0), min(ys.max() + 9, 480)
    x0, x1 = max(xs.min() - 8, 0), min(xs.max() + 9, 640)
    cam = s["cam"]
    win = dataclasses.replace(cam, width=int(x1 - x0), height=int(y1 - y0),
                              c_x=cam.c_x - x0, c_y=cam.c_y - y0)
    mesh = jbop.load_mesh(s["row"], decimate_to=full.DECIMATE_TO)
    ref = np.asarray(jrender(jnp.asarray(mesh.vertices), jnp.asarray(mesh.faces), win,
                             s["gt_t"], s["gt_q"])[0])
    _assert_same_image(p["render"][y0:y1, x0:x1], ref)
    outside = p["render"].copy()
    outside[y0:y1, x0:x1] = 0
    assert not outside.any()


def _jax_chains(n_steps):
    """scripts/simple_logjac.py's three chains at ``n_steps``."""
    model = jlogjac.target_model(logjac.THETA)
    sym = JMH(jsymmetric(jsequentialize(JNode("z", JNormal, 0.0, 0.1)), model), JConstant())
    ind = JMH(jindependent(jsequentialize(JNode("z", JNormal, 0.0, 1.5)), model), JConstant())
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    out = {}
    for key, label, sampler in zip(keys, logjac.CHAINS,
                                   (sym, ind, JComposed((sym, ind), weights=(0.5, 0.5)))):
        outs, _ = jsample_chain(key, model, sampler, n_steps=n_steps, n_particles=8,
                                collect_vars=("z",), n_burn_in=500, collect_every=5)
        out[label] = np.exp(np.asarray(outs["z"]).ravel())
    return out


def test_simple_logjac_recovers_theta_in_both_packages():
    steps = logjac.CHECK_STEPS
    ours = logjac.chains(logjac.parse_args(["--device", "cpu", "--n-steps", str(steps)]))
    ref = _jax_chains(steps)
    n_kept = (steps - 1 - 500 + 4) // 5 * 8
    for label, bound in logjac.MEAN_REL_BOUND.items():
        for z in (ours[label], ref[label]):
            assert z.shape == (n_kept,) and (z > 0).all()
            assert abs(z.mean() - logjac.THETA) / logjac.THETA <= bound, (label, z.mean())


def _errorbars(ax):
    """{label: (x, y)} of an axes' errorbar containers."""
    return {c.get_label(): (tuple(c.lines[0].get_xdata()), tuple(c.lines[0].get_ydata()))
            for c in ax.containers}


def test_torch_plots_draws_every_cuda_experiment(tmp_path):
    """Every BOP run's curves at their markers equal sampler_recall.csv (or
    paired_vs_jax.csv's port column), the visibility errorbars and the
    sweeps' points their CSVs; one PDF per figure."""
    from bayesianposeestimation.jl_tpu_torch.utils import evaluation as ev

    figs = torch_plots.draw_all(str(REPO / "data"), str(tmp_path))
    exp_pro = REPO / "data/exp_pro"
    runs = torch_plots.bop_runs(REPO / "data")
    assert {"smc_bop_cad", "hard_cases_vis", "smc_bop_val2_b005", "mcmc_baseline"} <= set(runs)
    theta = np.linspace(0, 1, 51)
    for name in runs:
        d = exp_pro / f"{name}_cuda"
        if (d / "sampler_recall.csv").exists():
            want = {(r["sampler"], m): float(r[f"{m}_recall"])
                    for r in torch_plots.read_csv(d / "sampler_recall.csv") for m in ("adds",
                                                                                      "vsd")}
        else:
            want = {(r["sampler"], r["metric"]): float(r["port_recall"])
                    for r in torch_plots.read_csv(d / "paired_vs_jax.csv")}
        for metric, th in (("adds", ev.ADDS_THETA), ("vsd", ev.BOP18_THETA)):
            lines = [ln for ln in figs[f"{name}_{metric}_recall"].axes[0].get_lines()
                     if ln.get_label() in {s for s, _ in want}]
            assert {ln.get_label() for ln in lines} == {s for s, m in want if m == metric}
            i = int(np.argmin(np.abs(theta - th)))
            for ln in lines:
                assert ln.get_ydata()[i] == pytest.approx(want[(ln.get_label(), metric)],
                                                          abs=1e-12)
        visib = d / "recall_vs_visibility.csv"
        assert (f"{name}_recall_vs_visibility" in figs) == visib.exists()
        if visib.exists():
            rows = torch_plots.read_csv(visib)
            got = _errorbars(figs[f"{name}_recall_vs_visibility"].axes[0])
            assert sorted(got) == sorted({r["sampler"] for r in rows})
            for sampler, (x, y) in got.items():
                grp = sorted((r for r in rows if r["sampler"] == sampler),
                             key=lambda r: float(r["visib_lo"]))
                assert y == tuple(float(r["vsd_recall"]) for r in grp)
                assert x == pytest.approx([(float(r["visib_lo"]) + float(r["visib_hi"])) / 2
                                           for r in grp])
    for name in torch_plots.BUDGET_SWEEPS:
        rows = torch_plots.read_csv(exp_pro / f"{name}_cuda/recall_vs_budget.csv")
        got = _errorbars(figs[f"{name}_recall_vs_budget"].axes[0])
        assert len(got) == len({int(r["n_particles"]) for r in rows})
        for n_p in {int(r["n_particles"]) for r in rows}:
            grp = sorted((r for r in rows if int(r["n_particles"]) == n_p),
                         key=lambda r: float(r["pose_time"]))
            assert got[f"{n_p} particles"] == (tuple(float(r["pose_time"]) for r in grp),
                                               tuple(float(r["vsd_recall"]) for r in grp))
    rows = torch_plots.read_csv(exp_pro / "mcmc_benchmark_cuda/recall_vs_time.csv")
    got = _errorbars(figs["mcmc_benchmark_vsd"].axes[0])
    assert sorted((x, y) for xs, ys in got.values() for x, y in zip(xs, ys)) == sorted(
        (float(r["mean_pose_time"]), float(r["vsd_recall"])) for r in rows)
    rows = torch_plots.read_csv(exp_pro / "smc_mh_resolution_cuda/resolution_recall.csv")
    ax1, ax2 = figs["smc_mh_resolution"].axes
    assert list(ax1.get_lines()[0].get_xdata()) == sorted(int(r["resolution"]) for r in rows)
    assert list(ax1.get_lines()[0].get_ydata()) == [
        float(r["vsd_recall"]) for r in sorted(rows, key=lambda r: int(r["resolution"]))]
    assert ax2.get_lines()[0].get_ydata() == pytest.approx(
        [1e3 * float(r["step_time"]) for r in sorted(rows, key=lambda r: int(r["resolution"]))])
    assert sorted(p.stem for p in tmp_path.glob("*.pdf")) == sorted(figs)


def test_save_then_draw_round_trip(tmp_path):
    """--save-arrays writes the arrays; --draw-from draws the same figure
    from them, its panels the saved arrays."""
    npz, pdf = tmp_path / "d.npz", tmp_path / "d.pdf"
    saved = crop.main(BOP_ARGV + ["--save-arrays", str(npz)])
    assert npz.exists() and not pdf.exists()
    drawn = crop.main(["--draw-from", str(npz), "--out", str(pdf)])
    assert pdf.stat().st_size > 0
    for k in saved:
        np.testing.assert_array_equal(saved[k], drawn[k])


def test_drawing_without_matplotlib_raises(tmp_path):
    npz = tmp_path / "d.npz"
    np.savez(npz, crop_15=np.ones((15, 15), np.float32))
    code = ("import sys; sys.modules['matplotlib'] = None; sys.path.insert(0, 'scripts'); "
            "import torch_visualize_crop as c; "
            f"c.main(['--draw-from', {str(npz)!r}, '--out', {str(tmp_path / 'x.pdf')!r}])")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), timeout=120)
    assert proc.returncode != 0 and "import of matplotlib halted" in proc.stderr
    assert not (tmp_path / "x.pdf").exists()
