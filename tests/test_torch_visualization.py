"""The port's plotting module against the JAX package's.

Every case of ``tests/test_visualization.py`` runs through
``jl_tpu_torch.utils.visualization``; then each plotting function draws the
same seeded NumPy inputs in both packages (and tensors in the port), and the
two figures must hold equal artist data: image arrays and their masks, line
x / y, patch extents, errorbar segments, titles and labels. ``mean_image``
equals JAX's within 1e-12, and both packages raise on a confidence interval
on the wrong side of its point.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from bayesianposeestimation.jl_tpu.utils import visualization as jviz  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils import visualization as viz  # noqa: E402


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


# -- the cases of tests/test_visualization.py, through the port ---------------------


def test_plots_smoke(tmp_path):
    viz.diss_defaults()
    rng = np.random.default_rng(0)
    depth = np.where(rng.uniform(size=(24, 24)) > 0.3, rng.uniform(0.8, 1.2, (24, 24)), 0.0)
    fig = viz.plot_depth_img(depth, title="depth")
    fig.savefig(tmp_path / "depth.png")
    fig = viz.plot_prob_img(rng.uniform(size=(24, 24)))
    fig.savefig(tmp_path / "prob.png")

    ts = rng.normal(0, 0.01, (50, 8, 3)) + [0, 0, 1]
    qs = rng.normal(size=(50, 8, 4))
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    fig = viz.plot_pose_chain(ts, qs, gt_t=[0, 0, 1])
    fig.savefig(tmp_path / "chain.png")
    fig = viz.plot_pose_density(ts[-1])
    fig.savefig(tmp_path / "density.png")
    fig = viz.plot_logprob(rng.normal(size=(50, 8)))
    fig.savefig(tmp_path / "logprob.png")
    fig = viz.plot_logevidence(np.cumsum(rng.normal(size=50)))
    fig.savefig(tmp_path / "evidence.png")
    fig = viz.plot_recall_curves({"smc": rng.uniform(0, 1, 100)}, theta_marker=0.3)
    fig.savefig(tmp_path / "recall.png")
    fig = viz.plot_scene_ontop(depth, (depth > 1.0).astype(float))
    fig.savefig(tmp_path / "overlay.png")

    mean = viz.mean_image(rng.uniform(size=(8, 24, 24)), np.log(np.full(8, 1 / 8)))
    assert mean.shape == (24, 24)

    def render_fn(t, q):
        return depth

    fig = viz.plot_best_pose(render_fn, ts[-1], qs[-1], rng.normal(size=8), obs_img=depth)
    fig.savefig(tmp_path / "best.png")
    assert (tmp_path / "best.png").stat().st_size > 0


def test_mean_image_weighting_correct():
    imgs = np.stack([np.full((4, 4), 1.0), np.full((4, 4), 3.0)])
    np.testing.assert_allclose(viz.mean_image(imgs, log_weights=np.array([0.0, -np.inf])), 1.0)
    np.testing.assert_allclose(viz.mean_image(imgs, log_weights=np.log([0.5, 0.5])), 2.0)
    np.testing.assert_allclose(viz.mean_image(imgs, log_weights=np.log([0.75, 0.25])), 1.5)
    out = viz.mean_image(imgs, log_weights=np.log([0.75, 0.25]) + 123.0)
    np.testing.assert_allclose(out, 1.5)


def test_plot_pose_density_weighted():
    ts = np.concatenate([np.zeros((50, 3)), np.ones((50, 3))])
    lw = np.concatenate([np.full(50, 0.0), np.full(50, -50.0)])
    fig = viz.plot_pose_density(ts, bins=2, log_weights=lw)
    heights = [p.get_height() for p in fig.axes[0].patches[:2]]
    assert heights[0] > 100 * max(heights[1], 1e-12)


VISIB_ROWS = [
    dict(sampler="smc_mh", visib_lo=0.1, visib_hi=0.3, n_gt=6,
         vsd_recall=0.5, ci_lo=0.19, ci_hi=0.81),
    dict(sampler="smc_mh", visib_lo=0.3, visib_hi=0.5, n_gt=16,
         vsd_recall=1.0, ci_lo=0.806, ci_hi=1.0 - 2e-16),
    dict(sampler="mh_sampler", visib_lo=0.1, visib_hi=0.3, n_gt=6,
         vsd_recall=0.0, ci_lo=0.0 + 2e-16, ci_hi=0.39),
]


def test_plot_recall_vs_visibility_clips_float_dust(tmp_path):
    fig = viz.plot_recall_vs_visibility(VISIB_ROWS)
    fig.savefig(tmp_path / "visib.png")
    assert (tmp_path / "visib.png").stat().st_size > 0


# -- the same figures in both packages -----------------------------------------------


def _artists(fig):
    """Every axes' data as plain Python / NumPy values."""
    out = []
    for ax in fig.axes:
        entry = {
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "ylim": ax.get_ylim() if ax.get_autoscaley_on() is False else None,
            "images": [(np.ma.getdata(im.get_array()), np.ma.getmaskarray(im.get_array()),
                        im.get_cmap().name, im.get_clim()) for im in ax.get_images()],
            "lines": [(np.asarray(ln.get_xdata(), float), np.asarray(ln.get_ydata(), float),
                       ln.get_label()) for ln in ax.get_lines()],
            "patches": [(p.get_x(), p.get_y(), p.get_width(), p.get_height())
                        for p in ax.patches],
            "collections": [[np.asarray(s) for s in (c.get_segments() if hasattr(
                c, "get_segments") else [p.vertices for p in c.get_paths()])]
                for c in ax.collections],
        }
        out.append(entry)
    return out


def _assert_same(a, b):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), (a, b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    depth = np.where(rng.uniform(size=(20, 16)) > 0.3, rng.uniform(0.8, 1.2, (20, 16)), 0.0)
    depth[0, 0] = np.inf
    ts = rng.normal(0, 0.01, (30, 6, 3)) + [0, 0, 1]
    qs = rng.normal(size=(30, 6, 4))
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    return dict(depth=depth, prob=rng.uniform(size=(20, 16)), ts=ts, qs=qs,
                lw=rng.normal(size=6) * 3, lp=rng.normal(size=(30, 6)),
                ev=np.cumsum(rng.normal(size=30)),
                errors={"smc_mh": rng.uniform(0, 1, 40), "mh_sampler": rng.uniform(0, 1, 33)},
                log_likes=rng.normal(size=6))


def _tensor(x):
    return torch.as_tensor(x) if isinstance(x, np.ndarray) else x


CASES = {
    "depth_img": lambda m, x, c: m.plot_depth_img(c(x["depth"]), title="d"),
    "prob_img": lambda m, x, c: m.plot_prob_img(c(x["prob"]), title="p"),
    "scene_ontop": lambda m, x, c: m.plot_scene_ontop(c(x["depth"]), c(x["prob"] > 0.5)),
    "pose_chain": lambda m, x, c: m.plot_pose_chain(c(x["ts"]), c(x["qs"]),
                                                    gt_t=c(np.array([0, 0, 1.0]))),
    "pose_density": lambda m, x, c: m.plot_pose_density(c(x["ts"][-1]), bins=7),
    "pose_density_weighted": lambda m, x, c: m.plot_pose_density(
        c(x["ts"][-1]), bins=7, log_weights=c(x["lw"])),
    "logprob": lambda m, x, c: m.plot_logprob(c(x["lp"])),
    "logprob_1d": lambda m, x, c: m.plot_logprob(c(x["lp"][:, 0])),
    "logevidence": lambda m, x, c: m.plot_logevidence(c(x["ev"])),
    "recall_curves": lambda m, x, c: m.plot_recall_curves(
        {k: c(v) for k, v in x["errors"].items()}, theta_marker=0.3, title="VSD"),
    "best_pose": lambda m, x, c: m.plot_best_pose(
        lambda t, q: c(x["depth"] * float(np.asarray(t)[2])), c(x["ts"][-1]),
        c(x["qs"][-1]), c(x["log_likes"]), obs_img=c(x["depth"])),
}


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_figure_data_equal_to_jax(case, as_tensor):
    """The port's figure holds the artist data of the JAX package's figure
    on the same inputs (the port's inputs as tensors too)."""
    x = _inputs()
    ref = _artists(CASES[case](jviz, x, lambda v: v))
    ours = _artists(CASES[case](viz, x, _tensor if as_tensor else (lambda v: v)))
    _assert_same(ours, ref)
    assert any(e["images"] or e["lines"] or e["patches"] for e in ref)


def test_recall_vs_visibility_data_equal_to_jax():
    """Rows as dicts in the port, a DataFrame in JAX: the same errorbars,
    samplers in sorted order, float dust clipped; numbers read as strings
    (the csv module) give the same figure."""
    ref = _artists(jviz.plot_recall_vs_visibility(pd.DataFrame(VISIB_ROWS)))
    ours = _artists(viz.plot_recall_vs_visibility(VISIB_ROWS))
    as_text = [{k: str(v) for k, v in r.items()} for r in VISIB_ROWS]
    _assert_same(ours, ref)
    _assert_same(_artists(viz.plot_recall_vs_visibility(as_text)), ref)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_mean_image_equals_jax(as_tensor):
    rng = np.random.default_rng(5)
    imgs = rng.uniform(size=(6, 9, 7))
    c = _tensor if as_tensor else (lambda v: v)
    for lw in (None, rng.normal(size=6), np.array([0.0, -np.inf, 1.0, 2.0, -3.0, 0.5]),
               rng.normal(size=6) + 123.0):
        ref = jviz.mean_image(imgs, lw)
        ours = viz.mean_image(c(imgs), None if lw is None else c(lw))
        assert isinstance(ours, np.ndarray) and ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)


def test_both_raise_on_an_interval_on_the_wrong_side():
    rows = [dict(sampler="smc_mh", visib_lo=0.1, visib_hi=0.3, n_gt=6,
                 vsd_recall=0.5, ci_lo=0.6, ci_hi=0.81)]
    with pytest.raises(ValueError, match="wrong side"):
        jviz.plot_recall_vs_visibility(pd.DataFrame(rows))
    with pytest.raises(ValueError, match="wrong side"):
        viz.plot_recall_vs_visibility(rows)
