"""Plots: depth/probability heatmaps, pose chains, evidence, recall curves.

Counterpart of ``jl_tpu/utils/visualization.py``, with the same names and the
same figures. Every function takes NumPy arrays or tensors (a tensor is
copied to the host first) and returns the matplotlib Figure, so scripts can
save or show it. ``plot_recall_vs_visibility`` takes rows as dicts (the
schema of ``recall_vs_visibility.csv``), as ``utils/bop.py`` does, where the
JAX package takes a pandas DataFrame.

matplotlib is imported inside ``_plt`` and ``diss_defaults`` only, so the
module imports where matplotlib is absent (the card's machine): arrays are
computed there and drawn elsewhere.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "diss_defaults",
    "plot_depth_img",
    "plot_prob_img",
    "plot_best_pose",
    "plot_scene_ontop",
    "mean_image",
    "plot_pose_chain",
    "plot_pose_density",
    "plot_logprob",
    "plot_logevidence",
    "plot_recall_curves",
    "plot_recall_vs_visibility",
]


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(x, dtype=None):
    """``x`` as a NumPy array; a tensor is detached and copied to the host."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def diss_defaults():
    """Publication-style defaults (the JAX package's ``diss_defaults``)."""
    import matplotlib

    matplotlib.rcParams.update({
        "figure.dpi": 150,
        "font.size": 9,
        "axes.grid": True,
        "grid.alpha": 0.3,
        "figure.constrained_layout.use": True,
    })


def _axes(ax):
    if ax is None:
        return _plt().subplots()
    return ax.figure, ax


def plot_depth_img(img, ax=None, title=None):
    """Depth heatmap; invalid (0/inf) pixels masked out."""
    img = _np(img, float)
    masked = np.ma.masked_where(~np.isfinite(img) | (img <= 0), img)
    fig, ax = _axes(ax)
    im = ax.imshow(masked, cmap="viridis")
    fig.colorbar(im, ax=ax, label="depth / m")
    if title:
        ax.set_title(title)
    return fig


def plot_prob_img(img, ax=None, title=None):
    """Probability heatmap in [0, 1]."""
    fig, ax = _axes(ax)
    im = ax.imshow(_np(img, float), cmap="magma", vmin=0, vmax=1)
    fig.colorbar(im, ax=ax, label="probability")
    if title:
        ax.set_title(title)
    return fig


def mean_image(images, log_weights=None):
    """Weighted mean over the particle axis (float64, on the host)."""
    images = _np(images, float)
    if log_weights is None:
        return images.mean(axis=0)
    lw = _np(log_weights)
    w = np.exp(lw - np.max(lw))
    w = w / w.sum()
    return np.tensordot(w, images, axes=1)


def plot_best_pose(render_depth_fn, ts, qs, log_likes, obs_img=None):
    """Render the max-likelihood pose and overlay it on the observation.
    ``render_depth_fn(t, q)`` gets the best row of ``ts`` and ``qs`` as given
    (a tensor row for tensors) and may return a tensor."""
    plt = _plt()
    best = int(np.argmax(_np(log_likes)))
    depth = _np(render_depth_fn(ts[best], qs[best]))
    fig, axes = plt.subplots(1, 2 if obs_img is not None else 1, squeeze=False)
    plot_depth_img(depth, ax=axes[0][0], title="best pose render")
    if obs_img is not None:
        plot_scene_ontop(obs_img, depth, ax=axes[0][1])
    return fig


def plot_scene_ontop(obs_img, render_img, ax=None, alpha=0.6):
    """Overlay a render silhouette on the observed image."""
    fig, ax = _axes(ax)
    obs = _np(obs_img, float)
    obs = np.ma.masked_where(~np.isfinite(obs) | (obs <= 0), obs)
    ax.imshow(obs, cmap="gray")
    mask = _np(render_img) > 0
    overlay = np.zeros((*mask.shape, 4))
    overlay[mask] = (1.0, 0.3, 0.1, alpha)
    ax.imshow(overlay)
    ax.set_title("estimate on observation")
    return fig


def plot_pose_chain(ts, qs, gt_t=None, gt_q=None):
    """Per-dimension translation traces + rotation-angle trace."""
    plt = _plt()
    ts = _np(ts)
    qs = _np(qs)
    steps = np.arange(ts.shape[0])
    fig, axes = plt.subplots(2, 2)
    for d, name in enumerate("xyz"):
        ax = axes.flat[d]
        vals = ts[..., d].reshape(ts.shape[0], -1)
        ax.plot(steps, vals.mean(-1), lw=1)
        ax.fill_between(steps, vals.min(-1), vals.max(-1), alpha=0.3)
        if gt_t is not None:
            ax.axhline(_np(gt_t)[d], color="k", ls="--", lw=0.8)
        ax.set_ylabel(f"t_{name} / m")
    ax = axes.flat[3]
    w = np.abs(qs[..., 0].reshape(qs.shape[0], -1))
    angle = 2 * np.degrees(np.arccos(np.clip(w, 0, 1)))
    ax.plot(steps, angle.mean(-1), lw=1)
    ax.set_ylabel("rotation angle / deg")
    ax.set_xlabel("step")
    return fig


def plot_pose_density(ts, bins=50, log_weights=None):
    """Translation marginals of the final particles. For weighted SMC
    populations pass ``log_weights``: the marginals are then the weighted
    posterior density, not the raw particle histogram."""
    plt = _plt()
    ts = _np(ts).reshape(-1, 3)
    weights = None
    if log_weights is not None:
        lw = _np(log_weights).reshape(-1)
        weights = np.exp(lw - lw.max())
        weights = weights / weights.sum()
    fig, axes = plt.subplots(1, 3)
    for d, name in enumerate("xyz"):
        axes[d].hist(ts[:, d], bins=bins, density=True, weights=weights)
        axes[d].set_xlabel(f"t_{name} / m")
    return fig


def plot_logprob(log_probs):
    """Log probability per step; the max and mean over particles for [steps, N]."""
    plt = _plt()
    lp = _np(log_probs)
    fig, ax = plt.subplots()
    if lp.ndim > 1:
        ax.plot(lp.max(-1), label="max")
        ax.plot(lp.mean(-1), label="mean")
        ax.legend()
    else:
        ax.plot(lp)
    ax.set_xlabel("step")
    ax.set_ylabel("log probability")
    return fig


def plot_logevidence(log_evidence):
    """Log-evidence trace, a convergence indicator of SMC."""
    plt = _plt()
    fig, ax = plt.subplots()
    ax.plot(_np(log_evidence))
    ax.set_xlabel("step")
    ax.set_ylabel("log evidence")
    return fig


def plot_recall_curves(errors_by_label, theta_marker=None, theta_range=None, title=""):
    """Recall-over-threshold curves per sampler label."""
    plt = _plt()
    theta_range = np.linspace(0, 1, 51) if theta_range is None else theta_range
    fig, ax = plt.subplots()
    for label, errors in errors_by_label.items():
        errors = _np(errors, float).ravel()
        recalls = [(errors < th).mean() if errors.size else 0.0 for th in theta_range]
        ax.plot(theta_range, recalls, label=label)
    if theta_marker is not None:
        ax.axvline(theta_marker, color="k", ls="--", lw=0.8)
    ax.set_xlabel("error threshold")
    ax.set_ylabel("recall")
    ax.set_ylim(0, 1)
    ax.set_title(title)
    ax.legend()
    return fig


def plot_recall_vs_visibility(visib_rows, title="VSD recall vs visibility"):
    """Recall per visibility bin with CI error bars, one line per sampler
    (in sorted order). ``visib_rows``: dicts with sampler, visib_lo,
    visib_hi, vsd_recall, ci_lo, ci_hi (the recall_vs_visibility.csv schema;
    numbers may be strings, as the csv module reads them)."""
    plt = _plt()
    groups = {}
    for r in visib_rows:
        groups.setdefault(r["sampler"], []).append(r)
    fig, ax = plt.subplots()
    for label in sorted(groups):
        grp = sorted(groups[label], key=lambda r: float(r["visib_lo"]))

        def col(key):
            return np.array([float(r[key]) for r in grp])

        recall = col("vsd_recall")
        x = (col("visib_lo") + col("visib_hi")) / 2
        # clip: CSVs written before recall_ci clamped the interval to contain
        # p-hat can carry ci_hi = recall - 2e-16 at full recall. Only float
        # dust may be clipped: an interval that excludes its own point
        # estimate must surface, not be zeroed.
        yerr = np.stack([recall - col("ci_lo"), col("ci_hi") - recall])
        if (yerr < -1e-9).any():
            raise ValueError(
                f"recall_vs_visibility rows for {label!r} have CI bounds on "
                f"the wrong side of the point estimate (min margin "
                f"{yerr.min():.3g}); the CSV is inconsistent")
        yerr = np.clip(yerr, 0.0, None)
        ax.errorbar(x, recall, yerr=yerr, marker="o", capsize=3, label=label)
    ax.set_xlabel("visibility fraction")
    ax.set_ylabel("VSD recall")
    ax.set_ylim(0, 1.02)
    ax.set_title(title)
    ax.legend()
    return fig
