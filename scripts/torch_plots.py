#!/usr/bin/env python3
"""The figures the JAX drivers draw inline, drawn from the port's artifacts.

    python3 scripts/torch_plots.py [--data-root data] [--out-dir plots/cuda]

The port's drivers run on the card, whose machine has no matplotlib, so they
write CSVs and error artifacts only. This script draws, wherever matplotlib
is, the JAX drivers' figures from the ``_cuda`` artifacts under --data-root,
with the port's ``utils.visualization`` and the ``csv`` module (no pandas):

- every BOP run (``data/exp_pro/<name>_cuda/errors`` holding one artifact per
  dataset, testset, sampler, scene and mode, as scripts/torch_smc_bop_val.py
  writes them): ``<name>_adds_recall`` and ``<name>_vsd_recall``, the
  recall-over-threshold curves per sampler marked at ``ev.ADDS_THETA`` /
  ``ev.BOP18_THETA``, and ``<name>_recall_vs_visibility`` where
  ``recall_vs_visibility.csv`` exists (scripts/smc_bop_val.py:486-498);
- ``smc_benchmark{,_cad,_steri}_cuda`` -> ``<name>_recall_vs_budget``
  (scripts/smc_benchmark.py:112-131);
- ``mcmc_benchmark_cuda`` -> ``mcmc_benchmark_vsd``
  (scripts/mcmc_benchmark.py:97-116);
- ``smc_mh_resolution_cuda`` -> ``smc_mh_resolution``
  (scripts/smc_mh_resolution.py:86-102).

Each figure is written as ``<out-dir>/<the JAX figure's stem>.pdf``; the
default --out-dir, plots/cuda, keeps the JAX package's plots/*.pdf
untouched.
"""

from __future__ import annotations

import argparse
import csv
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

# the config keys of a BOP run's error artifacts (scripts/torch_smc_bop_val.py)
BOP_RUN_KEYS = {"dataset", "testset", "sampler", "scene_id", "mode"}
BUDGET_SWEEPS = ("smc_benchmark", "smc_benchmark_cad", "smc_benchmark_steri")


def read_csv(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def bop_runs(data_root):
    """Names of the BOP runs under <data_root>/exp_pro (without ``_cuda``)."""
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import parse_savename

    names = []
    for d in sorted(Path(data_root, "exp_pro").glob("*_cuda")):
        files = sorted((d / "errors").glob("*.npz"))
        if files and all(set(parse_savename(f.name)) <= BOP_RUN_KEYS for f in files):
            names.append(d.name[:-len("_cuda")])
    return names


def run_errors(name, data_root):
    """{sampler: {"adds": [...], "vsd": [...]}} of a BOP run, its scenes
    concatenated in artifact order; samplers in sampler_recall.csv's order
    where the run has one."""
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import collect_results

    out_dir = Path(data_root, "exp_pro", f"{name}_cuda")
    errors = {}
    for r in collect_results(out_dir / "errors"):
        e = errors.setdefault(r["__config__"]["sampler"], {"adds": [], "vsd": []})
        for k in e:
            e[k].append(np.asarray(r[k], float).ravel())
    table = out_dir / "sampler_recall.csv"
    order = [r["sampler"] for r in read_csv(table)] if table.exists() else sorted(errors)
    return {s: {k: np.concatenate(v) for k, v in errors[s].items()} for s in order}


def draw_bop_run(name, data_root):
    """{stem: Figure} of a BOP run."""
    from bayesianposeestimation.jl_tpu_torch.utils import evaluation as ev
    from bayesianposeestimation.jl_tpu_torch.utils.visualization import (
        plot_recall_curves,
        plot_recall_vs_visibility,
    )

    errors = run_errors(name, data_root)
    figs = {
        f"{name}_adds_recall": plot_recall_curves(
            {s: e["adds"] for s, e in errors.items()}, ev.ADDS_THETA, title="ADDS"),
        f"{name}_vsd_recall": plot_recall_curves(
            {s: e["vsd"] for s, e in errors.items()}, ev.BOP18_THETA, title="VSD"),
    }
    visib = Path(data_root, "exp_pro", f"{name}_cuda", "recall_vs_visibility.csv")
    if visib.exists():
        figs[f"{name}_recall_vs_visibility"] = plot_recall_vs_visibility(read_csv(visib))
    return figs


def _groups(rows, key):
    """Rows grouped by ``key(row)``, groups in sorted key order (as pandas'
    groupby orders them)."""
    groups = {}
    for r in rows:
        groups.setdefault(key(r), []).append(r)
    return [(k, groups[k]) for k in sorted(groups)]


def _errorbar(ax, rows, x, **kw):
    """VSD recall against column ``x`` with its Wilson interval, as the JAX
    drivers draw it (the interval clipped at the point)."""
    rows = sorted(rows, key=lambda r: float(r[x]))

    def col(k):
        return np.array([float(r[k]) for r in rows])

    recall = col("vsd_recall")
    yerr = np.clip(np.stack([recall - col("vsd_ci_lo"), col("vsd_ci_hi") - recall]), 0.0, None)
    ax.errorbar(col(x), recall, yerr=yerr, marker="o", **kw)


def draw_recall_vs_budget(name, data_root):
    from bayesianposeestimation.jl_tpu_torch.utils.visualization import _plt

    rows = read_csv(Path(data_root, "exp_pro", f"{name}_cuda", "recall_vs_budget.csv"))
    fig, ax = _plt().subplots()
    for n_particles, grp in _groups(rows, lambda r: int(r["n_particles"])):
        _errorbar(ax, grp, "pose_time", capsize=3, label=f"{n_particles} particles")
    ax.set_xscale("log")
    ax.set_xlabel("pose time budget [s]")
    ax.set_ylabel("VSD recall")
    ax.set_ylim(0, 1.05)
    ax.legend()
    return {f"{name}_recall_vs_budget": fig}


def draw_mcmc_benchmark(data_root):
    from bayesianposeestimation.jl_tpu_torch.utils.visualization import _plt

    rows = read_csv(Path(data_root, "exp_pro", "mcmc_benchmark_cuda", "recall_vs_time.csv"))
    fig, ax = _plt().subplots(figsize=(5, 3.2))
    for (sampler, n_p), grp in _groups(rows, lambda r: (r["sampler"], int(r["n_particles"]))):
        label = sampler if sampler.startswith("mh") else f"{sampler} T={n_p}"
        _errorbar(ax, grp, "mean_pose_time", capsize=2, label=label)
    ax.set_xlabel("mean inference time [s]")
    ax.set_ylabel("VSD recall")
    ax.legend(fontsize=7)
    return {"mcmc_benchmark_vsd": fig}


def draw_resolution(data_root):
    from bayesianposeestimation.jl_tpu_torch.utils.visualization import _plt

    rows = read_csv(Path(data_root, "exp_pro", "smc_mh_resolution_cuda",
                         "resolution_recall.csv"))
    groups = _groups(rows, lambda r: int(r["resolution"]))
    res = np.array([k for k, _ in groups])
    recall = np.array([np.mean([float(r["vsd_recall"]) for r in g]) for _, g in groups])
    step_ms = np.array([np.mean([float(r["step_time"]) for r in g]) for _, g in groups]) * 1e3
    fig, ax1 = _plt().subplots(figsize=(5, 3.2))
    ax1.plot(res, recall, "o-", label="VSD recall")
    ax1.set_xlabel("crop resolution [px]")
    ax1.set_ylabel("VSD recall")
    ax2 = ax1.twinx()
    ax2.plot(res, step_ms, "s--", color="tab:orange", label="step time")
    ax2.set_ylabel("step time [ms]")
    return {"smc_mh_resolution": fig}


def draw_all(data_root="data", out_dir="plots/cuda"):
    """Draw and write every figure; returns {stem: Figure} (each closed
    once written, its artists kept)."""
    from bayesianposeestimation.jl_tpu_torch.utils.visualization import _plt, diss_defaults

    diss_defaults()
    exp_pro = Path(data_root, "exp_pro")
    drawers = [lambda n=name: draw_bop_run(n, data_root) for name in bop_runs(data_root)]
    drawers += [lambda n=name: draw_recall_vs_budget(n, data_root) for name in BUDGET_SWEEPS
                if (exp_pro / f"{name}_cuda" / "recall_vs_budget.csv").exists()]
    if (exp_pro / "mcmc_benchmark_cuda" / "recall_vs_time.csv").exists():
        drawers.append(lambda: draw_mcmc_benchmark(data_root))
    if (exp_pro / "smc_mh_resolution_cuda" / "resolution_recall.csv").exists():
        drawers.append(lambda: draw_resolution(data_root))
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    figs = {}
    for draw in drawers:
        for stem, fig in draw().items():
            fig.savefig(Path(out_dir) / f"{stem}.pdf")
            _plt().close(fig)
            figs[stem] = fig
    print(f"wrote {len(figs)} figures to {out_dir}")
    return figs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--out-dir", default="plots/cuda")
    args = ap.parse_args(argv)
    return draw_all(args.data_root, args.out_dir)


if __name__ == "__main__":
    main()
