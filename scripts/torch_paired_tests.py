"""Port-versus-JAX paired test on a BOP val sweep (exact McNemar test).

    python scripts/torch_paired_tests.py data/exp_pro/smc_bop_cad_jaxsteps_cuda \
        data/exp_pro/smc_bop_cad [--sampler smc_mh] [--scenes 1 2 3 4]

The first directory holds the port's per-gt errors (``errors/*.npz`` as
``scripts/torch_smc_bop_val.py`` writes them), the second the JAX package's
(``scripts/smc_bop_val.py``). Both evaluated the same gt instances of each
scene in the same order, so the per-gt outcomes (ADD-S < 0.1 of the
diameter, VSD < 0.3) are paired: the gts only one side gets right carry all
the information about a difference, and an exact two-sided binomial test on
them (``scripts/paired_tests.py``'s test, between the two packages instead of
between samplers) says whether it is chance. Prints one line per metric and
writes them to ``paired_vs_jax.csv`` in the port's directory, where the rows
of other samplers stay. Reads files only: no
device, and nothing of the JAX package.

``--by-config`` pairs the two directories' error files of the same name (one
config of an experiment sweep each, e.g. ``data/exp_pro/smc_benchmark_cuda``
against ``data/exp_pro/smc_benchmark``) and writes one row per config and
metric to ``paired_vs_jax_by_config.csv``: both recalls with their Wilson
intervals, both runs' steps per budget (``n_steps`` of the estimate
artifacts under exp_raw/), the discordant gts, the exact McNemar p and
whether it is significant at α = 0.05 after Bonferroni over the configs.
``--reevaluated FILE`` takes the JAX errors of the artifacts whose
checked-in errors are stale from that file (``scripts/reevaluate_errors.py``
keys them "<experiment>/<file>").
"""

from __future__ import annotations

import argparse
import csv
import math
import re
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bayesianposeestimation.jl_tpu_torch.utils import evaluation as ev  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils.artifacts import load_artifact  # noqa: E402


def binom_two_sided(k, n):
    """Exact two-sided binomial p-value of k successes in n at p = 0.5 (the
    minlike method of scipy.stats.binomtest)."""
    if n == 0:
        return 1.0
    pmf = [math.comb(n, i) * 0.5**n for i in range(n + 1)]
    thresh = pmf[k] * (1 + 1e-12)
    return min(1.0, sum(p for p in pmf if p <= thresh))


def scene_errors(exp_dir, sampler):
    """{scene_id: errors} of one sampler in an experiment's errors/."""
    out = {}
    for f in Path(exp_dir).glob(f"errors/*sampler={sampler},*.npz"):
        out[int(re.search(r"scene_id=(\d+)", f.name).group(1))] = load_artifact(f)
    return out


def paired(port, jax, scenes):
    """Per metric: (port recall, JAX recall, gts only the port gets right,
    gts only JAX gets right, exact McNemar p, n)."""
    rows = []
    for metric, theta in (("adds", ev.ADDS_THETA), ("vsd", ev.BOP18_THETA)):
        a = np.concatenate([np.asarray(port[s][metric]) < theta for s in scenes])
        b = np.concatenate([np.asarray(jax[s][metric]) < theta for s in scenes])
        only_port, only_jax = int(np.sum(a & ~b)), int(np.sum(~a & b))
        rows.append(dict(metric=metric, n_gt=a.size, port_recall=float(a.mean()),
                         jax_recall=float(b.mean()), only_port=only_port, only_jax=only_jax,
                         p_value=binom_two_sided(min(only_port, only_jax),
                                                 only_port + only_jax)))
    return rows


def by_config(port_dir, jax_dir, reevaluated=None, alpha=0.05):
    """One row per config (error file in both directories) and metric."""
    names = sorted({f.name for f in Path(port_dir).glob("errors/*.npz")}
                   & {f.name for f in Path(jax_dir).glob("errors/*.npz")})
    stale = np.load(reevaluated) if reevaluated else None
    rows = []
    for name in names:
        port = load_artifact(Path(port_dir) / "errors" / name)
        key = f"{Path(jax_dir).name}/{name}"
        if stale is not None and f"{key}/vsd" in stale.files:
            jax = {k: stale[f"{key}/{k}"] for k in ("adds", "vsd")}
        else:
            jax = load_artifact(Path(jax_dir) / "errors" / name)
        steps = [int(load_artifact(Path(str(d).replace("exp_pro", "exp_raw")) / name)["n_steps"])
                 for d in (port_dir, jax_dir)]
        for r in paired({1: port}, {1: jax}, [1]):
            n = r["n_gt"]
            port_ci = ev.recall_ci(round(r["port_recall"] * n), n)
            jax_ci = ev.recall_ci(round(r["jax_recall"] * n), n)
            rows.append(dict(config=name[:-len(".npz")], **r, port_ci_lo=port_ci[0],
                             port_ci_hi=port_ci[1], jax_ci_lo=jax_ci[0], jax_ci_hi=jax_ci[1],
                             port_n_steps=steps[0], jax_n_steps=steps[1],
                             reevaluated=stale is not None and key + "/vsd" in stale.files))
    for r in rows:
        r["significant_bonferroni"] = r["p_value"] < alpha / max(len(names), 1)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("port_dir")
    ap.add_argument("jax_dir")
    ap.add_argument("--sampler", default="smc_mh")
    ap.add_argument("--scenes", type=int, nargs="+", default=None,
                    help="default: every scene both directories hold")
    ap.add_argument("--by-config", action="store_true",
                    help="pair the error files of the same config name")
    ap.add_argument("--reevaluated", default=None,
                    help="JAX errors of today for artifacts whose checked-in errors are stale")
    args = ap.parse_args()
    if args.by_config:
        rows = by_config(args.port_dir, args.jax_dir, args.reevaluated)
        if not rows:
            raise SystemExit("no error files in common")
        for r in rows:
            print(f"{r['config']} {r['metric']}: port {r['port_recall']:.4f} "
                  f"[{r['port_ci_lo']:.3f}, {r['port_ci_hi']:.3f}] at {r['port_n_steps']} steps, "
                  f"JAX {r['jax_recall']:.4f} [{r['jax_ci_lo']:.3f}, {r['jax_ci_hi']:.3f}] at "
                  f"{r['jax_n_steps']} steps; only the port right {r['only_port']}, only JAX "
                  f"right {r['only_jax']}; exact McNemar p {r['p_value']:.4f}"
                  f"{' SIGNIFICANT after Bonferroni' if r['significant_bonferroni'] else ''}")
        out = Path(args.port_dir) / "paired_vs_jax_by_config.csv"
        with open(out, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
        print(f"wrote {out}")
        return
    port, jax = scene_errors(args.port_dir, args.sampler), scene_errors(args.jax_dir, args.sampler)
    scenes = sorted(args.scenes or set(port) & set(jax))
    missing = [s for s in scenes if s not in port or s not in jax]
    if not scenes or missing:
        raise SystemExit(f"no errors for scenes {missing or 'in common'}")
    for s in scenes:
        if not np.array_equal(port[s]["visib"], jax[s]["visib"]):
            raise SystemExit(f"scene {s}: the two evaluations hold different gts")
    rows = paired(port, jax, scenes)
    for r in rows:
        print(f"{args.sampler} {r['metric']} over {r['n_gt']} gts of scenes {scenes}: port "
              f"{r['port_recall']:.4f}, JAX {r['jax_recall']:.4f}; only the port right "
              f"{r['only_port']}, only JAX right {r['only_jax']}; exact McNemar p "
              f"{r['p_value']:.4f}")
    out = Path(args.port_dir) / "paired_vs_jax.csv"
    kept = []
    if out.exists():
        with open(out, newline="") as fh:
            kept = [r for r in csv.DictReader(fh) if r["sampler"] != args.sampler]
    with open(out, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=["sampler", *rows[0]])
        writer.writeheader()
        writer.writerows(kept + [{"sampler": args.sampler, **r} for r in rows])
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
