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


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("port_dir")
    ap.add_argument("jax_dir")
    ap.add_argument("--sampler", default="smc_mh")
    ap.add_argument("--scenes", type=int, nargs="+", default=None,
                    help="default: every scene both directories hold")
    args = ap.parse_args()
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
