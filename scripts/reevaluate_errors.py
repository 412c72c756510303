"""Re-evaluate checked-in estimates with the JAX package's current
``evaluate_scene`` and keep those whose checked-in errors it does not
reproduce.

Some experiments' errors under data/exp_pro/<name>/errors/ were computed by
an earlier version of the evaluation (or, where a sweep re-ran its
inference, belong to earlier estimates), so they are no reference for
another implementation of today's evaluation. This script evaluates each
estimate artifact of data/exp_raw/<name>/ again, compares with the
checked-in errors (ADD-S within 1e-5 relative, VSD and VSDBOP within 0.005,
equal visibilities where stored) and writes every artifact that disagrees,
with today's errors, into one .npz keyed "<name>/<artifact file>".

    python scripts/reevaluate_errors.py smc_priors smc_observation \\
        --out tests/fixtures/reevaluated_errors.npz
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

ADDS_REL_TOL = 1e-5
VSD_ABS_TOL = 0.005


def differences(ours, ref):
    """The largest difference of ``ours`` from the checked-in errors ``ref``
    per key (ADD-S relative; inf where visibilities, shapes or unmatched gts
    differ) and whether every one is within its gate."""
    gaps = {}
    if "visib" in ref and not np.array_equal(np.asarray(ours["visib"]), ref["visib"]):
        gaps["visib"] = np.inf
    for key, rel in (("adds", True), ("vsd", False), ("vsdbop", False)):
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        if a.shape != b.shape or not np.array_equal(np.isinf(a), np.isinf(b)):
            gaps[key] = np.inf
            continue
        fin = np.isfinite(b)
        d = np.abs(a - b)[fin]
        if rel:
            d = d / np.maximum(np.abs(b[fin]), 1e-30)
        gaps[key] = float(d.max(initial=0.0))
    ok = (gaps.get("visib", 0.0) == 0.0 and gaps["adds"] <= ADDS_REL_TOL
          and max(gaps["vsd"], gaps["vsdbop"]) <= VSD_ABS_TOL)
    return gaps, ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("experiments", nargs="+")
    ap.add_argument("--bop-dir", default="data/bop")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import smc_bop_val
    from bayesianposeestimation.jl_tpu.parameters import Parameters
    from bayesianposeestimation.jl_tpu.utils.artifacts import load_artifact

    kept = {}
    for name in args.experiments:
        for raw_path in sorted(Path("data/exp_raw", name).glob("*.npz")):
            raw = load_artifact(raw_path)
            ref = load_artifact(Path("data/exp_pro", name, "errors", raw_path.name))
            ours = smc_bop_val.evaluate_scene(raw["__config__"], args.bop_dir, Parameters(),
                                              list(raw["result_rows"]))
            gaps, same = differences(ours, ref)
            print(f"{name}/{raw_path.name}: {'reproduced' if same else 'NOT reproduced'} "
                  f"(max |d|: {', '.join(f'{k} {v:.3g}' for k, v in gaps.items())})")
            if not same:
                for key in ("adds", "vsd", "vsdbop", "visib"):
                    kept[f"{name}/{raw_path.name}/{key}"] = np.asarray(ours[key])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **kept)
    print(f"wrote {len(kept) // 4} artifacts to {args.out}")


if __name__ == "__main__":
    main()
