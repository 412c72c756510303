"""Readings for the limits of ``correct``: for each seed, a short window of
the cell at its own size (as many requests as a run checks, drawn the same
way), then the check's numbers of the port and of the control (the
reference in bfloat16 put in the port's place), both against the reference.
Not part of a benchmark run.

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 13 ... [--control-seeds 3]

Prints one JSON line per seed and a summary: the largest reading of the port
(the lower reading) and the smallest of the control (the upper reading) for
each number."""

import argparse
import json
import math
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def window(cell, config, seed, device, seconds):
    """A short window of the cell from ``seed``: (check kind, records, meshes,
    the configuration as the reference reads it, requests served)."""
    from portbench import cells

    entry = cells.entry_module(config).Entry(cell, config, seed, device)
    entry.setup()
    t0, i = time.perf_counter(), 0
    while i < entry.check.k or time.perf_counter() - t0 < seconds:
        entry.run(i)
        i += 1
    out = (entry.check_kind, entry.records(), entry.meshes(), entry.check_config(), i)
    entry.free()
    return out


def readings(cell, config, seed, device, control, seconds):
    from portbench.reference import check

    kind, records, meshes, cfg, served = window(cell, config, seed, device, seconds)
    t0 = time.perf_counter()
    out = check.judge(kind, records, meshes, cfg, device, control=control)
    out.update(seed=seed, requests=served, checked=len(records),
               check_s=time.perf_counter() - t0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="the first this many seeds also read the control")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from portbench import cells

    cell, config = cells.load(args.workload)
    lines = []
    for k, seed in enumerate(args.seeds):
        r = readings(cell, config, seed, args.device, k < args.control_seeds, args.seconds)
        lines.append(r)
        print(json.dumps(r), flush=True)
    names = list(lines[0]["program"])
    summary = {"lower": {n: max(r["program"][n] for r in lines) for n in names},
               "upper": {n: min((r["control"][n] for r in lines if r["control"]),
                                default=math.nan) for n in names}}
    print(json.dumps({"summary": summary}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in lines)
                                  + json.dumps({"summary": summary}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
