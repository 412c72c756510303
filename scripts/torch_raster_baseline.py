#!/usr/bin/env python3
"""Time the render+score kernel, the flagship chain and the trackers of this
tree against another checkout of the repository, in turns on one card.

    git archive <commit> | tar -x -C _checkout/parent     (leave data/ out)
    python3 scripts/torch_raster_baseline.py _checkout/parent           # kernels
    python3 scripts/torch_raster_baseline.py --paths _checkout/parent   # end to end

Two calls may land on two cards and host time differs by half between
machines, so two versions are only comparable inside one run. Both modes go
through the checkouts in the order other, this, this, other, each step in a
process of its own, started in that checkout, which builds its own kernel.

The first mode launches ``render_score`` / ``render_depth`` through each
checkout's own wrapper at the shapes the main paths use (bench shape:
1280-face monkey, 30x30, 100 poses; tracking shape: 256-face mesh, 80x60, 600
and 1250 poses; inputs from that checkout's ``chip_smoke.kernel_inputs`` and
``tracking_kernel_inputs``, which both must have) and prints one JSON line per
row: milliseconds per launch by CUDA events over 200 calls through Python
(paced by the host where the kernel is shorter than a call) and by the
profiler's device time. ``--paths`` runs ``chip_profile.py`` (the flagship
chain) and ``chip_profile.py tracking`` (both particle filters) in each and
prints per run the wall time of the unprofiled run, hypotheses or frames per
second, the device's busy time and idle share and the CUDA kernels per step
or frame. Needs a CUDA device.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ROWS = (("render_score[association] bench shape, 100 poses", "bench", "association", False),
        ("render_score[fixed_o] tracking shape, 600 poses", "track", "simple", False),
        ("render_score[fixed_o] tracking shape, 1250 poses", "track_big", "simple", False),
        ("render_score[fixed_o+mu] tracking shape, 600 poses", "track", "simple", True),
        ("render_depth tracking shape, 600 poses", "track", None, True),
        ("render_score[fixed_o] bench shape", "bench", "simple", False),
        ("render_score[smooth_association] bench shape", "bench", "smooth", False),
        ("render_score[uniform_fixed_o] bench shape", "bench", "no_exp", False),
        ("render_score[uniform_association] bench shape", "bench", "no_exp_association", False),
        ("render_score[fixed_o+mu] bench shape", "bench", "simple", True),
        ("render_depth bench shape", "bench", None, True))
PATH_KEYS = ("filter", "hypotheses_per_s", "fps", "wall_s", "device_busy_s",
             "device_idle_share_unprofiled", "cuda_kernels_per_step", "cuda_kernels_per_frame",
             "render_score_kernel_s", "render_score_kernel_share_of_busy")


def time_rows():
    """The rows' times in the checkout this process was started in: one
    ``{"row": ..., "events_ms": ..., "device_ms": ...}`` line each."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    import torch
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_depth, render_score

    dev = "cuda"
    inputs = {"bench": chip_smoke.kernel_inputs(dev, 30, 30, "monkey"),
              "track": chip_smoke.tracking_kernel_inputs(dev),
              "track_big": chip_smoke.tracking_kernel_inputs(dev, n_poses=1250)}
    for name, shape, variant, mu in ROWS:
        args = inputs[shape]
        if variant is None:
            def run(args=args):
                return render_depth(*args[:5], device=dev)
        else:
            def run(args=args, variant=variant, mu=mu):
                return render_score(*args, variant=variant, device=dev, return_mu=mu)
        print(json.dumps({"row": name,
                          "events_ms": chip_smoke.time_ms(run, 200, torch.cuda.synchronize),
                          "device_ms": chip_smoke.device_ms(run, 50)}), flush=True)
    return 0


def compare(other, paths):
    """Each step in ``other`` and in this tree in turns; the steps' JSON
    lines, tagged with their side, as they come."""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    steps = ((["chip_profile.py"], '{"card"'), (["chip_profile.py", "tracking"], '{"card"')) \
        if paths else (([str(Path(__file__).resolve()), "--rows"], '{"row"'),)
    ok = True
    for side, root in (("other", other), ("this", REPO), ("this", REPO), ("other", other)):
        for command, prefix in steps:
            proc = subprocess.run([sys.executable, *command], cwd=root, capture_output=True,
                                  text=True, check=False, timeout=900)
            if proc.returncode != 0:
                print(f"{side}: {' '.join(command)} failed:\n{proc.stderr[-2000:]}",
                      file=sys.stderr)
                ok = False
            for line in proc.stdout.splitlines():
                if line.startswith(prefix):
                    d = json.loads(line)
                    kept = {k: d[k] for k in PATH_KEYS if k in d} if paths else d
                    print(json.dumps({"side": side, "card": card, **kept}), flush=True)
    return 0 if ok else 1


def main():
    import torch

    args = sys.argv[1:]
    if not torch.cuda.is_available() or not args:
        print(__doc__, file=sys.stderr)
        return 2
    if args == ["--rows"]:
        return time_rows()
    paths = args[0] == "--paths"
    if len(args) != 1 + paths:
        print(__doc__, file=sys.stderr)
        return 2
    return compare(Path(args[-1]).resolve(), paths)


if __name__ == "__main__":
    sys.exit(main())
