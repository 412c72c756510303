"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s``): the cell's traffic and meshes are loaded,
the port builds what it builds, and one request of every shape the traffic
uses is served (the captures). Then one client serves requests back to back
for ``--seconds`` (a closed loop). With ``--trace 1`` a few requests named
in the cell file are profiled. After the window the peak device memory is
read, the port's state freed, and a sample of the window's requests drawn
from the seed is held against the plain reference (``reference/``). The last
line of standard output is one JSON object; the numbers compared are the
last lines of standard error. Without a CUDA device (or with fewer than the
cell asks for) the run fails and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "4")
REPO = Path(__file__).resolve().parents[1]
# build and kernel caches of anything the run compiles (the port builds into its
# own _build/; a Triton or extension build a later port adds lands here): fixed
# paths inside the checkout, so only the first run of a cell there compiles
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(REPO / ".cache" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(REPO / ".cache" / "triton"))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(REPO))


def _number(x):
    """``x`` as JSON takes it: an infinite or undefined reading as 1e300."""
    x = float(x)
    return x if math.isfinite(x) else 1e300


def card_line():
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=False).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out[0] if out else "not read"


def _summary(kind, entry, sl, counted, prep_s, request_wall_s):
    """The traced slice's numbers, with the roofline bound per launch and the
    mean wall of the traced requests' untraced twins."""
    from portbench import roofline, trace
    from portbench.reference.raster import camera_scalars

    units = entry.units_per_request() * len(entry.traced)
    s = trace.summarize(sl, units, counted)
    s.update(requests_traced=len(entry.traced), units_per_request=entry.units_per_request(),
             request_wall_s=request_wall_s)
    total, ops, n_pops = 0.0, 0, 0
    for (verts, faces), cam_f, ts, rs, epilogue in entry.roofline_inputs():
        cam = camera_scalars(cam_f["f_x"], cam_f["f_y"], cam_f["c_x"], cam_f["c_y"], cam_f["s"],
                             cam_f["width"], cam_f["height"], cam_f["near"], cam_f["far"])
        b, o = roofline.populations_work(verts, faces, cam, ts, rs, epilogue)
        total, ops, n_pops = total + b, ops + o, n_pops + ts.shape[0]
    s.update(kind=kind, prep_s=prep_s, peak_flops=roofline.PEAK_FP32_FLOPS,
             bound_per_launch_s=total / n_pops if n_pops else None,
             ops_per_unit=ops / n_pops * entry.launches_per_unit() if n_pops else None)
    return s


def run_cell(cell, config, seed, seconds, trace_on, device="cuda", t_start=None):
    """Set up, serve the window, check: (result dict, the check's lines for
    standard error, the JAX modules found loaded)."""
    import torch

    from portbench import cells, imports
    from portbench import trace as tr
    from portbench.reference import check

    t_start = time.perf_counter() if t_start is None else t_start
    mod = cells.entry_module(config)
    entry = mod.Entry(cell, config, seed, device)
    entry.setup()
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_score

    requests = []

    def serve(i, traced=False):
        s = time.perf_counter()
        try:
            n, ok = entry.run(i, traced=traced)
        except Exception:  # a request that raises is a failed request
            traceback.print_exc(limit=5)
            n, ok = 0, False
        requests.append((s, time.perf_counter(), n, ok))

    tplan = cell["trace"]
    i, tries, sl, counted, prep_skip, twin_walls = 0, 0, None, None, set(), []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if not (trace_on and sl is None and i >= tplan["skip"] and tries < tplan["tries"]):
            serve(i)
            i += 1
            continue
        # the traced slice: a few requests under the profiler, each served
        # untraced just before (the same item and seed, so the same device
        # work): the profiler slows the host, so the twin's wall is the wall
        n = tplan["requests"]
        for k in range(i, i + n):
            serve(k)
        twins = [e - s for s, e, _, ok in requests[-n:] if ok]
        entry.traced.clear()
        before = render_score.launches
        n_prep = len(entry.spans.seconds.get("prep", []))
        entry.spans.profiled = True
        with tr.Slice() as one, torch.profiler.record_function("portbench.slice"):
            for k in range(i, i + n):
                serve(k, traced=True)
        i += n
        entry.spans.profiled = False
        prep_skip.update(range(n_prep, len(entry.spans.seconds.get("prep", []))))
        tries += 1
        got, want = one.raster_launches(), render_score.launches - before
        if got >= want or tries == tplan["tries"]:
            sl, counted, twin_walls = one, want, twins
        else:
            print(f"portbench: traced slice {tries} recorded {got} of {want} render_score "
                  f"launches; taken again", file=sys.stderr)
    failed = sum(not ok for *_, ok in requests)
    window = {"requests": requests, "t0": t0, "setup_s": setup_s}
    lat = sorted(e - s for s, e, _, _ in requests)
    if lat:
        print(f"portbench: window {time.perf_counter() - t0:.3f} s, {len(lat)} requests, "
              f"latency ms min {1e3 * lat[0]:.2f} median {1e3 * lat[len(lat) // 2]:.2f} "
              f"max {1e3 * lat[-1]:.2f}; set-up {setup_s:.3f} s", file=sys.stderr)

    dev_info = {"platform": "gpu" if device != "cpu" else "cpu",
                "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
                if device != "cpu" else 0,
                "power_limit": card_line() if device != "cpu" else "cpu"}
    result = {"correct": False, "attempted": len(requests), "failed": failed, "metrics": {},
              "device": dev_info}
    if trace_on:
        if sl is None:
            print("portbench: the window ended before the traced slice", file=sys.stderr)
        else:
            prep_s = [v for k, v in enumerate(entry.spans.seconds.get("prep", []))
                      if k not in prep_skip]
            summary = _summary(mod.KIND, entry, sl, counted, prep_s,
                               sum(twin_walls) / len(twin_walls) if twin_walls else None)
            for m, read in cells.readers("per_layer", cell["name"]):
                v = read(summary)
                if v is not None:
                    result["metrics"][m["name"]] = {"value": _number(v), "unit": m["unit"]}
            dev_info["busy_s"] = summary["busy_s"]
            dev_info["window_s"] = summary["wall_s"]
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
    else:
        for m, read in cells.readers("end_to_end", cell["name"]):
            v = read(window)
            if v is not None:
                result["metrics"][m["name"]] = {"value": _number(v), "unit": m["unit"]}

    # the check: after the window, with the port's state freed
    records, meshes, cfg = entry.records(), entry.meshes(), entry.check_config()
    entry.free()
    if device != "cpu":
        torch.cuda.empty_cache()
    numbers = check.judge(entry.check_kind, records, meshes, cfg, device)["program"]
    limits = cell["check"]["limits"]
    within = all(numbers[k] <= limits[k] for k in limits)
    result["correct"] = bool(within and records and not failed)
    result["checks"] = {k: {"value": _number(numbers[k]), "limit": limits[k]} for k in limits}
    result["checks"]["failed_requests"] = {"value": failed, "limit": 0}
    result["checks"]["requests_checked_at_least"] = {"value": len(records), "limit": 1}
    lines = [f"check {k}: {numbers[k]!r} (limit {limits[k]!r})" for k in limits]
    lines.append(f"check failed_requests: {failed} (limit 0)")
    lines.append(f"check requests_checked_at_least: {len(records)} (limit 1)")
    found = imports.forbidden(sys.modules)
    return result, lines, found


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import cells

    cell, config = cells.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    try:
        import bayesianposeestimation.jl_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"portbench: the port is not importable here: {exc}", file=sys.stderr)
        return 3
    seed = args.seed % 2**63
    result, lines, found = run_cell(cell, config, seed, args.seconds, bool(args.trace), "cuda",
                                    T_START)
    if found:
        print(f"portbench: JAX modules were loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    checks = result.pop("checks")
    result["checks"] = checks  # the numbers compared come last
    print(json.dumps(result, allow_nan=False))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
