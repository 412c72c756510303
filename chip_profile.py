#!/usr/bin/env python3
"""Where the time goes on the card (PyTorch/CUDA port).

    python3 chip_profile.py            # the benchmark chain
    python3 chip_profile.py tracking   # the particle filters
    python3 chip_profile.py kernels    # both of the above, then the kernel alone
    python3 chip_profile.py evaluation # the BOP evaluation with and without the depth split
    python3 chip_profile.py telemetry <cell> <seed> [seconds]  # a benchmark cell, telemetry on

The benchmark chain is bench.py's configuration through the port
(bench_torch.run_chain: monkey mesh, 30x30, 100 particles, tempered SMC-MH,
association posterior); ``tracking`` is scripts/torch_ros_particle_filter.py's
configuration (80x60, 256-face mesh, 120-frame synthetic stream; coordinate
filter with 600 particles, bootstrap filter with 1250). Each runs eager
(``captured=False``) and captured (its steps replayed from CUDA graphs), each
once unprofiled for the wall time (after a warm-up run, which captures),
then once under torch.profiler, and reports: device busy time (sum of CUDA
kernel durations; one stream, so kernels do not overlap), the device's idle
share of the profiled and of the unprofiled wall time, CUDA kernels and the
host's launch calls (kernels, graphs, copies, fills) per step (per frame for
the filters), the render_score kernel's share of the busy time and its
device time per launch in the chain, and device time by kernel name.

``kernels`` times ``csrc/render_score.cu`` alone at the shapes those paths
give it (bench shape: 1280-face monkey, 30x30, 100 poses; tracking shape:
256-face mesh, 80x60, 600 and 1250 poses; ``render_depth`` also at the BOP
evaluation's shape, 81,920 faces, 3 poses, 100x100, every face drawn, and at
the bench shape, each with its automatic face slices and with one block per
pose): each row is first held against its
plain version, then timed with CUDA events and the profiler beside its bound
(chip_smoke.bound_ms), the share of the bound it reaches and, from a build
with in-kernel phase clocks (no kernel profiler runs on a sealed machine),
the share of its blocks' cycles in each phase; the rows the paths launch
most are also timed with the background-score kernel forced off and on (in
the order off, on, on, off: what the wrapper's threshold rests on). A row at
the shape of the cell ``synthcad_smc_mh.res100_p1000`` (20,000 faces,
100x100, 1,000 poses) times the plan ``render_score`` picks there (several
pose blocks an SM) beside one block an SM, each with its blocks per SM held
to the runtime's count (``res100_row``). It runs the chain and the tracking
profiles first, and last replays each row from a CUDA graph of 50 launches:
the time per launch once the host's pacing (the Python wrapper, ~0.07-0.1 ms
a call) is out of the way. Between the two, ``render_depth``'s face slices
are swept
(device time for forced slice counts beside the automatic plan's, its phase
clocks, and how evenly its slices share the raster's big boxes).
The SMC population update kernel's rows are phase 19 of ``chip_smoke.py``.
``telemetry`` runs one cell of the benchmark (``portbench/``) as its
untraced runs do, with the port's telemetry on from before the set-up to the
end of the window, and prints the cell's end-to-end metrics beside the host
loop's split: µs a step outside and inside the graph replay call, the parts
of a step, the mean spans of a request, the set-up's captures, a tracker's
runs, frames and scored poses (``parity_cases.telemetry_cell``); it stands in
until the benchmark's own readers compute these numbers, and goes then. Needs
a CUDA device.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent


def profiled(fn):
    """Run ``fn`` under torch.profiler: (wall s, device busy s, CUDA kernel
    count, top kernels by device time, and the render_score kernel's time,
    launches and share of the busy time with the host's launch calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from portbench.trace import HOST_LAUNCH_CALLS

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = collections.defaultdict(lambda: [0.0, 0])
    host = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a named range's shadow on the device's timeline (the port's
            # ``bpe.`` spans and step phases) is no kernel and no busy time
            if getattr(e, "is_user_annotation", False) or e.name.startswith("bpe."):
                continue
            by_name[e.name][0] += e.time_range.elapsed_us()
            by_name[e.name][1] += 1
        elif e.name in HOST_LAUNCH_CALLS:
            host[e.name] += 1
    busy_s = sum(v[0] for v in by_name.values()) * 1e-6

    raster = [v for k, v in by_name.items() if chip_smoke.is_raster_kernel(k)]
    raster_s = sum(v[0] for v in raster) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return wall, busy_s, sum(v[1] for v in by_name.values()), [
        {"name": k[:90], "us": v[0], "count": v[1]} for k, v in top], {
        "render_score_kernel_s": raster_s,
        "render_score_kernel_launches": sum(v[1] for k, v in by_name.items()
                                            if "render_score_kernel" in k),
        "render_score_kernel_share_of_busy": raster_s / busy_s if busy_s else None,
        "host_launch_calls": dict(host)}


def report(result, wall, prof_wall, busy_s, n_kernels, n_units, unit, top, raster):
    result.update(raster)
    result[f"host_launches_per_{unit}"] = sum(raster["host_launch_calls"].values()) / n_units
    if raster["render_score_kernel_launches"]:
        result["render_score_kernel_ms_per_launch"] = (
            raster["render_score_kernel_s"] * 1e3 / raster["render_score_kernel_launches"])
    result.update({
        "wall_s": wall, "profiled_wall_s": prof_wall, "device_busy_s": busy_s,
        "device_idle_share_profiled": 1.0 - busy_s / prof_wall if busy_s else None,
        "device_idle_share_unprofiled": 1.0 - busy_s / wall if busy_s else None,
        "cuda_kernels": n_kernels, f"cuda_kernels_per_{unit}": n_kernels / n_units,
        "top_kernels_us": top})
    print(json.dumps(result))
    for row in top:
        print(f"  {row['us']:12.1f} us  {row['count']:6d}x  {row['name']}")


def profile_chain(card):
    """The flagship chain eager (``captured=False``) and captured: the
    captured chain through ``bench_torch.run_chain`` (its steps replayed from
    CUDA graphs), the eager one timed the same way, each then profiled."""
    import torch
    from bench_torch import run_chain

    from bayesianposeestimation.jl_tpu_torch.models.experiment_samplers import smc_mh
    from bayesianposeestimation.jl_tpu_torch.samplers import sample_chain

    n_steps, n_particles = 500, 100
    _, _, post, walls, evals, launches, _ = run_chain("cuda", n_steps, n_particles)
    sampler = smc_mh(post.params, post)
    for captured in (False, True):
        def run(seed, captured=captured):
            return sample_chain(seed, post, sampler, n_steps, n_particles, device="cuda",
                                captured=captured)

        if captured:
            wall = walls[-1]
        else:
            run(2)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        run(3)  # the captured chain's runner is the sampler's own: capture it first
        prof_wall, busy_s, n_kernels, top, raster = profiled(lambda: run(3))
        report({"card": card, "captured": captured, "n_steps": n_steps,
                "n_particles": n_particles, "hypotheses_per_s": n_steps * n_particles / wall,
                "render_score_launches": launches[-1], "likelihood_evaluations": evals[-1]},
               wall, prof_wall, busy_s, n_kernels, n_steps, "step", top, raster)


def profile_tracking(card, n_frames=120, width=80, height=60):
    import torch

    sys.path.insert(0, str(REPO / "scripts"))
    import torch_ros_particle_filter as track

    from bayesianposeestimation.jl_tpu_torch.models.particle_filter import (
        bootstrap_pf,
        coordinate_pf,
        fused_pf_posterior,
    )

    stream, mesh = track.synthetic_stream(n_frames, width, height, device="cuda")
    posterior_fn = fused_pf_posterior("simple")
    for kind, pf in (("coordinate", coordinate_pf), ("bootstrap", bootstrap_pf)):
        params = track.filter_params(kind, width, height)
        experiment, depth, _ = track.tracking_setup(stream, mesh, params, "cuda")

        for captured in (False, True):
            def run(seed=0, captured=captured):
                return pf(seed, posterior_fn, params, experiment, depth, device="cuda",
                          captured=captured)

            run(1)  # warm-up (the capture)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof_wall, busy_s, n_kernels, top, raster = profiled(run)
            report({"card": card, "filter": kind, "captured": captured,
                    "n_particles": params.n_particles, "frames": n_frames - 1,
                    "fps": (n_frames - 1) / wall},
                   wall, prof_wall, busy_s, n_kernels, n_frames - 1, "frame", top, raster)


PHASES = ("vertices", "faces", "raster", "epilogue")


def phase_shares(fn, n=20):
    """Where the kernel's blocks spend their cycles: ``fn`` run ``n`` times on
    the library built with phase clocks, the share of each phase in the sum
    of the blocks' cycles, and the mean cycles per block and launch."""
    import ctypes

    import torch

    from bayesianposeestimation.jl_tpu_torch.ops import cuda_raster

    lib, _ = cuda_raster.build_library(phase_clocks=True)
    plain = cuda_raster.build_library
    clocks = (ctypes.c_ulonglong * len(PHASES))()
    cuda_raster.build_library = lambda: (lib, "")  # the wrappers' launches go to this build
    try:
        fn()
        torch.cuda.synchronize()
        assert lib.bpe_phase_clocks(clocks, 1) == 0
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        assert lib.bpe_phase_clocks(clocks, 1) == 0
    finally:
        cuda_raster.build_library = plain
    total = sum(clocks) or 1
    return {"share": {p: round(c / total, 4) for p, c in zip(PHASES, clocks)},
            "block_cycles_per_launch": total / n}


def kernel_rows(card, graphs=False):
    """The kernel alone at the main paths' shapes: checked against the plain
    version, then its time beside the plain version's and its bound, and the
    most launched rows with and without the background-score kernel.
    ``graphs``: only the time per launch of each row replayed from a CUDA
    graph (no host pacing)."""
    import torch

    import chip_smoke
    from bayesianposeestimation.jl_tpu_torch.ops import cuda_raster
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
        SCORE_VARIANTS,
        launch_plan,
        render_depth,
        render_depth_reference,
        render_score,
        render_score_reference,
    )

    dev = "cuda"
    sync = torch.cuda.synchronize
    bench = chip_smoke.kernel_inputs(dev, 30, 30, "monkey")
    track = chip_smoke.tracking_kernel_inputs(dev)
    track_big = chip_smoke.tracking_kernel_inputs(dev, n_poses=1250)
    evaluation = chip_smoke.evaluation_depth_args(dev)
    one = {"face_slices": 1}
    drawn = {"backface_cull": False}
    # (name, inputs, score variant or None for render_depth, image, render_depth kwargs)
    rows = [("render_score[association] bench shape, 100 poses", bench, "association", False,
             None),
            ("render_score[fixed_o] tracking shape, 600 poses", track, "simple", False, None),
            ("render_score[fixed_o] tracking shape, 1250 poses", track_big, "simple", False,
             None),
            ("render_score[fixed_o+mu] tracking shape, 600 poses", track, "simple", True, None),
            ("render_depth tracking shape, 600 poses", track, None, True, {}),
            ("render_depth evaluation shape, 81920 faces, 3 poses", evaluation, None, True,
             drawn),
            ("render_depth evaluation shape, one block per pose", evaluation, None, True,
             {**drawn, "tuning": one}),
            ("render_depth bench shape, 100 poses", bench, None, True, {}),
            ("render_depth bench shape, one block per pose", bench, None, True,
             {"tuning": one}),
            *((f"render_score[{e}] bench shape, 100 poses", bench, v, False, None)
              for v, e in SCORE_VARIANTS.items()
              if v in ("simple", "smooth", "no_exp", "no_exp_association"))]
    ok = True
    for name, args, variant, mu, depth_kw in rows:
        verts, faces, cam, t = args[:4]
        if variant is None:
            plan = launch_plan(verts.shape[0], faces.shape[0], cam.height, cam.width,
                               t.shape[0], depth_only=True, **(depth_kw.get("tuning") or {}))

            def run(args=args, kw=depth_kw):
                return (render_depth(*args[:5], device=dev, **kw),)

            def plain(args=args, cull=depth_kw.get("backface_cull", True)):
                return (render_depth_reference(*args[:5], backface_cull=cull),)

            epilogue = "depth"
        else:
            plan = launch_plan(verts.shape[0], faces.shape[0], cam.height, cam.width,
                               t.shape[0])

            def run(args=args, variant=variant, mu=mu):
                return render_score(*args, variant=variant, device=dev, return_mu=mu)

            def plain(args=args, variant=variant, mu=mu):
                return render_score_reference(*args, variant=variant, return_mu=mu)

            epilogue = SCORE_VARIANTS[variant]
        if graphs:
            print(json.dumps({"row": name, "card": card,
                              "graph_ms_per_launch": chip_smoke.graph_ms(run)}))
            continue
        out, ref = run(), plain()
        sync()
        image_equal = bool(torch.equal(out[-1], ref[-1])) if mu else None
        sums_close = all(bool(torch.allclose(a, b, **chip_smoke.TOL))
                         for a, b in zip(out[:2], ref[:2])) if variant else None
        row = {"row": name, "card": card, "plan": plan, "image_bitwise_equal": image_equal,
               "sums_within_tolerance": sums_close}
        ok = ok and image_equal is not False and sums_close is not False
        b_ms, b_by, _, pairs = chip_smoke.bound_ms(args, epilogue, mu=mu and variant)
        ms = chip_smoke.time_ms(run, 200, sync)
        dev_ms = chip_smoke.device_ms(run, 50)
        row.update({"ms": ms, "device_ms": dev_ms, "plain_ms": chip_smoke.time_ms(plain, 3, sync),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "share_of_bound": b_ms / dev_ms if dev_ms else None,
                    "share_of_bound_paced": b_ms / ms, "live_pairs": pairs,
                    "phases": phase_shares(run)})
        print(json.dumps(row))
        if name in (rows[0][0], rows[1][0], rows[2][0]):
            threshold, times = cuda_raster._BACKGROUND_MIN, []
            try:
                for forced in (2**62, 0, 0, 2**62):  # off, on, on, off
                    cuda_raster._BACKGROUND_MIN = forced
                    times.append(chip_smoke.device_ms(run, 200))
            finally:
                cuda_raster._BACKGROUND_MIN = threshold
            print(json.dumps({"row": name, "card": card,
                              "device_ms_background_off_on_on_off": times}))
    return ok


def res100_row(card, n_poses=1000):
    """render_score at the shape of the cell ``synthcad_smc_mh.res100_p1000``
    (``chip_smoke.res100_kernel_inputs``: a frozen 20,000-face synthcad
    mesh, 100x100, association with a mask prior), with the plan
    ``render_score`` picks (``path`` "resident": chunks small enough that
    several pose blocks share an SM) beside one block an SM
    (``chip_smoke.res100_plans``). First phase 2's checks there
    (``chip_smoke.res100_check``: the resident chunks against the plain
    version at 8 poses, the plans bitwise equal, blocks an SM against the
    runtime's count); then, at ``n_poses``, both plans' device time a launch
    (profiler, eager), paced time (CUDA events), time from a CUDA graph, the
    bound and the share of it, ``blocks_per_sm`` beside the runtime's count,
    and the share of the blocks' cycles in each phase (a
    ``-DBPE_PHASE_CLOCKS`` build)."""
    import torch

    import chip_smoke
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_score

    dev, sync = "cuda", torch.cuda.synchronize
    failures = []
    check = chip_smoke.res100_check(dev, failures, n_poses)
    args = chip_smoke.res100_kernel_inputs(dev, n_poses)
    b_ms, b_by, _, pairs = chip_smoke.bound_ms(args, "association")
    timed = {}
    for name, (tuning, plan) in chip_smoke.res100_plans(args).items():

        def run(tuning=tuning):
            return render_score(*args, device=dev, tuning=tuning)

        dev_ms = chip_smoke.device_ms(run, 20)
        timed[name] = {"plan": plan, "runtime_blocks_per_sm": chip_smoke.occupancy(plan),
                       "device_ms": dev_ms, "ms": chip_smoke.time_ms(run, 20, sync),
                       "graph_ms": chip_smoke.graph_ms(run, n=20, reps=5),
                       "share_of_bound": b_ms / dev_ms if dev_ms else None,
                       "phases": phase_shares(run, n=5)}
    print(json.dumps({"row": f"render_score[association] res100 shape, {args[1].shape[0]} "
                             f"faces 100x100, {n_poses} poses, mask prior", "card": card,
                      "check": check, "failures": failures, "bound_ms": b_ms, "bound_by": b_by,
                      "live_pairs": pairs, **timed}))
    return not failures


def slice_box_load(args, backface_cull, slices):
    """How evenly ``slices`` face slices share the raster: per (pose,
    slice), the pixels of its boxes above 128 pixels (kBigBox: a sliver
    whose area is rounding noise gets the whole image, and the whole block
    walks such boxes), max and mean over the blocks, and the whole-image
    boxes in all."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
        triangle_boxes,
        triangle_forms,
    )

    verts, faces, cam, t, q = args[:5]
    valid, _ = triangle_forms(verts, faces, cam, t, q, backface_cull)
    c0, c1, r0, r1 = triangle_boxes(verts, faces, cam, t, q)
    area = (c1 - c0 + 1).clamp(min=0) * (r1 - r0 + 1).clamp(min=0) * valid
    per = -(-faces.shape[0] // slices)
    big = torch.nn.functional.pad(area * (area > 128), (0, per * slices - faces.shape[0]))
    load = big.reshape(t.shape[0], slices, per).sum(-1).float()
    return {"whole_image_boxes": int((area == cam.height * cam.width).sum()),
            "big_box_pixels_max_block": float(load.max()),
            "big_box_pixels_mean_block": float(load.mean()),
            "small_box_pixels": int((area * (area <= 128)).sum())}


def face_slice_sweep(card):
    """render_depth's device time per launch for forced face-slice counts
    (each image bitwise equal to the plain version), beside the automatic
    plan with its phase clocks and how evenly its slices share the raster:
    the evaluation's shape (81,920 faces, 3 poses), the 128,000-face model
    (3 poses), the bench shape (100 poses), the tracking stream's synthesis
    (1,280 faces, 120 and 24 poses at 80x60). What launch_plan's rule rests
    on."""
    import torch

    import chip_smoke
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
        launch_plan,
        render_depth,
        render_depth_reference,
    )

    dev = "cuda"
    cases = (("evaluation 81920 faces 3 poses 100x100", chip_smoke.evaluation_depth_args(dev),
              False, (1, 22, 44, 66, 88, 132, 176, 264)),
             ("128000 faces 3 poses 100x100", chip_smoke.large_model_depth_args(dev), False,
              (1, 44, 88, 132, 176, 264, 352, 528)),
             ("bench 1280 faces 100 poses 30x30",
              chip_smoke.kernel_inputs(dev, 30, 30, "monkey")[:5], True, (1, 2, 3, 5)),
             ("1280 faces 120 poses 80x60",
              chip_smoke.kernel_inputs(dev, 80, 60, "monkey", n_poses=120)[:5], True,
              (1, 2, 3, 5)),
             ("1280 faces 24 poses 80x60",
              chip_smoke.kernel_inputs(dev, 80, 60, "monkey", n_poses=24)[:5], True,
              (1, 3, 5, 11)))
    ok = True
    for label, args, cull, counts in cases:
        ref = render_depth_reference(*args, backface_cull=cull)
        auto = launch_plan(args[0].shape[0], args[1].shape[0], args[2].height, args[2].width,
                           args[3].shape[0], depth_only=True)
        by_slices = {}
        for s in counts:
            def run(s=s):
                return render_depth(*args, backface_cull=cull, device=dev,
                                    tuning={"face_slices": s})

            same = bool(torch.equal(run(), ref))
            ok = ok and same
            by_slices[s] = {"device_ms": chip_smoke.device_ms(run, 30),
                            "graph_ms": chip_smoke.graph_ms(run), "bitwise_equal": same}

        def run_auto():
            return render_depth(*args, backface_cull=cull, device=dev)

        print(json.dumps({"sweep": label, "card": card, "auto_face_slices": auto["face_slices"],
                          "auto_face_cap": auto["face_cap"],
                          "auto_device_ms": chip_smoke.device_ms(run_auto, 30),
                          "auto_graph_ms": chip_smoke.graph_ms(run_auto),
                          "by_face_slices": by_slices, "auto_phases": phase_shares(run_auto),
                          "auto_box_load": slice_box_load(args, cull, auto["face_slices"])}))
    return ok


def evaluation_turns(card):
    """chip_smoke.py phase 7a's evaluation of the 54 JAX estimate artifacts
    end to end (host clock around all of them, ending in a synchronize),
    with render_depth's automatic face slices and with one block per pose
    in turns (split, one, one, split, after a warm-up that fills the mesh
    and image cache): what the split moves end to end."""
    import torch

    import chip_smoke
    from bayesianposeestimation.jl_tpu_torch.ops import cuda_raster
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import load_artifact, savename
    from parity_cases import bop_val_script

    bopval = bop_val_script()
    params = Parameters(device="cuda")
    raws = [load_artifact(chip_smoke.JAX_RAW / (savename(dict(
        dataset="synthcad", sampler=s, scene_id=n, testset="val")) + ".npz"))
        for s in chip_smoke.BOP_SAMPLERS for n in chip_smoke.BOP_SCENES]
    cache = {}

    def evaluate():
        cuda_raster.render_depth.launches = 0
        t0 = time.perf_counter()
        for raw in raws:
            bopval.evaluate_scene(raw["__config__"], str(chip_smoke.BOP_DIR), params,
                                  list(raw["result_rows"]), "cuda", cache)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, cuda_raster.render_depth.launches

    split_below = cuda_raster._SPLIT_BELOW
    turns = []
    try:
        evaluate()  # warm-up: meshes and depth images into the cache
        for name, below in (("split", split_below), ("one block per pose", 0),
                            ("one block per pose", 0), ("split", split_below)):
            cuda_raster._SPLIT_BELOW = below
            cuda_raster._cached_plan_args.cache_clear()
            seconds, launches = evaluate()
            turns.append({"plan": name, "seconds": seconds, "render_depth_launches": launches})
    finally:
        cuda_raster._SPLIT_BELOW = split_below
        cuda_raster._cached_plan_args.cache_clear()
    print(json.dumps({"evaluation": f"{len(raws)} JAX artifacts (chip_smoke.py phase 7a)",
                      "card": card, "turns": turns}))


def main() -> int:
    if sys.argv[1:2] == ["telemetry"]:
        import portbench.run  # noqa: F401  (the harness's thread settings, set before torch's import)
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    if sys.argv[1:] == ["tracking"]:
        profile_tracking(card)
    elif sys.argv[1:] == ["kernels"]:
        # the two paths first, in a process that has not yet profiled
        # anything or loaded the build with phase clocks
        profile_chain(card)
        profile_tracking(card)
        if not (kernel_rows(card) and res100_row(card) and face_slice_sweep(card)):
            print("chip_profile: a kernel row disagrees with its plain version",
                  file=sys.stderr)
            return 1
        kernel_rows(card, graphs=True)
    elif sys.argv[1:] == ["evaluation"]:
        evaluation_turns(card)
    elif sys.argv[1:2] == ["telemetry"] and len(sys.argv) in (4, 5):
        from parity_cases import telemetry_cell

        seconds = float(sys.argv[4]) if len(sys.argv) == 5 else 35.0
        out = telemetry_cell(sys.argv[2], int(sys.argv[3]) % 2**63, seconds)
        print(json.dumps({"card": card, **out}))
    elif not sys.argv[1:]:
        profile_chain(card)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
