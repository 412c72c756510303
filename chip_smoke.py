#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero):
  1. print the card's name and power limit (nvidia-smi) and build the kernel
     (``jl_tpu_torch/csrc/render_score.cu``) with nvcc from this checkout;
  2. hold the kernel against its plain PyTorch version on the card at the
     benchmark shape (monkey mesh, 30x30, 100 poses), at 80x60 and on the
     16x16 cube (association score), then for each of the eight score
     variants with the likelihood sigmas as parameters and as a device
     ``hyper`` row at 30x30 and 80x60: ell and sum_o within rtol=1e-3,
     atol=0.2, a median relative difference <= 1e-4 and bitwise-equal
     repeats; time every epilogue group and the hyper path at the benchmark
     shape against its plain version and its bound; the resident path
     (every epilogue, with and without the hyper row, forced by a face
     budget) bitwise against a one-chunk launch, and the path counter; at
     the res100 cell's shape (20,000 faces, 100x100, 1,000 poses) the
     automatic resident plan bitwise against one block an SM, its face
     chunks against the plain version at 8 poses, and every score kernel's
     blocks an SM against the runtime's count;
  3. run the benchmark chain through the port (bench.py's configuration:
     tempered SMC-MH, association posterior, 1280-face mesh, 30x30 crop,
     100 particles, 500 steps; ``bench_torch.run_chain``) after one warm-up
     run, three timed runs with the kernel's launch count read around each,
     and check the outputs;
  4. the per-image sweep of scripts/smc_bop_val.py on four synthetic
     640x480 scenes (the monkey, partly occluded by a cube): segmentation
     prior point, 30x30 crop, the step count calibrated to a 0.5 s budget
     (with the script's feedback pass on the realized wall time), then
     ``make_conditioned_chain`` for each of the eight variants over
     every image, and ``make_tuned_chain`` against it and with two tuned
     parameter sets; launches must equal likelihood evaluations in every run;
  5. the kernel check of scripts/verify_depth_layout.py through the port:
     ``render_depth`` against the dense rasteriser at 30 and 50 px for 64
     random poses, then the score recomputed by the plain score function from
     the depth image that ``render_score(return_mu=True)`` wrote against the
     kernel's own sums;
  6. tracking (scripts/torch_ros_particle_filter.py's configuration): the
     synthetic 80x60 stream rendered by ``render_depth`` on the card, the
     coordinate filter (600 particles) and the bootstrap filter (1250) on it
     and the coordinate filter on the stream with events, one warm-up run and
     three timed runs each; the script's error gates, launches = likelihood
     evaluations = 1 + 2 (F - 1) and 1 + (F - 1), final densities against the
     plain version on the CPU; frames per second are printed, not gated;
  7. BOP validation on data/bop/synthcad/val (scripts/torch_smc_bop_val.py):
     render_score[association] at the sweep's shapes (1,800-face model,
     30x30, 100 / 1 / 10 / 9 poses) against its plain version and timed;
     7a, the port's evaluate_scene on the JAX package's checked-in estimates
     of all 18 scenes and three samplers against its checked-in errors
     (visibilities equal, ADD-S within 1e-4 relative, VSD and every VSDBOP
     tau within 0.01, counts under each threshold equal but for entries
     within 0.01 of it), the recall per sampler beside sampler_recall.csv,
     and render_depth at the evaluation's shape (81,920 faces, 100x100, every
     face drawn, the faces of each pose split over blocks) bitwise equal to
     its plain version and to one block per pose, both plans timed; 7b, scene_inference on
     scene 1 for smc_mh, mh_sampler and mtm_sampler at the 0.5 s budget:
     finite estimates, launches = likelihood evaluations = 1 + k (steps - 1)
     per chain run (k = 2 for the multiple-try sampler), the best pose's
     log-likelihood against the plain version on the CPU; wall per pose,
     steps per budget and the scene's recall beside the JAX artifact's are
     printed, not gated;
  8. ``python3 bench_torch.py`` in a process of its own (phase 3 times the
     same ``bench_torch.run_chain``): rc 0, exactly one JSON line with
     bench.py's keys and ``device``, a positive value;
  9. the BOP submission CSV (scripts/torch_smc_bop_test.py) of synth val
     scene 1 into a temporary directory: header and (scene_id, im_id,
     obj_id) rows those of data/smc_mh_synth-val.csv, every R orthonormal
     with determinant +1, every row's time its image's sum, launches =
     likelihood evaluations; render_score[association] at 100 poses on each
     synth model (1,280, 12, 320 faces) against its plain version, timed;
  10. the hardvis split of data/bop/synth: phase 7a's evaluation parity on
     the six JAX artifacts, recalls equal to its sampler_recall.csv to every
     digit, render_depth at its evaluation shape (320 faces, 100x100)
     bitwise and timed, then smc_mh inference on scene 1 at 0.5 s per pose
     (launches = evaluations, finite estimates, best log-likelihood against
     the plain version) and render_score[association] at that inference's
     shape against its plain version, timed;
  11. scripts/torch_inference_time.py's grid at 25 / 50 / 100 px x 2 / 100 /
     1000 particles (ms per step printed), and render_score[association] at
     1000 poses x 100x100 against its plain version with phase 2's
     tolerances, timed;
  12. a recorded stream: the tracking scene's 120 frames rendered at 640x480
     by render_depth (written over NaN, bitwise against its plain version,
     timed, its device time required), written as
     a ROS1 bag by the port's rosbag writer (16UC1 images, camera info,
     ground-truth poses), converted by convert_rosbag and tracked through
     scripts/torch_ros_particle_filter.py's --stream path at 80x60 (the
     model read from an OBJ) by the coordinate (600) and bootstrap (1250)
     filters under the script's gates with launches = evaluations, and
     render_score[fixed_o] on the coordinate filter's final particles and
     the last frame against its plain version, timed; the spec
     fixture bag tests/fixtures/rosbag/tracker.bag read; phase 3's final
     SmcState saved by utils.checkpoint and restored onto the card bitwise;
  13. the graph (unfused) posteriors, which render with render_depth and
     score in tensor code: (a) scripts/torch_demo_inference.py's run at its
     defaults (simple_posterior, smc_mh, 1,280-face monkey, 30x30, 100
     particles, 300 steps) and with association_posterior, a first and three
     timed chains each: RESULT: PASS, render_depth launches = likelihood
     evaluations, no render_score launch; the host synchronisations of a
     graph and a fused evaluation and of a short chain printed; (b) each of
     the six graph factories on the demo's final particles against the
     matching fused variant on the card and against itself on the CPU
     (rtol 1e-3, atol 0.05); (d) mtm_sampler, 10 tries x 1 chain: finite,
     launches = evaluations = 1 + 2 (steps - 1); (e) the coordinate filter
     (600 particles) with pf_prior + simple_posterior on phase 6's stream
     under the tracking script's gates, launches = evaluations = 1 + 2 (F -
     1) per run, final densities against the plain version, fps printed; (f)
     Gibbs on tests/test_samplers.py's Gaussian model (mean and std within
     0.02); (c) render_depth with back faces drawn on (a)'s and (e)'s final
     particles ([100, 30, 30] x 1,280 faces, [600, 60, 80] x 256 faces),
     written over NaN, bitwise against its plain version, timed, its device
     time required;
  14. the dissertation's experiment sweeps and particle sharding: (a) the
     port's evaluate_scene on all 51 estimate artifacts of the nine JAX
     sweeps (smc_benchmark{,_cad,_steri}, mcmc_benchmark, mcmc_baseline,
     smc_mh_baseline, smc_mh_resolution, smc_observation, smc_priors)
     against the JAX errors (visibilities equal, ADD-S within 1e-4 relative,
     VSD and VSDBOP within 0.005; the JAX package's re-evaluation in
     tests/fixtures/reevaluated_errors.npz where it does not reproduce the
     checked-in errors), and each script's table on the port's errors
     against the same table on the JAX errors (and the checked-in CSV); (b)
     one config of each script on scene 1 through the script's ``run`` at its
     real settings (smc_benchmark 100 and 250 particles at 0.25 s,
     mcmc_benchmark MTM 40 tries at 0.25 s, smc_observation simple and
     smooth with the mask prior, smc_priors point, smc_mh_resolution 15 and
     60 px, smc_mh_baseline, smc_benchmark_steri 100 at 0.25 s): finite
     estimates, launches = likelihood evaluations per chain run; (c)
     render_score on each of those configs' final particles (MTM: 40 tries)
     against its plain version, timed; (d) ``sharded_sample_chain`` in a
     one-process NCCL group on the flagship posterior against
     ``sample_chain`` with the same seed, launches = evaluations, no host
     synchronisation; (e) the tracking script's coordinate filter exported
     with --export-tum through scripts/torch_trajectory_error.py, ATE and
     median errors inside the tracking gates;
  15. the hyperparameter searches and the synthetic BOP generator: (a) the
     port's evaluate_scene on all 108 estimate artifacts of the six JAX
     searches (HYPEROPT_EXPERIMENTS) under phase 14a's gates, against the
     JAX package's re-evaluation in
     tests/fixtures/reevaluated_errors_hyperopt.npz where the checked-in
     errors are stale, each trials.csv cost recomputed from those errors and
     from the port's beside the checked-in one; (b) each search script at
     its real settings with 2 trials on scene 1 of its split at --seed 0
     (HYPEROPT_RUNS) into a temporary directory: one calibration per object,
     one step count per object for both trials, finite estimates, launches =
     likelihood evaluations = 1 + k (steps - 1) per chain run, trials.csv
     well formed with the JAX search's first two candidates; (c)
     render_score[association] with the trial's hyper row on each search's
     final particles (MTM: 10 tries) against its plain version, timed; (d)
     scripts/torch_make_synthetic_bop.py: the easy profile (synth val scene
     1 at --seed 0, the checked-in rotations injected) and the cad profile
     (synthcad train scene 1, images 0-1, at --seed 77, the JAX script's
     rotation draws from tests/fixtures/jax_generator_quaternions.json
     injected) against the checked-in scenes (poses, cameras, masks,
     visibilities, depth), one render_depth launch per solo render, and
     render_depth at the generator's 160x160 window on the 128,000-face
     model (bitwise against its plain version, timed, its device time
     required);
  16. the JAX package's BOP runs that had no port counterpart, the budget
     repair and synth_steri on demand: (a) the port's evaluate_scene on the
     nine estimate artifacts of smc_bop_val, smc_bop_val2{,_b005,_b010},
     smc_bop_cad_val2 and hard_cases (BOP_RUNS) under phase 14a's gates,
     against tests/fixtures/reevaluated_errors_bop_runs.npz where the
     checked-in errors are stale, and render_depth at the hard split's
     evaluation shape (bitwise, timed); (b) scene_inference on the first two
     images of hard scene 1, val2 scene 1 at 0.05 s and synthcad val2 scene
     1 (finite, launches = evaluations), render_score[association] at the
     hard and val2 crops against its plain version, timed, and the mean wall
     per pose within 1.05 x the budget for mcmc_benchmark's mh_sampler at
     0.5 s and smc_benchmark's 100 particles at 0.05 s on scene 1; (c)
     scripts/torch_smc_benchmark_steri.py into a --bop-dir without the set:
     the generator makes it, then one 0.25 s config on two images;
  17. the figure scripts and the colour decoders: (a) the panels of
     scripts/torch_plot_depth_imgs.py (150x150 crop of synth val scene 1's
     first row), torch_visualize_crop.py (15 / 30 / 60 px, host work) and
     torch_visualize_full_scene.py (640x480, the model decimated to at most
     2,000 faces): each script's render_depth launches counted on its own,
     one per render (back faces drawn), none for the crops, and each
     kernels-line row carries its script's count; each render bitwise
     against its plain version over NaN and timed, the panels against the
     same computation on CPU tensors (z and mu equal, the association o
     within rtol 1e-5), the generated image within 3 sigma of
     mu on at least its binomial bound of pixels; (b)
     torch_simple_logjac.py's three chains at 2,000 steps, each mean within
     the script's stated bound of theta; (c) the colour PNG and JPEG
     fixtures of tests/fixtures/color bitwise against their checked-in
     imageio decodes;
  18. the chains captured as CUDA graphs against the eager loop
     (``captured=False``): (a) the flagship chain (phase 3's configuration),
     (b) phase 4's conditioned runner over its four scenes at two step
     counts through one capture and the tuned runner over two candidates
     through one capture, (c) both trackers on phase 6's stream (coordinate
     600, bootstrap 1250) and the unfused coordinate filter: each captured
     path bitwise equal to its eager run, the flagship reseeded equal and
     with another seed different, one capture per runner; hypotheses/s,
     ms per step (frame), the device's idle
     share and the host's launch calls per step, eager and captured, are
     printed, not gated; (d) each path in a process of its own (beyond a
     fresh process's first session torch.profiler drops a launch now and
     then; a second process where the first's dropped), the profiler's
     render_score kernels of one replayed flagship chain and of one
     replayed run of each tracker equal to the counted launches and
     evaluations and to 1 + k (steps - 1). Every chain of phases 3-17 runs
     captured (the default), so their launch gates count replays.
Every phase prints the seconds since the start when it ends.
Phase 2 also holds ``render_depth`` and ``render_score(return_mu=True)``
against their plain versions and each other, and times them at the tracking
shape (256-face mesh, 80x60, 600 poses); launches the kernel with forced
small face chunks and forced small row bands, which must leave the image,
ell and sum_o bitwise equal to the unforced launch;
launches ``render_depth`` with forced face slices (one block per pose and
several), which must leave its image bitwise equal;
runs the same poses with and without the background-score kernel (bitwise);
reads the camera from a device row (``cam_row``) at the bench and tracking
shapes: every epilogue and both images bitwise equal to the launch with host
scalars, within the phase's tolerances of the plain version given the same
row, and a second camera written into the same row bitwise equal to its own
launch;
renders 8 poses at 640x480 (an image that takes several shared-memory tiles)
and a 20480-face mesh at 160x120 (faces in chunks, vertices uncached) against
the plain version, the depth-only kernel (each of its plans) and the score
kernels with and without the image, depth bitwise, and the 128,000-face
synthcad model at the evaluation's 100x100 through each face-slice plan
(bitwise, timed); and prints for every timed row the share of its
bound that it reaches.
The second-to-last line is a JSON object describing the kernels; the last is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# the benchmark's scene, chain and likelihood-evaluation counter, which phase 3
# shares with bench_torch.py (standard library only at import)
from bench_torch import EvaluationCount, bench_scene, run_chain

REPO = Path(__file__).resolve().parent
PKG = "bayesianposeestimation/jl_tpu_torch"
PALLAS = "bayesianposeestimation/jl_tpu/ops/pallas_raster.py"

# published H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 operations per (live triangle, pixel) pair in the raster loop:
# w0 4, w1 4, w2 2, depth 4, max 1 (the three compares not counted)
OPS_PER_PAIR = 15
OPS_PER_FACE = 90  # transform, projection, edges, culls, area division
# fp32 operations (transcendentals counted as one) per pixel of each score
# epilogue, sums included: a normal logpdf ~7, the exponential tail ~16, an
# association ~12, a weighted mixture ~15, a smooth tail ~78 (two log_ndtr
# of ~20 each); the smooth epilogue evaluates a smooth tail twice (with the
# association and the pixel sigma)
OPS_PER_PIXEL = {"fixed_o": 40, "association": 60, "smooth_association": 200,
                 "uniform_fixed_o": 25, "uniform_association": 45,
                 "depth": 2}  # the depth-only kernel: a reciprocal and a select
MU_REL_TOL = 1e-6  # relative depth difference, kernel image vs plain version
TRACK_FRAMES = 120  # scripts/torch_ros_particle_filter.py's default stream
TOL = dict(rtol=1e-3, atol=0.2)
MEDIAN_REL_TOL = 1e-4
HYPER = (0.02, 0.015)  # [pixel_sigma, association_sigma] for the hyper checks
TIME_BUDGET = 0.5  # seconds per pose, the BOP submission's budget
# tuned sets of scripts/smc_bop_val.py (TUNED_PARAMETERS, CAD_TUNED)
TUNED_SETS = {
    "TUNED_PARAMETERS": dict(pixel_sigma=0.0019, association_sigma=0.0019, o_mask_is=0.87,
                             o_mask_not=0.20, sigma_t=(0.0108, 0.0108, 0.0108),
                             proposal_sigma_r=(1.48, 1.48, 1.48)),
    "CAD_TUNED": dict(pixel_sigma=0.002488, association_sigma=0.002488, o_mask_is=0.9564,
                      o_mask_not=0.3708, sigma_t=(0.01579, 0.01579, 0.01579),
                      proposal_sigma_r=(2.2945, 2.2945, 2.2945)),
}


def kernel_inputs(device, width, height, mesh_name, n_poses=100, seed=0):
    """Poses scattered around the scene's ground truth (2 cm, ~0.3 rad)."""
    import torch

    from bayesianposeestimation.jl_tpu_torch import quaternions as quat
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters

    exp, gt_t, gt_q, gen = bench_scene(device, width, height, mesh_name, seed)
    t = gt_t + 0.02 * torch.randn((n_poses, 3), generator=gen, device=device)
    q = quat.qplus(gt_q.expand(n_poses, 4),
                   0.3 * torch.randn((n_poses, 3), generator=gen, device=device))
    params = Parameters(width=width, height=height, device=str(device))
    s = exp.scene
    return (s["verts"], s["faces"], s["camera"], t.contiguous(), q.contiguous(),
            exp.depth_image.contiguous(), 0.7, params)


def compare_kernel(args, device, variant="association", hyper=None):
    """Kernel vs plain version on the same inputs; returns the comparison."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
        render_score,
        render_score_reference,
    )

    ell_k, sumo_k = render_score(*args, variant=variant, hyper=hyper, device=device)
    ell_k2, sumo_k2 = render_score(*args, variant=variant, hyper=hyper, device=device)
    ell_r, sumo_r = render_score_reference(*args, variant=variant, hyper=hyper)
    if device != "cpu":
        torch.cuda.synchronize()
    k = np.concatenate([ell_k.cpu().numpy(), sumo_k.cpu().numpy()])
    r = np.concatenate([ell_r.cpu().numpy(), sumo_r.cpu().numpy()])
    repeat_equal = bool(torch.equal(ell_k, ell_k2) and torch.equal(sumo_k, sumo_k2))
    rel = np.abs(k - r) / np.maximum(np.abs(r), 1e-30)
    ok = (bool(np.all(np.isfinite(k))) and repeat_equal
          and bool(np.allclose(k, r, **TOL)) and float(np.median(rel)) <= MEDIAN_REL_TOL)
    return {"ok": ok, "max_abs_err": float(np.max(np.abs(k - r))),
            "median_rel": float(np.median(rel)), "repeat_bitwise_equal": repeat_equal,
            "ell_mean": float(r[: len(r) // 2].mean()), "sum_o_mean": float(r[len(r) // 2:].mean())}


def time_ms(fn, n, sync):
    """Mean milliseconds per call over ``n`` calls after two warm-up calls
    (CUDA events on the card)."""
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / n


def device_ms(fn, n, tries=3):
    """Mean device time (ms) per launch of the kernels of csrc/render_score.cu
    that ``n`` calls of ``fn`` launch (the poses' kernel and, for a score,
    the small background kernel before it; for a split depth render the
    image's zeroing and the resolve kernel after it), from torch.profiler.
    Late in a long process the profiler drops some launches of a session,
    now and then all of them, so the recorded kernels' time is divided by
    the recorded launches (one ``render_score_kernel`` each), not by ``n``;
    a session that holds fewer than a quarter of its launches is taken
    again, up to ``tries`` times. None if none holds enough."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and (is_raster_kernel(e.name) or e.name.startswith("Memset"))]
        launches = sum("render_score_kernel" in e.name for e in kernels)
        if launches < n:
            print(f"device_ms: profiler session {attempt} of {tries} recorded {launches} of {n} "
                  f"kernel launches")
        if launches >= max(1, n // 4):
            return sum(e.time_range.elapsed_us() for e in kernels) / launches / 1e3
    return None


def on_nan_block(fn):
    """``fn()`` twice: the first output is filled with NaN and freed, and the
    caching allocator places the second on the same block, so that a
    compared image cannot be an earlier image left in freed memory. Returns
    (the second output, whether it lies on the NaN-filled block)."""
    first = fn()
    ptr = first.data_ptr()
    first.fill_(float("nan"))
    del first
    out = fn()
    return out, out.data_ptr() == ptr


def is_raster_kernel(name):
    """Whether a profiled CUDA kernel is one of csrc/render_score.cu."""
    return any(k in name for k in ("render_score_kernel", "score_background_kernel",
                                   "depth_resolve_kernel"))


def live_pairs(verts, faces, cam, t, q, backface_cull=True):
    """(live triangle, pixel) pairs a z-buffer must test on these poses: for
    each live triangle (back faces too where ``backface_cull`` is off), the
    pixel centres inside its bounding box clipped to the viewport."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
        project_vertices,
        triangle_forms,
    )

    valid, _ = triangle_forms(verts, faces, cam, t, q, backface_cull=backface_cull)
    u, v, _ = project_vertices(verts, faces, cam, t, q)

    def extent(c, size):
        # pixel centres lie at k - (size - 1) / 2 for k in [0, size)
        off = (size - 1) / 2.0
        lo = torch.ceil(torch.minimum(torch.minimum(c[0], c[1]), c[2]) + off).clamp(min=0)
        hi = torch.floor(torch.maximum(torch.maximum(c[0], c[1]), c[2]) + off).clamp(max=size - 1)
        return (hi - lo + 1).clamp(min=0)

    area = extent(u, cam.width) * extent(v, cam.height)
    return int(torch.where(valid, area, torch.zeros_like(area)).sum())


def bound_ms(args, epilogue="association", hyper=False, mu=False, backface_cull=True):
    """Least time for the kernel's work on these inputs: the larger of the
    fp32 operations over the fp32 peak and the bytes (inputs read once,
    outputs written once) over the memory rate. The raster work counts the
    pixels in each live triangle's clipped bounding box. ``epilogue="depth"``
    is the depth-only kernel (no observation, prior or sums); ``mu`` adds the
    [N, H, W] image that the kernel writes."""
    verts, faces, cam, t, q = args[:5]
    n, f = t.shape[0], faces.shape[0]
    p = cam.height * cam.width
    pairs = live_pairs(verts, faces, cam, t, q, backface_cull)
    ops = (pairs * OPS_PER_PAIR + n * f * OPS_PER_FACE
           + n * p * OPS_PER_PIXEL[epilogue])
    score = epilogue != "depth"
    nbytes = (verts.numel() + faces.numel() + t.numel() + q.numel()
              + (2 * p + 2 * n if score else 0) + (2 if hyper else 0)
              + (n * p if mu or not score else 0)) * 4
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops,
            pairs)


def share_of_bound(b_ms, ms, dev_ms):
    """The share of its bound a kernel reaches, by its device time and by the
    pace of back-to-back launches through the wrapper."""
    by_device = f"{100 * b_ms / dev_ms:.2f} %" if dev_ms else "not measured"
    return (f"share of bound {by_device} by device time, {100 * b_ms / ms:.2f} % by "
            f"launch-paced time")


def score_row(args, device, label, smi, variant="association", epilogue="association",
              calls=(200, 5, 50), hyper=None):
    """render_score on ``args`` (with the device ``hyper`` row if given)
    against its plain version (``compare_kernel``), then timed: CUDA events
    over ``calls[0]`` launches, the plain version over ``calls[1]`` calls,
    profiler device time over ``calls[2]``; the bound. Prints one line under
    ``label``; returns (timing row, comparison)."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
        render_score,
        render_score_reference,
    )

    res = compare_kernel(args, device, variant, hyper)
    sync = torch.cuda.synchronize
    ms = time_ms(lambda: render_score(*args, variant=variant, hyper=hyper, device=device),
                 calls[0], sync)
    plain_ms = time_ms(lambda: render_score_reference(*args, variant=variant, hyper=hyper),
                       calls[1], sync)
    dev_ms = device_ms(lambda: render_score(*args, variant=variant, hyper=hyper,
                                            device=device), calls[2])
    b_ms, b_by, ops, pairs = bound_ms(args, epilogue, hyper is not None)
    print(f"{label} ({args[1].shape[0]} faces, {args[2].width}x{args[2].height}, "
          f"{args[3].shape[0]} poses): ok {res['ok']}, max |d| {res['max_abs_err']:.5f}, median "
          f"rel {res['median_rel']:.2e}; kernel {ms:.4f} ms (CUDA events over {calls[0]} "
          f"calls), device {dev_ms} ms (profiler), plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
          f"({b_by}, {ops / 1e6:.3f} M ops, {pairs} live triangle-pixel pairs), "
          f"{share_of_bound(b_ms, ms, dev_ms)} on {smi}")
    return (ms, dev_ms, plain_ms, b_ms, b_by), res


def forced_plan_check(args, label, device, failures):
    """The kernel with forced small face chunks, row bands and both: image,
    ell and sum_o must equal the unforced launch bit for bit (tiles narrower
    than the image keep the image bitwise and the sums within rounding)."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
        launch_plan,
        render_depth,
        render_score,
    )

    verts, faces, cam, t = args[:4]
    width, n_faces = cam.width, faces.shape[0]
    base = render_score(*args, variant="simple", device=device, return_mu=True)
    base_assoc = render_score(*args, variant="association", device=device)
    base_depth = render_depth(*args[:5], device=device)
    for tuning in ({"face_budget": max(1, n_faces // 3)}, {"pixel_budget": 7 * width},
                   {"face_budget": 33, "pixel_budget": 3 * width},
                   {"pixel_budget": width // 2 + 3}):
        plan = launch_plan(verts.shape[0], n_faces, cam.height, width, t.shape[0], **tuning)
        narrow = plan["band_cols"] < width
        out = render_score(*args, variant="simple", device=device, return_mu=True, tuning=tuning)
        assoc = render_score(*args, variant="association", device=device, tuning=tuning)
        depth = render_depth(*args[:5], device=device, tuning=tuning)
        torch.cuda.synchronize()
        images = bool(torch.equal(out[2], base[2]) and torch.equal(depth, base_depth))
        sums = bool(all(torch.equal(a, b) for a, b in zip((*out[:2], *assoc),
                                                          (*base[:2], *base_assoc))))
        close = bool(all(torch.allclose(a, b, rtol=1e-5, atol=1e-3)
                         for a, b in zip((*out[:2], *assoc), (*base[:2], *base_assoc))))
        print(f"phase 2 forced plan at {label} {json.dumps(tuning)} -> faces per chunk "
              f"{plan['face_cap']} of {n_faces}, tile {plan['band_rows']}x{plan['band_cols']}, "
              f"threads {plan['threads']}: images bitwise equal {images}, ell and sum_o "
              f"bitwise equal {sums}" + (" (narrow tiles: within rounding "
                                         f"{close})" if narrow else ""))
        if not images or not (close if narrow else sums):
            failures.append(f"forced plan {tuning} at {label}")
    # the depth-only kernel's face slices (the score kernels take none)
    auto = launch_plan(verts.shape[0], n_faces, cam.height, width, t.shape[0],
                       depth_only=True)["face_slices"]
    for tuning in ({"face_slices": 1}, {"face_slices": 2}, {"face_slices": 9},
                   {"face_slices": 5, "face_budget": 33, "pixel_budget": 3 * width}):
        depth = render_depth(*args[:5], device=device, tuning=tuning)
        torch.cuda.synchronize()
        same = bool(torch.equal(depth, base_depth))
        print(f"phase 2 forced plan at {label} {json.dumps(tuning)} (automatic "
              f"{auto} face slices): render_depth image bitwise equal {same}")
        if not same:
            failures.append(f"forced plan {tuning} at {label}")


def path_counter():
    """A ``collections.Counter`` of the ``("render_score_path", path)``
    reports while it is listening (``telemetry.add_listener``), and the
    listener to remove."""
    import collections

    from bayesianposeestimation.jl_tpu_torch import telemetry

    paths = collections.Counter()

    def listen(key, n):
        if isinstance(key, tuple) and key[0] == "render_score_path":
            paths[key[1]] += n

    telemetry.add_listener(listen)
    return paths, listen


def resident_path_check(args, label, device, failures):
    """Phase 2: the resident path (``launch_plan``'s ``"resident"``: face
    chunks small enough that several pose blocks share an SM) against a
    one-chunk launch of the same inputs. Every epilogue, with the sigmas as
    parameters and from a device ``hyper`` row, forced onto the resident
    path by a face budget below the face count: ell and sum_o bitwise equal
    to the one-chunk launch, and so are μ, ell and sum_o of the ``+mu``
    launch under the same budget. Then the path counter (``("render_score_path",
    path)``) must have recorded these launches' paths and one of the banded
    path (``res100_check`` records the chunked path)."""
    import torch

    from bayesianposeestimation.jl_tpu_torch import telemetry
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
        EPILOGUES,
        SCORE_VARIANTS,
        launch_plan,
        render_score,
    )

    verts, faces, cam, t = args[:4]
    tuning = {"face_budget": max(1, faces.shape[0] // 3)}
    plans = {k: launch_plan(verts.shape[0], faces.shape[0], cam.height, cam.width,
                            t.shape[0], **kw)
             for k, kw in (("one chunk", {}), ("forced", tuning))}
    hyper = torch.tensor(HYPER, dtype=torch.float32, device=device)
    paths, listen = path_counter()
    try:
        for epilogue in EPILOGUES:
            variant = next(v for v, e in SCORE_VARIANTS.items() if e == epilogue)
            for row in (None, hyper):
                base = render_score(*args, variant=variant, hyper=row, device=device)
                forced = render_score(*args, variant=variant, hyper=row, device=device,
                                      tuning=tuning)
                torch.cuda.synchronize()
                same = all(bool(torch.equal(a, b)) for a, b in zip(base, forced))
                print(f"phase 2 resident path at {label}, {epilogue}"
                      f"{'' if row is None else ' +hyper'}: faces per chunk "
                      f"{plans['forced']['face_cap']} of {faces.shape[0]}, "
                      f"{plans['forced']['blocks_per_sm']} blocks an SM (one chunk: "
                      f"{plans['one chunk']['blocks_per_sm']}): ell and sum_o bitwise equal "
                      f"{same}")
                if not same:
                    failures.append(f"resident path at {label}: {epilogue} hyper {row is not None}")
        base = render_score(*args, device=device, return_mu=True)
        forced = render_score(*args, device=device, return_mu=True, tuning=tuning)
        render_score(*args, device=device, tuning={"pixel_budget": 7 * cam.width})
        torch.cuda.synchronize()
    finally:
        telemetry.remove_listener(listen)
    same = all(bool(torch.equal(a, b)) for a, b in zip(base, forced))
    wanted = {"one_chunk": 11, "resident": 11, "banded": 1}
    print(f"phase 2 resident path at {label}, association +mu: mu, ell and sum_o bitwise equal "
          f"{same}; launches by path {dict(paths)} (wanted {wanted})")
    if plans["forced"]["path"] != "resident" or plans["one chunk"]["path"] != "one_chunk":
        failures.append(f"resident path at {label}: plans {plans}")
    if not same or dict(paths) != wanted:
        failures.append(f"resident path at {label}: +mu or the path counter")


def occupancy(plan, epilogue="association", with_mu=False):
    """The blocks of ``plan`` that one SM holds at once of the score kernel
    for ``epilogue`` (the form that writes the image where ``with_mu``), as
    the CUDA runtime counts them (``bpe_score_occupancy``), or the error."""
    import ctypes

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import EPILOGUES, build_library

    fn = build_library()[0].bpe_score_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(-1)
    err = fn(EPILOGUES[epilogue], int(with_mu), plan["threads"], plan["smem_bytes"],
             ctypes.byref(blocks))
    return blocks.value if err == 0 else f"cudaError {err}"


def res100_plans(args):
    """At the inputs ``args``: the plan ``render_score`` picks and the
    plan of one block an SM (the ``face_cap`` of the plan for no pose count
    as ``face_budget``), each as (tuning, plan)."""
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import launch_plan

    verts, faces, cam, t = args[:4]
    shape = (verts.shape[0], faces.shape[0], cam.height, cam.width)
    one_block = {"face_budget": launch_plan(*shape)["face_cap"]}
    return {"resident": (None, launch_plan(*shape, t.shape[0])),
            "one block an SM": (one_block, launch_plan(*shape, t.shape[0], **one_block))}


def res100_check(device, failures, n_poses=1000, n_check=8):
    """Phase 2: ``render_score`` at the shape of the cell
    ``synthcad_smc_mh.res100_p1000`` (``res100_kernel_inputs``: 20,000
    faces, 100x100, a mask prior), where its own plan takes the resident
    path (``res100_plans``). At ``n_check`` poses under that plan's face
    chunks: μ of the ``+mu`` launch bitwise equal to the plain binned version
    under those chunks, ell and sum_o within ``TOL`` of the plain version. At
    ``n_poses``: every epilogue with and without the ``hyper`` row, and the
    ``+mu`` launch, bitwise equal under the automatic plan and one block an
    SM; the path counter's reports. For every epilogue, with the image and
    without, the plan's ``blocks_per_sm`` equal to the runtime's count, at
    ``n_poses`` (256 threads) and under the forced chunks at ``n_check`` (512
    threads). Returns the numbers."""
    import torch

    from bayesianposeestimation.jl_tpu_torch import telemetry
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
        EPILOGUES,
        SCORE_VARIANTS,
        launch_plan,
        render_mu_binned_reference,
        render_score,
        render_score_reference,
    )

    args = res100_kernel_inputs(device, n_poses)
    plans = res100_plans(args)
    chunks = {"face_budget": plans["resident"][1]["face_cap"]}
    small = res100_kernel_inputs(device, n_check)
    verts, faces, cam = small[:3]
    forced = launch_plan(verts.shape[0], faces.shape[0], cam.height, cam.width, n_check,
                         **chunks)
    hyper = torch.tensor(HYPER, dtype=torch.float32, device=device)
    cases = [(f"{e}{'' if row is None else ' +hyper'}",
              next(v for v, x in SCORE_VARIANTS.items() if x == e), row, False)
             for e in EPILOGUES for row in (None, hyper)]
    cases.append(("association +mu", "association", None, True))
    paths, listen = path_counter()
    try:
        ell, sum_o, mu = render_score(*small, device=device, return_mu=True, tuning=chunks)
        ref = render_score_reference(*small)
        binned = render_mu_binned_reference(*small[:5], face_budget=chunks["face_budget"],
                                            depth_only=False).reshape(mu.shape)
        unequal = []
        for name, variant, row, with_mu in cases:
            outs = [render_score(*args, variant=variant, hyper=row, device=device, tuning=tuning,
                                 return_mu=with_mu)
                    for tuning, _ in plans.values()]
            if not all(bool(torch.equal(a, b)) for a, b in zip(*outs)):
                unequal.append(name)
        torch.cuda.synchronize()
    finally:
        telemetry.remove_listener(listen)
    runtime = {f"{name} {e}{' +mu' if with_mu else ''}": occupancy(plan, e, with_mu)
               for name, plan in (("resident", plans["resident"][1]), ("forced", forced))
               for e in EPILOGUES for with_mu in (False, True)}
    off = {k: v for k, v in runtime.items()
           if v != (plans["resident"][1] if k.startswith("resident") else forced)["blocks_per_sm"]}
    wanted = {"resident": 12, "chunked": 11}
    res = {"poses": n_check, "faces_per_chunk": chunks["face_budget"],
           "mu_bitwise_vs_binned": bool(torch.equal(mu, binned)),
           "sums_within_tolerance": all(bool(torch.allclose(a, b, **TOL))
                                        for a, b in zip((ell, sum_o), ref)),
           "max_abs_err": max(float((a - b).abs().max()) for a, b in zip((ell, sum_o), ref)),
           "plans": {name: plan for name, (_, plan) in plans.items()}, "forced": forced,
           "unequal_between_plans": unequal, "launches_by_path": dict(paths),
           "runtime_blocks_per_sm_off": off}
    print(f"phase 2 res100 shape, {n_poses} poses: {json.dumps(res)} (wanted paths {wanted})")
    if not (res["mu_bitwise_vs_binned"] and res["sums_within_tolerance"]):
        failures.append("res100 shape: the resident chunks against the plain version")
    if unequal:
        failures.append(f"res100 shape: plans disagree on {unequal}")
    if plans["resident"][1]["path"] != "resident" or dict(paths) != wanted:
        failures.append("res100 shape: the path or the path counter")
    if off:
        failures.append(f"res100 shape: blocks an SM off the runtime's count: {off}")
    return res


def camera_row_check(args, label, device, failures):
    """Phase 2: the camera read from a device row (``cam_row``, the Pallas
    kernels' ``cam_ref``): every epilogue, ``return_mu`` and ``render_depth``
    with the row against the launch with host scalars (bitwise) and against
    the plain versions given the same row (phase 2's tolerances for the sums,
    the depth check of ``compare_depth_kernels`` for the images); then a
    second camera written into the same row against its host-scalar launch,
    bitwise."""
    import dataclasses

    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
        EPILOGUES,
        SCORE_VARIANTS,
        camera_row,
        render_depth,
        render_depth_reference,
        render_score,
        render_score_reference,
    )

    verts, faces, cam, t, q = args[:5]
    row = torch.as_tensor(camera_row(cam)).to(device)
    bitwise, worst, ok = True, 0.0, True
    for epilogue in EPILOGUES:
        variant = next(v for v, e in SCORE_VARIANTS.items() if e == epilogue)
        host = render_score(*args, variant=variant, device=device)
        from_row = render_score(*args, variant=variant, device=device, cam_row=row)
        plain = render_score_reference(*args, variant=variant, cam_row=row)
        bitwise &= all(bool(torch.equal(a, b)) for a, b in zip(host, from_row))
        k = torch.cat(from_row).cpu().numpy()
        r = torch.cat(plain).cpu().numpy()
        rel = np.abs(k - r) / np.maximum(np.abs(r), 1e-30)
        worst = max(worst, float(np.max(np.abs(k - r))))
        ok &= bool(np.allclose(k, r, **TOL)) and float(np.median(rel)) <= MEDIAN_REL_TOL
    mu_host = render_depth(*args[:5], device=device)
    mu_row = render_depth(*args[:5], device=device, cam_row=row)
    mu_plain = render_depth_reference(*args[:5], cam_row=row)
    mu_score = render_score(*args, variant="simple", device=device, return_mu=True,
                            cam_row=row)[2]
    covered = mu_plain > 0
    mu_rel = float(((mu_row - mu_plain).abs() / mu_plain.clamp(min=1e-30))[covered].max())
    images_bitwise = bool(torch.equal(mu_host, mu_row) and torch.equal(mu_score, mu_row))
    ok &= bool(torch.equal(mu_row > 0, covered)) and mu_rel <= MU_REL_TOL
    # another crop camera of the same size through the same row buffer
    other = dataclasses.replace(cam, f_x=cam.f_x * 1.07, c_x=cam.c_x + 0.6, c_y=cam.c_y - 0.4)
    row.copy_(torch.as_tensor(camera_row(other)))
    moved_ok = (all(bool(torch.equal(a, b)) for a, b in zip(
        render_score(*args, device=device, cam_row=row),
        render_score(*args[:2], other, *args[3:], device=device)))
        and bool(torch.equal(render_depth(*args[:5], device=device, cam_row=row),
                             render_depth(*args[:2], other, *args[3:5], device=device))))
    row.copy_(torch.as_tensor(camera_row(cam)))
    times = {name: (device_ms(lambda kw=kw: render_score(*args, device=device, **kw), 50),
                    device_ms(lambda kw=kw: render_depth(*args[:5], device=device, **kw), 50))
             for name, kw in (("host scalars", {}), ("row", {"cam_row": row}))}
    print(f"phase 2 camera row at {label}: every epilogue bitwise equal to the host scalars "
          f"{bitwise}, vs plain with the row max |d| {worst:.5f} (ok {ok}); render_depth and "
          f"return_mu images bitwise equal {images_bitwise}, max rel vs plain {mu_rel:.2e}; "
          f"a second camera through the same row bitwise {moved_ok}; device ms "
          f"render_score[association] / render_depth with host scalars "
          f"{times['host scalars'][0]} / {times['host scalars'][1]}, from the row "
          f"{times['row'][0]} / {times['row'][1]} (profiler)")
    if not (bitwise and ok and images_bitwise and moved_ok):
        failures.append(f"phase 2 camera row at {label}")


def background_path_check(args, device, failures):
    """A launch of a million pixel evaluations or more takes the score of
    uncovered pixels once, in a small kernel of its own; a smaller launch
    evaluates it in the poses' blocks. The same poses through both (all at
    once, and in batches below that size) must give the same bits."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.ops import cuda_raster

    verts, faces, cam, t, q = args[:5]
    n, n_pix = t.shape[0], cam.height * cam.width
    batch = max(1, (cuda_raster._BACKGROUND_MIN - 1) // n_pix)
    if not batch * n_pix < cuda_raster._BACKGROUND_MIN <= n * n_pix:
        failures.append("background path check: the shapes do not straddle the threshold")
        return
    for variant in ("simple", "association", "smooth"):
        whole = cuda_raster.render_score(*args, variant=variant, device=device)
        parts = [cuda_raster.render_score(verts, faces, cam, t[i:i + batch].contiguous(),
                                          q[i:i + batch].contiguous(), *args[5:],
                                          variant=variant, device=device)
                 for i in range(0, n, batch)]
        torch.cuda.synchronize()
        same = all(bool(torch.equal(whole[k], torch.cat([p[k] for p in parts]))) for k in (0, 1))
        print(f"phase 2 background score, {variant}: {n} poses in one launch (own kernel) vs "
              f"batches of {batch} (in the blocks): ell and sum_o bitwise equal {same}")
        if not same:
            failures.append(f"background score path differs ({variant})")


def no_size_limit_check(device, failures, verts, faces, smi):
    """Shapes that do not fit a block's shared memory at once: 8 poses of the
    1280-face mesh at 640x480 (the image in row bands), and a 20480-face
    icosphere at 160x120 (faces in chunks, vertices projected per face),
    each against the plain version: coverage identical, depth bitwise, from
    the depth-only kernel (its automatic face slices, one block per pose and
    six slices) and from a score kernel that writes the image; the sums of
    three score epilogues (whose blocks hold static shared memory beside the
    plan's) within the kernel-vs-plain tolerance. Then the BOP evaluation's
    largest model (synthcad object 2, 128,000 faces), 3 poses at 100x100,
    every face drawn: each plan bitwise equal to the plain version, and the
    automatic and one-block plans timed."""
    import torch

    from bayesianposeestimation.jl_tpu_torch import quaternions as quat
    from bayesianposeestimation.jl_tpu_torch.camera import CvCamera
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
        launch_plan,
        mesh_tensors,
        render_depth,
        render_depth_reference,
        render_score,
        render_score_reference,
    )
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
    from bayesianposeestimation.jl_tpu_torch.utils import mesh_io

    gen = torch.Generator(device=device).manual_seed(5)
    n = 8
    q = quat.rand_quaternion(gen, (n,)).contiguous()
    t = (torch.tensor([0.0, 0.0, 0.3], device=device)
         + 0.02 * torch.randn((n, 3), generator=gen, device=device)).contiguous()
    sphere = mesh_io.icosphere_mesh(0.1, 5)
    cases = (("1280 faces at 640x480", verts, faces, 640, 480),
             (f"{len(sphere.faces)} faces at 160x120",
              *mesh_tensors(sphere.vertices, sphere.faces, device), 160, 120))
    for label, v, f, w, h in cases:
        cam = CvCamera(width=w, height=h, f_x=0.94 * w, f_y=0.94 * w, c_x=(w - 1) / 2,
                       c_y=(h - 1) / 2, near=0.01, far=10.0)
        plan = launch_plan(v.shape[0], f.shape[0], h, w, n)
        t0 = time.perf_counter()
        mu = render_depth(v, f, cam, t, q, device=device)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ref = render_depth_reference(v, f, cam, t, q)
        coverage = bool(torch.equal(mu > 0, ref > 0))
        bitwise = bool(torch.equal(mu, ref))
        print(f"phase 2 no size limit, {label}, {n} poses: faces per chunk {plan['face_cap']}, "
              f"vertices cached {plan['cache_verts']}, tile {plan['band_rows']}x"
              f"{plan['band_cols']}, {plan['smem_bytes']} B of shared memory; covered "
              f"{float((ref > 0).float().mean()):.3f}; coverage identical {coverage}, depth "
              f"bitwise equal {bitwise}; one launch {dt * 1e3:.3f} ms")
        if not (coverage and bitwise and float((ref > 0).float().mean()) > 0.02):
            failures.append(f"no size limit: {label}")
        for tuning in ({"face_slices": 1}, {"face_slices": 6}):
            forced = render_depth(v, f, cam, t, q, device=device, tuning=tuning)
            torch.cuda.synchronize()
            same = bool(torch.equal(forced, ref))
            print(f"phase 2 no size limit, {label}, render_depth {json.dumps(tuning)} "
                  f"(automatic {plan['face_slices']}): depth bitwise equal {same}")
            if not same:
                failures.append(f"no size limit: {label}, render_depth {tuning}")
        # the score kernels at the same size, observing the first pose's image
        z = torch.where(ref[0] > 0, ref[0], torch.full_like(ref[0], torch.inf))
        score_args = (v, f, cam, t, q, z, 0.7, Parameters(width=w, height=h, device=str(device)))
        for variant, with_mu in (("simple", True), ("association", False), ("smooth", False)):
            out = render_score(*score_args, variant=variant, device=device, return_mu=with_mu)
            want = render_score_reference(*score_args, variant=variant)
            torch.cuda.synchronize()
            image = bool(torch.equal(out[2], ref)) if with_mu else None
            sums = all(bool(torch.isfinite(a).all() and torch.allclose(a, b, **TOL))
                       for a, b in zip(out[:2], want))
            err = max(float((a - b).abs().max()) for a, b in zip(out[:2], want))
            print(f"phase 2 no size limit, {label}, render_score {variant}"
                  + (f" with the image: image bitwise equal {image}" if with_mu else "")
                  + f": ell and sum_o within tolerance {sums} (max |d| {err:.5f}, ell mean "
                  f"{float(want[0].mean()):.1f})")
            if image is False or not sums:
                failures.append(f"no size limit: {label}, render_score {variant}")

    args = large_model_depth_args(device)
    v, f = args[:2]
    ref = render_depth_reference(*args, backface_cull=False)
    for tuning in (None, {"face_slices": 1}, {"face_slices": 17, "pixel_budget": 2000}):
        plan = launch_plan(v.shape[0], f.shape[0], 100, 100, 3, depth_only=True,
                           **(tuning or {}))
        mu = render_depth(*args, backface_cull=False, device=device, tuning=tuning)
        torch.cuda.synchronize()
        same = bool(torch.equal(mu, ref))
        timed = ""
        if tuning in (None, {"face_slices": 1}):
            dev_ms = device_ms(lambda: render_depth(*args, backface_cull=False, device=device,
                                                    tuning=tuning), 20)
            timed = f", device {dev_ms} ms (profiler)"
        print(f"phase 2 no size limit, {f.shape[0]} faces at 100x100, 3 poses, every face "
              f"drawn, render_depth {json.dumps(tuning)}: {plan['face_slices']} face slices "
              f"of up to {plan['face_cap']} faces, tile {plan['band_rows']}x"
              f"{plan['band_cols']}; covered {float((ref > 0).float().mean()):.3f}; depth "
              f"bitwise equal {same}{timed} on {smi}")
        if not (same and float((ref > 0).float().mean()) > 0.1):
            failures.append(f"no size limit: {f.shape[0]} faces, render_depth {tuning}")


def large_model_depth_args(device, seed=5):
    """render_depth's inputs for the BOP evaluation's largest model
    (synthcad object 2, 128,000 faces): 3 random rotations half a metre
    away, in a 100x100 camera that the object spans about three quarters of,
    as the evaluation's crop does (draw every face: ``backface_cull=False``)."""
    import torch

    from bayesianposeestimation.jl_tpu_torch import quaternions as quat
    from bayesianposeestimation.jl_tpu_torch.camera import CvCamera
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import mesh_tensors
    from bayesianposeestimation.jl_tpu_torch.utils import bop

    big = bop.load_mesh(BOP_DIR / "synthcad/models/obj_000002.ply")
    v, f = mesh_tensors(big.vertices, big.faces, device)
    cam = CvCamera(width=100, height=100, f_x=280.0, f_y=280.0, c_x=49.5, c_y=49.5,
                   near=0.01, far=10.0)
    gen = torch.Generator(device=device).manual_seed(seed)
    q = quat.rand_quaternion(gen, (3,)).contiguous()
    t = (torch.tensor([0.0, 0.0, 0.5], device=device)
         + 0.02 * torch.randn((3, 3), generator=gen, device=device)).contiguous()
    return v, f, cam, t, q


def check_chain(outs, final, posterior, gt, n_steps, n_particles):
    """Shapes and finiteness of the outputs, the best particle's pose error,
    and the final particles' densities re-evaluated by the plain version on
    the CPU against the card's."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch import quaternions as quat
    from bayesianposeestimation.jl_tpu_torch.models.fused import fused_posterior

    gt_t, gt_q = gt
    for k in ("t", "r", "log_prob", "log_like", "log_evidence", "temperature"):
        assert outs[k].shape[0] == n_steps - 1, (k, outs[k].shape)
        assert bool(torch.isfinite(outs[k]).all()), f"non-finite {k}"
    assert outs["t"].shape[1:] == (n_particles, 3) and outs["r"].shape[1:] == (n_particles, 4)
    s = final.sample
    best = int(torch.argmax(s.log_prob))
    t_err = float(torch.linalg.vector_norm(s.variables["t"][best] - gt_t))
    r_err = float(quat.quat_dist(s.variables["r"][best], gt_q))
    assert math.isfinite(t_err) and math.isfinite(r_err)

    cpu_post = fused_posterior(posterior.params, posterior.experiment.to("cpu"),
                               "association", device="cpu")
    cpu_sample = type(s)({k: v.cpu() for k, v in s.variables.items()})
    ll_cpu = cpu_post.logdensity_sample(cpu_sample).log_like.numpy()
    ll_dev = s.log_like.cpu().numpy()
    # the posterior scales ell by c_reg / sum_o (~50/300): the kernel's
    # tolerance scales with it
    dens_ok = bool(np.allclose(ll_dev, ll_cpu, rtol=1e-3, atol=0.2))
    return {"t_err_m": t_err, "r_err_rad": r_err,
            "log_evidence": float(outs["log_evidence"][-1]),
            "final_temperature": float(outs["temperature"][-1]),
            "density_vs_plain_max_abs": float(np.max(np.abs(ll_dev - ll_cpu))),
            "density_vs_plain_ok": dens_ok}


def occluded_scenes(device, n_scenes=4, seed=3, scale=1.0):
    """Full-frame scenes built through the port: the monkey at a pose of its
    own with a 6 cm cube 15 cm in front of it covering part of it, and 2 mm
    Gaussian depth noise (0 = no return). The mask is the monkey rendered
    alone. Depth and mask come back as host arrays, as the BOP sweep reads
    them from disk. ``scale`` shrinks the 640x480 frame."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch import quaternions as quat
    from bayesianposeestimation.jl_tpu_torch.camera import CvCamera
    from bayesianposeestimation.jl_tpu_torch.ops.rasterize import render_depth
    from bayesianposeestimation.jl_tpu_torch.utils import mesh_io

    w, h = round(640 * scale), round(480 * scale)
    base = CvCamera(width=w, height=h, f_x=600.0 * scale, f_y=600.0 * scale,
                    c_x=(w - 1) / 2, c_y=(h - 1) / 2, near=0.01, far=10.0)
    monkey, cube = mesh_io.monkey_mesh(0.08), mesh_io.cube_mesh(0.06)
    gen = torch.Generator(device=device).manual_seed(seed)

    def on_device(mesh):
        return (torch.as_tensor(mesh.vertices, dtype=torch.float32, device=device),
                torch.as_tensor(mesh.faces, device=device))

    (mv, mf), (cv, cf) = on_device(monkey), on_device(cube)
    positions = [(-0.06, 0.03, 0.85), (0.05, -0.02, 0.95), (0.02, 0.04, 1.05),
                 (-0.03, -0.05, 0.90)]
    scenes = []
    for i in range(n_scenes):
        gt_t = torch.tensor(positions[i % 4], dtype=torch.float32, device=device)
        gt_q = quat.rand_quaternion(gen)
        monkey_d = render_depth(mv, mf, base, gt_t, gt_q)
        side = 1.0 if i % 2 == 0 else -1.0
        cube_t = gt_t + torch.tensor([0.05 * side, 0.01, -0.15], device=device)
        cube_d = render_depth(cv, cf, base, cube_t, quat.rand_quaternion(gen))
        both = (monkey_d > 0) & (cube_d > 0)
        depth = torch.where(both, torch.minimum(monkey_d, cube_d),
                            torch.maximum(monkey_d, cube_d))
        noise = torch.randn(depth.shape, generator=gen, device=device)
        depth = torch.where(depth > 0, depth + 0.002 * noise, depth)
        mask = monkey_d > 0
        visible = mask & ((cube_d == 0) | (monkey_d <= cube_d))
        scenes.append({"cam": base, "depth": depth.cpu().numpy(), "mask": mask.cpu().numpy(),
                       "gt_t": gt_t, "gt_q": gt_q,
                       "visib_fract": float(visible.sum()) / max(float(mask.sum()), 1.0)})
    return scenes, monkey


def image_inputs(scene, params, diameter, o_mask=None):
    """scripts/smc_bop_val.py's per-image preparation: the segmentation
    prior point (pushed along its ray by a quarter diameter), the crop
    camera around it, the cropped observation and the mask prior image."""
    import numpy as np

    from bayesianposeestimation.jl_tpu_torch.camera import crop_camera, crop_image
    from bayesianposeestimation.jl_tpu_torch.models.experiment_models import (
        point_from_segmentation,
    )

    o_is, o_not = o_mask or (params.o_mask_is, params.o_mask_not)
    ys, xs = np.nonzero(scene["mask"])
    bbox = (xs.min(), xs.max(), ys.min(), ys.max())
    prior_t = point_from_segmentation(bbox, scene["depth"], scene["mask"], scene["cam"],
                                      diameter=diameter)
    cam = crop_camera(scene["cam"], prior_t, diameter, width=params.width,
                      height=params.height)
    obs = crop_image(scene["depth"], scene["cam"], cam)
    prior_o = np.where(crop_image(scene["mask"], scene["cam"], cam), o_is, o_not)
    return cam, obs.astype(np.float32), prior_o.astype(np.float32), prior_t


def timed_run(run, evals, *args):
    """One runner call, synchronised: (outs, final, wall s, kernel launches,
    likelihood evaluations)."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_score

    launches0, evals0 = render_score.launches, evals.n
    t0 = time.perf_counter()
    outs, final = run(*args)
    torch.cuda.synchronize()
    return (outs, final, time.perf_counter() - t0, render_score.launches - launches0,
            evals.n - evals0)


def best_error(outs, gt_t, gt_q):
    """Pose error of the final population's best-likelihood particle (the
    BOP sweep's estimate) and whether every output is finite."""
    import torch

    from bayesianposeestimation.jl_tpu_torch import quaternions as quat

    finite = all(bool(torch.isfinite(outs[k]).all())
                 for k in ("t", "r", "log_prob", "log_like", "log_evidence"))
    best = int(torch.argmax(outs["log_like"][-1]))
    t_err = float(torch.linalg.vector_norm(outs["t"][-1][best] - gt_t))
    r_err = float(quat.quat_dist(outs["r"][-1][best], gt_q))
    return finite, t_err, r_err


def densities_vs_plain(final, params, variant, cam, verts, faces, obs, prior_o, prior_t):
    """Max |Δ| between the final particles' log_like on the card and their
    re-evaluation by the plain version on the CPU, and whether it is within
    phase 3's tolerance."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch.models.fused import fused_posterior
    from bayesianposeestimation.jl_tpu_torch.parameters import Experiment

    exp = Experiment(scene={"camera": cam, "verts": torch.as_tensor(verts),
                            "faces": torch.as_tensor(faces)},
                     prior_o=torch.as_tensor(prior_o), prior_t=torch.as_tensor(prior_t),
                     depth_image=torch.as_tensor(obs))
    post = fused_posterior(params, exp, variant, device="cpu")
    s = final.sample
    cpu_sample = type(s)({k: v.cpu() for k, v in s.variables.items()})
    ll_cpu = post.logdensity_sample(cpu_sample).log_like.numpy()
    ll_dev = s.log_like.cpu().numpy()
    return (float(np.max(np.abs(ll_dev - ll_cpu))),
            bool(np.allclose(ll_dev, ll_cpu, rtol=1e-3, atol=0.2)))


def per_image_sweep(device, failures, n_particles=100, seed=11):
    """Phase 4: scripts/smc_bop_val.py's per-image loop on synthetic scenes
    through make_conditioned_chain (every variant) and make_tuned_chain.
    Returns the launches by kernel of the sweep and a summary."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch.models.experiment_samplers import smc_mh
    from bayesianposeestimation.jl_tpu_torch.models.fused import (
        fused_posterior,
        make_conditioned_chain,
        make_tuned_chain,
    )
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import SCORE_VARIANTS, render_score
    from bayesianposeestimation.jl_tpu_torch.parameters import Experiment, Parameters
    from bayesianposeestimation.jl_tpu_torch.utils import mesh_io
    from bayesianposeestimation.jl_tpu_torch.utils.evaluation import (
        mean_step_time,
        steps_for_time_budget,
    )

    params = Parameters(n_particles=n_particles, time_budget=TIME_BUDGET,
                        proposal_sigma_r=(0.5, 0.5, 0.5), device=str(device))
    t0 = time.perf_counter()
    scenes, mesh = occluded_scenes(device)
    diameter = mesh_io.mesh_diameter(mesh)
    images = [image_inputs(sc, params, diameter) for sc in scenes]
    print(f"phase 4 scenes: {len(scenes)} at {scenes[0]['cam'].width}x"
          f"{scenes[0]['cam'].height} in {time.perf_counter() - t0:.2f} s; visible fraction "
          f"{[round(sc['visib_fract'], 3) for sc in scenes]}; prior_t error (m) "
          f"{[round(float(np.linalg.norm(im[3] - sc['gt_t'].cpu().numpy())), 4) for im, sc in zip(images, scenes)]}")

    # calibrate once per object (smc_bop_val.py:165-190)
    cam, obs, prior_o, prior_t = images[0]
    exp = Experiment(scene={"camera": cam, "verts": mesh.vertices, "faces": mesh.faces},
                     prior_o=torch.as_tensor(prior_o), prior_t=prior_t,
                     depth_image=torch.as_tensor(obs))
    probe_post = fused_posterior(params, exp, "association", device=device)
    step_time, overhead = mean_step_time(seed, probe_post, smc_mh(params, probe_post),
                                         n_particles, max_seconds=0.5, return_overhead=True)
    n_steps = steps_for_time_budget(step_time, TIME_BUDGET, overhead=overhead)
    print(f"phase 4 calibration: step {step_time * 1e3:.3f} ms (+{overhead * 1e3:.1f} ms per "
          f"run) -> {n_steps} steps per {TIME_BUDGET} s budget")

    def runner(variant, n):
        return make_conditioned_chain(params.replace(n_steps=n), mesh.vertices, mesh.faces,
                                      variant, smc_mh, n, device=device)

    # feedback pass (smc_bop_val.py:201-235): the probe sees the best of its
    # repeats, a real run the typical host time and the per-image build; if
    # three real runs overshoot, re-derive the count from their overhead
    with EvaluationCount() as probe_evals:
        run = runner("association", n_steps)
        timed_run(run, probe_evals, seed + 1000, *images[0])  # warm-up
        wall_probe = float(np.mean([timed_run(run, probe_evals, seed + 1001, *images[0])[2]
                                    for _ in range(3)]))
    if wall_probe > TIME_BUDGET:
        o_real = max(wall_probe - n_steps * step_time, 0.0)
        n_new = steps_for_time_budget(step_time, TIME_BUDGET, overhead=o_real)
        print(f"phase 4 feedback: realized wall {wall_probe:.4f} s at {n_steps} steps > "
              f"budget; overhead {o_real * 1e3:.1f} ms -> {min(n_new, n_steps)} steps")
        n_steps = min(n_new, n_steps)
    params_run = params.replace(n_steps=n_steps)

    summary = {"n_steps": n_steps, "step_ms": step_time * 1e3, "overhead_ms": overhead * 1e3,
               "feedback_wall_s": wall_probe, "wall_s": {}, "t_err_mm": {}, "r_err_rad": {}}
    render_score.launches = 0
    render_score.launches_by.clear()
    with EvaluationCount() as evals:
        runners = {}
        for variant in SCORE_VARIANTS:
            run = runner(variant, n_steps)
            runners[variant] = run
            timed_run(run, evals, seed + 1000, *images[0])  # warm-up
            walls, t_errs, r_errs = [], [], []
            for k, ((cam, obs, prior_o, prior_t), sc) in enumerate(zip(images, scenes)):
                outs, final, wall, launches, n_evals = timed_run(
                    run, evals, seed + k, cam, obs, prior_o, prior_t)
                finite, t_err, r_err = best_error(outs, sc["gt_t"], sc["gt_q"])
                line = (f"phase 4 {variant:22s} image {k}: {n_steps} steps, wall {wall:.4f} s "
                        f"(budget {TIME_BUDGET} s), launches {launches} evaluations {n_evals}, "
                        f"best t err {t_err * 1e3:.2f} mm r err {r_err:.3f} rad")
                if not (launches == n_evals == n_steps):
                    failures.append(f"phase 4 {variant} image {k}: launches {launches} vs "
                                    f"evaluations {n_evals}")
                if not finite:
                    failures.append(f"phase 4 {variant} image {k}: non-finite outputs")
                if k == 0:
                    err, ok = densities_vs_plain(final, params_run, variant, cam, mesh.vertices,
                                                 mesh.faces, obs, prior_o, prior_t)
                    line += f", final densities vs plain max |d| {err:.5f}"
                    if not ok:
                        failures.append(f"phase 4 {variant}: densities vs plain version")
                print(line)
                walls.append(wall)
                t_errs.append(t_err * 1e3)
                r_errs.append(r_err)
            summary["wall_s"][variant] = walls
            summary["t_err_mm"][variant] = t_errs
            summary["r_err_rad"][variant] = r_errs

        # the tuned runner: hyper equal to the params reproduces the
        # conditioned runner; tuned sets change the likelihood
        tuned = make_tuned_chain(params_run, mesh.vertices, mesh.faces, "association", smc_mh,
                                 n_steps, device=device)
        hyper = {k: getattr(params_run, k) for k in
                 ("pixel_sigma", "association_sigma", "sigma_t", "proposal_sigma_r")}
        timed_run(tuned, evals, seed + 1000, *images[0], hyper)  # warm-up
        ref = timed_run(runners["association"], evals, seed, *images[0])
        same = timed_run(tuned, evals, seed, *images[0], hyper)
        gap = max(float((same[0][k] - ref[0][k]).abs().max()) for k in ("t", "r", "log_like"))
        print(f"phase 4 tuned chain, hyper = params: max |d| vs conditioned {gap:.3g} "
              f"(t, r, log_like); wall {same[2]:.4f} s, launches {same[3]} evaluations {same[4]}")
        if gap > 1e-6:
            failures.append(f"phase 4 tuned vs conditioned: max |d| {gap}")
        ll_ref = ref[0]["log_like"][-1]
        for name, tuned_set in TUNED_SETS.items():
            h = {k: tuned_set[k] for k in hyper}
            cam, obs, prior_o, prior_t = image_inputs(
                scenes[0], params, diameter, (tuned_set["o_mask_is"], tuned_set["o_mask_not"]))
            outs, _, wall, launches, n_evals = timed_run(tuned, evals, seed, cam, obs, prior_o,
                                                         prior_t, h)
            finite, t_err, r_err = best_error(outs, scenes[0]["gt_t"], scenes[0]["gt_q"])
            moved = float((outs["log_like"][-1] - ll_ref).abs().max())
            print(f"phase 4 tuned chain {name}: final log_like moved by up to {moved:.4f}; wall "
                  f"{wall:.4f} s, launches {launches} evaluations {n_evals}, best t err "
                  f"{t_err * 1e3:.2f} mm r err {r_err:.3f} rad")
            if not (launches == n_evals == n_steps) or not finite or moved <= 1e-3:
                failures.append(f"phase 4 tuned set {name}: launches {launches}, evaluations "
                                f"{n_evals}, finite {finite}, log_like moved {moved}")
    counts = dict(render_score.launches_by)
    print(f"phase 4 kernel launches by epilogue: {json.dumps(counts)}; total "
          f"{render_score.launches}, likelihood evaluations {evals.n}")
    if render_score.launches != evals.n:
        failures.append(f"phase 4 launches {render_score.launches} vs evaluations {evals.n}")
    summary["wall_s_mean"] = {v: float(np.mean(w)) for v, w in summary["wall_s"].items()}
    print(f"phase 4 summary: {json.dumps(summary)}")
    return counts


def tracking_kernel_inputs(device, n_poses=600, seed=0):
    """Kernel inputs at the tracking shape: the 256-face decimation of the
    0.18 m monkey, the 80x60 camera of the synthetic stream, ``n_poses``
    poses scattered around a pose of the orbit (5 mm, 0.05 rad: the
    coordinate filter's proposal scales) and a noisy frame over the
    background plane as the observation."""
    import torch

    from bayesianposeestimation.jl_tpu_torch import quaternions as quat
    from bayesianposeestimation.jl_tpu_torch.camera import CvCamera
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import mesh_tensors
    from bayesianposeestimation.jl_tpu_torch.ops.rasterize import render_depth
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
    from bayesianposeestimation.jl_tpu_torch.utils import mesh_io
    from bayesianposeestimation.jl_tpu_torch.utils.decimate import decimate

    w, h = 80, 60
    cam = CvCamera(width=w, height=h, f_x=1.1 * w, f_y=1.1 * w, c_x=(w - 1) / 2,
                   c_y=(h - 1) / 2, near=0.01, far=10.0)
    full = mesh_io.monkey_mesh(0.18)
    mesh = decimate(full, 256)
    verts, faces = mesh_tensors(mesh.vertices, mesh.faces, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    gt_t = torch.tensor([0.0, 0.03, 0.5], device=device)
    gt_q = quat.qexp(torch.tensor([0.4, 0.1, 0.05], device=device))
    clean = render_depth(*mesh_tensors(full.vertices, full.faces, device), cam, gt_t, gt_q)
    noise = torch.randn(clean.shape, generator=gen, device=device)
    z = torch.where(clean > 0, clean, torch.full_like(clean, 1.1)) + 0.005 * noise
    t = gt_t + 0.005 * torch.randn((n_poses, 3), generator=gen, device=device)
    q = quat.qplus(gt_q.expand(n_poses, 4),
                   0.05 * torch.randn((n_poses, 3), generator=gen, device=device))
    params = Parameters(width=w, height=h, device=str(device))
    return (verts, faces, cam, t.contiguous(), q.contiguous(), z.contiguous(),
            params.o_mask_is, params)


def res100_kernel_inputs(device, n_poses=1000, obj_id=1, seed=0):
    """Kernel inputs at the shape of the benchmark cell
    ``synthcad_smc_mh.res100_p1000``: the frozen 20,000-face decimation of
    synthcad object ``obj_id`` (``portbench/data/meshes``), a 100x100 crop
    camera (f = 373 px) with the object 0.7 m away, ``n_poses`` random
    rotations 1.6 cm around that point (the SMC prior's spread), the noisy
    render of one pose over a 1.1 m background as the observation, the mask
    prior of CAD_TUNED (``o_mask_is`` on the object's pixels, ``o_mask_not``
    off them) and its likelihood sigmas."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch import quaternions as quat
    from bayesianposeestimation.jl_tpu_torch.camera import CvCamera
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import mesh_tensors
    from bayesianposeestimation.jl_tpu_torch.ops.rasterize import render_depth
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters

    with np.load(REPO / "portbench/data/meshes" / f"synthcad_obj_{obj_id}_20000.npz") as m:
        verts, faces = mesh_tensors(m["vertices"], m["faces"], device)
    w = h = 100
    cam = CvCamera(width=w, height=h, f_x=373.0, f_y=373.0, c_x=(w - 1) / 2,
                   c_y=(h - 1) / 2, near=0.01, far=10.0)
    gen = torch.Generator(device=device).manual_seed(seed)
    gt_t = torch.tensor([0.0, 0.0, 0.7], device=device)
    gt_q = quat.rand_quaternion(gen, (1,))
    clean = render_depth(verts, faces, cam, gt_t, gt_q[0])
    noise = torch.randn(clean.shape, generator=gen, device=device)
    z = torch.where(clean > 0, clean, torch.full_like(clean, 1.1)) + 0.002 * noise
    t = gt_t + 0.016 * torch.randn((n_poses, 3), generator=gen, device=device)
    q = quat.rand_quaternion(gen, (n_poses,))
    tuned = TUNED_SETS["CAD_TUNED"]
    params = Parameters(width=w, height=h, device=str(device),
                        pixel_sigma=tuned["pixel_sigma"],
                        association_sigma=tuned["association_sigma"],
                        o_mask_is=tuned["o_mask_is"], o_mask_not=tuned["o_mask_not"])
    prior = torch.where(clean > 0, params.o_mask_is, params.o_mask_not)
    return (verts, faces, cam, t.contiguous(), q.contiguous(), z.contiguous(),
            prior.contiguous(), params)


def compare_depth_kernels(args, device):
    """``render_depth`` and ``render_score(return_mu=True)`` (fixed-o) against
    their plain versions and each other on the same inputs."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
        render_depth,
        render_depth_reference,
        render_score,
        render_score_reference,
    )

    mesh_pose = args[:5]
    mu_k = render_depth(*mesh_pose, device=device)
    mu_k2 = render_depth(*mesh_pose, device=device)
    mu_r = render_depth_reference(*mesh_pose)
    ell, sum_o, mu_s = render_score(*args, variant="simple", device=device, return_mu=True)
    ell2, sum_o2, mu_s2 = render_score(*args, variant="simple", device=device, return_mu=True)
    ell0, sum_o0 = render_score(*args, variant="simple", device=device)
    ell_r, sum_o_r, mu_sr = render_score_reference(*args, variant="simple", return_mu=True)
    if device != "cpu":
        torch.cuda.synchronize()
    covered = mu_r > 0
    rel = ((mu_k - mu_r).abs() / mu_r.clamp(min=1e-30))[covered]
    res = {
        "coverage_identical": bool(torch.equal(mu_k > 0, covered)),
        "covered_fraction": float(covered.float().mean()),
        "mu_max_rel": float(rel.max()) if rel.numel() else 0.0,
        "mu_max_abs": float((mu_k - mu_r).abs().max()),
        "depth_repeat_bitwise_equal": bool(torch.equal(mu_k, mu_k2)),
        "score_repeat_bitwise_equal": bool(torch.equal(ell, ell2) and torch.equal(sum_o, sum_o2)
                                           and torch.equal(mu_s, mu_s2)),
        "sums_equal_without_mu": bool(torch.equal(ell, ell0) and torch.equal(sum_o, sum_o0)),
        "score_mu_equals_depth_mu": bool(torch.equal(mu_s, mu_k)),
        "plain_mu_same": bool(torch.equal(mu_sr, mu_r)),
        "score_max_abs_err": float(max((ell - ell_r).abs().max(), (sum_o - sum_o_r).abs().max())),
        "finite": bool(torch.isfinite(mu_k).all() and torch.isfinite(ell).all()),
    }
    res["ok"] = (res["coverage_identical"] and res["covered_fraction"] > 0.02
                 and res["mu_max_rel"] <= MU_REL_TOL and res["depth_repeat_bitwise_equal"]
                 and res["score_repeat_bitwise_equal"] and res["sums_equal_without_mu"]
                 and res["score_mu_equals_depth_mu"] and res["plain_mu_same"] and res["finite"]
                 and bool(torch.allclose(ell, ell_r, **TOL))
                 and bool(torch.allclose(sum_o, sum_o_r, **TOL)))
    return res


def depth_layout_check(device, failures, n_poses=64, seed=3):
    """Phase 5: scripts/verify_depth_layout.py's kernel check through the
    port. Returns the launches by kernel that the phase made."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch import quaternions as quat
    from bayesianposeestimation.jl_tpu_torch.camera import CvCamera, crop_camera
    from bayesianposeestimation.jl_tpu_torch.models.fused import make_score_fn
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
        mesh_tensors,
        render_depth,
        render_score,
    )
    from bayesianposeestimation.jl_tpu_torch.ops.rasterize import render_depth_batch
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
    from bayesianposeestimation.jl_tpu_torch.utils import mesh_io

    render_score.launches = render_depth.launches = 0
    render_score.launches_by.clear()
    mesh = mesh_io.monkey_mesh(0.08)
    verts, faces = mesh_tensors(mesh.vertices, mesh.faces, device)
    base = CvCamera(width=640, height=480, f_x=600.0, f_y=600.0, c_x=319.5, c_y=239.5,
                    near=0.01, far=10.0)
    gen = torch.Generator(device=device).manual_seed(seed)
    q = quat.rand_quaternion(gen, (n_poses,)).contiguous()
    t = (torch.tensor([0.0, 0.0, 1.0], device=device)
         + 0.03 * torch.randn((n_poses, 3), generator=gen, device=device)).contiguous()
    for res in (30, 50):
        cam = crop_camera(base, np.array([0.0, 0.0, 1.0]), mesh_io.mesh_diameter(mesh),
                          width=res, height=res)
        ref = render_depth_batch(verts, faces, cam, t, q)
        d = render_depth(verts, faces, cam, t, q, device=device)
        mism = float(((ref > 0) != (d > 0)).float().mean())
        both = (ref > 0) & (d > 0)
        rel = ((d - ref).abs() / ref.clamp(min=1e-30))[both]
        p99 = float(torch.quantile(rel, 0.99))
        print(f"phase 5 res {res}: render_depth vs dense rasteriser, {n_poses} poses: coverage "
              f"mismatch {mism:.2e} (limit 5e-3), relative depth p99 {p99:.2e} (limit 1e-4) "
              f"max {float(rel.max()):.2e}")
        if not (mism < 5e-3 and p99 < 1e-4):
            failures.append(f"phase 5 render_depth vs dense rasteriser at {res} px")

        # the fused score, recomputed by the plain score function from the
        # image the kernel wrote, against the kernel's own sums
        params = Parameters(width=res, height=res, device=str(device))
        z = torch.where(d[0] > 0, d[0], torch.full_like(d[0], torch.inf)).contiguous()
        for variant in ("association", "simple"):
            ell, sum_o, mu = render_score(verts, faces, cam, t, q, z, 0.7, params, variant,
                                          device=device, return_mu=True)
            prior = torch.full((res * res,), 0.7, device=device)
            ell_px, o = make_score_fn(params, variant)(mu.reshape(n_poses, -1), z.reshape(-1),
                                                       prior)
            err_ell = float(((ell_px.sum(-1) - ell).abs() / ell.abs()).max())
            err_o = float((o.expand_as(ell_px).sum(-1) - sum_o).abs().max())
            same = bool(torch.equal(mu, d))
            print(f"phase 5 res {res} {variant}: score from the written image vs the kernel's "
                  f"sums: ell relative {err_ell:.2e} (limit 1e-4), sum_o abs {err_o:.2e}; "
                  f"image equals render_depth's bitwise: {same}")
            if not (err_ell < 1e-4 and err_o < 1e-2 and same):
                failures.append(f"phase 5 score from mu at {res} px ({variant})")
    counts = dict(render_score.launches_by, render_depth=render_depth.launches)
    print(f"phase 5 kernel launches: {json.dumps(counts)}")
    return counts


def tracker_script():
    sys.path.insert(0, str(REPO / "scripts"))
    import torch_ros_particle_filter

    return torch_ros_particle_filter


def track_filter(kind, stream, mesh, device, failures, smi, evals, width=80, height=60,
                 n_particles=None, n_check=200, with_events=False, phase="6"):
    """One filter of scripts/torch_ros_particle_filter.py on a stream (the
    script's set-up: decimation, camera and frames at width x height): a
    warm-up and three timed runs, the script's error gate, launches =
    likelihood evaluations = 4 (1 + k (F - 1)) (k = 2 for the coordinate
    filter), the final densities against the plain version on the CPU.
    Returns (the render_score launches, the kernel's arguments for the final
    particles on the last frame)."""
    import statistics

    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch.models.particle_filter import (
        bootstrap_pf,
        coordinate_pf,
        fused_pf_posterior,
    )
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_score

    track = tracker_script()
    pf, per_frame = (coordinate_pf, 2) if kind == "coordinate" else (bootstrap_pf, 1)
    posterior_fn = fused_pf_posterior("simple")
    params = track.filter_params(kind, width, height, n_particles, device)
    experiment, depth, small = track.tracking_setup(stream, mesh, params, device)
    frames = depth.shape[0] - 1
    launches0, evals0 = render_score.launches, evals.n
    outs, final, first, runs = track.timed_runs(pf, posterior_fn, params, experiment, depth,
                                                device)
    launches, n_evals = render_score.launches - launches0, evals.n - evals0
    expected = 4 * (1 + per_frame * frames)  # warm-up + three timed runs
    res = track.tracking_errors(*track.pose_estimates(outs), stream, with_events)
    finite = all(bool(torch.isfinite(v).all()) for v in outs.values())

    # final particles re-evaluated by the plain version on the CPU
    s = final.sample
    cpu_post = posterior_fn(params, experiment.with_depth_image(depth[-1].cpu()), device="cpu")
    cpu_sample = type(s)({k: v[:n_check].cpu() for k, v in s.variables.items()})
    ll_cpu = cpu_post.logdensity_sample(cpu_sample).log_like.numpy()
    ll_dev = s.log_like[:n_check].cpu().numpy()
    dens_ok = bool(np.allclose(ll_dev, ll_cpu, rtol=1e-3, atol=0.2))

    med = statistics.median(runs)
    tag = f"{kind}{' +events' if with_events else ''}"
    print(f"phase {phase} {tag}: {params.n_particles} particles, {small.n_faces}-face mesh, "
          f"{frames} frames at {width}x{height} on {smi}: first run {first:.4f} s, timed "
          f"runs {[round(r, 4) for r in runs]} s -> {frames / med:.2f} fps, "
          f"{med / frames * 1e3:.4f} ms per frame (sensor: {track.SENSOR_HZ} Hz, "
          f"{1e3 / track.SENSOR_HZ:.2f} ms per frame; not gated); launches {launches} "
          f"evaluations {n_evals} expected {expected}; median error "
          f"{res['median_error_mm']:.3f} mm, {res['median_rot_deg']:.3f} deg; recovery "
          f"{json.dumps(res['recovery'])}; gate {res['ok']}; final densities vs plain "
          f"({len(ll_cpu)} particles) max |d| {float(np.max(np.abs(ll_dev - ll_cpu))):.5f}")
    if not res["ok"]:
        failures.append(f"phase {phase} {tag}: tracking gate")
    if not finite:
        failures.append(f"phase {phase} {tag}: non-finite outputs")
    if not launches == n_evals == expected:
        failures.append(f"phase {phase} {tag}: launches {launches} vs evaluations {n_evals} "
                        f"vs expected {expected}")
    if not dens_ok:
        failures.append(f"phase {phase} {tag}: densities vs plain version")
    post = posterior_fn(params, experiment.with_depth_image(depth[-1]), device=device)
    args = (post.verts, post.faces, post.camera, s.variables["t"].contiguous(),
            s.variables["r"].contiguous(), post.depth, post.prior_o, params)
    return launches, args


def tracking_phase(device, failures, smi, n_frames=TRACK_FRAMES, width=80, height=60,
                   n_particles=None, n_check=200):
    """Phase 6: scripts/torch_ros_particle_filter.py's streams and filters.
    ``n_particles``: None for the script's 600 / 1250, or a number for both
    filters (a CPU rehearsal). Returns the launches by kernel of the phase."""
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_depth, render_score

    track = tracker_script()
    render_score.launches = render_depth.launches = 0
    render_score.launches_by.clear()
    t0 = time.perf_counter()
    streams = {ev: track.synthetic_stream(n_frames, width, height, with_events=ev, device=device)
               for ev in (False, True)}
    print(f"phase 6 streams: 2 x {n_frames} frames at {width}x{height} rendered by render_depth "
          f"({render_depth.launches} launches) in {time.perf_counter() - t0:.2f} s; object "
          f"covers {float((streams[False][0]['depth'][0] < 1.0).mean()):.3f} of frame 0")
    with EvaluationCount() as evals:
        for kind, with_events in (("coordinate", False), ("bootstrap", False),
                                  ("coordinate", True)):
            track_filter(kind, *streams[with_events], device, failures, smi, evals, width,
                         height, n_particles, n_check, with_events)
    counts = dict(render_score.launches_by, render_depth=render_depth.launches)
    print(f"phase 6 kernel launches: {json.dumps(counts)}")
    return counts


BOP_DIR = REPO / "data/bop"
JAX_RAW = REPO / "data/exp_raw/smc_bop_cad"  # the JAX package's synthcad val estimates
BOP_SAMPLERS = ("smc_mh", "mh_sampler", "mtm_sampler")
BOP_SCENES = tuple(range(1, 19))
# the BOP splits whose JAX estimates and errors are checked in: synthcad val
# (phase 7; its CAD models of 81,920-128,000 faces, object 1 the evaluation
# shape) and the hardvis split of the synth set (phase 10; the 1,280 / 12 /
# 320-face synth models at purpose-built low visibility, object 3 in both
# scenes), whose recalls must equal sampler_recall.csv to every digit
SYNTHCAD = dict(dataset="synthcad", testset="val", experiment="smc_bop_cad",
                scenes=BOP_SCENES, obj_id=1, phase="7a", exact_recall=False)
HARDVIS = dict(dataset="synth", testset="hardvis", experiment="hard_cases_vis", scenes=(1, 2),
               obj_id=3, phase="10", exact_recall=True)
ADDS_REL_TOL = 1e-4  # ADD-S, relative
VSD_ABS_TOL = 0.01  # VSD and every VSDBOP tau, absolute (a few pixels of a crop)
THETA_MARGIN = 0.01  # entries this close to a threshold may pass on one side only


def bop_val_script():
    sys.path.insert(0, str(REPO / "scripts"))
    import torch_smc_bop_val

    return torch_smc_bop_val


def compare_errors(ours, ref, adds_tol=ADDS_REL_TOL, vsd_tol=VSD_ABS_TOL):
    """The port's matched errors of one scene against the JAX package's:
    (list of failed checks, max ADD-S relative |d|, max VSD / VSDBOP |d|, the
    number of entries within THETA_MARGIN of a threshold). Visibilities are
    compared where the JAX errors store them."""
    import numpy as np

    from bayesianposeestimation.jl_tpu_torch.utils import evaluation as ev

    bad = []
    if "visib" in ref and not np.array_equal(ours["visib"], ref["visib"]):
        bad.append("visib")
    worst = {"adds": 0.0, "vsd": 0.0}
    near_total = 0
    for key, theta in (("adds", ev.ADDS_THETA), ("vsd", ev.BOP18_THETA),
                       ("vsdbop", np.asarray(ev.BOP19_THRESHOLDS))):
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        if a.shape != b.shape or not np.array_equal(np.isinf(a), np.isinf(b)):
            bad.append(f"{key} shape or unmatched gts")
            continue
        fin = np.isfinite(b)
        d = np.abs(a - b)[fin]
        if key == "adds":
            rel = d / np.maximum(np.abs(b[fin]), 1e-30)
            worst["adds"] = max(worst["adds"], float(rel.max(initial=0.0)))
            if rel.max(initial=0.0) > adds_tol:
                bad.append(f"adds relative {rel.max():.3g}")
        else:
            worst["vsd"] = max(worst["vsd"], float(d.max(initial=0.0)))
            if d.max(initial=0.0) > vsd_tol:
                bad.append(f"{key} |d| {d.max():.3g}")
        near = np.abs(b - theta) < THETA_MARGIN
        near_total += int(near.sum())
        if ((a < theta) != (b < theta))[~near].any():
            bad.append(f"{key} counts under the threshold")
    return bad, worst["adds"], worst["vsd"], near_total


def evaluation_depth_args(device, dataset="synthcad", testset="val", obj_id=1, raw=JAX_RAW):
    """render_depth's inputs at the evaluation's shape: the model of
    ``obj_id`` (synthcad object 1: 81,920 faces), the JAX smc_mh estimates
    (artifacts in ``raw``) of scene 1's first image of it and its ground
    truth, in the evaluation's 100x100 crop (draw every face:
    ``backface_cull=False``)."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch import quaternions as quat
    from bayesianposeestimation.jl_tpu_torch.camera import crop_camera
    from bayesianposeestimation.jl_tpu_torch.utils import bop
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import load_artifact

    bopval = bop_val_script()
    scene_rows = bop.bop_test_or_train(BOP_DIR, dataset, testset, 1)
    rows = load_artifact(raw / f"dataset={dataset},sampler=smc_mh,scene_id=1,testset={testset}.npz")
    g = next(r for r in scene_rows if r["obj_id"] == obj_id)
    ests = [r for r in rows["result_rows"]
            if (r["img_id"], r["obj_id"]) == (g["img_id"], obj_id)]
    mesh = bop.load_mesh(g)
    verts = torch.as_tensor(mesh.vertices, device=device)
    faces = torch.as_tensor(mesh.faces, device=device)
    cam = crop_camera(bop.camera_for_row(g), np.asarray(g["gt_t"], np.float32),
                      bop.model_diameter(g), width=bopval.EVAL_CROP, height=bopval.EVAL_CROP)
    t = torch.as_tensor(np.stack([np.asarray(e["t"], np.float32) for e in ests]
                                 + [np.asarray(g["gt_t"], np.float32)]), device=device)
    q = torch.cat([torch.as_tensor(np.stack([np.asarray(e["q"], np.float32) for e in ests]),
                                   device=device),
                   quat.matrix_to_quat(torch.as_tensor(np.asarray(g["gt_R"], np.float32),
                                                       device=device))[None]])
    return verts, faces, cam, t.contiguous(), q.contiguous()


def render_depth_check(device, smi, args, label="7a", backface_cull=False,
                       shape="the evaluation shape"):
    """render_depth at an evaluation's shape (``evaluation_depth_args``;
    every face drawn unless ``backface_cull``), each compared launch written
    over NaN, against its plain version and against one block per pose
    (``face_slices`` 1): both bitwise equal; then both plans timed (ok needs
    the automatic plan's device time). Returns (ok, timing row of the
    automatic plan, the one-block plan's (ms, device ms), the automatic
    plan's face slices)."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
        launch_plan,
        render_depth,
        render_depth_reference,
    )

    verts, faces, cam, t = args[:4]
    one = {"face_slices": 1}
    plan = launch_plan(verts.shape[0], faces.shape[0], cam.height, cam.width, t.shape[0],
                       depth_only=True)
    draw = functools.partial(render_depth, *args, backface_cull=backface_cull, device=device)
    d, fresh = on_nan_block(draw)
    d1, fresh1 = on_nan_block(lambda: draw(tuning=one))
    ref = render_depth_reference(*args, backface_cull=backface_cull)
    torch.cuda.synchronize()
    both = (d > 0) & (ref > 0)
    rel = float(((d - ref).abs() / ref.clamp(min=1e-30))[both].max())
    bitwise = fresh and bool(torch.equal(d, ref))
    single = fresh1 and bool(torch.equal(d, d1))
    sync = torch.cuda.synchronize
    times = {}
    for name, tuning in (("auto", None), ("one", one), ("one again", one), ("auto again", None)):
        run = functools.partial(draw, tuning=tuning)
        times[name] = (time_ms(run, 50, sync), device_ms(run, 20))
    ms, dev_ms = min(times["auto"][0], times["auto again"][0]), times["auto"][1]
    ms1, dev_ms1 = min(times["one"][0], times["one again"][0]), times["one"][1]
    plain_ms = time_ms(lambda: render_depth_reference(*args, backface_cull=backface_cull), 3,
                       sync)
    b_ms, b_by, ops, pairs = bound_ms(args, epilogue="depth")
    drawn = "front faces" if backface_cull else "every face drawn"
    print(f"phase {label} render_depth at {shape} ({faces.shape[0]} faces, "
          f"{cam.width}x{cam.height}, {t.shape[0]} poses, {drawn}): "
          f"{plan['face_slices']} face slices of up to {plan['face_cap']} faces "
          f"({t.shape[0] * plan['face_slices']} blocks of {plan['threads']} threads, "
          f"{plan['smem_bytes']} B of shared memory each); written over NaN {fresh and fresh1}, "
          f"bitwise equal to the plain version {bitwise}, to one block per pose {single} "
          f"(relative depth max {rel:.2e}); "
          f"kernel {ms:.4f} ms (CUDA events over 50 calls), device {dev_ms} ms (profiler); one "
          f"block per pose {ms1:.4f} ms, device {dev_ms1} ms (in the order split, one, one, "
          f"split: {json.dumps(times)}); plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
          f"({b_by}, {ops / 1e6:.3f} M ops, {pairs} front-face triangle-pixel pairs), "
          f"{share_of_bound(b_ms, ms, dev_ms)} on {smi}")
    return (bitwise and single and dev_ms is not None), \
        (ms, dev_ms, plain_ms, b_ms, b_by, rel), (ms1, dev_ms1), plan["face_slices"]


def bop_eval_parity(device, failures, smi, split=SYNTHCAD):
    """Phase 7a (10 for the hardvis split): the port's evaluate_scene on the
    JAX package's checked-in estimates of a split (every scene and MCMC/SMC
    sampler) against the JAX package's checked-in errors, and the recall per
    sampler beside sampler_recall.csv. Returns the render_depth launches of
    the evaluation and, after its verdict, what render_depth_check returns."""
    import csv

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_depth
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import load_artifact, savename

    bopval = bop_val_script()
    params = Parameters(device=device)
    phase, scenes = split["phase"], split["scenes"]
    raw_dir = REPO / "data/exp_raw" / split["experiment"]
    pro_dir = REPO / "data/exp_pro" / split["experiment"]
    cache = {}
    ours, refs = {}, {}
    worst_adds = worst_vsd = 0.0
    near = 0
    t0 = time.perf_counter()
    render_depth.launches = 0
    for sampler in BOP_SAMPLERS:
        for scene in scenes:
            name = savename(dict(dataset=split["dataset"], sampler=sampler, scene_id=scene,
                                 testset=split["testset"])) + ".npz"
            raw = load_artifact(raw_dir / name)
            ref = load_artifact(pro_dir / "errors" / name)
            got = bopval.evaluate_scene(raw["__config__"], str(BOP_DIR), params,
                                        list(raw["result_rows"]), device, cache)
            bad, w_adds, w_vsd, n_near = compare_errors(got, ref)
            worst_adds, worst_vsd, near = max(worst_adds, w_adds), max(worst_vsd, w_vsd), near + n_near
            if bad:
                failures.append(f"phase {phase} {sampler} scene {scene}: {bad}")
                print(f"phase {phase} {sampler} scene {scene}: FAILED {bad}")
            ours.setdefault(sampler, []).append(got)
            refs.setdefault(sampler, []).append(ref)
    launches = render_depth.launches
    dt = time.perf_counter() - t0
    print(f"phase {phase} evaluation of the JAX estimates of {split['dataset']} "
          f"{split['testset']} ({len(BOP_SAMPLERS)} samplers x {len(scenes)} scenes) on the "
          f"card: {dt:.2f} s, render_depth launches {launches}; "
          f"max ADD-S relative |d| {worst_adds:.3g} (limit {ADDS_REL_TOL}), max VSD/VSDBOP |d| "
          f"{worst_vsd:.4f} (limit {VSD_ABS_TOL}); {near} entries within {THETA_MARGIN} of a "
          f"threshold")
    with open(pro_dir / "sampler_recall.csv", newline="") as fh:
        csv_rows = {r["sampler"]: r for r in csv.DictReader(fh)}
    mine, _ = bopval.recall_rows(ours)
    for r in mine:
        want = csv_rows[r["sampler"]]
        line = ", ".join(f"{k} {r[k]!r} vs {want[k]}"
                         for k in ("vsd_recall", "adds_recall", "vsdbop_recall"))
        print(f"phase {phase} recall {r['sampler']} (n={r['n_gt']}), port vs "
              f"sampler_recall.csv: {line}")
        if split["exact_recall"]:
            for k in ("vsd_recall", "adds_recall", "vsdbop_recall"):
                if r[k] != float(want[k]):
                    failures.append(f"phase {phase} {r['sampler']} {k}")
        # counts agree up to the near-threshold entries, so the recalls do too
        for k in ("vsd_recall", "adds_recall"):
            if abs(r[k] - float(want[k])) * r["n_gt"] > near + 1e-9:
                failures.append(f"phase {phase} {r['sampler']} {k}")
    args = evaluation_depth_args(device, split["dataset"], split["testset"], split["obj_id"],
                                 raw_dir)
    ok, timing, one_block, slices = render_depth_check(device, smi, args, phase)
    if not ok:
        failures.append(f"phase {phase} render_depth at the evaluation shape: vs plain, vs one "
                        "block per pose, or no device time")
    return launches, timing, one_block, slices


class RunnerLog:
    """Records every call of the chain runners that
    ``models.fused.make_conditioned_chain`` builds while in use: the mesh,
    the call's inputs and outputs, and the kernel launches and likelihood
    evaluations it made."""

    def __init__(self, evals):
        self.evals = evals
        self.calls = []

    def __enter__(self):
        from bayesianposeestimation.jl_tpu_torch.models import fused
        from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_score

        self._inner = inner = fused.make_conditioned_chain

        def make(params, verts, faces, variant, factory, n_steps, *a, **kw):
            run = inner(params, verts, faces, variant, factory, n_steps, *a, **kw)

            def logged(seed, cam, obs, prior_o, prior_t, *rest, **kw):
                l0, e0 = render_score.launches, self.evals.n
                out = run(seed, cam, obs, prior_o, prior_t, *rest, **kw)
                self.calls.append(dict(seed=seed, params=params, verts=verts, faces=faces,
                                       n_steps=kw.get("n_steps") or n_steps,
                                       variant=variant, args=(cam, obs, prior_o, prior_t),
                                       rest=rest, out=out,
                                       launches=render_score.launches - l0,
                                       evals=self.evals.n - e0))
                return out

            logged.runners = run.runners  # its captured chains, which make_tuned_chain reads
            return logged

        fused.make_conditioned_chain = make
        return self

    def __exit__(self, *exc):
        from bayesianposeestimation.jl_tpu_torch.models import fused

        fused.make_conditioned_chain = self._inner


def bop_inference(device, failures, smi, scene=1, split=SYNTHCAD, samplers=BOP_SAMPLERS,
                  phase="7b"):
    """Phase 7b (and 10): scripts/torch_smc_bop_val.py's scene_inference on
    scene 1 of a split for each sampler at the 0.5 s budget, then
    evaluate_scene on the port's own estimates. Returns the render_score
    launches per sampler."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch.models.fused import fused_posterior
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_score
    from bayesianposeestimation.jl_tpu_torch.parameters import Experiment, Parameters
    from bayesianposeestimation.jl_tpu_torch.samples import Sample
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import load_artifact, savename

    bopval = bop_val_script()
    launches = {}
    cache = {}
    for sampler in samplers:
        config = dict(sampler=sampler, dataset=split["dataset"], testset=split["testset"],
                      scene_id=scene)
        tries = bopval.MCMC_TRIES if bopval.is_mcmc(sampler) else 100
        params = Parameters(n_particles=tries, time_budget=TIME_BUDGET, device=device,
                            **bopval.tuned_parameters(split["dataset"], sampler))
        per_step = 2 if sampler.startswith("mtm") else 1
        render_score.launches = 0
        t0 = time.perf_counter()
        with EvaluationCount() as evals, RunnerLog(evals) as log:
            result = bopval.scene_inference(config, str(BOP_DIR), params, device)
        dt = time.perf_counter() - t0
        launches[sampler] = render_score.launches
        rows = result["result_rows"]
        # the script seeds row i's run with seed + i, its warm-up and
        # feedback runs with seed + 10**6 and up
        seed0 = params.seed % (2**31)
        timed = [c for c in log.calls if c["seed"] < seed0 + 10**6]
        if len(timed) != len(rows):
            failures.append(f"phase {phase} {sampler}: {len(timed)} runs for {len(rows)} rows")
        finite = all(np.isfinite(r["t"]).all() and np.isfinite(r["q"]).all()
                     and np.isfinite(r["score"]) for r in rows)
        if not finite:
            failures.append(f"phase {phase} {sampler}: non-finite estimates")
        wrong = [(c["launches"], c["evals"], c["n_steps"]) for c in log.calls
                 if not c["launches"] == c["evals"] == 1 + per_step * (c["n_steps"] - 1)]
        if wrong or render_score.launches != evals.n:
            failures.append(f"phase {phase} {sampler}: launches vs evaluations {wrong[:3]}, total "
                            f"{render_score.launches} vs {evals.n}")
        # the best pose's likelihood, re-evaluated by the plain version
        worst = 0.0
        for r, c in zip(rows, timed):
            cam, obs, prior_o, prior_t = c["args"]
            exp = Experiment(scene={"camera": cam, "verts": c["verts"], "faces": c["faces"]},
                             prior_o=torch.as_tensor(prior_o), prior_t=prior_t,
                             depth_image=torch.as_tensor(obs))
            post = fused_posterior(c["params"], exp, c["variant"], device="cpu")
            ll = float(post.logdensity_sample(Sample({
                "t": torch.as_tensor(r["t"])[None], "r": torch.as_tensor(r["q"])[None]})).log_like)
            worst = max(worst, abs(ll - r["score"]))
            if not np.isclose(r["score"], ll, rtol=1e-3, atol=0.2):
                failures.append(f"phase {phase} {sampler} img {r['img_id']}: best log_like "
                                f"{r['score']} vs plain {ll}")
        walls = [r["time"] for r in rows]
        steps = {k: v["n_steps"] for k, v in result["calibration"].items()}
        step_ms = {k: round(v["step_time"] * 1e3, 4) for k, v in result["calibration"].items()}
        t1 = time.perf_counter()
        errors = bopval.evaluate_scene(config, str(BOP_DIR), params, rows, device, cache)
        t_eval = time.perf_counter() - t1
        jax_err = load_artifact(REPO / "data/exp_pro" / split["experiment"] / "errors"
                                / (savename(config) + ".npz"))
        mine, _ = bopval.recall_rows({"port": [errors], "jax": [jax_err]})
        rec = {r["sampler"]: r for r in mine}
        print(f"phase {phase} {sampler} scene {scene} ({len(rows)} rows, {tries} "
              f"{'tries' if tries == 10 else 'particles'}) on {smi}: {dt:.2f} s in all; steps "
              f"per {TIME_BUDGET} s budget by object {json.dumps(steps)} (step ms "
              f"{json.dumps(step_ms)}); wall per pose mean {np.mean(walls):.4f} s max "
              f"{np.max(walls):.4f} s; launches {render_score.launches} = evaluations {evals.n}; "
              f"best log_like vs plain max |d| {worst:.4f}; evaluation {t_eval:.2f} s; VSD recall "
              f"{rec['port']['vsd_recall']:.3f} (JAX artifact {rec['jax']['vsd_recall']:.3f}), "
              f"ADD-S {rec['port']['adds_recall']:.3f} (JAX {rec['jax']['adds_recall']:.3f}), "
              f"n={rec['port']['n_gt']}")
    return launches


def bop_kernel_rows(device, smi, dataset="synthcad", obj_id=1, poses=(100, 1, 10, 9),
                    phase="7", testset="val"):
    """render_score[association] at the BOP sweep's shapes (the 30x30 crop of
    the first scene-1 image of ``obj_id``; synthcad object 1 decimated to
    1,800 faces) for the pose batches of its samplers: SMC-MH 100, MH 1, MTM
    10 tries and 9 auxiliary tries. Each against its plain version and timed;
    returns the rows by pose count."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch import quaternions as quat
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
    from bayesianposeestimation.jl_tpu_torch.utils import bop
    from bayesianposeestimation.jl_tpu_torch.utils.experiment_io import load_img_mesh

    bopval = bop_val_script()
    params = Parameters(device=device, **bopval.tuned_parameters(dataset))
    row = next(r for r in bop.bop_test_or_train(BOP_DIR, dataset, testset, 1)
               if r["obj_id"] == obj_id)
    cam, obs, prior_o, prior_t = bopval.image_inputs(row, params, "mask", "mask", None)
    mesh = load_img_mesh(row, params)[2]
    verts = torch.as_tensor(mesh.vertices, device=device)
    faces = torch.as_tensor(mesh.faces, device=device)
    z = torch.as_tensor(np.where(obs > 0, obs, np.inf).astype(np.float32),
                        device=device).contiguous()
    prior = torch.as_tensor(prior_o, device=device).contiguous()
    gen = torch.Generator(device=device).manual_seed(5)
    out = {}
    for n in poses:
        t = (torch.as_tensor(prior_t, device=device)
             + 0.01 * torch.randn((n, 3), generator=gen, device=device)).contiguous()
        q = quat.rand_quaternion(gen, (n,)).contiguous()
        args = (verts, faces, cam, t, q, z, prior, params)
        row, res = score_row(args, device, f"phase {phase} render_score[association] at the "
                             f"{dataset} {testset} BOP shape, object {obj_id}", smi)
        out[n] = (*row, dict(res, faces=mesh.n_faces))
    return out


def bench_phase(failures, smi):
    """Phase 8: ``python3 bench_torch.py`` as a user runs it: rc 0, exactly
    one JSON line on stdout with bench.py's keys and ``device``, a positive
    value. Returns (the JSON record, its launches record from stderr)."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, str(REPO / "bench_torch.py")],
                              capture_output=True, text=True, timeout=300, cwd=REPO)
    except subprocess.TimeoutExpired:
        failures.append("phase 8 bench_torch.py: no result in 300 s")
        return {}, {}
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    result, record = {}, {}
    try:
        result = json.loads(lines[0]) if len(lines) == 1 else {}
        record = json.loads(proc.stderr.split("bench_torch: ", 1)[1].splitlines()[0])
    except (IndexError, ValueError):
        pass
    keys_ok = set(result) == {"metric", "value", "unit", "vs_baseline", "device"}
    if not (proc.returncode == 0 and len(lines) == 1 and keys_ok and result["value"] > 0):
        failures.append(f"phase 8 bench_torch.py: rc {proc.returncode}, {len(lines)} stdout "
                        f"lines, keys ok {keys_ok}")
        print(f"phase 8 bench_torch.py stdout {proc.stdout[-2000:]!r} stderr "
              f"{proc.stderr[-2000:]!r}")
    print(f"phase 8 bench_torch.py ({time.perf_counter() - t0:.1f} s): {json.dumps(result)}; "
          f"{json.dumps(record)}; on {smi}")
    return result, record


def write_obj(path, mesh):
    """The mesh as a Wavefront OBJ (vertices to float32 precision)."""
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in mesh.vertices.tolist()]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in mesh.faces.tolist()]
    Path(path).write_text("\n".join(lines) + "\n")


def bop_submission(device, failures, smi):
    """Phase 9: scripts/torch_smc_bop_test.py on synth val scene 1 into a
    temporary directory: the CSV's header and (scene_id, im_id, obj_id)
    rows those of data/smc_mh_synth-val.csv, every R orthonormal with
    determinant +1, every row's time its image's sum, launches = likelihood
    evaluations. Then render_score[association] at 100 poses on each synth
    model's 30x30 crop against its plain version, timed. Returns ({faces:
    kernel row}, {faces: launches})."""
    import csv
    import tempfile

    import numpy as np

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_score
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters

    sys.path.insert(0, str(REPO / "scripts"))
    import torch_smc_bop_test as sub

    bopval = bop_val_script()
    params = Parameters(n_particles=100, time_budget=TIME_BUDGET, device=device,
                        **bopval.tuned_parameters("synth", "smc_mh"))
    render_score.launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, EvaluationCount() as evals, \
            RunnerLog(evals) as log:
        [result] = sub.scene_results([1], "synth", "val", "smc_mh", params, str(BOP_DIR),
                                     Path(tmp), device)
    launches, n_evals = render_score.launches, evals.n
    rows = result["result_rows"]
    lines = [sub.HEADER] + sub.submission_lines(rows)
    ref = (REPO / "data/smc_mh_synth-val.csv").read_text().splitlines()
    bad = []
    if lines[0] != ref[0]:
        bad.append("header")
    parsed = list(csv.reader(lines[1:]))
    if [p[:3] for p in parsed] != [r[:3] for r in csv.reader(ref[1:])]:
        bad.append("(scene_id, im_id, obj_id) rows")
    worst = 0.0
    img_time = {}
    for r in rows:
        img_time[r["img_id"]] = img_time.get(r["img_id"], 0.0) + r["time"]
    for p in parsed:
        R = np.asarray(p[4].split(), float).reshape(3, 3)
        worst = max(worst, float(np.abs(R.T @ R - np.eye(3)).max()))
        if not (np.abs(R.T @ R - np.eye(3)).max() <= 1e-5 and np.linalg.det(R) > 0):
            bad.append(f"R of im {p[1]} obj {p[2]}")
        if p[6] != f"{img_time[int(p[1])]:.4f}":
            bad.append(f"time of im {p[1]}")
        if len(p[5].split()) != 3 or not np.isfinite(np.asarray(p[5].split(), float)).all():
            bad.append(f"t of im {p[1]}")
    if not launches == n_evals > 0:
        bad.append(f"launches {launches} vs evaluations {n_evals}")
    if bad:
        failures.append(f"phase 9 BOP submission: {bad}")
    steps = {k: v["n_steps"] for k, v in result["calibration"].items()}
    walls = [r["time"] for r in rows]
    by_faces = {}  # the chain runs' launches by mesh, as the kernel rows below key them
    for c in log.calls:
        n = int(c["faces"].shape[0])
        by_faces[n] = by_faces.get(n, 0) + c["launches"]
    print(f"phase 9 BOP submission CSV (synth val scene 1, smc_mh, {len(rows)} rows) on {smi}: "
          f"{time.perf_counter() - t0:.2f} s; failed checks {bad}; max |RtR - I| {worst:.2e}; "
          f"steps per {TIME_BUDGET} s budget by object {json.dumps(steps)}; wall per pose mean "
          f"{np.mean(walls):.4f} s max {np.max(walls):.4f} s; launches {launches} = evaluations "
          f"{n_evals}, by mesh faces {json.dumps(by_faces)}")
    kernel_rows = {}
    for obj in (1, 2, 3):
        row = bop_kernel_rows(device, smi, "synth", obj, (100,), "9")[100]
        if not row[5]["ok"]:
            failures.append(f"phase 9 render_score at the synth BOP shape, object {obj}")
        kernel_rows[obj] = row
    return kernel_rows, by_faces


def hardvis_phase(device, failures, smi):
    """Phase 10: the hardvis split of data/bop/synth. The port's evaluation
    of the JAX package's six checked-in estimate artifacts under phase 7a's
    gates, with recalls equal to sampler_recall.csv to every digit,
    render_depth at its evaluation shape (the 320-face icosphere) bitwise
    against its plain version and timed, then smc_mh inference on scene 1
    at the 0.5 s budget, and render_score[association] at that inference's
    shape (the icosphere's crop in the first hardvis scene-1 image, 100
    poses) against its plain version and timed. Returns (render_depth
    launches of the evaluation, its timing row, render_score launches of the
    inference, the render_score row)."""
    launches, timing, _, _ = bop_eval_parity(device, failures, smi, HARDVIS)
    phase_launches = bop_inference(device, failures, smi, 1, HARDVIS, ("smc_mh",), "10")
    row = bop_kernel_rows(device, smi, "synth", HARDVIS["obj_id"], (100,), "10", "hardvis")[100]
    if not row[-1]["ok"] or row[1] is None:
        failures.append("phase 10 render_score at the hardvis shape: vs plain, or no device "
                        "time")
    return launches, timing, phase_launches["smc_mh"], row


def inference_time_phase(device, failures, smi, resolutions=(25, 50, 100),
                         particles=(2, 100, 1000)):
    """Phase 11: scripts/torch_inference_time.py's grid at 3 x 3 of its 21
    points (ms per step printed), then render_score[association] at 1,000
    poses x 100x100, the largest point, against its plain version with phase
    2's tolerances and timed. Returns (launches at that point, its timing
    row, its comparison)."""
    import torch

    from bayesianposeestimation.jl_tpu_torch import quaternions as quat
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_score

    sys.path.insert(0, str(REPO / "scripts"))
    import torch_inference_time as it

    t0 = time.perf_counter()
    launches = {}
    for res in resolutions:
        for n in particles:
            render_score.launches = 0
            [row] = it.grid_rows("monkey", [res], [n], device)
            launches[(res, n)] = render_score.launches
            print(f"phase 11 inference time {res}x{res}, {n} particles: "
                  f"{row['step_time_ms']:.4f} ms per step, {row['hyp_per_s']:.1f} hyp/s, "
                  f"{launches[(res, n)]} launches on {smi}")
    params, exp = it.scene("monkey", max(resolutions), device)
    n = max(particles)
    gen = torch.Generator(device=device).manual_seed(11)
    t = (exp.prior_t + 0.02 * torch.randn((n, 3), generator=gen, device=device)).contiguous()
    q = quat.qplus(torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).expand(n, 4),
                   0.3 * torch.randn((n, 3), generator=gen, device=device)).contiguous()
    z = torch.where(exp.depth_image > 0, exp.depth_image,
                    torch.full_like(exp.depth_image, float("inf"))).contiguous()
    s = exp.scene
    args = (s["verts"], s["faces"], s["camera"], t, q, z, 0.7, params)
    row, res_cmp = score_row(args, device, "phase 11 render_score[association] at the grid's "
                             "largest point", smi, calls=(50, 2, 20))
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s")
    if not res_cmp["ok"] or row[1] is None:
        failures.append("phase 11 render_score at 1000 poses x 100x100: vs plain, or no "
                        "device time")
    return launches[(max(resolutions), n)], row, res_cmp


def stream_messages(stream, stamp0_ns=1_700_000_000 * 10**9):
    """A depth stream as ROS messages: camera info, then per frame a 16UC1
    image (millimetres) and the ground-truth pose, at the 90 Hz sensor's
    stamps."""
    import numpy as np

    cam = stream["camera"]
    K = [cam.f_x, cam.s, cam.c_x, 0.0, cam.f_y, cam.c_y, 0.0, 0.0, 1.0]
    msgs = [("/camera/depth/camera_info", "sensor_msgs/CameraInfo", stamp0_ns,
             dict(height=cam.height, width=cam.width, K=K))]
    for i, (d, t, q) in enumerate(zip(stream["depth"], stream["gt_t"], stream["gt_q"])):
        stamp = stamp0_ns + round(i * 1e9 / 90.0)
        mm = np.clip(np.round(d * 1000.0), 0, 65535).astype("<u2")
        msgs.append(("/camera/depth/image_rect", "sensor_msgs/Image", stamp,
                     dict(height=cam.height, width=cam.width, encoding="16UC1",
                          data=mm.tobytes(), header=dict(seq=i, stamp=stamp * 1e-9))))
        msgs.append(("/object/gt_pose", "geometry_msgs/PoseStamped", stamp,
                     dict(position=dict(x=float(t[0]), y=float(t[1]), z=float(t[2])),
                          orientation=dict(w=float(q[0]), x=float(q[1]), y=float(q[2]),
                                           z=float(q[3])),
                          header=dict(seq=i, stamp=stamp * 1e-9))))
    return msgs


def stream_phase(device, failures, smi, final_state, n_frames=TRACK_FRAMES, vga=(640, 480),
                 width=80, height=60, n_particles=None, n_check=200):
    """Phase 12: a recorded depth stream into the trackers. The tracking
    scene's frames rendered at 640x480 by render_depth (written over NaN,
    held bitwise against its plain version and timed), written as a ROS1 bag (16UC1 images,
    camera info, ground-truth poses), converted by convert_rosbag, and
    tracked through scripts/torch_ros_particle_filter.py's --stream path at
    80x60 (the stream resized, the camera rescaled, the model read from an
    OBJ and decimated to 256 faces) by the coordinate (600) and bootstrap
    (1250) filters under the script's gates; the spec fixture bag read; and
    phase 3's final SmcState saved and restored onto the card bitwise.
    Returns (render_depth launches of the synthesis, its timing row and
    relative error, render_score launches of the trackers, the timing row
    and comparison of render_score on the coordinate filter's final
    particles and last frame)."""
    import tempfile

    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
        mesh_tensors,
        render_depth,
        render_depth_reference,
        render_score,
    )
    from bayesianposeestimation.jl_tpu_torch.utils import checkpoint, rosbag
    from bayesianposeestimation.jl_tpu_torch.utils.experiment_io import convert_rosbag

    track = tracker_script()
    t0 = time.perf_counter()
    render_depth.launches = 0
    stream, mesh = track.synthetic_stream(n_frames, *vga, device=device)
    depth_launches = render_depth.launches
    verts, faces = mesh_tensors(mesh.vertices, mesh.faces, device)
    t = torch.as_tensor(stream["gt_t"], device=device).contiguous()
    q = torch.as_tensor(stream["gt_q"], device=device).contiguous()
    args = (verts, faces, stream["camera"], t, q)
    # the stream's own frames were rendered into a block of this size just
    # now: the compared launch writes over NaN
    d, fresh = on_nan_block(lambda: render_depth(*args, device=device))
    ref = render_depth_reference(*args)
    torch.cuda.synchronize()
    both = (d > 0) & (ref > 0)
    rel = float(((d - ref).abs() / ref.clamp(min=1e-30))[both].max())
    bitwise = fresh and bool(torch.equal(d, ref))
    sync = torch.cuda.synchronize
    ms = time_ms(lambda: render_depth(*args, device=device), 20, sync)
    plain_ms = time_ms(lambda: render_depth_reference(*args), 1, sync)
    dev_ms = device_ms(lambda: render_depth(*args, device=device), 10)
    b_ms, b_by, ops, pairs = bound_ms(args, epilogue="depth")
    print(f"phase 12 render_depth at {vga[0]}x{vga[1]} x {n_frames} poses ({faces.shape[0]} "
          f"faces): written over NaN {fresh}, bitwise equal to the plain version {bitwise} "
          f"(relative depth max {rel:.2e}); "
          f"kernel {ms:.4f} ms (CUDA events over 20 calls), device {dev_ms} ms (profiler), plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}, {ops / 1e6:.3f} M ops, {pairs} live "
          f"triangle-pixel pairs), {share_of_bound(b_ms, ms, dev_ms)} on {smi}")
    if not bitwise or dev_ms is None:
        failures.append("phase 12 render_depth at 640x480: vs plain, or no device time")

    render_score.launches = 0
    with tempfile.TemporaryDirectory() as tmp, EvaluationCount() as evals:
        tmp = Path(tmp)
        t1 = time.perf_counter()
        rosbag.write_bag(tmp / "stream.bag", stream_messages(stream))
        convert_rosbag(tmp / "stream.bag", tmp / "stream.npz", "/camera/depth/image_rect",
                       "/camera/depth/camera_info", "/object/gt_pose")
        write_obj(tmp / "object.obj", mesh)
        recorded, model = track.recorded_stream(tmp / "stream.npz", str(tmp / "object.obj"))
        mm = np.clip(np.round(stream["depth"] * 1000.0), 0, 65535) / 1000.0
        same = (recorded["depth"].shape == stream["depth"].shape
                and float(np.abs(recorded["depth"] - mm).max()) < 1e-6
                and np.array_equal(recorded["gt_t"], stream["gt_t"])
                and float(np.abs(recorded["gt_q"] - stream["gt_q"]).max()) < 1e-6
                and all(getattr(recorded["camera"], k) == getattr(stream["camera"], k)
                        for k in ("width", "height", "f_x", "f_y", "c_x", "c_y", "s"))
                and np.array_equal(model.faces, mesh.faces))
        print(f"phase 12 bag: {n_frames} frames at {vga[0]}x{vga[1]}, "
              f"{(tmp / 'stream.bag').stat().st_size / 2**20:.1f} MiB, written, converted and "
              f"read back in {time.perf_counter() - t1:.2f} s; stream equal to the frames in "
              f"millimetres, poses, camera and OBJ model {same}")
        if not same:
            failures.append("phase 12 bag -> stream round trip")
        filter_args = {kind: track_filter(kind, recorded, model, device, failures, smi, evals,
                                          width, height, n_particles, n_check, phase="12")[1]
                       for kind in ("coordinate", "bootstrap")}
    track_launches = render_score.launches
    # the kernel on the recorded stream's own inputs: the coordinate filter's
    # final particles on the last bag-derived frame
    track_row, track_cmp = score_row(
        filter_args["coordinate"], device, "phase 12 render_score[fixed_o] on the recorded "
        "stream, the coordinate filter's final particles", smi, "simple", "fixed_o",
        (100, 3, 30))
    if not track_cmp["ok"] or track_row[1] is None:
        failures.append("phase 12 render_score[fixed_o] on the recorded stream: vs plain, or "
                        "no device time")

    fixture = [m[1] for m in rosbag.read_bag(REPO / "tests/fixtures/rosbag/tracker.bag")]
    if fixture != ["sensor_msgs/Image", "sensor_msgs/CameraInfo", "geometry_msgs/PoseStamped"]:
        failures.append(f"phase 12 fixture bag: {fixture}")
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_state(Path(tmp) / "state.npz", final_state)
        restored = checkpoint.load_state(Path(tmp) / "state.npz", final_state)
    def leaves(state):
        s = state.sample
        return [*s.variables.values(), s.log_prob, s.log_like, state.log_weights,
                state.log_evidence, state.temperature, state.log_relative_ess]

    pairs_ = list(zip(leaves(restored), leaves(final_state)))
    equal = (list(restored.sample.variables) == list(final_state.sample.variables)
             and all(a.device == b.device and torch.equal(a, b) for a, b in pairs_))
    print(f"phase 12 fixture bag {fixture}; checkpoint of phase 3's final SmcState: "
          f"{len(pairs_)} leaves restored on {restored.log_weights.device}, bitwise equal "
          f"{equal}; phase {time.perf_counter() - t0:.1f} s")
    if not equal:
        failures.append("phase 12 checkpoint round trip")
    return (depth_launches, (ms, dev_ms, plain_ms, b_ms, b_by), rel, track_launches,
            track_row, track_cmp)

GRAPH_TOL = dict(rtol=1e-3, atol=0.05)  # graph vs fused log densities (the JAX pair: <= 0.0043)


def demo_script():
    sys.path.insert(0, str(REPO / "scripts"))
    import torch_demo_inference

    return torch_demo_inference


def sync_sites(fn):
    """The Python call sites (file:line) of the host synchronisations that
    ``fn()`` makes after one warm-up call, by torch's sync debug mode. Only
    its per-sync warning counts: setting the mode the first time in a
    process also warns, once, that the mode is a prototype."""
    import warnings

    import torch

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def demo_phase(device, failures, smi):
    """Phase 13a: scripts/torch_demo_inference.py's run at its defaults
    (simple_posterior, smc_mh, 1,280-face monkey, 30x30, 100 particles, 300
    steps) and with association_posterior: a first chain and three timed
    chains each, RESULT: PASS, render_depth launches = likelihood
    evaluations = steps, no render_score launch; no host synchronisation in
    one graph evaluation, one fused evaluation, a 5-step chain or a
    tracker's per-frame build of a graph posterior (torch's sync debug mode,
    which must see the sync of a control). Returns the results by
    posterior."""
    demo = demo_script()
    results = {}
    for posterior in ("simple_posterior", "association_posterior"):
        args = demo.parse_args(["--posterior", posterior])
        res = demo.run(args, device, trials=3)
        results[posterior] = res
        ok = res["t_err"] < demo.PASS_T_ERR
        hyp = args.n_steps * args.n_particles / min(res["seconds"])
        print(f"phase 13a demo {posterior} (smc_mh, {args.mesh}, 30x30, {args.n_particles} "
              f"particles, {args.n_steps} steps) on {smi}: first run {res['first']:.3f} s, "
              f"timed {[round(x, 4) for x in res['seconds']]} s -> {hyp:.1f} hypotheses/s; "
              f"evaluations {res['evaluations']}, render_depth launches "
              f"{res['depth_launches']}, render_score launches {res['score_launches']}; "
              f"translation error {res['t_err'] * 1e3:.2f} mm, rotation error "
              f"{math.degrees(res['r_err']):.2f} deg, log evidence {res['log_evidence']:.2f}; "
              f"RESULT: {'PASS' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"phase 13a demo {posterior}: RESULT FAIL")
        if not (res["depth_launches"] == res["evaluations"] == [args.n_steps] * 3
                and res["score_launches"] == [0] * 3):
            failures.append(f"phase 13a demo {posterior}: launches vs evaluations")
        if not all(bool(v.isfinite().all()) for v in res["outs"].values()):
            failures.append(f"phase 13a demo {posterior}: non-finite outputs")
    import torch

    from bayesianposeestimation.jl_tpu_torch.models import experiment_models as em
    from bayesianposeestimation.jl_tpu_torch.samplers import sample_chain

    # the same chain on the fused simple posterior, for the graph path's cost
    args = demo.parse_args(["--fused"])
    fused_res = demo.run(args, device, trials=3)
    print(f"phase 13a demo simple (fused, for comparison) on {smi}: timed "
          f"{[round(x, 4) for x in fused_res['seconds']]} s -> "
          f"{args.n_steps * args.n_particles / min(fused_res['seconds']):.1f} hypotheses/s; "
          f"render_score launches {fused_res['score_launches']}; translation error "
          f"{fused_res['t_err'] * 1e3:.2f} mm")
    res = results["simple_posterior"]
    post, sample = res["posterior"], res["final"].sample
    params, _, fused, sampler, _, _ = demo.build(demo.parse_args(["--fused"]),
                                                 torch.device(device))
    sites = {"one graph evaluation": sync_sites(lambda: post.logdensity_sample(sample)),
             "one fused evaluation": sync_sites(lambda: fused.logdensity_sample(sample)),
             "a 5-step smc_mh chain on the graph posterior": sync_sites(
                 lambda: sample_chain(0, post, sampler, 5, 100, device=device))}
    # a tracker's per-frame build of the graph posterior
    exp = res["experiment"]
    prior = em.point_prior(params, exp, device)
    build = sync_sites(lambda: em.association_posterior(
        params, exp.with_depth_image(exp.depth_image + 0.0), prior))
    # the detector sees a sync where there is one
    control = sync_sites(lambda: float(sample.log_like.sum()))
    print(f"phase 13a host synchronisations (torch's sync debug mode, call sites): "
          f"{json.dumps(sites)}; building association_posterior on a new frame: {build}; "
          f"control (one float() of a card tensor): {control}")
    if not control or build or any(sites.values()):
        failures.append("phase 13a: host synchronisations in the graph path, or none "
                        "seen in the control")
    return results


def graph_vs_fused(device, failures, smi, sample):
    """Phase 13b: each graph factory's log densities on the demo's final
    particles against the matching fused variant on the card and against
    the graph posterior on the CPU (plain version). Returns the max |d|s."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch.models import experiment_models as em

    demo = demo_script()
    cpu_sample = type(sample)({k: v.cpu() for k, v in sample.variables.items()})
    worst = {}
    for factory, variant in demo.FUSED_VARIANTS.items():
        params, exp, graph, _, _, _ = demo.build(demo.parse_args(["--posterior", factory]),
                                                 torch.device(device))
        fused = demo.build(demo.parse_args(["--posterior", factory, "--fused"]),
                           torch.device(device))[2]
        exp_cpu = exp.to("cpu")
        plain = getattr(em, factory)(params, exp_cpu, em.point_prior(params, exp_cpu, "cpu"))
        g = graph.logdensity_sample(sample)
        f = fused.logdensity_sample(sample)
        c = plain.logdensity_sample(cpu_sample)
        torch.cuda.synchronize()
        d_fused = d_plain = 0.0
        ok = True
        for k in ("log_like", "log_prob"):
            gk, fk, ck = (getattr(x, k).cpu().numpy() for x in (g, f, c))
            d_fused = max(d_fused, float(np.max(np.abs(gk - fk))))
            d_plain = max(d_plain, float(np.max(np.abs(gk - ck))))
            ok &= bool(np.all(np.isfinite(gk)) and np.allclose(gk, fk, **GRAPH_TOL)
                       and np.allclose(gk, ck, **GRAPH_TOL))
        worst[factory] = (d_fused, d_plain)
        print(f"phase 13b {factory} vs fused {variant} on the demo's final particles "
              f"({sample.variables['t'].shape[0]}): max |d| {d_fused:.5f} (card vs card), "
              f"{d_plain:.5f} (card vs plain version on the CPU), log_like range "
              f"{float(g.log_like.min()):.2f} .. {float(g.log_like.max()):.2f}; ok {ok} on {smi}")
        if not ok:
            failures.append(f"phase 13b {factory} vs fused {variant} / plain version")
    return worst


def graph_depth_row(args, device, smi, label, phase="13c"):
    """Phase 13c (and 17a): render_depth with back faces drawn at a path's
    shape, on that path's own inputs (verts, faces, cam, t, q): written over
    NaN, bitwise against the plain version, timed. Returns (ok, timing row,
    max |d|)."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
        render_depth,
        render_depth_reference,
    )

    def run():
        return render_depth(*args, backface_cull=False, device=device)

    d, fresh = on_nan_block(run)
    ref = render_depth_reference(*args, backface_cull=False)
    torch.cuda.synchronize()
    err = float((d - ref).abs().max())
    bitwise = fresh and bool(torch.equal(d, ref))
    sync = torch.cuda.synchronize
    ms = time_ms(run, 100, sync)
    plain_ms = time_ms(lambda: render_depth_reference(*args, backface_cull=False), 3, sync)
    dev_ms = device_ms(run, 30)
    b_ms, b_by, ops, pairs = bound_ms(args, epilogue="depth", backface_cull=False)
    verts, faces, cam, t = args[:4]
    print(f"phase {phase} render_depth, {label} ({faces.shape[0]} faces, {cam.width}x{cam.height}, "
          f"{t.shape[0]} poses, back faces drawn): written over NaN {fresh}, bitwise equal to "
          f"the plain version {bitwise}; kernel {ms:.4f} ms (CUDA events over 100 calls), "
          f"device {dev_ms} ms (profiler), plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
          f"({b_by}, {ops / 1e6:.3f} M ops, {pairs} triangle-pixel pairs), "
          f"{share_of_bound(b_ms, ms, dev_ms)} on {smi}")
    return bitwise and dev_ms is not None, (ms, dev_ms, plain_ms, b_ms, b_by), err


def graph_mtm(device, failures, smi, n_steps=20):
    """Phase 13d: mtm_sampler (10 tries, 1 chain) on the demo's graph
    posterior: finite densities, render_depth launches = evaluations = 1 +
    2 (steps - 1). Returns the launches."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.models import experiment_samplers as es
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_depth
    from bayesianposeestimation.jl_tpu_torch.samplers import sample_chain

    demo = demo_script()
    args = demo.parse_args(["--n-steps", str(n_steps), "--n-particles", "10"])
    params, _, posterior, _, _, _ = demo.build(args, torch.device(device))
    sampler = es.mtm_sampler(params, posterior)
    render_depth.launches = 0
    with EvaluationCount() as evals:
        t0 = time.perf_counter()
        outs, final = sample_chain(3, posterior, sampler, n_steps, 1, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, expected = render_depth.launches, 1 + 2 * (n_steps - 1)
    finite = all(bool(v.isfinite().all()) for v in outs.values())
    print(f"phase 13d mtm_sampler on simple_posterior, 10 tries x 1 chain, {n_steps} steps: "
          f"{wall:.3f} s on {smi}; render_depth launches {launches}, evaluations {evals.n}, "
          f"expected {expected}; finite {finite}; final log_like "
          f"{float(final.sample.log_like[0]):.3f}")
    if not (finite and launches == evals.n == expected):
        failures.append("phase 13d mtm on the graph posterior")
    return launches


def unfused_filter(device, failures, smi, n_check=200):
    """Phase 13e: the coordinate filter (600 particles) with pf_prior +
    simple_posterior on phase 6's synthetic 80x60 stream: a warm-up and three
    timed runs, the tracking script's gates, render_depth launches =
    evaluations = 4 (1 + 2 (F - 1)), no render_score launch, final densities
    against the plain version on the CPU. Returns (render_depth launches,
    the kernel's arguments for the final particles)."""
    import statistics

    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch.models import experiment_models as em
    from bayesianposeestimation.jl_tpu_torch.models.particle_filter import (
        coordinate_pf,
        pf_prior,
    )
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_depth, render_score
    from bayesianposeestimation.jl_tpu_torch.render import render_scene

    track = tracker_script()
    stream, mesh = track.synthetic_stream(TRACK_FRAMES, 80, 60, device=device)
    params = track.filter_params("coordinate", 80, 60, None, device)
    experiment, depth, small = track.tracking_setup(stream, mesh, params, device)
    frames = depth.shape[0] - 1
    render_depth.launches = render_score.launches = 0
    with EvaluationCount() as evals:
        outs, final, first, runs = track.timed_runs(coordinate_pf, em.simple_posterior, params,
                                                    experiment, depth, device)
    launches, score_launches = render_depth.launches, render_score.launches
    expected = 4 * (1 + 2 * frames)
    res = track.tracking_errors(*track.pose_estimates(outs), stream)
    finite = all(bool(torch.isfinite(v).all()) for v in outs.values())
    s = final.sample
    exp_cpu = experiment.with_depth_image(depth[-1].cpu())
    cpu_post = em.simple_posterior(params, exp_cpu, pf_prior(params, exp_cpu, "cpu"))
    cpu_sample = type(s)({k: v[:n_check].cpu() for k, v in s.variables.items()})
    ll_cpu = cpu_post.logdensity_sample(cpu_sample).log_like.numpy()
    ll_dev = s.log_like[:n_check].cpu().numpy()
    dens_ok = bool(np.allclose(ll_dev, ll_cpu, **GRAPH_TOL))
    med = statistics.median(runs)
    print(f"phase 13e unfused coordinate filter (pf_prior + simple_posterior): "
          f"{params.n_particles} particles, {small.n_faces}-face mesh, {frames} frames at 80x60 "
          f"on {smi}: first run {first:.4f} s, timed runs {[round(r, 4) for r in runs]} s -> "
          f"{frames / med:.2f} fps, {med / frames * 1e3:.4f} ms per frame (not gated); "
          f"render_depth launches {launches}, evaluations {evals.n}, expected {expected}, "
          f"render_score launches {score_launches}; median error "
          f"{res['median_error_mm']:.3f} mm, {res['median_rot_deg']:.3f} deg; gate {res['ok']}; "
          f"final densities vs plain ({len(ll_cpu)} particles) max |d| "
          f"{float(np.max(np.abs(ll_dev - ll_cpu))):.5f}")
    if not res["ok"]:
        failures.append("phase 13e unfused filter: tracking gate")
    if not (finite and dens_ok):
        failures.append("phase 13e unfused filter: non-finite outputs or densities vs plain")
    if not (launches == evals.n == expected and score_launches == 0):
        failures.append(f"phase 13e unfused filter: launches {launches} vs evaluations "
                        f"{evals.n} vs expected {expected}, render_score {score_launches}")
    scene = render_scene(experiment.scene, device)
    return launches, (scene["verts"], scene["faces"], scene["camera"],
                      s.variables["t"].contiguous(), s.variables["r"].contiguous())


def gibbs_on_card(device, failures, smi):
    """Phase 13f: Gibbs with the exact conditional on tests/test_samplers.py's
    Gaussian model, on the card: mean and std within 0.02 of the posterior."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch.distributions import Normal
    from bayesianposeestimation.jl_tpu_torch.graph import BroadcastedNode, sequentialize
    from bayesianposeestimation.jl_tpu_torch.posterior import PosteriorModel
    from bayesianposeestimation.jl_tpu_torch.samplers import Gibbs, sample_chain
    from bayesianposeestimation.jl_tpu_torch.tempering import ConstantSchedule

    obs, sigma = 1.0, 0.5
    mean, std = obs / (1 + sigma**2), math.sqrt(sigma**2 / (1 + sigma**2))
    x = BroadcastedNode("x", Normal, 0.0, 1.0)
    model = PosteriorModel(BroadcastedNode("y", Normal, x, sigma)
                           | torch.tensor(obs, device=device))
    sampler = Gibbs(sequentialize(BroadcastedNode("x", Normal, mean, std)), ConstantSchedule())
    outs, _ = sample_chain(0, model, sampler, 500, 64, collect_vars=("x",), device=device)
    xs = outs["x"][100:].cpu().numpy().ravel()
    ok = (model.device.type == "cuda" and abs(float(np.mean(xs)) - mean) < 0.02
          and abs(float(np.std(xs)) - std) < 0.02)
    print(f"phase 13f Gibbs on the Gaussian model on {model.device}: mean {np.mean(xs):.4f} "
          f"(exact {mean:.4f}), std {np.std(xs):.4f} (exact {std:.4f}); ok {ok}")
    if not ok:
        failures.append("phase 13f Gibbs")


def graph_phase(device, failures, smi):
    """Phase 13: the graph (unfused) posteriors on render_depth. Returns the
    kernels-line rows of render_depth at the graph path's two shapes."""
    t0 = time.perf_counter()
    demo_results = demo_phase(device, failures, smi)
    simple = demo_results["simple_posterior"]
    graph_vs_fused(device, failures, smi, simple["final"].sample)
    graph_mtm(device, failures, smi)
    filter_launches, filter_args = unfused_filter(device, failures, smi)
    gibbs_on_card(device, failures, smi)
    from bayesianposeestimation.jl_tpu_torch.render import render_scene

    sample = simple["final"].sample
    scene = render_scene(simple["experiment"].scene, device)
    demo_args = (scene["verts"], scene["faces"], scene["camera"],
                 sample.variables["t"].contiguous(), sample.variables["r"].contiguous())
    rows = []
    for label, args, launches, path in (
            ("the demo's final particles", demo_args,
             sum(sum(r["depth_launches"]) for r in demo_results.values()),
             "phase 13a graph posteriors, timed demo chains"),
            ("the unfused filter's final particles", filter_args, filter_launches,
             "phase 13e unfused coordinate filter")):
        ok, row, err = graph_depth_row(args, device, smi, label)
        if not ok:
            failures.append(f"phase 13c render_depth at {label}: vs plain, or no device time")
        rows.append((f"render_depth {args[1].shape[0]} faces {args[2].width}x{args[2].height} "
                     f"{args[3].shape[0]} poses (graph posterior)", launches, path, err, row))
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s")
    return rows


# -- phase 14: the experiment sweeps and particle sharding ----------------------

# the experiment sweeps' JAX runs whose estimates and errors are checked in
# (data/exp_raw/<name>, data/exp_pro/<name>): each experiment's script and the
# arguments the JAX run used (read off its artifacts' __config__), and the
# table it wrote
SWEEP_EXPERIMENTS = {
    "smc_benchmark": ("torch_smc_benchmark", [], "recall_vs_budget.csv"),
    "smc_benchmark_cad": ("torch_smc_benchmark", ["--dataset", "synthcad", "--particles", "10",
                                                  "--experiment-name", "smc_benchmark_cad"],
                          None),
    "smc_benchmark_steri": ("torch_smc_benchmark_steri", ["--particles", "100", "--budgets",
                                                          "0.25", "0.5"],
                            "recall_vs_budget.csv"),
    "mcmc_benchmark": ("torch_mcmc_benchmark", [], "recall_vs_time.csv"),
    "mcmc_baseline": ("torch_mcmc_baseline", [], "sampler_recall.csv"),
    "smc_mh_baseline": ("torch_smc_mh_baseline", [], "baseline_recall.csv"),
    "smc_mh_resolution": ("torch_smc_mh_resolution", ["--resolutions", "15", "30", "60"],
                          "resolution_recall.csv"),
    "smc_observation": ("torch_smc_observation", ["--variants", "association", "smooth",
                                                  "simple", "--o-priors", "mask"],
                        "observation_recall.csv"),
    "smc_priors": ("torch_smc_priors", [], "priors_recall.csv"),
}
# the JAX package's errors of the artifacts whose checked-in errors its
# evaluation does not reproduce today (scripts/reevaluate_errors.py)
REEVALUATED = REPO / "tests/fixtures/reevaluated_errors.npz"
SWEEP_ADDS_REL_TOL = ADDS_REL_TOL  # phase 7a's (the card sums in another order: ~2e-5)
SWEEP_VSD_ABS_TOL = 0.005
# phase 14b: one config of each script on scene 1 at its real settings
# (script, its arguments, the config's distinguishing keys)
SWEEP_RUNS = (
    ("torch_smc_benchmark", ["--particles", "100", "--budgets", "0.25"], {}),
    ("torch_smc_benchmark", ["--particles", "250", "--budgets", "0.25"], {}),
    ("torch_mcmc_benchmark", ["--mtm-tries", "40", "--budgets", "0.25"],
     {"sampler": "mtm_sampler"}),
    ("torch_smc_observation", ["--variants", "simple", "--o-priors", "mask"], {}),
    ("torch_smc_observation", ["--variants", "smooth", "--o-priors", "mask"], {}),
    ("torch_smc_priors", ["--priors", "point"], {}),
    ("torch_smc_mh_resolution", ["--resolutions", "15"], {}),
    ("torch_smc_mh_resolution", ["--resolutions", "60"], {}),
    ("torch_smc_mh_baseline", [], {}),
    ("torch_smc_benchmark_steri", ["--particles", "100", "--budgets", "0.25"], {}),
)
SHARD_STEPS = 20  # the sharded flagship chain of phase 14d


def sweep_script(name):
    """A sweep script's module and the module whose ``configs`` / ``run`` /
    ``table`` it uses (the steri script runs torch_smc_benchmark's sweep)."""
    import importlib

    sys.path.insert(0, str(REPO / "scripts"))
    script = importlib.import_module(name)
    return script, (importlib.import_module("torch_smc_benchmark")
                    if name == "torch_smc_benchmark_steri" else script)


def sweep_reference(name, file, fixture=REEVALUATED):
    """The JAX errors an artifact is held to: the JAX package's evaluation
    of today (in ``fixture``) where it does not reproduce the checked-in
    errors, else those. Returns (errors, whether they are the re-evaluation)."""
    import numpy as np

    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import load_artifact

    key = f"{name}/{file}"
    with np.load(fixture) as f:
        if f"{key}/vsd" in f.files:
            return {k: f[f"{key}/{k}"] for k in ("adds", "vsd", "vsdbop", "visib")}, True
    return load_artifact(REPO / "data/exp_pro" / name / "errors" / file), False


def csv_equal(value, text):
    """A table value against its CSV text (numbers by value)."""
    if str(value) == text:
        return True
    try:
        return float(value) == float(text)
    except ValueError:
        return False


def sweep_eval_parity(device, failures):
    """Phase 14a: the port's evaluate_scene on the card on every estimate
    artifact of the nine experiments' JAX runs against the JAX errors
    (``sweep_reference``): visibilities equal where stored, ADD-S within
    1e-4 relative, VSD and VSDBOP within 0.005, counts under each threshold
    equal but for entries within 0.01 of it. Then each script's table code
    on the JAX estimates with the port's errors against the same code with
    the JAX errors: every column equal, or where an entry near a threshold
    moved a recall, the recalls within those entries and the columns that
    do not follow from the errors equal. The table from the checked-in JAX
    errors equals the checked-in CSV. Returns the render_depth launches."""
    import csv

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_depth
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import load_artifact, savename

    bopval = bop_val_script()
    params = Parameters(device=device)
    cache = {}
    t0 = time.perf_counter()
    render_depth.launches = 0
    n_artifacts, n_reeval, worst_adds, worst_vsd = 0, 0, 0.0, 0.0
    for name, (script_name, argv, csv_name) in SWEEP_EXPERIMENTS.items():
        script, module = sweep_script(script_name)
        args = script.parse_args([*argv, "--device", device])
        configs = module.configs(args)
        ours_all, refs_all, checked_in_all, near, reeval, n_gt = [], [], [], 0, 0, 0
        for config in configs:
            file = savename(config) + ".npz"
            raw = load_artifact(REPO / "data/exp_raw" / name / file)
            ours = bopval.evaluate_scene(raw["__config__"], str(BOP_DIR), params,
                                         list(raw["result_rows"]), device, cache)
            ref, is_reeval = sweep_reference(name, file)
            reeval += is_reeval
            n_gt = max(n_gt, len(ref["vsd"]))
            bad, w_adds, w_vsd, n_near = compare_errors(ours, ref, SWEEP_ADDS_REL_TOL,
                                                        SWEEP_VSD_ABS_TOL)
            worst_adds, worst_vsd = max(worst_adds, w_adds), max(worst_vsd, w_vsd)
            near += n_near
            if bad:
                failures.append(f"phase 14a {name}/{file}: {bad}")
                print(f"phase 14a {name}/{file}: FAILED {bad}")
            ours_all.append((config, raw, ours))
            refs_all.append((config, raw, ref))
            checked_in_all.append((config, raw, load_artifact(
                REPO / "data/exp_pro" / name / "errors" / file)))
        n_artifacts += len(configs)
        n_reeval += reeval
        if csv_name is None:
            print(f"phase 14a {name}: {len(configs)} artifacts ({reeval} held to the "
                  f"re-evaluation), no table checked in; {near} entries near a threshold")
            continue
        mine = module.table(ours_all, args)
        theirs = module.table(refs_all, args)
        derived = ("n_gt", "vsd_ci_lo", "vsd_ci_hi", "adds_ci_lo", "adds_ci_hi")
        for a, b in zip(mine, theirs):
            for key, val in b.items():
                if a[key] == val:
                    continue
                moved = (key.endswith("_recall") and abs(a[key] - val) * n_gt <= near + 1e-9
                         or key in derived and near > 0)
                if not moved:
                    failures.append(f"phase 14a {name} table {key}: {a[key]} vs {val}")
        with open(REPO / "data/exp_pro" / name / csv_name, newline="") as fh:
            checked_in = list(csv.DictReader(fh))
        table = module.table(checked_in_all, args)
        same = len(checked_in) == len(table) and all(
            csv_equal(b[k], r[k]) for b, r in zip(table, checked_in) for k in r if k in b)
        csv_note = f"the table from the checked-in JAX errors equals {csv_name}: {same}"
        if not same:
            failures.append(f"phase 14a {name}: table vs {csv_name}")

        def recalls(rows):
            return json.dumps([{k: round(v, 4) for k, v in r.items() if k.endswith("recall")}
                               for r in rows])

        print(f"phase 14a {name}: {len(configs)} artifacts ({reeval} held to the "
              f"re-evaluation); the port's table {recalls(mine)} vs the JAX errors' "
              f"{recalls(theirs)}; {csv_note}; {near} entries near a threshold")
    print(f"phase 14a evaluation of {n_artifacts} JAX estimate artifacts ({n_reeval} held to the "
          f"JAX package's re-evaluation) on the card: {time.perf_counter() - t0:.2f} s, "
          f"render_depth launches {render_depth.launches}; max ADD-S relative |d| "
          f"{worst_adds:.3g} (limit {SWEEP_ADDS_REL_TOL}), max VSD/VSDBOP |d| {worst_vsd:.4f} "
          f"(limit {SWEEP_VSD_ABS_TOL})")
    if n_artifacts != 51:
        failures.append(f"phase 14a evaluated {n_artifacts} artifacts, not 51")
    return render_depth.launches


def sweep_kernel_args(call, device, n_tries=None):
    """render_score's arguments for a logged chain run's final particles (as
    its posterior passes them); ``n_tries``: the poses of a multiple-try
    step, scattered around a one-chain final state (5 mm, ~0.1 rad)."""
    import torch

    from bayesianposeestimation.jl_tpu_torch import quaternions as quat
    from bayesianposeestimation.jl_tpu_torch.models.fused import fused_posterior
    from bayesianposeestimation.jl_tpu_torch.parameters import Experiment

    cam, obs, prior_o, prior_t = call["args"]
    exp = Experiment(scene={"camera": cam, "verts": call["verts"], "faces": call["faces"]},
                     prior_o=torch.as_tensor(prior_o), prior_t=prior_t,
                     depth_image=torch.as_tensor(obs))
    post = fused_posterior(call["params"], exp, call["variant"], device=device)
    sample = call["out"][1].sample
    t, q = sample.variables["t"].reshape(-1, 3), sample.variables["r"].reshape(-1, 4)
    if n_tries is not None:
        gen = torch.Generator(device=device).manual_seed(14)
        t = t[:1] + 0.005 * torch.randn((n_tries, 3), generator=gen, device=device)
        q = quat.qplus(q[:1].expand(n_tries, 4),
                       0.1 * torch.randn((n_tries, 3), generator=gen, device=device))
    return (post.verts, post.faces, post.camera, t.contiguous(), q.contiguous(), post.depth,
            post.prior_o, call["params"])


def sweep_runs(device, failures, smi, workdir):
    """Phases 14b and 14c: one config of each experiment script on scene 1
    (``SWEEP_RUNS``), called through the script's own ``run`` at its real
    settings, estimates and errors written under ``workdir``: finite
    estimates, render_score launches = likelihood evaluations = 1 + k
    (steps - 1) per chain run, the recall beside the JAX artifact's. Then
    render_score on each config's final particles (for MTM: its tries)
    against its plain version, timed. Returns the kernels-line rows."""
    import numpy as np

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import SCORE_VARIANTS, render_score
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import savename

    bopval = bop_val_script()
    cache, rows = {}, []
    for script_name, argv, select in SWEEP_RUNS:
        script, module = sweep_script(script_name)
        args = script.parse_args([*argv, "--device", device])
        [config] = [c for c in module.configs(args)
                    if all(c[k] == v for k, v in select.items())]
        experiment = getattr(args, "experiment_name", None) or module.NAME
        per_step = 2 if config["sampler"].startswith("mtm") else 1
        render_score.launches = 0
        t0 = time.perf_counter()
        with EvaluationCount() as evals, RunnerLog(evals) as log:
            result, errors = module.run(config, args, cache, data_root=workdir)
        dt = time.perf_counter() - t0
        launches = render_score.launches
        label = f"{experiment} " + savename({k: v for k, v in config.items()
                                              if k not in ("dataset", "testset", "scene_id",
                                                           "sampler")})
        rows_out = result["result_rows"]
        if not all(np.isfinite(r["t"]).all() and np.isfinite(r["q"]).all()
                   and np.isfinite(r["score"]) for r in rows_out):
            failures.append(f"phase 14b {label}: non-finite estimates")
        wrong = [(c["launches"], c["evals"], c["n_steps"]) for c in log.calls
                 if not c["launches"] == c["evals"] == 1 + per_step * (c["n_steps"] - 1)]
        if wrong or launches != evals.n or launches == 0:
            failures.append(f"phase 14b {label}: launches vs evaluations {wrong[:3]}, total "
                            f"{launches} vs {evals.n}")
        rec = bopval.scene_recalls(errors)
        try:
            jax_rec = bopval.scene_recalls(sweep_reference(experiment,
                                                           savename(config) + ".npz")[0])
        except FileNotFoundError:  # a config the JAX run did not make
            jax_rec = {k: float("nan") for k in rec}
        walls = [r["time"] for r in rows_out]
        steps = {k: v["n_steps"] for k, v in result["calibration"].items()}
        step_ms = {k: round(v["step_time"] * 1e3, 4) for k, v in result["calibration"].items()}
        print(f"phase 14b {label} scene 1 ({len(rows_out)} rows) on {smi}: {dt:.2f} s in all; "
              f"steps per {config.get('pose_time', 0.5)} s budget by object {json.dumps(steps)} "
              f"(step ms {json.dumps(step_ms)}); wall per pose mean {np.mean(walls):.4f} s max "
              f"{np.max(walls):.4f} s; launches {launches} = evaluations {evals.n}; VSD recall "
              f"{rec['vsd_recall']:.3f} (JAX {jax_rec['vsd_recall']:.3f}), ADD-S "
              f"{rec['adds_recall']:.3f} (JAX {jax_rec['adds_recall']:.3f}), "
              f"n={len(errors['vsd'])}")
        # 14c: the kernel at this config's shape, on its largest model's final particles
        timed = [c for c in log.calls if c["seed"] < c["params"].seed % (2**31) + 10**6]
        call = max(timed, key=lambda c: c["faces"].shape[0])
        variant = call["variant"]
        kernel_args = sweep_kernel_args(call, device,
                                        config["n_particles"] if per_step == 2 else None)
        epilogue = SCORE_VARIANTS[variant]
        shape = (f"{kernel_args[1].shape[0]} faces {kernel_args[2].width}x"
                 f"{kernel_args[2].height} {kernel_args[3].shape[0]} poses")
        row, res = score_row(kernel_args, device, f"phase 14c render_score[{epilogue}] "
                             f"({variant}) at {label}", smi, variant=variant, epilogue=epilogue)
        if not res["ok"] or row[1] is None:
            failures.append(f"phase 14c render_score at {label}: vs plain, or no device time")
        rows.append((f"render_score[{epilogue}] {label} {shape}", launches,
                     f"phase 14b {script_name}.run on scene 1", res["max_abs_err"], row))
    return rows


def sharded_chain_check(device, failures, smi, n_steps=SHARD_STEPS, n_particles=100):
    """Phase 14d: ``sharded_sample_chain`` in a one-process NCCL group on
    the flagship posterior (bench_torch's scene, smc_mh, 100 particles)
    against ``sample_chain`` with the same seed: every collected output and
    the final state equal within tests/test_multichip.py's gates (evidence
    and log-likelihoods 2e-3, best t 1e-4), launches = likelihood
    evaluations = steps, and no host synchronisation in the sharded chain
    (torch's sync debug mode, as phase 13a)."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from bayesianposeestimation.jl_tpu_torch.models.experiment_samplers import smc_mh
    from bayesianposeestimation.jl_tpu_torch.models.fused import fused_posterior
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_score
    from bayesianposeestimation.jl_tpu_torch.parallel.sharded import (
        particle_group,
        sharded_sample_chain,
    )
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
    from bayesianposeestimation.jl_tpu_torch.samplers import sample_chain

    params = Parameters(n_steps=n_steps, n_particles=n_particles,
                        proposal_sigma_r=(0.5, 0.5, 0.5), device=device)
    exp, _, _, _ = bench_scene(device)
    posterior = fused_posterior(params, exp, "association", device=device)
    sampler = smc_mh(params, posterior)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        group = particle_group(device, init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            backend = dist.get_backend(group)
            ref_outs, ref_final = sample_chain(3, posterior, sampler, n_steps, n_particles,
                                               device=device)
            render_score.launches = 0
            with EvaluationCount() as evals:
                outs, final = sharded_sample_chain(3, posterior, sampler, n_steps, n_particles,
                                                   group)
                torch.cuda.synchronize()
            launches, n_evals = render_score.launches, evals.n
            sites = sync_sites(lambda: sharded_sample_chain(4, posterior, sampler, 5,
                                                            n_particles, group))
            plain_sites = sync_sites(lambda: sample_chain(4, posterior, sampler, 5,
                                                          n_particles, device=device))
        finally:
            dist.destroy_process_group()
    gaps = {k: float((outs[k] - ref_outs[k]).abs().max()) for k in ref_outs}
    ll, ref_ll = final.sample.log_like.cpu().numpy(), ref_final.sample.log_like.cpu().numpy()
    best = final.sample.variables["t"][int(np.argmax(ll))].cpu().numpy()
    ref_best = ref_final.sample.variables["t"][int(np.argmax(ref_ll))].cpu().numpy()
    ok = (np.allclose(outs["log_evidence"].cpu().numpy(), ref_outs["log_evidence"].cpu().numpy(),
                      rtol=2e-3, atol=2e-3)
          and np.allclose(np.sort(ll), np.sort(ref_ll), rtol=2e-3, atol=2e-3)
          and np.allclose(best, ref_best, atol=1e-4))
    print(f"phase 14d sharded_sample_chain over {backend} at world size 1 on {smi} (flagship "
          f"posterior, {n_particles} particles, {n_steps} steps) against sample_chain, same "
          f"seed: max |d| {json.dumps({k: float(f'{v:.3g}') for k, v in gaps.items()})}; gates "
          f"met {ok}; launches {launches} = evaluations {n_evals} (expected {n_steps}); host "
          f"syncs in a 5-step sharded chain {sites} (unsharded {plain_sites})")
    if backend != "nccl":
        failures.append(f"phase 14d ran over {backend}, not nccl")
    if not ok:
        failures.append("phase 14d sharded chain vs sample_chain")
    if not launches == n_evals == n_steps:
        failures.append(f"phase 14d launches {launches} vs evaluations {n_evals}")
    if sites:
        failures.append(f"phase 14d host syncs in the sharded chain: {sites}")
    return launches


def trajectory_check(device, failures, workdir):
    """Phase 14e: scripts/torch_ros_particle_filter.py's coordinate filter
    (phase 6's stream and settings) exported with --export-tum, then
    scripts/torch_trajectory_error.py on the two trajectories: ATE and the
    median errors inside the tracking gates (< 5 mm, < 10 deg)."""
    import contextlib
    import io

    track = tracker_script()
    sys.path.insert(0, str(REPO / "scripts"))
    import torch_trajectory_error

    base = Path(workdir) / "coordinate"
    argv = sys.argv
    sys.argv = ["torch_ros_particle_filter.py", "--filter", "coordinate", "--device", device,
                "--export-tum", str(base)]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = track.main()
    finally:
        sys.argv = argv
    summary = torch_trajectory_error.main([f"{base}.tum", f"{base}_gt.tum",
                                           "--out-csv", f"{base}_traj.csv"])
    ok = (rc == 0 and summary["ate_rmse_mm"] < 5.0 and summary["trans_median_mm"] < 5.0
          and summary["rot_median_deg"] < 10.0)
    print(f"phase 14e coordinate filter exported to TUM (tracking script rc {rc}, "
          f"{out.getvalue().strip().splitlines()[-1]}); torch_trajectory_error: "
          f"{json.dumps(summary)}; gates (ATE and median < 5 mm, median < 10 deg) {ok}")
    if not ok:
        failures.append("phase 14e trajectory error gates")


def sweeps_phase(device, failures, smi):
    """Phase 14: the experiment sweeps and particle sharding. Returns the
    kernels-line rows of render_score at the sweeps' shapes."""
    import tempfile

    t0 = time.perf_counter()
    eval_launches = sweep_eval_parity(device, failures)
    print(f"phase 14a took {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as workdir:
        t1 = time.perf_counter()
        rows = sweep_runs(device, failures, smi, workdir)
        print(f"phase 14b-c took {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        sharded_chain_check(device, failures, smi)
        trajectory_check(device, failures, workdir)
        print(f"phase 14d-e took {time.perf_counter() - t1:.1f} s")
    print(f"phase 14 took {time.perf_counter() - t0:.1f} s")
    return rows, eval_launches


# -- phase 15: the hyperparameter searches and the synthetic BOP generator ------

# the JAX package's checked-in searches (data/exp_raw/<name>, data/exp_pro/<name>):
# each search's script and the arguments its run used, read off its artifacts
# (dataset, split and scenes from the configs, the trial count from
# trials.csv, the time budget from n_steps x step_time: 0.22 s of 0.25 s on
# synth, 0.38-0.44 s of 0.5 s on synthcad); --seed 0 reproduces every
# candidate of its trials.csv
HYPEROPT_EXPERIMENTS = {
    "smc_mh_hyperopt": ("torch_smc_mh_hyperopt", ["--trials", "30", "--scenes", "1"]),
    "smc_mh_hyperopt_cad": ("torch_smc_mh_hyperopt",
                            ["--dataset", "synthcad", "--testset", "train", "--scenes", "1", "2",
                             "3", "--trials", "10", "--time-budget", "0.5",
                             "--experiment-name", "smc_mh_hyperopt_cad"]),
    "mcmc_hyperopt_mh_sampler": ("torch_mcmc_baseline_hyperopt",
                                 ["--trials", "8", "--samplers", "mh_sampler"]),
    "mcmc_hyperopt_mtm_sampler": ("torch_mcmc_baseline_hyperopt",
                                  ["--trials", "8", "--samplers", "mtm_sampler"]),
    "mcmc_hyperopt_cad_mh": ("torch_mcmc_baseline_hyperopt",
                             ["--dataset", "synthcad", "--testset", "train", "--scenes", "1", "2",
                              "--trials", "8", "--time-budget", "0.5", "--samplers",
                              "mh_sampler", "--experiment-names", "mcmc_hyperopt_cad_mh"]),
    "mcmc_hyperopt_cad_mtm": ("torch_mcmc_baseline_hyperopt",
                              ["--dataset", "synthcad", "--testset", "train", "--scenes", "1",
                               "2", "--trials", "8", "--time-budget", "0.5", "--samplers",
                               "mtm_sampler", "--experiment-names", "mcmc_hyperopt_cad_mtm"]),
}
REEVALUATED_HYPEROPT = REPO / "tests/fixtures/reevaluated_errors_hyperopt.npz"
# phase 15b: these searches with 2 trials on scene 1 of their split
HYPEROPT_RUNS = ("smc_mh_hyperopt", "smc_mh_hyperopt_cad", "mcmc_hyperopt_mh_sampler",
                 "mcmc_hyperopt_mtm_sampler")
# the JAX script's rotation draws at --seed 77 (synthcad train), for phase 15d
JAX_QUATERNIONS = REPO / "tests/fixtures/jax_generator_quaternions.json"
# generated scenes against the checked-in ones: per-mask IoU, visible
# fraction, depth PNG units where both scenes' masks agree
GEN_MASK_IOU = 0.98
GEN_VISIB_TOL = 0.01
GEN_DEPTH_UNITS = 1


def hyperopt_argv(name, extra=()):
    """``torch_smc_mh_hyperopt.py``'s arguments of a checked-in search at
    --seed 0 (the MCMC script's through its ``search_argvs``), then
    ``extra`` (later options win)."""
    import importlib

    sys.path.insert(0, str(REPO / "scripts"))
    script, argv = HYPEROPT_EXPERIMENTS[name]
    argv = [*argv, "--seed", "0"]
    if script == "torch_mcmc_baseline_hyperopt":
        mcmc = importlib.import_module(script)
        [argv] = mcmc.search_argvs(mcmc.parse_args(argv))
    return [*argv, *extra]


def hyperopt_script():
    sys.path.insert(0, str(REPO / "scripts"))
    import torch_smc_mh_hyperopt

    return torch_smc_mh_hyperopt


def read_trials(path):
    """A trials.csv as a list of dicts of floats (trial as int)."""
    import csv

    with open(path, newline="") as fh:
        return [{k: (int(v) if k == "trial" else float(v)) for k, v in r.items()}
                for r in csv.DictReader(fh)]


def hyperopt_eval_parity(device, failures):
    """Phase 15a: the port's evaluate_scene on the card on every estimate
    artifact of the six JAX searches against the JAX errors
    (``sweep_reference`` with the hyperopt fixture) under phase 14a's gates;
    each trial's cost (1 - VSD recall over its scenes) from the reference
    errors and from the port's beside the checked-in trials.csv. Returns the
    render_depth launches."""
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_depth
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
    from bayesianposeestimation.jl_tpu_torch.utils import evaluation as ev
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import (
        load_artifact,
        parse_savename,
    )

    bopval = bop_val_script()
    params = Parameters(device=device)
    cache = {}
    t0 = time.perf_counter()
    render_depth.launches = 0
    n_artifacts, n_reeval, worst_adds, worst_vsd = 0, 0, 0.0, 0.0
    for name in HYPEROPT_EXPERIMENTS:
        counts = {}  # trial -> [ref correct, ours correct, total]
        reeval = near = 0
        files = sorted((REPO / "data/exp_raw" / name).glob("*.npz"))
        for path in files:
            raw = load_artifact(path)
            ours = bopval.evaluate_scene(raw["__config__"], str(BOP_DIR), params,
                                         list(raw["result_rows"]), device, cache)
            ref, is_reeval = sweep_reference(name, path.name, REEVALUATED_HYPEROPT)
            reeval += is_reeval
            bad, w_adds, w_vsd, n_near = compare_errors(ours, ref, SWEEP_ADDS_REL_TOL,
                                                        SWEEP_VSD_ABS_TOL)
            worst_adds, worst_vsd = max(worst_adds, w_adds), max(worst_vsd, w_vsd)
            near += n_near
            if bad:
                failures.append(f"phase 15a {name}/{path.name}: {bad}")
                print(f"phase 15a {name}/{path.name}: FAILED {bad}")
            c = counts.setdefault(int(parse_savename(path.name)["trial"]), [0, 0, 0])
            n_ref, n_tot = ev.threshold_errors(ref["vsd"], ev.BOP18_THETA)
            c[0] += n_ref
            c[1] += ev.threshold_errors(ours["vsd"], ev.BOP18_THETA)[0]
            c[2] += n_tot
        n_artifacts += len(files)
        n_reeval += reeval
        trials = read_trials(REPO / "data/exp_pro" / name / "trials.csv")
        costs = []
        for h in trials:
            n_ref, n_ours, n_tot = counts[h["trial"]]
            costs.append((h["trial"], round(h["cost"], 4), round(1 - n_ref / n_tot, 4),
                          round(1 - n_ours / n_tot, 4)))
            if abs(n_ref - n_ours) > near:
                failures.append(f"phase 15a {name} trial {h['trial']}: cost from the port's "
                                f"errors {1 - n_ours / n_tot} vs the reference's "
                                f"{1 - n_ref / n_tot}")
        changed = [c[0] for c in costs if c[1] != c[2]]
        print(f"phase 15a {name}: {len(files)} artifacts ({reeval} held to the re-evaluation), "
              f"{near} entries near a threshold; trial costs (trial, checked-in, from the "
              f"reference errors, from the port's): {json.dumps(costs)}; the reference moves "
              f"the cost of trials {changed}")
    print(f"phase 15a evaluation of {n_artifacts} JAX estimate artifacts ({n_reeval} held to the "
          f"JAX package's re-evaluation) on the card: {time.perf_counter() - t0:.2f} s, "
          f"render_depth launches {render_depth.launches}; max ADD-S relative |d| "
          f"{worst_adds:.3g} (limit {SWEEP_ADDS_REL_TOL}), max VSD/VSDBOP |d| {worst_vsd:.4f} "
          f"(limit {SWEEP_VSD_ABS_TOL})")
    if n_artifacts != 108:
        failures.append(f"phase 15a evaluated {n_artifacts} artifacts, not 108")
    return render_depth.launches


def hyperopt_runs(device, failures, smi, workdir):
    """Phases 15b and 15c: each of HYPEROPT_RUNS through
    ``torch_smc_mh_hyperopt.main`` at its real settings with 2 trials on
    scene 1, into ``workdir``; then render_score with the trial's hyper row
    on the largest model's final particles against its plain version.
    Returns the kernels-line rows."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_score
    from bayesianposeestimation.jl_tpu_torch.utils import evaluation
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import load_artifact

    hyp = hyperopt_script()
    rows = []
    for name in HYPEROPT_RUNS:
        argv = hyperopt_argv(name, ["--trials", "2", "--scenes", "1", "--device", device,
                                    "--bop-dir", str(BOP_DIR)])
        args = hyp.parse_args(argv)
        per_step = 2 if args.sampler.startswith("mtm") else 1
        calibrations = []
        inner = evaluation.mean_step_time

        def counted(*a, **kw):
            calibrations.append(a[1].faces.shape[0])
            return inner(*a, **kw)

        evaluation.mean_step_time = counted
        render_score.launches = 0
        t0 = time.perf_counter()
        try:
            with EvaluationCount() as evals, RunnerLog(evals) as log:
                result = hyp.main(argv, data_root=workdir)
        finally:
            evaluation.mean_step_time = inner
        dt = time.perf_counter() - t0
        launches = render_score.launches
        calib = result["calibration"][1]
        steps = {k: v["n_steps"] for k, v in calib.items()}
        by_object = {}  # the chain runs of each object's runner (its mesh array)
        for c in log.calls:
            by_object.setdefault(id(c["verts"]), []).append(c)
        same_steps = all(len({c["n_steps"] for c in cs}) == 1 for cs in by_object.values())
        one_calibration = len(calibrations) == len(by_object) == len(calib)
        wrong = [(c["launches"], c["evals"], c["n_steps"]) for c in log.calls
                 if not c["launches"] == c["evals"] == 1 + per_step * (c["n_steps"] - 1)]
        # the rows' runs: the warm-up that captures each object's runner runs at
        # a seed from seed0 + 10**6 on, as scene_inference's (phase 14b)
        timed = [c for c in log.calls if c["seed"] < c["params"].seed % (2**31) + 10**6]
        raws = [load_artifact(p) for p in sorted(
            (Path(workdir) / "exp_raw" / f"{args.experiment_name}_cuda").glob("*.npz"))]
        finite = len(raws) == 2 and all(
            np.isfinite(r["t"]).all() and np.isfinite(r["q"]).all() and np.isfinite(r["score"])
            for raw in raws for r in raw["result_rows"])
        n_rows = sum(len(raw["result_rows"]) for raw in raws)
        trials = read_trials(Path(workdir) / "exp_pro" / f"{args.experiment_name}_cuda" /
                             "trials.csv")
        jax_trials = read_trials(REPO / "data/exp_pro" / name / "trials.csv")[:2]
        keys = ["trial", *(n for n, *_ in hyp.SPACE), "cost"]
        same_cands = (len(trials) == 2 and all(list(h) == keys for h in trials) and all(
            abs(a[k] - b[k]) <= 1e-12 for a, b in zip(trials, jax_trials) for k in keys[:-1]))
        jax_steps = sorted({int(load_artifact(p)["n_steps"]) for p in
                            (REPO / "data/exp_raw" / name).glob("*scene_id=1,*.npz")})
        walls = [r["time"] for raw in raws for r in raw["result_rows"]]
        print(f"phase 15b {name} (scene 1, 2 trials, {args.time_budget} s per pose) on {smi}: "
              f"{dt:.2f} s in all; calibrations by model faces {calibrations}; steps per "
              f"budget by object {json.dumps(steps)} (step ms "
              f"{json.dumps({k: round(v['step_time'] * 1e3, 4) for k, v in calib.items()})}; "
              f"the JAX run's on its TPU, scene 1: {jax_steps}); one step count per object for "
              f"both trials {same_steps}; {len(log.calls)} chain runs "
              f"({len(log.calls) - len(timed)} warm-ups) for {n_rows} rows; wall "
              f"per pose mean {np.mean(walls):.4f} s max {np.max(walls):.4f} s; launches "
              f"{launches} = evaluations {evals.n}; costs "
              f"{[round(h['cost'], 4) for h in trials]} (JAX "
              f"{[round(h['cost'], 4) for h in jax_trials]}); candidates equal the JAX "
              f"search's first two {same_cands}")
        if not one_calibration:
            failures.append(f"phase 15b {name}: {len(calibrations)} calibrations for "
                            f"{len(calib)} objects")
        if not same_steps or len(timed) != n_rows:
            failures.append(f"phase 15b {name}: step counts differ between trials, or "
                            f"{len(timed)} chain runs for {n_rows} rows")
        if not finite:
            failures.append(f"phase 15b {name}: non-finite estimates or missing artifacts")
        if wrong or launches != evals.n or launches == 0:
            failures.append(f"phase 15b {name}: launches vs evaluations {wrong[:3]}, total "
                            f"{launches} vs {evals.n}")
        if not same_cands:
            failures.append(f"phase 15b {name}: trials.csv vs the JAX search's candidates")
        # 15c: the kernel with the trial's hyper row on the largest model's final particles
        call = max(log.calls[::-1], key=lambda c: c["faces"].shape[0])
        hyper = call["rest"][0]
        row_h = torch.tensor([hyper["pixel_sigma"], hyper["association_sigma"]],
                             dtype=torch.float32, device=device)
        kernel_args = sweep_kernel_args(call, device, args.n_particles if per_step == 2 else None)
        shape = (f"{kernel_args[1].shape[0]} faces {kernel_args[2].width}x"
                 f"{kernel_args[2].height} {kernel_args[3].shape[0]} poses")
        row, res = score_row(kernel_args, device, f"phase 15c render_score[association+hyper] "
                             f"at {name}", smi, hyper=row_h)
        if not res["ok"] or row[1] is None:
            failures.append(f"phase 15c render_score+hyper at {name}: vs plain, or no device "
                            f"time")
        rows.append((f"render_score[association+hyper] {name} {shape}", launches,
                     f"phase 15b torch_smc_mh_hyperopt.main, 2 trials on scene 1",
                     res["max_abs_err"], row))
    return rows


def compare_generated_scene(out_dir, ref_dir, img_ids):
    """A generated scene directory against a checked-in one, image by image:
    (failed checks, measured differences). Obj ids and instance counts must
    be equal, cam_t_m2c within 1e-9 mm, cam_R_m2c within 1e-5, the cameras
    equal, each mask_visib within GEN_MASK_IOU, each visib_fract within
    GEN_VISIB_TOL, each depth PNG within GEN_DEPTH_UNITS wherever both
    scenes' masks (the union over the image's instances) agree."""
    import numpy as np

    from bayesianposeestimation.jl_tpu_torch.utils.png import read_png

    out_dir, ref_dir = Path(out_dir), Path(ref_dir)

    def load(d, name):
        return json.loads((d / name).read_text())

    gt_o, gt_r = load(out_dir, "scene_gt.json"), load(ref_dir, "scene_gt.json")
    info_o, info_r = load(out_dir, "scene_gt_info.json"), load(ref_dir, "scene_gt_info.json")
    cam_o, cam_r = load(out_dir, "scene_camera.json"), load(ref_dir, "scene_camera.json")
    bad = []
    stats = dict(t_mm=0.0, R=0.0, min_iou=1.0, mask_px=0, visib=0.0, depth_units=0,
                 depth_px_over=0, depth_units_all=0)
    for k in (str(i) for i in img_ids):
        if [g["obj_id"] for g in gt_o[k]] != [g["obj_id"] for g in gt_r[k]]:
            bad.append(f"image {k}: obj ids or instance count")
            continue
        if cam_o[k] != cam_r[k]:
            bad.append(f"image {k}: camera")
        union_o = union_r = 0
        for j, (a, b) in enumerate(zip(gt_o[k], gt_r[k])):
            stats["t_mm"] = max(stats["t_mm"], float(np.abs(
                np.subtract(a["cam_t_m2c"], b["cam_t_m2c"])).max()))
            stats["R"] = max(stats["R"], float(np.abs(
                np.subtract(a["cam_R_m2c"], b["cam_R_m2c"])).max()))
            m_o = read_png(out_dir / "mask_visib" / f"{int(k):06d}_{j:06d}.png") > 0
            m_r = read_png(ref_dir / "mask_visib" / f"{int(k):06d}_{j:06d}.png") > 0
            iou = (m_o & m_r).sum() / max((m_o | m_r).sum(), 1)
            stats["min_iou"] = min(stats["min_iou"], float(iou))
            stats["mask_px"] = max(stats["mask_px"], int((m_o ^ m_r).sum()))
            stats["visib"] = max(stats["visib"], abs(info_o[k][j]["visib_fract"]
                                                     - info_r[k][j]["visib_fract"]))
            union_o, union_r = union_o | m_o, union_r | m_r
        d_o = read_png(out_dir / "depth" / f"{int(k):06d}.png").astype(np.int64)
        d_r = read_png(ref_dir / "depth" / f"{int(k):06d}.png").astype(np.int64)
        diff = np.abs(d_o - d_r)
        agree = union_o == union_r
        stats["depth_units"] = max(stats["depth_units"], int(diff[agree].max()))
        stats["depth_px_over"] += int((diff[agree] > GEN_DEPTH_UNITS).sum())
        stats["depth_units_all"] = max(stats["depth_units_all"], int(diff.max()))
    if cam_o.keys() != {str(i) for i in img_ids} or gt_o.keys() != cam_o.keys():
        bad.append(f"images {sorted(gt_o)} written, not {list(img_ids)}")
    if stats["t_mm"] > 1e-9:
        bad.append(f"cam_t_m2c |d| {stats['t_mm']} mm")
    if stats["R"] > 1e-5:
        bad.append(f"cam_R_m2c |d| {stats['R']}")
    if stats["min_iou"] < GEN_MASK_IOU:
        bad.append(f"mask IoU {stats['min_iou']:.4f}")
    if stats["visib"] > GEN_VISIB_TOL:
        bad.append(f"visib_fract |d| {stats['visib']:.4f}")
    if stats["depth_px_over"]:
        bad.append(f"{stats['depth_px_over']} depth pixels over {GEN_DEPTH_UNITS} unit where the "
                   f"masks agree")
    return bad, stats


def gt_quaternions(scene_dir):
    """The rotations of a scene's annotations as quaternions [4], in the
    order the generator draws them (image by image, instance by instance)."""
    import torch

    from bayesianposeestimation.jl_tpu_torch import quaternions as quat

    gt = json.loads((Path(scene_dir) / "scene_gt.json").read_text())
    return [quat.matrix_to_quat(torch.tensor(g["cam_R_m2c"], dtype=torch.float32)
                                .reshape(3, 3)).numpy()
            for k in sorted(gt, key=int) for g in gt[k]]


def generator_script():
    sys.path.insert(0, str(REPO / "scripts"))
    import torch_make_synthetic_bop

    return torch_make_synthetic_bop


GENERATOR_RUNS = (
    # (label, arguments, checked-in scene, images, rotations)
    ("easy, synth val scene 1", ["--seed", "0"], "synth/val/000001", range(8), "scene_gt"),
    ("cad, synthcad train scene 1", ["--profile", "cad", "--split", "train", "--n-scenes", "1",
                                     "--n-images", "2", "--seed", "77"],
     "synthcad/train/000001", range(2), "jax"),
)


def generator_phase(device, failures, smi, workdir):
    """Phase 15d: the generator's easy and cad profiles into ``workdir`` with
    the checked-in (easy) or the JAX script's (cad) rotations injected,
    against the checked-in scenes (``compare_generated_scene``), one
    render_depth launch per solo render; then render_depth at the 160x160
    window on the 128,000-face model at the cad scene's pose of it (front
    faces), bitwise against its plain version and timed. Returns (the cad
    run's render_depth launches, timing row, relative depth max)."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch import quaternions as quat
    from bayesianposeestimation.jl_tpu_torch.camera import CvCamera
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import mesh_tensors, render_depth

    gen = generator_script()
    launches = {}
    for label, argv, ref, img_ids, rot in GENERATOR_RUNS:
        args = gen.parse_args(["--root", str(Path(workdir) / "bop"), "--device", device, *argv])
        draws = (gt_quaternions(BOP_DIR / ref) if rot == "scene_gt" else
                 json.loads(JAX_QUATERNIONS.read_text())["quaternions"])
        it = iter(draws)
        render_depth.launches = 0
        out = gen.generate(args, draw_quaternion=lambda: np.asarray(next(it), np.float32))
        launches[label] = render_depth.launches
        bad, stats = compare_generated_scene(out["split_dir"] / Path(ref).name, BOP_DIR / ref,
                                             img_ids)
        secs = out["seconds"]
        print(f"phase 15d generator {label} on {smi}: {len(secs)} images in {sum(secs):.3f} s "
              f"({np.mean(secs):.4f} s per image, first {secs[0]:.4f} s, the rest "
              f"{np.mean(secs[1:]):.4f} s); {out['renders']} solo renders, render_depth "
              f"launches {render_depth.launches}; against the checked-in scene: "
              f"{json.dumps(stats)}; {bad or 'all gates met'}")
        if bad:
            failures.append(f"phase 15d generator {label}: {bad}")
        if render_depth.launches != out["renders"]:
            failures.append(f"phase 15d generator {label}: {render_depth.launches} launches for "
                            f"{out['renders']} solo renders")
    # the kernel at the 128,000-face model's pose in the cad scene (image 1)
    gt = json.loads((Path(workdir) / "bop/synthcad/train/000001/scene_gt.json").read_text())
    g = gt["1"][0]
    mesh = gen.build_objects("cad")[g["obj_id"]]
    verts, faces = mesh_tensors(mesh.vertices, mesh.faces, device)
    t = np.asarray(g["cam_t_m2c"]) / 1000.0
    q = quat.matrix_to_quat(torch.tensor(g["cam_R_m2c"], dtype=torch.float32).reshape(3, 3))
    cam = CvCamera(width=640, height=480, f_x=580.0, f_y=580.0, c_x=319.5, c_y=239.5,
                   near=0.01, far=10.0)
    win = gen.window_camera(cam, *gen.window_origin(cam, t))
    args = (verts, faces, win, torch.as_tensor(t[None], dtype=torch.float32, device=device),
            q[None].to(device).contiguous())
    ok, timing, one_block, slices = render_depth_check(
        device, smi, args, "15d", backface_cull=True,
        shape=f"the generator's {gen.WINDOW}x{gen.WINDOW} window")
    if not ok:
        failures.append("phase 15d render_depth at the generator's shape: vs plain, vs one "
                        "block per pose, or no device time")
    return launches["cad, synthcad train scene 1"], timing, slices


def hyperopt_phase(device, failures, smi):
    """Phase 15: the hyperparameter searches and the synthetic BOP generator.
    Returns (the kernels-line rows of render_score at the searches' shapes,
    the generator's render_depth row)."""
    import tempfile

    t0 = time.perf_counter()
    hyperopt_eval_parity(device, failures)
    print(f"phase 15a took {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as workdir:
        t1 = time.perf_counter()
        rows = hyperopt_runs(device, failures, smi, workdir)
        print(f"phase 15b-c took {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        gen_launches, gen_timing, gen_slices = generator_phase(device, failures, smi, workdir)
        print(f"phase 15d took {time.perf_counter() - t1:.1f} s")
    print(f"phase 15 took {time.perf_counter() - t0:.1f} s")
    return rows, (gen_launches, gen_timing, gen_slices)


# -- phase 16: the JAX package's BOP runs without a port counterpart ------------

# the JAX package's runs of scripts/smc_bop_val.py (data/exp_raw/<name>,
# data/exp_pro/<name>), all smc_mh: each run's arguments, read off its
# artifacts (split and scenes from the configs; the budget from n_steps x
# step_time: 0.43-0.47 s of 0.5 s, 0.024 s of 0.05 s and 0.072 s of 0.10 s
# after the 0.92 safety factor)
BOP_RUNS = {
    "smc_bop_val": ["--dataset", "synth", "--testset", "val", "--scenes", "1"],
    "smc_bop_val2": ["--dataset", "synth", "--testset", "val2", "--scenes", "1", "2", "3"],
    "smc_bop_val2_b005": ["--dataset", "synth", "--testset", "val2", "--scenes", "1",
                          "--time-budget", "0.05"],
    "smc_bop_val2_b010": ["--dataset", "synth", "--testset", "val2", "--scenes", "1",
                          "--time-budget", "0.1"],
    "smc_bop_cad_val2": ["--dataset", "synthcad", "--testset", "val2", "--scenes", "1", "2"],
    "hard_cases": ["--dataset", "synth", "--testset", "hard", "--scenes", "1"],
}
# the JAX package's errors of today where the checked-in errors are stale (the
# six synth artifacts of the val / val2 runs; scripts/reevaluate_errors.py)
REEVALUATED_BOP_RUNS = REPO / "tests/fixtures/reevaluated_errors_bop_runs.npz"
# phase 16b: scene_inference on scene 1 of each new split, its first two images
BOP_RUN_CUTS = ("hard_cases", "smc_bop_val2_b005", "smc_bop_cad_val2")
CUT_IMAGES = 2
BUDGET_SLACK = 1.05  # the port's budget_ok slack (scripts/torch_mcmc_benchmark.py)
# the two configs whose recorded means overran their budget before the step
# counts followed the realized pace: (script, arguments, the config's keys)
BUDGET_RUNS = (
    ("torch_mcmc_benchmark", ["--mtm-tries", "5", "--budgets", "0.5"],
     {"sampler": "mh_sampler"}),
    ("torch_smc_benchmark", ["--particles", "100", "--budgets", "0.05"], {}),
)


def bop_run_args(name, device="cpu", extra=()):
    """scripts/torch_smc_bop_val.py's arguments and configs for a JAX run of
    BOP_RUNS (the configs name its artifacts)."""
    bopval = bop_val_script()
    args = bopval.parse_args([*BOP_RUNS[name], "--samplers", "smc_mh", "--experiment-name",
                              name, "--device", device, *extra])
    return args, bopval.sweep_configs(args)


@contextlib.contextmanager
def first_images(n=CUT_IMAGES):
    """The BOP readers cut to the first ``n`` images of a scene while in
    use (targets and ground truth alike)."""
    from bayesianposeestimation.jl_tpu_torch.utils import bop

    inner = bop.bop_test_or_train

    def cut(*args):
        rows = inner(*args)
        keep = sorted({r["img_id"] for r in rows})[:n]
        return [r for r in rows if r["img_id"] in keep]

    bop.bop_test_or_train = cut
    try:
        yield
    finally:
        bop.bop_test_or_train = inner


def bop_runs_eval_parity(device, failures, smi):
    """Phase 16a: the port's evaluate_scene on the card on the nine estimate
    artifacts of the six JAX runs against the JAX errors (``sweep_reference``
    with REEVALUATED_BOP_RUNS) under phase 14a's gates, each run's recall
    beside the reference's; then render_depth at the hard split's evaluation
    shape bitwise against its plain version, timed. Returns (the
    evaluation's render_depth launches, the timing row, the face slices)."""
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_depth
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import load_artifact, savename

    bopval = bop_val_script()
    params = Parameters(device=device)
    cache = {}
    t0 = time.perf_counter()
    render_depth.launches = 0
    n_artifacts, n_reeval, worst_adds, worst_vsd = 0, 0, 0.0, 0.0
    for name in BOP_RUNS:
        _, configs = bop_run_args(name, device)
        ours_all, refs_all, near = [], [], 0
        for config in configs:
            file = savename(config) + ".npz"
            raw = load_artifact(REPO / "data/exp_raw" / name / file)
            ours = bopval.evaluate_scene(raw["__config__"], str(BOP_DIR), params,
                                         list(raw["result_rows"]), device, cache)
            ref, is_reeval = sweep_reference(name, file, REEVALUATED_BOP_RUNS)
            n_reeval += is_reeval
            bad, w_adds, w_vsd, n_near = compare_errors(ours, ref, SWEEP_ADDS_REL_TOL,
                                                        SWEEP_VSD_ABS_TOL)
            worst_adds, worst_vsd, near = max(worst_adds, w_adds), max(worst_vsd, w_vsd), \
                near + n_near
            if bad:
                failures.append(f"phase 16a {name}/{file}: {bad}")
                print(f"phase 16a {name}/{file}: FAILED {bad}")
            ours_all.append(ours)
            refs_all.append(ref)
        n_artifacts += len(configs)
        [mine], _ = bopval.recall_rows({"smc_mh": ours_all})
        [theirs], _ = bopval.recall_rows({"smc_mh": refs_all})
        for k in ("vsd_recall", "adds_recall"):
            if abs(mine[k] - theirs[k]) * mine["n_gt"] > near + 1e-9:
                failures.append(f"phase 16a {name} {k}: {mine[k]} vs {theirs[k]}")
        print(f"phase 16a {name}: {len(configs)} artifacts, n={mine['n_gt']}; VSD / ADD-S / "
              f"VSDBOP recall {mine['vsd_recall']:.4f} / {mine['adds_recall']:.4f} / "
              f"{mine['vsdbop_recall']:.4f} (the JAX reference's {theirs['vsd_recall']:.4f} / "
              f"{theirs['adds_recall']:.4f} / {theirs['vsdbop_recall']:.4f}); {near} entries "
              f"near a threshold")
    launches = render_depth.launches
    print(f"phase 16a evaluation of {n_artifacts} JAX estimate artifacts ({n_reeval} held to the "
          f"JAX package's re-evaluation) on the card: {time.perf_counter() - t0:.2f} s, "
          f"render_depth launches {launches}; max ADD-S relative |d| {worst_adds:.3g} (limit "
          f"{SWEEP_ADDS_REL_TOL}), max VSD/VSDBOP |d| {worst_vsd:.4f} (limit "
          f"{SWEEP_VSD_ABS_TOL})")
    if n_artifacts != 9:
        failures.append(f"phase 16a evaluated {n_artifacts} artifacts, not 9")
    args = evaluation_depth_args(device, "synth", "hard", 3, REPO / "data/exp_raw/hard_cases")
    ok, timing, _, slices = render_depth_check(device, smi, args, "16a",
                                               shape="the hard split's evaluation shape")
    if not ok:
        failures.append("phase 16a render_depth at the hard evaluation shape: vs plain, vs one "
                        "block per pose, or no device time")
    return launches, timing, slices


def bop_run_cuts(device, failures, smi, workdir):
    """Phase 16b: scripts/torch_smc_bop_val.py's scene_inference on the first
    two images of scene 1 of each new split (BOP_RUN_CUTS, at its JAX run's
    budget): finite estimates, launches = likelihood evaluations = 1 +
    (steps - 1) per chain run; render_score[association] at the hard and
    val2 crops against its plain version, timed; then the two configs of
    BUDGET_RUNS through their scripts' ``run`` on scene 1 whole (12 poses:
    a mean over the three poses of two images swings by a tenth): the mean
    wall per pose within BUDGET_SLACK x the budget. Returns {label:
    (launches, kernel row)}."""
    import numpy as np

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_score
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import load_artifact, savename

    bopval = bop_val_script()
    launches = {}
    for name in BOP_RUN_CUTS:
        args, configs = bop_run_args(name, device)
        config = configs[0]
        params = Parameters(n_particles=args.n_particles, time_budget=args.time_budget,
                            device=device, **bopval.tuned_parameters(args.dataset, "smc_mh"))
        render_score.launches = 0
        t0 = time.perf_counter()
        with first_images(), EvaluationCount() as evals, RunnerLog(evals) as log:
            result = bopval.scene_inference(config, str(BOP_DIR), params, device)
        dt = time.perf_counter() - t0
        launches[name] = render_score.launches
        rows = result["result_rows"]
        if not rows or not all(np.isfinite(r["t"]).all() and np.isfinite(r["q"]).all()
                               and np.isfinite(r["score"]) for r in rows):
            failures.append(f"phase 16b {name}: no rows or non-finite estimates")
        wrong = [(c["launches"], c["evals"], c["n_steps"]) for c in log.calls
                 if not c["launches"] == c["evals"] == 1 + (c["n_steps"] - 1)]
        if wrong or render_score.launches != evals.n or render_score.launches == 0:
            failures.append(f"phase 16b {name}: launches vs evaluations {wrong[:3]}, total "
                            f"{render_score.launches} vs {evals.n}")
        walls = [r["time"] for r in rows]
        jax_steps = int(load_artifact(REPO / "data/exp_raw" / name /
                                      (savename(config) + ".npz"))["n_steps"])
        print(f"phase 16b {name} ({args.dataset} {args.testset} scene 1, {len(rows)} rows of "
              f"{CUT_IMAGES} images, {args.time_budget} s per pose) on {smi}: {dt:.2f} s in all; "
              f"steps per run {[r['n_steps'] for r in rows]} (the JAX run's on its TPU "
              f"{jax_steps}); wall per pose mean {np.mean(walls):.4f} s max "
              f"{np.max(walls):.4f} s; launches {render_score.launches} = evaluations {evals.n}")
    rows_out = {}
    for label, testset, obj_id, name in (("hard crop", "hard", 3, "hard_cases"),
                                         ("val2 crop", "val2", 1, "smc_bop_val2_b005")):
        row = bop_kernel_rows(device, smi, "synth", obj_id, (100,), "16b", testset)[100]
        if not row[-1]["ok"] or row[1] is None:
            failures.append(f"phase 16b render_score at the {label}: vs plain, or no device "
                            f"time")
        rows_out[label] = (launches[name], row)
    for script_name, argv, select in BUDGET_RUNS:
        script, module = sweep_script(script_name)
        args = script.parse_args([*argv, "--device", device, "--bop-dir", str(BOP_DIR)])
        [config] = [c for c in module.configs(args)
                    if all(c[k] == v for k, v in select.items())]
        result, _ = module.run(config, args, {}, data_root=workdir)
        walls = [r["time"] for r in result["result_rows"]]
        mean = float(np.mean(walls))
        ok = mean <= BUDGET_SLACK * config["pose_time"]
        print(f"phase 16b budget {script_name} {config['sampler']} {config['n_particles']} x "
              f"{config['pose_time']} s on {smi}: {len(walls)} poses, steps "
              f"{[r['n_steps'] for r in result['result_rows']]}, wall per pose "
              f"{[round(w, 4) for w in walls]}, mean {mean:.4f} s (limit "
              f"{BUDGET_SLACK * config['pose_time']:.4f} s): {ok}")
        if not ok:
            failures.append(f"phase 16b {script_name} {config['sampler']} mean wall {mean:.4f} s "
                            f"over {BUDGET_SLACK} x {config['pose_time']} s")
    return rows_out


def steri_on_demand(device, failures, smi, workdir):
    """Phase 16c: scripts/torch_smc_benchmark_steri.py into a --bop-dir that
    lacks synth_steri, from ``workdir``: the generator makes the set (8
    images), then one config (100 particles x 0.25 s) on its first two
    images writes its table; launches = likelihood evaluations."""
    import csv
    import os

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_score

    steri, _ = sweep_script("torch_smc_benchmark_steri")
    bop_dir = Path(workdir) / "bop"
    argv = ["--bop-dir", str(bop_dir), "--particles", "100", "--budgets", "0.25", "--device",
            device]
    cwd = os.getcwd()
    render_score.launches = 0
    t0 = time.perf_counter()
    os.chdir(workdir)
    try:
        with first_images(), EvaluationCount() as evals:
            rc = steri.main(argv)
    finally:
        os.chdir(cwd)
    dt = time.perf_counter() - t0
    scene = bop_dir / "synth_steri/val/000001"
    n_images = len(list((scene / "depth").glob("*.png"))) if scene.is_dir() else 0
    table = Path(workdir) / "data/exp_pro/smc_benchmark_steri_cuda/recall_vs_budget.csv"
    rows = list(csv.DictReader(open(table, newline=""))) if table.is_file() else []
    print(f"phase 16c steri script into a --bop-dir without the set on {smi}: rc {rc}, "
          f"{dt:.2f} s in all; {n_images} images generated; table {rows}; launches "
          f"{render_score.launches} = evaluations {evals.n}")
    if rc != 0 or n_images != 8 or len(rows) != 1:
        failures.append(f"phase 16c steri script: rc {rc}, {n_images} images, {len(rows)} rows")
    if render_score.launches != evals.n or render_score.launches == 0:
        failures.append(f"phase 16c launches {render_score.launches} vs evaluations {evals.n}")


def bop_runs_phase(device, failures, smi):
    """Phase 16: the JAX package's BOP runs without a port counterpart, the
    budget repair and synth_steri on demand. Returns (16a's render_depth
    launches, timing row and face slices; 16b's kernel rows)."""
    import tempfile

    t0 = time.perf_counter()
    eval_launches, eval_timing, eval_slices = bop_runs_eval_parity(device, failures, smi)
    print(f"phase 16a took {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as workdir:
        t1 = time.perf_counter()
        rows = bop_run_cuts(device, failures, smi, workdir)
        print(f"phase 16b took {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        steri_on_demand(device, failures, smi, workdir)
        print(f"phase 16c took {time.perf_counter() - t1:.1f} s")
    print(f"phase 16 took {time.perf_counter() - t0:.1f} s")
    return (eval_launches, eval_timing, eval_slices), rows


# -- phase 17: the figure scripts and the colour decoders ----------------------------

COLOR_FIXTURES = REPO / "tests/fixtures/color"
O_TOL = dict(rtol=1e-5, atol=1e-6)  # the association image, card against CPU


def figure_panels(scripts, device, failures, smi):
    """Phase 17a: the panels of scripts/torch_plot_depth_imgs.py,
    torch_visualize_crop.py and torch_visualize_full_scene.py on synth val
    scene 1 (the scripts' defaults): each script's render_depth launches
    counted on its own (one per render, none for the host crops); mu and the
    full-frame render bitwise against the plain version over NaN (and
    timed), the panels against the same computation on CPU tensors, gen in
    distribution. Returns the kernels-line rows."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_depth
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters

    depth_imgs, crop, full = scripts
    argv = ["--bop-dir", str(BOP_DIR)]
    d_args, c_args, f_args = (m.parse_args(argv) for m in (depth_imgs, crop, full))
    launches, out = {}, {}
    for label, run in (("plot_depth_imgs", lambda: depth_imgs.panels(d_args, device)),
                       ("visualize_crop", lambda: crop.panels(c_args)),
                       ("visualize_full_scene", lambda: full.panels(f_args, device))):
        render_depth.launches = 0
        out[label] = run()
        launches[label] = render_depth.launches
    card, crops, scene = out["plot_depth_imgs"], out["visualize_crop"], out["visualize_full_scene"]
    expected = {"plot_depth_imgs": 1, "visualize_crop": 0, "visualize_full_scene": 1}
    print(f"phase 17a panels on {smi}: render_depth launches {launches}, renders {expected} "
          f"(plot_depth_imgs mu {card['mu'].shape}, visualize_full_scene "
          f"{scene['render'].shape}, {int((scene['render'] > 0).sum())} object pixels)")
    if launches != expected:
        failures.append(f"phase 17a: render_depth launches {launches} for renders {expected}")
    cpu = depth_imgs.panels(d_args, "cpu")
    sigma = Parameters().pixel_sigma
    k, n, least = depth_imgs.within_3_sigma(card["gen"], card["mu"], sigma)
    checks = {
        "z equal": bool(np.array_equal(card["z"], cpu["z"])),
        "mu equal to the CPU's": bool(np.array_equal(card["mu"], cpu["mu"])),
        "o close": bool(np.allclose(card["o"], cpu["o"], **O_TOL)),
        "gen zero off the object": bool((card["gen"][card["mu"] == 0] == 0).all()),
        "gen within 3 sigma": k >= least,
        "crops": all(c.shape == (int(name.split("_")[1]),) * 2 and (c > 0).any()
                     for name, c in crops.items()),
        "full-frame depth": scene["depth"].shape == scene["render"].shape == (480, 640),
    }
    print(f"phase 17a against the CPU: o max |d| "
          f"{float(np.abs(card['o'] - cpu['o']).max()):.2e}; gen: {k} of {n} object pixels "
          f"within 3 sigma ({least:.1f} needed); crops {[c.shape for c in crops.values()]}; "
          f"{json.dumps(checks)}")
    failures.extend(f"phase 17a: {name}" for name, ok in checks.items() if not ok)
    rows = []
    for label, script, args in (("plot_depth_imgs", depth_imgs, d_args),
                                ("visualize_full_scene", full, f_args)):
        inputs = script.render_inputs(args, device)[0]
        ok, row, err = graph_depth_row(inputs, device, smi, f"{label}'s gt pose", phase="17a")
        if not ok:
            failures.append(f"phase 17a render_depth at {label}'s shape: vs plain, or no "
                            f"device time")
        rows.append((f"render_depth {inputs[1].shape[0]} faces {inputs[2].width}x"
                     f"{inputs[2].height} 1 pose ({label})", launches[label],
                     f"phase 17a {label} panels", err, row))
    torch.cuda.synchronize()
    return rows


def logjac_on_card(logjac, device, failures):
    """Phase 17b: scripts/torch_simple_logjac.py's three chains on the card
    at CHECK_STEPS steps, each mean within its stated bound of theta."""
    z = logjac.chains(logjac.parse_args(["--n-steps", str(logjac.CHECK_STEPS),
                                         "--device", device]))
    for label, bound in logjac.MEAN_REL_BOUND.items():
        rel = abs(float(z[label].mean()) - logjac.THETA) / logjac.THETA
        print(f"phase 17b {label}: mean {z[label].mean():.4f}, rel err {rel:.4f} "
              f"(bound {bound})")
        if not rel <= bound:
            failures.append(f"phase 17b simple_logjac {label}: rel err {rel:.3f} > {bound}")


def color_fixtures(failures):
    """Phase 17c: the colour fixtures decoded by utils.png / utils.jpeg
    against their checked-in imageio decodes, bitwise."""
    import numpy as np

    from bayesianposeestimation.jl_tpu_torch.utils.jpeg import read_jpeg
    from bayesianposeestimation.jl_tpu_torch.utils.png import read_png

    for name in ("rgb.png", "rgba.png", "ycc420.jpg"):
        path = COLOR_FIXTURES / name
        ours = read_png(path) if path.suffix == ".png" else read_jpeg(path)
        ref = np.load(COLOR_FIXTURES / f"{path.stem}.npy")
        if ours.shape != ref.shape or ours.dtype != ref.dtype:
            print(f"phase 17c {name}: {ours.shape} {ours.dtype}, imageio {ref.shape} {ref.dtype}")
            failures.append(f"phase 17c {name}: shape or dtype")
            continue
        d = np.abs(ours.astype(int) - ref.astype(int))
        ok = bool(np.array_equal(ours, ref))
        print(f"phase 17c {name}: {ours.shape} {ours.dtype} against imageio's decode: "
              f"max |d| {int(d.max())}, mean {float(d.mean()):.4f}; bitwise equal {ok}")
        if not ok:
            failures.append(f"phase 17c {name}")


def figures_phase(device, failures, smi):
    """Phase 17: the figure scripts and the colour decoders. Returns 17a's
    kernels-line rows."""
    sys.path.insert(0, str(REPO / "scripts"))
    import torch_plot_depth_imgs
    import torch_simple_logjac
    import torch_visualize_crop
    import torch_visualize_full_scene

    t0 = time.perf_counter()
    rows = figure_panels((torch_plot_depth_imgs, torch_visualize_crop,
                          torch_visualize_full_scene), device, failures, smi)
    print(f"phase 17a took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    logjac_on_card(torch_simple_logjac, device, failures)
    print(f"phase 17b took {time.perf_counter() - t1:.1f} s")
    color_fixtures(failures)
    print(f"phase 17 took {time.perf_counter() - t0:.1f} s")
    return rows


# -- phase 18: the captured chains against the eager loop -----------------------

CAPTURE_REPS = 3  # timed runs of each path after its warm-up
# the host's calls that put work on the device: kernel launches, graph
# launches, copies and fills
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                     "cudaMemsetAsync")


def tree_difference(a, b):
    """(bitwise equal, max relative difference over the finite entries, or
    inf where the structure or the non-finite entries differ) of two states
    or output dicts."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.capture import tree_leaves

    sa, la = tree_leaves(a)
    sb, lb = tree_leaves(b)
    if sa != sb:
        return False, math.inf
    equal, worst = True, 0.0
    for x, y in zip(la, lb):
        if torch.equal(x, y) or torch.allclose(x, y, rtol=0, atol=0, equal_nan=True):
            continue
        equal = False
        xd, yd = x.double(), y.double()
        fin = torch.isfinite(xd) & torch.isfinite(yd)
        if not torch.equal(torch.isfinite(xd), torch.isfinite(yd)):
            return False, math.inf
        if bool(fin.any()):
            rel = (xd - yd).abs() / yd.abs().clamp(min=1e-12)
            worst = max(worst, float(rel[fin].max()))
    return equal, worst


def profile_path(fn, n_units):
    """``fn()`` under torch.profiler: the profiled wall seconds, the device's
    busy seconds (kernels, copies and fills; one stream at a time) and idle
    share, the host's launches per unit (``HOST_LAUNCH_CALLS``), its graph
    launches and the kernels of csrc/render_score.cu the device ran (those
    a graph replay runs included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, host, graphs, raster = 0.0, 0, 0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += e.time_range.elapsed_us()
            raster += "render_score_kernel" in e.name
        elif e.name in HOST_LAUNCH_CALLS:
            host += 1
            graphs += e.name == "cudaGraphLaunch"
    busy = busy_us * 1e-6
    return {"profiled_wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall if wall else None,
            "host_launches_per_unit": host / n_units, "graph_launches": graphs,
            "render_score_kernels": raster}


def compare_paths(label, eager, captured, failures, phase="18"):
    """Print and gate one captured-vs-eager comparison (bitwise expected)."""
    equal, rel = tree_difference(captured, eager)
    print(f"phase {phase} {label}: captured vs eager bitwise equal {equal}"
          + ("" if equal else f", max relative difference {rel:.3g}"))
    if not equal:
        failures.append(f"phase {phase} {label}: captured differs from eager (max rel {rel})")
    return equal


def timed_path(run, n_units, trials=CAPTURE_REPS):
    """A warm-up call of ``run(seed)`` (the capture, on a captured path),
    then ``trials`` timed calls at one seed: (the last output, wall seconds
    of each call)."""
    import torch

    run(1000)
    torch.cuda.synchronize()
    walls = []
    for _ in range(trials):
        t0 = time.perf_counter()
        out = run(0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, walls


def path_metrics(label, run, n_units, unit, n_particles, smi, profile=None):
    """Time ``run`` and profile one more call of it (or ``profile`` = (a
    call, its units), a shorter run of the same path): wall seconds, ms per
    unit, hypotheses (particles x units) per second, the device's idle share
    of the profiled and the unprofiled wall and the host's launches per
    unit, with the profiler's render_score kernels beside the counted
    launches (printed; phase 18d gates the count in a process of its own)."""
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_score

    out, walls = timed_path(run, n_units)
    best = min(walls)
    prof_fn, prof_units = profile or ((lambda: run(0)), n_units)
    l0 = render_score.launches
    with EvaluationCount() as evals:
        prof = profile_path(prof_fn, prof_units)
    launches = render_score.launches - l0
    busy_per_unit = prof["device_busy_s"] / prof_units
    m = {"walls_s": walls, "ms_per_unit": best / n_units * 1e3,
         "hypotheses_per_s": n_particles * n_units / best,
         "idle_share_profiled": prof["idle_share"],
         "idle_share_unprofiled": 1.0 - busy_per_unit * n_units / best,
         "host_launches_per_unit": prof["host_launches_per_unit"],
         "graph_launches": prof["graph_launches"],
         "profiler_kernels": prof["render_score_kernels"], "launches": launches,
         "evaluations": evals.n}
    print(f"phase 18 {label} on {smi}: best of {[round(w, 4) for w in walls]} s, "
          f"{m['ms_per_unit']:.4f} ms per {unit}, {m['hypotheses_per_s']:.1f} hypotheses/s, "
          f"device idle {m['idle_share_unprofiled']:.3f} of the wall "
          f"({m['idle_share_profiled']:.3f} profiled), host launches per {unit} "
          f"{m['host_launches_per_unit']:.2f} ({m['graph_launches']} graph launches in "
          f"{prof_units} {unit}s profiled), render_score kernels there: profiler "
          f"{m['profiler_kernels']}, counted {launches}, likelihood evaluations {evals.n}")
    return out, m


def kernel_count_gate(label, counts, expected, failures):
    """The profiler's render_score kernels of one replayed run equal the
    counted launches and evaluations and ``expected``."""
    c = counts
    ok = c["profiler_kernels"] == c["launches"] == c["evaluations"] == expected
    print(f"phase 18d {label}: profiler {c['profiler_kernels']} render_score kernels, "
          f"counted launches {c['launches']}, evaluations {c['evaluations']}, expected "
          f"{expected}: {'equal' if ok else 'DIFFERENT'}")
    if not ok:
        failures.append(f"phase 18d {label}: profiler kernels {c['profiler_kernels']}, "
                        f"launches {c['launches']}, evaluations {c['evaluations']}, "
                        f"expected {expected}")


def captured_flagship(device, failures, smi, n_steps=500, n_particles=100):
    """Phase 18a: the flagship chain (bench_torch's configuration) captured
    and eager: bitwise equal, reseeded equal, another seed different, the
    profiler's kernels of one replayed chain equal to the counters."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.models.experiment_samplers import smc_mh
    from bayesianposeestimation.jl_tpu_torch.models.fused import fused_posterior
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
    from bayesianposeestimation.jl_tpu_torch.samplers import sample_chain
    from bayesianposeestimation.jl_tpu_torch.samplers.chain import chain_runner

    params = Parameters(n_steps=n_steps, n_particles=n_particles,
                        proposal_sigma_r=(0.5, 0.5, 0.5), device=str(device))
    exp, _, _, _ = bench_scene(device)
    post = fused_posterior(params, exp, "association", device=device)
    sampler = smc_mh(params, post)
    res = {}
    for label, captured in (("eager", False), ("captured", True)):
        def run(seed, captured=captured):
            return sample_chain(seed, post, sampler, n_steps, n_particles, device=device,
                                captured=captured)

        def short(captured=captured):  # profiled: 100 steps of the same path
            return sample_chain(0, post, sampler, 101, n_particles, device=device,
                                captured=captured)

        out, m = path_metrics(f"18a flagship chain {label} (smc_mh, 1280 faces, 30x30, "
                              f"{n_particles} particles, {n_steps} steps)", run, n_steps, "step",
                              n_particles, smi, profile=(short, 100))
        res[label] = (out, m)
    compare_paths("18a flagship chain", res["eager"][0], res["captured"][0], failures)
    again = sample_chain(0, post, sampler, n_steps, n_particles, device=device)
    other = sample_chain(1, post, sampler, n_steps, n_particles, device=device)
    same = tree_difference(again, res["captured"][0])[0]
    moved = not torch.equal(other[0]["t"], again[0]["t"])
    runner = chain_runner(post, sampler, n_particles)
    n_graphs = sum(s.graph is not None for s in runner.steps)
    print(f"phase 18a reseeded chain equal {same}, another seed differs {moved}; "
          f"{n_graphs} graphs captured for {len(runner.steps)} branches")
    if not (same and moved and n_graphs == len(runner.steps)):
        failures.append(f"phase 18a reseeding: same seed equal {same}, other seed moved "
                        f"{moved}, graphs {n_graphs}")
    return {k: v[1] for k, v in res.items()}


def graph_ids(run):
    """The CUDA graphs an image runner (``make_conditioned_chain``) holds."""
    return [id(s.graph) for r in run.runners.values() for s in r.chain.steps]


def captured_runners(device, failures, smi, n_particles=100, seed=31):
    """Phase 18b: phase 4's conditioned runner over its four scenes (at two
    step counts: one capture serves both) and the tuned runner over two
    candidates through one capture, each captured and eager."""
    import numpy as np

    from bayesianposeestimation.jl_tpu_torch.models.experiment_samplers import smc_mh
    from bayesianposeestimation.jl_tpu_torch.models.fused import (
        make_conditioned_chain,
        make_tuned_chain,
    )
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
    from bayesianposeestimation.jl_tpu_torch.utils import mesh_io

    params = Parameters(n_particles=n_particles, time_budget=TIME_BUDGET,
                        proposal_sigma_r=(0.5, 0.5, 0.5), device=str(device), n_steps=300)
    scenes, mesh = occluded_scenes(device)
    diameter = mesh_io.mesh_diameter(mesh)
    images = [image_inputs(sc, params, diameter) for sc in scenes]
    steps = (300, 300, 250, 250)
    outs, metrics = {}, {}
    for label, captured in (("eager", False), ("captured", True)):
        import torch

        run = make_conditioned_chain(params, mesh.vertices, mesh.faces, "association", smc_mh,
                                     300, device=device, captured=captured)
        run(seed + 1000, *images[0])  # warm-up: the capture
        torch.cuda.synchronize()
        ids = graph_ids(run)
        walls = []
        for k, (image, n) in enumerate(zip(images, steps)):
            t0 = time.perf_counter()
            outs[label, k] = run(seed + k, *image, n_steps=n)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        ms = [w / n * 1e3 for w, n in zip(walls, steps)]
        metrics[label] = {"walls_s": walls, "ms_per_step": ms,
                          "steps_per_budget": [int(TIME_BUDGET / (m * 1e-3)) for m in ms]}
        if captured and graph_ids(run) != ids:
            failures.append("phase 18b conditioned runner: captured again after the warm-up")
        print(f"phase 18b conditioned runner {label} on {smi}: four scenes at {list(steps)} "
              f"steps: walls {[round(w, 4) for w in walls]} s, ms per step "
              f"{[round(m, 4) for m in ms]}, steps per {TIME_BUDGET} s at that pace "
              f"{metrics[label]['steps_per_budget']}; graphs {len(graph_ids(run))}")
    for k in range(len(images)):
        compare_paths(f"18b conditioned runner scene {k} ({steps[k]} steps)",
                      outs["eager", k], outs["captured", k], failures)

    cands = {name: {k: s[k] for k in ("pixel_sigma", "association_sigma", "sigma_t",
                                      "proposal_sigma_r")} for name, s in TUNED_SETS.items()}
    tuned_in = {name: image_inputs(scenes[0], params, diameter,
                                   (s["o_mask_is"], s["o_mask_not"]))
                for name, s in TUNED_SETS.items()}
    tuned_outs = {}
    for label, captured in (("eager", False), ("captured", True)):
        import torch

        run = make_tuned_chain(params, mesh.vertices, mesh.faces, "association", smc_mh, 300,
                               device=device, captured=captured)
        ids = None
        for name, hyper in cands.items():
            t0 = time.perf_counter()
            tuned_outs[label, name] = run(seed, *tuned_in[name], hyper)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if captured:
                ids = ids or graph_ids(run)
            print(f"phase 18b tuned runner {label}, candidate {name}: wall {wall:.4f} s "
                  f"(the first call captures)")
        if captured and graph_ids(run) != ids:
            failures.append("phase 18b tuned runner: a second capture for the second candidate")
    for name in cands:
        compare_paths(f"18b tuned runner candidate {name}", tuned_outs["eager", name],
                      tuned_outs["captured", name], failures)
    a, b = (tuned_outs["captured", n][0]["log_like"] for n in cands)
    if bool((a == b).all()):
        failures.append("phase 18b tuned runner: both candidates gave the same chain")
    return metrics


def captured_filters(device, failures, smi, n_frames=TRACK_FRAMES, width=80, height=60):
    """Phase 18c: both trackers on phase 6's stream (coordinate 600,
    bootstrap 1250 particles) and the unfused coordinate filter (pf_prior +
    simple_posterior), captured and eager."""
    from bayesianposeestimation.jl_tpu_torch.models import experiment_models as em
    from bayesianposeestimation.jl_tpu_torch.models.particle_filter import (
        bootstrap_pf,
        coordinate_pf,
        fused_pf_posterior,
    )

    track = tracker_script()
    stream, mesh = track.synthetic_stream(n_frames, width, height, device=device)
    frames = n_frames - 1
    metrics = {}
    for kind, pf, posterior_fn, tag in (
            ("coordinate", coordinate_pf, fused_pf_posterior("simple"), "coordinate"),
            ("bootstrap", bootstrap_pf, fused_pf_posterior("simple"), "bootstrap"),
            ("coordinate", coordinate_pf, em.simple_posterior, "unfused coordinate")):
        params = track.filter_params(kind, width, height, None, device)
        experiment, depth, _ = track.tracking_setup(stream, mesh, params, device)
        res = {}
        for label, captured in (("eager", False), ("captured", True)):
            def run(seed, captured=captured):
                return pf(seed, posterior_fn, params, experiment, depth, device=device,
                          captured=captured)

            res[label] = path_metrics(
                f"18c {tag} filter {label} ({params.n_particles} particles, {frames} frames "
                f"at {width}x{height})", run, frames, "frame", params.n_particles, smi)
        compare_paths(f"18c {tag} filter", res["eager"][0], res["captured"][0], failures)
        metrics[tag] = {k: v[1] for k, v in res.items()}
    return metrics


REPLAY_COUNT_FLAG = "--replay-kernel-count"
# each replayed path of phase 18d and its render_score launches, 1 + k (units - 1)
REPLAY_PATHS = {"flagship": 500, "coordinate": 1 + 2 * (TRACK_FRAMES - 1),
                "bootstrap": TRACK_FRAMES}


def replay_kernel_count(path, device="cuda"):
    """Phase 18d's measurement of one path (``REPLAY_PATHS``: the flagship
    chain, 100 particles x 500 steps, or a tracker on phase 6's stream) in a
    process of its own (``python3 chip_smoke.py --replay-kernel-count
    PATH``): run once to capture, then once more under torch.profiler, the
    profiler's render_score kernels beside the counted launches and
    evaluations of that run. The first profiler session of a fresh process
    records every kernel; later sessions drop some now and then (PERF.md
    §7). Prints one JSON line."""
    sys.path.insert(0, str(REPO))
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_score

    if path == "flagship":
        from bayesianposeestimation.jl_tpu_torch.models.experiment_samplers import smc_mh
        from bayesianposeestimation.jl_tpu_torch.models.fused import fused_posterior
        from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
        from bayesianposeestimation.jl_tpu_torch.samplers import sample_chain

        params = Parameters(n_steps=500, n_particles=100, proposal_sigma_r=(0.5, 0.5, 0.5),
                            device=device)
        post = fused_posterior(params, bench_scene(device)[0], "association", device=device)
        sampler = smc_mh(params, post)

        def run(seed):
            return sample_chain(seed, post, sampler, 500, 100, device=device)
    else:
        from bayesianposeestimation.jl_tpu_torch.models.particle_filter import (
            bootstrap_pf,
            coordinate_pf,
            fused_pf_posterior,
        )

        track = tracker_script()
        stream, mesh = track.synthetic_stream(TRACK_FRAMES, 80, 60, device=device)
        pf = coordinate_pf if path == "coordinate" else bootstrap_pf
        params = track.filter_params(path, 80, 60, None, device)
        experiment, depth, _ = track.tracking_setup(stream, mesh, params, device)

        def run(seed):
            return pf(seed, fused_pf_posterior("simple"), params, experiment, depth,
                      device=device)
    run(1)  # the capture
    l0 = render_score.launches
    with EvaluationCount() as evals:
        prof = profile_path(lambda: run(0), 1)
    print(json.dumps({"profiler_kernels": prof["render_score_kernels"],
                      "launches": render_score.launches - l0, "evaluations": evals.n,
                      "graph_launches": prof["graph_launches"]}))
    return 0


def replay_count_phase(failures, attempts=2):
    """Phase 18d: ``replay_kernel_count`` of each path in a process of its
    own (a second process where the first's profiler session dropped
    kernels), its profiler count held to its counters and to 1 + k (units -
    1)."""
    for path, expected in REPLAY_PATHS.items():
        for attempt in range(1, attempts + 1):
            try:
                proc = subprocess.run(
                    [sys.executable, str(REPO / "chip_smoke.py"), REPLAY_COUNT_FLAG, path],
                    capture_output=True, text=True, timeout=300, cwd=REPO)
                counts = json.loads(proc.stdout.strip().splitlines()[-1])
            except (subprocess.TimeoutExpired, IndexError, ValueError) as e:
                counts = {"profiler_kernels": f"no result ({type(e).__name__})",
                          "launches": None, "evaluations": None}
            if counts["profiler_kernels"] == counts["launches"] or attempt == attempts:
                break
            print(f"phase 18d {path}: process {attempt} of {attempts}: the profiler recorded "
                  f"{counts['profiler_kernels']} of {counts['launches']} kernels")
        kernel_count_gate(path, counts, expected, failures)


def captured_phase(device, failures, smi):
    """Phase 18: the chain, the per-image runners and both trackers captured
    as CUDA graphs against the eager loop (``captured=False``), on the card.
    Returns the metrics of each path, eager and captured."""
    t0 = time.perf_counter()
    out = {"flagship": captured_flagship(device, failures, smi)}
    out["runners"] = captured_runners(device, failures, smi)
    out["filters"] = captured_filters(device, failures, smi)
    replay_count_phase(failures)
    print(f"phase 18 summary: {json.dumps(out)}")
    print(f"phase 18 took {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not (REPO / PKG / "csrc" / "render_score.cu").is_file():
        print(f"chip_smoke: {PKG} not found beside this script", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bayesianposeestimation.jl_tpu_torch.ops import cuda_raster
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
        EPILOGUES,
        SCORE_VARIANTS,
        render_depth,
        render_depth_reference,
        render_score,
        render_score_reference,
    )

    dev = "cuda"
    failures = []
    t_start = time.perf_counter()

    def phase_done(n):
        print(f"phase {n} done {time.perf_counter() - t_start:.1f} s after the start")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # -- phase 1: build -----------------------------------------------------
    t0 = time.perf_counter()
    _, log = cuda_raster.build_library()
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    phase_done(1)

    # -- phase 2: kernel against its plain version -------------------------
    shapes = [("bench monkey 30x30", 30, 30, "monkey"), ("monkey 80x60", 80, 60, "monkey"),
              ("cube 16x16", 16, 16, "cube")]
    flagship = None
    worst = {e: 0.0 for e in EPILOGUES}
    worst["association+hyper"] = 0.0
    for label, w, h, mesh_name in shapes:
        args = kernel_inputs(dev, w, h, mesh_name)
        res = compare_kernel(args, dev)
        worst["association"] = max(worst["association"], res["max_abs_err"])
        print(f"phase 2 {label}: {json.dumps(res)} launches so far {render_score.launches}")
        if not res["ok"]:
            failures.append(f"kernel vs plain at {label}")
        if flagship is None:
            flagship = args

    # every variant, with the params' sigmas and with a device hyper row, on
    # a mask-like prior image (o_mask_is on the object, o_mask_not off it)
    # with eight object pixels at prior 0 and 1 (the association's edge case)
    hyper = torch.tensor(HYPER, dtype=torch.float32, device=dev)
    variant_args = {}
    for label, w, h in (("30x30", 30, 30), ("80x60", 80, 60)):
        args = list(kernel_inputs(dev, w, h, "monkey"))
        z, params = args[5], args[7]
        prior = torch.where(torch.isfinite(z), params.o_mask_is, params.o_mask_not).reshape(-1)
        on = torch.nonzero(torch.isfinite(z).reshape(-1)).squeeze(1)
        edge = on[:: max(1, len(on) // 8)][:8]
        prior[edge[0::2]], prior[edge[1::2]] = 0.0, 1.0
        args[6] = prior.reshape(h, w).contiguous()
        args = tuple(args)
        variant_args[label] = args
        for variant, epilogue in SCORE_VARIANTS.items():
            for row in (None, hyper):
                res = compare_kernel(args, dev, variant, row)
                key = epilogue if row is None else "association+hyper"
                worst[epilogue] = max(worst[epilogue], res["max_abs_err"])
                if row is not None:
                    worst[key] = max(worst[key], res["max_abs_err"])
                tag = "hyper row" if row is not None else "params"
                print(f"phase 2 {variant} ({epilogue}, {tag}) monkey {label}: ok {res['ok']}, "
                      f"max |d| {res['max_abs_err']:.5f}, median rel {res['median_rel']:.2e}, "
                      f"repeats equal {res['repeat_bitwise_equal']}, "
                      f"ell mean {res['ell_mean']:.2f}")
                if not res["ok"]:
                    failures.append(f"kernel vs plain: {variant} {tag} at {label}")

    # no quiet fallback on the card: these raise before any launch
    before = render_score.launches
    for bad in ({"variant": "bogus"}, {"hyper": hyper[:1]}, {"hyper": hyper.double()},
                {"hyper": hyper.cpu()}):
        try:
            render_score(*flagship, device=dev, **{"variant": "association", **bad})
            failures.append(f"render_score accepted {bad}")
        except (TypeError, ValueError) as e:
            print(f"phase 2 rejected {list(bad)[0]}: {e}")
    if render_score.launches != before:
        failures.append("a rejected render_score call launched the kernel")

    sync = torch.cuda.synchronize
    scalar_ms = time_ms(lambda: render_score(*flagship, device=dev), 200, sync)
    print(f"phase 2 timing association with a Python-number prior (filled on the device): kernel "
          f"{scalar_ms:.4f} ms (CUDA events over 200 calls) on {smi}")
    groups = {e: next(v for v, g in SCORE_VARIANTS.items() if g == e) for e in EPILOGUES}
    timing = {}
    bench_args = variant_args["30x30"]
    for name, (variant, row) in [*((e, (v, None)) for e, v in groups.items()),
                                 ("association+hyper", ("association", hyper))]:
        epilogue = SCORE_VARIANTS[variant]
        ms = time_ms(lambda: render_score(*bench_args, variant=variant, hyper=row,
                                          device=dev), 200, sync)
        plain_ms = time_ms(lambda: render_score_reference(*bench_args, variant=variant,
                                                          hyper=row), 5, sync)
        dev_ms = device_ms(lambda: render_score(*bench_args, variant=variant, hyper=row,
                                                device=dev), 50)
        b_ms, b_by, ops, pairs = bound_ms(bench_args, epilogue, row is not None)
        timing[name] = (ms, dev_ms, plain_ms, b_ms, b_by)
        print(f"phase 2 timing {name} ({variant}) at the bench shape (100 poses): kernel "
              f"{ms:.4f} ms (CUDA events over 200 calls), device {dev_ms} ms (profiler), "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}, {ops / 1e6:.3f} M ops, "
              f"{pairs} live triangle-pixel pairs), {share_of_bound(b_ms, ms, dev_ms)} on {smi}")

    # the depth-image kernels: render_depth and render_score(return_mu=True)
    # against their plain versions and each other, at the three shapes above
    # and at the tracking shape
    track_args = tracking_kernel_inputs(dev)
    worst_depth = {"render_depth": 0.0, "fixed_o+mu": 0.0}
    for label, args in [*((lb, kernel_inputs(dev, w, h, m)) for lb, w, h, m in shapes),
                        ("tracking 256 faces 80x60 600 poses", track_args)]:
        res = compare_depth_kernels(args, dev)
        worst_depth["render_depth"] = max(worst_depth["render_depth"], res["mu_max_abs"])
        worst_depth["fixed_o+mu"] = max(worst_depth["fixed_o+mu"], res["score_max_abs_err"])
        print(f"phase 2 depth kernels at {label}: {json.dumps(res)}")
        if not res["ok"]:
            failures.append(f"depth kernels vs plain at {label}")
    before = (render_depth.launches, render_score.launches)
    v, f, cam, t, q = flagship[:5]
    for name, bad in (("faces dtype", (v, f.long(), cam, t, q)),
                      ("verts dtype", (v.double(), f, cam, t, q)),
                      ("t shape", (v, f, cam, t[:, :2].contiguous(), q)),
                      ("q shape", (v, f, cam, t, q[:1])),
                      ("t device", (v, f, cam, t.cpu(), q))):
        try:
            render_depth(*bad, device=dev)
            failures.append(f"render_depth accepted a bad {name}")
        except (TypeError, ValueError) as e:
            print(f"phase 2 render_depth rejected {name}: {e}")
    if (render_depth.launches, render_score.launches) != before:
        failures.append("a rejected render_depth call launched a kernel")

    # the launch plan never changes the result; no mesh or image size limit
    t0 = time.perf_counter()
    forced_plan_check(track_args, "the tracking shape", dev, failures)
    forced_plan_check(flagship, "the bench shape", dev, failures)
    resident_path_check(variant_args["30x30"], "the bench shape with a mask prior", dev,
                        failures)
    res100_check(dev, failures)
    background_path_check(track_args, dev, failures)
    camera_row_check(flagship, "the bench shape", dev, failures)
    camera_row_check(track_args, "the tracking shape", dev, failures)
    no_size_limit_check(dev, failures, flagship[0], flagship[1], smi)
    for bad in ({"face_budget": 0}, {"pixel_budget": -1}, {"threads": 100},
                {"face_slices": 0}):
        try:
            render_depth(*flagship[:5], device=dev, tuning=bad)
            failures.append(f"render_depth accepted tuning {bad}")
        except (TypeError, ValueError) as e:
            print(f"phase 2 rejected tuning {bad}: {e}")
    try:  # a score kernel takes one block per pose
        render_score(*flagship, device=dev, tuning={"face_slices": 2})
        failures.append("render_score accepted face_slices")
    except ValueError as e:
        print(f"phase 2 render_score rejected face_slices: {e}")
    print(f"phase 2 launch-plan and size checks took {time.perf_counter() - t0:.1f} s")

    # timing at the tracking shape: the depth-only kernel, the fixed-o score
    # with and without the image, and the fixed-o score at the bootstrap
    # filter's 1250 poses
    track_timing = {}
    track_slices = cuda_raster.launch_plan(
        track_args[0].shape[0], track_args[1].shape[0], track_args[2].height,
        track_args[2].width, track_args[3].shape[0], depth_only=True)["face_slices"]
    big_args = tracking_kernel_inputs(dev, n_poses=1250)
    for name, args, fn, plain, bound_kw in (
            ("render_depth", track_args,
             lambda: render_depth(*track_args[:5], device=dev),
             lambda: render_depth_reference(*track_args[:5]), dict(epilogue="depth")),
            ("render_score[fixed_o+mu]", track_args,
             lambda: render_score(*track_args, variant="simple", device=dev, return_mu=True),
             lambda: render_score_reference(*track_args, variant="simple", return_mu=True),
             dict(epilogue="fixed_o", mu=True)),
            ("render_score[fixed_o]", track_args,
             lambda: render_score(*track_args, variant="simple", device=dev),
             lambda: render_score_reference(*track_args, variant="simple"),
             dict(epilogue="fixed_o")),
            ("render_score[fixed_o] 1250 poses", big_args,
             lambda: render_score(*big_args, variant="simple", device=dev),
             lambda: render_score_reference(*big_args, variant="simple"),
             dict(epilogue="fixed_o"))):
        ms = time_ms(fn, 100, sync)
        plain_ms = time_ms(plain, 3, sync)
        dev_ms = device_ms(fn, 30)
        b_ms, b_by, ops, pairs = bound_ms(args, **bound_kw)
        track_timing[name] = (ms, dev_ms, plain_ms, b_ms, b_by)
        print(f"phase 2 timing {name} at the tracking shape (256 faces, 80x60, "
              f"{args[3].shape[0]} poses): kernel {ms:.4f} ms (CUDA events over 100 calls), "
              f"device {dev_ms} ms (profiler), plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
              f"({b_by}, {ops / 1e6:.3f} M ops, {pairs} live triangle-pixel pairs), "
              f"{share_of_bound(b_ms, ms, dev_ms)} on {smi}")
    phase_done(2)

    # -- phase 3: the benchmark chain ---------------------------------------
    n_steps, n_particles = 500, 100
    outs, final, post, secs, evals, chain_launches, gt = run_chain(
        dev, n_steps, n_particles, trials=3)
    res = check_chain(outs, final, post, gt, n_steps, n_particles)
    launches = chain_launches[-1]
    hyp = n_steps * n_particles / min(secs)
    print(f"phase 3 chain (bench_torch.run_chain): best of {[round(x, 4) for x in secs]} s, "
          f"{hyp:.1f} hypotheses/s on {smi}; kernel launches {chain_launches}, likelihood "
          f"evaluations {evals}; {json.dumps(res)}")
    if not all(n > 0 and n == e == n_steps for n, e in zip(chain_launches, evals)):
        failures.append(f"launches {chain_launches} vs evaluations {evals}")
    if not res["density_vs_plain_ok"]:
        failures.append("chain densities vs plain version")
    phase_done(3)

    # -- phase 4: the per-image sweep ----------------------------------------
    sweep_launches = per_image_sweep(dev, failures)
    phase_done(4)

    # -- phase 5: the depth-layout kernel check -------------------------------
    layout_launches = depth_layout_check(dev, failures)
    phase_done(5)

    # -- phase 6: tracking ------------------------------------------------------
    track_launches = tracking_phase(dev, failures, smi)
    phase_done(6)

    # -- phase 7: BOP validation on data/bop/synthcad/val ------------------------
    bop_rows = bop_kernel_rows(dev, smi)
    for n, row in bop_rows.items():
        if not row[5]["ok"]:
            failures.append(f"phase 7 render_score at the BOP shape, {n} poses")
    eval_launches, eval_timing, eval_one_block, eval_slices = bop_eval_parity(dev, failures,
                                                                              smi)
    phase_done("7a")
    bop_launches = bop_inference(dev, failures, smi)
    phase_done("7b")

    # -- phase 8: bench_torch.py ------------------------------------------------
    _, bench_record = bench_phase(failures, smi)
    phase_done(8)

    # -- phase 9: the BOP submission CSV on synth val -----------------------------
    synth_rows, synth_launches = bop_submission(dev, failures, smi)
    phase_done(9)

    # -- phase 10: the hardvis split ----------------------------------------------
    hardvis_eval_launches, hardvis_timing, hardvis_launches, hardvis_row = hardvis_phase(
        dev, failures, smi)
    phase_done(10)

    # -- phase 11: the inference-time grid -----------------------------------------
    grid_launches, grid_timing, grid_cmp = inference_time_phase(dev, failures, smi)
    phase_done(11)

    # -- phase 12: a recorded stream into the trackers, checkpoints ----------------
    vga_launches, vga_timing, vga_rel, stream_launches, stream_row, stream_cmp = stream_phase(
        dev, failures, smi, final)
    phase_done(12)

    # -- phase 13: the graph (unfused) posteriors on render_depth -----------------
    graph_rows = graph_phase(dev, failures, smi)
    phase_done(13)

    # -- phase 14: the experiment sweeps and particle sharding ----------------------
    sweep_rows, _ = sweeps_phase(dev, failures, smi)
    phase_done(14)

    # -- phase 15: the hyperparameter searches and the synthetic BOP generator ------
    hyperopt_rows, (gen_launches, gen_timing, gen_slices) = hyperopt_phase(dev, failures, smi)
    phase_done(15)

    # -- phase 16: the JAX BOP runs without a port counterpart, budgets, steri ------
    (hard_eval_launches, hard_timing, hard_slices), cut_rows = bop_runs_phase(dev, failures, smi)
    phase_done(16)

    # -- phase 17: the figure scripts and the colour decoders ------------------------
    figure_rows = figures_phase(dev, failures, smi)
    phase_done(17)

    # -- phase 18: the captured chains, runners and trackers against eager --------
    captured_phase(dev, failures, smi)
    phase_done(18)

    if failures:
        print(f"chip_smoke FAILED: {failures}", file=sys.stderr)
        return 1
    entries = []
    for name, (ms, dev_ms, plain_ms, b_ms, b_by) in timing.items():
        if name == "association":
            n_launch, path = launches, "phase 3 flagship chain"
        else:
            n_launch, path = sweep_launches.get(name, 0), "phase 4 per-image sweep"
        entries.append({
            "name": f"render_score[{name}]", "route": "cuda",
            "source": f"{PKG}/csrc/render_score.cu",
            "replaces": f"{PALLAS}:938" if name.endswith("+hyper") else f"{PALLAS}:937",
            "launches": n_launch, "path": path, "max_abs_err": worst[name], "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / dev_ms if dev_ms else None,
            "share_of_bound_paced": b_ms / ms, "library_ms": None})
    for name, n_launch, path, replaces, err in (
            ("render_depth", track_launches.get("render_depth", 0),
             "phase 6 stream synthesis of the tracking script", f"{PALLAS}:930",
             worst_depth["render_depth"]),
            ("render_score[fixed_o+mu]", layout_launches.get("fixed_o+mu", 0),
             "phase 5 depth-layout kernel check", f"{PALLAS}:943", worst_depth["fixed_o+mu"]),
            ("render_score[fixed_o]", track_launches.get("fixed_o", 0),
             "phase 6 tracking, 600 poses at 80x60", f"{PALLAS}:937", worst["fixed_o"])):
        ms, dev_ms, plain_ms, b_ms, b_by = track_timing[name]
        shown = name if name != "render_score[fixed_o]" else "render_score[fixed_o] 80x60 600 poses"
        entries.append({
            "name": shown, "route": "cuda", "source": f"{PKG}/csrc/render_score.cu",
            "replaces": replaces, "launches": n_launch, "path": path, "max_abs_err": err,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "share_of_bound": b_ms / dev_ms if dev_ms else None,
            "share_of_bound_paced": b_ms / ms, "library_ms": None,
            **({"face_slices": track_slices} if name == "render_depth" else {})})
    ms, dev_ms, plain_ms, b_ms, b_by, rel = eval_timing
    entries.append({
        "name": "render_depth 81920 faces 100x100 (evaluation)", "route": "cuda",
        "source": f"{PKG}/csrc/render_score.cu", "replaces": f"{PALLAS}:930",
        "launches": eval_launches, "path": "phase 7a evaluation of the JAX estimates",
        "max_abs_err": rel, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / dev_ms if dev_ms else None,
        "share_of_bound_paced": b_ms / ms, "library_ms": None, "face_slices": eval_slices,
        "one_block_per_pose_ms": eval_one_block[0],
        "one_block_per_pose_device_ms": eval_one_block[1]})
    for sampler, poses in (("smc_mh", (100,)), ("mh_sampler", (1,)), ("mtm_sampler", (10, 9))):
        for n in poses:
            ms, dev_ms, plain_ms, b_ms, b_by, res = bop_rows[n]
            entries.append({
                "name": f"render_score[association] BOP 1800 faces 30x30 {n} poses",
                "route": "cuda", "source": f"{PKG}/csrc/render_score.cu",
                "replaces": f"{PALLAS}:937", "launches": bop_launches[sampler],
                "path": f"phase 7b {sampler} on synthcad val scene 1",
                "max_abs_err": res["max_abs_err"], "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "share_of_bound": b_ms / dev_ms if dev_ms else None,
                "share_of_bound_paced": b_ms / ms, "library_ms": None})
    def entry(name, replaces, launches, path, err, row, **extra):
        ms, dev_ms, plain_ms, b_ms, b_by = row[:5]
        return {"name": name, "route": "cuda", "source": f"{PKG}/csrc/render_score.cu",
                "replaces": f"{PALLAS}:{replaces}", "launches": launches, "path": path,
                "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by,
                "share_of_bound": b_ms / dev_ms if dev_ms else None,
                "share_of_bound_paced": b_ms / ms, "library_ms": None, **extra}

    entries.append(entry("render_score[association] bench_torch.py 1280 faces 30x30 100 poses",
                         937, sum(bench_record.get("launches", [0])),
                         "phase 8 bench_torch.py, timed chains (its own process)",
                         worst["association"], timing["association"]))
    for obj, (*row, res) in synth_rows.items():
        entries.append(entry(
            f"render_score[association] synth BOP {res['faces']} faces 30x30 100 poses", 937,
            synth_launches.get(res["faces"], 0),
            f"phase 9 BOP submission, synth val scene 1, object {obj}", res["max_abs_err"], row))
    *row, res = hardvis_row
    entries.append(entry(f"render_score[association] hardvis {res['faces']} faces 30x30 100 poses",
                         937, hardvis_launches, "phase 10 smc_mh on hardvis scene 1",
                         res["max_abs_err"], row))
    entries.append(entry("render_depth 320 faces 100x100 (hardvis evaluation)", 930,
                         hardvis_eval_launches, "phase 10 evaluation of the JAX estimates",
                         hardvis_timing[5], hardvis_timing))
    entries.append(entry("render_score[association] 1280 faces 100x100 1000 poses", 937,
                         grid_launches, "phase 11 inference-time grid, 1000 particles at 100 px",
                         grid_cmp["max_abs_err"], grid_timing))
    entries.append(entry("render_depth 1280 faces 640x480 120 poses", 930, vga_launches,
                         "phase 12 synthesis of the recorded stream", vga_rel, vga_timing))
    entries.append(entry("render_score[fixed_o] 80x60 recorded stream", 937, stream_launches,
                         "phase 12 trackers on the bag-derived stream",
                         stream_cmp["max_abs_err"], stream_row))
    for name, n_launch, path, err, row in graph_rows:
        entries.append(entry(name, 930, n_launch, path, err, row))
    for name, n_launch, path, err, row in sweep_rows:
        entries.append(entry(name, 937, n_launch, path, err, row))
    for name, n_launch, path, err, row in hyperopt_rows:
        entries.append(entry(name, 938, n_launch, path, err, row))
    entries.append(entry("render_depth 128000 faces 160x160 1 pose (generator)", 930,
                         gen_launches, "phase 15d synthcad generator, train scene 1 images 0-1",
                         gen_timing[5], gen_timing, face_slices=gen_slices))
    entries.append(entry("render_depth 320 faces 100x100 (hard split evaluation)", 930,
                         hard_eval_launches, "phase 16a evaluation of the six JAX BOP runs",
                         hard_timing[5], hard_timing, face_slices=hard_slices))
    for label, (n_launch, (*row, res)) in cut_rows.items():
        entries.append(entry(f"render_score[association] synth {label} {res['faces']} faces "
                             f"30x30 100 poses", 937, n_launch,
                             f"phase 16b smc_mh on the {label}'s split, scene 1, two images",
                             res["max_abs_err"], row))
    for name, n_launch, path, err, row in figure_rows:
        entries.append(entry(name, 930, n_launch, path, err, row))
    for e in entries:
        if e["launches"] <= 0:
            print(f"chip_smoke FAILED: {e['name']} was not launched on its path",
                  file=sys.stderr)
            return 1
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(replay_kernel_count(sys.argv[2]) if sys.argv[1:2] == [REPLAY_COUNT_FLAG]
             else main())
