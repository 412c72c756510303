#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: rendered+scored pose
hypotheses per second on one card.

    python3 bench_torch.py [--n-steps 500] [--n-particles 100]

The counterpart of ``bench.py``'s ``measure()`` with the same configuration:
the 1280-face ``monkey_mesh(0.08)``, the 640x480 camera cropped to 30x30
around t = (0.01, -0.02, 1.0), a ground-truth rotation drawn from a seeded
torch generator (JAX's threefry draw cannot be reproduced, so the gt pose
differs from ``bench.py``'s), observation noise 0.01, ``o_mask_is`` (0.7) as the
pixel prior, and tempered SMC-MH (``smc_mh``) over the fused association
posterior with ``proposal_sigma_r = (0.5, 0.5, 0.5)``, 100 particles x 500
steps. One warm-up chain, then the best of 3 timed chains, each ending in
``torch.cuda.synchronize()``.

Prints exactly one JSON line on stdout with ``bench.py``'s keys (``metric``,
``value``, ``unit``, ``vs_baseline`` against 1e5 hypotheses/s) and
``device``: the card's name and power limit as ``nvidia-smi`` prints them.
The trials, kernel launches and likelihood evaluations go to stderr. Exits
non-zero if a timed chain's ``render_score`` launches differ from its
likelihood evaluations (or from one per step), or an output is not finite.

Without a CUDA device it raises, unless ``--allow-cpu`` (or
``BENCH_ALLOW_CPU=1``, as ``bench.py`` takes) asks for the CPU, where the
kernels' plain versions run and make no launches. ``chip_smoke.py`` phase 3
times its chain through ``run_chain`` below.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

BASELINE_HYP_PER_SEC = 1.0e5
TRIALS = 3  # timed chains after the warm-up; the headline is the best of them


def bench_scene(device, width=30, height=30, mesh_name="monkey", seed=0):
    """bench.py's scene built through the port: mesh, crop camera around
    t = (0.01, -0.02, 1.0), a random ground-truth rotation and the noisy
    rendered observation (background 0 -> +inf in the Experiment). Returns
    (experiment, gt_t, gt_q, the generator after the draws)."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch import quaternions as quat
    from bayesianposeestimation.jl_tpu_torch.camera import CvCamera, crop_camera
    from bayesianposeestimation.jl_tpu_torch.ops.rasterize import render_depth
    from bayesianposeestimation.jl_tpu_torch.parameters import Experiment
    from bayesianposeestimation.jl_tpu_torch.utils import mesh_io

    mesh = mesh_io.monkey_mesh(0.08) if mesh_name == "monkey" else mesh_io.cube_mesh(0.1)
    base = CvCamera(width=640, height=480, f_x=600.0, f_y=600.0, c_x=319.5, c_y=239.5,
                    near=0.01, far=10.0)
    gt_t_np = np.array([0.01, -0.02, 1.0])
    cam = crop_camera(base, gt_t_np, mesh_io.mesh_diameter(mesh), width=width, height=height)
    gen = torch.Generator(device=device).manual_seed(seed)
    verts = torch.as_tensor(mesh.vertices, device=device)
    faces = torch.as_tensor(mesh.faces, device=device)
    gt_t = torch.as_tensor(gt_t_np, dtype=torch.float32, device=device)
    gt_q = quat.rand_quaternion(gen)
    clean = render_depth(verts, faces, cam, gt_t, gt_q)
    noise = torch.randn(clean.shape, generator=gen, device=device)
    obs = torch.where(clean > 0, clean + 0.01 * noise, torch.zeros_like(clean))
    exp = Experiment(scene={"camera": cam, "verts": verts, "faces": faces},
                     prior_o=0.7, prior_t=gt_t, depth_image=obs)
    return exp, gt_t, gt_q, gen


class EvaluationCount:
    """Counts FusedPosterior likelihood evaluations of posteriors on one
    device type (default the card's: re-evaluations by the plain version on
    the CPU are not counted) while in use."""

    def __init__(self, device_type="cuda"):
        self.device_type = device_type

    def __enter__(self):
        from bayesianposeestimation.jl_tpu_torch.models.fused import FusedPosterior

        self.n = 0
        self._inner = inner = FusedPosterior.prior_and_likelihood

        def counted(posterior, sample, *args):
            self.n += posterior.device.type == self.device_type
            return inner(posterior, sample, *args)

        FusedPosterior.prior_and_likelihood = counted
        return self

    def __exit__(self, *exc):
        from bayesianposeestimation.jl_tpu_torch.models.fused import FusedPosterior

        FusedPosterior.prior_and_likelihood = self._inner


def run_chain(device, n_steps=500, n_particles=100, seed=1, trials=1):
    """The benchmark chain through the port: one warm-up chain, then
    ``trials`` timed chains, each ending in a synchronisation. Returns
    (outs, final, posterior, seconds, evaluations, launches, (gt_t, gt_q)):
    the last timed chain's outputs and final state, and per timed chain its
    wall seconds, likelihood evaluations and ``render_score`` launches."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.models.experiment_samplers import smc_mh
    from bayesianposeestimation.jl_tpu_torch.models.fused import fused_posterior
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_score
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
    from bayesianposeestimation.jl_tpu_torch.samplers import sample_chain

    dev = torch.device(device)
    params = Parameters(n_steps=n_steps, n_particles=n_particles,
                        proposal_sigma_r=(0.5, 0.5, 0.5), device=str(device))
    exp, gt_t, gt_q, _ = bench_scene(device)
    posterior = fused_posterior(params, exp, "association", device=device)
    sampler = smc_mh(params, posterior)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    sample_chain(seed + 1000, posterior, sampler, n_steps, n_particles, device=device)  # warm-up
    sync()
    seconds, evaluations, launches = [], [], []
    for trial in range(trials):
        render_score.launches = 0
        with EvaluationCount(dev.type) as evals:
            t0 = time.perf_counter()
            outs, final = sample_chain(seed + trial, posterior, sampler, n_steps, n_particles,
                                       device=device)
            sync()
            seconds.append(time.perf_counter() - t0)
        evaluations.append(evals.n)
        launches.append(render_score.launches)
    return outs, final, posterior, seconds, evaluations, launches, (gt_t, gt_q)


def card_line():
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-steps", type=int, default=500)
    ap.add_argument("--n-particles", type=int, default=100)
    ap.add_argument("--allow-cpu", action="store_true",
                    help="run on the CPU when there is no CUDA device (BENCH_ALLOW_CPU=1 too)")
    args = ap.parse_args(argv)
    import torch

    if torch.cuda.is_available():
        device, name = "cuda", card_line()
    elif args.allow_cpu or os.environ.get("BENCH_ALLOW_CPU") == "1":
        device, name = "cpu", "cpu"
    else:
        raise RuntimeError("bench_torch: no CUDA device (torch.cuda.is_available() is False); "
                           "pass --allow-cpu to run on the CPU")

    outs, _, _, seconds, evaluations, launches, _ = run_chain(
        device, args.n_steps, args.n_particles, trials=TRIALS)
    want_launches = evaluations if device == "cuda" else [0] * TRIALS
    finite = all(bool(torch.isfinite(v).all()) for v in outs.values())
    record = {"device": name, "seconds": seconds, "evaluations": evaluations,
              "launches": launches, "expected_evaluations": args.n_steps, "finite": finite}
    print(f"bench_torch: {json.dumps(record)}", file=sys.stderr)
    if launches != want_launches or any(e != args.n_steps for e in evaluations):
        print("bench_torch: render_score launches differ from likelihood evaluations",
              file=sys.stderr)
        return 1
    if not finite:
        print("bench_torch: non-finite chain outputs", file=sys.stderr)
        return 1
    value = args.n_steps * args.n_particles / min(seconds)
    print(json.dumps({
        "metric": f"rendered+scored pose hypotheses/sec/card (smc_mh, association_posterior, "
                  f"1280-face mesh, 30x30, {args.n_particles} particles)",
        "value": round(value, 1),
        "unit": "hypotheses/s",
        "vs_baseline": round(value / BASELINE_HYP_PER_SEC, 3),
        "device": name,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
