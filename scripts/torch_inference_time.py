"""Step time of the PyTorch/CUDA port over particles x resolution
(counterpart of ``scripts/inference_time.py``).

    python scripts/torch_inference_time.py [--mesh monkey] [--resolutions 25 50 100]

The scene is the JAX script's: the mesh at the identity pose 1 m in front of
the 640x480 camera, cropped to a square of each resolution, its clean render
as the observation, prior_o 0.7, the fused association posterior and
tempered SMC-MH (``smc_mh``, ``proposal_sigma_r = (0.5, 0.5, 0.5)``). The
step time of each (resolution, particles) point is ``mean_step_time`` (the
difference of two run lengths, within 0.5 s). Rows go to
data/exp_pro/inference_time_cuda.csv by merge-by-key, as the JAX script
merges: a partial re-run replaces the rows of its resolutions and particle
counts and keeps the rest. Runs on the CUDA device unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import csv
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FIELDS = ("resolution", "n_particles", "step_time_ms", "hyp_per_s")
MESHES = ("cube", "monkey", "icosphere")


def scene(mesh_name, res, device):
    """(params, experiment) of one resolution: the mesh at the identity pose
    1 m away in a res x res crop, observed by its own clean render."""
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu_torch.camera import CvCamera, crop_camera
    from bayesianposeestimation.jl_tpu_torch.ops.rasterize import render_depth
    from bayesianposeestimation.jl_tpu_torch.parameters import Experiment, Parameters
    from bayesianposeestimation.jl_tpu_torch.utils import mesh_io

    mesh = {"cube": lambda: mesh_io.cube_mesh(0.1),
            "monkey": lambda: mesh_io.monkey_mesh(0.08),
            "icosphere": lambda: mesh_io.icosphere_mesh(0.05)}[mesh_name]()
    base = CvCamera(width=640, height=480, f_x=600.0, f_y=600.0, c_x=319.5, c_y=239.5,
                    near=0.01, far=10.0)
    params = Parameters(width=res, height=res, proposal_sigma_r=(0.5, 0.5, 0.5),
                        device=str(device))
    cam = crop_camera(base, np.array([0.0, 0.0, 1.0]), mesh_io.mesh_diameter(mesh),
                      width=res, height=res)
    verts = torch.as_tensor(mesh.vertices, device=device)
    faces = torch.as_tensor(mesh.faces, device=device)
    gt_t = torch.tensor([0.0, 0.0, 1.0], device=device)
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    clean = render_depth(verts, faces, cam, gt_t, identity)
    exp = Experiment(scene={"camera": cam, "verts": verts, "faces": faces}, prior_o=0.7,
                     prior_t=gt_t, depth_image=clean)
    return params, exp


def grid_rows(mesh_name, resolutions, particles, device, seed=0, max_seconds=0.5):
    """One row per (resolution, particles): step time in ms and hypotheses
    per second."""
    from bayesianposeestimation.jl_tpu_torch.models import experiment_samplers as es
    from bayesianposeestimation.jl_tpu_torch.models.fused import fused_posterior
    from bayesianposeestimation.jl_tpu_torch.utils.evaluation import mean_step_time

    rows = []
    for res in resolutions:
        params0, exp = scene(mesh_name, res, device)
        for n in particles:
            params = params0.replace(n_particles=n)
            posterior = fused_posterior(params, exp, "association", device=device)
            st = mean_step_time(seed, posterior, es.smc_mh(params, posterior), n,
                                max_seconds=max_seconds)
            rows.append(dict(resolution=res, n_particles=n, step_time_ms=st * 1e3,
                             hyp_per_s=n / st))
            print(f"res {res:4d} particles {n:5d}: {st * 1e3:8.4f} ms/step "
                  f"-> {n / st:12,.0f} hyp/s", flush=True)
    return rows


def merge_rows(csv_path, rows):
    """Write ``rows`` into ``csv_path``: rows of the file whose resolution is
    among the new rows' resolutions and whose particle count is among their
    counts are replaced, the others kept; sorted by (resolution,
    n_particles). Returns the rows written."""
    csv_path = Path(csv_path)
    merged = list(rows)
    if csv_path.exists():
        res_new = {r["resolution"] for r in rows}
        n_new = {r["n_particles"] for r in rows}
        with open(csv_path, newline="") as fh:
            old = [dict(resolution=int(r["resolution"]), n_particles=int(r["n_particles"]),
                        step_time_ms=float(r["step_time_ms"]), hyp_per_s=float(r["hyp_per_s"]))
                   for r in csv.DictReader(fh)]
        merged = [r for r in old if not (r["resolution"] in res_new
                                         and r["n_particles"] in n_new)] + merged
    merged.sort(key=lambda r: (r["resolution"], r["n_particles"]))
    csv_path.parent.mkdir(parents=True, exist_ok=True)
    with open(csv_path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=FIELDS)
        writer.writeheader()
        writer.writerows(merged)
    return merged


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--particles", type=int, nargs="+", default=[2, 10, 50, 100, 250, 500, 1000])
    ap.add_argument("--resolutions", type=int, nargs="+", default=[25, 50, 100])
    ap.add_argument("--mesh", default="monkey", choices=MESHES)
    ap.add_argument("--csv", default="data/exp_pro/inference_time_cuda.csv")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from bayesianposeestimation.jl_tpu_torch.devices import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        from bench_torch import card_line

        print(f"card: {card_line()}")
    rows = grid_rows(args.mesh, args.resolutions, args.particles, device)
    merge_rows(args.csv, rows)
    print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()
