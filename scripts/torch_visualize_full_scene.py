#!/usr/bin/env python3
"""Full-scene overlay through the PyTorch/CUDA port: the ground-truth pose
rendered over the full frame.

    python3 scripts/torch_visualize_full_scene.py [--device cuda]
    python3 scripts/torch_visualize_full_scene.py --save-arrays full_scene.npz
    python3 scripts/torch_visualize_full_scene.py --draw-from full_scene.npz

The counterpart of scripts/visualize_full_scene.py: the first row of
--dataset/--testset/--scene, its model decimated to at most 2,000 faces,
rendered at its ground-truth pose at the full frame's resolution (one
``render_depth`` launch, back faces drawn as the JAX script's dense
rasteriser draws them) and overlaid on the measured depth (the synthetic
data sets have no colour stream). ``--save-arrays`` / ``--draw-from``,
--device and --out (plots/cuda/full_scene.pdf) as in
scripts/torch_plot_depth_imgs.py.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
from _figures import figure_args, gt_pose, run_figure  # noqa: E402

DECIMATE_TO = 2000


def parse_args(argv=None):
    return figure_args(__doc__, "plots/cuda/full_scene.pdf").parse_args(argv)


def render_inputs(args, device):
    """(verts, faces, full camera, gt t, gt q) of the render, and the
    measured depth [H, W]."""
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import mesh_tensors
    from bayesianposeestimation.jl_tpu_torch.utils import bop

    row = bop.bop_test_or_train(args.bop_dir, args.dataset, args.testset, args.scene)[0]
    mesh = bop.load_mesh(row, decimate_to=DECIMATE_TO)
    verts, faces = mesh_tensors(mesh.vertices, mesh.faces, device)
    t, q = gt_pose(row, device)
    return (verts, faces, bop.camera_for_row(row), t, q), bop.load_depth_image(row)


def panels(args, device="cuda") -> dict:
    """``depth`` (measured) and ``render`` (gt pose), [H, W] float32."""
    from bayesianposeestimation.jl_tpu_torch.devices import resolve_device
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_depth

    device = resolve_device(device)
    render_args, depth = render_inputs(args, device)
    render = render_depth(*render_args, backface_cull=False, device=device)[0]
    return {"depth": np.asarray(depth, np.float32), "render": render.cpu().numpy()}


def draw_overlay(arrays, out):
    from bayesianposeestimation.jl_tpu_torch.utils.visualization import (
        _plt,
        diss_defaults,
        plot_scene_ontop,
    )

    diss_defaults()
    fig, ax = _plt().subplots(figsize=(6, 4.5))
    plot_scene_ontop(arrays["depth"], arrays["render"], ax=ax)
    fig.savefig(out, bbox_inches="tight")
    return fig


def main(argv=None):
    args = parse_args(argv)
    return run_figure(args, lambda a: panels(a, a.device), draw_overlay)


if __name__ == "__main__":
    main()
