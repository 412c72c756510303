"""What the port's figure scripts share: their arguments, the first BOP
row's set-up, its ground-truth pose and the save / draw flow.

scripts/torch_plot_depth_imgs.py, torch_visualize_crop.py,
torch_visualize_full_scene.py and torch_simple_logjac.py import it (each
runs with scripts/ on ``sys.path``, as ``python3 scripts/<name>.py`` puts it
there). It imports no JAX, no matplotlib and no CUDA.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def figure_args(doc, out, bop=True, device=True):
    """The arguments of the figure scripts: the BOP row (with ``bop``),
    --device (with ``device``), --save-arrays / --draw-from and --out."""
    ap = argparse.ArgumentParser(description=doc,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    if bop:
        ap.add_argument("--bop-dir", default="data/bop")
        ap.add_argument("--dataset", default="synth")
        ap.add_argument("--testset", default="val")
        ap.add_argument("--scene", type=int, default=1)
    if device:
        ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=out, help="where the figure goes")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--save-arrays", metavar="PATH",
                      help="write the arrays to an .npz and draw nothing")
    mode.add_argument("--draw-from", metavar="PATH",
                      help="draw the figure from an .npz written by --save-arrays")
    return ap


def first_row(args):
    """The first target row of the scene, its camera, measured depth,
    diameter and the segmentation's prior point (the JAX scripts' set-up)."""
    from bayesianposeestimation.jl_tpu_torch.models.experiment_models import (
        point_from_segmentation,
    )
    from bayesianposeestimation.jl_tpu_torch.utils import bop

    row = bop.bop_test_or_train(args.bop_dir, args.dataset, args.testset, args.scene)[0]
    cam = bop.camera_for_row(row)
    depth = bop.load_depth_image(row)
    mask = bop.load_mask_image(row)
    ys, xs = np.nonzero(mask)
    prior_t = point_from_segmentation((xs.min(), xs.max(), ys.min(), ys.max()), depth, mask,
                                      cam)
    return dict(row=row, cam=cam, depth=depth, diameter=bop.model_diameter(row),
                prior_t=prior_t)


def gt_pose(row, device):
    """The row's ground-truth (t [1, 3], q [1, 4]) as float32 tensors."""
    import torch

    from bayesianposeestimation.jl_tpu_torch import quaternions as quat

    t = torch.as_tensor(np.asarray(row["gt_t"], np.float32)[None], device=device)
    q = quat.matrix_to_quat(torch.as_tensor(np.asarray(row["gt_R"], np.float32),
                                            device=device))[None]
    return t, q.contiguous()


def run_figure(args, compute, draw):
    """``compute(args)`` -> dict of arrays, saved with --save-arrays, else
    ``draw(arrays, out)``; with --draw-from the arrays come from the file."""
    if args.draw_from:
        with np.load(args.draw_from) as f:
            arrays = dict(f)
    else:
        arrays = compute(args)
        if args.save_arrays:
            Path(args.save_arrays).parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(args.save_arrays, **arrays)
            print(f"wrote {args.save_arrays}")
            return arrays
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    draw(arrays, args.out)
    print(f"wrote {args.out}")
    return arrays
