#!/usr/bin/env python3
"""The same object crop at increasing crop resolutions, through the
PyTorch/CUDA port.

    python3 scripts/torch_visualize_crop.py [--resolutions 15 30 60]
    python3 scripts/torch_visualize_crop.py --save-arrays crop_resolutions.npz
    python3 scripts/torch_visualize_crop.py --draw-from crop_resolutions.npz

The counterpart of scripts/visualize_crop.py: the first row of
--dataset/--testset/--scene, its measured depth resampled through a crop
camera around the segmentation's prior point at each of --resolutions. The
synthetic data sets carry no colour images, so the depth crop is shown. The
crops are host work (``camera.crop_image``), so there is no --device.
``--save-arrays`` / ``--draw-from`` and --out (plots/cuda/crop_resolutions.pdf)
as in scripts/torch_plot_depth_imgs.py.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
from _figures import figure_args, first_row, run_figure  # noqa: E402


def parse_args(argv=None):
    ap = figure_args(__doc__, "plots/cuda/crop_resolutions.pdf", device=False)
    ap.add_argument("--resolutions", type=int, nargs="+", default=[15, 30, 60])
    return ap.parse_args(argv)


def panels(args) -> dict:
    """``crop_<R>``: the [R, R] float32 depth crop for each resolution R."""
    from bayesianposeestimation.jl_tpu_torch.camera import crop_camera, crop_image

    s = first_row(args)
    out = {}
    for res in args.resolutions:
        cam = crop_camera(s["cam"], s["prior_t"], s["diameter"], width=res, height=res)
        out[f"crop_{res}"] = np.asarray(crop_image(s["depth"], s["cam"], cam), np.float32)
    return out


def draw_crops(arrays, out):
    from bayesianposeestimation.jl_tpu_torch.utils.visualization import (
        _plt,
        diss_defaults,
        plot_depth_img,
    )

    names = sorted(arrays, key=lambda k: int(k.split("_")[1]))
    diss_defaults()
    fig, axes = _plt().subplots(1, len(names), figsize=(2.6 * len(names), 2.8))
    for ax, name in zip(np.atleast_1d(axes), names):
        res = name.split("_")[1]
        plot_depth_img(arrays[name], ax=ax, title=f"{res}x{res}")
    fig.savefig(out, bbox_inches="tight")
    return fig


def main(argv=None):
    return run_figure(parse_args(argv), panels, draw_crops)


if __name__ == "__main__":
    main()
