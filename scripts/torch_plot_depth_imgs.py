#!/usr/bin/env python3
"""Generative-model panels through the PyTorch/CUDA port: observed /
rendered / sampled / association.

    python3 scripts/torch_plot_depth_imgs.py [--resolution 150] [--device cuda]
    python3 scripts/torch_plot_depth_imgs.py --save-arrays depth_imgs.npz
    python3 scripts/torch_plot_depth_imgs.py --draw-from depth_imgs.npz

The counterpart of scripts/plot_depth_imgs.py: for the first row of
--dataset/--testset/--scene, the measured depth cropped to a --resolution
square around the segmentation's prior point (``z``), the expected depth at
the ground-truth pose (``mu``: one ``render_depth`` launch, back faces drawn
as the JAX script's dense rasteriser draws them), a draw ``gen`` of
``pixel_mixture(..., mu, o = 1)`` from a ``torch.Generator`` seeded 8, zero
where ``mu`` is, and the association probability ``o`` of
``pixel_association_fn(params)(0.5, mu, z)``. The JAX draw comes from
``jax.random``, so ``gen`` agrees with it in distribution only.

The arrays are computed on --device (the card by default; without one it
raises unless ``--device cpu`` is given). ``--save-arrays PATH`` writes them
to an ``.npz`` and draws nothing (the card's machine has no matplotlib);
``--draw-from PATH`` draws the 1x4 panel from such a file. With neither, the
script computes and draws. The figure goes to --out (plots/cuda/depth_imgs.pdf;
the JAX script's plots/depth_imgs.pdf is never written). A missing matplotlib
raises.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
from _figures import figure_args, first_row, gt_pose, run_figure  # noqa: E402

GEN_SEED = 8
ASSOCIATION_PRIOR = 0.5


def parse_args(argv=None):
    ap = figure_args(__doc__, "plots/cuda/depth_imgs.pdf")
    ap.add_argument("--resolution", type=int, default=150)
    return ap.parse_args(argv)


def render_inputs(args, device):
    """(verts, faces, crop camera, gt t, gt q) of ``mu``'s render, with the
    measured crop ``z`` and the parameters."""
    from bayesianposeestimation.jl_tpu_torch.camera import crop_camera, crop_image
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import mesh_tensors
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
    from bayesianposeestimation.jl_tpu_torch.utils import bop

    s = first_row(args)
    res = args.resolution
    cam = crop_camera(s["cam"], s["prior_t"], s["diameter"], width=res, height=res)
    z = np.asarray(crop_image(s["depth"], s["cam"], cam), np.float32)
    mesh = bop.load_mesh(s["row"])
    verts, faces = mesh_tensors(mesh.vertices, mesh.faces, device)
    t, q = gt_pose(s["row"], device)
    return (verts, faces, cam, t, q), z, Parameters(width=res, height=res)


def panels(args, device="cuda") -> dict:
    """The four [R, R] float32 panels ``z``, ``mu``, ``gen``, ``o``."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.devices import resolve_device
    from bayesianposeestimation.jl_tpu_torch.models import pixel
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_depth

    device = resolve_device(device)
    render_args, z, params = render_inputs(args, device)
    mu = render_depth(*render_args, backface_cull=False, device=device)[0]
    gen = torch.Generator(device=device).manual_seed(GEN_SEED)
    draw = pixel.pixel_mixture(params.min_depth, params.max_depth, params.pixel_theta,
                               params.pixel_sigma, mu, 1.0).sample(gen)
    draw = torch.where(mu > 0, draw, torch.zeros_like(draw))
    o = pixel.pixel_association_fn(params)(ASSOCIATION_PRIOR, mu,
                                           torch.as_tensor(z, device=device))
    return {"z": z, "mu": mu.cpu().numpy(), "gen": draw.cpu().numpy(),
            "o": o.cpu().numpy().astype(np.float32)}


def within_3_sigma(gen, mu, sigma):
    """(pixels of ``gen`` within 3 sigma of ``mu`` where mu > 0, those
    pixels, the least count a draw of N(mu, sigma) gives but with
    probability below 3e-7: the binomial mean less 5 standard deviations)."""
    on = mu > 0
    n = int(on.sum())
    k = int((np.abs(gen[on] - mu[on]) <= 3 * sigma).sum())
    p = math.erf(3 / math.sqrt(2))
    return k, n, n * p - 5 * math.sqrt(n * p * (1 - p))


def draw_panels(arrays, out):
    from bayesianposeestimation.jl_tpu_torch.utils.visualization import (
        _plt,
        diss_defaults,
        plot_depth_img,
        plot_prob_img,
    )

    diss_defaults()
    fig, axes = _plt().subplots(1, 4, figsize=(11, 2.8))
    plot_depth_img(arrays["z"], ax=axes[0], title="measured z")
    plot_depth_img(arrays["mu"], ax=axes[1], title="expected mu (gt)")
    plot_depth_img(arrays["gen"], ax=axes[2], title="generated z ~ p(z|mu,o=1)")
    plot_prob_img(arrays["o"], ax=axes[3], title="association o")
    fig.savefig(out, bbox_inches="tight")
    return fig


def main(argv=None):
    args = parse_args(argv)
    return run_figure(args, lambda a: panels(a, a.device), draw_panels)


if __name__ == "__main__":
    main()
