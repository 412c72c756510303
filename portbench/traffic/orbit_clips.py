"""Depth clips of an orbiting, bobbing object for a tracker (a frozen copy
of the tracking script's synthetic stream, rendered by the benchmark's
plain rasteriser): the object orbits about 0.5 m away (4 cm by 3 cm,
bobbing 3 cm, turning 0.8 / 0.2 / 0.1 rad per unit of phase) over a
background plane at ``background`` metres, seen by a pinhole camera of
focal length 1.1 x width, with Gaussian depth noise and speckle dropout
(0 = no return). One orbit phase from the seed starts every clip; each
clip's noise comes from the seed and the clip's number."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import raster


def qexp(v):
    """Rotation vectors [..., 3] to unit quaternions (w, x, y, z)."""
    theta = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    half = 0.5 * theta
    small = theta < 1e-6
    sinc = torch.where(small, 0.5 - half * half / 12.0,
                       torch.sin(half) / torch.where(small, torch.ones_like(theta), theta))
    return torch.cat([torch.cos(half), sinc * v], dim=-1)


def camera(traffic):
    w, h = traffic["width"], traffic["height"]
    return dict(f_x=1.1 * w, f_y=1.1 * w, c_x=(w - 1) / 2, c_y=(h - 1) / 2, s=0.0,
                width=w, height=h, near=0.01, far=10.0)


def trajectory(n_frames, phase):
    ts_ = np.linspace(0, 2 * np.pi, n_frames) + phase
    gt_t = np.stack([0.04 * np.sin(ts_), 0.03 * np.cos(ts_), 0.50 + 0.03 * np.sin(2 * ts_)], 1)
    gt_q = qexp(torch.as_tensor(np.stack([0.8 * ts_, 0.2 * np.sin(ts_), 0.1 * ts_], 1),
                                dtype=torch.float32)).numpy()
    return gt_t.astype(np.float32), gt_q.astype(np.float32)


def load(traffic: dict, mesh, seed: int, device):
    """(clips [C, F, H, W] float32 host array, gt_t [F, 3], gt_q [F, 4],
    camera fields): ``mesh`` = (verts, faces) tensors on ``device``."""
    n, f = traffic["n_clips"], traffic["n_frames"]
    phase = float(np.random.default_rng([seed, 2]).uniform(0.0, 2 * math.pi))
    gt_t, gt_q = trajectory(f, phase)
    cam_f = camera(traffic)
    cam = raster.camera_scalars(cam_f["f_x"], cam_f["f_y"], cam_f["c_x"], cam_f["c_y"], 0.0,
                                cam_f["width"], cam_f["height"], cam_f["near"], cam_f["far"])
    verts, faces = mesh
    depth = raster.render_depth(verts, faces, cam, torch.as_tensor(gt_t, device=device),
                                torch.as_tensor(gt_q, device=device))
    depth = depth.reshape(f, cam_f["height"], cam_f["width"]).cpu().numpy()
    depth = np.where(depth > 0, depth, traffic["background"])
    clips = []
    for c in range(n):
        rng = np.random.default_rng([seed, 3, c])
        noisy = depth + rng.normal(0, traffic["noise"], depth.shape)
        noisy = np.where(rng.random(depth.shape) < traffic["dropout"], 0.0, noisy)
        clips.append(noisy.astype(np.float32))
    return np.stack(clips), gt_t, gt_q, cam_f
