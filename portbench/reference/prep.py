"""The host prep of one BOP pose request, re-derived from the decoded image,
its mask and the intrinsics: the segmentation's prior point, the 30x30 (or
other) crop camera around it, the cropped observation and the mask prior.
The same arithmetic, in the same order, as the pipeline's host prep (a
frozen copy), in float64 as NumPy computes it there.

``rnd`` rounds every intermediate result: the identity for the reference,
``bf16`` for the lower-precision control."""

from __future__ import annotations

import numpy as np
import torch

CROP_SCALE = 1.5  # the crop's side in object diameters


def exact(x):
    return x


def bf16(x):
    """``x`` rounded to bfloat16 (by way of float32), in its own type."""
    a = np.asarray(x, np.float64)
    r = torch.from_numpy(a).to(torch.float32).to(torch.bfloat16).to(torch.float64).numpy()
    if np.ndim(x) == 0 and not isinstance(x, np.ndarray):
        return float(r)
    return r.astype(np.asarray(x).dtype) if np.asarray(x).dtype.kind == "f" else r


def prior_point(depth, mask, K, diameter, rnd=exact):
    """Bounding-box centre of the mask at its masked median depth,
    reprojected and pushed 0.25 diameter along its ray: float32 [3]."""
    ys, xs = np.nonzero(mask)
    left, right, top, bottom = (xs.min(), xs.max(), ys.min(), ys.max()) if xs.size else (0, 1, 0, 1)
    u = rnd((left + right) / 2.0)
    v = rnd((top + bottom) / 2.0)
    masked = depth[mask]
    masked = masked[(masked > 0) & np.isfinite(masked)]
    z = float(np.median(masked)) if masked.size else float(depth[depth.shape[0] // 2,
                                                                depth.shape[1] // 2])
    z = rnd(z)
    fx, fy, cx, cy, s = K[0, 0], K[1, 1], K[0, 2], K[1, 2], K[0, 1]
    y = rnd(rnd(rnd(v - cy) * z) / fy)
    x = rnd(rnd(rnd(rnd(u - cx) * z) / fx) - rnd(rnd(s * y) / fx))
    p = np.asarray([x, y, z], np.float32)
    p = rnd(p * rnd(1.0 + rnd(0.25 * float(diameter) / max(rnd(np.linalg.norm(p)), 1e-6))))
    return np.asarray(p, np.float32)


def crop_camera(K, center, diameter, width, height, rnd=exact):
    """The crop camera's (f_x, f_y, c_x, c_y, s) for a square of
    ``CROP_SCALE`` diameters around the projected ``center``."""
    fx, fy, cx, cy, s = K[0, 0], K[1, 1], K[0, 2], K[1, 2], K[0, 1]
    x, y, z = (float(c) for c in center[:3])
    u0 = rnd(rnd(rnd(rnd(fx * x) / z) + rnd(rnd(s * y) / z)) + cx)
    v0 = rnd(rnd(rnd(fy * y) / z) + cy)
    side_x = rnd(rnd(rnd(fx * CROP_SCALE) * diameter) / z)
    side_y = rnd(rnd(rnd(fy * CROP_SCALE) * diameter) / z)
    left = rnd(u0 - rnd(side_x / 2))
    top = rnd(v0 - rnd(side_y / 2))
    sx = rnd(width / side_x)
    sy = rnd(height / side_y)
    return dict(f_x=rnd(fx * sx), f_y=rnd(fy * sy), c_x=rnd(rnd(cx - left) * sx),
                c_y=rnd(rnd(cy - top) * sy), s=rnd(s * sx))


def crop(img, K, cam, width, height, rnd=exact):
    """``img`` [H, W] resampled at the crop camera's pixels (nearest)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = rnd(rnd(np.arange(width) - cam["c_x"]) / cam["f_x"])
    v = rnd(rnd(np.arange(height) - cam["c_y"]) / cam["f_y"])
    su = np.clip(rnd(rnd(u * fx) + cx).round().astype(int), 0, img.shape[1] - 1)
    sv = np.clip(rnd(rnd(v * fy) + cy).round().astype(int), 0, img.shape[0] - 1)
    return np.asarray(img)[sv][:, su]


def prep(depth, mask, K, diameter, width, height, o_mask_is, o_mask_not, rnd=exact):
    """(crop camera dict, observation [h, w] float32, mask prior [h, w]
    float32, prior point [3] float32) of one request."""
    point = prior_point(depth, mask, K, diameter, rnd)
    cam = crop_camera(K, point, diameter, width, height, rnd)
    obs = crop(depth, K, cam, width, height, rnd)
    prior_o = np.where(crop(mask, K, cam, width, height, rnd), o_mask_is, o_mask_not)
    return cam, np.asarray(obs, np.float32), np.asarray(prior_o, np.float32), point
