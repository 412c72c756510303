"""Plain rasteriser: the rendered depth of N poses of a triangle mesh, and
the count of live (triangle, pixel) pairs.

A frozen copy of the kernel's mathematics in plain PyTorch: vertices
transformed by the pose's quaternion, projected by the pinhole camera with
pixel centres on a grid centred in the image, triangles culled when
degenerate, behind ``near`` or beyond ``far``, off the viewport or (by
default) facing away; a pixel is covered where all three barycentric
weights are at least -1e-5, and its depth is the reciprocal of the largest
perspective-correct inverse depth over the triangles that cover it (0 where
none does). Each triangle is tested only at the pixels of its box: its
projected extent widened by the rounding margin of the kernel's box rule,
the whole image for a sliver whose area is rounding noise.

``dtype`` is the arithmetic: float32 for the reference, bfloat16 for the
lower-precision control (the image is accumulated in float32 either way)."""

from __future__ import annotations

import numpy as np
import torch

TOL = 1e-5
BOX_TOL = 4e-5
BOX_ERR = 2.0 ** -15
BOX_SLACK = 1e-6
BOX_WHOLE = 6.0
PAIR_BUDGET = 1 << 24  # (triangle, pixel) pairs enumerated at once


def camera_scalars(f_x, f_y, c_x, c_y, s, width, height, near, far) -> dict:
    """The camera as the raster reads it: fp32-rounded focal lengths, skew,
    principal point relative to the grid centre, clip depths."""
    f32 = np.float32
    gcx, gcy = (width - 1) / 2.0, (height - 1) / 2.0
    return {"fx": float(f32(f_x)), "fy": float(f32(f_y)), "s": float(f32(s)),
            "cx_off": float(f32(f32(c_x) - f32(gcx))), "cy_off": float(f32(f32(c_y) - f32(gcy))),
            "near": float(f32(near)), "far": float(f32(far)), "gcx": gcx, "gcy": gcy,
            "width": int(width), "height": int(height)}


def project(verts, faces, cam, t, q):
    """Per (pose, face) and corner: pixel u, v (grid-centred) and camera
    depth z, lists of three [N, F] tensors."""
    tx, ty, tz = (t[:, k:k + 1] for k in range(3))
    qw, qx, qy, qz = (q[:, k:k + 1] for k in range(4))
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    tri = verts[faces.long()]
    u, v, z = [], [], []
    for j in range(3):
        vx, vy, vz = (tri[None, :, j, k] for k in range(3))
        x = r00 * vx + r01 * vy + r02 * vz + tx
        y = r10 * vx + r11 * vy + r12 * vz + ty
        zz = r20 * vx + r21 * vy + r22 * vz + tz
        inv = 1.0 / torch.where(zz > cam["near"], zz, torch.full_like(zz, cam["near"]))
        u.append((cam["fx"] * x + cam["s"] * y) * inv + cam["cx_off"])
        v.append(cam["fy"] * y * inv + cam["cy_off"])
        z.append(zz)
    return u, v, z


def _edges(u, v):
    def edge(ua, va, ub, vb):
        return -(vb - va), ub - ua, (vb - va) * ua - (ub - ua) * va

    e0 = edge(u[1], v[1], u[2], v[2])
    e1 = edge(u[2], v[2], u[0], v[0])
    e2 = edge(u[0], v[0], u[1], v[1])
    return e0, e1, e2[0] * u[2] + e2[1] * v[2] + e2[2]


def triangles(verts, faces, cam, t, q, backface_cull=True):
    """(valid [N, F], the nine forms, the projected u, v) of every triangle."""
    u, v, z = project(verts, faces, cam, t, q)
    (a0, b0, c0), (a1, b1, c1), area = _edges(u, v)
    gcx, gcy = cam["gcx"], cam["gcy"]
    in_view = ((torch.minimum(torch.minimum(u[0], u[1]), u[2]) <= cam["width"] - 1 - gcx + 0.5)
               & (torch.maximum(torch.maximum(u[0], u[1]), u[2]) >= -gcx - 0.5)
               & (torch.minimum(torch.minimum(v[0], v[1]), v[2]) <= cam["height"] - 1 - gcy + 0.5)
               & (torch.maximum(torch.maximum(v[0], v[1]), v[2]) >= -gcy - 0.5))
    z_ok = torch.ones_like(in_view)
    for zj in z:
        z_ok = z_ok & (zj > cam["near"]) & (zj < cam["far"])
    valid = (torch.abs(area) > 1e-9) & z_ok & in_view
    if backface_cull:
        valid = valid & (area < 0)
    factor = torch.where(valid, 1.0 / torch.where(valid, area, torch.ones_like(area)),
                         torch.zeros_like(area))
    iz0, iz1, iz2 = (1.0 / zj for zj in z)
    forms = (a0 * factor, b0 * factor, c0 * factor, a1 * factor, b1 * factor, c1 * factor,
             iz2, iz0 - iz2, iz1 - iz2)
    return valid, forms, u, v, area


def boxes(u, v, area, cam, margin=True):
    """Inclusive pixel boxes (c0, c1, r0, r1), int64 [N, F], clipped to the
    image (empty where c1 < c0 or r1 < r0). ``margin``: widened by the fp32
    inside test's rounding (whole image for slivers); without it, the pixel
    centres inside the exact projected extent."""
    gcx, gcy = cam["gcx"], cam["gcy"]
    umin = torch.minimum(torch.minimum(u[0], u[1]), u[2])
    umax = torch.maximum(torch.maximum(u[0], u[1]), u[2])
    vmin = torch.minimum(torch.minimum(v[0], v[1]), v[2])
    vmax = torch.maximum(torch.maximum(v[0], v[1]), v[2])
    if margin:
        ext_u, ext_v = umax - umin, vmax - vmin
        big_l = torch.maximum(ext_u, ext_v)
        big_m = torch.maximum(torch.maximum(umin.abs(), umax.abs()),
                              torch.maximum(vmin.abs(), vmax.abs()))
        big_m = torch.clamp(big_m, min=max(gcx, gcy) + 0.5)
        r = BOX_ERR * big_l * big_m / area.abs()
        whole = ~(r < BOX_WHOLE) | ~(big_l * big_m < 1e30)
        m_u = ext_u * (BOX_TOL + r) + BOX_SLACK * big_m
        m_v = ext_v * (BOX_TOL + r) + BOX_SLACK * big_m
        lo_u, hi_u = (umin - m_u) + gcx, (umax + m_u) + gcx
        lo_v, hi_v = (vmin - m_v) + gcy, (vmax + m_v) + gcy
    else:
        whole = torch.zeros_like(umin, dtype=torch.bool)
        lo_u, hi_u, lo_v, hi_v = umin + gcx, umax + gcx, vmin + gcy, vmax + gcy

    def bounds(lo, hi, size):
        first = torch.where(whole, torch.zeros_like(lo), torch.ceil(lo).clamp(0, size))
        last = torch.where(whole, torch.full_like(hi, size - 1),
                           torch.floor(hi).clamp(-1, size - 1))
        return first.long(), last.long()

    c0, c1 = bounds(lo_u, hi_u, cam["width"])
    r0, r1 = bounds(lo_v, hi_v, cam["height"])
    return c0, c1, r0, r1


def _pose_groups(count_per_pose, budget):
    """Consecutive pose ranges whose pairs stay near ``budget``."""
    csum = np.cumsum(count_per_pose)
    groups, start, base = [], 0, 0
    for i in range(len(csum)):
        if csum[i] - base > budget and i > start:
            groups.append((start, i))
            start, base = i, csum[i - 1]
    groups.append((start, len(csum)))
    return groups


def render_depth(verts, faces, cam, t, q, backface_cull=True, dtype=torch.float32):
    """Rendered depth [N, H*W] float32 (0 = background) of poses t [N, 3],
    q [N, 4] (w, x, y, z)."""
    verts, t, q = verts.to(dtype), t.to(dtype), q.to(dtype)
    n = t.shape[0]
    h, w = cam["height"], cam["width"]
    valid, forms, u, v, area = triangles(verts, faces, cam, t, q, backface_cull)
    c0, c1, r0, r1 = boxes([x.float() for x in u], [x.float() for x in v], area.float(), cam)
    box_w = (c1 - c0 + 1).clamp(min=0)
    box_h = (r1 - r0 + 1).clamp(min=0)
    count = torch.where(valid, box_w * box_h, torch.zeros_like(box_w))
    maxd = torch.zeros(n * h * w, dtype=torch.float32, device=verts.device)
    n_faces = faces.shape[0]
    for p0, p1 in _pose_groups(count.sum(1).cpu().numpy(), PAIR_BUDGET):
        cnt = count[p0:p1].reshape(-1)
        tri = torch.repeat_interleave(torch.arange(cnt.numel(), device=cnt.device), cnt)
        i = torch.arange(tri.numel(), device=tri.device) - (cnt.cumsum(0) - cnt)[tri]
        bw = box_w[p0:p1].reshape(-1)[tri]
        rr = i // bw
        col = c0[p0:p1].reshape(-1)[tri] + (i - rr * bw)
        row = r0[p0:p1].reshape(-1)[tri] + rr
        pu = (col.to(torch.float64) - cam["gcx"]).to(dtype)
        pv = (row.to(torch.float64) - cam["gcy"]).to(dtype)
        f = [x[p0:p1].reshape(-1)[tri] for x in forms]
        w0 = f[0] * pu + f[1] * pv + f[2]
        w1 = f[3] * pu + f[4] * pv + f[5]
        w2 = 1.0 - w0 - w1
        d = (f[6] + f[7] * w0 + f[8] * w1).float()
        hit = (w0 >= -TOL) & (w1 >= -TOL) & (w2 >= -TOL) & (d > 0)
        pose = p0 + tri // n_faces
        pixel = (pose * h + row) * w + col
        maxd.scatter_reduce_(0, pixel[hit], d[hit], reduce="amax")
    maxd = maxd.reshape(n, h * w)
    return torch.where(maxd > 0, 1.0 / torch.where(maxd > 0, maxd, torch.ones_like(maxd)),
                       torch.zeros_like(maxd))


def live_pairs(verts, faces, cam, t, q, backface_cull=True) -> int:
    """(live triangle, pixel centre in its exact projected box) pairs: the
    tests a z-buffer must make on these poses."""
    valid, _, u, v, area = triangles(verts.float(), faces, cam, t.float(), q.float(),
                                     backface_cull)
    c0, c1, r0, r1 = boxes(u, v, area, cam, margin=False)
    n = (c1 - c0 + 1).clamp(min=0) * (r1 - r0 + 1).clamp(min=0)
    return int(torch.where(valid, n, torch.zeros_like(n)).sum())
