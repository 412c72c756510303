"""Fused render + score and depth render: the hand-written CUDA kernels and
their plain versions.

Counterpart of ``jl_tpu/ops/pallas_raster.py``: ``pallas_render_score`` with
every score variant of ``models/fused.make_score_fn``, its ``hyper`` row and
its ``return_mu`` form, and ``pallas_render_depth``. ``render_score`` and
``render_depth`` launch ``csrc/render_score.cu`` for CUDA tensors and run
``render_score_reference`` / ``render_depth_reference`` (the same functions
in plain PyTorch) for CPU tensors; there is no fallback from one to the other.
``mesh_tensors`` puts a mesh on the device as both kernels take it and checks
its face indices on the host, once per faces tensor and vertex count.

The kernel tests a live triangle only at the pixels of a bounding box and
keeps a pose's faces and image in shared memory, in chunks and tiles where
they do not fit; the depth-only kernel may split a pose's faces over several
blocks that merge their images by a max. What decides that lives here, where
the CPU tests reach it: ``triangle_boxes`` (the box rule, mirrored line for
line in the kernel), ``launch_plan`` (the shared-memory plan and face slices
the kernel is launched with) and ``render_mu_binned_reference`` (the depth
kernel's algorithm in plain PyTorch, bitwise equal to
``render_mu_reference``, which tests every pixel).

The camera reaches a launch as seven fp32 scalars (``camera_row``): as
launch arguments by default, or, with ``cam_row``, from a device row the
kernel reads at run time (the counterpart of the Pallas kernels' ``cam_ref``),
so a captured chain serves every crop camera of one image size. The plain
versions take the same row.

A launch is counted through ``telemetry.count``, so the launches a captured
CUDA graph makes are counted again on every replay.

The kernel library is compiled with ``nvcc`` from the package's own source at
the first CUDA launch, into ``_build/`` beside the package, and loaded with
``ctypes`` (plain C entry point, no PyTorch headers). The build is the span
``library.build`` and counts ``("library", "compiled")`` or ``("library",
"loaded")``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import types
import weakref
from pathlib import Path

import numpy as np
import torch

from .. import telemetry
from ..camera import CvCamera
from ..devices import check_on_device, resolve_device

__all__ = ["render_score", "render_score_reference", "render_depth",
           "render_depth_reference", "camera_row", "CAMERA_ROW", "triangle_forms",
           "triangle_boxes", "inside_test", "launch_plan", "render_mu_reference",
           "render_mu_binned_reference", "build_library", "mesh_tensors", "check_faces",
           "SCORE_VARIANTS", "EPILOGUES"]

_PKG = Path(__file__).resolve().parents[1]
_SOURCE = _PKG / "csrc" / "render_score.cu"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the kernel's score epilogues (enum Epilogue in the source) and the score
# variants each computes; the variants of one epilogue differ only in the
# regularizer, which applies outside the kernel
EPILOGUES = {"fixed_o": 0, "association": 1, "smooth_association": 2,
             "uniform_fixed_o": 3, "uniform_association": 4}
SCORE_VARIANTS = {
    "simple": "fixed_o", "smooth_simple": "fixed_o",
    "association": "association", "association_simple_reg": "association",
    "smooth": "smooth_association", "smooth_simple_reg": "smooth_association",
    "no_exp": "uniform_fixed_o", "no_exp_association": "uniform_association",
}

_TOL = 1e-5
# elements of one [N, chunk, P] pixel-evaluation tensor in the plain version
_CHUNK_BUDGET = 16 * 2**20

# The kernel's shared-memory plan and bounding-box rule (mirrored line for
# line in csrc/render_score.cu: kFormWords, kSmemLimit, kSmemStatic, kBoxTol,
# kBoxErr, kBoxSlack, kBoxWhole).
_FORM_WORDS = 13  # per live face: nine forms and the box c0, c1, r0, r1
_SMEM_STATIC = 4224  # the kernel's static shared memory (4,112 B), rounded up
_SMEM_LIMIT = 232448 - _SMEM_STATIC  # dynamic part of what a block may take on sm_90
_VERT_CACHE_BYTES = 64 * 1024  # projected vertices are cached up to this size
# threads per block: 512 below two poses per SM of an H100 (132 SMs)
_POSES_FILL = 2 * 132
# The depth-only kernel's face slices. A split costs a fixed ~3 us (the
# image's zeroing, the merge, a second kernel) and pays where the poses
# leave most SMs idle: it does below _SPLIT_BELOW poses (half the SMs),
# where the blocks are made to number about _POSES_FILL, a slice keeping at
# least _SLICE_FACES faces. Device ms on an NVIDIA H100 80GB HBM3 at 700 W
# (chip_profile.py kernels, face-slice sweep): 81,920 faces, 3 poses,
# 100x100: 0.0230 in 88 slices vs 0.4159 in one block per pose; 1,280 faces
# at 80x60, 24 poses: 0.0116 in 5 vs 0.0136; 120 poses: 0.0218 in 3 vs
# 0.0145; 100 poses at 30x30: 0.0125 in 3 vs 0.0092.
_SPLIT_BELOW = 132 // 2
_SLICE_FACES = 256
# pixel evaluations (poses x pixels) from which a launch takes the score of
# uncovered pixels once, in a kernel of its own (~2 us of device time).
# Device ms without / with it on an NVIDIA H100 80GB HBM3 at 700 W
# (chip_profile.py kernels): bench shape (90,000 evaluations) 0.0162 / 0.0183,
# tracking shape (2.9 M) 0.0634 / 0.0507, with 1250 poses (6 M) 0.1018 / 0.0770
_BACKGROUND_MIN = 2**20
_BOX_TOL = 4e-5  # 4 x the inside test's tolerance
_BOX_ERR = 2.0 ** -15  # 512 x the fp32 unit roundoff 2^-24
_BOX_SLACK = 1e-6
_BOX_WHOLE = 6.0  # from this r on, the box is the whole image
# the plan as the C entry points take it, in their argument order
_PLAN_ARGS = ("threads", "cache_verts", "face_cap", "band_rows", "band_cols")
_DEPTH_PLAN_ARGS = (*_PLAN_ARGS, "face_slices")


@functools.lru_cache(maxsize=256)
def _camera_scalars(cam: CvCamera):
    """fp32-rounded camera scalars in grid-centred coordinates, shared by the
    kernel launch and the plain version so both see identical values (cached,
    so read-only)."""
    f32 = np.float32
    gcx, gcy = (cam.width - 1) / 2.0, (cam.height - 1) / 2.0
    return types.MappingProxyType({
        "fx": float(f32(cam.f_x)), "fy": float(f32(cam.f_y)), "s": float(f32(cam.s)),
        "cx_off": float(f32(f32(cam.c_x) - f32(gcx))),
        "cy_off": float(f32(f32(cam.c_y) - f32(gcy))),
        "near": float(f32(cam.near)), "far": float(f32(cam.far)),
        "gcx": gcx, "gcy": gcy,
    })


# the camera scalars a launch reads, in the order of a device row
CAMERA_ROW = ("fx", "fy", "s", "cx_off", "cy_off", "near", "far")


def camera_row(cam: CvCamera) -> np.ndarray:
    """The seven fp32 camera scalars of ``CAMERA_ROW`` that a launch reads,
    as a host array; a device copy of it is a launch's ``cam_row``."""
    c = _camera_scalars(cam)
    return np.array([c[k] for k in CAMERA_ROW], np.float32)


def _camera_values(cam: CvCamera, cam_row=None):
    """The camera scalars as the plain version uses them: ``_camera_scalars``,
    with the entries of ``cam_row`` (0-dim tensors) in place of the host
    numbers where a row is given."""
    c = _camera_scalars(cam)
    if cam_row is None:
        return c
    return {**c, **{k: cam_row[i] for i, k in enumerate(CAMERA_ROW)}}


def project_vertices(verts, faces, cam: CvCamera, t, q, cam_row=None):
    """Per (pose, face) and corner j: the pixel coordinates u[j], v[j] in
    grid-centred coordinates (pixel centres at integer offsets from the grid
    centre) and the camera depth z[j], each [N, F]."""
    c = _camera_values(cam, cam_row)
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

    tri = verts[faces.long()]  # [F, 3, 3]
    u, v, z = [], [], []
    for j in range(3):
        vx, vy, vz = (tri[None, :, j, k] for k in range(3))
        x = r00 * vx + r01 * vy + r02 * vz + tx
        y = r10 * vx + r11 * vy + r12 * vz + ty
        zz = r20 * vx + r21 * vy + r22 * vz + tz
        inv = 1.0 / torch.where(zz > c["near"], zz, c["near"])
        u.append((c["fx"] * x + c["s"] * y) * inv + c["cx_off"])
        v.append(c["fy"] * y * inv + c["cy_off"])
        z.append(zz)
    return u, v, z


def _edges_and_area(u, v):
    """The three edge functions (alpha, beta, gamma; edge i lies opposite
    corner i) and the signed double area of each projected triangle."""
    def edge(ua, va, ub, vb):
        return -(vb - va), ub - ua, (vb - va) * ua - (ub - ua) * va

    e0 = edge(u[1], v[1], u[2], v[2])
    e1 = edge(u[2], v[2], u[0], v[0])
    e2 = edge(u[0], v[0], u[1], v[1])
    return e0, e1, e2, e2[0] * u[2] + e2[1] * v[2] + e2[2]


def triangle_forms(verts, faces, cam: CvCamera, t, q, backface_cull=True, cam_row=None):
    """Per (pose, face): validity [N, F] and the nine forms the raster loop
    reads — edge forms 0 and 1 pre-divided by the signed area
    (A0, B0, C0, A1, B1, C1) and the inverse-depth coefficients
    (IZ2, IZ0 - IZ2, IZ1 - IZ2) — each [N, F]. Culls as build_forms does:
    degenerate, depth outside (near, far), off the viewport, backfacing."""
    c = _camera_values(cam, cam_row)
    u, v, z = project_vertices(verts, faces, cam, t, q, cam_row)
    (a0, b0, c0), (a1, b1, c1), _, area = _edges_and_area(u, v)

    gcx, gcy = c["gcx"], c["gcy"]
    lo_u, hi_u = -gcx - 0.5, cam.width - 1 - gcx + 0.5
    lo_v, hi_v = -gcy - 0.5, cam.height - 1 - gcy + 0.5
    in_view = ((torch.minimum(torch.minimum(u[0], u[1]), u[2]) <= hi_u)
               & (torch.maximum(torch.maximum(u[0], u[1]), u[2]) >= lo_u)
               & (torch.minimum(torch.minimum(v[0], v[1]), v[2]) <= hi_v)
               & (torch.maximum(torch.maximum(v[0], v[1]), v[2]) >= lo_v))
    z_ok = torch.ones_like(in_view)
    for zj in z:
        z_ok = z_ok & (zj > c["near"]) & (zj < c["far"])
    valid = (torch.abs(area) > 1e-9) & z_ok & in_view
    if backface_cull:
        valid = valid & (area < 0)
    factor = torch.where(valid, 1.0 / torch.where(valid, area, torch.ones_like(area)),
                         torch.zeros_like(area))
    iz0, iz1, iz2 = (1.0 / zj for zj in z)
    forms = (a0 * factor, b0 * factor, c0 * factor, a1 * factor, b1 * factor,
             c1 * factor, iz2, iz0 - iz2, iz1 - iz2)
    return valid, forms


def inside_test(forms, pu, pv):
    """The raster core's test of triangles (their nine ``forms``) at pixel
    centres (pu, pv), broadcast against each other: whether each barycentric
    weight is at least -1e-5, and the perspective-correct inverse depth."""
    A0, B0, C0, A1, B1, C1, IZ2, DZ0, DZ1 = forms
    w0 = A0 * pu + B0 * pv + C0
    w1 = A1 * pu + B1 * pv + C1
    w2 = 1.0 - w0 - w1
    inside = (w0 >= -_TOL) & (w1 >= -_TOL) & (w2 >= -_TOL)
    return inside, IZ2 + DZ0 * w0 + DZ1 * w1


def render_mu_reference(verts, faces, cam: CvCamera, t, q, backface_cull=True, cam_row=None):
    """Rendered depth μ [N, H*W] (0 = background) exactly as the kernel's
    raster loop computes it: max over live covering triangles of the
    perspective-correct inverse depth, then its reciprocal."""
    valid, forms = triangle_forms(verts, faces, cam, t, q, backface_cull, cam_row)
    c = _camera_scalars(cam)
    n, n_faces = valid.shape
    n_pix = cam.height * cam.width
    idx = torch.arange(n_pix, device=verts.device)
    pu = (idx % cam.width).to(verts.dtype) - c["gcx"]
    pv = (idx // cam.width).to(verts.dtype) - c["gcy"]
    chunk = max(1, min(n_faces, _CHUNK_BUDGET // max(1, n * n_pix)))
    maxd = torch.zeros((n, n_pix), dtype=verts.dtype, device=verts.device)
    for s in range(0, n_faces, chunk):
        sl = slice(s, s + chunk)
        inside, d = inside_test([x[:, sl, None] for x in forms], pu, pv)
        inside = inside & valid[:, sl, None]
        cand = torch.where(inside, d, torch.zeros_like(d))
        maxd = torch.maximum(maxd, cand.amax(dim=1))
    return torch.where(maxd > 0, 1.0 / torch.where(maxd > 0, maxd, torch.ones_like(maxd)),
                       torch.zeros_like(maxd))


def triangle_boxes(verts, faces, cam: CvCamera, t, q, margin=True):
    """Per (pose, face): the inclusive pixel box (c0, c1, r0, r1), int32
    [N, F] each, clipped to the image; empty where c1 < c0 or r1 < r0.

    With ``margin`` (the kernel's rule) the box holds every pixel at which the
    fp32 inside test of ``render_mu_reference`` can pass. The test accepts
    barycentric weights down to -1e-5 and rounds, so a pixel centre outside
    the triangle's exact extent can pass it. With L the larger extent of the
    triangle, M the largest coordinate magnitude of its corners and of the
    viewport, and r = 2^-15 L M / |area| (512 unit roundoffs of the terms that
    make a weight, relative to the area): the computed area is the exact one
    within a factor 1 ± r/25, and each computed weight is the exact one
    divided by that factor and moved by less than 0.06 r. For r < 6 a passing
    pixel then lies within ext * (4e-5 + r) of the extent in each direction;
    1e-6 M covers the rounding of the box's own bounds. Where r >= 6 (a
    sliver whose area is rounding noise) the box is the whole image.

    Without ``margin`` it is the box of the pixel centres inside the exact
    extent: the work a z-buffer must do on these inputs."""
    c = _camera_scalars(cam)
    u, v, _ = project_vertices(verts, faces, cam, t, q)
    gcx, gcy = c["gcx"], c["gcy"]
    umin = torch.minimum(torch.minimum(u[0], u[1]), u[2])
    umax = torch.maximum(torch.maximum(u[0], u[1]), u[2])
    vmin = torch.minimum(torch.minimum(v[0], v[1]), v[2])
    vmax = torch.maximum(torch.maximum(v[0], v[1]), v[2])
    if margin:
        area = _edges_and_area(u, v)[3]
        ext_u, ext_v = umax - umin, vmax - vmin
        big_l = torch.maximum(ext_u, ext_v)
        big_m = torch.maximum(torch.maximum(umin.abs(), umax.abs()),
                              torch.maximum(vmin.abs(), vmax.abs()))
        big_m = torch.clamp(big_m, min=max(gcx, gcy) + 0.5)
        r = _BOX_ERR * big_l * big_m / area.abs()
        whole = ~(r < _BOX_WHOLE) | ~(big_l * big_m < 1e30)
        m_u = ext_u * (_BOX_TOL + r) + _BOX_SLACK * big_m
        m_v = ext_v * (_BOX_TOL + r) + _BOX_SLACK * big_m
        lo_u, hi_u = (umin - m_u) + gcx, (umax + m_u) + gcx
        lo_v, hi_v = (vmin - m_v) + gcy, (vmax + m_v) + gcy
    else:
        whole = torch.zeros_like(umin, dtype=torch.bool)
        lo_u, hi_u, lo_v, hi_v = umin + gcx, umax + gcx, vmin + gcy, vmax + gcy

    def bounds(lo, hi, size):
        first = torch.where(whole, torch.zeros_like(lo), torch.ceil(lo).clamp(0, size))
        last = torch.where(whole, torch.full_like(hi, size - 1),
                           torch.floor(hi).clamp(-1, size - 1))
        return first.to(torch.int32), last.to(torch.int32)

    c0, c1 = bounds(lo_u, hi_u, cam.width)
    r0, r1 = bounds(lo_v, hi_v, cam.height)
    return c0, c1, r0, r1


def launch_plan(n_verts, n_faces, height, width, n_poses=None, face_budget=None,
                pixel_budget=None, face_slices=None, depth_only=False):
    """How one block divides its shared memory and its work: ``threads`` per
    block (512 where the poses are fewer than two per SM, else 256);
    ``cache_verts`` (the projected vertices are kept in shared memory, else
    each face projects its own corners); ``face_cap`` faces per chunk (13
    words each); a ``band_rows`` x ``band_cols`` tile of the inverse-depth
    image; ``smem_bytes`` of dynamic shared memory in all; ``face_slices``
    blocks per pose, each on a contiguous slice of ceil(F / face_slices)
    faces.

    The defaults keep every face of a slice and the whole image resident
    where they fit in the 227 KB a block may take (less the kernel's static
    part), and cut faces into chunks and the image into tiles where they do
    not. The score kernels take one block per pose (``face_slices`` 1). With
    ``depth_only`` (the depth-only kernel) and fewer poses than half the
    SMs, the faces are split: about two blocks per SM in all, at least 256
    faces a slice, and enough slices that each is one chunk.
    ``face_budget``, ``pixel_budget`` and ``face_slices`` force other values
    (for tests of the chunked, banded and split paths); none of them changes
    the image."""
    threads = 256 if n_poses is None or n_poses > _POSES_FILL else 512
    for name, b in (("face_budget", face_budget), ("pixel_budget", pixel_budget),
                    ("face_slices", face_slices)):
        if b is not None and b < 1:
            raise ValueError(f"{name} must be at least 1, got {b}")
    if face_slices is not None and not depth_only:
        raise ValueError("face_slices applies to the depth-only kernel (render_depth)")
    cache_verts = 12 * n_verts <= _VERT_CACHE_BYTES
    left = _SMEM_LIMIT - (12 * n_verts if cache_verts else 0)
    fit = max(1, left // 2 // (4 * _FORM_WORDS))  # faces of one chunk beside the image
    slices = face_slices or 1
    if face_slices is None and depth_only and n_poses is not None and n_poses < _SPLIT_BELOW:
        slices = min(-(-_POSES_FILL // max(n_poses, 1)), max(1, n_faces // _SLICE_FACES))
        slices = max(slices, -(-n_faces // fit))
    if n_poses is not None and n_poses * slices >= 2**31:
        raise ValueError(f"{n_poses} poses x {slices} face slices exceed a launch's blocks")
    face_cap = max(1, min(-(-n_faces // slices), face_budget or fit))
    left -= 4 * _FORM_WORDS * face_cap
    n_pixels = max(1, min(height * width, pixel_budget or left // 4))
    band_cols = min(width, n_pixels)
    band_rows = max(1, min(height, n_pixels // max(band_cols, 1)))
    smem = 4 * ((3 * n_verts if cache_verts else 0) + _FORM_WORDS * face_cap
                + band_rows * band_cols)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"the plan needs {smem} bytes of shared memory, over {_SMEM_LIMIT}")
    return {"threads": threads, "cache_verts": cache_verts, "face_cap": face_cap,
            "band_rows": band_rows, "band_cols": band_cols, "smem_bytes": smem,
            "face_slices": slices}


def render_mu_binned_reference(verts, faces, cam: CvCamera, t, q, backface_cull=True,
                               face_budget=None, pixel_budget=None, face_slices=None):
    """Rendered depth μ [N, H*W] by the depth kernel's algorithm in plain
    PyTorch: face slice by face slice, image tile by image tile and face
    chunk by face chunk (``launch_plan`` for N poses), each live triangle is
    tested only at the pixels of its box (``triangle_boxes``) inside the
    tile, and a passing pixel's positive inverse depth goes into the slice's
    image by a scattered max; the slices' images then merge by a max. Same
    expressions as ``render_mu_reference``, which tests every triangle at
    every pixel."""
    valid, forms = triangle_forms(verts, faces, cam, t, q, backface_cull)
    c0, c1, r0, r1 = (b.long() for b in triangle_boxes(verts, faces, cam, t, q))
    c = _camera_scalars(cam)
    n, n_faces = valid.shape
    height, width = cam.height, cam.width
    plan = launch_plan(verts.shape[0], n_faces, height, width, n, face_budget=face_budget,
                       pixel_budget=pixel_budget, face_slices=face_slices, depth_only=True)
    per_slice = -(-n_faces // plan["face_slices"])
    maxd = torch.zeros(n * height * width, dtype=verts.dtype, device=verts.device)
    for s0 in range(0, n_faces, max(per_slice, 1)):
        s1 = min(s0 + per_slice, n_faces)
        part = torch.zeros_like(maxd)  # the slice's own image
        for row0 in range(0, height, plan["band_rows"]):
            row1 = min(row0 + plan["band_rows"], height) - 1
            for col0 in range(0, width, plan["band_cols"]):
                col1 = min(col0 + plan["band_cols"], width) - 1
                for f0 in range(s0, s1, plan["face_cap"]):
                    sl = slice(f0, min(f0 + plan["face_cap"], s1))
                    bc0, br0 = c0[:, sl].clamp(min=col0), r0[:, sl].clamp(min=row0)
                    box_w = (c1[:, sl].clamp(max=col1) - bc0 + 1).clamp(min=0)
                    box_h = (r1[:, sl].clamp(max=row1) - br0 + 1).clamp(min=0)
                    count = torch.where(valid[:, sl], box_w * box_h, torch.zeros_like(box_w))
                    count = count.reshape(-1)
                    # one entry per (triangle, pixel of its box in this tile)
                    tri = torch.repeat_interleave(
                        torch.arange(count.numel(), device=count.device), count)
                    i = torch.arange(tri.numel(), device=tri.device) - (count.cumsum(0)
                                                                         - count)[tri]
                    bw = box_w.reshape(-1)[tri]
                    rr = i // bw
                    col = bc0.reshape(-1)[tri] + (i - rr * bw)
                    row = br0.reshape(-1)[tri] + rr
                    pu = col.to(verts.dtype) - c["gcx"]
                    pv = row.to(verts.dtype) - c["gcy"]
                    inside, d = inside_test([x[:, sl].reshape(-1)[tri] for x in forms], pu, pv)
                    hit = inside & (d > 0)
                    pose = tri // box_w.shape[1]
                    pixel = (pose * height + row) * width + col
                    part.scatter_reduce_(0, pixel[hit], d[hit], reduce="amax")
        maxd = torch.maximum(maxd, part)
    maxd = maxd.reshape(n, height * width)
    return torch.where(maxd > 0, 1.0 / torch.where(maxd > 0, maxd, torch.ones_like(maxd)),
                       torch.zeros_like(maxd))


def render_depth_reference(verts, faces, cam: CvCamera, t, q, backface_cull=True, cam_row=None):
    """Plain PyTorch version of the depth kernel: μ [N, H, W], 0 = background;
    ``cam_row`` as ``render_depth`` takes it."""
    mu = render_mu_reference(verts, faces, cam, t, q, backface_cull, cam_row)
    return mu.reshape(t.shape[0], cam.height, cam.width)


def render_score_reference(verts, faces, cam: CvCamera, t, q, z, prior_o, params,
                           variant="association", backface_cull=True, hyper=None,
                           return_mu=False, cam_row=None):
    """Plain PyTorch version of the kernel: (ell [N], sum_o [N]), and with
    ``return_mu`` also μ [N, H, W]. ``hyper``: None or [pixel_sigma,
    association_sigma] in place of the params values; ``cam_row`` as
    ``render_score`` takes it."""
    from ..models.fused import make_hyper_score_fn, make_score_fn

    score_fn = (make_score_fn(params, variant) if hyper is None
                else functools.partial(make_hyper_score_fn(params, variant), hyper=hyper))
    mu = render_mu_reference(verts, faces, cam, t, q, backface_cull, cam_row)
    zf = z.reshape(-1)
    prior = torch.as_tensor(prior_o, dtype=zf.dtype, device=zf.device)
    prior = prior.expand(cam.height, cam.width).reshape(-1)
    ell_px, o = score_fn(mu, zf, prior)
    ell, sum_o = ell_px.sum(-1), o.expand_as(ell_px).sum(-1)
    if return_mu:
        return ell, sum_o, mu.reshape(t.shape[0], cam.height, cam.width)
    return ell, sum_o


def _compile(source: Path, extra_flags=()):
    """Compile ``source`` with nvcc (once per version of its text and the
    flags) and load it: (ctypes library, nvcc's report)."""
    flags = [*_NVCC_FLAGS, *extra_flags]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _BUILD_DIR / f"lib{source.stem}_{tag}.so"
    log, built = "", out.exists()
    telemetry.count(("library", "loaded" if built else "compiled"))
    if not built:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *flags, "-o", str(tmp), str(source)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        log = proc.stderr
        os.replace(tmp, out)
    return ctypes.CDLL(str(out)), log


@functools.lru_cache(maxsize=None)
def build_library(phase_clocks=False):
    """Compile (once per source version) and load the kernel library; returns
    (ctypes library, nvcc's register/shared-memory report). ``phase_clocks``
    builds the instrumented variant (``-DBPE_PHASE_CLOCKS``: every block adds
    the cycles of each of its phases to a device array that
    ``bpe_phase_clocks(out, reset)`` reads), a measuring aid that the
    wrappers never load."""
    with telemetry.span("library.build"):
        lib, log = _compile(_SOURCE, ("-DBPE_PHASE_CLOCKS",) if phase_clocks else ())
    if phase_clocks:
        lib.bpe_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.bpe_phase_clocks.restype = ctypes.c_int
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    plan = [i] * len(_PLAN_ARGS)
    fn = lib.bpe_render_score
    fn.argtypes = [p, i, p, i, p, p, i, p, p, i, i, f, f, f, f, f, f, f, p, i, i,
                   f, f, f, f, f, p, p, p, p, p, *plan, p]
    fn.restype = ctypes.c_int
    fn = lib.bpe_render_depth
    fn.argtypes = [p, i, p, i, p, p, i, i, i, f, f, f, f, f, f, f, p, i, p, *plan, i, p]
    fn.restype = ctypes.c_int
    return lib, log


@functools.lru_cache(maxsize=256)
def _cached_plan_args(n_verts, n_faces, height, width, n_poses, tuning, depth_only):
    plan = launch_plan(n_verts, n_faces, height, width, n_poses, **dict(tuning),
                       depth_only=depth_only)
    return tuple(int(plan[k]) for k in (_DEPTH_PLAN_ARGS if depth_only else _PLAN_ARGS))


def _plan_args(verts, faces, cam, n_poses, tuning, depth_only=False):
    """The launch plan as the C entry points take it (cached by shape: a
    chain launches the same shape thousands of times)."""
    return _cached_plan_args(verts.shape[0], faces.shape[0], cam.height, cam.width, n_poses,
                             tuple(sorted(tuning.items())) if tuning else (), depth_only)


def _check(name, x, dtype, shape):
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != len(shape) or any(s is not None and s != d
                                    for s, d in zip(shape, x.shape)):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _kernel_name(variant, hyper, return_mu=False) -> str:
    """The launch-count key of a kernel call: its epilogue, with "+hyper"
    when the likelihood sigmas come from a device row and "+mu" when the
    launch also writes the depth image."""
    return (SCORE_VARIANTS[variant] + ("" if hyper is None else "+hyper")
            + ("+mu" if return_mu else ""))


def _check_mesh_and_poses(dev, verts, faces, t, q):
    check_on_device(dev, verts=verts, faces=faces, t=t, q=q)
    _check("verts", verts, torch.float32, (None, 3))
    _check("faces", faces, torch.int32, (None, 3))
    _check("t", t, torch.float32, (None, 3))
    _check("q", q, torch.float32, (t.shape[0], 4))


@functools.lru_cache(maxsize=None)
def _is_hopper(index):
    return torch.cuda.get_device_capability(index) == (9, 0)


def _check_cam_row(dev, cam_row):
    if cam_row is not None:
        check_on_device(dev, cam_row=cam_row)
        _check("cam_row", cam_row, torch.float32, (len(CAMERA_ROW),))


def _check_hopper(dev, x, kernel):
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not _is_hopper(x.device.index):
        raise RuntimeError(f"the {kernel} kernel is built for sm_90a (Hopper)")


# (id, vertex count) -> faces tensor whose indices were checked against that
# vertex count
_CHECKED_FACES = weakref.WeakValueDictionary()


def _check_faces(faces, n_verts):
    faces_np = (faces.cpu().numpy() if isinstance(faces, torch.Tensor)
                else np.asarray(faces))
    if faces_np.size and (faces_np.min() < 0 or faces_np.max() >= n_verts):
        raise ValueError("faces index outside the vertex array")


def check_faces(faces_t, n_verts, faces=None):
    """Raise unless every index of the faces tensor ``faces_t`` lies inside a
    vertex array of ``n_verts``. The check runs on the host (on ``faces``,
    the host array ``faces_t`` was made from, where given), once per faces
    tensor and vertex count."""
    key = (id(faces_t), n_verts)
    if _CHECKED_FACES.get(key) is not faces_t:
        _check_faces(faces_t if faces is None else faces, n_verts)
        _CHECKED_FACES[key] = faces_t


def mesh_tensors(verts, faces, device):
    """The mesh as the kernels take it — verts [V, 3] f32 and faces [F, 3]
    int32, contiguous on ``device`` — after checking on the host that every
    face index lies inside the vertex array. Once per mesh: the per-image
    posteriors and the render node reuse the result and skip the check."""
    dev = resolve_device(device)
    verts_t = torch.as_tensor(verts).to(device=dev, dtype=torch.float32).contiguous()
    faces_t = torch.as_tensor(faces).to(device=dev, dtype=torch.int32).contiguous()
    check_faces(faces_t, verts_t.shape[0], faces)
    return verts_t, faces_t


def render_depth(verts, faces, cam: CvCamera, t, q, backface_cull=True, device="cuda",
                 tuning=None, cam_row=None):
    """Depth render of N poses: μ [N, H, W] f32, 0 = background.

    verts [V, 3] f32, faces [F, 3] int32, t [N, 3] f32, q [N, 4] f32 (w, x, y,
    z); (H, W) = (cam.height, cam.width). Every tensor must lie on
    ``device``: CUDA launches the depth-only kernel, the CPU runs
    ``render_depth_reference``. ``render_depth.launches`` counts the calls
    that launch the kernel (one each, also where the faces are split over
    several blocks per pose and a second small kernel finishes the image).
    ``tuning``: None, or ``launch_plan``'s ``face_budget``, ``pixel_budget``
    and ``face_slices`` for the kernel launch; they change how the work is
    divided, never the image. ``cam_row``: None, or an f32 [7] device row of
    ``camera_row`` values that the kernel reads in place of ``cam``'s (whose
    size still sets the image's)."""
    dev = resolve_device(device)
    _check_mesh_and_poses(dev, verts, faces, t, q)
    _check_cam_row(dev, cam_row)
    if dev.type == "cpu":
        return render_depth_reference(verts, faces, cam, t, q, backface_cull, cam_row)
    _check_hopper(dev, verts, "render_depth")
    n = t.shape[0]
    mu = torch.empty((n, cam.height, cam.width), dtype=torch.float32, device=verts.device)
    if n == 0:
        return mu
    lib, _ = build_library()
    c = _camera_scalars(cam)
    plan = _plan_args(verts, faces, cam, n, tuning, depth_only=True)
    with torch.cuda.device(verts.device):
        err = lib.bpe_render_depth(
            verts.data_ptr(), verts.shape[0], faces.data_ptr(), faces.shape[0],
            t.data_ptr(), q.data_ptr(), n, cam.height, cam.width, c["fx"], c["fy"],
            c["s"], c["cx_off"], c["cy_off"], c["near"], c["far"],
            None if cam_row is None else cam_row.data_ptr(),
            int(bool(backface_cull)), mu.data_ptr(), *plan,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"render_depth kernel launch failed: cudaError {err}")
    telemetry.count(("render_depth", None))
    return mu


render_depth.launches = 0


def render_score(verts, faces, cam: CvCamera, t, q, z, prior_o, params,
                 variant="association", backface_cull=True, hyper=None, device="cuda",
                 return_mu=False, tuning=None, cam_row=None):
    """Fused transform + render + associate + score for N poses.

    verts [V, 3] f32, faces [F, 3] int32, t [N, 3] f32, q [N, 4] f32 (w, x, y, z),
    z [H, W] f32 observation (invalid = +inf), prior_o float or [H, W];
    (H, W) = (cam.height, cam.width); ``variant`` one of ``SCORE_VARIANTS``;
    ``hyper`` None or f32 [2] = [pixel_sigma, association_sigma], read by the
    kernel on the device in place of the ``params`` values. Returns
    (ell [N], sum_o [N]) f32, and with ``return_mu`` also the rendered depth
    μ [N, H, W] (0 = background) that the score was computed from. Every
    tensor must lie on ``device``: CUDA launches the kernel, the CPU runs
    ``render_score_reference``. ``render_score.launches`` counts the kernel
    launches and ``render_score.launches_by`` counts them by epilogue
    (``"+hyper"`` added for launches with a hyper row, ``"+mu"`` for launches
    that write the image). ``tuning``: as for ``render_depth``, without
    ``face_slices`` (a score kernel takes one block per pose); ``cam_row``:
    as for ``render_depth``."""
    dev = resolve_device(device)
    if variant not in SCORE_VARIANTS:
        raise ValueError(f"unknown score variant {variant!r}")
    _check_mesh_and_poses(dev, verts, faces, t, q)
    check_on_device(dev, z=z)
    _check("z", z, torch.float32, (cam.height, cam.width))
    if hyper is not None:
        check_on_device(dev, hyper=hyper)
        _check("hyper", hyper, torch.float32, (2,))
    _check_cam_row(dev, cam_row)
    if dev.type == "cpu":
        return render_score_reference(verts, faces, cam, t, q, z, prior_o, params,
                                      variant, backface_cull, hyper, return_mu, cam_row)
    _check_hopper(dev, verts, "render_score")

    if not isinstance(prior_o, torch.Tensor) and np.ndim(prior_o) == 0:
        # a host number: filled on the device, no host-to-device copy per call
        prior = torch.full((cam.height, cam.width), float(prior_o), dtype=torch.float32,
                           device=verts.device)
    else:
        prior = torch.as_tensor(prior_o, dtype=torch.float32, device=verts.device)
        prior = prior.expand(cam.height, cam.width).contiguous()
    n = t.shape[0]
    ell = torch.empty(n, dtype=torch.float32, device=verts.device)
    sum_o = torch.empty(n, dtype=torch.float32, device=verts.device)
    mu = (torch.empty((n, cam.height, cam.width), dtype=torch.float32, device=verts.device)
          if return_mu else None)
    out = (ell, sum_o, mu) if return_mu else (ell, sum_o)
    # The score of an uncovered pixel does not depend on the pose: a large
    # launch takes it once per pixel into this scratch (ell_px and o) with a
    # small kernel of its own, which a small launch would not earn back.
    background = (torch.empty(2 * cam.height * cam.width, dtype=torch.float32,
                              device=verts.device)
                  if n * cam.height * cam.width >= _BACKGROUND_MIN else None)
    if n == 0:
        return out
    lib, _ = build_library()
    c = _camera_scalars(cam)
    plan = _plan_args(verts, faces, cam, n, tuning)
    with torch.cuda.device(verts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bpe_render_score(
            verts.data_ptr(), verts.shape[0], faces.data_ptr(), faces.shape[0],
            t.data_ptr(), q.data_ptr(), n, z.data_ptr(), prior.data_ptr(),
            cam.height, cam.width, c["fx"], c["fy"], c["s"], c["cx_off"],
            c["cy_off"], c["near"], c["far"],
            None if cam_row is None else cam_row.data_ptr(), int(bool(backface_cull)),
            EPILOGUES[SCORE_VARIANTS[variant]], params.min_depth, params.max_depth,
            params.pixel_theta, params.pixel_sigma, params.association_sigma,
            None if hyper is None else hyper.data_ptr(),
            ell.data_ptr(), sum_o.data_ptr(),
            None if mu is None else mu.data_ptr(),
            None if background is None else background.data_ptr(), *plan, stream)
    if err != 0:
        raise RuntimeError(f"render_score kernel launch failed: cudaError {err}")
    telemetry.count(("render_score", _kernel_name(variant, hyper, return_mu)))
    return out


render_score.launches = 0
render_score.launches_by = collections.Counter()


def _count_launch(key, n):
    """Add reported launches (``telemetry.count``) to the wrappers' counters."""
    if not isinstance(key, tuple) or len(key) != 2:
        return
    kernel, name = key
    if kernel == "render_score":
        render_score.launches += n
        render_score.launches_by[name] += n
    elif kernel == "render_depth":
        render_depth.launches += n


telemetry.add_listener(_count_launch)
