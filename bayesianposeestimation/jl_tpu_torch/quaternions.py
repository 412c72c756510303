"""Quaternion algebra on ``[..., 4]`` tensors in ``(w, x, y, z)`` order.

Counterpart of ``jl_tpu/quaternions.py``: the tangent space is rotation
vectors ``v in R^3`` with ``exp(v) = (cos(|v|/2), sin(|v|/2) v/|v|)``;
``q ⊕ v = q * exp(v)`` and ``q1 ⊖ q2 = log(q2⁻¹ * q1)``. All functions
broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch

__all__ = [
    "qmul",
    "qconj",
    "qnorm",
    "qnormalize",
    "qexp",
    "qlog",
    "qplus",
    "qminus",
    "qrotate",
    "quat_to_matrix",
    "matrix_to_quat",
    "quat_angle",
    "quat_dist",
    "quat_identity",
    "rand_quaternion",
]


def quat_identity(shape=(), dtype=torch.float32, device="cpu"):
    """Identity quaternion(s) ``[*shape, 4]``, filled on ``device``."""
    q = torch.zeros((*shape, 4), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def qmul(q1, q2):
    """Hamilton product of two quaternions ``[..., 4]``."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def qconj(q):
    """Conjugate (= inverse for unit quaternions): the vector part negated,
    which is q * (1, -1, -1, -1) exactly, without a host-to-device copy of
    the signs (a captured step may hold none)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qnorm(q):
    return torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def qnormalize(q, eps=1e-12):
    return q / torch.clamp(qnorm(q), min=eps)


def qexp(v):
    """Exp map from rotation vectors ``[..., 3]`` to unit quaternions, safe at 0."""
    theta = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    half = 0.5 * theta
    small = theta < 1e-6
    sinc_half = torch.where(small, 0.5 - half * half / 12.0,
                            torch.sin(half) / torch.where(small, torch.ones_like(theta), theta))
    return torch.cat([torch.cos(half), sinc_half * v], dim=-1)


def qlog(q):
    """Log map from unit quaternions to shortest-arc rotation vectors ``[..., 3]``."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    xyz = q[..., 1:]
    s = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    half = torch.atan2(s, w)
    small = s < 1e-6
    scale = torch.where(small, 2.0 + half * half / 3.0,
                        2.0 * half / torch.where(small, torch.ones_like(s), s))
    return scale * xyz


def qplus(q, v):
    """Tangent-space addition ``q ⊕ v = q * exp(v)`` (local perturbation)."""
    return qmul(q, qexp(v))


def qminus(q1, q2):
    """Tangent-space difference ``q1 ⊖ q2 = log(q2⁻¹ * q1)``."""
    return qlog(qmul(qconj(q2), q1))


def qrotate(q, p):
    """Rotate 3D points ``p [..., 3]`` by quaternion(s) ``q [..., 4]``."""
    w = q[..., :1]
    u = q[..., 1:]
    u, p = torch.broadcast_tensors(u, p)
    uxp = torch.linalg.cross(u, p, dim=-1)
    return p + 2.0 * (w * uxp + torch.linalg.cross(u, uxp, dim=-1))


def quat_to_matrix(q):
    """Unit quaternion ``[..., 4]`` to rotation matrix ``[..., 3, 3]``."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def matrix_to_quat(m):
    """Rotation matrix ``[..., 3, 3]`` to unit quaternion ``[..., 4]`` with
    w >= 0: Shepperd's method, the branch of the largest of 1 + tr and the
    three 1 + 2 m_ii - tr (the first on ties), as ``jl_tpu`` picks it."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def branch(c0, c1, c2, c3, s):
        return (torch.stack([c0, c1, c2, c3], dim=-1)
                / (2.0 * torch.sqrt(torch.clamp(s, min=1e-12)))[..., None])

    sw, sx = 1 + tr, 1 + m00 - m11 - m22
    sy, sz = 1 - m00 + m11 - m22, 1 - m00 - m11 + m22
    cand = torch.stack([branch(sw, m21 - m12, m02 - m20, m10 - m01, sw),
                        branch(m21 - m12, sx, m01 + m10, m02 + m20, sx),
                        branch(m02 - m20, m01 + m10, sy, m12 + m21, sy),
                        branch(m10 - m01, m02 + m20, m12 + m21, sz, sz)], dim=-2)
    idx = torch.argmax(torch.stack([sw, sx, sy, sz], dim=-1), dim=-1)
    q = torch.gather(cand, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = qnormalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_angle(q):
    """Rotation angle in radians of unit quaternion(s)."""
    return 2.0 * torch.arccos(torch.clamp(torch.abs(q[..., 0]), 0.0, 1.0))


def quat_dist(q1, q2):
    """Angular distance ``acos(min(1, |real(q1 * conj(q2))|))`` in radians."""
    w = qmul(q1, qconj(q2))[..., 0]
    return torch.arccos(torch.clamp(torch.abs(w), max=1.0))


def rand_quaternion(generator: torch.Generator, shape=(), dtype=torch.float32):
    """Uniform random unit quaternions (normalized Gaussian 4-vectors), drawn
    on ``generator``'s device."""
    n = torch.randn((*shape, 4), generator=generator, dtype=dtype,
                    device=generator.device)
    return qnormalize(n)
