"""Pose estimates from a population (frozen definitions, float64).

SMC on one image: the final population's particle of highest
log-likelihood. Tracking, per frame: the weighted mean of the translations
and the chordal mean of the rotations, the principal eigenvector of
Σ w q qᵀ with a non-negative w component."""

from __future__ import annotations

import torch


def weighted_pose(log_weights, t, q):
    """(t [3], q [4]) of one population: log_weights [N], t [N, 3], q [N, 4]."""
    w = torch.exp(log_weights.double())
    est_t = (w[:, None] * t.double()).sum(0)
    qd = q.double()
    m = (w[:, None, None] * qd[:, :, None] * qd[:, None, :]).sum(0)
    _, vecs = torch.linalg.eigh(m)
    est_q = vecs[:, -1]
    return est_t, est_q * (-1.0 if float(est_q[0]) < 0 else 1.0)


def rotation_gap(q_a, q_b) -> float:
    """Angle in radians between two unit quaternions (sign-invariant)."""
    dot = abs(float((q_a.double() * q_b.double()).sum()))
    dot /= float(q_a.double().norm() * q_b.double().norm())
    return 2.0 * float(torch.arccos(torch.clamp(torch.tensor(dot), -1.0, 1.0)))
