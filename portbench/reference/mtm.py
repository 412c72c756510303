"""One multiple-try Metropolis move in plain PyTorch (float32), from its
draws: the try count m, the proposal's draws for the T tries and for the
T - 1 auxiliary tries, the Gumbel noise [T, N] and the uniforms [N] (a
frozen copy of the mathematics of the BOP pipeline's multiple-try baseline,
written from the method, not from the program's code).

A move from the state x (N chains): the tries y_j = x ⊕ ε_j; the try y_k
picked by Gumbel-max over j < m of (w_j + g_j); the reference set z_j = y_k ⊕
δ_j for j < m - 1, and x itself; log α = LSE_{j<m} w(y_j) - LSE(w(z_j), w(x));
the next state is y_k where log u <= log α, else x.

Departures from the program's move, each with its reason:

* the weights are the tempered log densities alone: the proposal terms
  cancel. The t and r walks are symmetric (their transition probability is
  0) and the independent r draw's density is one constant at every try, at
  every member of the reference set and at the previous state, so it
  shifts both sums by the same amount;
* the tries at j >= m are left out of both sums and of the pick, where the
  program gives them the weight -inf;
* the previous state's density is whatever the caller gives: the
  reference's own at the step's temperature, where the program re-tempers
  the density the chain carried;
* the independent r draw is the drawn quaternion as it is (the rotation's
  bijector is the identity).

``density(t [K, N, 3], r [K, N, 4]) -> [K, N]`` is the caller's: the
tempered log density at the move's temperature."""

from __future__ import annotations

import torch

KINDS = ("t_walk", "r_walk", "r_independent")


def qexp(v):
    """Rotation vectors [..., 3] to unit quaternions (w, x, y, z)."""
    theta = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    half = 0.5 * theta
    small = theta < 1e-6
    sinc = torch.where(small, 0.5 - half * half / 12.0,
                       torch.sin(half) / torch.where(small, torch.ones_like(theta), theta))
    return torch.cat([torch.cos(half), sinc * v], dim=-1)


def qmul(a, b):
    """Hamilton product of quaternions [..., 4]."""
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=-1)


def propose(kind, t, r, draws):
    """(t [K, N, 3], r [K, N, 4]) that ``draws`` [K, N, 3] (a walk) or [K, N,
    4] (independent quaternions) make from the state (t [N, 3], r [N, 4])."""
    k = draws.shape[0]
    t, r = t.expand(k, *t.shape), r.expand(k, *r.shape)
    if kind == "t_walk":
        return t + draws, r
    if kind == "r_walk":
        return t, qmul(r, qexp(draws))
    if kind == "r_independent":
        return t, draws
    raise ValueError(f"no proposal {kind!r}")


def pick(try_density, gumbel, m):
    """The selected try [N]: argmax over j < m of (w_j + g_j)."""
    return torch.argmax(try_density[:m] + gumbel[:m], dim=0)


def log_alpha(try_density, ref_density, prev_density, m):
    """log α [N]: LSE over the m tries less LSE over the reference set's
    first m - 1 members and the previous state, in float64."""
    tries = try_density[:m].double()
    ref = torch.cat([ref_density[:m - 1].double(), prev_density.double()[None]], dim=0)
    return torch.logsumexp(tries, dim=0) - torch.logsumexp(ref, dim=0)


def move(density, kind, t, r, prev_density, m, tries, gumbel, aux, u):
    """One move of the chains in the state (t [N, 3], r [N, 4]) whose
    tempered density is ``prev_density`` [N]: a dict of the next state
    (``t``, ``r``, ``density``), the tries and the reference set (poses and
    densities), the selected ``index`` [N], ``log_alpha`` [N] and ``accept``
    [N]."""
    m = int(m)
    chain = torch.arange(t.shape[0], device=t.device)
    try_t, try_r = propose(kind, t, r, tries)
    try_d = density(try_t, try_r)
    idx = pick(try_d, gumbel, m)
    sel_t, sel_r = try_t[idx, chain], try_r[idx, chain]
    ref_t, ref_r = propose(kind, sel_t, sel_r, aux)
    ref_d = density(ref_t, ref_r)
    la = log_alpha(try_d, ref_d, prev_density, m)
    accept = torch.log(u.double()) <= la
    keep = accept[:, None]
    return dict(t=torch.where(keep, sel_t, t), r=torch.where(keep, sel_r, r),
                density=torch.where(accept, try_d[idx, chain], prev_density),
                tries=(try_t, try_r, try_d), reference=(ref_t, ref_r, ref_d), index=idx,
                log_alpha=la, accept=accept)
