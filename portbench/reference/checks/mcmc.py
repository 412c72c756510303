"""One Metropolis-Hastings chain on one image, the MCMC baselines of the BOP
pipeline: the record holds the request's whole chain (the state ``t``,
``r``, the tempered log density ``log_prob`` and the log-likelihood
``log_like`` after every step, [S, C] for S steps of C chains), and the
estimate is the chain's state of highest log-likelihood over all steps.

No number needs the chain's random draws: each comes from the stored states.
A state is distinct from the step at which the chain moved to it; the
reference renders and scores each distinct state once.

* ``prep``: as for ``bop`` (``checks/bop.py``);
* ``loglike``: every step's stored log-likelihood against the reference's
  render and score of the state it holds, relative to max(|reference|, 1);
* ``density``: every step's stored tempered log density against the
  reference's ℓ_prior + ϕ_k·ℓ_like of the state it holds, relative, where
  ϕ_k is the linear schedule's temperature after step k
  (``reference.smc.temperatures``) and ℓ_prior the posterior's point
  prior: t ~ Normal(prior point, sigma_t) on each axis, r uniform on the
  unit quaternions (-log 2π²); neither prior has a bijector term (both
  bijectors are the identity);
* ``acceptance``: the moves of a chain accepted at α < 1e-9, where log α_k =
  ℓ_ϕk(new) - ℓ_ϕk(previous) with the reference's densities at the step's
  temperature. The proposal terms cancel: the t and r walks are symmetric
  (their transition probability is 0) and the independent r draw's density
  is the same constant at both ends. The uniforms are float32, and
  ``torch.rand`` on the card reads exactly 0 in a share of 2.9e-8 of its
  draws (2^-25; the smallest other value is 2^-33), whose log -inf accepts
  any proposal: a sound chain makes such a move now and then (1 in 24 runs
  of 96 chains on the card), a handful in one chain all but never
  (``tools/mh_moves.py`` counts both). A chain that accepts every proposal
  makes hundreds;
* ``stuck``: a chain's steps (after its first) per step at which the state
  changed; a chain that never moves reads inf;
* ``restless``: its steps per step at which the state did not change; a
  chain that accepts every proposal reads inf, where a sound chain near
  the tempered posterior's end rejects most of its wide moves. Both are
  shares of steps turned into ratios, so that a sound chain's reading and
  a broken chain's lie far apart;
* ``estimate``: how far the reference's likelihood of the state the
  candidate reported falls below the reference's best over the chain's
  states, relative to max(|best|, 1), or inf where the reported pose is not
  the chain's state at the reported step.

The control's outputs are the reference's in bfloat16 (likelihood sums and
the tempering in float32) at the same states; ``acceptance``, ``stuck``
and ``restless`` are properties of the chain judged by the reference alone,
the same for both candidates."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import prep as prep_ref
from .. import smc
from . import bop, finite_gap, loglike

NUMBERS = ("prep", "loglike", "density", "acceptance", "stuck", "restless", "estimate")
LOG_SURFACE_S3 = math.log(2.0 * math.pi ** 2)
BLOCK = 1024  # distinct states rendered at once
LOG_LOW_ALPHA = -9.0 * math.log(10.0)  # α below 1e-9: only a uniform of 0 accepts it


def states(t, r):
    """(moved [S, C]: the step holds another state than the step before,
    always at the first step; first [D]: the flat step index of each distinct
    state's first step; state [S * C]: each step's index into ``first``)."""
    s, c = t.shape[:2]
    moved = torch.ones((s, c), dtype=torch.bool, device=t.device)
    moved[1:] = (t[1:] != t[:-1]).any(-1) | (r[1:] != r[:-1]).any(-1)
    flat = torch.arange(s * c, device=t.device).reshape(s, c)
    owner = torch.cummax(torch.where(moved, flat, torch.full_like(flat, -1)), dim=0).values
    first = torch.nonzero(moved.reshape(-1)).reshape(-1)
    lookup = torch.full((s * c,), -1, dtype=torch.long, device=t.device)
    lookup[first] = torch.arange(first.numel(), device=t.device)
    return moved, first, lookup[owner.reshape(-1)]


def prior_logdensity(t, point, sigma_t, dtype):
    """ℓ_prior [N] of positions t [N, 3]: Normal(point, sigma_t) per axis and
    the uniform rotation's constant."""
    loc = torch.as_tensor(np.asarray(point, np.float32), device=t.device).to(dtype)
    scale = torch.as_tensor(np.asarray(sigma_t, np.float32), device=t.device).to(dtype)
    z = (t.to(dtype) - loc) / scale
    axes = -0.5 * z * z - torch.log(scale) - 0.5 * math.log(2.0 * math.pi)
    return axes.float().sum(-1) - LOG_SURFACE_S3


def reference(rec, mesh, cfg, device, control=False):
    """The reference's (or, in bfloat16, the control's) outputs for one chain:
    prep, each step's log-likelihood and tempered density, the pick; and,
    from the reference alone, the chain's moves judged."""
    dtype, rnd = (torch.bfloat16, prep_ref.bf16) if control else (torch.float32,
                                                                  prep_ref.exact)
    cam_f, cam, obs, prior_o, point, z, prior = bop.prepared(rec, cfg, device, rnd)
    chain = rec["chain"]
    t, r = chain["t"].to(device), chain["r"].to(device)
    s, c = t.shape[:2]
    moved, first, state = states(t, r)
    ft, fr = t.reshape(-1, 3)[first], r.reshape(-1, 4)[first]
    ll = torch.cat([loglike(mesh, cam, ft[k:k + BLOCK], fr[k:k + BLOCK], z, prior, cfg,
                            cfg["epilogue"], dtype).float()
                    for k in range(0, first.numel(), BLOCK)])
    lp = prior_logdensity(ft, point, cfg["sigma_t"], dtype)
    phi = torch.as_tensor(smc.temperatures(cfg["n_steps"], s), device=device)[:, None]
    ll_steps, lp_steps = ll[state].reshape(s, c), lp[state].reshape(s, c)
    out = dict(cam=cam_f, obs=obs, prior_o=prior_o, point=point, ll=ll_steps,
               density=lp_steps + phi * ll_steps)
    pick = int(torch.argmax(ll_steps.reshape(-1)))
    out.update(pick=pick, estimate=(t.reshape(-1, 3)[pick], r.reshape(-1, 4)[pick]))
    if not control:
        # log α of each step's move: the state it holds against the state
        # before, both tempered to the step's ϕ, in float64 (NaN where the
        # chain stayed)
        p64, l64 = phi.double(), ll_steps.double()
        dens = lp_steps.double() + p64 * l64
        prev = lp_steps.double()[:-1] + p64[1:] * l64[:-1]
        log_alpha = torch.where(moved[1:], dens[1:] - prev, torch.nan)
        moves = moved[1:].sum(0).double()
        out.update(log_alpha=log_alpha,
                   acceptance=float((log_alpha < LOG_LOW_ALPHA).sum(0).max()),
                   stuck=float(((s - 1) / moves).max()),
                   restless=float(((s - 1) / (s - 1 - moves)).max()))
    return out


def numbers(cand, ref, rec):
    """The seven numbers of one chain for a candidate's outputs."""
    chain = rec["chain"]
    pick = cand["pick"]
    t, q = cand["estimate"]
    same_pose = (torch.equal(t.cpu().float(), chain["t"].reshape(-1, 3)[pick].cpu().float())
                 and torch.equal(q.cpu().float(),
                                 chain["r"].reshape(-1, 4)[pick].cpu().float()))
    ll = ref["ll"].reshape(-1)
    best = float(ll.max())
    gap = (best - float(ll[pick])) / max(abs(best), 1.0)
    return {"prep": bop.prep_gap(cand, ref),
            "loglike": finite_gap(cand["ll"].cpu(), ref["ll"].cpu()),
            "density": finite_gap(cand["density"].cpu(), ref["density"].cpu()),
            "acceptance": ref["acceptance"], "stuck": ref["stuck"],
            "restless": ref["restless"],
            "estimate": gap if same_pose else math.inf}


def program(rec):
    """The port's outputs of one chain, as the record holds them."""
    chain = rec["chain"]
    return dict(cam=rec["prep"]["cam"], obs=rec["prep"]["obs"], prior_o=rec["prep"]["prior_o"],
                point=rec["prep"]["point"], ll=chain["log_like"], density=chain["log_prob"],
                pick=rec["pick"], estimate=rec["estimate"])
