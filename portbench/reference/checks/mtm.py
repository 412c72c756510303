"""One multiple-try Metropolis chain on one image, the MTM baseline of the
BOP pipeline. A record holds what ``mcmc`` reads (the request's whole
chain: the state, ``log_prob`` and ``log_like`` after every step, [S, C])
and, under ``moves``, the record of the moves at a few seeded steps k >= 1
as the chain collected it: ``step`` [K] (the chain's row k), the tries'
poses and tempered log densities (``try_t`` [K, T, C, 3], ``try_r``,
``try_log_prob`` [K, T, C]), the reference set's T - 1 auxiliary tries
(``ref_t``, ``ref_r``, ``ref_log_prob``), the try count ``m`` [K], the
Gumbel noise ``gumbel`` [K, T, C], the selected ``index`` [K, C], the
port's ``log_alpha`` [K, C] and the uniforms ``u`` [K, C]. ``cfg`` holds,
beside the configuration, the cell's ``tries`` and ``alpha`` limits
(``tries_limit``, ``alpha_limit``), which set the margins below.

* ``prep``, ``loglike``, ``density``, ``stuck``, ``estimate``: as ``mcmc``
  reads them from the chain (``checks/mcmc.py``);
* ``tries``: each stored try's and reference member's tempered log density
  against the reference's ℓ_prior + ϕ_k·ℓ_like of its stored pose (render
  and score), relative to max(|reference|, 1), where ϕ_k is the schedule's
  temperature after step k;
* ``alpha``: the port's log α against the reference's (``reference/mtm.py``
  on the reference's densities of the tries, of the reference set and of
  the previous state, the chain's row k - 1, with the stored m), on the
  scale of the sums it is made of: the gap over max(|LSE of the tries|,
  |LSE of the reference set and the previous state|, 1);
* ``select``: the moves whose selected index is not the reference's
  Gumbel-max pick over j < m of (w_j + g_j), on the stored noise, counted
  only where the reference's top two differ by more than twice the
  ``tries`` limit on the scale of the tries' densities, and every move
  whose stored m lies outside [2, T] (its pick is judged among the m
  clamped to that range);
* ``decision``: the moves whose next state (the chain's row k) is not the
  selected try (the stored try at the stored index) where log u <= log
  α_ref, or the previous state otherwise, counted only where log u lies
  outside the ``alpha`` margin around log α_ref.

The control's outputs are the reference's in bfloat16 (``mcmc``'s, and
its densities of the same tries, its log α and its pick from them);
``stuck`` and ``decision`` are properties of the chain judged by the
reference alone, the same for both candidates."""

from __future__ import annotations

import torch

from .. import mtm
from .. import prep as prep_ref
from .. import smc
from . import bop, finite_gap, loglike, mcmc

NUMBERS = ("prep", "loglike", "density", "stuck", "estimate", "tries", "alpha", "select",
           "decision")


def _densities(mesh, cam, z, prior, point, cfg, dtype, t, r, phi):
    """ℓ_prior + ϕ·ℓ_like of poses t [..., 3], r [..., 4] at ϕ of their shape."""
    shape = t.shape[:-1]
    ft, fr = t.reshape(-1, 3), r.reshape(-1, 4)
    ll = torch.cat([loglike(mesh, cam, ft[k:k + mcmc.BLOCK], fr[k:k + mcmc.BLOCK], z, prior,
                            cfg, cfg["epilogue"], dtype).float()
                    for k in range(0, ft.shape[0], mcmc.BLOCK)])
    lp = mcmc.prior_logdensity(ft, point, cfg["sigma_t"], dtype)
    return lp.reshape(shape) + phi * ll.reshape(shape)


def reference(rec, mesh, cfg, device, control=False):
    """``mcmc``'s outputs for the chain, and for each recorded move the
    reference's (or the control's) densities of its tries, of its reference
    set and of the previous state, log α, the pick and, from the reference
    alone, the moves' decisions judged."""
    dtype = torch.bfloat16 if control else torch.float32
    out = mcmc.reference(rec, mesh, cfg, device, control)
    _, cam, _, _, point, z, prior = bop.prepared(rec, cfg, device,
                                                 prep_ref.bf16 if control else prep_ref.exact)
    mv = rec["moves"]
    steps = mv["step"].to(device).long()
    chain = rec["chain"]
    phi_all = torch.as_tensor(smc.temperatures(cfg["n_steps"], chain["t"].shape[0]),
                              device=device)
    phi = phi_all[steps]  # [K]
    ph = phi[:, None, None]
    try_d = _densities(mesh, cam, z, prior, point, cfg, dtype, mv["try_t"].to(device),
                       mv["try_r"].to(device), ph)
    ref_d = _densities(mesh, cam, z, prior, point, cfg, dtype, mv["ref_t"].to(device),
                       mv["ref_r"].to(device), ph)
    prev_t, prev_r = chain["t"].to(device)[steps - 1], chain["r"].to(device)[steps - 1]
    prev_d = _densities(mesh, cam, z, prior, point, cfg, dtype, prev_t, prev_r, phi[:, None])
    n_tries = mv["try_t"].shape[1]
    stored_m = [int(m) for m in mv["m"]]
    ms = [min(max(m, 2), n_tries) for m in stored_m]
    alpha = torch.stack([mtm.log_alpha(try_d[i], ref_d[i], prev_d[i], m)
                         for i, m in enumerate(ms)])
    scale = torch.stack([torch.maximum(
        torch.logsumexp(try_d[i, :m].double(), 0).abs(),
        torch.logsumexp(torch.cat([ref_d[i, :m - 1], prev_d[i][None]]).double(), 0).abs()
    ).clamp(min=1.0) for i, m in enumerate(ms)])
    gumbel = mv["gumbel"].to(device)
    index = torch.stack([mtm.pick(try_d[i], gumbel[i], m) for i, m in enumerate(ms)])
    out["moves"] = dict(try_d=try_d, ref_d=ref_d, log_alpha=alpha, index=index)
    if control:
        return out
    # the pick's margin: the reference's top two of w + g over j < m
    top = [torch.topk((try_d[i, :m] + gumbel[i, :m]).double(), 2, dim=0).values
           for i, m in enumerate(ms)]
    size = torch.stack([try_d[i, :m].double().abs().amax(0).clamp(min=1.0)
                        for i, m in enumerate(ms)])
    gap = torch.stack([tv[0] - tv[1] for tv in top])
    out["pick_clear"] = gap > 2.0 * cfg["tries_limit"] * size
    out["m_outside"] = torch.tensor([m != c for m, c in zip(stored_m, ms)], device=device)
    # the decisions: the next state against the selected try or the state before
    log_u = torch.log(mv["u"].to(device).double())
    accept = log_u <= alpha
    clear = (log_u - alpha).abs() > cfg["alpha_limit"] * scale
    kk = torch.arange(len(ms), device=device)[:, None]
    cc = torch.arange(alpha.shape[1], device=device)[None, :]
    idx = mv["index"].to(device).long()
    sel_t, sel_r = mv["try_t"].to(device)[kk, idx, cc], mv["try_r"].to(device)[kk, idx, cc]
    next_t, next_r = chain["t"].to(device)[steps], chain["r"].to(device)[steps]
    want_t = torch.where(accept[..., None], sel_t, prev_t)
    want_r = torch.where(accept[..., None], sel_r, prev_r)
    wrong = ((next_t != want_t).any(-1) | (next_r != want_r).any(-1)) & clear
    out.update(alpha_scale=scale, decision=float(wrong.sum()))
    return out


def numbers(cand, ref, rec):
    """The nine numbers of one chain for a candidate's outputs."""
    chain_numbers = mcmc.numbers(cand, ref, rec)
    c, r = cand["moves"], ref["moves"]
    tries = max(finite_gap(c["try_d"].cpu(), r["try_d"].cpu()),
                finite_gap(c["ref_d"].cpu(), r["ref_d"].cpu()))
    a_c, a_r = c["log_alpha"].cpu().double(), r["log_alpha"].cpu().double()
    alpha = finite_gap(a_c / ref["alpha_scale"].cpu(), a_r / ref["alpha_scale"].cpu(),
                       rel=False)
    wrong_pick = (((c["index"].cpu().long() != r["index"].cpu()) & ref["pick_clear"].cpu())
                  | ref["m_outside"].cpu()[:, None])
    return {**{k: chain_numbers[k] for k in ("prep", "loglike", "density", "stuck",
                                             "estimate")},
            "tries": tries, "alpha": alpha, "select": float(wrong_pick.sum()),
            "decision": ref["decision"]}


def program(rec):
    """The port's outputs of one chain and its recorded moves, as the record
    holds them."""
    mv = rec["moves"]
    return dict(mcmc.program(rec), moves=dict(try_d=mv["try_log_prob"],
                                              ref_d=mv["ref_log_prob"],
                                              log_alpha=mv["log_alpha"], index=mv["index"]))
