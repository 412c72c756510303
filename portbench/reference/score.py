"""The image likelihood of rendered depth against an observation: the pixel
models and regularizers of the posterior (frozen copies), in plain PyTorch.

Per pixel, with μ the rendered depth (0 = background), z the observation
(+inf where invalid) and o the association probability:

    p(z) = o·N(z; μ, σ) + (1 - o)·(½·Exp(z; θ) + ½·U(min, max))

``association``: o is the posterior that the pixel shows the object, from
the prior o (the mask prior) and the same mixture's two parts with the
association σ; the prior itself where it is 0 or 1 or μ <= 0 (sums in at
least float32). The image's
log-likelihood is c_reg / Σo · Σ log p(z). ``fixed_o``: o is the prior, and
the image's log-likelihood is c_reg / (H·W) · Σ log p(z)."""

from __future__ import annotations

import math

import torch


def _normal(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * z * z - torch.log(scale) - 0.5 * math.log(2.0 * math.pi)


def _tail(x, theta, low, high):
    """½·Exp(θ) + ½·TailUniform(low, high), as the mixture of weights 1, 1."""
    valid = x >= 0
    le = -torch.where(valid, x, torch.zeros_like(x)) / theta - torch.log(theta)
    le = torch.where(valid, le, torch.full_like(le, -torch.inf))
    lu = (-torch.log(high - low)).expand_as(x)
    one = torch.ones_like(theta)
    log_norm = torch.log(one + one)
    return torch.logaddexp(torch.log(one) - log_norm + le, torch.log(one) - log_norm + lu)


def _mixture(x, mu, sigma, o, theta, low, high):
    wa, wb = o, 1.0 - o
    log_norm = torch.log(wa + wb)
    la = torch.log(wa) - log_norm + _normal(x, mu, sigma)
    lb = torch.log(wb) - log_norm + _tail(x, theta, low, high)
    return torch.logaddexp(la, lb)


def image_loglike(mu, z, prior_o, p, epilogue, dtype=torch.float32):
    """Log-likelihood [N] of rendered depth ``mu`` [N, P] against ``z`` [P]
    with prior o ``prior_o`` [P] (or a number); ``p`` holds min_depth,
    max_depth, pixel_theta, pixel_sigma, association_sigma and c_reg."""
    dev = mu.device

    def c(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    mu, z = mu.to(dtype), z.to(dtype).reshape(1, -1)
    prior = torch.as_tensor(prior_o, dtype=dtype, device=dev).expand(z.shape)
    theta, low, high = c(p["pixel_theta"]), c(p["min_depth"]), c(p["max_depth"])
    if epilogue == "association":
        sig_a = c(p["association_sigma"])
        l_is = torch.log(prior) + _normal(z, mu, sig_a)
        l_not = torch.log(torch.clamp(1.0 - prior, min=1e-38)) + _tail(z, theta, low, high)
        post = torch.exp(l_is - torch.logaddexp(l_is, l_not))
        limit = (prior <= 0.0) | (prior >= 1.0) | (mu <= 0.0)
        o = torch.where(limit, prior, post)
    elif epilogue == "fixed_o":
        o = prior
    else:
        raise ValueError(f"no reference for the {epilogue!r} epilogue")
    ell_px = _mixture(z, mu, c(p["pixel_sigma"]), o, theta, low, high)
    acc = torch.float64 if dtype == torch.float64 else torch.float32  # sums: at least fp32
    ell = ell_px.to(acc).sum(-1)
    n = o.expand_as(ell_px).to(acc).sum(-1) if epilogue == "association" else \
        torch.full_like(ell, float(z.shape[-1]))
    safe = torch.where(n == 0, torch.ones_like(n), n)
    return torch.where(n == 0, torch.full_like(ell, -torch.inf), p["c_reg"] / safe * ell)
