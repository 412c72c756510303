"""Distributions: pure-function ``logpdf`` and ``sample``.

Counterpart of ``jl_tpu/distributions.py`` (``Normal``, ``Exponential``,
``TruncatedExponential``, ``SmoothExponential``, ``Uniform``,
``TailUniform``, ``Dirac``, ``BinaryMixture``, ``QuaternionUniform``,
``QuaternionNormal``, ``Gumbel``, ``MvNormal``, ``bijector_of``,
``broadcast_shape_of`` and the kernel-safe ``log_ndtr``). Parameters are
floats or tensors that broadcast against the value; ``sample(generator,
shape)`` draws ``shape + broadcast_shape`` values on the generator's device.
A Python-number parameter becomes a tensor by a fill on the value's device,
never by a host-to-device copy, which would synchronise the stream.

Invalid-measurement convention: observed depth +inf gives -inf under every
density except ``TailUniform``, and the mixtures combine in log space, where
``logaddexp(-inf, -inf) = -inf`` keeps the all-invalid case free of NaN.
"""

from __future__ import annotations

import dataclasses
import math
import numbers
from dataclasses import dataclass
from typing import Any

import torch

from . import quaternions as quat
from .bijectors import IDENTITY, LOG, LOGIT

__all__ = ["Normal", "Exponential", "TruncatedExponential", "SmoothExponential", "Uniform",
           "TailUniform", "Dirac", "BinaryMixture", "QuaternionUniform", "QuaternionNormal",
           "Gumbel", "MvNormal", "bijector_of", "broadcast_shape_of", "log_ndtr"]

# smallest normal fp32; the JAX package's 1e-38 floors lie below it
_FLT_MIN = torch.finfo(torch.float32).tiny


def _on(v, dtype, device) -> torch.Tensor:
    """``v`` as a tensor of ``dtype`` on ``device``; a number (Python or
    NumPy scalar) is filled there (no host-to-device copy)."""
    if isinstance(v, numbers.Real):
        return torch.full((), v, dtype=dtype, device=device)
    return torch.as_tensor(v, dtype=dtype, device=device)


def _as(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a tensor of ``like``'s dtype and device."""
    return _on(v, like.dtype, like.device)


def _float_dtype(*params):
    """The dtype of the first floating tensor among ``params`` (float32 if none)."""
    return next((p.dtype for p in params if isinstance(p, torch.Tensor)
                 and p.is_floating_point()), torch.float32)


def _uniform(generator: torch.Generator, shape, dtype):
    return torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)


def _log_floored(v):
    """log(max(v, 1e-38)) as the JAX package evaluates it: XLA flushes the
    subnormal floor to zero, so the result is -inf wherever v < FLT_MIN.
    Written out, so it does not depend on the device's denormal handling."""
    return torch.where(v < _FLT_MIN, torch.full_like(v, -torch.inf), torch.log(v))


def _log1mexp(a):
    """log(1 - exp(a)) for a <= 0, without log1p/expm1 (the JAX formula)."""
    return _log_floored(1.0 - torch.exp(a))


def _erf_approx(x):
    """Abramowitz & Stegun 7.1.26 erf (|err| < 1.5e-7), the JAX formula."""
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741 + t * (
        -1.453152027 + t * 1.061405429))))
    return s * (1.0 - poly * torch.exp(-ax * ax))


def log_ndtr(x):
    """log Φ(x) by the JAX package's kernel-safe formula (not
    ``torch.special.log_ndtr``): the A&S erf for x > -4 and the 3-term
    asymptotic series log Φ(x) ~ -x²/2 - log(-x√(2π)) + log(1 - 1/x² + 3/x⁴
    - 15/x⁶) below, with the same operation order as the CUDA kernel."""
    xb = torch.clamp(x, min=-4.0)
    body = _log_floored(0.5 * (1.0 + _erf_approx(xb * 0.7071067811865476)))
    xt = torch.clamp(x, max=-4.0)
    inv2 = 1.0 / (xt * xt)
    tail = (-0.5 * xt * xt - torch.log(-xt * 2.5066282746310002)
            + torch.log(1.0 - inv2 + 3.0 * inv2 * inv2 - 15.0 * inv2 * inv2 * inv2))
    return torch.where(x > -4.0, body, tail)


def _param_shape(*params) -> tuple:
    return torch.broadcast_shapes(*(tuple(torch.as_tensor(p).shape) for p in params))


@dataclass(frozen=True)
class Normal:
    """Gaussian N(loc, scale²)."""

    loc: Any = 0.0
    scale: Any = 1.0

    def logpdf(self, x):
        scale = _as(self.scale, x)
        z = (x - self.loc) / scale
        # x = +inf (invalid measurement) gives z = inf -> -inf, no NaN
        return -0.5 * z * z - torch.log(scale) - 0.5 * math.log(2.0 * math.pi)

    def sample(self, generator: torch.Generator, shape=()):
        b = _param_shape(self.loc, self.scale)
        dtype = next((p.dtype for p in (self.scale, self.loc) if isinstance(p, torch.Tensor)),
                     torch.float32)
        eps = torch.randn((*shape, *b), generator=generator, dtype=dtype,
                          device=generator.device)
        return self.loc + self.scale * eps

    @property
    def bijector(self):
        return IDENTITY


@dataclass(frozen=True)
class Exponential:
    """Exponential with *mean* θ: pdf(x) = exp(-x/θ)/θ on [0, inf)."""

    theta: Any = 1.0

    def logpdf(self, x):
        theta = _as(self.theta, x)
        valid = x >= 0
        ll = -torch.where(valid, x, torch.zeros_like(x)) / theta - torch.log(theta)
        return torch.where(valid, ll, torch.full_like(ll, -torch.inf))

    def sample(self, generator: torch.Generator, shape=()):
        dtype = _float_dtype(self.theta)
        theta = _on(self.theta, dtype, generator.device)
        e = torch.empty((*shape, *theta.shape), dtype=dtype, device=generator.device)
        return theta * e.exponential_(generator=generator)

    @property
    def bijector(self):
        return LOG


@dataclass(frozen=True)
class TruncatedExponential:
    """Exponential (mean θ) truncated to [low, high]; for high <= low (e.g. a
    background render μ = 0 as the upper bound) the density is zero
    everywhere."""

    theta: Any = 1.0
    low: Any = 0.0
    high: Any = math.inf

    def logpdf(self, x):
        theta, low, high = _as(self.theta, x), _as(self.low, x), _as(self.high, x)
        inside = (x >= low) & (x <= high)
        # log P(low <= X <= high) = -low/θ + log(1 - exp(-(high-low)/θ))
        span = (high - low) / theta
        ok = span > 0
        log_z = -low / theta + _log1mexp(-torch.where(ok, span, torch.ones_like(span)))
        ll = -torch.where(inside, x, torch.zeros_like(x)) / theta - torch.log(theta) - log_z
        return torch.where(inside & ok, ll, torch.full_like(ll, -torch.inf))

    def sample(self, generator: torch.Generator, shape=()):
        """Inverse CDF of the truncated exponential."""
        dtype = _float_dtype(self.theta, self.low, self.high)
        dev = generator.device
        theta, low, high = (_on(p, dtype, dev) for p in (self.theta, self.low, self.high))
        u = _uniform(generator, (*shape, *torch.broadcast_shapes(
            theta.shape, low.shape, high.shape)), dtype)
        cl = -torch.expm1(-low / theta)
        ch = -torch.expm1(-high / theta)
        return -theta * torch.log1p(-(cl + u * (ch - cl)))

    @property
    def bijector(self):
        return LOG


@dataclass(frozen=True)
class SmoothExponential:
    """Exponential decay (mean θ) on [low, high] convolved with sensor noise
    N(0, σ²): the smoothly truncated occlusion component of the smooth pixel
    models. Closed form

        f(z) = exp(σ²/(2θ²) - (z-low)/θ) / (θ Z)
               · [Φ((z-low)/σ - σ/θ) - Φ((z-high)/σ - σ/θ)],
        Z    = 1 - exp(-(high-low)/θ);

    zero density for high <= low (e.g. background μ = 0) and at z = +inf.
    Where fp32 cannot tell Φ(a) from Φ(b) the density is exactly zero, as in
    the JAX package."""

    low: Any = 0.0
    high: Any = 1.0
    theta: Any = 1.0
    sigma: Any = 0.01

    def logpdf(self, x):
        theta, sigma = _as(self.theta, x), _as(self.sigma, x)
        low, high = _as(self.low, x), _as(self.high, x)
        span = high - low
        ok = span > 0
        finite_x = torch.isfinite(x)
        xs = torch.where(finite_x, x, torch.zeros_like(x))
        a = (xs - low) / sigma - sigma / theta
        b = (xs - high) / sigma - sigma / theta
        la = log_ndtr(a)
        lb = log_ndtr(b)
        # log(Φ(a) - Φ(b)) = la + log(1 - exp(lb - la)), clipped below 0
        diff = torch.clamp(lb - la, max=0.0)
        log_window = la + _log1mexp(torch.clamp(diff, max=-1e-12))
        log_z = _log1mexp(-torch.where(ok, span, torch.ones_like(span)) / theta)
        r = sigma / theta
        ll = 0.5 * (r * r) - (xs - low) / theta - torch.log(theta) - log_z + log_window
        return torch.where(ok & finite_x, ll, torch.full_like(ll, -torch.inf))

    def sample(self, generator: torch.Generator, shape=()):
        """A truncated-exponential draw plus N(0, σ²) sensor noise."""
        base = TruncatedExponential(self.theta, self.low, self.high).sample(generator, shape)
        noise = torch.randn(base.shape, generator=generator, dtype=base.dtype,
                            device=generator.device)
        return base + _on(self.sigma, base.dtype, generator.device) * noise

    @property
    def bijector(self):
        return IDENTITY


@dataclass(frozen=True)
class Uniform:
    """Uniform on [low, high]; -inf outside the support."""

    low: Any = 0.0
    high: Any = 1.0

    def logpdf(self, x):
        low, high = _as(self.low, x), _as(self.high, x)
        inside = (x >= low) & (x <= high)
        val = -torch.log(high - low)
        return torch.where(inside, val, torch.full_like(val, -torch.inf))

    def sample(self, generator: torch.Generator, shape=()):
        dtype = _float_dtype(self.low, self.high)
        low, high = (_on(p, dtype, generator.device) for p in (self.low, self.high))
        u = _uniform(generator, (*shape, *torch.broadcast_shapes(low.shape, high.shape)), dtype)
        return low + u * (high - low)

    @property
    def bijector(self):
        return LOGIT


@dataclass(frozen=True)
class TailUniform:
    """Uniform density 1/(high-low) everywhere, +inf included: the long tail
    that keeps invalid measurements from zeroing an image likelihood."""

    low: Any = 0.0
    high: Any = 1.0

    def logpdf(self, x):
        val = -torch.log(_as(self.high, x) - _as(self.low, x))
        return val.expand(torch.broadcast_shapes(x.shape, val.shape))

    def sample(self, generator: torch.Generator, shape=()):
        return Uniform(self.low, self.high).sample(generator, shape)

    @property
    def bijector(self):
        return IDENTITY


@dataclass(frozen=True)
class Dirac:
    """Point mass: logpdf 0 at the atom, -inf elsewhere."""

    value: Any = 0.0

    def logpdf(self, x):
        v = _as(self.value, x)
        return torch.where(x == v, torch.zeros_like(x), torch.full_like(x, -torch.inf))

    def sample(self, generator: torch.Generator, shape=()):
        v = _on(self.value, _float_dtype(self.value), generator.device)
        return v.expand(*shape, *v.shape)

    @property
    def bijector(self):
        return IDENTITY


@dataclass(frozen=True)
class Gumbel:
    """Gumbel(loc, scale); the standard one drives the Gumbel-max pick of
    multiple-try Metropolis."""

    loc: Any = 0.0
    scale: Any = 1.0

    def logpdf(self, x):
        scale = _as(self.scale, x)
        z = (x - _as(self.loc, x)) / scale
        return -(z + torch.exp(-z)) - torch.log(scale)

    def sample(self, generator: torch.Generator, shape=()):
        """loc + scale · (-log(-log u)), u uniform in [tiny, 1)."""
        dtype = _float_dtype(self.loc, self.scale)
        u = _uniform(generator, (*shape, *_param_shape(self.loc, self.scale)), dtype)
        g = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(dtype).tiny)))
        return self.loc + self.scale * g

    @property
    def bijector(self):
        return IDENTITY


@dataclass(frozen=True)
class BinaryMixture:
    """Two-component mixture with unnormalized weights ``weight_a``, ``weight_b``."""

    dist_a: Any = None
    dist_b: Any = None
    weight_a: Any = 1.0
    weight_b: Any = 1.0

    def logpdf(self, x):
        wa = _as(self.weight_a, x)
        wb = _as(self.weight_b, x)
        log_norm = torch.log(wa + wb)
        la = torch.log(wa) - log_norm + self.dist_a.logpdf(x)
        lb = torch.log(wb) - log_norm + self.dist_b.logpdf(x)
        return torch.logaddexp(la, lb)

    def sample(self, generator: torch.Generator, shape=()):
        """A draw of each component, then component a where a uniform falls
        below weight_a / (weight_a + weight_b)."""
        a = self.dist_a.sample(generator, shape)
        b = self.dist_b.sample(generator, shape)
        wa, wb = (_on(w, a.dtype, generator.device) for w in (self.weight_a, self.weight_b))
        u = _uniform(generator, torch.broadcast_shapes(a.shape, b.shape), a.dtype)
        return torch.where(u < wa / (wa + wb), a, b)

    @property
    def bijector(self):
        return IDENTITY


# Surface area of the unit 3-sphere; uniform density w.r.t. the S^3 measure.
_LOG_SURFACE_S3 = math.log(2.0 * math.pi**2)


@dataclass(frozen=True)
class QuaternionUniform:
    """Uniform distribution over unit quaternions ``[..., 4]`` (Haar on S^3)."""

    dtype: Any = torch.float32

    def logpdf(self, x):
        return torch.full(x.shape[:-1], -_LOG_SURFACE_S3, dtype=x.dtype, device=x.device)

    def sample(self, generator: torch.Generator, shape=()):
        return quat.rand_quaternion(generator, shape, dtype=self.dtype)

    @property
    def bijector(self):
        return IDENTITY


@dataclass(frozen=True)
class QuaternionNormal:
    """Tangent-space Gaussian around a mean quaternion: q = loc ⊕ v with
    v ~ N(0, scale² I₃); the particle filter's orientation prior."""

    loc: Any = None  # [..., 4]
    scale: Any = 0.1

    def logpdf(self, x):
        v = quat.qminus(x, _as(self.loc, x))
        return Normal(0.0, self.scale).logpdf(v).sum(-1)

    def sample(self, generator: torch.Generator, shape=()):
        loc = torch.as_tensor(self.loc)
        b = torch.broadcast_shapes(loc.shape[:-1], tuple(torch.as_tensor(self.scale).shape))
        eps = torch.randn((*shape, *b, 3), generator=generator, dtype=loc.dtype,
                          device=generator.device)
        return quat.qplus(loc, self.scale * eps)

    @property
    def bijector(self):
        return IDENTITY


@dataclass(frozen=True)
class MvNormal:
    """Zero-centred multivariate normal with full covariance ``cov`` [d, d];
    values are [..., d]."""

    cov: Any = None

    def logpdf(self, x):
        cov = _as(self.cov, x)
        d = cov.shape[-1]
        chol = torch.linalg.cholesky(cov)
        quad = torch.einsum("...i,ij,...j->...", x, torch.linalg.inv(cov), x)
        logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
        return -0.5 * (quad + logdet + d * math.log(2.0 * math.pi))

    def sample(self, generator: torch.Generator, shape=()):
        cov = torch.as_tensor(self.cov)
        eps = torch.randn((*shape, cov.shape[-1]), generator=generator, dtype=cov.dtype,
                          device=generator.device)
        return eps @ torch.linalg.cholesky(cov.to(generator.device)).T

    @property
    def bijector(self):
        return IDENTITY


def bijector_of(dist):
    """Bijector mapping the distribution's support to R^n."""
    return dist.bijector


def _leaves(dist):
    """The numeric parameters of a distribution, nested mixtures included."""
    for f in dataclasses.fields(dist):
        v = getattr(dist, f.name)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            yield from _leaves(v)
        elif isinstance(v, (torch.Tensor, numbers.Real, tuple, list)):
            yield v


def broadcast_shape_of(dist) -> tuple:
    """Broadcast shape of the distribution's parameters."""
    leaves = list(_leaves(dist))
    return tuple(_param_shape(*leaves)) if leaves else ()
