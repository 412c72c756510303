"""The MH move's tail after the render as one CUDA kernel.

``mh_move`` launches ``csrc/smc_update.cu``'s ``mh_move_kernel`` (built into
the same library as the raster kernels, ``cuda_raster.build_library``): from
``render_score``'s per-pose sums it computes the likelihood's regularizer,
the point prior, the tempered log density, the previous sample re-tempered,
the MH test and its select, and the SMC increment, in one launch in place of
the 39-49 small kernels that ``samplers/mh.py``'s plain version
(``mh_transition_plain``) launches on the card. It takes CUDA tensors only
and raises on anything else; ``samplers/mh.mh_transition`` chooses between
the two.

``mh_move.launches`` counts the moves ``samplers/mh.mh_transition`` sends
here: each reports ``("mh_move_path", "kernel")`` through
``telemetry.count`` (a replayed capture reports it again); a direct call of
the wrapper is not counted.
"""

from __future__ import annotations

import ctypes
import functools
import math
import numbers

import numpy as np
import torch

from .. import telemetry
from ..distributions import _LOG_SURFACE_S3
from . import cuda_raster

__all__ = ["mh_move", "check_inputs"]

# the plain version's constants, as torch rounds them to fp32
_HALF_LOG_2PI = float(np.float32(0.5 * math.log(2.0 * math.pi)))
_LOG_R_DENSITY = float(np.float32(-_LOG_SURFACE_S3))


@functools.lru_cache(maxsize=None)
def _entry():
    lib, _ = cuda_raster.build_library()
    fn = lib.bpe_mh_move
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, p, i, p, i, f, f, f, f, f,
                   p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def check_inputs(ell_raw, sum_o, prop_t, prop_r, prev_t, prev_r, prev_log_prob,
                 prev_log_like, u, old_temp, new_temp, prior_t, sigma_t, c_reg,
                 q_backward=0.0, q_forward=0.0) -> int:
    """Raise unless the arguments are what ``mh_move`` takes (every tensor
    f32, contiguous, on one device, of the shapes ``mh_move`` names; host
    numbers for ``c_reg`` and the transition terms); returns the particle
    count N."""
    n = ell_raw.shape[0] if ell_raw.dim() == 1 else -1
    if n < 1:
        raise ValueError(f"mh_move takes 1 or more particles, got ell_raw of shape "
                         f"{tuple(ell_raw.shape)}")
    for name, x in (("c_reg", c_reg), ("q_backward", q_backward), ("q_forward", q_forward)):
        if isinstance(x, torch.Tensor) or not isinstance(x, numbers.Real):
            raise TypeError(f"{name} must be a host number, got {type(x).__name__}")
    shapes = {"ell_raw": (ell_raw, (n,)), "sum_o": (sum_o, (n,)), "prop_t": (prop_t, (n, 3)),
              "prop_r": (prop_r, (n, 4)), "prev_t": (prev_t, (n, 3)),
              "prev_r": (prev_r, (n, 4)), "prev_log_prob": (prev_log_prob, (n,)),
              "prev_log_like": (prev_log_like, (n,)), "u": (u, (n,)),
              "old_temp": (old_temp, ()), "new_temp": (new_temp, ())}
    for name, x in (("prior_t", prior_t), ("sigma_t", sigma_t)):
        shapes[name] = (x, (3,) if x.dim() == 1 else ())
    dev = ell_raw.device
    for name, (x, shape) in shapes.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, not {dev}")
        cuda_raster._check(name, x, torch.float32, shape)
    return n


def mh_move(ell_raw, sum_o, prop_t, prop_r, prev_t, prev_r, prev_log_prob, prev_log_like, u,
            old_temp, new_temp, prior_t, sigma_t, c_reg, q_backward=0.0, q_forward=0.0,
            increment=False):
    """One MH move's tail on the card.

    ``ell_raw`` and ``sum_o`` f32 [N]: ``render_score``'s sums of the
    proposed poses ``prop_t`` [N, 3], ``prop_r`` [N, 4]; the previous sample
    ``prev_t``, ``prev_r``, ``prev_log_prob`` and ``prev_log_like`` at the
    temperature ``old_temp``; the uniforms ``u`` [N]; the new temperature
    ``new_temp`` (both f32 0-dim); the point prior's ``prior_t`` and
    ``sigma_t`` (f32 [3] or 0-dim); the regularizer's ``c_reg`` and the
    proposal's constant transition terms log q(prev | prop) and log q(prop |
    prev), host numbers (``check_inputs``). Returns (t, r, log_prob,
    log_like) of the accepted sample, every tensor new, and the SMC increment
    (phi' - phi) * prev_log_like [N] with ``increment``, else None. CUDA
    tensors only: any other device raises."""
    n = check_inputs(ell_raw, sum_o, prop_t, prop_r, prev_t, prev_r, prev_log_prob,
                     prev_log_like, u, old_temp, new_temp, prior_t, sigma_t, c_reg, q_backward,
                     q_forward)
    dev = ell_raw.device
    cuda_raster._check_hopper(dev, ell_raw, "mh_move")
    t, r = torch.empty_like(prop_t), torch.empty_like(prop_r)
    log_prob, log_like = torch.empty_like(ell_raw), torch.empty_like(ell_raw)
    incr = torch.empty_like(ell_raw) if increment else None
    with torch.cuda.device(dev):
        err = _entry()(
            n, ell_raw.data_ptr(), sum_o.data_ptr(), prop_t.data_ptr(), prop_r.data_ptr(),
            prev_t.data_ptr(), prev_r.data_ptr(), prev_log_prob.data_ptr(),
            prev_log_like.data_ptr(), u.data_ptr(), old_temp.data_ptr(), new_temp.data_ptr(),
            prior_t.data_ptr(), prior_t.dim(), sigma_t.data_ptr(), sigma_t.dim(),
            float(np.float32(c_reg)), _HALF_LOG_2PI, _LOG_R_DENSITY,
            float(np.float32(q_backward)), float(np.float32(q_forward)), t.data_ptr(),
            r.data_ptr(), log_prob.data_ptr(), log_like.data_ptr(),
            None if incr is None else incr.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mh_move kernel launch failed: cudaError {err}")
    return t, r, log_prob, log_like, incr


mh_move.launches = 0


def _count_launch(key, n):
    if key == ("mh_move_path", "kernel"):
        mh_move.launches += n


telemetry.add_listener(_count_launch)
