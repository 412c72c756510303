"""The check that no JAX reached the process: a module counts when the first
component of its dotted name is ``jax``, ``jaxlib`` or ``flax``, or its first
two are ``bayesianposeestimation`` and ``jl_tpu`` (the JAX package).
Components are compared whole: ``bayesianposeestimation.jl_tpu_torch.ops``
passes, ``bayesianposeestimation.jl_tpu.ops`` does not."""

from __future__ import annotations

FORBIDDEN_TOP = ("jax", "jaxlib", "flax")
JAX_PACKAGE = ("bayesianposeestimation", "jl_tpu")


def forbidden(names) -> list:
    """The names among ``names`` (module names) that are JAX's."""
    out = []
    for name in names:
        parts = name.split(".")
        if parts[0] in FORBIDDEN_TOP or tuple(parts[:2]) == JAX_PACKAGE:
            out.append(name)
    return sorted(out)
