"""Sample: the immutable state container flowing through all samplers.

Counterpart of ``jl_tpu/samples.py``: ``variables`` maps names to tensors
with a leading particle dim; quaternion variables use tangent-space ⊕/⊖.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

from . import quaternions as quat

__all__ = ["Sample", "sample_plus", "sample_minus", "to_model_domain", "to_unconstrained_domain"]


@dataclass(frozen=True)
class Sample:
    """variables: dict name -> tensor; log_prob / log_like: [N] (or None
    before the first density evaluation)."""

    variables: dict
    log_prob: Any = None
    log_like: Any = None

    @property
    def names(self):
        return tuple(self.variables.keys())

    def __getitem__(self, names):
        if isinstance(names, str):
            names = (names,)
        return Sample({k: self.variables[k] for k in names})

    def merge(self, other) -> "Sample":
        """Right-biased merge of the variables of ``other`` (a Sample or a
        dict); the log densities are reset."""
        other_vars = other.variables if isinstance(other, Sample) else other
        return Sample({**self.variables, **other_vars})

    def set_logdensities(self, log_prob, log_like) -> "Sample":
        return replace(self, log_prob=log_prob, log_like=log_like)


def sample_plus(s: Sample, deltas: dict, quaternion_names=()) -> Sample:
    """s ⊕ deltas: quaternions get q * exp(v), the rest x + v."""
    return Sample({
        k: (v if k not in deltas else
            quat.qplus(v, deltas[k]) if k in quaternion_names else v + deltas[k])
        for k, v in s.variables.items()
    })


def sample_minus(a: Sample, b: Sample, names=None, quaternion_names=()) -> dict:
    """a ⊖ b per variable (default: the shared names)."""
    if names is None:
        names = tuple(k for k in a.variables if k in b.variables)
    return {k: (quat.qminus(a.variables[k], b.variables[k]) if k in quaternion_names
                else a.variables[k] - b.variables[k]) for k in names}


def to_model_domain(s: Sample, bijectors: dict, batch_ndim: int = 1):
    """Unconstrained -> model domain; returns (sample, summed logjac)."""
    logjac = 0.0
    new_vars = dict(s.variables)
    for name, b in bijectors.items():
        if name in new_vars:
            x, lj = b.inverse_with_logjac(new_vars[name])
            new_vars[name] = x
            if lj.dim() > batch_ndim:
                lj = lj.sum(dim=tuple(range(batch_ndim, lj.dim())))
            logjac = logjac + lj
    return replace(s, variables=new_vars), logjac


def to_unconstrained_domain(s: Sample, bijectors: dict) -> Sample:
    """Model -> unconstrained domain; the densities are kept."""
    return Sample({k: (bijectors[k].forward(v) if k in bijectors else v)
                   for k, v in s.variables.items()}, s.log_prob, s.log_like)
