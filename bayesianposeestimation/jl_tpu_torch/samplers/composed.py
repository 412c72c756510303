"""ComposedSampler: one weighted-random sub-sampler per step;
CoordinateSampler: every sub-sampler in turn within one step.

Counterpart of ``jl_tpu/samplers/composed.py``. JAX draws the pick on the
device and branches with ``lax.switch``; here the pick is drawn on the host
generator (as the original Julia sampler does), so choosing a branch never
waits for the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

__all__ = ["ComposedSampler", "CoordinateSampler"]


@dataclass(frozen=True, eq=False)
class ComposedSampler:
    samplers: tuple
    weights: Any  # probability weights, one per sampler

    def probs(self) -> torch.Tensor:
        w = torch.as_tensor(self.weights, dtype=torch.float32)
        return w / w.sum()

    def init(self, rngs, model, n_particles=None):
        """The first sampler initializes."""
        return self.samplers[0].init(rngs, model, n_particles)

    def pick(self, rngs) -> int:
        """The index of this step's sub-sampler, drawn from the host generator."""
        return int(torch.multinomial(self.probs(), 1, generator=rngs.host))

    def step(self, rngs, model, state):
        return self.samplers[self.pick(rngs)].step(rngs, model, state)


@dataclass(frozen=True, eq=False)
class CoordinateSampler:
    """Runs all sub-samplers one after the other in one step (block-wise
    sampling, as the coordinate particle filter moves t and then r)."""

    samplers: tuple

    def init(self, rngs, model, n_particles=None):
        return self.samplers[0].init(rngs, model, n_particles)

    def step(self, rngs, model, state):
        sample = None
        for s in self.samplers:
            sample, state = s.step(rngs, model, state)
        return sample, state
