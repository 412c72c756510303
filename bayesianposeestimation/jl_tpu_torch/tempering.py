"""Likelihood-tempering schedules ϕ: 0 -> 1 (counterpart of ``jl_tpu/tempering.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import math

import torch

__all__ = ["ConstantSchedule", "LinearSchedule", "ExponentialSchedule", "StepCount"]


class StepCount:
    """A chain's step count as ``LinearSchedule`` reads it on the device:
    the fp32 increment 1/n_steps in a 0-dim tensor, which ``set`` rewrites
    between runs, so one captured step serves every step count (a paced
    sweep changes it from run to run). The increment is the fp32 rounding
    of the host's 1/n_steps, the value the schedule adds for an int."""

    def __init__(self, device, n_steps: int = 1):
        self.increment = torch.empty((), dtype=torch.float32, device=device)
        self.set(n_steps)

    def set(self, n_steps: int) -> "StepCount":
        self.n_steps = int(n_steps)
        self.increment.fill_(float(torch.tensor(1.0 / self.n_steps, dtype=torch.float32)))
        return self


@dataclass(frozen=True)
class ConstantSchedule:
    """Sample from the untempered posterior: ϕ ≡ 1 (a tensor of ones on the
    temperature's device, so nothing is read on the host)."""

    def increment(self, temperature: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(temperature, dtype=torch.float32)


@dataclass(frozen=True)
class LinearSchedule:
    """ϕ += 1/n_steps, capped at 1 (fp32, on the temperature's device).
    ``n_steps``: an int, or a ``StepCount`` read on the device."""

    n_steps: Any

    def increment(self, temperature: torch.Tensor) -> torch.Tensor:
        step = (self.n_steps.increment if isinstance(self.n_steps, StepCount)
                else 1.0 / self.n_steps)
        return torch.clamp(temperature + step, max=1.0)


@dataclass(frozen=True)
class ExponentialSchedule:
    """Exponential saturation towards 1: ϕ' = ϕ·e^(-λ) + 1 - e^(-λ), with λ
    chosen so that ϕ reaches ``goal_temp`` from 0 after ``n_steps``."""

    n_steps: int
    goal_temp: float = 0.99

    @property
    def lam(self):
        return -math.log(1.0 - self.goal_temp) / self.n_steps

    def increment(self, temperature: torch.Tensor) -> torch.Tensor:
        decay = math.exp(-self.lam)
        return temperature.to(torch.float32) * decay + (1.0 - decay)
