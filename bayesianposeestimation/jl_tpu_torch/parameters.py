"""Inference configuration and the per-scene Experiment container.

Counterpart of ``jl_tpu/parameters.py``. ``Parameters`` is a frozen dataclass
with the same field names and defaults, except that ``float_type`` is a torch
dtype and ``device`` names a torch device. ``Experiment`` holds the scene and
observation as tensors; invalid depth (<= 0) becomes +inf so only the
long-tail pixel component carries density there.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

__all__ = ["Parameters", "Experiment"]


@dataclass(frozen=True)
class Parameters:
    """Inference configuration (same defaults as the JAX package)."""

    # Render context
    width: int = 30
    height: int = 30
    depth: int = 100
    min_depth: float = 0.5
    max_depth: float = 1.5

    # Depth pixel model
    pixel_sigma: float = 0.01
    pixel_theta: float = 1.0
    # Pixel association
    association_sigma: float = 0.01
    proposal_sigma_o: float = 0.01
    # Image model
    c_reg: float = 50.0

    # Pose model
    sigma_t: tuple = (0.03, 0.03, 0.03)
    # Association model
    o_mask_is: float = 0.7
    o_mask_not: float = 0.3
    # Proposal model
    proposal_sigma_t: tuple = (0.01, 0.01, 0.01)
    proposal_sigma_r: tuple = (0.1, 0.1, 0.1)
    velocity_decay: float = 0.9

    # Inference
    float_type: Any = torch.float32
    device: str = "cuda"
    seed: int = 8418387917544508114
    n_steps: int = 3_000
    time_budget: float = 0.5
    n_burn_in: int = 0
    n_thinning: int = 0
    n_particles: int = 100
    relative_ess: float = 0.5
    w_r_ind: float = 0.1
    w_t_ind: float = 0.1
    w_r_sym: float = 0.9
    w_t_sym: float = 0.9

    @property
    def img_size(self):
        return (self.width, self.height)

    def replace(self, **kw) -> "Parameters":
        return dataclasses.replace(self, **kw)

    def cast(self, x):
        """``x`` as a tensor of the configured float type (on its own
        device, if it is a tensor)."""
        return torch.as_tensor(x, dtype=self.float_type)


@dataclass(frozen=True)
class Experiment:
    """Per-scene data: ``scene`` = {'camera': CvCamera, 'verts': [V,3] f32,
    'faces': [F,3] int32}, ``prior_o`` (float or [H, W]), ``prior_t`` [3],
    ``prior_r`` [4] (identity if None) and the observed ``depth_image`` [H, W]
    with invalid pixels (<= 0) replaced by +inf."""

    scene: dict
    prior_o: Any
    prior_t: Any
    prior_r: Any = None
    depth_image: Any = None

    def __post_init__(self):
        if self.prior_r is None:
            object.__setattr__(self, "prior_r", torch.tensor([1.0, 0.0, 0.0, 0.0]))
        if self.depth_image is not None:
            img = torch.as_tensor(self.depth_image, dtype=torch.float32)
            img = torch.where(img <= 0, torch.full_like(img, torch.inf), img)
            object.__setattr__(self, "depth_image", img)
        if self.prior_t is not None:
            object.__setattr__(self, "prior_t", torch.as_tensor(self.prior_t, dtype=torch.float32))

    def with_depth_image(self, depth_image) -> "Experiment":
        """The same experiment with another observation (streaming filters)."""
        return Experiment(self.scene, self.prior_o, self.prior_t, self.prior_r, depth_image)

    @property
    def camera(self):
        return self.scene["camera"]

    def to(self, device) -> "Experiment":
        """The same experiment with every tensor on ``device``."""
        scene = {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
                 for k, v in self.scene.items()}
        prior_o = (self.prior_o.to(device) if isinstance(self.prior_o, torch.Tensor)
                   else self.prior_o)
        depth = None if self.depth_image is None else self.depth_image.to(device)
        return Experiment(scene, prior_o, self.prior_t.to(device),
                          self.prior_r.to(device), depth)
