"""Posterior and prior factories: the user-facing model constructors.

Counterpart of ``jl_tpu/models/experiment_models.py``: ``point_prior``,
``point_from_segmentation`` (host-side NumPy) and the six graph posteriors
``simple_posterior``, ``association_posterior``, ``association_simple_reg``,
``smooth_posterior``, ``smooth_simple_reg`` and ``smooth_simple_posterior``.
Each factory wires the prior (whose last node is the render node μ(t, r)),
an association node o, the per-pixel mixture z conditioned on the
observation, and an image regularizer into a ``PosteriorModel`` on the
prior's device. An evaluation renders μ with one ``render_depth`` launch and
scores it in tensor code; ``models.fused`` computes the same densities in
one fused launch.

Building a posterior makes no host-device copy: the mesh was uploaded by the
prior (``render.render_scene``) and a Python-number prior o is filled on the
device, so a tracker can rebuild its posterior every frame.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..camera import reproject_3d
from ..devices import resolve_device
from ..distributions import Normal, QuaternionUniform
from ..graph import BroadcastedNode, DeterministicNode, ModifierNode, device_of
from ..parameters import sigma_row
from ..posterior import PosteriorModel
from ..render import render_context, render_fn, render_scene
from .pixel import (
    image_likelihood_normalizer,
    pixel_association_fn,
    pixel_mixture,
    simple_image_regularization,
    smooth_association_fn,
    smooth_mixture,
)

__all__ = [
    "point_prior",
    "point_from_segmentation",
    "simple_posterior",
    "association_posterior",
    "association_simple_reg",
    "smooth_posterior",
    "smooth_simple_reg",
    "smooth_simple_posterior",
]


def point_prior(params, experiment, device="cuda"):
    """t ~ Normal(prior_t, σ_t), r ~ QuaternionUniform, μ = render(t, r) on
    ``device``. Returns the μ node."""
    dev = resolve_device(device)
    sigma_t = sigma_row(params.sigma_t, dev)
    t = BroadcastedNode("t", Normal, experiment.prior_t.to(dev), sigma_t)
    r = BroadcastedNode("r", QuaternionUniform)
    mu_fn = partial(render_fn, render_context(params), render_scene(experiment.scene, dev))
    return DeterministicNode("mu", mu_fn, t, r)


def point_from_segmentation(bounding_box, depth_image, mask_img, cv_camera, diameter=None):
    """Bounding-box centre + masked median depth -> 3D prior point [3] f32.

    ``bounding_box`` = (left, right, top, bottom) in pixels. The median of the
    valid depths under the mask is used (the image centre's depth when there
    are none). ``diameter``: when given, the point is pushed 0.25·diameter
    along its camera ray, since the median lies on the visible surface,
    nearer than the object's centre by about its radius."""
    left, right, top, bottom = bounding_box
    u = (left + right) / 2.0
    v = (top + bottom) / 2.0
    depth = np.asarray(depth_image)
    mask = np.asarray(mask_img) > 0
    masked = depth[mask]
    masked = masked[(masked > 0) & np.isfinite(masked)]
    if masked.size:
        z = float(np.median(masked))
    else:
        z = float(depth[depth.shape[0] // 2, depth.shape[1] // 2])
    x, y, z = reproject_3d(u, v, z, cv_camera)
    p = np.asarray([x, y, z], np.float32)
    if diameter is not None:
        p = p * (1.0 + 0.25 * float(diameter) / max(np.linalg.norm(p), 1e-6))
    return p.astype(np.float32)


def _on_prior_device(experiment, mu_node):
    """(observation [H, W], prior o as a tensor) on the device of the prior
    ending in ``mu_node``; a Python-number prior o is filled there."""
    dev = device_of(mu_node)
    depth = experiment.depth_image.to(dev)
    prior_o = experiment.prior_o
    if isinstance(prior_o, torch.Tensor):
        prior_o = prior_o.to(device=dev, dtype=torch.float32)
    else:
        prior_o = torch.full((), float(prior_o), dtype=torch.float32, device=dev)
    return depth, prior_o


def _fixed_o_node(prior_o, mu_node):
    """The prior o broadcast to the render's shape. (The reference samples a
    Dirac node here; a Dirac's log density at its atom is 0, so the
    deterministic broadcast gives the same densities.)"""
    return DeterministicNode("o", lambda mu: prior_o.expand(mu.shape), mu_node)


def _association_node(o_fn, prior_o, depth, mu_node):
    """o = o_fn(prior o, μ, z) against this experiment's observation ``depth``."""
    return DeterministicNode("o", lambda mu: o_fn(prior_o, mu, depth), mu_node)


def _posterior(params, depth, mixture, mu_node, o_node, normalize_by_o):
    """z ~ mixture(μ, o) | depth, its log density regularized by c_reg / Σo
    (``normalize_by_o``) or by c_reg / n_pixels."""
    z = BroadcastedNode("z", partial(mixture, params.min_depth, params.max_depth,
                                     params.pixel_theta, params.pixel_sigma), mu_node, o_node)
    if normalize_by_o:
        def reg(ell, values):
            return image_likelihood_normalizer(params.c_reg, ell, values["o"])
    else:
        n_pixels = params.width * params.height

        def reg(ell, values):
            return simple_image_regularization(params.c_reg, ell, n_pixels)
    return PosteriorModel(ModifierNode(z | depth, reg))


def simple_posterior(params, experiment, mu_node):
    """Fixed association prior o, exponential + uniform tail,
    SimpleImageRegularization."""
    depth, prior_o = _on_prior_device(experiment, mu_node)
    return _posterior(params, depth, pixel_mixture, mu_node, _fixed_o_node(prior_o, mu_node),
                      normalize_by_o=False)


def association_posterior(params, experiment, mu_node):
    """Analytic pixel association + ImageLikelihoodNormalizer."""
    depth, prior_o = _on_prior_device(experiment, mu_node)
    o = _association_node(pixel_association_fn(params), prior_o, depth, mu_node)
    return _posterior(params, depth, pixel_mixture, mu_node, o, normalize_by_o=True)


def association_simple_reg(params, experiment, mu_node):
    """Analytic pixel association + SimpleImageRegularization."""
    depth, prior_o = _on_prior_device(experiment, mu_node)
    o = _association_node(pixel_association_fn(params), prior_o, depth, mu_node)
    return _posterior(params, depth, pixel_mixture, mu_node, o, normalize_by_o=False)


def smooth_posterior(params, experiment, mu_node):
    """Smooth association + smooth mixture + ImageLikelihoodNormalizer."""
    depth, prior_o = _on_prior_device(experiment, mu_node)
    o = _association_node(smooth_association_fn(params), prior_o, depth, mu_node)
    return _posterior(params, depth, smooth_mixture, mu_node, o, normalize_by_o=True)


def smooth_simple_reg(params, experiment, mu_node):
    """Smooth association + smooth mixture + SimpleImageRegularization."""
    depth, prior_o = _on_prior_device(experiment, mu_node)
    o = _association_node(smooth_association_fn(params), prior_o, depth, mu_node)
    return _posterior(params, depth, smooth_mixture, mu_node, o, normalize_by_o=False)


def smooth_simple_posterior(params, experiment, mu_node):
    """Fixed association prior + pixel mixture + SimpleImageRegularization:
    the reference uses ``pixel_mixture`` here too, not ``smooth_mixture``."""
    depth, prior_o = _on_prior_device(experiment, mu_node)
    return _posterior(params, depth, pixel_mixture, mu_node, _fixed_o_node(prior_o, mu_node),
                      normalize_by_o=False)
