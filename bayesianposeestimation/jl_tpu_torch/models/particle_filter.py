"""Streaming particle filters for depth-image pose tracking.

Counterpart of ``jl_tpu/models/particle_filter.py``: the velocity-state
prior with its render node (``pf_prior``) and without it for the fused
likelihood (``pf_prior_nodes``), the decayed-velocity, constant-acceleration
proposals (``Dynamics``, ``JointDynamics``), ``resize_experiment`` /
``crop_experiment``, and the two filters — ``coordinate_pf`` (block-wise: a
bootstrap step on t, then one on r) and ``bootstrap_pf`` (joint dynamics).

JAX scans the frames inside one compiled program; here a filter is a
``capture.ChainRunner`` whose frame step is captured once as a CUDA graph
(one per filter kind, cached as the JAX package caches its jitted runner:
per posterior factory, parameters, kind, collected variables, stream shape
and experiment) and replayed per frame, after the frame is copied, device
to device, into the observation buffer the step reads. The stream lies on
the device, resampling is ``torch.where``-selected and nothing is read on
the host per frame. A fused posterior (a factory from
``fused_pf_posterior``, marked ``fused``) is built once and each frame
written into its observation (``FusedPosterior.with_observation``). Any
other factory is called as ``posterior_fn(params, experiment, prior)`` with
``pf_prior``, as in the JAX package: the prior (mesh and sigmas on the
device) is built once and the posterior rebuilt inside every frame step on
that frame's experiment, so an association node scores every frame against
its own image. On the CPU the same step runs eagerly; ``captured=False``
runs the eager frame loop. The proposals take their normals as arguments
(``apply``), so a test can hand both packages the same draws.
"""

from __future__ import annotations

import collections
import math
import weakref
from dataclasses import dataclass
from functools import partial
from typing import Any

import torch

from .. import quaternions as quat
from .. import telemetry
from ..camera import crop_camera
from ..capture import ChainRunner
from ..convert import stream_from_numpy
from ..devices import resolve_device
from ..distributions import Normal, QuaternionNormal
from ..graph import BroadcastedNode, DeterministicNode
from ..parameters import Experiment, sigma_row
from ..render import render_context, render_fn, render_scene
from ..rngs import Rngs
from ..samplers import (
    BootstrapKernel,
    CoordinateSampler,
    SequentialMonteCarlo,
    collect_variables,
)
from ..samples import Sample
from ..telemetry import count, span
from ..tempering import ConstantSchedule
from .fused import fused_posterior

__all__ = [
    "pf_prior",
    "pf_prior_nodes",
    "fused_pf_posterior",
    "Dynamics",
    "JointDynamics",
    "coordinate_pf",
    "bootstrap_pf",
    "resize_experiment",
    "crop_experiment",
]


def fused_pf_posterior(variant: str = "association"):
    """Posterior factory for the trackers: the fused render+score likelihood
    with the velocity-state prior (``pf_prior_nodes``). The factory is called
    as ``factory(params, experiment, device="cuda")``."""
    def factory(params, experiment, device="cuda"):
        exp = experiment.to(resolve_device(device))
        return fused_posterior(params, exp, variant, device=device,
                               prior_graph=pf_prior_nodes(params, exp))

    factory.fused = True
    return factory


def pf_prior_nodes(params, experiment):
    """Velocity-state prior nodes, on the device of ``experiment.prior_t``:
    t_dot, r_dot ~ N(0, proposal σ), t ~ N(prior_t, proposal σ_t),
    r ~ QuaternionNormal(prior_r, proposal σ_r[0]). There is no render node:
    the fused likelihood renders inside its kernel."""
    dev = experiment.prior_t.device
    sigma_t = sigma_row(params.proposal_sigma_t, dev)
    sigma_r = sigma_row(params.proposal_sigma_r, dev)
    zeros = torch.zeros(3, dtype=torch.float32, device=dev)
    return {
        "t_dot": BroadcastedNode("t_dot", Normal, zeros, sigma_t),
        "r_dot": BroadcastedNode("r_dot", Normal, zeros, sigma_r),
        "t": BroadcastedNode("t", Normal, experiment.prior_t, sigma_t),
        "r": BroadcastedNode("r", QuaternionNormal, experiment.prior_r.to(dev),
                             float(params.proposal_sigma_r[0])),
    }


def pf_prior(params, experiment, device="cuda"):
    """The velocity-state prior of ``pf_prior_nodes`` on ``device`` with the
    render node μ = render(t, r); the velocities are parents of μ only to join
    the graph. Returns the μ node."""
    dev = resolve_device(device)
    exp = experiment.to(dev)
    nodes = pf_prior_nodes(params, exp)
    render = partial(render_fn, render_context(params), render_scene(exp.scene, dev))
    return DeterministicNode("mu", lambda t, r, t_dot, r_dot: render(t, r),
                             nodes["t"], nodes["r"], nodes["t_dot"], nodes["r_dot"])


@dataclass(frozen=True, eq=False)
class Dynamics:
    """Decayed-velocity, constant-acceleration proposal for one variable;
    symmetric (transition probability 0).

    name 't': t' = t + t_dot + ½a,  t_dot' = decay·t_dot + a,  a = σ·ε
    name 'r': the tangent-space equivalent via ⊕.
    """

    name: str
    decay: float
    sigma: Any
    is_quaternion: bool = False

    @property
    def names(self):
        return (self.name, f"{self.name}_dot")

    @property
    def quaternion_names(self):
        return (self.name,) if self.is_quaternion else ()

    def apply(self, previous: Sample, normals) -> Sample:
        """The proposal for standard normals ``normals`` (the velocity's shape)."""
        x = previous.variables[self.name]
        v = previous.variables[f"{self.name}_dot"]
        acc = self.sigma * normals
        out = dict(previous.variables)
        out[self.name] = (quat.qplus(x, v + 0.5 * acc) if self.is_quaternion
                          else x + v + 0.5 * acc)
        out[f"{self.name}_dot"] = self.decay * v + acc
        return Sample(out)

    def propose(self, generator, previous: Sample) -> Sample:
        v = previous.variables[f"{self.name}_dot"]
        return self.apply(previous, torch.randn(v.shape, generator=generator, dtype=v.dtype,
                                                device=generator.device))

    def transition_probability(self, new, prev, batch_ndim=1):
        return 0.0


@dataclass(frozen=True, eq=False)
class JointDynamics:
    """Joint t and r dynamics: both blocks of ``Dynamics`` in one proposal."""

    sigma_t: Any
    sigma_r: Any
    decay: float = 0.9

    names = ("t", "r", "t_dot", "r_dot")
    quaternion_names = ("r",)

    def apply(self, previous: Sample, normals_t, normals_r) -> Sample:
        t, td = previous.variables["t"], previous.variables["t_dot"]
        r, rd = previous.variables["r"], previous.variables["r_dot"]
        acc_t = self.sigma_t * normals_t
        acc_r = self.sigma_r * normals_r
        out = dict(previous.variables)
        out["t_dot"] = self.decay * td + acc_t
        out["t"] = t + td + 0.5 * acc_t
        out["r_dot"] = self.decay * rd + acc_r
        out["r"] = quat.qplus(r, rd + 0.5 * acc_r)
        return Sample(out)

    def propose(self, generator, previous: Sample) -> Sample:
        td, rd = previous.variables["t_dot"], previous.variables["r_dot"]

        def randn(like):
            return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                               device=generator.device)

        return self.apply(previous, randn(td), randn(rd))

    def transition_probability(self, new, prev, batch_ndim=1):
        return 0.0


def _nearest(depth_img, rows, cols):
    return depth_img[rows[:, None], cols[None, :]]


def resize_experiment(experiment: Experiment, depth_img, width, height) -> Experiment:
    """The experiment with ``depth_img`` [h, w] resized to (height, width) by
    nearest-neighbour sampling, which keeps invalid pixels invalid."""
    h, w = depth_img.shape
    dev = depth_img.device
    vi = torch.arange(height, device=dev) * h // height
    ui = torch.arange(width, device=dev) * w // width
    return experiment.with_depth_image(_nearest(depth_img, vi, ui))


def crop_experiment(experiment: Experiment, depth_img, t, diameter, width, height) -> Experiment:
    """The experiment cropped around the estimate ``t`` and resized: the crop
    camera's pixel grid samples the source image at its nearest pixels."""
    cam = experiment.scene["camera"]
    ccam = crop_camera(cam, t, float(diameter), width=width, height=height)
    dev = depth_img.device
    u = (torch.arange(width, device=dev, dtype=torch.float32) - ccam.c_x) / ccam.f_x
    v = (torch.arange(height, device=dev, dtype=torch.float32) - ccam.c_y) / ccam.f_y
    src_u = torch.clamp((u * cam.f_x + cam.c_x).to(torch.int64), 0, depth_img.shape[1] - 1)
    src_v = torch.clamp((v * cam.f_y + cam.c_y).to(torch.int64), 0, depth_img.shape[0] - 1)
    return Experiment({**experiment.scene, "camera": ccam}, experiment.prior_o,
                      experiment.prior_t, experiment.prior_r, _nearest(depth_img, src_v, src_u))


def _pf_samplers(params, kind, device):
    sigma_t = sigma_row(params.proposal_sigma_t, device)
    sigma_r = sigma_row(params.proposal_sigma_r, device)

    def smc(kernel):
        return SequentialMonteCarlo(kernel, ConstantSchedule(), params.n_particles,
                                    math.log(params.relative_ess))

    if kind == "coordinate":
        t_kernel = BootstrapKernel(Dynamics("t", params.velocity_decay, sigma_t))
        r_kernel = BootstrapKernel(Dynamics("r", params.velocity_decay, sigma_r,
                                            is_quaternion=True))
        return CoordinateSampler((smc(t_kernel), smc(r_kernel)))
    return smc(BootstrapKernel(JointDynamics(sigma_t, sigma_r, params.velocity_decay)))


# likelihood evaluations of the whole population a frame, one a sampler block
_LIKELIHOODS_PER_FRAME = {"coordinate": 2, "bootstrap": 1}


# the captured filters, most recently used last: (factory, params, kind,
# collected variables, stream shape, device, experiment id) -> (experiment
# reference, runner, frame feed)
_PF_RUNNERS = collections.OrderedDict()
_PF_RUNNERS_KEPT = 4


def _pf_runner(posterior_fn, params, experiment, frame0, kind, collect_vars, dev):
    """The cached captured filter of one configuration and experiment, and
    the function that writes a frame into the observation its step reads."""
    key = (posterior_fn, params, kind, tuple(collect_vars), tuple(frame0.shape), dev,
           id(experiment))
    hit = _PF_RUNNERS.get(key)
    if hit is not None and hit[0]() is experiment:
        _PF_RUNNERS.move_to_end(key)
        return hit[1], hit[2]
    exp = experiment.to(dev)  # moved once: a frame step copies nothing from the host
    if getattr(posterior_fn, "fused", False):
        post = posterior_fn(params, exp.with_depth_image(frame0), device=dev)
        feed = post.with_observation

        def build():
            return post
    else:
        prior = pf_prior(params, exp, dev)
        obs = torch.empty_like(frame0)
        feed = obs.copy_

        def build():
            return posterior_fn(params, exp.with_depth_image(obs), prior)
    runner = ChainRunner(_pf_samplers(params, kind, dev), build, dev, params.n_particles,
                         collect_vars)
    _PF_RUNNERS[key] = (weakref.ref(experiment), runner, feed)
    while len(_PF_RUNNERS) > _PF_RUNNERS_KEPT:
        _PF_RUNNERS.popitem(last=False)
    return runner, feed


def _run_pf(seed, posterior_fn, params, experiment, depth_imgs, kind, collect_vars, device,
            captured=True):
    """Init on frame 0, then one sampler step per remaining frame.

    ``depth_imgs``: [F, H, W] at render size — a float32 tensor on ``device``
    with invalid pixels +inf (``convert.stream_from_numpy``), or a host array
    with invalid pixels <= 0, which is uploaded and converted once. While
    telemetry is on, a captured run is the span ``pf.run``, with the cached
    filter's lookup or build ``pf.runner`` inside, and counts, by filter
    kind, ``("pf", kind, "runs")``, the frames it steps (``"frames"``) and
    the poses it scores (``"poses_scored"``: frames × particles × the
    kind's likelihood evaluations a frame), all known on the host."""
    dev = resolve_device(device)
    if not isinstance(depth_imgs, torch.Tensor):
        depth_imgs = stream_from_numpy(depth_imgs, dev)
    if depth_imgs.device.type != dev.type:
        raise ValueError(f"depth_imgs is on {depth_imgs.device}, filter asked for {dev}")
    depth_imgs = depth_imgs.to(torch.float32).contiguous()
    if captured:
        with span("pf.run"):
            if telemetry.ON:
                frames = depth_imgs.shape[0] - 1
                count(("pf", kind, "runs"))
                count(("pf", kind, "frames"), frames)
                count(("pf", kind, "poses_scored"),
                      frames * params.n_particles * _LIKELIHOODS_PER_FRAME[kind])
            with span("pf.runner"):
                runner, feed = _pf_runner(posterior_fn, params, experiment, depth_imgs[0],
                                          kind, collect_vars, dev)
            feed(depth_imgs[0])
            return runner.run(seed, depth_imgs.shape[0],
                              before_step=lambda i: feed(depth_imgs[i + 1]))
    sampler = _pf_samplers(params, kind, dev)
    rngs = Rngs.from_seed(seed, dev)
    if getattr(posterior_fn, "fused", False):
        first = posterior_fn(params, experiment.with_depth_image(depth_imgs[0]), device=dev)

        def model_for(depth_img):
            return first.with_observation(depth_img)
    else:
        prior = pf_prior(params, experiment, dev)

        def model_for(depth_img):
            return posterior_fn(params, experiment.with_depth_image(depth_img), prior)
    _, state = sampler.init(rngs, model_for(depth_imgs[0]), params.n_particles)
    outs = []
    for depth_img in depth_imgs[1:]:
        _, state = sampler.step(rngs, model_for(depth_img), state)
        outs.append(collect_variables(state, collect_vars))
    keys = outs[0].keys() if outs else ()
    return {k: torch.stack([o[k] for o in outs]) for k in keys}, state


def coordinate_pf(seed, posterior_fn, params, experiment, depth_imgs,
                  collect_vars=("t", "r"), device="cuda", captured=True):
    """Block-wise (t, then r) bootstrap particle filter over a depth stream:
    two likelihood evaluations per frame. ``posterior_fn``: a
    ``fused_pf_posterior`` factory, or a graph factory of
    ``models.experiment_models`` (given ``pf_prior``). Returns (outs, final)
    with ``outs`` stacked over the F-1 tracked frames as
    ``collect_variables`` gives them. ``captured=False``: the eager frame
    loop."""
    return _run_pf(seed, posterior_fn, params, experiment, depth_imgs, "coordinate",
                   collect_vars, device, captured)


def bootstrap_pf(seed, posterior_fn, params, experiment, depth_imgs,
                 collect_vars=("t", "r"), device="cuda", captured=True):
    """Joint-dynamics bootstrap particle filter over a depth stream: one
    likelihood evaluation per frame. Returns (outs, final) as ``coordinate_pf``."""
    return _run_pf(seed, posterior_fn, params, experiment, depth_imgs, "bootstrap",
                   collect_vars, device, captured)
