"""Fused posterior: the likelihood is one render+score kernel launch.

Counterpart of ``jl_tpu/models/fused.py`` (``make_score_fn`` for all eight
variants, ``make_hyper_score_fn``, ``FusedPosterior``, ``fused_posterior``,
``make_conditioned_chain``, ``make_tuned_chain``). The kernel returns the
per-pose pixel sums (ℓ, Σo); the regularizer applies outside:

* ImageLikelihoodNormalizer:  ℓ_reg = c_reg / Σo · ℓ
* SimpleImageRegularization:  ℓ_reg = c_reg / n_pix · ℓ   (``_SIMPLE_REG``)

The faces go to the kernel in their original order. The mesh is uploaded
and its face indices checked once (``ops.cuda_raster.mesh_tensors``), so building a
posterior per image makes no device-to-host copy.

The per-image runners compile once, as the JAX package's ``jax.jit`` does:
a runner holds one posterior whose observation, prior image, position
prior, crop camera (a device row the kernel reads) and, when tuned, the
likelihood, prior and proposal sigmas are static device buffers, and one
``capture.ChainRunner`` over it. A call copies its inputs into the buffers,
reseeds and replays the captured steps; the schedule reads the call's step
count from the device (``tempering.StepCount``), so one capture serves
every image, camera, candidate and step count.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from ..capture import ChainRunner
from ..convert import image_from_numpy
from ..devices import resolve_device
from ..distributions import Normal, QuaternionUniform
from ..graph import (
    BroadcastedNode,
    bijectors_of,
    logdensityof_graph,
    quaternion_names_of,
    sample_graph,
)
from ..models import pixel as P
from ..ops.cuda_raster import CAMERA_ROW, camera_row, check_faces, mesh_tensors, render_score
from ..parameters import Experiment, sigma_row
from ..posterior import tempered_logdensity
from ..samplers.chain import sample_chain
from ..samples import Sample
from ..telemetry import count, span
from ..tempering import StepCount

__all__ = ["make_score_fn", "make_hyper_score_fn", "FusedPosterior",
           "fused_posterior", "make_conditioned_chain", "make_tuned_chain"]


def make_hyper_score_fn(params, variant: str):
    """Score fn with run-time likelihood scalars: (μ, z, prior_o, hyper) ->
    (ℓ_px, o), where hyper[0] = pixel_sigma and hyper[1] = association_sigma
    (the values of ``params`` for them are ignored)."""
    def fn(mu, z, prior_o, hyper):
        p2 = params.replace(pixel_sigma=hyper[0], association_sigma=hyper[1])
        return make_score_fn(p2, variant)(mu, z, prior_o)

    return fn


def make_score_fn(params, variant: str):
    """Elementwise (μ, z, prior_o) -> (ℓ_px, o) for the kernel epilogue:
    simple / smooth_simple (fixed o = prior), association /
    association_simple_reg, smooth / smooth_simple_reg, no_exp (uniform
    tail, fixed o) and no_exp_association."""
    min_d, max_d = params.min_depth, params.max_depth
    theta, sigma = params.pixel_theta, params.pixel_sigma

    if variant in ("simple", "smooth_simple"):
        def fn(mu, z, prior_o):
            return P.pixel_mixture(min_d, max_d, theta, sigma, mu, prior_o).logpdf(z), prior_o

        return fn

    if variant in ("association", "association_simple_reg"):
        o_fn = P.pixel_association_fn(params)

        def fn(mu, z, prior_o):
            o = o_fn(prior_o, mu, z)
            return P.pixel_mixture(min_d, max_d, theta, sigma, mu, o).logpdf(z), o

        return fn

    if variant in ("smooth", "smooth_simple_reg"):
        o_fn = P.smooth_association_fn(params)

        def fn(mu, z, prior_o):
            o = o_fn(prior_o, mu, z)
            return P.smooth_mixture(min_d, max_d, theta, sigma, mu, o).logpdf(z), o

        return fn

    if variant == "no_exp":
        def fn(mu, z, prior_o):
            return P.uniform_pixel_mixture(min_d, max_d, sigma, mu, prior_o).logpdf(z), prior_o

        return fn

    if variant == "no_exp_association":
        o_fn = P.uniform_association_fn(params)

        def fn(mu, z, prior_o):
            o = o_fn(prior_o, mu, z)
            return P.uniform_pixel_mixture(min_d, max_d, sigma, mu, o).logpdf(z), o

        return fn

    raise ValueError(f"unknown score variant {variant!r}")


_SIMPLE_REG = ("simple", "association_simple_reg", "smooth_simple_reg",
               "smooth_simple", "no_exp", "no_exp_association")


class FusedPosterior:
    """Posterior over t [N, 3] and r [N, 4] with the point prior
    t ~ N(prior_t, σ_t), r ~ QuaternionUniform, and the fused likelihood.

    ``prior_graph``: a dict of ``BroadcastedNode``s on ``device`` in place
    of the point prior (the particle filter's velocity-state prior,
    ``models.particle_filter.pf_prior_nodes``); the likelihood still reads
    only ``t`` and ``r``.

    ``hyper``: None, or a float32 [2] tensor on ``device`` holding
    [pixel_sigma, association_sigma], which the kernel then reads at run time
    in place of the ``params`` values. ``cam_row``: None, or the camera's
    ``ops.cuda_raster.camera_row`` as an f32 [7] tensor on ``device``, read
    at run time in place of the camera's intrinsics (its size stays the
    image's). Faces made by ``mesh_tensors`` (as ``fused_posterior`` and the
    chain runners pass them) are not checked again; any other faces are
    checked here, on the host."""

    def __init__(self, params, experiment, variant: str = "association",
                 backface_cull: bool = True, device="cuda", hyper=None, prior_graph=None,
                 cam_row=None):
        make_score_fn(params, variant)  # rejects unknown variants up front
        self.device = resolve_device(device)
        self.params = params
        self.variant = variant
        self.backface_cull = backface_cull
        self.hyper = hyper
        self.cam_row = cam_row
        self.simple_reg = variant in _SIMPLE_REG
        exp = experiment.to(self.device)
        self.experiment = exp
        self.verts = exp.scene["verts"].to(torch.float32).contiguous()
        self.faces = exp.scene["faces"].to(torch.int32).contiguous()
        check_faces(self.faces, self.verts.shape[0])
        self.camera = exp.scene["camera"]
        self.depth = exp.depth_image.to(torch.float32).contiguous()
        self.prior_o = torch.as_tensor(exp.prior_o, dtype=torch.float32, device=self.device) \
            .expand(params.height, params.width).contiguous()
        # the point prior's mean and sigma where the MH move's kernel
        # (ops/mh_move.py) computes this posterior's densities as the plain
        # code does: the npixel likelihood with a host c_reg, fp32 rows of 3
        # (or one) on the device; else None, and every move runs plain
        self.move_prior = None
        if prior_graph is None:
            sigma_t = sigma_row(params.sigma_t, self.device)
            prior_graph = {
                "t": BroadcastedNode("t", Normal, exp.prior_t, sigma_t),
                "r": BroadcastedNode("r", QuaternionUniform),
            }
            rows = (exp.prior_t, sigma_t)
            if (not self.simple_reg and isinstance(params.c_reg, numbers.Real)
                    and all(isinstance(x, torch.Tensor) and x.dtype == torch.float32
                            and x.device.type == self.device.type
                            and x.shape in ((3,), ()) and x.is_contiguous() for x in rows)):
                self.move_prior = rows
        self.graph = prior_graph
        self.bijectors = bijectors_of(self.graph)
        self.quaternion_names = quaternion_names_of(self.graph)

    def with_observation(self, depth) -> "FusedPosterior":
        """This posterior conditioned on another observation, in place:
        ``depth`` [H, W] f32 on this posterior's device with invalid pixels
        already +inf (a frame of a stream prepared by
        ``convert.stream_from_numpy``) is copied into the posterior's own
        observation buffer, which a captured step reads; returns ``self``.
        Nothing is copied or checked on the host."""
        self.depth.copy_(depth)
        return self

    def sample_prior(self, generator, n_particles: int) -> Sample:
        return Sample(sample_graph(self.graph, generator, (n_particles,)))

    def render(self, sample: Sample, batch_ndim: int = 1):
        """(ℓ, Σo): the kernel's per-pose pixel sums before the regularizer,
        each of the poses' batch shape: the leading dims of t [..., 3]
        (``batch_ndim`` of them, e.g. [tries, chains]), flattened into one
        kernel launch and shaped back. Counts one evaluation."""
        t = sample.variables["t"]
        r = sample.variables["r"]
        batch = t.shape[:-1]
        if len(batch) != batch_ndim:
            raise ValueError(f"t has {len(batch)} batch dims, expected {batch_ndim}")
        count(("evaluation", self.device.type))
        ell_raw, sum_o = render_score(
            self.verts, self.faces, self.camera, t.reshape(-1, 3).contiguous(),
            r.reshape(-1, 4).contiguous(), self.depth, self.prior_o, self.params,
            self.variant, self.backface_cull, hyper=self.hyper, device=self.device,
            cam_row=self.cam_row)
        return ell_raw.reshape(batch), sum_o.reshape(batch)

    def prior_and_likelihood(self, sample: Sample, batch_ndim: int = 1):
        """(log prior, log likelihood), each of the poses' batch shape
        (``render``)."""
        ell_raw, sum_o = self.render(sample, batch_ndim)
        if self.simple_reg:
            ell_like = P.simple_image_regularization(
                self.params.c_reg, ell_raw, self.params.width * self.params.height)
        else:
            ell_like = P.logdensity_npixel(ell_raw, self.params.c_reg, sum_o)
        return logdensityof_graph(self.graph, sample.variables, batch_ndim), ell_like

    def logdensity_sample(self, sample: Sample, batch_ndim: int = 1) -> Sample:
        lp, ll = self.prior_and_likelihood(sample, batch_ndim)
        return sample.set_logdensities(lp + ll, ll)

    def tempered_logdensity_sample(self, sample: Sample, temp, batch_ndim: int = 1) -> Sample:
        lp, ll = self.prior_and_likelihood(sample, batch_ndim)
        return sample.set_logdensities(tempered_logdensity(lp, ll, temp), ll)


def fused_posterior(params, experiment, variant: str = "association",
                    backface_cull: bool = True, device="cuda", hyper=None,
                    prior_graph=None) -> FusedPosterior:
    """The fused posterior of ``experiment`` on ``device``."""
    verts, faces = mesh_tensors(experiment.scene["verts"], experiment.scene["faces"], device)
    exp = Experiment({**experiment.scene, "verts": verts, "faces": faces},
                     experiment.prior_o, experiment.prior_t, experiment.prior_r,
                     experiment.depth_image)
    return FusedPosterior(params, exp, variant, backface_cull, device, hyper, prior_graph)


# the per-call scalars of an image runner, in one device vector: the camera
# row, the position prior, [pixel_sigma, association_sigma], sigma_t and
# proposal_sigma_r
_ROW_FIELDS = (("camera", len(CAMERA_ROW)), ("prior_t", 3), ("hyper", 2), ("sigma_t", 3),
               ("proposal_sigma_r", 3))


class _ImageRunner:
    """One mesh's chain on per-image inputs in static device buffers: the
    posterior and sampler are built once, at the first call, and each call
    copies its inputs in and runs the captured chain (``tuned``: the
    likelihood sigmas, sigma_t and proposal_sigma_r come from the call).
    While telemetry is on, a call is the span ``image.call``, the copy-in
    ``image.load`` and the first call's build ``image.build``."""

    def __init__(self, params, verts_t, faces_t, variant, sampler_factory, n_steps,
                 collect_vars, n_chains, device, tuned):
        self.params, self.verts, self.faces = params, verts_t, faces_t
        self.variant, self.factory, self.n_steps = variant, sampler_factory, n_steps
        self.collect_vars, self.n_chains, self.device = collect_vars, n_chains, device
        self.tuned = tuned
        self.posterior = self.chain = None
        self.step_count = StepCount(device, params.n_steps)
        self.vector = torch.zeros(sum(n for _, n in _ROW_FIELDS), dtype=torch.float32,
                                  device=device)
        self.rows, start = {}, 0
        for name, n in _ROW_FIELDS:
            self.rows[name] = self.vector[start:start + n]
            start += n

    def _build(self, camera):
        rows = self.rows
        p = self.params.replace(n_steps=self.step_count)
        if self.tuned:
            p = p.replace(sigma_t=rows["sigma_t"], proposal_sigma_r=rows["proposal_sigma_r"])
        h, w = self.params.height, self.params.width
        exp = Experiment(scene={"camera": camera, "verts": self.verts, "faces": self.faces},
                         prior_o=torch.zeros((h, w), dtype=torch.float32, device=self.device),
                         prior_t=rows["prior_t"],
                         depth_image=torch.zeros((h, w), dtype=torch.float32,
                                                 device=self.device))
        post = FusedPosterior(p, exp, self.variant, device=self.device,
                              hyper=rows["hyper"] if self.tuned else None,
                              cam_row=rows["camera"])
        self.posterior = post
        self.chain = ChainRunner(self.factory(p, post), lambda: post, self.device,
                                 self.n_chains, self.collect_vars)

    def _load(self, camera, depth_img, prior_o, prior_t, hyper):
        """Copy one call's inputs into the static buffers."""
        h, w = self.params.height, self.params.width
        if (camera.width, camera.height) != (w, h):
            raise ValueError(f"the camera is {camera.width}x{camera.height}, the runner "
                             f"renders {w}x{h}")
        if self.posterior is None:
            with span("image.build"):
                self._build(camera)
        post = self.posterior
        post.camera = camera  # the kernel reads the row; the host copy is for the reader
        host = {"camera": camera_row(camera),
                "prior_t": torch.as_tensor(prior_t, dtype=torch.float32).cpu().numpy(),
                "hyper": np.zeros(2), "sigma_t": np.zeros(3), "proposal_sigma_r": np.zeros(3)}
        if self.tuned:
            host.update(hyper=[hyper["pixel_sigma"], hyper["association_sigma"]],
                        sigma_t=hyper["sigma_t"], proposal_sigma_r=hyper["proposal_sigma_r"])
        self.vector.copy_(torch.from_numpy(np.concatenate(
            [np.ravel(np.asarray(host[name], np.float32)) for name, _ in _ROW_FIELDS])))
        depth = torch.as_tensor(depth_img, dtype=torch.float32).to(self.device)
        post.depth.copy_(torch.where(depth <= 0, torch.full_like(depth, torch.inf), depth))
        if np.ndim(prior_o) == 0:
            post.prior_o.fill_(float(prior_o))
        else:
            post.prior_o.copy_(torch.as_tensor(prior_o, dtype=torch.float32).to(self.device)
                               .expand(h, w))

    def __call__(self, seed, camera, depth_img, prior_o, prior_t, hyper=None, n_steps=None):
        with span("image.call"):
            with span("image.load"):
                self._load(camera, depth_img, prior_o, prior_t, hyper)
            self.step_count.set(self.params.n_steps if n_steps is None else n_steps)
            return self.chain.run(seed, self.n_steps if n_steps is None else int(n_steps))


def _eager_image_chain(params, verts_t, faces_t, variant, sampler_factory, n_steps,
                       collect_vars, n_chains, dev, seed, camera, depth_img, prior_o, prior_t,
                       hyper):
    """One call of an image runner as an eager chain: the posterior and the
    sampler built for the call, host sigmas in ``params``, the eager loop."""
    p, row = params, None
    if hyper is not None:
        p = p.replace(
            sigma_t=tuple(float(s) for s in np.ravel(hyper["sigma_t"])),
            proposal_sigma_r=tuple(float(s) for s in np.ravel(hyper["proposal_sigma_r"])))
        row = torch.stack([torch.as_tensor(hyper[k], dtype=torch.float32).to(dev).reshape(())
                           for k in ("pixel_sigma", "association_sigma")])
    depth, prior_o, prior_t = image_from_numpy(depth_img, prior_o, prior_t, dev)
    exp = Experiment(scene={"camera": camera, "verts": verts_t, "faces": faces_t},
                     prior_o=prior_o, prior_t=prior_t, depth_image=depth)
    posterior = FusedPosterior(p, exp, variant, device=dev, hyper=row)
    sampler = sampler_factory(p, posterior)
    return sample_chain(seed, posterior, sampler, n_steps, n_chains, collect_vars, device=dev,
                        captured=False)


def make_conditioned_chain(params, verts, faces, variant, sampler_factory, n_steps,
                           collect_vars=("t", "r"), n_chains=None, device="cuda",
                           captured=True):
    """Chain runner for one mesh, conditioned on per-image data.

    Returns ``run(seed, camera, depth_img, prior_o, prior_t, hyper=None,
    n_steps=None) -> (outs, final)``: the crop camera (of the params' size),
    observation [H, W] (<= 0 invalid), segmentation prior (float or [H, W])
    and position prior [3] change per call; the mesh is uploaded and checked
    once, here. The posterior and ``sampler_factory(params, posterior)`` are
    built once, on static buffers that each call refills, and each call runs
    the chain for ``n_steps`` (init + n_steps - 1 steps, outputs stacked)
    with ``n_chains`` (default ``params.n_particles``) chains through one
    ``capture.ChainRunner``: on the card its steps are captured at the first
    call and replayed after. A call's ``n_steps`` sets both its length and
    the step count its schedule reads (by default the runner's ``n_steps``
    and ``params.n_steps``), without a new capture.
    ``hyper`` tunes the call as ``make_tuned_chain`` describes (a second
    posterior and capture). ``captured=False`` builds the posterior and
    sampler per call and runs the eager loop."""
    dev = resolve_device(device)
    verts_t, faces_t = mesh_tensors(verts, faces, dev)
    n = params.n_particles if n_chains is None else n_chains
    runners = {}

    default_steps = n_steps

    def run(seed, camera, depth_img, prior_o, prior_t, hyper=None, n_steps=None):
        if not captured:
            p = params if n_steps is None else params.replace(n_steps=int(n_steps))
            return _eager_image_chain(p, verts_t, faces_t, variant, sampler_factory,
                                      default_steps if n_steps is None else int(n_steps),
                                      collect_vars, n, dev, seed, camera, depth_img, prior_o,
                                      prior_t, hyper)
        tuned = hyper is not None
        if tuned not in runners:
            runners[tuned] = _ImageRunner(params, verts_t, faces_t, variant, sampler_factory,
                                          default_steps, collect_vars, n, dev, tuned)
        return runners[tuned](seed, camera, depth_img, prior_o, prior_t, hyper, n_steps)

    run.runners = runners
    return run


def make_tuned_chain(params, verts, faces, variant, sampler_factory, n_steps,
                     collect_vars=("t", "r"), n_chains=None, device="cuda", captured=True):
    """Like ``make_conditioned_chain``, with tuned hyperparameters per call:
    ``run(seed, camera, depth_img, prior_o, prior_t, hyper, n_steps=None) ->
    (outs, final)``, ``hyper`` = dict(pixel_sigma=s, association_sigma=s,
    sigma_t=[3], proposal_sigma_r=[3]). The two likelihood sigmas reach the
    kernel as a device row, and sigma_t and proposal_sigma_r are device rows
    that the prior and the proposals read, as the JAX package traces them:
    every candidate runs through one capture."""
    run = make_conditioned_chain(params, verts, faces, variant, sampler_factory, n_steps,
                                 collect_vars, n_chains, device, captured)

    def tuned(seed, camera, depth_img, prior_o, prior_t, hyper, n_steps=None):
        return run(seed, camera, depth_img, prior_o, prior_t, hyper, n_steps)

    tuned.runners = run.runners
    return tuned
