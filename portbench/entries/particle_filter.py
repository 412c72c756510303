"""Tracking through the port's captured particle filter: for each request
(a clip of depth frames), the stream's upload (``convert.stream_from_numpy``),
one ``models.particle_filter.coordinate_pf`` (or ``bootstrap_pf``) call on
the tracker's inputs as the tracking script builds them, and the estimate of
every tracked frame on the host: the weighted mean translation and the
chordal mean rotation, as the tracking script takes them."""

from __future__ import annotations

import importlib

import numpy as np
import torch

from bayesianposeestimation.jl_tpu_torch import convert
from bayesianposeestimation.jl_tpu_torch.camera import CvCamera
from bayesianposeestimation.jl_tpu_torch.models.particle_filter import (
    bootstrap_pf,
    coordinate_pf,
    fused_pf_posterior,
)
from bayesianposeestimation.jl_tpu_torch.parameters import Parameters

from ..reference import raster
from .common import Reservoir, Spans, load_mesh, request_seed

KIND = "track"
FILTERS = {"coordinate": coordinate_pf, "bootstrap": bootstrap_pf}


def pose_estimates(outs):
    """Per frame: the weighted-mean translation and the chordal-mean rotation
    (principal eigenvector of Σ w q qᵀ, sign-invariant), as host arrays."""
    w = np.exp(outs["log_weights"].cpu().numpy().astype(np.float64))
    est_t = np.einsum("fn,fnd->fd", w, outs["t"].cpu().numpy())
    qs = outs["r"].cpu().numpy()
    _, eigvecs = np.linalg.eigh(np.einsum("fn,fni,fnj->fij", w, qs, qs))
    est_q = eigvecs[:, :, -1]
    est_q *= np.where(est_q[:, :1] < 0, -1.0, 1.0)
    return est_t, est_q


class Entry:
    check_kind = "track"

    def __init__(self, cell, config, seed, device):
        self.cell, self.config, self.seed, self.device = cell, config, seed, device
        tr = cell["traffic"]
        self.params = Parameters(width=tr["width"], height=tr["height"],
                                 n_particles=int(config["n_particles"]),
                                 device=torch.device(device).type,
                                 **{k: tuple(v) if isinstance(v, list) else v
                                    for k, v in config["parameters"].items()})
        self.filter = FILTERS[config["filter"]]
        self.spans = Spans()
        self.check = Reservoir(int(cell["check"]["requests"]), seed)
        self.frames_checked = int(cell["check"]["frames"])
        self.traced = []

    def setup(self):
        tr = self.cell["traffic"]
        _, full = load_mesh(self.config["stream_mesh"], self.device)
        gen = importlib.import_module(f"portbench.traffic.{tr['generator']}")
        self.clips, gt_t, gt_q, cam = gen.load(tr, full, self.seed, self.device)
        host, self.mesh = load_mesh(self.config["mesh"], self.device)
        self.camera = CvCamera(width=cam["width"], height=cam["height"], f_x=cam["f_x"],
                               f_y=cam["f_y"], c_x=cam["c_x"], c_y=cam["c_y"],
                               near=cam["near"], far=cam["far"])
        self.cam_fields = cam
        p = self.params
        # one experiment serves every clip: the priors are the orbit's first pose
        self.experiment = convert.experiment_from_numpy(
            self.camera, host[0], host[1], p.o_mask_is, gt_t[0], self.clips[0][0],
            prior_r=gt_q[0])
        self.posterior_fn = fused_pf_posterior(self.config["variant"])
        self._serve(self.clips[0], request_seed(self.seed, 0, warm_up=True))  # warm-up: the capture
        self.spans.seconds.clear()

    def _serve(self, clip, seed):
        spans = self.spans
        with spans("upload"):
            depth = convert.stream_from_numpy(clip, self.device)
        with spans("filter"):
            outs, _ = self.filter(seed, self.posterior_fn, self.params, self.experiment, depth,
                                  device=self.device)
        with spans("estimate"):
            est_t, est_q = pose_estimates(outs)
        return outs, est_t, est_q

    def run(self, i, traced=False):
        """Serve clip request ``i``; returns (frames estimated, whether it succeeded)."""
        c = i % len(self.clips)
        outs, est_t, est_q = self._serve(self.clips[c], request_seed(self.seed, i))
        ok = bool(np.isfinite(est_t).all() and np.isfinite(est_q).all())
        if traced:
            self.traced.append((outs["t"], outs["r"]))
        if ok:
            self.check.offer(lambda: self._records(i, c, outs, est_t, est_q))
        return est_t.shape[0], ok

    def _records(self, i, c, outs, est_t, est_q):
        n = est_t.shape[0]
        rng = np.random.default_rng([self.seed, 11, i])
        frames = sorted({n - 1, *rng.choice(n - 1, self.frames_checked - 1, replace=False)})
        return [dict(mesh=0, obs=self.clips[c][f + 1],
                     population={k: outs[k][f] for k in ("t", "r", "log_like", "log_weights")},
                     estimate=(est_t[f], est_q[f])) for f in frames]

    def records(self):
        return [r for clip in self.check.items for r in clip]

    def meshes(self):
        return {0: self.mesh}

    def units_per_request(self):
        return self.clips.shape[1] - 1

    def check_config(self):
        cam = self.cam_fields
        return dict(self.config["parameters"], o_prior=self.config["parameters"]["o_mask_is"],
                    camera=raster.camera_scalars(cam["f_x"], cam["f_y"], cam["c_x"], cam["c_y"],
                                                 0.0, cam["width"], cam["height"], cam["near"],
                                                 cam["far"]))

    def roofline_inputs(self):
        for ts, rs in self.traced:
            yield self.mesh, self.cam_fields, ts, rs, self.config["epilogue"]

    def launches_per_unit(self):
        return 2 if self.config["filter"] == "coordinate" else 1

    def free(self):
        self.experiment = None
