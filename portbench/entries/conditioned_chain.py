"""BOP pose estimation through the port's per-image runner: for each
request, the host prep (``camera.crop_camera``, ``camera.crop_image``,
``models.experiment_models.point_from_segmentation``), one
``models.fused.make_conditioned_chain(..., captured=True)`` runner call per
object (the configuration's sampler and posterior for its fixed step
count), and the estimate, read back to the host as the BOP validation
script takes it: by the configuration's ``estimate``, the final
population's particle of highest log-likelihood (``final_best``, SMC, one
chain per particle) or the one chain's sample of highest log-likelihood
over all its steps (``chain_best``, the MCMC baselines). Each estimate has
its check kind (``ESTIMATES``)."""

from __future__ import annotations

import importlib

import numpy as np
import torch

from bayesianposeestimation.jl_tpu_torch.camera import CvCamera, crop_camera, crop_image
from bayesianposeestimation.jl_tpu_torch.models import experiment_samplers
from bayesianposeestimation.jl_tpu_torch.models.experiment_models import point_from_segmentation
from bayesianposeestimation.jl_tpu_torch.models.fused import make_conditioned_chain
from bayesianposeestimation.jl_tpu_torch.parameters import Parameters

from .common import PORTBENCH, Reservoir, Spans, load_mesh, request_seed

KIND = "pose"  # the per-layer metrics' suffix
ESTIMATES = {"final_best": "bop", "chain_best": "mcmc"}  # estimate -> check kind
NEAR, FAR = 0.01, 10.0  # the full camera's clip depths, as the BOP reader sets them


class Entry:
    def __init__(self, cell, config, seed, device):
        self.cell, self.config, self.seed, self.device = cell, config, seed, device
        traffic = cell["traffic"]
        self.size = int(traffic["resolution"])
        self.n_particles = int(traffic["n_particles"])
        self.n_steps = int(config["n_steps"])
        self.estimate = config.get("estimate", "final_best")
        self.check_kind = ESTIMATES[self.estimate]
        # as the BOP script decides both: the MCMC baselines run one chain
        self.n_chains = 1 if self.estimate == "chain_best" else self.n_particles
        self.params = Parameters(width=self.size, height=self.size,
                                 n_particles=self.n_particles, n_steps=self.n_steps,
                                 device=torch.device(device).type,
                                 **{k: tuple(v) if isinstance(v, list) else v
                                    for k, v in config["parameters"].items()})
        self.spans = Spans()
        self.check = Reservoir(int(cell["check"]["requests"]), seed)
        self.traced = []

    # -- set-up ---------------------------------------------------------------

    def setup(self):
        repo = PORTBENCH.parent
        traffic = self.cell["traffic"]
        gen = importlib.import_module(f"portbench.traffic.{traffic['generator']}")
        self.items = gen.load(traffic, repo, self.seed)
        for it in self.items:
            K = it["K"]
            h, w = it["depth"].shape
            it["camera"] = CvCamera(width=w, height=h, f_x=K[0, 0], f_y=K[1, 1], c_x=K[0, 2],
                                    c_y=K[1, 2], s=K[0, 1], near=NEAR, far=FAR)
        budget = 2 * self.size * self.size  # the triangle budget of the crop
        factory = getattr(experiment_samplers, self.config["sampler"])
        self.meshes_dev, self.runners = {}, {}
        for obj in sorted({it["obj_id"] for it in self.items}):
            host, dev = load_mesh(self.config["meshes"][str(budget)][str(obj)], self.device)
            self.meshes_dev[obj] = dev
            self.runners[obj] = make_conditioned_chain(
                self.params, host[0], host[1], self.config["variant"], factory, self.n_steps,
                n_chains=self.n_chains, device=self.device, captured=True)
        # warm-up: one request of each object captures its runner's steps
        for obj in self.runners:
            item = next(it for it in self.items if it["obj_id"] == obj)
            self._serve(item, request_seed(self.seed, obj, warm_up=True))
        self.spans.seconds.clear()

    # -- one request ------------------------------------------------------------

    def _serve(self, it, seed):
        p, spans = self.params, self.spans
        with spans("prep"):
            ys, xs = np.nonzero(it["mask"])
            bbox = (xs.min(), xs.max(), ys.min(), ys.max()) if xs.size else (0, 1, 0, 1)
            prior_t = point_from_segmentation(bbox, it["depth"], it["mask"], it["camera"],
                                              diameter=it["diameter"])
            cam = crop_camera(it["camera"], prior_t, it["diameter"], width=p.width,
                              height=p.height)
            obs = crop_image(it["depth"], it["camera"], cam)
            prior_o = np.asarray(np.where(crop_image(it["mask"], it["camera"], cam),
                                          p.o_mask_is, p.o_mask_not), np.float32)
        with spans("chain"):
            outs, _ = self.runners[it["obj_id"]](seed, cam, obs, prior_o, prior_t,
                                                 n_steps=self.n_steps)
        with spans("estimate"):
            ll_all = outs["log_like"].cpu().numpy()  # [steps, chains]
            if self.estimate == "chain_best":  # pick: the flat (step, chain) index
                pick = int(np.argmax(ll_all))
                step, chain = divmod(pick, ll_all.shape[1])
            else:  # pick: the particle of the final step
                pick = int(np.argmax(ll_all[-1]))
                step, chain = ll_all.shape[0] - 1, pick
            t = outs["t"][step, chain].cpu().numpy()
            q = outs["r"][step, chain].cpu().numpy()
        return (cam, obs, prior_o, prior_t), outs, pick, (t, q)

    def run(self, i, traced=False):
        """Serve request ``i``; returns (poses estimated, whether it succeeded)."""
        it = self.items[i % len(self.items)]
        prep, outs, pick, (t, q) = self._serve(it, request_seed(self.seed, i))
        ok = bool(np.isfinite(t).all() and np.isfinite(q).all())
        if traced:
            self.traced.append((it["obj_id"], prep[0], outs["t"], outs["r"]))
        if ok:
            self.check.offer(lambda: self._record(it, prep, outs, pick, t, q))
        return 1, ok

    def _record(self, it, prep, outs, pick, t, q):
        cam, obs, prior_o, prior_t = prep
        rec = dict(
            depth=it["depth"], mask=it["mask"], K=it["K"], diameter=it["diameter"],
            mesh=it["obj_id"], n_rows=int(outs["t"].shape[0]),
            prep=dict(cam={k: float(getattr(cam, k)) for k in ("f_x", "f_y", "c_x", "c_y", "s")},
                      obs=np.asarray(obs), prior_o=prior_o, point=np.asarray(prior_t)),
            pick=pick, estimate=(torch.as_tensor(t), torch.as_tensor(q)))
        if self.estimate == "chain_best":  # the whole chain, kept on the host
            rec["chain"] = {k: outs[k].cpu() for k in ("t", "r", "log_prob", "log_like")}
            return rec

        def pop(k):
            return {name: outs[key][k] for name, key in
                    (("t", "t"), ("r", "r"), ("log_like", "log_like"),
                     ("log_weights", "log_weights"))}

        rec.update(populations={"prev": pop(-2), "final": pop(-1)},
                   temperatures=outs["temperature"][-2:].cpu().numpy())
        return rec

    # -- what the check and the trace read ----------------------------------------

    def units_per_request(self):
        return self.n_steps - 1  # steps a request replays

    def check_config(self):
        """The configuration as the reference reads it: the stated values."""
        return dict(self.config["parameters"], width=self.size, height=self.size, near=NEAR,
                    far=FAR, n_steps=self.n_steps, epilogue=self.config["epilogue"])

    def roofline_inputs(self):
        """Per traced request: (mesh, crop camera fields, t [S, N, 3], r [S, N, 4])."""
        for obj, cam, ts, rs in self.traced:
            yield (self.meshes_dev[obj],
                   dict(f_x=cam.f_x, f_y=cam.f_y, c_x=cam.c_x, c_y=cam.c_y, s=cam.s,
                        width=cam.width, height=cam.height, near=cam.near, far=cam.far),
                   ts, rs, self.config["epilogue"])

    def records(self):
        return self.check.items

    def meshes(self):
        return self.meshes_dev

    def launches_per_unit(self):
        return 1

    def free(self):
        self.runners.clear()
