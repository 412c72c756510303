"""BOP pose estimation with the multiple-try baseline (``mtm_sampler``)
through the port's per-image runner: the MCMC entry (``conditioned_chain.py``,
``chain_best``) as it serves, times, estimates and profiles a request, with
records for the check kind ``mtm`` (``reference/checks/mtm.py``). The port's
multiple-try step reports the record of each move (its tries, its reference
set, m, the Gumbel noise, the selected index, log α and the uniform), which
the runners built here collect every step as rows (``mtm_*``: their
collected variables name ``samplers.mtm.RECORD``); a record holds, beside
the whole chain, those rows at a few steps drawn from the seed, copied to
the host for the checked requests alone. Each step scores the tries and the reference set
in two ``render_score`` launches, which the roofline reads."""

from __future__ import annotations

import functools

import numpy as np
import torch

from bayesianposeestimation.jl_tpu_torch.samplers import mtm

from . import conditioned_chain

KIND = conditioned_chain.KIND
MOVE_ROWS = ("try_t", "try_r", "try_log_prob", "ref_t", "ref_r", "ref_log_prob", "m", "gumbel",
             "index", "log_alpha", "u")


class Entry(conditioned_chain.Entry):
    def __init__(self, cell, config, seed, device):
        super().__init__(cell, config, seed, device)
        self.check_kind = "mtm"
        self.moves_checked = int(cell["check"]["moves"])
        self.request = 0

    def setup(self):
        """The MCMC entry's set-up, with runners that also collect the move
        record."""
        record = getattr(mtm, "RECORD", None)
        if record is None:
            raise SystemExit("portbench: the port's multiple-try step reports no move record")
        build = conditioned_chain.make_conditioned_chain
        conditioned_chain.make_conditioned_chain = functools.partial(
            build, collect_vars=("t", "r", record))
        try:
            super().setup()
        finally:
            conditioned_chain.make_conditioned_chain = build

    def _serve(self, it, seed):
        out = super()._serve(it, seed)
        self.outs = out[1]
        return out

    def run(self, i, traced=False):
        self.request = i
        n, ok = super().run(i, traced)
        if traced:  # the poses each launch scored: the tries and the reference set
            obj, cam, _, _ = self.traced[-1]
            self.traced[-1] = (obj, cam, self.outs)
        return n, ok

    def _record(self, it, prep, outs, pick, t, q):
        rec = super()._record(it, prep, outs, pick, t, q)
        rows = outs["t"].shape[0]
        rng = np.random.default_rng([self.seed, 13, self.request])
        steps = torch.as_tensor(np.sort(rng.choice(np.arange(1, rows),
                                                   min(self.moves_checked, rows - 1),
                                                   replace=False)))
        at = steps.to(outs["t"].device)
        rec["moves"] = {"step": steps,
                        **{k: outs["mtm_" + k][at].cpu() for k in MOVE_ROWS}}
        return rec

    def check_config(self):
        limits = self.cell["check"]["limits"]
        return dict(super().check_config(), tries_limit=limits["tries"],
                    alpha_limit=limits["alpha"])

    def roofline_inputs(self):
        """Per traced request: the tries [S, T, 3] and the reference sets [S,
        T - 1, 3] (one chain), each step's two launches."""
        for obj, cam, outs in self.traced:
            cam_f = dict(f_x=cam.f_x, f_y=cam.f_y, c_x=cam.c_x, c_y=cam.c_y, s=cam.s,
                         width=cam.width, height=cam.height, near=cam.near, far=cam.far)
            for head in ("try", "ref"):
                ts, rs = outs[f"mtm_{head}_t"], outs[f"mtm_{head}_r"]
                yield (self.meshes_dev[obj], cam_f, ts.reshape(ts.shape[0], -1, 3),
                       rs.reshape(rs.shape[0], -1, 4), self.config["epilogue"])

    def launches_per_unit(self):
        return 2
