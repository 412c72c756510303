"""Tracking through the port's captured bootstrap particle filter: the
tracker entry (``particle_filter.py``) as it serves, times, estimates and
profiles a request, with records for the check kind ``bootstrap``
(``reference/checks/bootstrap.py``), which also judges each checked frame's
resample. A record holds, beside the tracker's, the log-weights the frame's
step started from (the previous tracked frame's, or the uniform weights of
the filter's init before the first) and the step's log relative ESS before
its resample, both as the filter collected them."""

from __future__ import annotations

import math

import numpy as np
import torch

from . import particle_filter

KIND = particle_filter.KIND


class Entry(particle_filter.Entry):
    check_kind = "bootstrap"

    def _records(self, i, c, outs, est_t, est_q):
        n = est_t.shape[0]
        rng = np.random.default_rng([self.seed, 11, i])
        frames = sorted({n - 1, *rng.choice(n - 1, self.frames_checked - 1, replace=False)})
        lw = outs["log_weights"]
        init = torch.full_like(lw[0], -math.log(lw.shape[1]))
        return [dict(mesh=0, obs=self.clips[c][f + 1],
                     population={k: outs[k][f] for k in ("t", "r", "log_like", "log_weights")},
                     previous_log_weights=lw[f - 1] if f else init,
                     log_relative_ess=outs["log_relative_ess"][f],
                     estimate=(est_t[f], est_q[f])) for f in frames]
