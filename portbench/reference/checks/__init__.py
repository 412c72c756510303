"""The check kinds, one module each: ``checks/<kind>.py``, found by the name
an entry gives (``reference.check.judge``). A kind's module gives

* ``NUMBERS``: the names of the numbers it reads, in order;
* ``reference(rec, mesh, cfg, device, control=False)``: the reference's
  outputs for one record, or with ``control`` the lower-precision
  control's (the reference in bfloat16 put in the port's place);
* ``program(rec)``: the port's outputs, as the record holds them;
* ``numbers(cand, ref, rec)``: the numbers of one record for a candidate's
  outputs against the reference's.

Here: the arithmetic the kinds share."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import raster
from ..score import image_loglike


def finite_gap(a, b, rel=True):
    """The largest gap between ``a`` and ``b`` (relative to max(|b|, 1)),
    inf where one is finite and the other is not; 0 where neither is."""
    a, b = a.double(), b.double()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        return math.inf
    if not bool(fa.any()):
        return 0.0
    d = (a - b).abs()[fa]
    if rel:
        d = d / b.abs()[fa].clamp(min=1.0)
    return float(d.max())


def crop_cam(cam_fields, width, height, near, far):
    return raster.camera_scalars(cam_fields["f_x"], cam_fields["f_y"], cam_fields["c_x"],
                                 cam_fields["c_y"], cam_fields["s"], width, height, near, far)


def loglike(mesh, cam, t, q, z, prior_o, p, epilogue, dtype):
    verts, faces = mesh
    mu = raster.render_depth(verts, faces, cam, t, q, dtype=dtype)
    return image_loglike(mu, z, prior_o, p, epilogue, dtype)


def observation(obs, device):
    z = torch.as_tensor(np.asarray(obs, np.float32), device=device).reshape(-1)
    return torch.where(z <= 0, torch.full_like(z, torch.inf), z)
