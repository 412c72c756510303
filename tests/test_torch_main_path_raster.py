"""Port parity on the main path's own raster configuration.

The flagship chain renders the 1280-face monkey at 30x30 through
``pallas_render_score(paired=True)`` over ``antipodal_pair_faces``
(``jl_tpu/models/fused.py:161-172``), with the 3-group ``depth_in_dot``
layout; past ``_DEPTH_IN_DOT_MAX_PPAD`` pixels (80x60) Pallas takes the
2-group layout, and a mesh that cannot pair takes ``band_cull`` over
``spatial_sort_faces``. Each of those Pallas paths runs here in interpret
mode against the port's plain version (``render_score_reference``, which the
CUDA kernel equals bitwise on the card) on the same noisy monkey render, with
the association score.

Tolerances: ell and sum_o within rtol=1e-3, atol=0.2, as in
tests/test_torch_render_score.py (the two rasterisers evaluate the edge
functions by different arithmetic, so a silhouette pixel may rarely flip its
winning triangle). The depth images are compared by coverage and interior
percentiles, not by the max (a flipped silhouette pixel differs by the depth
step between two faces).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianposeestimation.jl_tpu import quaternions as JQ
from bayesianposeestimation.jl_tpu.camera import CvCamera as JCam
from bayesianposeestimation.jl_tpu.camera import crop_camera
from bayesianposeestimation.jl_tpu.models.fused import make_score_fn as j_make_score_fn
from bayesianposeestimation.jl_tpu.ops import pallas_raster as PR
from bayesianposeestimation.jl_tpu.ops.rasterize import render_depth_batch as j_render
from bayesianposeestimation.jl_tpu.parameters import Parameters as JParams
from bayesianposeestimation.jl_tpu.utils import mesh_io
from bayesianposeestimation.jl_tpu_torch import convert
from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_score_reference

N_POSES = 4
GT_T = np.array([0.01, -0.02, 1.0], np.float32)


def _scene(width, height, seed=0):
    """bench.py's scene at (width, height): the monkey in a crop of the VGA
    camera, a noisy render of the truth as the observation (+inf off the
    object), and poses scattered around the truth (2 cm, ~0.3 rad)."""
    mesh = mesh_io.monkey_mesh(0.08)
    base = JCam(width=640, height=480, f_x=600.0, f_y=600.0, c_x=319.5, c_y=239.5,
                near=0.01, far=10.0)
    cam = crop_camera(base, GT_T, mesh_io.mesh_diameter(mesh), width=width, height=height)
    rng = np.random.default_rng(seed)
    gt_q = np.asarray(JQ.rand_quaternion(jax.random.PRNGKey(seed)), np.float32)
    clean = np.asarray(j_render(jnp.asarray(mesh.vertices), jnp.asarray(mesh.faces), cam,
                                jnp.asarray(GT_T[None]), jnp.asarray(gt_q[None])))[0]
    z = np.where(clean > 0, clean + 0.01 * rng.normal(size=clean.shape), np.inf)
    t = (GT_T + 0.02 * rng.normal(size=(N_POSES, 3))).astype(np.float32)
    q = np.asarray(JQ.qplus(jnp.asarray(np.repeat(gt_q[None], N_POSES, 0)),
                            jnp.asarray(0.3 * rng.normal(size=(N_POSES, 3)), jnp.float32)),
                   np.float32)
    return mesh, cam, t, q, z.astype(np.float32), float((clean > 0).mean())


@pytest.mark.parametrize("width,height,layout", [(30, 30, "paired"), (80, 60, "paired"),
                                                 (30, 30, "band_cull")])
def test_plain_version_matches_pallas_on_the_main_path_layout(width, height, layout):
    mesh, cam, t, q, z, covered = _scene(width, height)
    assert covered > 0.1  # the observation holds the object, not only +inf
    verts = jnp.asarray(mesh.vertices)
    n_pix = width * height
    p_pad = PR._round_up(n_pix, PR.LANE)
    # the depth rides the edge dot (3 row groups) up to _DEPTH_IN_DOT_MAX_PPAD
    # pixels; past it the kernel takes the 2-group layout
    groups = 3 if PR._resolve_depth_in_dot(None, p_pad) else 2
    if layout == "paired":
        # the fused posterior's choice for this mesh and image
        assert PR.paired_layout_ok(mesh.faces.shape[0], n_pix)
        faces = PR.antipodal_pair_faces(verts, jnp.asarray(mesh.faces))
        kw = dict(paired=True)
    else:
        faces = PR.spatial_sort_faces(verts, jnp.asarray(mesh.faces),
                                      PR.resolve_chunk(mesh.faces.shape[0], n_pix))
        kw = dict(band_cull=True)
    assert groups == (3 if (width, height) == (30, 30) else 2)
    jp = JParams(width=width, height=height)
    ell_j, sumo_j, mu_j = (np.asarray(a) for a in PR.pallas_render_score(
        verts, jnp.asarray(faces), cam, jnp.asarray(t), jnp.asarray(q), jnp.asarray(z),
        jnp.float32(0.7), j_make_score_fn(jp, "association"), return_mu=True, **kw))

    tp = convert.parameters_from_fields(width=width, height=height)
    t_cam = convert.camera_from_fields(width=cam.width, height=cam.height, f_x=cam.f_x,
                                       f_y=cam.f_y, c_x=cam.c_x, c_y=cam.c_y, s=cam.s,
                                       near=cam.near, far=cam.far)
    ell_t, sumo_t, mu_t = (a.numpy() for a in render_score_reference(
        torch.as_tensor(mesh.vertices), torch.as_tensor(mesh.faces), t_cam,
        torch.as_tensor(t), torch.as_tensor(q), torch.as_tensor(z), 0.7, tp,
        "association", return_mu=True))

    assert np.all(np.isfinite(ell_t)) and sumo_t.min() > 0.05 * n_pix
    np.testing.assert_allclose(ell_t, ell_j, rtol=1e-3, atol=0.2)
    np.testing.assert_allclose(sumo_t, sumo_j, rtol=1e-3, atol=0.2)
    assert (mu_j > 0).mean() > 0.1
    assert np.mean((mu_t > 0) != (mu_j > 0)) < 5e-3
    both = (mu_t > 0) & (mu_j > 0)
    rel = np.abs(mu_t[both] - mu_j[both]) / mu_j[both]
    # the 3-group layout carries the depth through the edge dot's bf16x2
    # split: a few 1e-6 relative at the median there, ~1e-7 in the 2-group one
    assert np.percentile(rel, 50) < 1e-5 and np.percentile(rel, 99) < 1e-4
