"""The roofline's live-pair count: a hand-worked triangle, and a count that
reads nothing of the port."""

import numpy as np
import torch

from portbench import roofline
from portbench.reference import raster


def _cam(w=9, h=7, f=10.0):
    return raster.camera_scalars(f, f, (w - 1) / 2, (h - 1) / 2, 0.0, w, h, 0.01, 10.0)


def _triangle():
    # at z = 1 m with f = 10 px/m: corners at pixel offsets (-2, -2), (3, -2), (-2, 1)
    # from the grid centre, wound so that it faces the camera
    verts = torch.tensor([[-0.2, -0.2, 0.0], [-0.2, 0.1, 0.0], [0.3, -0.2, 0.0]])
    faces = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    t = torch.tensor([[0.0, 0.0, 1.0]])
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    return verts, faces, t, q


def test_one_triangle_counts_its_box():
    verts, faces, t, q = _triangle()
    # the box spans columns -2..3 (6) and rows -2..1 (4) around the centre
    assert raster.live_pairs(verts, faces, _cam(), t, q) == 24
    # facing away: culled, no pair
    assert raster.live_pairs(verts, faces[:, [0, 2, 1]], _cam(), t, q) == 0
    ops, nbytes = roofline.launch_work(verts, faces, _cam(), t, q, "association")
    assert ops == 24 * 15 + 1 * 1 * 90 + 63 * 60
    assert nbytes == (9 + 3 + 3 + 4 + 2 * 63 + 2) * 4


def test_count_ignores_the_ports_projection(monkeypatch):
    from bayesianposeestimation.jl_tpu_torch.ops import cuda_raster

    gen = torch.Generator().manual_seed(3)
    verts = torch.randn((40, 3), generator=gen) * 0.05
    faces = torch.randint(0, 40, (60, 3), generator=gen, dtype=torch.int32)
    t = torch.tensor([[0.0, 0.0, 0.6], [0.01, -0.02, 0.7]])
    q = torch.nn.functional.normalize(torch.randn((2, 4), generator=gen), dim=1)
    before = roofline.launch_work(verts, faces, _cam(30, 30, 40.0), t, q, "fixed_o")

    def broken(*args, **kw):
        raise AssertionError("the yardstick called the port")

    monkeypatch.setattr(cuda_raster, "project_vertices", broken)
    monkeypatch.setattr(cuda_raster, "triangle_forms", broken)
    assert roofline.launch_work(verts, faces, _cam(30, 30, 40.0), t, q, "fixed_o") == before
    assert before[0] > 2 * 60 * 90


def test_bound_takes_the_larger_time():
    b, by = roofline.bound_s(67e12, 1.0)
    assert np.isclose(b, 1.0) and by == "operations"
    b, by = roofline.bound_s(1.0, 3.35e12)
    assert np.isclose(b, 1.0) and by == "bytes"
