"""The port's compile-once trackers on the CPU: one frame step per filter
kind over an observation buffer that each frame is copied into.

``coordinate_pf`` and ``bootstrap_pf`` run a ``capture.ChainRunner`` whose
step is captured once (on the card; on the CPU the same static-buffer step
runs eagerly), cached per configuration and experiment as the JAX package
caches its jitted filter. Both filters, with the fused posterior and with a
graph posterior rebuilt inside every frame step, must equal the eager frame
loop (``captured=False``) bitwise, also on a second stream through the
cached runner.
"""

import numpy as np
import pytest
import torch

from bayesianposeestimation.jl_tpu_torch import capture, convert
from bayesianposeestimation.jl_tpu_torch.models import experiment_models as TEM
from bayesianposeestimation.jl_tpu_torch.models import particle_filter as TPF
from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_depth
from bayesianposeestimation.jl_tpu_torch.utils import mesh_io

CAM = dict(width=24, height=24, f_x=28.8, f_y=28.8, c_x=11.5, c_y=11.5, near=0.01, far=10.0)


def _stream(n_frames=5, seed=0, drift=0.03):
    """A 10 cm cube drifting and turning over ``n_frames`` 24x24 frames,
    4 mm depth noise, invalid background (0)."""
    mesh = mesh_io.cube_mesh(0.1)
    cam = convert.camera_from_fields(**CAM)
    s = torch.linspace(0, 1, n_frames)[:, None]
    t = torch.tensor([[0.0, 0.0, 1.0]]) + s * torch.tensor([[drift, -0.02, 0.04]])
    q = torch.cat([torch.ones(n_frames, 1), 0.15 * s, torch.zeros(n_frames, 1), 0.05 * s], 1)
    q = q / q.norm(dim=1, keepdim=True)
    clean = render_depth(torch.as_tensor(mesh.vertices, dtype=torch.float32),
                         torch.as_tensor(mesh.faces, dtype=torch.int32), cam, t, q,
                         device="cpu").numpy()
    noisy = np.where(clean > 0, clean + np.random.default_rng(seed).normal(0, 0.004, clean.shape),
                     0.0).astype(np.float32)
    exp = convert.experiment_from_numpy(cam, mesh.vertices, mesh.faces, 0.7, t[0].numpy(),
                                        noisy[0])
    return exp, noisy


def _params():
    return convert.parameters_from_fields(
        width=24, height=24, n_particles=24, relative_ess=0.5,
        proposal_sigma_t=(0.005, 0.005, 0.005), proposal_sigma_r=(0.05, 0.05, 0.05),
        device="cpu")


def _equal(a, b):
    sa, la = capture.tree_leaves(a)
    sb, lb = capture.tree_leaves(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert torch.equal(x, y) or torch.allclose(x, y, rtol=0, atol=0, equal_nan=True)


FACTORIES = {"fused": TPF.fused_pf_posterior("simple"), "graph": TEM.simple_posterior,
             "graph_association": TEM.association_posterior}


@pytest.mark.parametrize("kind", ["coordinate", "bootstrap"])
@pytest.mark.parametrize("factory", list(FACTORIES))
def test_filter_equals_the_eager_frame_loop(kind, factory):
    """Both filters with the fused and the graph posteriors: outputs and
    final state bitwise equal to the eager frame loop, on a first stream and
    on a second one through the cached runner, with another seed."""
    pf = TPF.coordinate_pf if kind == "coordinate" else TPF.bootstrap_pf
    posterior_fn, params = FACTORIES[factory], _params()
    exp, frames = _stream()
    stream = convert.stream_from_numpy(frames, "cpu")
    other = convert.stream_from_numpy(_stream(seed=1, drift=-0.02)[1], "cpu")
    for seed, depth in ((0, stream), (1, other)):
        eager = pf(seed, posterior_fn, params, exp, depth, device="cpu", captured=False)
        static = pf(seed, posterior_fn, params, exp, depth, device="cpu")
        _equal(static, eager)
        assert static[0]["t"].shape == (frames.shape[0] - 1, 24, 3)
    hits = [v for k, v in TPF._PF_RUNNERS.items() if k[0] is posterior_fn and k[2] == kind]
    assert len(hits) == 1  # the second stream reused the first stream's runner


def test_host_stream_and_device_stream_agree():
    """A host array is uploaded and converted once (<= 0 -> +inf); the
    captured filter takes it as it takes the converted tensor."""
    exp, frames = _stream()
    params = _params()
    fn = FACTORIES["fused"]
    a = TPF.bootstrap_pf(4, fn, params, exp, frames, device="cpu")
    b = TPF.bootstrap_pf(4, fn, params, exp, convert.stream_from_numpy(frames, "cpu"),
                         device="cpu")
    _equal(a, b)


def test_runner_cache_is_bounded_and_keyed_by_the_experiment():
    """Another experiment gets its own runner; no more than
    ``_PF_RUNNERS_KEPT`` runners are kept, the oldest dropped first."""
    params = _params()
    fn = FACTORIES["fused"]
    TPF._PF_RUNNERS.clear()
    exps = []
    for k in range(TPF._PF_RUNNERS_KEPT + 2):
        exp, frames = _stream(n_frames=3, seed=k)
        exps.append(exp)
        TPF.bootstrap_pf(0, fn, params, exp, frames, device="cpu")
    assert len(TPF._PF_RUNNERS) == TPF._PF_RUNNERS_KEPT
    kept = {k[-1] for k in TPF._PF_RUNNERS}
    assert kept == {id(e) for e in exps[-TPF._PF_RUNNERS_KEPT:]}
