"""Port parity: the particle-filter tracking path against the JAX package.

Module by module on the same NumPy inputs (``QuaternionNormal``, the
velocity-state prior, the dynamics proposals with the JAX draws injected, the
bootstrap kernel, one coordinate-sampler step from a converted state, camera
rescaling, resizing and cropping, decimation, the tracker's likelihood), then
the slice as a whole in distribution: both filters of both packages on the
synthetic stream of ``tests/test_particle_filter.py``.

The two packages draw different random numbers from the same seed, so a
step-for-step comparison takes the JAX function's own draws (made from its
key exactly as the JAX code makes them) and hands them to the port, whose
proposals take their normals as arguments; where the port's sampler draws
them itself, the test replaces ``torch.randn`` / ``torch.rand`` by a queue of
those draws. Likelihood tolerances are those of the kernel tests (rtol 1e-3,
atol 0.2 on the raw pixel sums: a silhouette pixel may flip).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianposeestimation.jl_tpu import distributions as JD
from bayesianposeestimation.jl_tpu import graph as JG
from bayesianposeestimation.jl_tpu import quaternions as jquat
from bayesianposeestimation.jl_tpu import tempering as JT
from bayesianposeestimation.jl_tpu.camera import CvCamera as JCam
from bayesianposeestimation.jl_tpu.models import particle_filter as JPF
from bayesianposeestimation.jl_tpu.ops.rasterize import render_depth as j_render_depth
from bayesianposeestimation.jl_tpu.ops.rasterize import render_depth_batch as j_render
from bayesianposeestimation.jl_tpu.parameters import Experiment as JExperiment
from bayesianposeestimation.jl_tpu.parameters import Parameters as JParams
from bayesianposeestimation.jl_tpu.samplers import smc as JS
from bayesianposeestimation.jl_tpu.samples import Sample as JSample
from bayesianposeestimation.jl_tpu.utils import decimate as jdecimate
from bayesianposeestimation.jl_tpu.utils import mesh_io
from bayesianposeestimation.jl_tpu_torch import convert
from bayesianposeestimation.jl_tpu_torch import distributions as TD
from bayesianposeestimation.jl_tpu_torch import graph as TG
from bayesianposeestimation.jl_tpu_torch import tempering as TT
from bayesianposeestimation.jl_tpu_torch.models import fused as TF
from bayesianposeestimation.jl_tpu_torch.models import particle_filter as TPF
from bayesianposeestimation.jl_tpu_torch.rngs import Rngs
from bayesianposeestimation.jl_tpu_torch.samplers import smc as TS
from bayesianposeestimation.jl_tpu_torch.samples import Sample as TSample
from bayesianposeestimation.jl_tpu_torch.utils import decimate as tdecimate
from bayesianposeestimation.jl_tpu_torch.utils.bop import depth_resize
from bayesianposeestimation.jl_tpu_torch.utils.experiment_io import save_tum

N = 32
CAM = dict(width=32, height=24, f_x=1.1 * 32, f_y=1.1 * 32, c_x=15.5, c_y=11.5,
           near=0.01, far=10.0)
SIGMAS = dict(proposal_sigma_t=(0.01, 0.012, 0.008), proposal_sigma_r=(0.05, 0.04, 0.06))


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _pf_values(rng, n=N):
    return {"t": (np.array([0.0, 0.0, 0.35]) + 0.01 * rng.normal(size=(n, 3))).astype(np.float32),
            "r": _unit(rng.normal(size=(n, 4))),
            "t_dot": (0.01 * rng.normal(size=(n, 3))).astype(np.float32),
            "r_dot": (0.05 * rng.normal(size=(n, 3))).astype(np.float32)}


def _jsample(values):
    return JSample({k: jnp.asarray(v) for k, v in values.items()})


def _tsample(values):
    return TSample({k: torch.as_tensor(v) for k, v in values.items()})


def _scene(rng, n_particles=N, relative_ess=0.5):
    """The operating point of the JAX package's rotation-sensitivity test:
    a 12 cm cube at 0.35 m over a valid background plane, 32x24."""
    mesh = mesh_io.cube_mesh(0.12)
    gt_t = np.array([0.0, 0.0, 0.35], np.float32)
    gt_q = np.asarray(jquat.qexp(jnp.array([0.2, 0.3, 0.1])), np.float32)
    clean = np.asarray(j_render_depth(jnp.asarray(mesh.vertices), jnp.asarray(mesh.faces),
                                      JCam(**CAM), jnp.asarray(gt_t), jnp.asarray(gt_q),
                                      height=24, width=32))
    obs = np.where(clean > 0, clean + 0.003 * rng.normal(size=clean.shape), 0.9)
    obs = obs.astype(np.float32)
    fields = dict(width=32, height=24, n_particles=n_particles, relative_ess=relative_ess,
                  **SIGMAS)
    jparams = JParams(raster_chunk=64, **fields)
    jexp = JExperiment(scene={"camera": JCam(**CAM), "verts": jnp.asarray(mesh.vertices),
                              "faces": jnp.asarray(mesh.faces)},
                       prior_o=jparams.o_mask_is, prior_t=jnp.asarray(gt_t),
                       prior_r=jnp.asarray(gt_q), depth_image=jnp.asarray(obs))
    tparams = convert.parameters_from_fields(device="cpu", **fields)
    texp = convert.experiment_from_numpy(convert.camera_from_fields(**CAM), mesh.vertices,
                                         mesh.faces, tparams.o_mask_is, gt_t, obs, prior_r=gt_q)
    return (jparams, jexp), (tparams, texp), (gt_t, gt_q)


@pytest.mark.parametrize("scale", [0.05, 0.3])
def test_quaternion_normal_logpdf_matches(scale, rng):
    loc = _unit(rng.normal(size=4))
    x = _unit(loc + scale * rng.normal(size=(N, 4)))
    a = np.asarray(JD.QuaternionNormal(jnp.asarray(loc), scale).logpdf(jnp.asarray(x)))
    b = TD.QuaternionNormal(torch.as_tensor(loc), scale).logpdf(torch.as_tensor(x)).numpy()
    assert b.shape == (N,)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


def test_quaternion_normal_samples_around_its_mean_and_is_a_quaternion_variable():
    loc = torch.as_tensor(_unit(np.array([0.5, -0.5, 0.5, 0.5])))
    gen = torch.Generator().manual_seed(0)
    q = TD.QuaternionNormal(loc, 0.1).sample(gen, (4000,))
    assert q.shape == (4000, 4)
    np.testing.assert_allclose(q.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    from bayesianposeestimation.jl_tpu_torch import quaternions as tquat

    v = tquat.qminus(q, loc)
    np.testing.assert_allclose(v.std(0).numpy(), 0.1, atol=0.01)
    np.testing.assert_allclose(v.mean(0).numpy(), 0.0, atol=0.01)
    graph = {"r": TG.BroadcastedNode("r", TD.QuaternionNormal, loc, 0.1),
             "t": TG.BroadcastedNode("t", TD.Normal, 0.0, 1.0)}
    assert TG.quaternion_names_of(graph) == ("r",)
    assert repr(TG.bijectors_of(graph)["r"]) == "Identity"


def test_constant_schedule_matches():
    for temp in (0.0, 0.4, 1.0):
        a = float(JT.ConstantSchedule().increment(jnp.float32(temp)))
        b = TT.ConstantSchedule().increment(torch.tensor(temp))
        assert a == float(b) == 1.0 and b.dtype == torch.float32


def test_pf_prior_nodes_logdensity_matches(rng):
    (jparams, jexp), (tparams, texp), _ = _scene(rng)
    values = _pf_values(rng)
    jgraph = JPF.pf_prior_nodes(jparams, jexp)
    tgraph = TPF.pf_prior_nodes(tparams, texp)
    assert tuple(tgraph) == tuple(jgraph) == ("t_dot", "r_dot", "t", "r")
    a = np.asarray(JG.logdensityof_graph(jgraph, {k: jnp.asarray(v) for k, v in values.items()}, 1))
    b = TG.logdensityof_graph(tgraph, {k: torch.as_tensor(v) for k, v in values.items()}, 1)
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-4)
    assert TG.quaternion_names_of(tgraph) == JG.quaternion_names_of(jgraph) == ("r",)
    gen = torch.Generator().manual_seed(1)
    drawn = TG.sample_graph(tgraph, gen, (7,))
    assert {k: tuple(v.shape) for k, v in drawn.items()} == {
        "t_dot": (7, 3), "r_dot": (7, 3), "t": (7, 3), "r": (7, 4)}


@pytest.mark.parametrize("name", ["t", "r"])
def test_dynamics_matches_with_injected_draws(name, rng):
    values = _pf_values(rng)
    sigma = np.asarray(SIGMAS[f"proposal_sigma_{name}"], np.float32)
    key = jax.random.PRNGKey(5)
    jd = JPF.Dynamics(name, 0.9, jnp.asarray(sigma), is_quaternion=name == "r")
    td = TPF.Dynamics(name, 0.9, torch.as_tensor(sigma), is_quaternion=name == "r")
    a = jd.propose(key, _jsample(values))
    eps = np.array(jax.random.normal(key, (N, 3), jnp.float32))
    b = td.apply(_tsample(values), torch.as_tensor(eps))
    for k in values:
        np.testing.assert_allclose(b.variables[k].numpy(), np.asarray(a.variables[k]),
                                   rtol=1e-5, atol=1e-6)
    assert td.names == jd.names and td.quaternion_names == jd.quaternion_names
    assert td.transition_probability(b, _tsample(values)) == 0.0
    # the proposal the sampler draws itself has the same law
    drawn = td.propose(torch.Generator().manual_seed(0), _tsample(values))
    assert drawn.variables[name].shape == values[name].shape


def test_joint_dynamics_matches_with_injected_draws(rng):
    values = _pf_values(rng)
    st = np.asarray(SIGMAS["proposal_sigma_t"], np.float32)
    sr = np.asarray(SIGMAS["proposal_sigma_r"], np.float32)
    key = jax.random.PRNGKey(6)
    a = JPF.JointDynamics(jnp.asarray(st), jnp.asarray(sr), 0.8).propose(key, _jsample(values))
    kt, kr = jax.random.split(key)
    eps_t = torch.as_tensor(np.array(jax.random.normal(kt, (N, 3), jnp.float32)))
    eps_r = torch.as_tensor(np.array(jax.random.normal(kr, (N, 3), jnp.float32)))
    td = TPF.JointDynamics(torch.as_tensor(st), torch.as_tensor(sr), 0.8)
    b = td.apply(_tsample(values), eps_t, eps_r)
    for k in values:
        np.testing.assert_allclose(b.variables[k].numpy(), np.asarray(a.variables[k]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b.variables["r"].norm(dim=-1).numpy(), 1.0, atol=1e-5)
    assert td.names == JPF.JointDynamics.names


def _states(rng, values):
    lw = rng.normal(size=N).astype(np.float32)
    lp, ll = (rng.normal(size=N).astype(np.float32) for _ in range(2))
    jw = JS.normalize_log_weights(jnp.asarray(lw))
    js = JS.SmcState(JSample({k: jnp.asarray(v) for k, v in values.items()}, jnp.asarray(lp),
                             jnp.asarray(ll)),
                     jw, jnp.float32(-2.0), jnp.float32(1.0), JS.log_relative_ess(jw))
    ts = convert.smc_state_from_numpy(values, np.asarray(jw), lp, ll, log_evidence=-2.0,
                                      temperature=1.0)
    return js, ts


@pytest.mark.parametrize("kernel", ["BootstrapKernel", "ForwardProposalKernel"])
def test_kernel_increments_match(kernel, rng):
    """Both kernels keep the proposed sample; the bootstrap increment is its
    likelihood, the forward-proposal one the MH-ratio-like density ratio."""
    js, ts = _states(rng, _pf_values(rng))
    js2, ts2 = _states(rng, _pf_values(rng))
    sigma = np.asarray(SIGMAS["proposal_sigma_t"], np.float32)
    jk = getattr(JS, kernel)(JPF.Dynamics("t", 0.9, jnp.asarray(sigma)))
    tk = getattr(TS, kernel)(TPF.Dynamics("t", 0.9, torch.as_tensor(sigma)))
    a = np.asarray(jk.incremental_weights(js2.sample, jnp.float32(1.0), js))
    b = tk.incremental_weights(ts2.sample, torch.tensor(1.0), ts)
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-6)
    assert tk.forward(None, ts2.sample, ts.sample) is ts2.sample
    np.testing.assert_allclose(np.asarray(ts.log_relative_ess), np.asarray(js.log_relative_ess),
                               rtol=1e-6)


class _Draws:
    """Stands in for ``torch.randn`` / ``torch.rand``: hands out queued arrays."""

    def __init__(self, arrays):
        self.queue = [torch.as_tensor(np.asarray(a, np.float32)) for a in arrays]

    def __call__(self, shape, **kwargs):
        out = self.queue.pop(0)
        assert tuple(out.shape) == tuple(shape), (out.shape, shape)
        return out


@pytest.mark.parametrize("relative_ess", [1e-9, 0.5, 1.0])
def test_coordinate_sampler_step_matches_from_converted_state(relative_ess, rng, monkeypatch):
    """One coordinate step (a t block, then an r block) of both packages from
    the same state with the same draws: never, maybe and always resampling."""
    (jparams, jexp), (tparams, texp), _ = _scene(rng, relative_ess=relative_ess)
    values = _pf_values(rng)
    jmodel = JPF.fused_pf_posterior("simple")(jparams, jexp)
    tmodel = TPF.fused_pf_posterior("simple")(tparams, texp, device="cpu")
    jsampler = JPF._pf_samplers(jparams, "coordinate")
    tsampler = TPF._pf_samplers(tparams, "coordinate", torch.device("cpu"))

    # a state as the filter carries it: densities of the previous frame
    jstate = jmodel.tempered_logdensity_sample(_jsample(values), 1.0)
    lw = JS.normalize_log_weights(jnp.asarray(rng.normal(size=N).astype(np.float32)))
    jstate = JS.SmcState(jstate, lw, jnp.float32(0.0), jnp.float32(1.0), JS.log_relative_ess(lw))
    tstate = convert.smc_state_from_numpy(
        values, np.asarray(lw), np.asarray(jstate.sample.log_prob),
        np.asarray(jstate.sample.log_like))

    key = jax.random.PRNGKey(17)
    _, jnew = jsampler.step(key, jmodel, jstate)
    normals, uniforms = [], []
    for k in jax.random.split(key, 2):
        k_prop, _, k_res = jax.random.split(k, 3)
        normals.append(np.array(jax.random.normal(k_prop, (N, 3), jnp.float32)))
        uniforms.append(np.array(jax.random.uniform(k_res, ())))
    monkeypatch.setattr(torch, "randn", _Draws(normals))
    monkeypatch.setattr(torch, "rand", _Draws(uniforms))
    _, tnew = tsampler.step(Rngs.from_seed(0, "cpu"), tmodel, tstate)
    monkeypatch.undo()

    n_pix = tparams.width * tparams.height
    for k in values:
        np.testing.assert_allclose(tnew.sample.variables[k].numpy(),
                                   np.asarray(jnew.sample.variables[k]), rtol=1e-5, atol=1e-6)
    raw = n_pix / tparams.c_reg  # log_like = c_reg / n_pix * (raw pixel sum)
    np.testing.assert_allclose(tnew.sample.log_like.numpy() * raw,
                               np.asarray(jnew.sample.log_like) * raw, rtol=1e-3, atol=0.2)
    np.testing.assert_allclose(tnew.log_weights.numpy(), np.asarray(jnew.log_weights),
                               rtol=1e-3, atol=0.02)
    np.testing.assert_allclose(float(tnew.log_evidence), float(jnew.log_evidence),
                               rtol=1e-3, atol=0.02)
    assert float(tnew.temperature) == float(jnew.temperature) == 1.0
    if relative_ess == 1.0:  # resampled: uniform weights
        np.testing.assert_allclose(tnew.log_weights.numpy(), -math.log(N), rtol=1e-6)


def test_scale_to_matches():
    fields = dict(width=640, height=480, f_x=610.0, f_y=605.0, c_x=321.3, c_y=238.9, s=0.4,
                  near=0.02, far=7.0)
    a = JCam(**fields).scale_to(80, 60)
    b = convert.camera_from_fields(**fields).scale_to(80, 60)
    for k in ("width", "height", "near", "far"):
        assert getattr(a, k) == getattr(b, k)
    for k in ("f_x", "f_y", "c_x", "c_y", "s"):
        assert float(getattr(a, k)) == pytest.approx(getattr(b, k), rel=1e-12)


def test_resize_and_crop_experiment_exact(rng):
    (jparams, jexp), (tparams, texp), (gt_t, _) = _scene(rng)
    big = rng.uniform(0.3, 1.5, size=(48, 64)).astype(np.float32)
    big[rng.random(big.shape) < 0.05] = np.inf  # invalid pixels stay invalid
    a = JPF.resize_experiment(jexp, jnp.asarray(big), 32, 24)
    b = TPF.resize_experiment(texp, torch.as_tensor(big), 32, 24)
    np.testing.assert_array_equal(b.depth_image.numpy(), np.asarray(a.depth_image))
    np.testing.assert_array_equal(depth_resize(big, 32, 24), np.asarray(a.depth_image))
    assert b.scene is texp.scene

    cam = dict(CAM, width=64, height=48, f_x=70.4, f_y=70.4, c_x=31.5, c_y=23.5)
    jexp64 = JExperiment(scene={**jexp.scene, "camera": JCam(**cam)}, prior_o=0.7,
                         prior_t=jnp.asarray(gt_t))
    texp64 = convert.experiment_from_numpy(convert.camera_from_fields(**cam),
                                           np.asarray(jexp.scene["verts"]),
                                           np.asarray(jexp.scene["faces"]), 0.7, gt_t, big)
    t_est = np.array([0.02, -0.01, 0.35])
    a = JPF.crop_experiment(jexp64, jnp.asarray(big), t_est, 0.2, 32, 24)
    b = TPF.crop_experiment(texp64, torch.as_tensor(big), t_est, 0.2, 32, 24)
    np.testing.assert_array_equal(b.depth_image.numpy(), np.asarray(a.depth_image))
    ca, cb = a.scene["camera"], b.scene["camera"]
    for k in ("f_x", "f_y", "c_x", "c_y"):
        assert float(getattr(ca, k)) == pytest.approx(getattr(cb, k), rel=1e-6)
    assert (cb.width, cb.height) == (32, 24)
    assert texp64.scene["camera"].width == 64  # the source experiment is untouched


def test_decimate_matches_on_the_monkey():
    mesh = mesh_io.monkey_mesh(0.18)
    a = jdecimate.decimate(mesh, 256)
    b = tdecimate.decimate(convert.mesh_from_numpy(mesh.vertices, mesh.faces), 256)
    assert b.n_faces == a.n_faces == 256
    np.testing.assert_array_equal(b.faces, a.faces)
    np.testing.assert_array_equal(b.vertices, a.vertices)
    c = tdecimate._cluster_decimate(convert.mesh_from_numpy(mesh.vertices, mesh.faces), 256)
    d = jdecimate._cluster_decimate(mesh, 256)
    np.testing.assert_array_equal(c.faces, d.faces)
    np.testing.assert_array_equal(c.vertices, d.vertices)
    small = convert.mesh_from_numpy(*(lambda m: (m.vertices, m.faces))(mesh_io.cube_mesh(0.1)))
    assert tdecimate.decimate(small, 256) is small  # already within the budget


def test_pf_likelihood_matches_and_is_rotation_sensitive(rng):
    """The eight orientations of the JAX package's rotation-sensitivity test."""
    (jparams, jexp), (tparams, texp), (gt_t, gt_q) = _scene(rng, n_particles=8)
    angs = np.array([0.0, 0.0, 0.0, 0.0, 0.5, 1.0, 1.5, 3.0], np.float32)
    qs = np.stack([np.asarray(jquat.qmul(jnp.asarray(gt_q),
                                         jquat.qexp(jnp.array([a / 2, 0.0, 0.0])))) for a in angs])
    values = {"t": np.tile(gt_t, (8, 1)), "r": qs.astype(np.float32),
              "t_dot": np.zeros((8, 3), np.float32), "r_dot": np.zeros((8, 3), np.float32)}
    jpost = JPF.fused_pf_posterior("simple")(jparams, jexp)
    tpost = TPF.fused_pf_posterior("simple")(tparams, texp, device="cpu")
    a = jpost.logdensity_sample(_jsample(values), batch_ndim=1)
    b = tpost.logdensity_sample(_tsample(values))
    raw = tparams.width * tparams.height / tparams.c_reg
    np.testing.assert_allclose(b.log_like.numpy() * raw, np.asarray(a.log_like) * raw,
                               rtol=1e-3, atol=0.2)
    np.testing.assert_allclose(b.log_prob.numpy(), np.asarray(a.log_prob), rtol=1e-3, atol=0.01)
    ll = b.log_like.numpy()
    assert ll[0] - ll[4] > 1.0 and ll[0] - ll[7] > 2.0, ll


def test_with_observation_swaps_only_the_observation(rng):
    _, (tparams, texp), _ = _scene(rng)
    post = TPF.fused_pf_posterior("simple")(tparams, texp, device="cpu")
    s = _tsample(_pf_values(rng))
    a = post.logdensity_sample(s)
    depth, verts, graph = post.depth, post.verts, post.graph
    other_obs = torch.full((24, 32), torch.inf)
    other = post.with_observation(other_obs)
    # written in place into the buffer a captured step reads
    assert other is post and post.depth is depth and post.depth is not other_obs
    assert torch.equal(post.depth, other_obs)
    assert post.verts is verts and post.graph is graph
    b = other.logdensity_sample(s)
    assert bool(torch.isfinite(b.log_like).all())  # every pixel invalid: the tail only
    assert float((a.log_like - b.log_like).abs().max()) > 0.1
    assert len(set(b.log_like.tolist())) == 1


def _stream(n_frames=6, width=24, height=24):
    """The stream of tests/test_particle_filter.py: a 10 cm cube drifting
    and turning over six 24x24 frames, 4 mm depth noise."""
    mesh = mesh_io.cube_mesh(0.1)
    cam = dict(width=width, height=height, f_x=1.2 * width, f_y=1.2 * width,
               c_x=(width - 1) / 2, c_y=(height - 1) / 2, near=0.01, far=10.0)
    s = np.linspace(0, 1, n_frames)
    gt_t = np.stack([0.03 * s, -0.02 * s, 1.0 + 0.04 * s], 1).astype(np.float32)
    gt_q = np.stack([np.asarray(jquat.qexp(jnp.array([0.3 * si, 0.0, 0.1 * si]))) for si in s])
    depth = np.asarray(j_render(jnp.asarray(mesh.vertices), jnp.asarray(mesh.faces), JCam(**cam),
                                jnp.asarray(gt_t), jnp.asarray(gt_q, jnp.float32)))
    noisy = np.where(depth > 0, depth + np.random.default_rng(0).normal(0, 0.004, depth.shape),
                     0.0)
    return mesh, cam, noisy.astype(np.float32), gt_t, gt_q.astype(np.float32)


def _stream_setups():
    mesh, cam, depth, gt_t, gt_q = _stream()
    fields = dict(width=24, height=24, n_particles=64, proposal_sigma_t=(0.01, 0.01, 0.01),
                  proposal_sigma_r=(0.05, 0.05, 0.05))
    jparams = JParams(raster_chunk=64, **fields)
    jexp = JExperiment(scene={"camera": JCam(**cam), "verts": jnp.asarray(mesh.vertices),
                              "faces": jnp.asarray(mesh.faces)},
                       prior_o=jparams.o_mask_is, prior_t=jnp.asarray(gt_t[0]),
                       prior_r=jnp.asarray(gt_q[0]), depth_image=jnp.asarray(depth[0]))
    tparams = convert.parameters_from_fields(device="cpu", **fields)
    texp = convert.experiment_from_numpy(convert.camera_from_fields(**cam), mesh.vertices,
                                         mesh.faces, tparams.o_mask_is, gt_t[0], depth[0],
                                         prior_r=gt_q[0])
    return (jparams, jexp), (tparams, texp), depth, gt_t


def _median_error(outs_t, outs_w, gt_t):
    est_t = np.einsum("fn,fnd->fd", np.exp(outs_w), outs_t)
    return float(np.median(np.linalg.norm(est_t - gt_t[1:], axis=1)))


@pytest.mark.parametrize("kind", ["coordinate", "bootstrap"])
def test_filters_track_like_the_jax_package(kind):
    """The slice as a whole, in distribution: over five seeds each package's
    median translation error stays below 2 cm and the two packages' mean
    median errors lie within 1 cm of each other."""
    (jparams, jexp), (tparams, texp), depth, gt_t = _stream_setups()
    jpf = JPF.coordinate_pf if kind == "coordinate" else JPF.bootstrap_pf
    tpf = TPF.coordinate_pf if kind == "coordinate" else TPF.bootstrap_pf
    jfn, tfn = JPF.fused_pf_posterior("simple"), TPF.fused_pf_posterior("simple")
    stream = convert.stream_from_numpy(depth)
    errs_j, errs_t = [], []
    for seed in range(5):
        outs, _ = jpf(jax.random.PRNGKey(seed), jfn, jparams, jexp, depth)
        errs_j.append(_median_error(np.asarray(outs["t"]), np.asarray(outs["log_weights"]), gt_t))
        outs, final = tpf(seed, tfn, tparams, texp, stream, device="cpu")
        errs_t.append(_median_error(outs["t"].numpy(), outs["log_weights"].numpy(), gt_t))
        assert outs["t"].shape == (5, 64, 3) and outs["r"].shape == (5, 64, 4)
        assert all(bool(torch.isfinite(v).all()) for v in outs.values())
        assert float(final.temperature) == 1.0
    assert max(errs_j) < 0.02 and max(errs_t) < 0.02, (errs_j, errs_t)
    assert abs(np.mean(errs_j) - np.mean(errs_t)) < 0.01, (errs_j, errs_t)


@pytest.mark.parametrize("kind,per_frame", [("coordinate", 2), ("bootstrap", 1)])
def test_filter_evaluates_once_per_block_and_builds_the_model_once(kind, per_frame, monkeypatch):
    _, (tparams, texp), depth, _ = _stream_setups()
    calls = {"evaluations": 0, "mesh": 0}
    inner_eval, inner_mesh = TF.FusedPosterior.prior_and_likelihood, TF.mesh_tensors

    def counted_eval(self, sample, *args):
        calls["evaluations"] += 1
        return inner_eval(self, sample, *args)

    def counted_mesh(*args):
        calls["mesh"] += 1
        return inner_mesh(*args)

    monkeypatch.setattr(TF.FusedPosterior, "prior_and_likelihood", counted_eval)
    monkeypatch.setattr(TF, "mesh_tensors", counted_mesh)
    pf = TPF.coordinate_pf if kind == "coordinate" else TPF.bootstrap_pf
    # a host array goes through the same conversion (<= 0 -> +inf, once)
    outs, _ = pf(3, TPF.fused_pf_posterior("simple"), tparams, texp, depth,
                 collect_vars=("t", "r", "t_dot"), device="cpu")
    assert calls == {"evaluations": 1 + per_frame * (depth.shape[0] - 1), "mesh": 1}
    assert outs["t_dot"].shape == (5, 64, 3) and outs["log_weights"].shape == (5, 64)


def test_filter_coasts_through_dropped_frames():
    """Frames with every pixel invalid carry no evidence: the weights stay
    uniform, nothing turns NaN, and the filter re-acquires afterwards."""
    _, (tparams, texp), depth, gt_t = _stream_setups()
    depth = depth.copy()
    depth[2:4] = 0.0
    outs, _ = TPF.coordinate_pf(0, TPF.fused_pf_posterior("simple"), tparams, texp, depth,
                                device="cpu")
    assert all(bool(torch.isfinite(v).all()) for v in outs.values())
    lw = outs["log_weights"].numpy()
    np.testing.assert_allclose(np.exp(lw).sum(1), 1.0, rtol=1e-4)
    assert _median_error(outs["t"].numpy(), lw, gt_t) < 0.03


def test_filters_default_to_the_card():
    _, (tparams, texp), depth, _ = _stream_setups()
    if not torch.cuda.is_available():
        for pf in (TPF.coordinate_pf, TPF.bootstrap_pf):
            with pytest.raises(RuntimeError):  # no quiet fallback to the CPU
                pf(0, TPF.fused_pf_posterior("simple"), tparams, texp, depth)
        with pytest.raises(RuntimeError):
            TPF.fused_pf_posterior("simple")(tparams, texp)
    with pytest.raises(ValueError):
        TPF.fused_pf_posterior("bogus")(tparams, texp, device="cpu")


def test_convert_carries_a_tracking_setup_across(rng, tmp_path):
    jparams = JParams(width=80, height=60, n_particles=600, velocity_decay=0.85,
                      relative_ess=0.4, proposal_sigma_t=(0.005,) * 3,
                      proposal_sigma_r=(0.05,) * 3)
    import dataclasses

    tparams = convert.parameters_from_fields(**dataclasses.asdict(jparams))
    for k in ("velocity_decay", "relative_ess", "n_particles", "width", "height"):
        assert getattr(tparams, k) == getattr(jparams, k)
    assert tparams.proposal_sigma_t == (0.005,) * 3 and tparams.proposal_sigma_r == (0.05,) * 3

    depth = rng.uniform(0.2, 1.0, size=(3, 6, 8)).astype(np.float32)
    depth[0, 0, :2] = [0.0, -1.0]
    stream = convert.stream_from_numpy(depth)
    assert stream.dtype == torch.float32 and stream.shape == (3, 6, 8)
    assert bool(torch.isinf(stream[0, 0, :2]).all()) and int(torch.isinf(stream).sum()) == 2
    np.testing.assert_array_equal(stream.numpy()[depth > 0], depth[depth > 0])

    values = _pf_values(rng)
    lw = np.log(np.full(N, 1.0 / N, np.float32))
    state = convert.smc_state_from_numpy(values, lw, np.zeros(N), np.ones(N), temperature=1.0)
    assert set(state.sample.variables) == {"t", "r", "t_dot", "r_dot"}
    assert float(state.log_relative_ess) == pytest.approx(0.0, abs=1e-5)
    assert float(state.temperature) == 1.0 and state.sample.log_like.dtype == torch.float32

    path = tmp_path / "track.tum"
    save_tum(path, np.arange(N) / 90.0, values["t"], values["r"])
    rows = np.loadtxt(path)
    np.testing.assert_allclose(rows[:, 1:4], values["t"], rtol=1e-6)
    np.testing.assert_allclose(rows[:, 7], values["r"][:, 0], rtol=1e-6, atol=1e-8)  # w last
