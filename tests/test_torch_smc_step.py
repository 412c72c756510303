"""Port parity: whole SequentialMonteCarlo steps of ``smc_mh``'s three kernels.

``smc_mh`` (the flagship sampler, ``jl_tpu/models/experiment_samplers.py:132-142``)
composes three tempered SMC samplers: ``AdaptiveKernel(MhKernel(t))``,
``MhKernel(r)`` and ``MhKernel(r independent)``. Each runs here for a few
whole ``SequentialMonteCarlo.step``s in both packages, from the same state, on
the fused association posterior of a 12-face cube at 16x16 (the JAX side's
Pallas kernel in interpret mode). The port's draws are replaced by the JAX
step's own, split from its key exactly as the JAX step splits it: the
proposal's normals (the adaptive kernel's standard normals, or the proposal
graph's draws), the MH uniforms and the resampling uniform. Temperature,
weights, evidence, ESS and particles are compared after every step, each
package carrying its own state on.

Tolerances: the two posteriors' log-likelihoods agree within rtol 1e-3, atol
0.1 (tests/test_torch_fused.py; here within 0.03); a step moves a weight by
(ϕ' - ϕ)·ℓ with ϕ' - ϕ = 1/20, so normalized weights, evidence and log ESS
agree within 0.005 (measured: 6e-4). With every accept and resampling
decision the same, the particles agree to float32 rounding: 1e-6 (measured:
1.2e-7), also where the adaptive proposal's covariance comes from those
weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianposeestimation.jl_tpu import graph as JG
from bayesianposeestimation.jl_tpu import quaternions as JQ
from bayesianposeestimation.jl_tpu.camera import CvCamera
from bayesianposeestimation.jl_tpu.camera import crop_camera
from bayesianposeestimation.jl_tpu.models import experiment_samplers as JES
from bayesianposeestimation.jl_tpu.models.fused import fused_posterior as j_fused
from bayesianposeestimation.jl_tpu.ops.rasterize import render_depth
from bayesianposeestimation.jl_tpu.parameters import Experiment, Parameters
from bayesianposeestimation.jl_tpu.samplers import smc as JS
from bayesianposeestimation.jl_tpu.samples import Sample as JSample
from bayesianposeestimation.jl_tpu.utils import mesh_io
from bayesianposeestimation.jl_tpu_torch import convert
from bayesianposeestimation.jl_tpu_torch import proposals as TPr
from bayesianposeestimation.jl_tpu_torch.models import experiment_samplers as TES
from bayesianposeestimation.jl_tpu_torch.models.fused import fused_posterior as t_fused
from bayesianposeestimation.jl_tpu_torch.rngs import Rngs
from bayesianposeestimation.jl_tpu_torch.samplers import smc as TS

N = 24
SCHEDULE = 20  # LinearSchedule steps: each step raises the temperature by 0.05
STEPS = 3
TEMP0 = 0.25
KERNELS = {0: "AdaptiveKernel(MhKernel(t))", 1: "MhKernel(r)", 2: "MhKernel(r independent)"}
WEIGHT_ATOL = 0.005
PARTICLE_ATOL = 1e-6


@pytest.fixture(scope="module")
def model():
    """tests/test_multichip.py's cube scene through both fused posteriors."""
    params = Parameters(width=16, height=16, n_particles=N, n_steps=SCHEDULE,
                        proposal_sigma_r=(0.3, 0.3, 0.3))
    mesh = mesh_io.cube_mesh(0.1)
    base = CvCamera(width=640, height=480, f_x=600.0, f_y=600.0, c_x=319.5, c_y=239.5,
                    near=0.01, far=10.0)
    cam = crop_camera(base, np.array([0.01, -0.02, 1.0]), mesh_io.mesh_diameter(mesh),
                      width=16, height=16)
    scene = {"camera": cam, "verts": jnp.asarray(mesh.vertices),
             "faces": jnp.asarray(mesh.faces)}
    k_gt, k_noise = jax.random.split(jax.random.PRNGKey(3))
    gt_t = jnp.array([0.01, -0.02, 1.0])
    gt_q = JQ.rand_quaternion(k_gt)
    clean = render_depth(scene["verts"], scene["faces"], cam, gt_t, gt_q)
    obs = jnp.where(clean > 0, clean + 0.01 * jax.random.normal(k_noise, clean.shape), 0.0)
    exp = Experiment(scene=scene, prior_o=params.o_mask_is, prior_t=gt_t, depth_image=obs)
    j_post = j_fused(params, exp, "association")
    t_params = convert.parameters_from_fields(
        **{f.name: getattr(params, f.name) for f in dataclasses.fields(params)})
    t_cam = convert.camera_from_fields(**{f.name: float(getattr(cam, f.name))
                                          for f in dataclasses.fields(cam)})
    t_exp = convert.experiment_from_numpy(t_cam, mesh.vertices, mesh.faces, params.o_mask_is,
                                          np.asarray(gt_t), np.asarray(obs))
    t_post = t_fused(t_params, t_exp, "association", device="cpu")
    return dict(params=params, t_params=t_params, j_post=j_post, t_post=t_post,
                gt_t=np.asarray(gt_t), gt_q=np.asarray(gt_q))


def _initial_states(model, seed):
    """A JAX SmcState at TEMP0 (particles scattered around the truth, uneven
    weights) and the same state in the port."""
    rng = np.random.default_rng(seed)
    t = (model["gt_t"] + 0.01 * rng.normal(size=(N, 3))).astype(np.float32)
    q = (model["gt_q"] + 0.3 * rng.normal(size=(N, 4))).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w = rng.normal(size=N).astype(np.float32)
    w = w - np.log(np.exp(w.astype(np.float64)).sum()).astype(np.float32)
    js = model["j_post"].tempered_logdensity_sample(
        JSample({"t": jnp.asarray(t), "r": jnp.asarray(q)}), jnp.float32(TEMP0))
    jw = jnp.asarray(w)
    jstate = JS.SmcState(js, jw, jnp.float32(0.0), jnp.float32(TEMP0),
                         JS.log_relative_ess(jw))
    tstate = convert.smc_state_from_numpy({"t": t, "r": q}, w, np.asarray(js.log_prob),
                                          np.asarray(js.log_like), 0.0, TEMP0)
    return jstate, tstate


def _jax_draws(smc, key):
    """The random numbers of ``smc.step(key, ...)``, split from its key as
    the JAX step splits it: (proposal draws or adaptive normals, MH
    uniforms [N], resampling uniform)."""
    k_prop, k_fwd, k_res = jax.random.split(key, 3)
    kernel = smc.kernel
    if isinstance(kernel, JS.AdaptiveKernel):
        names = kernel.kernel.proposal.names
        k_delta, _ = jax.random.split(k_prop)
        keys = jax.random.split(k_delta, max(len(names), 1))
        moves = {name: jax.random.normal(k, (N, 3), jnp.float32) for k, name in zip(keys, names)}
    else:
        moves = JG.sample_graph(kernel.proposal.model, k_prop, (N,))
    u_mh = jax.random.uniform(k_fwd, (N,))
    u_res = jax.random.uniform(k_res, ())
    return ({k: torch.as_tensor(np.array(v)) for k, v in moves.items()},
            torch.as_tensor(np.array(u_mh)), torch.as_tensor(np.array(u_res)))


def _inject(monkeypatch, draws):
    """Hand the port's step the JAX draws in ``draws`` (a one-element list
    the test refills before each step)."""
    inner_deltas, inner_mh, inner_res = TS.adaptive_deltas, TS.mh_kernel, TS.maybe_resample
    log = {"accepted": 0, "rejected": 0, "resampled": 0}

    def deltas(state, names, sigmas, quaternion_names, normals):
        return inner_deltas(state, names, sigmas, quaternion_names, draws[0][0])

    def mh(u, proposal, new, old):
        u = draws[0][1]
        out = inner_mh(u, proposal, new, old)
        same = (out.log_prob == new.log_prob) & (out.log_prob != old.log_prob)
        log["accepted"] += int(same.sum())
        log["rejected"] += int((out.log_prob == old.log_prob).sum())
        return out

    def resample(u, state, threshold):
        log["resampled"] += int(bool(state.log_relative_ess < threshold))
        return inner_res(draws[0][2], state, threshold)

    monkeypatch.setattr(TS, "adaptive_deltas", deltas)
    monkeypatch.setattr(TS, "mh_kernel", mh)
    monkeypatch.setattr(TS, "maybe_resample", resample)
    monkeypatch.setattr(TS, "propose",
                        lambda generator, proposal, previous:
                        TPr.apply_draws(proposal, previous, draws[0][0]))
    return log


def _assert_states_close(j, t, step, kind):
    where = f"{KERNELS[kind]}, step {step}"
    assert float(t.temperature) == pytest.approx(float(j.temperature), abs=0), where
    np.testing.assert_allclose(t.log_weights.numpy(), np.asarray(j.log_weights),
                               atol=WEIGHT_ATOL, err_msg=where)
    np.testing.assert_allclose(float(t.log_evidence), float(j.log_evidence), atol=WEIGHT_ATOL,
                               err_msg=where)
    np.testing.assert_allclose(float(t.log_relative_ess), float(j.log_relative_ess),
                               atol=WEIGHT_ATOL, err_msg=where)
    np.testing.assert_allclose(t.sample.variables["t"].numpy(),
                               np.asarray(j.sample.variables["t"]), atol=PARTICLE_ATOL,
                               err_msg=where)
    np.testing.assert_allclose(t.sample.variables["r"].numpy(),
                               np.asarray(j.sample.variables["r"]), atol=PARTICLE_ATOL,
                               err_msg=where)
    np.testing.assert_allclose(t.sample.log_like.numpy(), np.asarray(j.sample.log_like),
                               rtol=1e-3, atol=0.1, err_msg=where)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", [0, 1, 2])
def test_smc_mh_kernel_steps_match_with_injected_draws(model, kind, seed, monkeypatch):
    j_smc = JES.smc_mh(model["params"], model["j_post"]).samplers[kind]
    t_smc = TES.smc_mh(model["t_params"], model["t_post"]).samplers[kind]
    assert type(t_smc.kernel).__name__ == type(j_smc.kernel).__name__
    jstate, tstate = _initial_states(model, seed)
    draws = [None]
    log = _inject(monkeypatch, draws)
    rngs = Rngs.from_seed(0, "cpu")
    for step, key in enumerate(jax.random.split(jax.random.PRNGKey(50 + 10 * kind + seed),
                                                STEPS)):
        draws[0] = _jax_draws(j_smc, key)
        _, jstate = j_smc.step(key, model["j_post"], jstate)
        _, tstate = t_smc.step(rngs, model["t_post"], tstate)
        _assert_states_close(jstate, tstate, step, kind)
    # the steps took both MH outcomes, and resampled in some step and not in others
    assert log["accepted"] > 0 and log["rejected"] > 0, log
    assert 0 < log["resampled"] < STEPS, log
