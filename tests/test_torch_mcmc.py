"""Port parity: the MCMC samplers (MetropolisHastings, MultipleTry), the
chain runner for their states, the sampler factories and the fused
posterior's [tries, chains] batch.

Step-for-step agreement: a JAX state carried across with
``convert.mcmc_state_from_numpy`` and the JAX step's own draws (split from
its key exactly as the JAX step splits it) handed to the port, whose
``transition`` / ``move`` take them as arguments. The model of these tests
is analytic and the same in both packages (t ~ N(t0, σ), r uniform, a point
on the object observed with 5 mm noise), so its densities agree to float32
rounding and the steps can be compared at that tolerance; the fused
posterior's batch is held against JAX's at the renderers' tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianposeestimation.jl_tpu import distributions as JD
from bayesianposeestimation.jl_tpu import graph as JG
from bayesianposeestimation.jl_tpu import proposals as JPr
from bayesianposeestimation.jl_tpu import quaternions as JQ
from bayesianposeestimation.jl_tpu.camera import CvCamera as JCam
from bayesianposeestimation.jl_tpu.models import experiment_samplers as JES
from bayesianposeestimation.jl_tpu.models.fused import fused_posterior as j_fused
from bayesianposeestimation.jl_tpu.ops.rasterize import render_depth as j_render_depth
from bayesianposeestimation.jl_tpu.parameters import Experiment as JExperiment
from bayesianposeestimation.jl_tpu.parameters import Parameters as JParameters
from bayesianposeestimation.jl_tpu.posterior import PosteriorModel
from bayesianposeestimation.jl_tpu.posterior import retemper as j_retemper
from bayesianposeestimation.jl_tpu.samplers import mh as JMH
from bayesianposeestimation.jl_tpu.samplers import mtm as JMTM
from bayesianposeestimation.jl_tpu.samples import Sample as JSample
from bayesianposeestimation.jl_tpu.tempering import LinearSchedule as JLinear
from bayesianposeestimation.jl_tpu.utils import mesh_io
from bayesianposeestimation.jl_tpu_torch import convert
from bayesianposeestimation.jl_tpu_torch import distributions as TD
from bayesianposeestimation.jl_tpu_torch import graph as TG
from bayesianposeestimation.jl_tpu_torch import proposals as TPr
from bayesianposeestimation.jl_tpu_torch import quaternions as TQ
from bayesianposeestimation.jl_tpu_torch.models import experiment_samplers as TES
from bayesianposeestimation.jl_tpu_torch.models import fused as TF
from bayesianposeestimation.jl_tpu_torch.posterior import retemper as t_retemper
from bayesianposeestimation.jl_tpu_torch.posterior import tempered_logdensity
from bayesianposeestimation.jl_tpu_torch.samplers import chain as TC
from bayesianposeestimation.jl_tpu_torch.samplers import mh as TMH
from bayesianposeestimation.jl_tpu_torch.samplers import mtm as TMTM
from bayesianposeestimation.jl_tpu_torch.samples import Sample as TSample
from bayesianposeestimation.jl_tpu_torch.tempering import ConstantSchedule as TConst
from bayesianposeestimation.jl_tpu_torch.tempering import LinearSchedule as TLinear

N = 48
T0 = np.array([0.01, -0.02, 1.0], np.float32)
SIG_T = np.array([0.03, 0.03, 0.03], np.float32)
V0 = np.array([0.04, 0.01, -0.02], np.float32)  # a point on the object
TRUE_Q = np.array([0.9, 0.3, -0.2, 0.1], np.float32) / np.linalg.norm([0.9, 0.3, -0.2, 0.1])
OBS = np.asarray(JQ.qrotate(jnp.asarray(TRUE_Q), jnp.asarray(V0))) + T0 + 0.004
OBS_SIGMA = 0.005
# float32 rounding of densities of magnitude ~1e3 and their differences
F32 = dict(rtol=1e-5, atol=2e-3)


def j_model():
    t = JG.BroadcastedNode("t", JD.Normal, jnp.asarray(T0), jnp.asarray(SIG_T))
    r = JG.BroadcastedNode("r", JD.QuaternionUniform)
    p = JG.DeterministicNode("p", lambda t, r: JQ.qrotate(r, jnp.asarray(V0)) + t, t, r)
    y = JG.BroadcastedNode("y", JD.Normal, p, OBS_SIGMA) | jnp.asarray(OBS)
    return PosteriorModel(y)


class TModel:
    """The analytic model in the port: prior graph over t and r, and the
    observed point's Normal likelihood."""

    device = torch.device("cpu")

    def __init__(self):
        self.graph = {"t": TG.BroadcastedNode("t", TD.Normal, torch.as_tensor(T0),
                                              torch.as_tensor(SIG_T)),
                      "r": TG.BroadcastedNode("r", TD.QuaternionUniform)}
        self.bijectors = TG.bijectors_of(self.graph)
        self.quaternion_names = TG.quaternion_names_of(self.graph)

    def sample_prior(self, generator, n):
        return TSample(TG.sample_graph(self.graph, generator, (n,)))

    def tempered_logdensity_sample(self, sample, temp, batch_ndim=1):
        v = sample.variables
        lp = TG.logdensityof_graph(self.graph, v, batch_ndim)
        p = TQ.qrotate(v["r"], torch.as_tensor(V0)) + v["t"]
        ll = TD.Normal(p, OBS_SIGMA).logpdf(torch.as_tensor(OBS)).sum(-1)
        return sample.set_logdensities(tempered_logdensity(lp, ll, temp), ll)


def _params():
    jp = JParameters(n_particles=8, n_steps=20, proposal_sigma_t=(0.004, 0.004, 0.004),
                     proposal_sigma_r=(0.3, 0.3, 0.3))
    tp = convert.parameters_from_fields(**{f.name: getattr(jp, f.name)
                                           for f in dataclasses.fields(jp)})
    return jp, tp.replace(device="cpu")


def _proposals(kind):
    """The three moves of ``mh_sampler`` in both packages: kind 0 = t
    symmetric, 1 = r symmetric, 2 = r independent."""
    jp, tp = _params()
    jm, tm = j_model(), TModel()
    return (JES.mh_sampler(jp, jm).samplers[kind].proposal,
            TES.mh_sampler(tp, tm).samplers[kind].proposal, jm, tm)


def _state(seed, temp=0.3):
    """A JAX MCMC state near the posterior (prior draws pulled towards the
    truth) at temperature ``temp``, and the same state in the port."""
    rng = np.random.default_rng(seed)
    t = (OBS - V0 + 0.01 * rng.normal(size=(N, 3))).astype(np.float32)
    q = (TRUE_Q + 0.2 * rng.normal(size=(N, 4))).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    js = j_model().tempered_logdensity_sample(
        JSample({"t": jnp.asarray(t), "r": jnp.asarray(q)}), jnp.float32(temp))
    jstate = JMH.MCMCState(js, jnp.float32(temp))
    tstate = convert.mcmc_state_from_numpy({"t": t, "r": q}, np.asarray(js.log_prob),
                                           np.asarray(js.log_like), temp)
    return jstate, tstate


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_samples_close(a, b, **tol):
    for k in a.variables:
        np.testing.assert_allclose(_np(b.variables[k]), np.asarray(a.variables[k]), **tol)
    np.testing.assert_allclose(_np(b.log_prob), np.asarray(a.log_prob), **tol)
    np.testing.assert_allclose(_np(b.log_like), np.asarray(a.log_like), **tol)


def test_analytic_model_densities_match():
    """The two packages' test models agree to float32 rounding, also on a
    [tries, chains] batch."""
    rng = np.random.default_rng(0)
    t = (T0 + 0.02 * rng.normal(size=(5, N, 3))).astype(np.float32)
    q = rng.normal(size=(5, N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    a = j_model().tempered_logdensity_sample(JSample({"t": jnp.asarray(t), "r": jnp.asarray(q)}),
                                             0.4, batch_ndim=2)
    b = TModel().tempered_logdensity_sample(TSample({"t": torch.as_tensor(t),
                                                     "r": torch.as_tensor(q)}),
                                            torch.tensor(0.4), batch_ndim=2)
    _assert_samples_close(a, b, **F32)


@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_mh_step_matches_with_injected_draws(kind, seed):
    """One MetropolisHastings step: the previous sample re-tempered to the
    new temperature, the JAX proposal and uniforms; log α, the accepted
    sample and the densities equal to float32 tolerance."""
    jprop, tprop, jm, tm = _proposals(kind)
    jstate, tstate = _state(seed)
    jsched, tsched = JLinear(10), TLinear(10)
    key = jax.random.PRNGKey(100 + seed)
    j_res, j_new = JMH.MetropolisHastings(jprop, jsched).step(key, jm, jstate)

    k_prop, k_accept = jax.random.split(key)
    j_temp = jsched.increment(jstate.temperature)
    j_prev = j_retemper(jstate.sample, jstate.temperature, j_temp)
    j_proposed = JPr.propose(k_prop, jprop, j_prev)
    u = torch.as_tensor(np.array(jax.random.uniform(k_accept, (N,))))

    sampler = TMH.MetropolisHastings(tprop, tsched)
    t_temp = tsched.increment(tstate.temperature)
    t_prev = t_retemper(tstate.sample, tstate.temperature, t_temp)
    t_proposed = TSample({k: torch.as_tensor(np.array(v))
                          for k, v in j_proposed.variables.items()})
    t_res, t_new = sampler.transition(tm, tstate.sample, t_proposed, u, tstate.temperature,
                                      t_temp)

    j_alpha = JMH.acceptance_ratio(jprop, jm.tempered_logdensity_sample(j_proposed, j_temp),
                                   j_prev)
    t_alpha = TMH.acceptance_ratio(tprop, tm.tempered_logdensity_sample(t_proposed, t_temp),
                                   t_prev)
    np.testing.assert_allclose(_np(t_alpha), np.asarray(j_alpha), **F32)
    _assert_samples_close(j_res, t_res, **F32)
    assert float(t_new.temperature) == pytest.approx(float(j_new.temperature))
    accepted = np.log(u.numpy()) <= _np(t_alpha)
    assert 0 < accepted.sum() < N  # both outcomes occur


@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_mtm_step_matches_with_injected_draws(kind, seed, monkeypatch):
    """One MultipleTry step with JAX's try count, try and auxiliary draws,
    Gumbel noise and uniforms: the selected try, log α and the result equal
    to float32 tolerance."""
    n_tries = 6
    jprop, tprop, jm, tm = _proposals(kind)
    jstate, tstate = _state(seed)
    jsched, tsched = JLinear(10), TLinear(10)
    key = jax.random.PRNGKey(200 + seed)

    seen = {"lse": [], "idx": []}
    j_lse, j_gumbel = JMTM.logsumexp, JMTM.gumbel_index

    def lse(x, axis):
        out = j_lse(x, axis=axis)
        seen["lse"].append(np.asarray(out))
        return out

    def gumbel(k, w, axis=0):
        out = j_gumbel(k, w, axis=axis)
        seen["idx"].append(np.asarray(out))
        return out

    monkeypatch.setattr(JMTM, "logsumexp", lse)
    monkeypatch.setattr(JMTM, "gumbel_index", gumbel)
    j_res, j_new = JMTM.MultipleTry(jprop, n_tries, jsched).step(key, jm, jstate)
    j_alpha = seen["lse"][0] - seen["lse"][1]

    k_m, k_prop, k_sel, k_aux, k_acc = jax.random.split(key, 5)
    m = torch.as_tensor(int(jax.random.randint(k_m, (), 2, n_tries + 1)))

    def draws(k, n):
        return {name: torch.as_tensor(np.array(v)) for name, v in
                JG.sample_graph(jprop.model, k, (n, N)).items()}

    tries, aux = draws(k_prop, n_tries), draws(k_aux, n_tries - 1)
    noise = torch.as_tensor(np.array(jax.random.gumbel(k_sel, (n_tries, N))))
    u = torch.as_tensor(np.array(jax.random.uniform(k_acc, (N,))))

    t_idx = []
    inner = TMTM.gumbel_index
    monkeypatch.setattr(TMTM, "gumbel_index",
                        lambda g, w, axis=0: t_idx.append(inner(g, w, axis)) or t_idx[-1])
    sampler = TMTM.MultipleTry(tprop, n_tries, tsched)
    t_temp = tsched.increment(tstate.temperature)
    t_prev = t_retemper(tstate.sample, tstate.temperature, t_temp)
    selected, t_alpha = sampler.select(tm, t_prev, t_temp, m, tries, noise, aux)
    np.testing.assert_array_equal(t_idx[0].numpy(), seen["idx"][0])
    np.testing.assert_allclose(t_alpha.numpy(), j_alpha, **F32)
    assert selected.variables["t"].shape == (N, 3) and selected.variables["r"].shape == (N, 4)

    t_res, t_new = sampler.move(tm, tstate, m, tries, noise, aux, u)
    _assert_samples_close(j_res, t_res, **F32)
    assert float(t_new.temperature) == pytest.approx(float(j_new.temperature))
    accepted = np.log(u.numpy()) <= j_alpha
    assert 0 < accepted.sum() < N  # both outcomes occur


def test_mtm_try_count_masks_the_tries():
    """With m = 2 only the first two tries can be selected, and the step
    draws its try count on the generator's device (no host draw)."""
    _, tprop, _, tm = _proposals(0)
    _, tstate = _state(3)
    sampler = TMTM.MultipleTry(tprop, 6, TConst())
    gen = torch.Generator().manual_seed(0)
    tries = TG.sample_graph(tprop.model, gen, (6, N))
    aux = TG.sample_graph(tprop.model, gen, (5, N))
    noise = TMTM.gumbel_noise(gen, (6, N))
    temp = torch.ones(())
    for m in (2, 6):
        sel, alpha = sampler.select(tm, tstate.sample, temp, torch.tensor(m), tries, noise, aux)
        cand = tstate.sample.variables["t"][None] + tries["t"]
        hit = (sel.variables["t"][None] == cand).all(-1)  # [T, N]
        assert bool(hit.any(0).all())
        assert torch.isfinite(alpha).all()
        if m == 2:
            assert not bool(hit[2:].any())


def _gaussian_model(names=("x",)):
    """x ~ N(0, 1) (and z ~ N(0, 1)); y ~ N(sum of them, 0.5) observed at 1."""

    class Gaussian:
        device = torch.device("cpu")

        def __init__(self):
            self.graph = {n: TG.BroadcastedNode(n, TD.Normal, 0.0, 1.0) for n in names}
            self.bijectors = TG.bijectors_of(self.graph)
            self.quaternion_names = ()

        def sample_prior(self, generator, n):
            return TSample(TG.sample_graph(self.graph, generator, (n,)))

        def tempered_logdensity_sample(self, sample, temp, batch_ndim=1):
            v = sample.variables
            lp = TG.logdensityof_graph(self.graph, v, batch_ndim)
            s = sum(v[n] for n in names)
            ll = TD.Normal(s, 0.5).logpdf(torch.tensor(1.0))
            return sample.set_logdensities(tempered_logdensity(lp, ll, temp), ll)

    return Gaussian()


def _posterior_mean_std(obs=1.0, sigma=0.5):
    var = sigma**2 / (1 + sigma**2)
    return obs / (1 + sigma**2), np.sqrt(var)


def _run(sampler, model, n_steps, n_particles, names=("x",), seed=0):
    outs, _ = TC.sample_chain(seed, model, sampler, n_steps, n_particles, names, device="cpu")
    return outs


@pytest.mark.parametrize("sampler_kind", ["mh", "mtm_symmetric", "mtm_independent"])
def test_chains_recover_gaussian_posterior(sampler_kind):
    """Port analogues of tests/test_samplers.py's Gaussian recovery (MH, and
    MTM with symmetric and with independent tries, 8 tries): the chain's
    mean and spread after burn-in against the analytic posterior, at the JAX
    tests' tolerances."""
    model = _gaussian_model()
    node_sigma = 1.0 if sampler_kind == "mtm_independent" else 0.5
    node = TG.sequentialize(TG.BroadcastedNode("x", TD.Normal, 0.0, node_sigma))
    if sampler_kind == "mtm_independent":
        q = TPr.independent_proposal(node, model)
    else:
        q = TPr.symmetric_proposal(node, model)
    if sampler_kind == "mh":
        sampler, n_steps, n, burn, tol_m, tol_s = (TMH.MetropolisHastings(q, TConst()), 2000,
                                                   64, 500, 0.02, 0.02)
    else:
        sampler, n_steps, n, burn = TMTM.MultipleTry(q, 8, TConst()), 1500, 32, 300
        tol_m, tol_s = 0.03, (0.04 if sampler_kind == "mtm_independent" else 0.03)
    xs = _run(sampler, model, n_steps, n)["x"][burn:].numpy().ravel()
    mean, std = _posterior_mean_std()
    assert np.mean(xs) == pytest.approx(mean, abs=tol_m)
    assert np.std(xs) == pytest.approx(std, abs=tol_s)


def test_mtm_independent_subset_variables():
    """Independent MTM over one of two variables with n_tries == n_chains:
    the untouched variable is broadcast exactly once (shapes, finite)."""
    model = _gaussian_model(("x", "z"))
    q = TPr.independent_proposal(TG.sequentialize(TG.BroadcastedNode("x", TD.Normal, 0.0, 1.0)),
                                 model)
    outs = _run(TMTM.MultipleTry(q, 8, TConst()), model, 50, 8, ("x", "z"))
    assert outs["x"].shape == (49, 8) and outs["z"].shape == (49, 8)
    assert torch.isfinite(outs["log_prob"]).all()


def test_sample_chain_burn_in_and_thinning():
    """``n_burn_in`` / ``collect_every`` select the steps JAX's
    ``outs[n_burn_in::collect_every]`` selects, from the same chain."""
    model = _gaussian_model()
    q = TPr.symmetric_proposal(TG.sequentialize(TG.BroadcastedNode("x", TD.Normal, 0.0, 0.5)),
                               model)
    sampler = TMH.MetropolisHastings(q, TConst())
    full, _ = TC.sample_chain(5, model, sampler, 30, 4, ("x",), device="cpu")
    thin, final = TC.sample_chain(5, model, sampler, 30, 4, ("x",), device="cpu",
                                  collect_every=3, n_burn_in=4)
    torch.testing.assert_close(thin["x"], full["x"][4::3], rtol=0, atol=0)
    assert set(thin) == {"x", "log_prob", "log_like"}
    assert isinstance(final, TMH.MCMCState)
    assert TC.collect_variables(final, ("x",)).keys() == thin.keys()


FACTORIES = ("mh_sampler", "mh_local_sampler", "mtm_sampler", "mtm_local_sampler",
             "smc_forward", "smc_bootstrap", "smc_mh")


def _describe(sampler):
    """(sampler classes, kernel classes, weights, proposal kinds and names,
    proposal sigmas) of a composed sampler."""
    out = []
    for s in sampler.samplers:
        kernel = getattr(s, "kernel", None)
        inner = getattr(kernel, "kernel", kernel)
        prop = s.proposal if kernel is None else inner.proposal
        node = next(iter(prop.model.values()))
        sig = [np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a).tolist()
               for a in node.args]
        out.append((type(s).__name__, type(kernel).__name__ if kernel else None,
                    type(inner).__name__ if inner else None, prop.kind, prop.names, sig,
                    getattr(s, "n_tries", None), getattr(s, "n_particles", None)))
    return out, [float(w) for w in sampler.weights]


@pytest.mark.parametrize("factory", FACTORIES)
def test_factories_match_jax(factory):
    """Each factory composes the same samplers, kernels, proposals (kind,
    variables, sigmas), try and particle counts and weights as JAX's, and
    a short chain through it on the analytic model is finite."""
    jp, tp = _params()
    jm, tm = j_model(), TModel()
    j_desc = _describe(getattr(JES, factory)(jp, jm))
    t_desc = _describe(getattr(TES, factory)(tp, tm))
    assert t_desc == j_desc
    outs, _ = TC.sample_chain(1, tm, getattr(TES, factory)(tp, tm), 6, 8, device="cpu")
    assert outs["t"].shape == (5, 8, 3) and outs["r"].shape == (5, 8, 4)
    assert all(bool(torch.isfinite(v).all()) for v in outs.values())


@pytest.mark.parametrize("factory", ["mh_sampler", "mtm_sampler"])
def test_mcmc_factories_match_jax_in_distribution(factory):
    """The MCMC factories on the analytic model, 600 steps of 24 chains in
    each package: the posterior mean of the observed point and its mean
    distance to the observation agree within 1.5 mm (the point's posterior
    sd is ~3 mm per axis; t and r alone are not identified by one point)."""
    jp, tp = _params()
    jp, tp = jp.replace(n_steps=600), tp.replace(n_steps=600)
    jm, tm = j_model(), TModel()
    from bayesianposeestimation.jl_tpu.samplers import sample_chain as j_sample_chain

    jo, _ = j_sample_chain(jax.random.PRNGKey(4), jm, getattr(JES, factory)(jp, jm), 600, 24)
    to, _ = TC.sample_chain(4, tm, getattr(TES, factory)(tp, tm), 600, 24, device="cpu")

    def summary(t, r):
        t, r = np.asarray(t)[200:], np.asarray(r)[200:]
        p = np.asarray(JQ.qrotate(jnp.asarray(r), jnp.asarray(V0))) + t
        return p.reshape(-1, 3).mean(0), np.linalg.norm(p - OBS, axis=-1).mean()

    jp_mean, jerr = summary(jo["t"], jo["r"])
    tp_mean, terr = summary(to["t"].numpy(), to["r"].numpy())
    np.testing.assert_allclose(tp_mean, jp_mean, atol=1.5e-3)
    assert terr == pytest.approx(jerr, abs=1.5e-3)


@pytest.fixture(scope="module")
def cube_scene():
    """A cube at 1 m behind a 16x16 camera, its noisy render and a mask prior."""
    params = JParameters(width=16, height=16, n_particles=6, n_steps=4,
                         proposal_sigma_r=(0.5, 0.5, 0.5), pixel_sigma=0.004,
                         association_sigma=0.004, sigma_t=(0.02, 0.02, 0.02))
    mesh = mesh_io.cube_mesh(0.1)
    cam = JCam(width=16, height=16, f_x=20.0, f_y=20.0, c_x=7.5, c_y=7.5, near=0.01, far=10.0)
    gt_t = np.array([0.0, 0.0, 1.0], np.float32)
    gt_q = np.asarray(JQ.rand_quaternion(jax.random.PRNGKey(3)))
    clean = np.asarray(j_render_depth(jnp.asarray(mesh.vertices), jnp.asarray(mesh.faces), cam,
                                      jnp.asarray(gt_t), jnp.asarray(gt_q)))
    prior_o = np.where(clean > 0, params.o_mask_is, params.o_mask_not).astype(np.float32)
    t_params = convert.parameters_from_fields(**{f.name: getattr(params, f.name)
                                                 for f in dataclasses.fields(params)})
    t_cam = convert.camera_from_fields(**{f.name: float(getattr(cam, f.name))
                                          for f in dataclasses.fields(cam)})
    return dict(params=params, t_params=t_params.replace(device="cpu"), mesh=mesh, cam=cam,
                t_cam=t_cam, gt_t=gt_t, gt_q=gt_q, obs=clean, prior_o=prior_o)


def test_fused_posterior_tries_by_chains_batch(cube_scene, monkeypatch):
    """A [tries, chains] pose batch goes through one kernel call and comes
    back [tries, chains], equal to the chains evaluated try by try, and to
    JAX's batch_ndim=2 densities at the fused-posterior tolerance (rtol
    1e-3, atol 0.1, as tests/test_torch_conditioned_chain.py)."""
    sc = cube_scene
    rng = np.random.default_rng(1)
    t = (sc["gt_t"] + 0.01 * rng.normal(size=(4, 5, 3))).astype(np.float32)
    q = (sc["gt_q"] + 0.1 * rng.normal(size=(4, 5, 4))).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    j_exp = JExperiment(scene={"camera": sc["cam"], "verts": jnp.asarray(sc["mesh"].vertices),
                               "faces": jnp.asarray(sc["mesh"].faces)},
                        prior_o=jnp.asarray(sc["prior_o"]), prior_t=jnp.asarray(sc["gt_t"]),
                        depth_image=jnp.asarray(sc["obs"]))
    t_exp = convert.experiment_from_numpy(sc["t_cam"], sc["mesh"].vertices, sc["mesh"].faces,
                                          sc["prior_o"], sc["gt_t"], sc["obs"])
    post = TF.fused_posterior(sc["t_params"], t_exp, device="cpu")
    calls = []
    inner = TF.render_score
    monkeypatch.setattr(TF, "render_score",
                        lambda *a, **k: calls.append(a[3].shape) or inner(*a, **k))
    b = post.tempered_logdensity_sample(TSample({"t": torch.as_tensor(t),
                                                 "r": torch.as_tensor(q)}),
                                        torch.tensor(0.5), batch_ndim=2)
    assert calls == [(20, 3)] and b.log_prob.shape == (4, 5)
    per_try = [post.tempered_logdensity_sample(TSample({"t": torch.as_tensor(t[i]),
                                                        "r": torch.as_tensor(q[i])}),
                                               torch.tensor(0.5)) for i in range(4)]
    for k in ("log_prob", "log_like"):
        torch.testing.assert_close(getattr(b, k), torch.stack([getattr(s, k) for s in per_try]),
                                   rtol=0, atol=0)
    a = j_fused(sc["params"], j_exp).tempered_logdensity_sample(
        JSample({"t": jnp.asarray(t), "r": jnp.asarray(q)}), 0.5, batch_ndim=2)
    for k in ("log_prob", "log_like"):
        np.testing.assert_allclose(getattr(b, k).numpy(), np.asarray(getattr(a, k)),
                                   rtol=1e-3, atol=0.1)
    with pytest.raises(ValueError):
        post.tempered_logdensity_sample(TSample({"t": torch.as_tensor(t),
                                                 "r": torch.as_tensor(q)}), 0.5)


def test_tuned_chain_matches_conditioned_mh_sampler(cube_scene):
    """The port's analogue of tests/test_infra.py's tuned-chain test for
    ``mh_sampler``: hyper equal to the params reproduces the conditioned
    runner exactly (one chain), another candidate changes the result."""
    sc = cube_scene
    p = sc["t_params"]
    args = dict(verts=sc["mesh"].vertices, faces=sc["mesh"].faces, variant="association",
                sampler_factory=TES.mh_sampler, n_steps=4, n_chains=1, device="cpu")
    ref = TF.make_conditioned_chain(p, **args)
    tuned = TF.make_tuned_chain(p, **args)
    z = np.ones((16, 16), np.float32)
    o = np.full((16, 16), 0.7, np.float32)
    t0 = np.array([0.0, 0.0, 1.0], np.float32)
    hyper = {k: getattr(p, k) for k in ("pixel_sigma", "association_sigma", "sigma_t",
                                        "proposal_sigma_r")}
    outs_ref, _ = ref(7, sc["t_cam"], z, o, t0)
    outs_tuned, _ = tuned(7, sc["t_cam"], z, o, t0, hyper)
    assert outs_ref["t"].shape == (3, 1, 3)
    for k in ("t", "r", "log_like"):
        torch.testing.assert_close(outs_tuned[k], outs_ref[k], rtol=1e-6, atol=1e-6)
    hyper2 = dict(hyper, pixel_sigma=0.012, association_sigma=0.012,
                  sigma_t=(0.04, 0.04, 0.04), proposal_sigma_r=(1.5, 1.5, 1.5))
    outs2, _ = tuned(7, sc["t_cam"], z, o, t0, hyper2)
    assert not torch.allclose(outs2["log_like"], outs_tuned["log_like"])


@pytest.mark.parametrize("factory", ["mh_sampler", "mtm_sampler"])
def test_mcmc_chain_on_fused_posterior(cube_scene, factory):
    """One chain of each MCMC baseline on the fused posterior (the BOP
    sweep's configuration: one chain, n_particles tries): output shapes, and
    one kernel call per MH step, two per MTM step (tries and auxiliary
    tries), one at init."""
    sc = cube_scene
    t_exp = convert.experiment_from_numpy(sc["t_cam"], sc["mesh"].vertices, sc["mesh"].faces,
                                          sc["prior_o"], sc["gt_t"], sc["obs"])
    post = TF.fused_posterior(sc["t_params"], t_exp, device="cpu")
    calls = []
    inner = TF.FusedPosterior.prior_and_likelihood

    def counted(self, sample, *a):
        calls.append(tuple(sample.variables["t"].shape))
        return inner(self, sample, *a)

    TF.FusedPosterior.prior_and_likelihood = counted
    try:
        outs, final = TC.sample_chain(3, post, getattr(TES, factory)(sc["t_params"], post), 5, 1,
                                      device="cpu")
    finally:
        TF.FusedPosterior.prior_and_likelihood = inner
    assert outs["t"].shape == (4, 1, 3) and isinstance(final, TMH.MCMCState)
    assert all(bool(torch.isfinite(v).all()) for v in outs.values())
    if factory == "mh_sampler":
        assert calls == [(1, 3)] * 5
    else:
        tries = sc["t_params"].n_particles
        assert calls == [(1, 3)] + [(tries, 1, 3), (tries - 1, 1, 3)] * 4
