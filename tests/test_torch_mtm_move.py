"""The multiple-try move (``samplers/mtm.py``) as the benchmark cell
``synthcad_mtm.bop`` runs it, on the CPU: one ``MultipleTry.move`` on the
16x16 cube posterior with 10 tries against the benchmark's plain move
(``portbench/reference/mtm.py``) on the same injected draws, for each of
``mtm_sampler``'s three proposals at m = 2 and m = 10; the move's record as
the captured runner collects it, bitwise the eager loop's; and the
telemetry of a move: one ``mtm_move`` and 10 + 9 poses a step, and its two
profiler ranges."""

import numpy as np
import pytest
import torch

import parity_cases
from bayesianposeestimation.jl_tpu_torch import telemetry
from bayesianposeestimation.jl_tpu_torch.graph import sample_graph
from bayesianposeestimation.jl_tpu_torch.models import experiment_samplers as TES
from bayesianposeestimation.jl_tpu_torch.rngs import Rngs
from bayesianposeestimation.jl_tpu_torch.samplers import MCMCState, MtmState, sample_chain
from bayesianposeestimation.jl_tpu_torch.samplers import mtm
from portbench.reference import mtm as ref_mtm
from portbench.reference import raster
from portbench.reference.checks import loglike
from portbench.reference.checks.mcmc import prior_logdensity

TRIES, CHAINS = 10, 4
KINDS = ("t_walk", "r_walk", "r_independent")  # mtm_sampler's branches, in order


@pytest.fixture(scope="module")
def cube():
    """(params, posterior) with 10 tries; the observation's invalid pixels
    at +inf, as the image runners load them."""
    params, post = parity_cases.cube_posterior("cpu", TRIES, observed=True)
    post.depth.copy_(torch.where(post.depth <= 0, torch.full_like(post.depth, torch.inf),
                                 post.depth))
    return params, post


@pytest.fixture(autouse=True)
def telemetry_off():
    telemetry.disable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()


def _density(params, post, phi):
    """The reference's tempered log density at ϕ of poses [K, N, ...]."""
    c = post.camera
    cam = raster.camera_scalars(c.f_x, c.f_y, c.c_x, c.c_y, c.s, c.width, c.height, c.near,
                                c.far)
    p = {k: getattr(params, k) for k in ("min_depth", "max_depth", "pixel_theta",
                                         "pixel_sigma", "association_sigma", "c_reg")}
    z = post.depth.reshape(-1)
    point = post.experiment.prior_t.numpy()

    def density(t, r):
        shape = t.shape[:-1]
        ft, fr = t.reshape(-1, 3), r.reshape(-1, 4)
        ll = loglike((post.verts, post.faces), cam, ft, fr, z, 0.7, p, "association",
                     torch.float32).float()
        lp = prior_logdensity(ft, point, params.sigma_t, torch.float32)
        return (lp + phi * ll).reshape(shape)

    return density


@pytest.mark.parametrize("m", [2, TRIES])
@pytest.mark.parametrize("branch", range(3), ids=KINDS)
def test_move_matches_the_plain_move(cube, branch, m):
    """The selected try, log α, the decision and the next state as the plain
    move makes them from the same draws; the recorded tries' and reference
    set's densities as the reference scores their poses."""
    params, post = cube
    sampler = TES.mtm_sampler(params, post).samplers[branch]
    rngs = Rngs.from_seed(7 + branch, "cpu")
    _, state = sampler.init(rngs, post, CHAINS)
    gen = torch.Generator().manual_seed(100 * branch + m)
    tries = sample_graph(sampler.proposal.model, gen, (TRIES, CHAINS))
    aux = sample_graph(sampler.proposal.model, gen, (TRIES - 1, CHAINS))
    gumbel = mtm.gumbel_noise(gen, (TRIES, CHAINS))
    u = torch.rand((CHAINS,), generator=gen)
    result, new = sampler.move(post, state, torch.tensor(m), tries, gumbel, aux, u)

    phi = float(new.temperature)
    density = _density(params, post, phi)
    s = state.sample.variables
    (draws, aux_draws), = [(tries[k], aux[k]) for k in sampler.proposal.names]
    want = ref_mtm.move(density, KINDS[branch], s["t"], s["r"],
                        density(s["t"][None], s["r"][None])[0], m, draws, gumbel, aux_draws, u)
    rec = new.record
    assert isinstance(new, MtmState) and int(rec["m"]) == m
    assert torch.equal(rec["index"], want["index"]) and bool((want["index"] < m).all())
    scale = want["tries"][2][:m].abs().amax(0).clamp(min=1.0).double()
    np.testing.assert_array_less((rec["log_alpha"].double() - want["log_alpha"]).abs() / scale,
                                 1e-5)
    assert torch.equal(torch.log(u.double()) <= want["log_alpha"], want["accept"])
    assert torch.equal(rec["log_alpha"] >= torch.log(u), want["accept"])
    torch.testing.assert_close(result.variables["t"], want["t"], rtol=0, atol=0)
    torch.testing.assert_close(result.variables["r"], want["r"], rtol=0, atol=1e-7)
    for head, (t, r, d) in (("try", want["tries"]), ("ref", want["reference"])):
        torch.testing.assert_close(rec[f"{head}_t"], t, rtol=0, atol=0)
        torch.testing.assert_close(rec[f"{head}_r"], r, rtol=0, atol=1e-7)
        gap = (rec[f"{head}_log_prob"] - d).abs() / d.abs().clamp(min=1.0)
        assert float(gap.max()) < 1e-5, (head, gap)
    torch.testing.assert_close(rec["gumbel"], gumbel, rtol=0, atol=0)
    assert torch.equal(rec["u"], u)


def test_record_rows_captured_equal_eager(cube):
    """The ``mtm_*`` rows of a chain that names ``mtm.RECORD`` as the runner
    collects them equal the eager loop's bitwise, and the final state is the
    plain MCMC state in both; a chain that does not name it collects none; a
    composed sampler whose first branch is MH collects none, one whose MH
    branch follows refuses to collect the record."""
    params, post = cube
    sampler = TES.mtm_sampler(params, post)
    names = ("t", "r", mtm.RECORD)
    eager, eager_final = sample_chain(5, post, sampler, 7, 1, names, device="cpu",
                                      captured=False)
    static, final = sample_chain(5, post, sampler, 7, 1, names, device="cpu")
    rows = sorted(k for k in static if k.startswith("mtm_"))
    assert rows == sorted("mtm_" + k for k in ("try_t", "try_r", "try_log_prob", "ref_t",
                                               "ref_r", "ref_log_prob", "m", "gumbel",
                                               "index", "log_alpha", "u"))
    assert static["mtm_try_r"].shape == (6, TRIES, 1, 4)
    assert static["mtm_ref_log_prob"].shape == (6, TRIES - 1, 1)
    assert static.keys() == eager.keys()
    for k in static:
        assert torch.equal(static[k], eager[k]), k
    assert type(final) is type(eager_final) is MCMCState
    plain, _ = sample_chain(5, post, sampler, 7, 1, device="cpu")
    assert sorted(plain) == ["log_like", "log_prob", "r", "t"]
    assert torch.equal(plain["t"], static["t"])
    mh = TES.mh_sampler(params, post)
    mh_first = type(sampler)((mh.samplers[0], sampler.samplers[1]), (0.5, 0.5))
    outs, _ = sample_chain(5, post, mh_first, 7, 1, names, device="cpu")
    assert not [k for k in outs if k.startswith("mtm_")]
    mtm_first = type(sampler)((sampler.samplers[1], mh.samplers[0]), (0.5, 0.5))
    for captured in (True, False):
        with pytest.raises(KeyError, match="mtm_"):
            sample_chain(5, post, mtm_first, 7, 1, names, device="cpu", captured=captured)


def test_counters_count_a_move_and_its_poses(cube):
    """``mtm_move`` once a step by proposal, ``mtm_poses`` 10 tries and 9
    reference poses a step; nothing while telemetry is off."""
    params, post = cube
    sampler = TES.mtm_sampler(params, post)
    sample_chain(3, post, sampler, 5, 1, device="cpu")
    assert not telemetry.snapshot()["counts"]
    telemetry.enable()
    sample_chain(3, post, sampler, 9, 1, device="cpu")
    counts = telemetry.snapshot()["counts"]
    moves = {k[1]: v for k, v in counts.items() if k[0] == "mtm_move"}
    assert sum(moves.values()) == 8 and set(moves) <= {"t symmetric", "r symmetric",
                                                        "r independent"}
    assert counts[("mtm_poses", "tries")] == 8 * TRIES
    assert counts[("mtm_poses", "reference")] == 8 * (TRIES - 1)


def test_profile_names_the_selection_and_the_reference_set(cube):
    params, post = cube
    sampler = TES.mtm_sampler(params, post).samplers[0]
    rngs = Rngs.from_seed(1, "cpu")
    _, state = sampler.init(rngs, post, 1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sampler.step(rngs, post, state)
    names = {e.key for e in prof.key_averages()}
    assert {"bpe.mtm.select", "bpe.mtm.reference"} <= names
