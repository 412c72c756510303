"""The MH move after its draws (``samplers/mh.py`` ``mh_transition``): the
proposal's likelihood regularizer and point prior, tempering, the previous
sample re-tempered, the MH test and its select, and for SMC the weight
increment.

On the card, where the move allows it (``mh_move_path``), it is one kernel
after the render (``ops/mh_move.py``, ``csrc/smc_update.cu``); every other
move, and every move of CPU tensors or of a sharded step, runs the plain
version (``mh_transition_plain``), the code the steps always ran. On the CPU
these tests hold the plain version and the steps bitwise to that code
written out, check which moves may take the kernel and that each move counts
its path once, run the kernel's path with the kernel's arithmetic written in
plain PyTorch in the wrapper's place, check the wrapper's arguments and the
comparison ``chip_smoke.py``'s phase 20 makes, on the plain version with
planted faults. The tests marked ``card`` need a CUDA card and skip without
one: the kernel against the plain version on the same tensors
(``parity_cases.mh_move_cases``) and captured chains bitwise against their
eager loops with the kernel in both. Run them on the card with ``python3 -m
pytest tests/test_torch_mh_move.py -m card --noconftest -p no:cacheprovider``
(this file imports no JAX; the suite's conftest does).
"""

import math
import re
import types
from pathlib import Path

import pytest
import torch

import parity_cases
from bayesianposeestimation.jl_tpu_torch import capture, telemetry
from bayesianposeestimation.jl_tpu_torch.distributions import Normal, QuaternionUniform
from bayesianposeestimation.jl_tpu_torch.graph import BroadcastedNode, sequentialize
from bayesianposeestimation.jl_tpu_torch.models import experiment_samplers as TES
from bayesianposeestimation.jl_tpu_torch.models import particle_filter as TPF
from bayesianposeestimation.jl_tpu_torch.ops import cuda_raster
from bayesianposeestimation.jl_tpu_torch.ops import mh_move as ops_move
from bayesianposeestimation.jl_tpu_torch.posterior import retemper
from bayesianposeestimation.jl_tpu_torch.proposals import (
    additive_proposal,
    independent_proposal,
    propose,
)
from bayesianposeestimation.jl_tpu_torch.rngs import Rngs
from bayesianposeestimation.jl_tpu_torch.samplers import mh, sample_chain, smc
from bayesianposeestimation.jl_tpu_torch.samples import Sample
from portbench.trace import RASTER_KERNELS

PROPOSALS = parity_cases.MH_MOVE_PROPOSALS
CASES = parity_cases.MH_MOVE_CASES


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the move kernel has no CPU form")
    return "cuda"


def _equal(a, b):
    sa, la = capture.tree_leaves(a)
    sb, lb = capture.tree_leaves(b)
    assert sa == sb
    for x, y in zip(la, lb):  # bitwise, NaN where NaN
        assert torch.equal(x, y) or torch.allclose(x, y, rtol=0, atol=0, equal_nan=True)


def _paths(fn):
    """``fn()``'s ``("mh_move_path", *)`` counts, in order."""
    seen = []

    def listen(key, n):
        if key[0] == "mh_move_path":
            seen.extend([key[1]] * n)

    telemetry.add_listener(listen)
    try:
        fn()
    finally:
        telemetry.remove_listener(listen)
    return seen


# -- the plain version ---------------------------------------------------------


def _old_smc_step(sampler, rngs, model, old_state):
    """``SequentialMonteCarlo.step`` as it ran before the move had a name."""
    gen = rngs.device
    new_temp = sampler.temp_schedule.increment(old_state.temperature)
    proposed = sampler.kernel.propose(gen, old_state)
    proposed = model.tempered_logdensity_sample(proposed, new_temp)
    old_retempered = retemper(old_state.sample, old_state.temperature, new_temp)
    new_sample = sampler.kernel.forward(gen, proposed, old_retempered)
    incr = sampler.kernel.incremental_weights(new_sample, new_temp, old_state)
    dtype = torch.result_type(old_state.log_weights, incr)
    u = torch.rand((), generator=gen, dtype=dtype, device=gen.device)
    new = smc.update_population(old_state, incr, new_sample, new_temp, u,
                                sampler.log_relative_ess_threshold)
    return new.sample, new


def _old_mh_step(sampler, rngs, model, state):
    """``MetropolisHastings.step`` as it ran before the move had a name."""
    gen = rngs.device
    new_temp = sampler.temp_schedule.increment(state.temperature)
    previous = retemper(state.sample, state.temperature, new_temp)
    proposed = propose(gen, sampler.proposal, previous)
    u = torch.rand(previous.log_prob.shape, generator=gen, dtype=previous.log_prob.dtype,
                   device=gen.device)
    proposed = model.tempered_logdensity_sample(proposed, new_temp)
    result = mh.mh_kernel(u, sampler.proposal, proposed, previous)
    return result, mh.MCMCState(result, new_temp)


@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("factory", ["smc_mh", "mh_sampler"])
def test_steps_equal_the_sequence_they_ran_before(factory, kind):
    """Four steps of each branch of ``smc_mh`` and ``mh_sampler`` on the CPU,
    each from the same generator state through the step and through the
    sequence the step ran before the move went through ``mh_transition``:
    bitwise; the steps took moves, and the MH steps also rejected some (an
    SMC step's resampling hides its rejections)."""
    params, post = parity_cases.cube_posterior("cpu", observed=True)
    sampler = getattr(TES, factory)(params, post).samplers[kind]
    old = _old_smc_step if factory == "smc_mh" else _old_mh_step
    rngs = Rngs.from_seed(3, "cpu")
    _, state = sampler.init(rngs, post, 8)
    accepted = rejected = 0
    for _ in range(4):
        gen_state = rngs.device.get_state()
        got = sampler.step(rngs, post, state)
        rngs.device.set_state(gen_state)
        _equal(got, old(sampler, rngs, post, state))
        before = state.sample.variables["t"], state.sample.variables["r"]
        after = got[0].variables["t"], got[0].variables["r"]
        stayed = torch.all(before[0] == after[0], 1) & torch.all(before[1] == after[1], 1)
        accepted, rejected = accepted + int((~stayed).sum()), rejected + int(stayed.sum())
        state = got[1]
    assert accepted > 0 and (rejected > 0 or factory == "smc_mh"), (accepted, rejected)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("proposal", PROPOSALS)
def test_plain_move_equals_its_parts(proposal, case):
    """``mh_transition_plain`` and, for CPU tensors, ``mh_transition`` are
    bitwise the parts the steps called: the proposal's tempered density,
    ``retemper``, ``mh_kernel`` and the increment (ϕ' - ϕ)·ℓ_like."""
    inp = parity_cases.mh_move_inputs("cpu", 100, proposal, case)
    post, prop, new_temp = inp["posterior"], inp["proposal"], inp["new_temp"]
    proposed = post.tempered_logdensity_sample(inp["proposed"], new_temp)
    previous = retemper(inp["previous"], inp["old_temp"], new_temp)
    expected = (mh.mh_kernel(inp["u"], prop, proposed, previous),
                (new_temp - inp["old_temp"]) * inp["previous"].log_like)
    args = (post, prop, inp["proposed"], inp["previous"], inp["old_temp"], new_temp, inp["u"])
    _equal(mh.mh_transition_plain(*args, increment=True), expected)
    assert _paths(lambda: _equal(mh.mh_transition(*args, increment=True), expected)) == [
        "plain"]
    _equal(mh.mh_transition_plain(*args)[0], expected[0])


@pytest.mark.parametrize("fault", ["none", "path", "row", "log_prob", "log_like", "incr",
                                   "decision"])
def test_phase20_comparison_sees_planted_faults(fault):
    """``parity_cases.compare_mh_move`` on the CPU with the plain version in
    the kernel's place: it passes the plain version, and fails another path,
    a particle's t taken from another particle, a log_prob or log_like one
    unit in the last place off, an increment off by one unit, a flipped
    accept decision."""
    inp = parity_cases.mh_move_inputs("cpu", 100, "t_walk", "random")
    plain = parity_cases.mh_move_plain(inp)
    sample, incr = plain[0], plain[1].clone()
    t, r = sample.variables["t"].clone(), sample.variables["r"].clone()
    lp, ll = sample.log_prob.clone(), sample.log_like.clone()
    path = "plain" if fault == "path" else "kernel"
    if fault == "row":
        t[5] = t[6]
    elif fault == "log_prob":
        lp[3] = torch.nextafter(lp[3], torch.tensor(math.inf))
    elif fault == "log_like":
        ll[4] = torch.nextafter(ll[4], torch.tensor(-math.inf))
    elif fault == "incr":
        incr[7] = torch.nextafter(incr[7], torch.tensor(math.inf))
    elif fault == "decision":
        prev = inp["previous"]
        took = ~torch.all(t == prev.variables["t"], 1)
        i = int(torch.nonzero(took)[0])
        t[i], r[i] = prev.variables["t"][i], prev.variables["r"][i]
    out = (Sample({"t": t, "r": r}, lp, ll), incr, path)
    res = parity_cases.compare_mh_move(inp, out, plain)
    assert res["ok"] == (fault == "none"), res


# -- which moves may take the kernel ---------------------------------------------


_CUDA = torch.device("cuda", 0)


def _fake(dtype=torch.float32):
    """What ``mh_move_path`` reads of a tensor on a card: device and dtype."""
    return types.SimpleNamespace(device=_CUDA, dtype=dtype)


def _fake_sample(names=("t", "r")):
    return Sample({k: _fake() for k in names}, _fake(), _fake())


def _fake_like(sample):
    """``sample`` as ``mh_move_path`` would see it on a card."""
    return Sample({k: _fake(v.dtype) for k, v in sample.variables.items()}, _fake(), _fake())


def _on_card(post):
    """``post`` as the step sees it on a card: its prior rows there."""
    if post.move_prior is not None:
        post.move_prior = (_fake(), _fake())
    return post


def _path_case(case):
    params, post = parity_cases.cube_posterior("cpu")
    t_walk, r_walk, r_ind = TES._proposals(params, post, False)
    proposal, model, shard, u = t_walk, _on_card(post), None, _fake()
    proposed, previous = _fake_sample(), _fake_sample()
    if case in ("r_walk", "r_independent"):
        proposal = r_walk if case == "r_walk" else r_ind
    elif case == "cpu tensors":
        u = torch.zeros(8)
    elif case == "sharded":
        shard = smc.ParticleShard(None, 0, 1, 8)
    elif case == "simple_reg posterior":
        model = _on_card(parity_cases.cube_posterior("cpu", variant="simple")[1])
    elif case == "velocity-state prior":
        params, exp, _ = _stream_inputs()
        model = _on_card(TPF.fused_pf_posterior("simple")(params, exp, device="cpu"))
    elif case == "graph posterior":
        model = types.SimpleNamespace(params=params)
    elif case == "additive proposal":
        proposal = additive_proposal(
            sequentialize(BroadcastedNode("t", Normal, 0.001, 0.01)), post)
    elif case == "independent Normal proposal":
        proposal = independent_proposal(
            sequentialize(BroadcastedNode("t", Normal, 0.0, 1.0)), post)
    elif case == "dynamics proposal":
        proposal = TPF.Dynamics("t", 0.9, 0.01)
    elif case == "float64 uniforms":
        u = _fake(torch.float64)
    elif case == "velocity variables":
        proposed = previous = _fake_sample(("t", "r", "t_dot", "r_dot"))
    return mh.mh_move_path(model, proposal, proposed, previous, u, shard)


def _stream_inputs(device="cpu"):
    import numpy as np

    from bayesianposeestimation.jl_tpu_torch import convert
    from bayesianposeestimation.jl_tpu_torch.utils import mesh_io

    mesh = mesh_io.cube_mesh(0.1)
    cam = convert.camera_from_fields(width=24, height=24, f_x=28.8, f_y=28.8, c_x=11.5,
                                     c_y=11.5, near=0.01, far=10.0)
    frames = np.zeros((3, 24, 24), np.float32)
    exp = convert.experiment_from_numpy(cam, mesh.vertices, mesh.faces, 0.7, [0.0, 0.0, 1.0],
                                        frames[0])
    params = convert.parameters_from_fields(width=24, height=24, n_particles=24,
                                            device=device)
    return params, exp, convert.stream_from_numpy(frames, device)


PATH_CASES = {"t_walk": "kernel", "r_walk": "kernel", "r_independent": "kernel",
              "cpu tensors": "plain", "sharded": "plain", "simple_reg posterior": "plain",
              "velocity-state prior": "plain", "graph posterior": "plain",
              "additive proposal": "plain", "independent Normal proposal": "plain",
              "dynamics proposal": "plain", "float64 uniforms": "plain",
              "velocity variables": "plain"}


@pytest.mark.parametrize("case", list(PATH_CASES))
def test_path_is_kernel_only_where_the_kernel_computes_the_plain_move(case):
    """``mh_move_path`` on tensors as a card holds them: the kernel for
    ``smc_mh``'s and ``mh_sampler``'s three proposals on the fused point-prior
    posterior; the plain version for CPU tensors, a sharded step, a fixed-o
    or velocity-state posterior, a graph posterior, a proposal whose
    transition terms vary or that brings its own, other dtypes or
    variables."""
    assert _path_case(case) == PATH_CASES[case]


def test_move_prior_only_for_the_point_prior_and_the_npixel_likelihood():
    """``FusedPosterior.move_prior`` is the point prior's rows (the very
    tensors its density reads) for the npixel variants, and None for the
    fixed-o variants and the particle filter's prior graph."""
    for variant in ("association", "smooth", "simple", "no_exp", "association_simple_reg"):
        params, post = parity_cases.cube_posterior("cpu", variant=variant)
        if post.simple_reg:
            assert post.move_prior is None, variant
        else:
            node = post.graph["t"]
            assert post.move_prior[0] is node.args[0] and post.move_prior[1] is node.args[1]
    params, exp, _ = _stream_inputs()
    assert TPF.fused_pf_posterior("simple")(params, exp, device="cpu").move_prior is None


def test_constant_terms_are_the_plain_functions():
    """The transition terms the kernel takes for a proposal are what
    ``acceptance_ratio`` adds: 0 for the symmetric walks, the plain
    function's fp32 density for the independent QuaternionUniform draws."""
    from bayesianposeestimation.jl_tpu_torch.proposals import transition_probability

    params, post = parity_cases.cube_posterior("cpu")
    t_walk, r_walk, r_ind = TES._proposals(params, post, False)
    assert mh._constant_terms(t_walk) == mh._constant_terms(r_walk) == (0.0, 0.0)
    inp = parity_cases.mh_move_inputs("cpu", 5, "r_independent", "random")
    q = transition_probability(r_ind, inp["proposed"], inp["previous"])
    assert torch.equal(q, torch.full((5,), mh._constant_terms(r_ind)[0]))
    ind = independent_proposal(
        sequentialize(BroadcastedNode("r", QuaternionUniform, torch.float64)), post)
    assert mh._constant_terms(ind) is None


@pytest.mark.parametrize("name, moves", [("smc_mh", 1), ("mh_sampler", 1), ("smc_bootstrap", 0),
                                         ("smc_forward", 0), ("mtm_sampler", 0),
                                         ("coordinate_pf", 0), ("bootstrap_pf", 0)])
def test_every_mh_move_counts_its_path_once(name, moves):
    """A chain counts ``("mh_move_path", "plain")`` once a step on the CPU
    where its step is an MH move, and nothing where it is not: the
    bootstrap and forward-proposal SMC kernels, multiple-try and both
    trackers."""
    if name.endswith("_pf"):
        params, exp, depth = _stream_inputs()
        pf = TPF.coordinate_pf if name == "coordinate_pf" else TPF.bootstrap_pf
        steps = depth.shape[0] - 1
        seen = _paths(lambda: pf(0, TPF.fused_pf_posterior("simple"), params, exp, depth,
                                 device="cpu", captured=False))
    else:
        params, post = parity_cases.cube_posterior("cpu", observed=True)
        steps = 5
        seen = _paths(lambda: sample_chain(0, post, getattr(TES, name)(params, post), 6, 8,
                                           device="cpu", captured=False))
    assert seen == ["plain"] * (moves * steps)


def test_sharded_step_never_reaches_the_wrapper(monkeypatch):
    """A sharded ``smc_mh`` chain (one process, collectives as identities)
    runs every move through the plain version, even where the path would
    allow the kernel: the wrapper, patched to raise, is never called."""
    def refused(*a, **kw):
        raise AssertionError("a sharded step reached the move kernel's wrapper")

    def all_gather(parts, x, group=None):
        parts[0].copy_(x)

    monkeypatch.setattr(mh, "mh_move", refused)
    monkeypatch.setattr(smc.dist, "all_reduce", lambda x, op=None, group=None: None)
    monkeypatch.setattr(smc.dist, "all_gather", all_gather)
    from bayesianposeestimation.jl_tpu_torch.parallel.sharded import shard_sampler

    params, post = parity_cases.cube_posterior("cpu", observed=True)
    sampler = shard_sampler(TES.smc_mh(params, post), smc.ParticleShard(None, 0, 1, 8))
    seen = _paths(lambda: sample_chain(0, post, sampler, 6, 8, device="cpu", captured=False))
    assert seen == ["plain"] * 5


# -- the kernel's path, its arithmetic written in plain PyTorch ---------------------


def _kernel_in_torch(ell_raw, sum_o, prop_t, prop_r, prev_t, prev_r, prev_log_prob,
                     prev_log_like, u, old_temp, new_temp, prior_t, sigma_t, c_reg,
                     q_backward=0.0, q_forward=0.0, increment=False):
    """``ops/mh_move.mh_move``'s arguments and results, computed as
    ``mh_move_kernel`` computes them (steps 1-7 of its comment), elementwise
    in plain PyTorch; the prior's three terms summed by torch's own sum of
    the device, which the kernel follows on the card."""
    ops_move.check_inputs(ell_raw, sum_o, prop_t, prop_r, prev_t, prev_r, prev_log_prob,
                          prev_log_like, u, old_temp, new_temp, prior_t, sigma_t, c_reg,
                          q_backward, q_forward)
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32)
    safe = torch.where(sum_o == 0, torch.ones_like(sum_o), sum_o)
    like = torch.where(sum_o == 0, torch.full_like(ell_raw, -math.inf),
                       (1.0 / safe) * torch.tensor(c_reg, dtype=f32) * ell_raw)
    z = (prop_t - prior_t) / sigma_t
    terms = (z * -0.5) * z - torch.log(sigma_t) - torch.tensor(ops_move._HALF_LOG_2PI)
    prior = terms.sum(-1) + torch.tensor(ops_move._LOG_R_DENSITY)
    log_prob = prior + torch.where(new_temp > 0, new_temp * like, zero)
    delta = new_temp - old_temp
    prev = prev_log_prob + torch.where(delta != 0, delta * prev_log_like, zero)
    alpha = ((log_prob - prev) + torch.tensor(q_backward, dtype=f32)) - torch.tensor(
        q_forward, dtype=f32)
    accept = torch.log(u) <= alpha
    return (torch.where(accept[:, None], prop_t, prev_t),
            torch.where(accept[:, None], prop_r, prev_r),
            torch.where(accept, log_prob, prev), torch.where(accept, like, prev_log_like),
            delta * prev_log_like if increment else None)


@pytest.fixture
def kernel_path_on_cpu(monkeypatch):
    """The kernel's path taken for CPU tensors, the wrapper's arithmetic
    written in plain PyTorch (``_kernel_in_torch``)."""
    real = mh.mh_move_path

    def cpu_as_card(model, proposal, proposed, previous, u, shard=None):
        if shard is not None:
            return "plain"
        prior = model.move_prior
        model.move_prior = None if prior is None else (_fake(), _fake())
        try:
            return real(model, proposal, _fake_like(proposed), _fake_like(previous),
                        _fake(u.dtype), shard)
        finally:
            model.move_prior = prior

    monkeypatch.setattr(mh, "mh_move_path", cpu_as_card)
    monkeypatch.setattr(mh, "mh_move", _kernel_in_torch)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("proposal", PROPOSALS)
def test_kernel_path_wires_the_plain_move(kernel_path_on_cpu, proposal, case):
    """``mh_transition``'s kernel path (the render's sums, the prior rows,
    the transition terms, the outputs in the sample's order) on the CPU with
    the kernel's arithmetic in the wrapper's place: phase 20's comparison
    passes, the path counted is ``kernel``."""
    inp = parity_cases.mh_move_inputs("cpu", 100, proposal, case)
    plain = parity_cases.mh_move_plain(inp)
    out = []
    assert _paths(lambda: out.append(parity_cases.mh_move_kernel(inp))) == ["kernel"]
    res = parity_cases.compare_mh_move(inp, out[0], plain)
    assert res["ok"], res


@pytest.mark.parametrize("factory", ["smc_mh", "mh_sampler"])
def test_kernel_path_chains_equal_the_plain_chains(kernel_path_on_cpu, factory, monkeypatch):
    """Six-step ``smc_mh`` and ``mh_sampler`` chains on the CPU through the
    kernel's path (its arithmetic in plain PyTorch) equal the plain chains
    bitwise, one kernel move a step."""
    params, post = parity_cases.cube_posterior("cpu", observed=True)
    sampler = getattr(TES, factory)(params, post)
    out = []
    assert _paths(lambda: out.append(sample_chain(0, post, sampler, 6, 8, device="cpu",
                                                  captured=False))) == ["kernel"] * 5
    monkeypatch.undo()
    _equal(out[0], sample_chain(0, post, sampler, 6, 8, device="cpu", captured=False))


# -- the wrapper ---------------------------------------------------------------


def _wrapper_args(n=8):
    f = torch.float32
    z = torch.zeros
    return [z(n, dtype=f), z(n, dtype=f), z((n, 3), dtype=f), z((n, 4), dtype=f),
            z((n, 3), dtype=f), z((n, 4), dtype=f), z(n, dtype=f), z(n, dtype=f),
            torch.full((n,), 0.5, dtype=f), z((), dtype=f), z((), dtype=f), z(3, dtype=f),
            torch.full((3,), 0.03, dtype=f), 50.0]


BAD = {
    "float64 sums": (lambda a: a.__setitem__(0, a[0].double()), TypeError),
    "sum_o of another length": (lambda a: a.__setitem__(1, a[1][:5]), ValueError),
    "t of width 4": (lambda a: a.__setitem__(2, torch.zeros(8, 4)), ValueError),
    "non-contiguous r": (lambda a: a.__setitem__(3, torch.zeros(4, 8).t()), ValueError),
    "previous log_prob of another length": (lambda a: a.__setitem__(6, torch.zeros(9)),
                                            ValueError),
    "uniforms a row": (lambda a: a.__setitem__(8, torch.zeros(1, 8)), ValueError),
    "temperature not a scalar": (lambda a: a.__setitem__(9, torch.zeros(1)), ValueError),
    "prior mean of 2": (lambda a: a.__setitem__(11, torch.zeros(2)), ValueError),
    "sigma of another dtype": (lambda a: a.__setitem__(12, torch.zeros(3, dtype=torch.int32)),
                               TypeError),
    "c_reg on a device": (lambda a: a.__setitem__(13, torch.tensor(50.0)), TypeError),
    "no particles": (lambda a: a.__setitem__(0, torch.zeros(0)), ValueError),
}


@pytest.mark.parametrize("bad", list(BAD))
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    args = _wrapper_args()
    change, error = BAD[bad]
    change(args)
    with pytest.raises(error):
        ops_move.mh_move(*args)


def test_wrapper_runs_no_plain_version_for_cpu_tensors():
    """Valid CPU tensors raise: the kernel has no quiet fallback; a scalar
    prior passes the checks too."""
    args = _wrapper_args()
    assert ops_move.check_inputs(*args) == 8
    scalar = args[:11] + [torch.zeros(()), torch.full((), 0.03)] + args[13:]
    assert ops_move.check_inputs(*scalar, q_backward=-3.0, q_forward=-3.0) == 8
    with pytest.raises(TypeError):
        ops_move.check_inputs(*args, q_backward=torch.tensor(0.0))
    before = ops_move.mh_move.launches
    with pytest.raises(ValueError, match="unsupported device"):
        ops_move.mh_move(*args)
    assert ops_move.mh_move.launches == before


def test_kernel_source_mirrors_the_wrapper():
    """The C entry point takes the arguments the wrapper's ctypes binding
    declares, in number and kind; the kernel is built in the raster kernels'
    library (one nvcc run) and its name is no name the benchmark's trace
    counts as ``render_score``'s."""
    src = Path(cuda_raster.__file__).resolve().parents[1] / "csrc" / "smc_update.cu"
    text = src.read_text()
    sig = re.search(r'extern "C" int bpe_mh_move\((.*?)\)\s*\{', text, re.S).group(1)
    kinds = ["p" if "*" in arg else "i" if arg.split()[0] == "int" else "f"
             for arg in (a.strip() for a in sig.split(","))]
    binding = re.search(r"fn\.argtypes = \[(.*?)\]", Path(ops_move.__file__).read_text(),
                        re.S).group(1)
    assert kinds == [a.strip() for a in binding.split(",")]
    assert src in cuda_raster._SOURCES
    assert "mh_move_kernel" in text
    assert not any(k in "mh_move_kernel" for k in RASTER_KERNELS)


# -- on the card -------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("proposal", PROPOSALS)
@pytest.mark.parametrize("n", parity_cases.MH_MOVE_SIZES)
def test_kernel_matches_the_plain_version_on_the_card(card, n, proposal):
    """Phase 20's comparison (``parity_cases.mh_move_cases``): the move
    through the kernel against the plain version on the same card tensors in
    every case of ``parity_cases.MH_MOVE_CASES``, bitwise."""
    for case, res in parity_cases.mh_move_cases(card, n, proposal):
        assert res["ok"], (case, res)


@pytest.mark.card
@pytest.mark.parametrize("factory, n", [("smc_mh", 100), ("mh_sampler", 1)])
def test_captured_mh_chains_equal_eager_on_the_card(card, factory, n):
    """A captured chain (its moves replayed from CUDA graphs) is bitwise the
    eager loop, both through the move kernel, one launch a step."""
    params, post = parity_cases.cube_posterior(card, n_particles=n, n_steps=40, observed=True)
    sampler = getattr(TES, factory)(params, post)
    before = ops_move.mh_move.launches
    eager = sample_chain(0, post, sampler, 40, n, device=card, captured=False)
    assert ops_move.mh_move.launches - before == 39
    captured = sample_chain(0, post, sampler, 40, n, device=card)
    _equal(captured, eager)
    assert ops_move.mh_move.launches - before == 78


@pytest.mark.card
@pytest.mark.parametrize("kind", ["bootstrap", "coordinate"])
def test_trackers_make_no_mh_move_on_the_card(card, kind):
    """Both filters on the card, eager and captured, count no MH move."""
    params, exp, depth = _stream_inputs(card)
    pf = TPF.coordinate_pf if kind == "coordinate" else TPF.bootstrap_pf
    for captured in (False, True):
        assert _paths(lambda: pf(0, TPF.fused_pf_posterior("simple"), params, exp, depth,
                                 device=card, captured=captured)) == []
