"""The port's compile-once chain (``capture.ChainRunner``) on the CPU.

On the card a chain's step is captured as a CUDA graph and replayed; on the
CPU the same static-buffer step runs eagerly. These tests hold that path
bitwise against the eager loop (``sample_chain(..., captured=False)``, the
chain as it ran before it was captured) for every sampler family, and check
the replay accounting of the launch and evaluation counters on a fake
replay. The model is a fused 16x16 cube posterior (the kernel's plain
version on the CPU), small enough for a few chains per test.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

import bench_torch
import parity_cases
from bayesianposeestimation.jl_tpu_torch import capture, convert, telemetry
from bayesianposeestimation.jl_tpu_torch.models import experiment_samplers as TES
from bayesianposeestimation.jl_tpu_torch.ops import cuda_raster
from bayesianposeestimation.jl_tpu_torch.samplers import (
    ComposedSampler,
    MetropolisHastings,
    MultipleTry,
    sample_chain,
)
from bayesianposeestimation.jl_tpu_torch.samplers.chain import chain_runner
from bayesianposeestimation.jl_tpu_torch.samples import Sample
from bayesianposeestimation.jl_tpu_torch.samplers.smc import SmcState
from bayesianposeestimation.jl_tpu_torch.tempering import LinearSchedule, StepCount

N = 8


def _params(**kw):
    return convert.parameters_from_fields(
        width=16, height=16, n_particles=N, n_steps=7, proposal_sigma_r=(0.5, 0.5, 0.5),
        device="cpu", **kw)


@pytest.fixture(scope="module")
def posterior():
    """A 10 cm cube 1 m away behind a 16x16 camera, observed with noise."""
    return parity_cases.cube_posterior("cpu", N, observed=True)[1]


def _mixed(params, post, mtm_first=False):
    """A composed sampler of an MH and a multiple-try branch (the MH branch
    first, which initialises the chain, unless ``mtm_first``)."""
    mh, mtm = TES.mh_sampler(params, post), TES.mtm_sampler(params, post)
    schedule = LinearSchedule(params.n_steps)
    branches = (MetropolisHastings(mh.samplers[0].proposal, schedule),
                MultipleTry(mtm.samplers[1].proposal, 3, schedule))
    return ComposedSampler(branches[::-1] if mtm_first else branches, (0.5, 0.5))


SAMPLERS = {"smc_mh": TES.smc_mh, "mh_sampler": TES.mh_sampler,
            "mtm_sampler": TES.mtm_sampler, "smc_forward": TES.smc_forward,
            "smc_bootstrap": TES.smc_bootstrap, "composed_mh_mtm": _mixed,
            "composed_mtm_mh": lambda params, post: _mixed(params, post, mtm_first=True)}


def _assert_trees_equal(a, b):
    sa, la = capture.tree_leaves(a)
    sb, lb = capture.tree_leaves(b)
    assert sa == sb
    for x, y in zip(la, lb):  # bitwise, NaN where NaN
        assert torch.equal(x, y) or torch.allclose(x, y, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_static_buffer_chain_equals_the_eager_loop(posterior, name):
    """Outputs and final state bitwise equal to the eager loop, for each
    sampler family and a composed sampler of an MH and a multiple-try branch
    in either order; a second run on
    the cached runner with another seed equals its eager run too."""
    params = posterior.params
    sampler = SAMPLERS[name](params, posterior)
    n = 1 if name.startswith(("mh", "mtm", "composed")) else N
    for seed in (3, 4):
        eager = sample_chain(seed, posterior, sampler, 7, n, device="cpu", captured=False)
        static = sample_chain(seed, posterior, sampler, 7, n, device="cpu")
        _assert_trees_equal(static[0], eager[0])
        _assert_trees_equal(static[1], eager[1])
    assert len(vars(posterior)["_chain_runners"]) >= 1


@pytest.mark.parametrize("collect", [(1, 0), (2, 1), (3, 10)])
def test_chunks_thinning_and_burn_in(posterior, monkeypatch, collect):
    """Chunks of 3 rows over 9 steps, thinned and burnt in as the eager loop
    keeps them; a burn-in past the chain collects nothing."""
    monkeypatch.setattr(capture.ChainRunner, "CHUNK", 3)
    sampler = TES.smc_bootstrap(posterior.params, posterior)
    every, burn = collect
    kw = dict(device="cpu", collect_every=every, n_burn_in=burn)
    eager = sample_chain(5, posterior, sampler, 10, N, captured=False, **kw)
    static = sample_chain(5, posterior, sampler, 10, N, **kw)
    _assert_trees_equal(static, eager)
    if burn >= 9:
        assert static[0] == {}


def test_reseeding_and_final_state_copies(posterior):
    """A runner reseeds its own generators per run: the same seed gives the
    same chain, another seed another; the returned final state is a copy
    that the next run does not overwrite."""
    sampler = TES.smc_mh(posterior.params, posterior)
    a_outs, a_final = sample_chain(11, posterior, sampler, 5, N, device="cpu")
    kept = a_final.sample.variables["t"].clone()
    b_outs, _ = sample_chain(12, posterior, sampler, 5, N, device="cpu")
    c_outs, _ = sample_chain(11, posterior, sampler, 5, N, device="cpu")
    _assert_trees_equal(a_outs, c_outs)
    assert not torch.equal(a_outs["t"], b_outs["t"])
    assert torch.equal(a_final.sample.variables["t"], kept)


def test_step_count_schedule_equals_the_host_count():
    """``LinearSchedule`` on a device ``StepCount`` adds the same fp32
    increment as on the host int, for every count a sweep may take, and a
    StepCount set again serves another count."""
    temps = torch.linspace(0.0, 1.0, 97)
    count = StepCount("cpu")
    for n in (1, 3, 7, 96, 100, 333, 480, 1000, 3000, 4097):
        host, device = LinearSchedule(n), LinearSchedule(count.set(n))
        assert torch.equal(device.increment(temps), host.increment(temps)), n


def test_copy_tree_copies_into_the_buffers_and_refuses_another_structure():
    """The new state is copied into the static buffers, a passed-through
    buffer stays as it is; a step that changes the state's structure (a
    variable, a shape) raises."""
    a, b = torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])
    dst = Sample({"t": a, "u": b})
    capture.copy_tree(dst, Sample({"t": torch.tensor([5.0, 6.0]), "u": b}))
    assert dst.variables["t"] is a and a.tolist() == [5.0, 6.0] and b.tolist() == [3.0, 4.0]
    with pytest.raises(ValueError):
        capture.copy_tree(dst, Sample({"t": a}))
    with pytest.raises(ValueError):
        capture.copy_tree(dst, Sample({"t": a, "u": torch.zeros(3)}))


def test_smc_state_clone_has_its_own_buffers():
    """The init state shares one zero between evidence and temperature; the
    static state gets a buffer for each."""
    zero = torch.zeros(())
    s = SmcState(Sample({"t": torch.zeros(2, 3)}, torch.zeros(2), torch.zeros(2)),
                 torch.zeros(2), zero, zero, torch.zeros(()))
    c = capture.clone_tree(s)
    assert c.log_evidence is not c.temperature
    assert c.log_evidence.data_ptr() != c.temperature.data_ptr()


class _FakeGraph:
    """Stands in for a CUDA graph: a replay runs nothing on the device."""

    def replay(self):
        pass


class _FakeStepGraph(capture.StepGraph):
    """The capture protocol on the CPU: the first call runs the step (a real
    step, counted), the capture runs it once more while recording its events
    (as a CUDA capture records its kernels without reporting them), and each
    later call is a replay that reports the recorded events."""

    def __init__(self, fn, device, generator, pool=None, captured=True):
        super().__init__(fn, device, generator, pool, captured)
        self.captured = True

    def capture(self):
        self.fn()
        with telemetry.recording() as tally:
            self.fn()
        self.graph, self.tally = _FakeGraph(), dict(tally)


def test_counters_are_replay_accounted(posterior, monkeypatch):
    """Launches (a plain-version call counted as one, standing in for the
    card's kernel) and likelihood evaluations of a chain whose steps are
    replayed from a fake capture equal those of the eager loop: the capture
    counts nothing, each replay what its capture recorded."""
    reference = cuda_raster.render_score_reference

    def launching(*a, **kw):
        telemetry.count(("render_score", "association"))
        return reference(*a, **kw)

    monkeypatch.setattr(cuda_raster, "render_score_reference", launching)
    sampler = TES.smc_mh(posterior.params, posterior)
    counts = {}
    for label, graph_cls in (("eager", None), ("replayed", _FakeStepGraph)):
        if graph_cls is not None:
            monkeypatch.setattr(capture, "StepGraph", graph_cls)
            vars(posterior).pop("_chain_runners", None)
        cuda_raster.render_score.launches = 0
        cuda_raster.render_score.launches_by.clear()
        with bench_torch.EvaluationCount("cpu") as evals:
            sample_chain(2, posterior, sampler, 40, N, device="cpu",
                         captured=graph_cls is not None)
        counts[label] = (cuda_raster.render_score.launches,
                         dict(cuda_raster.render_score.launches_by), evals.n)
    runner = chain_runner(posterior, sampler, N)
    assert all(isinstance(s, _FakeStepGraph) and s.graph is not None for s in runner.steps)
    assert counts["replayed"] == counts["eager"] == (40, {"association": 40}, 40)
    cuda_raster.render_score.launches = 0
    cuda_raster.render_score.launches_by.clear()


@pytest.mark.parametrize("name", ["smc_mh", "smc_bootstrap"])
def test_update_path_counted_each_step_and_replay_accounted(posterior, monkeypatch, name):
    """Each SMC step counts its population update's path once
    (``("smc_update_path", "plain")`` on the CPU), in the eager loop and in a
    chain whose steps are replayed from a fake capture: the capture records
    it, each replay reports it again."""
    sampler = getattr(TES, name)(posterior.params, posterior)
    counts = {}
    for label, graph_cls in (("eager", None), ("replayed", _FakeStepGraph)):
        if graph_cls is not None:
            monkeypatch.setattr(capture, "StepGraph", graph_cls)
            vars(posterior).pop("_chain_runners", None)
        seen = collections.Counter()

        def listen(key, n, seen=seen):
            seen[key] += n

        telemetry.add_listener(listen)
        try:
            sample_chain(2, posterior, sampler, 40, N, device="cpu",
                         captured=graph_cls is not None)
        finally:
            telemetry.remove_listener(listen)
        counts[label] = {k: v for k, v in seen.items() if k[0] == "smc_update_path"}
    assert counts["replayed"] == counts["eager"] == {("smc_update_path", "plain"): 39}


def test_recording_nests_and_listeners_detach():
    seen = []

    def listen(key, n):
        seen.append((key, n))

    telemetry.add_listener(listen)
    try:
        telemetry.count("a")
        with telemetry.recording() as outer:
            telemetry.count("b", 2)
            with telemetry.recording() as inner:
                telemetry.count("c")
        telemetry.count("d")
    finally:
        telemetry.remove_listener(listen)
    telemetry.count("e")
    assert seen == [("a", 1), ("d", 1)]
    assert dict(outer) == {"b": 2} and dict(inner) == {"c": 1}


def test_nested_composed_sampler_is_refused(posterior):
    inner = TES.mh_sampler(posterior.params, posterior)
    outer = dataclasses.replace(inner, samplers=(inner, inner.samplers[0]),
                                weights=(0.5, 0.5))
    with pytest.raises(TypeError):
        sample_chain(0, posterior, outer, 3, 1, device="cpu")


def test_eager_loop_still_reachable_and_sampler_pick_on_host(posterior):
    """``captured=False`` is the eager loop; the composed sampler's branch
    comes from the host generator, so both paths pick alike."""
    sampler = TES.smc_mh(posterior.params, posterior)
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)

    class R:
        def __init__(self, g):
            self.host = g

    picks1 = [sampler.pick(R(g1)) for _ in range(20)]
    picks2 = [int(torch.multinomial(sampler.probs(), 1, generator=g2)) for _ in range(20)]
    assert picks1 == picks2 and set(picks1) <= {0, 1, 2}
    outs, _ = sample_chain(0, posterior, sampler, 3, N, device="cpu", captured=False)
    assert outs["t"].shape == (2, N, 3) and np.isfinite(outs["log_like"].numpy()).all()
