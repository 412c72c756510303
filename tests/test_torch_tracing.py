"""The port's telemetry on the CPU: spans and counters inside the captured
runner, the per-image runner and the tracker.

Off (the default), a run reads no clock, keeps no span and reports no count
beyond the launches and evaluations it always reports. On, it gives the
same outputs bitwise, and a chain replayed through the fake capture of
tests/test_torch_captured_chain.py reports its steps and the picks of each
branch; its spans nest under one request, each self time within its span.
"""

import time
import types

import numpy as np
import pytest
import torch
from test_torch_captured_chain import _FakeStepGraph

from bayesianposeestimation.jl_tpu_torch import capture, convert, telemetry
from bayesianposeestimation.jl_tpu_torch.models import experiment_samplers as TES
from bayesianposeestimation.jl_tpu_torch.models import particle_filter as TPF
from bayesianposeestimation.jl_tpu_torch.models.fused import make_conditioned_chain
from bayesianposeestimation.jl_tpu_torch.ops import cuda_raster
from bayesianposeestimation.jl_tpu_torch.utils import mesh_io

N_STEPS = 9


@pytest.fixture(autouse=True)
def telemetry_off():
    """Every test starts and ends with telemetry off and empty."""
    telemetry.disable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()


def _image():
    """A 16x16 crop of a 10 cm cube 1 m away, observed with noise."""
    mesh = mesh_io.cube_mesh(0.1)
    cam = convert.camera_from_fields(width=16, height=16, f_x=20.0, f_y=20.0, c_x=7.5, c_y=7.5,
                                     near=0.01, far=10.0)
    t = torch.tensor([[0.01, -0.02, 1.0]])
    q = torch.tensor([[0.9, 0.1, 0.3, -0.2]])
    clean = cuda_raster.render_depth(torch.as_tensor(mesh.vertices, dtype=torch.float32),
                                     torch.as_tensor(mesh.faces, dtype=torch.int32), cam, t,
                                     q / q.norm(), device="cpu")[0].numpy()
    noise = np.random.default_rng(0).normal(0.0, 0.004, clean.shape)
    obs = np.where(clean > 0, clean + noise, 0.0).astype(np.float32)
    return mesh, cam, obs, np.array([0.02, -0.01, 1.01], np.float32)


def _image_runs(seeds=(3, 4), captured=True):
    """``smc_mh`` through one per-image runner, one call per seed."""
    mesh, cam, obs, prior_t = _image()
    params = convert.parameters_from_fields(width=16, height=16, n_particles=8,
                                            n_steps=N_STEPS, proposal_sigma_r=(0.5, 0.5, 0.5),
                                            device="cpu")
    run = make_conditioned_chain(params, mesh.vertices, mesh.faces, "association",
                                 TES.smc_mh, N_STEPS, device="cpu", captured=captured)
    return [run(seed, cam, obs, 0.7, prior_t) for seed in seeds]


def _tracker_run(seed=2, n_frames=5, captured=True):
    """The coordinate filter over a 24x24 stream of a drifting cube."""
    mesh = mesh_io.cube_mesh(0.1)
    cam = convert.camera_from_fields(width=24, height=24, f_x=28.8, f_y=28.8, c_x=11.5,
                                     c_y=11.5, near=0.01, far=10.0)
    s = torch.linspace(0, 1, n_frames)[:, None]
    t = torch.tensor([[0.0, 0.0, 1.0]]) + s * torch.tensor([[0.03, -0.02, 0.04]])
    q = torch.cat([torch.ones(n_frames, 1), 0.15 * s, torch.zeros(n_frames, 1), 0.05 * s], 1)
    clean = cuda_raster.render_depth(torch.as_tensor(mesh.vertices, dtype=torch.float32),
                                     torch.as_tensor(mesh.faces, dtype=torch.int32), cam, t,
                                     q / q.norm(dim=1, keepdim=True), device="cpu").numpy()
    frames = np.where(clean > 0, clean, 0.0).astype(np.float32)
    exp = convert.experiment_from_numpy(cam, mesh.vertices, mesh.faces, 0.7, t[0].numpy(),
                                        frames[0])
    params = convert.parameters_from_fields(
        width=24, height=24, n_particles=16, relative_ess=0.5,
        proposal_sigma_t=(0.005, 0.005, 0.005), proposal_sigma_r=(0.05, 0.05, 0.05),
        device="cpu")
    return TPF.coordinate_pf(seed, TPF.fused_pf_posterior("simple"), params, exp,
                             convert.stream_from_numpy(frames, "cpu"), device="cpu",
                             captured=captured)


def _equal(a, b):
    sa, la = capture.tree_leaves(a)
    sb, lb = capture.tree_leaves(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert torch.equal(x, y) or torch.allclose(x, y, rtol=0, atol=0, equal_nan=True)


RUNS = {"image": _image_runs, "tracker": _tracker_run}


@pytest.mark.parametrize("path", list(RUNS))
def test_off_reads_no_clock_and_keeps_nothing(path, monkeypatch):
    """Off, a run opens no span (none is even made), reads no clock and
    reports only what it always reports: the evaluations, the path of each
    SMC population update and, where the chain makes MH moves (the image
    runner's ``smc_mh``, not the tracker), the path of each move."""
    def refused(*a, **kw):
        raise AssertionError("read or made while telemetry is off")

    seen = []

    def listen(key, n):
        seen.append(key)

    telemetry.add_listener(listen)
    monkeypatch.setattr(telemetry, "_Span", refused)
    monkeypatch.setattr(time, "perf_counter_ns", refused)
    try:
        RUNS[path]()
    finally:
        telemetry.remove_listener(listen)
    moves = {("mh_move_path", "plain")} if path == "image" else set()
    assert set(seen) == {("evaluation", "cpu"), ("smc_update_path", "plain")} | moves
    snap = telemetry.snapshot()
    assert snap["spans"] == [] and not snap["counts"] and snap["dropped"] == 0
    assert telemetry.span("a") is telemetry.span("b")


@pytest.mark.parametrize("path", list(RUNS))
def test_outputs_bitwise_equal_on_and_off(path):
    """The static-buffer runs with telemetry off and on and the eager loop
    (``captured=False``) with it on give the same outputs, bitwise."""
    off = RUNS[path]()
    telemetry.enable()
    on = RUNS[path]()
    _equal(on, off)
    _equal(RUNS[path](captured=False), off)
    assert telemetry.snapshot()["counts"][("runner", "steps")] > 0


def test_replayed_chain_reports_steps_and_picks(monkeypatch):
    """A chain of n steps, its steps replayed from the fake capture, reports
    n - 1 steps and picks by branch that sum to n - 1; one capture per
    branch it picked; the host times are counted."""
    monkeypatch.setattr(capture, "StepGraph", _FakeStepGraph)
    telemetry.enable()
    _image_runs(seeds=(5,))
    counts = telemetry.snapshot()["counts"]
    picks = {key[2]: n for key, n in counts.items() if key[:2] == ("runner", "picks")}
    assert counts[("runner", "steps")] == N_STEPS - 1
    assert sum(picks.values()) == N_STEPS - 1 and set(picks) == {0, 1, 2}
    assert counts[("graph", "captures")] == sum(1 for n in picks.values() if n)
    assert counts[("runner", "replay_ns")] > 0 and counts[("runner", "pick_ns")] > 0
    assert counts[("runner", "chunk_ns")] > 0 and counts[("runner", "feed_ns")] == 0
    assert counts[("evaluation", "cpu")] > 0


def _children(spans, i):
    return [s["name"] for s in spans if s["parent"] == i]


def test_image_spans_nest_under_one_request():
    """image.call > image.load (image.build the first time) and runner.run >
    runner.start, runner.advance, runner.gather, each call its own request;
    every self time lies between 0 and the span's duration."""
    telemetry.enable()
    _image_runs()
    spans = telemetry.snapshot()["spans"]
    roots = [i for i, s in enumerate(spans) if s["parent"] == -1]
    assert [spans[i]["name"] for i in roots] == ["image.call", "image.call"]
    assert len({spans[i]["request"] for i in roots}) == 2
    for k, root in enumerate(roots):
        assert _children(spans, root) == ["image.load", "runner.run"]
        load, run = (i for i, s in enumerate(spans) if s["parent"] == root)
        assert _children(spans, load) == (["image.build"] if k == 0 else [])
        assert _children(spans, run) == ["runner.start", "runner.advance", "runner.gather"]
    for i, s in enumerate(spans):
        assert s["request"] == spans[max(r for r in roots if r <= i)]["request"]
        assert 0 <= s["self_ns"] <= s["end_ns"] - s["start_ns"]


def test_tracker_spans_and_frame_feed():
    """pf.run > pf.runner, runner.run; a step per tracked frame, each fed."""
    telemetry.enable()
    _tracker_run(n_frames=5)
    snap = telemetry.snapshot()
    spans, counts = snap["spans"], snap["counts"]
    assert spans[0]["name"] == "pf.run" and spans[0]["parent"] == -1
    assert _children(spans, 0) == ["pf.runner", "runner.run"]
    assert counts[("runner", "steps")] == 4 and counts[("runner", "feed_ns")] > 0
    assert counts[("runner", "picks", 0)] == 4


def test_span_list_is_bounded(monkeypatch):
    """Past ``SPAN_LIMIT`` a span is counted as dropped; a child of a dropped
    span keeps its request."""
    monkeypatch.setattr(telemetry, "SPAN_LIMIT", 2)
    telemetry.enable()
    with telemetry.span("a"):
        with telemetry.span("b"):
            with telemetry.span("c"):
                with telemetry.span("d"):
                    pass
    snap = telemetry.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["a", "b"] and snap["dropped"] == 2
    assert snap["spans"][1]["parent"] == 0
    assert snap["spans"][0]["self_ns"] == (snap["spans"][0]["end_ns"] - snap["spans"][0]["start_ns"]
                                           - (snap["spans"][1]["end_ns"]
                                              - snap["spans"][1]["start_ns"]))


def test_counts_kept_only_while_on_and_reset():
    telemetry.count("x")
    telemetry.enable()
    telemetry.count("x", 2)
    with telemetry.span("r"):
        pass
    telemetry.disable()
    telemetry.count("x", 5)
    snap = telemetry.snapshot()
    assert snap["counts"] == {"x": 2} and [s["name"] for s in snap["spans"]] == ["r"]
    telemetry.reset()
    assert telemetry.snapshot()["spans"] == [] and not telemetry.snapshot()["counts"]


def test_profiler_sees_the_spans_and_step_ranges():
    """Under torch.profiler each span is a ``bpe.`` range, and each step's
    pick and replay (the eager step on the CPU) are ranges too."""
    telemetry.enable()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _image_runs(seeds=(6,))
    names = {e.name for e in prof.events()}
    assert {"bpe.image.call", "bpe.image.load", "bpe.runner.run", "bpe.runner.start",
            "bpe.runner.advance", "bpe.runner.gather", "bpe.step.pick",
            "bpe.step.replay", "bpe.step.chunk"} <= names


@pytest.mark.parametrize("built", [True, False], ids=["compiled", "loaded"])
def test_library_build_is_a_span_and_a_count(built, tmp_path, monkeypatch):
    """The kernel library's build is the span ``library.build`` and counts
    whether nvcc ran or a build of the same source was loaded (nvcc and the
    loader stand in here)."""
    monkeypatch.setattr(cuda_raster, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_raster.shutil, "which", lambda name: __file__)

    def nvcc(cmd, **kw):
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return types.SimpleNamespace(returncode=0, stderr="")

    monkeypatch.setattr(cuda_raster.subprocess, "run", nvcc)
    monkeypatch.setattr(cuda_raster.ctypes, "CDLL", lambda path: types.SimpleNamespace(
        bpe_render_score=types.SimpleNamespace(), bpe_render_depth=types.SimpleNamespace()))
    if not built:
        cuda_raster.build_library.__wrapped__()  # the first build, before telemetry is on
    telemetry.enable()
    cuda_raster.build_library.__wrapped__()
    snap = telemetry.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["library.build"]
    assert snap["counts"] == {("library", "compiled" if built else "loaded"): 1}


@pytest.mark.parametrize("name", ["synthcad_smc_mh.bop", "track_coordinate.synth120"])
def test_benchmark_cell_with_telemetry_on(name):
    """``chip_profile.py telemetry`` at a test size on the CPU: the cell
    stays correct, its steps and requests are counted, the named parts of a
    step are the loop's own, and telemetry is off again after it."""
    import parity_cases
    from portbench import cells

    cell, config = cells.load(name)
    if config["entry"] == "conditioned_chain":
        config["n_steps"] = 5
        cell["traffic"]["n_particles"] = 4
        per_request = 4
    else:
        config["n_particles"] = 16
        cell["traffic"].update(n_clips=2, n_frames=6, width=40, height=30)
        cell["check"]["frames"] = 3
        per_request = 5
    cell["check"]["requests"] = 2
    out = parity_cases.telemetry_cell(name, 20250106, 0.5, "cpu", cell, config)
    t = out["telemetry"]
    assert out["correct"] and out["failed"] == 0 and t["requests"] == out["attempted"] >= 1
    assert t["steps"] == per_request * t["requests"] and t["dropped"] == 0
    assert t["runner_host_us"] > 0 and t["replay_call_us"] > 0
    assert 0 < t["parts_share_of_loop"] <= 1 and t["setup_capture_s"] == 0
    assert ("image.load" in t["request_ms"]) == (per_request == 4)
    assert not telemetry.enabled() and telemetry.snapshot()["spans"] == []
