"""The benchmark cell ``track_bootstrap.synth120`` (the bootstrap particle
filter at 1,250 particles) on the CPU, at the benchmark's own test size
(``portbench/tests/conftest.py``'s ``tiny_cell``: 16 particles, 2 clips of
6 frames at 40x30; at that size checked frames resample, some after
uniform weights, so that ``resample`` judges their draws), held against
the plain reference (``portbench/reference``) through the harness's
``run_cell``.

A sound run is correct; each planted fault makes it not correct: the
harness's three (``portbench/tools/faults.py``) and two that break the
resample alone, planted here:

* ``resample_uniform``: ``systematic_resampling_indices`` draws as if every
  weight were equal;
* ``resample_skipped``: ``maybe_resample`` sets the weights to uniform and
  draws nothing.

Both keep every particle once, so they leave the same population. Of
``track``'s numbers none catches either: the frame's likelihoods are
sound (``loglike`` 0), its weights uniform as after any resample
(``weights`` ~1e-6) and the estimate the plain mean on both sides
(``estimate`` ~1e-6); only ``resample`` reads them (0.47-1.03 nats in each
of the first four requests of six seeds at this size, a sound run 0). The
bf16 control fails a number. The filters count their runs, frames and
scored poses by kind while telemetry is on, and report nothing while it is
off.
"""

import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_profile
from bayesianposeestimation.jl_tpu_torch import telemetry
from bayesianposeestimation.jl_tpu_torch.samplers import smc
from portbench import calibrate
from portbench.reference.checks import bootstrap
from portbench.run import run_cell
from portbench.tests.conftest import tiny_cell
from portbench.tools import faults

CELL = "track_bootstrap.synth120"


@pytest.fixture(autouse=True)
def telemetry_off():
    telemetry.disable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()


def resample_uniform(monkeypatch):
    real = smc.systematic_resampling_indices
    monkeypatch.setattr(smc, "systematic_resampling_indices",
                        lambda log_weights, u, shard=None:
                        real(torch.zeros_like(log_weights), u, shard))


def resample_skipped(monkeypatch):
    def skipped(u, state, threshold, shard=None):
        uniform = torch.full_like(state.log_weights, -math.log(state.log_weights.shape[-1]))
        do = state.log_relative_ess < threshold
        return smc.SmcState(state.sample, torch.where(do, uniform, state.log_weights),
                            state.log_evidence, state.temperature, state.log_relative_ess)

    monkeypatch.setattr(smc, "maybe_resample", skipped)


FAULTS = {**{k: faults.FAULTS[k] for k in ("state_unchanged", "half_batch", "answer_altered")},
          "resample_uniform": resample_uniform, "resample_skipped": resample_skipped}


def _run(seed=20250101):
    cell, config = tiny_cell(CELL)
    result, _, _ = run_cell(cell, config, seed, 0.5, False, "cpu")
    assert result["attempted"] >= 1
    return result


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["checks"]["resample"]["value"] == 0.0


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = _run()
    assert not result["correct"], result["checks"]
    if fault.startswith("resample"):
        checks = result["checks"]
        assert checks["resample"]["value"] > checks["resample"]["limit"], checks


def test_tiny_cell_resamples_after_uniform_weights():
    """The checked frames of the runs below include a draw that ``resample``
    judges: a frame resampled after uniform weights."""
    cell, config = tiny_cell(CELL)
    _, records, _, _, _ = calibrate.window(cell, config, 20250101, "cpu", 0.0)
    judged = [r for r in records
              if float(r["log_relative_ess"]) < math.log(config["parameters"]["relative_ess"])
              and bool((r["previous_log_weights"] == r["previous_log_weights"][0]).all())]
    assert judged


def test_control_fails_a_number():
    cell, config = tiny_cell(CELL)
    limits = cell["check"]["limits"]
    out = calibrate.readings(cell, config, 77, "cpu", True, 0.0)
    assert all(out["program"][k] <= limits[k] for k in limits), out
    assert any(out["control"][k] > limits[k] for k in limits), out


def test_kind_loads_neither_the_port_nor_jax():
    """The kind and the reference it reads, imported alone."""
    code = ("import sys; import portbench.reference.check as c; c.kind_module('bootstrap'); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('bayesianposeestimation', 'jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[1], check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def _systematic(ell, u):
    """The plain systematic draw: indices [N] for weights ∝ exp(ell)."""
    n = ell.numel()
    cdf = torch.cumsum(torch.softmax(ell.double(), 0), 0)
    return torch.searchsorted(cdf / cdf[-1], (u + torch.arange(n, dtype=torch.float64)) / n
                              ).clamp(max=n - 1)


@pytest.mark.parametrize("draw, previous, sound", [
    ("systematic", "uniform", True), ("each_once", "uniform", False),
    ("other_likelihood", "uniform", False), ("systematic", "spread", True),
    ("each_once", "spread", False)])
def test_draw_gap_separates_draws(draw, previous, sound):
    """``draw_gap`` on 200 particles whose log-weights spread over 6 nats
    (their log-likelihoods, after uniform or spread previous weights): 0 for
    a systematic draw on them, over half a nat for each particle kept once
    (a draw that ignores them, or none; judged after spread weights too, as
    each survivor then stands at its own place) or a draw on another
    likelihood."""
    gen = torch.Generator().manual_seed(3)
    n = 200
    ell = 6.0 * torch.rand(n, generator=gen, dtype=torch.float64) - 2000.0
    prev = torch.full((n,), -math.log(n), dtype=torch.float64)
    if previous == "spread":
        prev = torch.log_softmax(-ell + 2.0 * torch.rand(n, generator=gen, dtype=torch.float64), 0)
        ell = ell + 4.0 * torch.rand(n, generator=gen, dtype=torch.float64)
    t = torch.randn(n, 3, generator=gen)
    r = torch.randn(n, 4, generator=gen)
    idx = {"systematic": _systematic(prev + ell, 0.37), "each_once": torch.arange(n),
           "other_likelihood": _systematic((prev + ell).flip(0), 0.37)}[draw]
    gap = bootstrap.draw_gap(t[idx], r[idx], ell[idx], prev)
    assert (gap == 0.0) if sound else gap > 0.5, gap


@pytest.mark.parametrize("name, per_frame", [("track_coordinate.synth120", 2), (CELL, 1)])
def test_filter_counts_by_kind(name, per_frame):
    """``chip_profile.py telemetry`` on the cell at the test size: the
    window's runs, frames stepped and poses scored, by filter kind."""
    cell, config = tiny_cell(name)
    out = chip_profile.telemetry_cell(name, 20250106, 0.5, "cpu", cell, config)
    pf = out["telemetry"]["pf"]
    kind = config["filter"]
    runs = out["attempted"]
    frames = runs * (cell["traffic"]["n_frames"] - 1)
    assert out["correct"] and pf == {f"{kind}/runs": runs, f"{kind}/frames": frames,
                                     f"{kind}/poses_scored": frames * 16 * per_frame}


def test_nothing_counted_while_off():
    """With telemetry off a listener hears no filter count, and the cell's
    run is the same."""
    heard = []

    def listen(key, n):
        heard.append(key)

    telemetry.add_listener(listen)
    try:
        result = _run()
    finally:
        telemetry.remove_listener(listen)
    assert result["correct"] and heard and not [k for k in heard if k[0] == "pf"]
