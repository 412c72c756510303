"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; the lower-precision control fails a number.
The harness's look for a card is skipped: the rest of a run (set-up,
window, check) runs on the CPU at a test size (``tiny_cell``)."""

import pytest
import torch

from bayesianposeestimation.jl_tpu_torch import capture
from bayesianposeestimation.jl_tpu_torch.models import fused
from bayesianposeestimation.jl_tpu_torch.samplers import smc
from portbench import calibrate
from portbench.run import run_cell

CELLS = ["synthcad_smc_mh.bop", "track_coordinate.synth120"]


def _run(tiny, name):
    cell, config = tiny(name)
    result, _, found = run_cell(cell, config, 20250101, 0.5, False, "cpu")
    assert found == [] and result["attempted"] >= 1
    return result


def _unchanged(monkeypatch):
    """Every SMC step returns the state it was given."""
    monkeypatch.setattr(smc.SequentialMonteCarlo, "step",
                        lambda self, rngs, model, old: (old.sample, old))


def _half_batch(monkeypatch):
    """The likelihood of the first half of the poses; the rest get its mean."""
    real = fused.render_score

    def half(verts, faces, cam, t, q, *args, **kw):
        n = t.shape[0]
        k = max(1, n // 2)
        ell, sum_o = real(verts, faces, cam, t[:k].contiguous(), q[:k].contiguous(), *args, **kw)
        return (torch.cat([ell, ell.mean().expand(n - k)]),
                torch.cat([sum_o, sum_o.mean().expand(n - k)]))

    monkeypatch.setattr(fused, "render_score", half)


def _altered_answer(monkeypatch):
    """The chain's last poses moved by 5 mm where they are produced."""
    real = capture.ChainRunner.run

    def run(self, *args, **kw):
        outs, final = real(self, *args, **kw)
        outs["t"][-1] += 0.005
        return outs, final

    monkeypatch.setattr(capture.ChainRunner, "run", run)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tiny):
    result = _run(tiny, name)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_answer],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch, tiny):
    fault(monkeypatch)
    result = _run(tiny, name)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_number(name, tiny):
    cell, config = tiny(name)
    limits = cell["check"]["limits"]
    out = calibrate.readings(cell, config, 77, "cpu", True, 0.0)
    assert all(out["program"][k] <= limits[k] for k in limits), out
    assert any(out["control"][k] > limits[k] for k in limits), out


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_its_host_metrics(name, tiny):
    cell, config = tiny(name)
    cell["trace"].update(skip=1, requests=1)
    result, _, _ = run_cell(cell, config, 20250102, 1.5, True, "cpu")
    assert result["correct"] and "breakdown" in result
    # without a card the slice holds host events only: no kernel, no launch
    metrics = result["metrics"]
    host = "prep_ms.pose" if name.startswith("synthcad") else "host_calls_per_frame.track"
    assert host in metrics and not any("roofline" in k for k in metrics)
