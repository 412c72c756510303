"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; the lower-precision control fails a number.
The harness's look for a card is skipped: the rest of a run (set-up,
window, check) runs on the CPU at a test size (``tiny_cell``)."""

import pytest

from portbench import calibrate
from portbench.run import run_cell
from portbench.tools import faults

CELLS = ["synthcad_smc_mh.bop", "track_coordinate.synth120", "synthcad_mh.bop"]


def _run(tiny, name):
    cell, config = tiny(name)
    result, _, found = run_cell(cell, config, 20250101, 0.5, False, "cpu")
    assert found == [] and result["attempted"] >= 1
    return result


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tiny):
    result = _run(tiny, name)
    assert result["correct"], result["checks"]


# the faults each cell can have (``tools/faults.py``): half a launch's poses
# left out needs more than one pose a launch; an MH test dropped, an MH chain
FAULTS = {"synthcad_smc_mh.bop": ("state_unchanged", "half_batch", "answer_altered"),
          "track_coordinate.synth120": ("state_unchanged", "half_batch", "answer_altered"),
          "synthcad_mh.bop": ("state_unchanged", "likelihood_moved", "answer_altered",
                              "all_accepted")}


@pytest.mark.parametrize("name, fault", [(n, f) for n in CELLS for f in FAULTS[n]],
                         ids=[f"{n}-{f}" for n in CELLS for f in FAULTS[n]])
def test_fault_is_not_correct(name, fault, monkeypatch, tiny):
    faults.FAULTS[fault](monkeypatch)
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
