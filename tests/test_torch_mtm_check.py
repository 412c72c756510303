"""The benchmark cell ``synthcad_mtm.bop`` (the multiple-try baseline, one
chain a pose) on the CPU, cut to a test size: 3 tries, 10 steps a pose, 2
requests checked with every move of their chains (on the CPU the captured
runner's static-buffer step runs eagerly), held against the plain reference
(``portbench/reference``) by the check kind ``mtm``.

A sound window reads correct; each fault of a multiple-try move planted in
the port (``portbench/tools/mtm_faults.py``) reads not correct, by the
number that sees it:

* a selection that ignores the weights: ``select``;
* log α by the MH ratio of the selected try alone: ``alpha``;
* a reference set without the previous state: ``alpha``;
* the reference set scored at the tries' poses: ``tries``;
* every selected try accepted: ``decision``;
* steps that return their state: ``tries`` (the record stays empty) and
  ``stuck``.

The bf16 control fails a number. One set-up serves every window: on the
CPU a fault planted after it reaches every later step."""

import pytest

from portbench import cells
from portbench.entries import common, multiple_try_chain
from portbench.reference import check
from portbench.tools import mtm_faults

CELL = "synthcad_mtm.bop"
N_STEPS, N_TRIES, REQUESTS = 10, 3, 2


def tiny():
    cell, config = cells.load(CELL)
    config["n_steps"] = N_STEPS
    cell["traffic"]["n_particles"] = N_TRIES
    cell["check"].update(requests=REQUESTS, moves=N_STEPS - 2)
    return cell, config


@pytest.fixture(scope="module")
def entry():
    cell, config = tiny()
    e = multiple_try_chain.Entry(cell, config, 20250101, "cpu")
    e.setup()
    yield e
    e.free()


def _window(entry, control=False, seed=20250102):
    """The check's numbers of a fresh window of ``REQUESTS`` requests."""
    entry.check = common.Reservoir(REQUESTS, seed)
    for i in range(REQUESTS):
        _, ok = entry.run(i)
        assert ok
    return check.judge(entry.check_kind, entry.records(), entry.meshes(),
                       entry.check_config(), "cpu", control=control)


def _over(numbers, limits):
    return {k: numbers[k] for k in limits if numbers[k] > limits[k]}


def test_sound_window_is_correct(entry):
    limits = entry.cell["check"]["limits"]
    out = _window(entry)
    assert _over(out["program"], limits) == {}, out["program"]
    recs = entry.records()
    assert len(recs) == REQUESTS
    moves = recs[0]["moves"]
    assert moves["step"].tolist() == list(range(1, N_STEPS - 1))
    assert moves["try_t"].shape == (N_STEPS - 2, N_TRIES, 1, 3)
    assert moves["ref_r"].shape == (N_STEPS - 2, N_TRIES - 1, 1, 4)
    assert set(moves["m"].tolist()) <= {2, 3}


# the fault and the number that has to see it
SEEN_BY = {"select_ignores_weights": "select", "alpha_of_selected_try": "alpha",
           "reference_without_state": "alpha", "reference_scored_at_tries": "tries",
           "all_accepted": "decision", "state_unchanged": "tries"}


@pytest.mark.parametrize("fault", list(SEEN_BY))
def test_fault_is_not_correct(entry, fault, monkeypatch):
    limits = entry.cell["check"]["limits"]
    mtm_faults.FAULTS[fault](monkeypatch)
    over = _over(_window(entry)["program"], limits)
    assert SEEN_BY[fault] in over, over


def test_control_fails_a_number(entry):
    limits = entry.cell["check"]["limits"]
    out = _window(entry, control=True)
    assert _over(out["program"], limits) == {}
    assert _over(out["control"], limits), out["control"]
