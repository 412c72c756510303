"""The port's recorded pose times keep their budgets, and the calibration
that keeps them.

* Every table of the port's runs, ``data/exp_pro/*_cuda/*.csv``, that has a
  ``mean_pose_time`` column holds mean <= budget in every row, with no
  slack: the counterpart of ``tests/test_artifact_budgets.py`` for the JAX
  package's tables. The tables are found by glob, so a new one is covered
  without an edit.
* ``scripts/torch_smc_bop_val.py``'s ``scene_inference`` under a time
  budget, with the chain runs' wall times simulated: each run takes the
  count of the mean pace its object's last three runs realized (the three
  probe runs before the first), never above the calibrated count, and a
  run is never cut short. The simulated mean per pose stays within
  the budget where the host slows down mid-scene.
* ``scripts/torch_mcmc_benchmark.py --mode steps`` runs each config at the
  ``n_steps`` the JAX run of that config recorded, and its table carries no
  budget column.
"""

import csv
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import torch_mcmc_benchmark as mcmc  # noqa: E402
import torch_smc_bop_val as bopval  # noqa: E402

from bayesianposeestimation.jl_tpu_torch.parameters import Parameters  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils import evaluation as ev  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils.artifacts import (  # noqa: E402
    load_artifact,
    savename,
)


def _budgeted_tables():
    out = []
    for path in sorted((ROOT / "data/exp_pro").glob("*_cuda/*.csv")):
        with open(path, newline="") as fh:
            header = next(csv.reader(fh), [])
        if "mean_pose_time" in header:
            out.append(str(path.relative_to(ROOT)))
    return out


BUDGETED = _budgeted_tables()


def test_the_budgeted_tables_are_found():
    # the four budgeted sweeps: mcmc_benchmark, smc_benchmark, its synthcad
    # and steri runs
    assert len(BUDGETED) >= 4, BUDGETED


@pytest.mark.parametrize("rel", BUDGETED)
def test_recorded_pose_times_within_budget(rel):
    with open(ROOT / rel, newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert rows, f"{rel} is empty"
    budget_key = "pose_time" if "pose_time" in rows[0] else "time_budget"
    bad = [(r.get("sampler"), r.get("n_particles"), r[budget_key], r["mean_pose_time"])
           for r in rows if float(r["mean_pose_time"]) > float(r[budget_key])]
    assert not bad, f"{rel}: mean_pose_time exceeds the budget in rows {bad}"


# -- the paced step counts of scene_inference --------------------------------------

STEP_TIME, OVERHEAD, BUDGET = 1e-3, 0.004, 0.25


def _simulate(monkeypatch, pace_of_run):
    """scene_inference on synth val scene 1 (12 rows, 3 objects) with the
    chain runs replaced: run k (warm-up and probes included) of ``n``
    steps takes ``OVERHEAD + n * pace_of_run(k)`` seconds. Returns the
    result and the step counts of every run in order."""
    from bayesianposeestimation.jl_tpu_torch.models import fused

    runs = []

    def make(params, verts, faces, variant, factory, n_steps, **kw):
        def run(seed, cam, obs, prior_o, prior_t):
            runs.append(n_steps)
            shape = (n_steps, kw.get("n_chains", 1))
            return ({"t": torch.zeros(*shape, 3), "r": torch.tensor([1.0, 0, 0, 0]).expand(
                *shape, 4), "log_like": torch.zeros(shape)}, None)
        run.n_steps = n_steps
        return run

    def timed(run, device, *args):
        out = run(*args)
        return out, OVERHEAD + run.n_steps * pace_of_run(len(runs) - 1)

    monkeypatch.setattr(fused, "make_conditioned_chain", make)
    monkeypatch.setattr(ev, "mean_step_time", lambda *a, **kw: (STEP_TIME, OVERHEAD))
    monkeypatch.setattr(bopval, "_timed", timed)
    params = Parameters(n_particles=10, time_budget=BUDGET, device="cpu",
                        **bopval.TUNED_PARAMETERS)
    config = dict(sampler="smc_mh", dataset="synth", testset="val", scene_id=1)
    result = bopval.scene_inference(config, str(ROOT / "data/bop"), params, device="cpu")
    return result, runs


def test_steps_follow_the_realized_pace(monkeypatch):
    n_cal = bopval._quantize_steps(ev.steps_for_time_budget(STEP_TIME, BUDGET,
                                                            overhead=OVERHEAD))
    # the host runs 1.5x slower than the calibration saw, then, from the
    # 11th run on, 2x slower
    result, runs = _simulate(monkeypatch, lambda k: STEP_TIME * (1.5 if k < 10 else 2.0))
    rows = result["result_rows"]
    assert len(rows) == 12
    assert max(runs) == n_cal  # the warm-up and the probes run the calibrated count
    assert all(r["n_steps"] <= n_cal for r in rows)
    slow = bopval._quantize_steps(ev.steps_for_time_budget(1.5 * STEP_TIME, BUDGET,
                                                           overhead=OVERHEAD))
    assert slow < n_cal and rows[0]["n_steps"] == slow  # object 1 at its probes' pace
    # the recorded count per object is the one its first timed run took
    for key, cal in result["calibration"].items():
        assert next(r for r in rows if r["obj_id"] == int(key))["n_steps"] == cal["n_steps"]
    assert result["n_steps"] == slow
    assert np.mean([r["time"] for r in rows]) <= BUDGET
    # three 2x-slow runs of an object later, its runs take the 2x count
    slower = bopval._quantize_steps(ev.steps_for_time_budget(2.0 * STEP_TIME, BUDGET,
                                                             overhead=OVERHEAD))
    assert slower < slow and rows[-1]["n_steps"] == slower


def test_steps_stay_at_the_calibration_when_the_host_is_fast(monkeypatch):
    n_cal = bopval._quantize_steps(ev.steps_for_time_budget(STEP_TIME, BUDGET,
                                                            overhead=OVERHEAD))
    result, runs = _simulate(monkeypatch, lambda k: 0.5 * STEP_TIME)
    assert set(runs) == {n_cal}
    assert all(r["n_steps"] == n_cal for r in result["result_rows"])
    assert result["n_steps"] == n_cal


def test_realized_step_time_and_the_paced_count():
    assert ev.realized_step_time(0.5, 100, 0.1) == pytest.approx(0.004)
    assert ev.realized_step_time(0.05, 100, 0.1) == 0.0
    obj = dict(n_cal=200, overhead=0.01, paces=[])

    def steps(pace):
        return bopval._quantize_steps(ev.steps_for_time_budget(pace, 0.5, overhead=0.01))

    assert bopval._paced_steps(obj, 0.0, 0.5) == 200  # within the overhead: no pace
    assert bopval._paced_steps(obj, 1e-4, 0.5) == 200  # never above the calibration
    assert bopval._paced_steps(obj, 0.004, 0.5) == steps((1e-4 + 0.004) / 2)
    assert bopval._paced_steps(obj, 0.005, 0.5) == steps((1e-4 + 0.004 + 0.005) / 3)
    # the mean of the last three paces
    assert bopval._paced_steps(obj, 0.006, 0.5) == steps(0.005)
    assert obj["paces"] == [1e-4, 0.004, 0.005, 0.006]


# -- the MCMC benchmark at the JAX steps --------------------------------------------


def test_mcmc_steps_mode_runs_the_jax_step_counts(monkeypatch):
    args = mcmc.parse_args(["--mode", "steps", "--device", "cpu"])
    configs = mcmc.configs(args)
    assert len(configs) == 12
    jax = {c["sampler"] + str(c["n_particles"]) + str(c["pose_time"]): int(load_artifact(
        ROOT / "data/exp_raw/mcmc_benchmark" / (savename(c) + ".npz"))["n_steps"])
        for c in configs}
    steps = [mcmc.parameters(c, args).n_steps for c in configs]
    assert steps == list(jax.values())
    assert sum(steps) == 25163  # per gt, over the 12 configs
    calls = []
    monkeypatch.setattr(bopval, "run_config", lambda *a, **kw: calls.append((a, kw)))
    mcmc.run(configs[0], args)
    (name, config, params, *_), kw = calls[0]
    assert name == mcmc.STEPS_NAME and config == configs[0]
    assert kw["fixed_steps"] and params.n_steps == steps[0]
    assert kw["signature"]["n_steps"] == steps[0]
    # the time mode keeps the budget
    mcmc.run(configs[0], mcmc.parse_args(["--device", "cpu"]))
    (name, _, params, *_), kw = calls[1]
    assert name == mcmc.NAME and not kw["fixed_steps"] and "n_steps" not in kw["signature"]


def test_mcmc_steps_table_has_no_budget_columns():
    args = mcmc.parse_args(["--mode", "steps", "--device", "cpu"])
    config = mcmc.configs(args)[0]
    file = savename(config) + ".npz"
    raw = load_artifact(ROOT / "data/exp_raw/mcmc_benchmark" / file)
    errors = load_artifact(ROOT / "data/exp_pro/mcmc_benchmark/errors" / file)
    [row] = mcmc.table([(config, raw, errors)], args)
    assert row["n_steps"] == int(raw["n_steps"])
    assert "mean_pose_time" not in row and "budget_ok" not in row
    assert row["mean_run_time"] == pytest.approx(np.mean([r["time"]
                                                          for r in raw["result_rows"]]))
    [row] = mcmc.table([(config, raw, errors)], mcmc.parse_args(["--device", "cpu"]))
    assert "mean_pose_time" in row and "budget_ok" in row
