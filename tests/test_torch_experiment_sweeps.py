"""Port parity of the dissertation's experiment sweeps: the sweep scripts
``scripts/torch_{smc_benchmark,smc_benchmark_steri,mcmc_benchmark,
mcmc_baseline,smc_mh_baseline,smc_mh_resolution,smc_observation,
smc_priors}.py`` against the JAX package's checked-in runs of
``scripts/<same name>.py`` (51 estimate artifacts under data/exp_raw/, their
errors and tables under data/exp_pro/).

* Config parity: at the arguments each JAX run used (read off its
  artifacts' ``__config__``), a script's config list names exactly the JAX
  artifacts, config for config, and stores the same ``__signature__`` where
  the JAX script stores one.
* Table parity: a script's table code fed the JAX package's own estimates
  and errors reproduces the checked-in CSV: every shared column equal
  (recalls, counts, Wilson intervals, times, ``budget_ok``).
* The steri script makes a missing data set with the port's generator
  before its sweep.
* Evaluation parity on the CPU, one synth-model artifact per experiment:
  ``evaluate_scene`` of the port on the JAX estimates against the JAX errors
  under phase 7a's gates (visibilities equal, ADD-S within 1e-5 relative,
  VSD and VSDBOP within 0.005). 19 of the 46 synth artifacts' checked-in
  errors are not what the JAX package's evaluation computes today (an
  earlier VSD; for one MTM run, earlier estimates; for one, an ADD-S entry
  1.9e-5 off by rounding):
  ``scripts/reevaluate_errors.py`` keeps today's JAX errors of those in
  ``tests/fixtures/reevaluated_errors.npz``, which is then the reference,
  and one of them is recomputed here by the JAX package. The synthcad
  artifacts (81,920-128,000-face models) are evaluated on the card only
  (``chip_smoke.py`` phase 14a).
"""

import csv
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch_smc_bop_val as bopval  # noqa: E402
from parity_cases import SWEEP_EXPERIMENTS  # noqa: E402  (the JAX runs' arguments)

from bayesianposeestimation.jl_tpu_torch.parameters import Parameters  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils.artifacts import (  # noqa: E402
    canonical_signature,
    load_artifact,
    savename,
)

RAW, PRO = ROOT / "data/exp_raw", ROOT / "data/exp_pro"
REEVALUATED = ROOT / "tests/fixtures/reevaluated_errors.npz"
ADDS_REL_TOL = 1e-5
VSD_ABS_TOL = 0.005
# one synth-model artifact of each experiment for the CPU evaluation
CPU_ARTIFACTS = {
    "smc_benchmark": "n_particles=250,pose_time=0.25",
    "smc_benchmark_steri": "pose_time=0.25",
    "mcmc_benchmark": "n_particles=40,pose_time=0.25",
    "mcmc_baseline": "sampler=mh_sampler",
    "smc_mh_baseline": "variant=simple",
    "smc_mh_resolution": "resolution=15",
    "smc_observation": "variant=simple",
    "smc_priors": "prior=point,",
}
WITH_TABLE = [n for n, (_, _, table) in SWEEP_EXPERIMENTS.items() if table]


def _configs(name):
    """The script of an experiment, the module whose sweep it runs (the
    steri script runs torch_smc_benchmark's), its arguments and configs."""
    script_name, argv, _ = SWEEP_EXPERIMENTS[name]
    script = importlib.import_module(script_name)
    module = (importlib.import_module("torch_smc_benchmark")
              if script_name == "torch_smc_benchmark_steri" else script)
    args = script.parse_args([*argv, "--device", "cpu"])
    return module, args, module.configs(args)


def _signature(module, args):
    if module.__name__ == "torch_smc_benchmark":
        return module.tuned(args)
    if module.__name__ == "torch_mcmc_benchmark":
        return dict(bopval.SWEEP_TUNED)
    return None


def _jax(name, config):
    file = savename(config) + ".npz"
    return load_artifact(RAW / name / file), load_artifact(PRO / name / "errors" / file)


def _read_csv(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def _same(ours, theirs):
    try:
        return float(ours) == pytest.approx(float(theirs), rel=1e-12, abs=0)
    except ValueError:
        return str(ours) == theirs


@pytest.mark.parametrize("name", list(SWEEP_EXPERIMENTS))
def test_configs_name_the_jax_artifacts(name):
    module, args, configs = _configs(name)
    jax = {p.name: load_artifact(p) for p in (RAW / name).glob("*.npz")}
    assert len(configs) == len(jax) > 0
    assert {savename(c) + ".npz" for c in configs} == set(jax)
    sig = _signature(module, args)
    for config in configs:
        stored = jax[savename(config) + ".npz"]
        assert stored["__config__"] == config
        if "__signature__" in stored:
            assert canonical_signature(sig) == stored["__signature__"]
        else:
            assert sig is None


@pytest.mark.parametrize("name", WITH_TABLE)
def test_table_reproduces_the_jax_csv(name):
    module, args, configs = _configs(name)
    rows = module.table([(c, *_jax(name, c)) for c in configs], args)
    theirs = _read_csv(PRO / name / SWEEP_EXPERIMENTS[name][2])
    assert len(rows) == len(theirs)
    shared = [k for k in theirs[0] if k in rows[0]]
    assert len(shared) >= 4, shared
    for ours, ref in zip(rows, theirs):
        for key in shared:
            assert _same(ours[key], ref[key]), (key, ours[key], ref[key])


def _reference(name, file):
    """The JAX errors of one artifact: today's re-evaluation where the
    checked-in errors are not reproduced by it, else the checked-in ones."""
    key = f"{name}/{file}"
    with np.load(REEVALUATED) as f:
        if f"{key}/vsd" in f.files:
            return {k: f[f"{key}/{k}"] for k in ("adds", "vsd", "vsdbop", "visib")}, True
    return load_artifact(PRO / name / "errors" / file), False


_PORT_ERRORS = {}


def _port_errors(name, file):
    if (name, file) not in _PORT_ERRORS:
        raw = load_artifact(RAW / name / file)
        _PORT_ERRORS[name, file] = bopval.evaluate_scene(
            raw["__config__"], str(ROOT / "data/bop"), Parameters(device="cpu"),
            list(raw["result_rows"]), device="cpu")
    return _PORT_ERRORS[name, file]


def _artifact(name):
    tag = CPU_ARTIFACTS[name]
    [file] = [p.name for p in (RAW / name).glob("*.npz") if tag in p.name]
    return file


@pytest.mark.parametrize("name", list(CPU_ARTIFACTS))
def test_evaluate_scene_matches_jax_errors(name):
    file = _artifact(name)
    ours = _port_errors(name, file)
    ref, _ = _reference(name, file)
    if "visib" in ref:
        np.testing.assert_array_equal(ours["visib"], ref["visib"])
    for key in ("adds", "vsd", "vsdbop"):
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        assert a.shape == b.shape, key
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
        fin = np.isfinite(b)
        if key == "adds":
            np.testing.assert_allclose(a[fin], b[fin], rtol=ADDS_REL_TOL, atol=0)
        else:
            np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=VSD_ABS_TOL)


def test_reevaluated_errors_are_the_jax_package_today():
    """The fixture's entry of smc_priors' point-prior run against the JAX
    package's evaluate_scene run now, and the checked-in errors it replaces
    against both: ADD-S (the same estimates) agrees, VSD does not."""
    import smc_bop_val

    from bayesianposeestimation.jl_tpu.parameters import Parameters as JParameters

    name, file = "smc_priors", _artifact("smc_priors")
    ref, reevaluated = _reference(name, file)
    assert reevaluated
    raw = load_artifact(RAW / name / file)
    jax_now = smc_bop_val.evaluate_scene(raw["__config__"], str(ROOT / "data/bop"),
                                         JParameters(), list(raw["result_rows"]))
    for key in ("adds", "vsd", "vsdbop", "visib"):
        np.testing.assert_allclose(np.asarray(jax_now[key]), ref[key], rtol=1e-6, atol=1e-6)
    stale = load_artifact(PRO / name / "errors" / file)
    np.testing.assert_allclose(stale["adds"], ref["adds"], rtol=ADDS_REL_TOL)
    assert np.abs(stale["vsd"] - ref["vsd"]).max() > VSD_ABS_TOL


def test_steri_script_generates_a_missing_data_set(tmp_path, monkeypatch):
    """Where --bop-dir lacks synth_steri/val, the script runs the port's
    generator into it at the JAX script's seed (a process of its own, on
    --device), then the sweep on what it made; where the set is there, the
    sweep alone."""
    import torch_smc_benchmark as bench
    import torch_smc_benchmark_steri as steri

    sweeps = []
    monkeypatch.setattr(bench, "main", lambda argv, dataset, name: sweeps.append(
        (argv, dataset, name)))
    argv = ["--bop-dir", str(tmp_path), "--device", "cpu", "--budgets", "0.25"]
    assert steri.main(argv) == 0
    scene = tmp_path / "synth_steri/val/000001"
    assert sorted(p.name for p in scene.iterdir()) == [
        "depth", "mask_visib", "scene_camera.json", "scene_gt.json", "scene_gt_info.json"]
    assert len(list((scene / "depth").glob("*.png"))) == 8
    assert (tmp_path / "synth_steri/models/models_info.json").is_file()
    assert sweeps == [(argv, "synth_steri", "smc_benchmark_steri")]
    cmd = steri.generator_argv(steri.parse_args(argv))
    assert cmd[1].endswith("scripts/torch_make_synthetic_bop.py")
    assert cmd[2:] == ["--dataset", "synth_steri", "--seed", "7", "--root", str(tmp_path),
                       "--device", "cpu"]
    # the set is there now: no second generation
    monkeypatch.setattr(steri.subprocess, "run", lambda *a, **kw: pytest.fail("generated"))
    assert steri.main(argv) == 0 and len(sweeps) == 2


@pytest.mark.parametrize("script_name", sorted({d for d, _, _ in SWEEP_EXPERIMENTS.values()}))
def test_sweep_scripts_refuse_cuda_without_a_card(script_name, monkeypatch):
    """No quiet fallback: asking for the card on a machine without one
    raises before anything runs."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        importlib.import_module(script_name).main(["--scenes", "1", "--bop-dir",
                                                   str(ROOT / "data/bop")])


def test_paired_by_config_pairs_files_of_one_name():
    import torch_paired_tests

    rows = torch_paired_tests.by_config(PRO / "smc_priors", PRO / "smc_priors")
    assert len(rows) == 2 * 3  # ADD-S and VSD of each of the three configs
    for r in rows:
        assert r["only_port"] == r["only_jax"] == 0 and r["p_value"] == 1.0
        assert r["port_n_steps"] == r["jax_n_steps"] > 0
        assert not r["significant_bonferroni"] and not r["reevaluated"]
    rows = torch_paired_tests.by_config(PRO / "smc_priors", PRO / "smc_priors", REEVALUATED)
    assert all(r["reevaluated"] for r in rows)
    # the stale and today's JAX errors of the same estimates: ADD-S equal
    assert all(r["only_port"] == r["only_jax"] == 0 for r in rows if r["metric"] == "adds")
