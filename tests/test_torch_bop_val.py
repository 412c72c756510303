"""Port parity: the BOP validation slice as a whole.

``scene_inference`` of scripts/smc_bop_val.py and of
scripts/torch_smc_bop_val.py on the first two target rows of synthcad val
scene 1, in ``mode: steps`` with few particles and steps, on the CPU (the
JAX side's Pallas kernel in interpret mode, the port's plain versions). Both
runners are wrapped to record what each image hands its chain: the crop
camera, the cropped observation, the prior image and the prior point must be
equal (the crop camera to float32 rounding: the JAX script computes it in
float32 scalars, the port in float64); the chains' outputs finite and of the
right shapes. The script helpers copied from the JAX script keep the
expectations of tests/test_val_script_helpers.py.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bayesianposeestimation.jl_tpu.models import fused as JF
from bayesianposeestimation.jl_tpu.parameters import Parameters as JParameters
from bayesianposeestimation.jl_tpu.utils import bop as JB
from bayesianposeestimation.jl_tpu_torch.models import fused as TF
from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
from bayesianposeestimation.jl_tpu_torch.utils import bop as TB

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import smc_bop_val as JS  # noqa: E402
import torch_smc_bop_val as TS  # noqa: E402

CONFIG = dict(dataset="synthcad", testset="val", scene_id=1, mode="steps")
ROWS = 2


def _recording(module, monkeypatch):
    """Wrap ``module.make_conditioned_chain`` so every runner call records
    (camera, observation, prior_o, prior_t) and the chain's outputs."""
    calls = []
    inner = module.make_conditioned_chain

    def make(*args, **kwargs):
        run = inner(*args, **kwargs)

        def recorded(seed, cam, obs, prior_o, prior_t, *rest, **kw):
            out = run(seed, cam, obs, prior_o, prior_t, *rest, **kw)
            calls.append((cam, np.asarray(obs), np.asarray(prior_o), np.asarray(prior_t), out))
            return out

        return recorded

    monkeypatch.setattr(module, "make_conditioned_chain", make)
    return calls


def _first_rows(module, monkeypatch):
    inner = module.bop_test_or_train

    def rows(*args):
        out = inner(*args)
        return out.iloc[:ROWS] if hasattr(out, "iloc") else out[:ROWS]

    monkeypatch.setattr(module, "bop_test_or_train", rows)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX script's smc_mh on two rows: 4 particles, 3 steps."""
    with pytest.MonkeyPatch.context() as mp:
        _first_rows(JB, mp)
        calls = _recording(JF, mp)
        params = JParameters(n_particles=4, n_steps=3, **JS.CAD_TUNED)
        result = JS.scene_inference(dict(CONFIG, sampler="smc_mh"), str(ROOT / "data/bop"),
                                    params)
    return result, calls


@pytest.mark.parametrize("sampler", ["smc_mh", "mh_sampler", "mtm_sampler"])
def test_scene_inference_matches_jax_inputs(jax_run, sampler, monkeypatch):
    """Targets and every chain input equal to the JAX script's; outputs
    finite, one estimate per row."""
    j_result, j_calls = jax_run
    _first_rows(TB, monkeypatch)
    calls = _recording(TF, monkeypatch)
    n = 4 if sampler == "smc_mh" else 3  # particles, or the MCMC baselines' tries
    params = Parameters(n_particles=n, n_steps=3, device="cpu", **TS.CAD_TUNED)
    result = TS.scene_inference(dict(CONFIG, sampler=sampler), str(ROOT / "data/bop"), params,
                                device="cpu")
    rows, j_rows = result["result_rows"], j_result["result_rows"]
    assert len(rows) == len(j_rows) == ROWS
    for r, jr in zip(rows, j_rows):
        for k in ("scene_id", "img_id", "gt_id", "obj_id", "depth_scale", "visib_fract"):
            assert r[k] == jr[k]
        for k in ("gt_t", "gt_R", "cam_K"):
            np.testing.assert_array_equal(r[k], jr[k])
        assert r["t"].shape == (3,) and r["q"].shape == (4,)
        assert np.isfinite(r["t"]).all() and np.isfinite(r["score"])
        assert np.linalg.norm(r["q"]) == pytest.approx(1.0, abs=1e-5)
    assert result["calibration"]["1"]["n_steps"] == 3
    # the warm-up call first, then one call per row (mode: steps has no
    # feedback pass), in both scripts
    assert len(calls) == len(j_calls) == 1 + ROWS
    for (cam, obs, prior_o, prior_t, (outs, _)), (jcam, jobs, jprior_o, jprior_t, _) in zip(
            calls, j_calls):
        for f in dataclasses.fields(cam):
            assert getattr(cam, f.name) == pytest.approx(float(getattr(jcam, f.name)),
                                                         rel=1e-6), f.name
        np.testing.assert_array_equal(obs, jobs)
        np.testing.assert_array_equal(prior_o, jprior_o)
        np.testing.assert_array_equal(prior_t, jprior_t)
        chains = 1 if sampler != "smc_mh" else n
        assert outs["t"].shape == (2, chains, 3) and outs["r"].shape == (2, chains, 4)
        assert all(bool(torch.isfinite(v).all()) for v in outs.values())


def test_script_helpers_keep_their_expectations():
    """_quantize_steps and tuned_parameters as tests/test_val_script_helpers.py
    holds the JAX script's, and equal to them."""
    for n in (1, 13, 63):
        assert TS._quantize_steps(n) == n
    for n in (64, 100, 480, 481, 511, 512, 1000, 3841, 50_000):
        q = TS._quantize_steps(n)
        assert q == JS._quantize_steps(n) and q <= n and q > n * (1 - 1 / 16) - 1
    assert TS._quantize_steps(480) == TS._quantize_steps(481) == 480
    assert TS.tuned_parameters("synthcad", "mh_sampler") is TS.CAD_TUNED
    assert TS.tuned_parameters("synthcad", "some_new_sampler") is TS.CAD_TUNED
    assert TS.tuned_parameters("synth", "smc_mh") is TS.TUNED_PARAMETERS
    assert TS.tuned_parameters("tless", "smc_mh") is TS.TUNED_PARAMETERS
    assert TS.CAD_TUNED == JS.CAD_TUNED and TS.TUNED_PARAMETERS == JS.TUNED_PARAMETERS
    assert TS.DATASET_TUNED == JS.DATASET_TUNED


def test_recall_rows_and_csv(tmp_path):
    """The recall table of the checked-in JAX errors, written with the csv
    module, reproduces the checked-in sampler_recall.csv."""
    import csv

    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import collect_results

    errs = {}
    for r in collect_results(ROOT / "data/exp_pro/smc_bop_cad/errors"):
        errs.setdefault(r["__config__"]["sampler"], []).append(r)
    # the JAX script concatenated the scenes in sweep order (1, 2, ..., 18)
    for v in errs.values():
        v.sort(key=lambda r: r["__config__"]["scene_id"])
    rows, visib_rows = TS.recall_rows(errs)
    TS.write_csv(tmp_path / "recall.csv", rows)
    ours = {r["sampler"]: r for r in csv.DictReader(open(tmp_path / "recall.csv"))}
    theirs = {r["sampler"]: r for r in csv.DictReader(
        open(ROOT / "data/exp_pro/smc_bop_cad/sampler_recall.csv"))}
    assert ours.keys() == theirs.keys()
    for s, row in theirs.items():
        for k, v in row.items():
            if k != "sampler":
                assert float(ours[s][k]) == pytest.approx(float(v), rel=1e-12), (s, k)
    assert {r["sampler"] for r in visib_rows} == set(theirs)


def test_script_refuses_cuda_without_a_card(monkeypatch):
    """No quiet fallback: asking for the card on a machine without one raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = Parameters(device="cuda")
    with pytest.raises(RuntimeError):
        TS.evaluate_scene(dict(CONFIG, sampler="smc_mh"), str(ROOT / "data/bop"), params, [],
                          device="cuda")
