"""Port parity on the hardvis split (``data/bop/synth/hardvis``): the other
dataset family of the BOP validation, with the small synth models (1,280,
12 and 320 faces; scene 1 holds the 320-face icosphere) at purpose-built low
visibility.

``scripts/torch_smc_bop_val.py``'s ``evaluate_scene`` on the CPU, on the JAX
package's checked-in scene-1 estimates of each sampler
(``data/exp_raw/hard_cases_vis``), against the JAX package's checked-in
errors (``data/exp_pro/hard_cases_vis/errors``): visibilities equal, ADD-S
within 1e-5 relative and VSD / VSDBOP within 0.005 (``chip_smoke.py`` phase
7a's gates hold the card to the same); then the port's ``recall_rows`` on
those errors equals the recall the JAX package's evaluation module computes
from its own errors of the scene.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from bayesianposeestimation.jl_tpu.utils import evaluation as JE
from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
from bayesianposeestimation.jl_tpu_torch.utils.artifacts import load_artifact, savename

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import torch_smc_bop_val as TS  # noqa: E402

SAMPLERS = ("smc_mh", "mh_sampler", "mtm_sampler")
ADDS_REL_TOL = 1e-5
VSD_ABS_TOL = 0.005
_ERRORS = {}


def _name(sampler):
    return savename(dict(dataset="synth", sampler=sampler, scene_id=1, testset="hardvis")) + ".npz"


def port_errors(sampler):
    """The port's errors of the JAX estimates of scene 1 (computed once)."""
    if sampler not in _ERRORS:
        raw = load_artifact(ROOT / "data/exp_raw/hard_cases_vis" / _name(sampler))
        _ERRORS[sampler] = TS.evaluate_scene(raw["__config__"], str(ROOT / "data/bop"),
                                             Parameters(device="cpu"),
                                             list(raw["result_rows"]), device="cpu")
    return _ERRORS[sampler]


def jax_errors(sampler):
    return load_artifact(ROOT / "data/exp_pro/hard_cases_vis/errors" / _name(sampler))


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_evaluate_scene_matches_jax_errors(sampler):
    ours, ref = port_errors(sampler), jax_errors(sampler)
    np.testing.assert_array_equal(ours["visib"], ref["visib"])
    assert len(ours["vsd"]) == 50
    for key in ("adds", "vsd", "vsdbop"):
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        assert a.shape == b.shape, key
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
        fin = np.isfinite(b)
        if key == "adds":
            np.testing.assert_allclose(a[fin], b[fin], rtol=ADDS_REL_TOL, atol=0)
        else:
            np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=VSD_ABS_TOL)


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_scene_recall_matches_jax(sampler):
    [row], visib_rows = TS.recall_rows({sampler: [port_errors(sampler)]})
    ref = jax_errors(sampler)
    for key, theta in (("adds_recall", JE.ADDS_THETA), ("vsd_recall", JE.BOP18_THETA),
                       ("vsdbop_recall", np.asarray(JE.BOP19_THRESHOLDS))):
        errs = ref[key.split("_")[0]]
        assert row[key] == JE.recall(*JE.threshold_errors(errs, theta)), key
    assert row["n_gt"] == 50
    assert sum(r["n_gt"] for r in visib_rows) == 50
