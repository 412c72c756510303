"""Port parity of the evaluation on the JAX package's synthcad val2 run
(``smc_bop_cad_val2``), on the CPU: one row of each scene, the evaluation's
renders of the 81,920-face model being ~23 s a row for the plain dense
rasteriser here (the card evaluates both artifacts whole in
``chip_smoke.py`` phase 16a).

The port's ``evaluate_scene`` on the JAX estimate of a single-gt image of
object 1 against the JAX package's checked-in errors of that gt (which its
evaluation of today reproduces: ``scripts/reevaluate_errors.py``) under
phase 14a's gates.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch_smc_bop_val as bopval  # noqa: E402
from chip_smoke import (  # noqa: E402
    REEVALUATED_BOP_RUNS,
    SWEEP_ADDS_REL_TOL,
    SWEEP_VSD_ABS_TOL,
    compare_errors,
    sweep_reference,
)

from bayesianposeestimation.jl_tpu_torch.parameters import Parameters  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils import bop  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils.artifacts import load_artifact  # noqa: E402

NAME = "smc_bop_cad_val2"
IMG = 3  # object 1 (81,920 faces), one gt, in both scenes


def _gt_slice(scene_id, img_id, obj_id, min_visib=0.1):
    """Where a (scene, image, object) group's gts stand in a whole scene's
    matched errors (every group holds an estimate)."""
    offset, groups = 0, {}
    for g in bop.bop_test_or_train(ROOT / "data/bop", "synthcad", "val2", scene_id):
        if g["visib_fract"] >= min_visib:
            groups.setdefault((g["img_id"], g["obj_id"]), []).append(g)
    for key, gts in groups.items():
        if key == (img_id, obj_id):
            return slice(offset, offset + len(gts))
        offset += len(gts)
    raise KeyError((img_id, obj_id))


@pytest.mark.parametrize("scene_id", [1, 2])
def test_evaluate_rows_match_jax_errors(scene_id):
    file = f"dataset=synthcad,sampler=smc_mh,scene_id={scene_id},testset=val2.npz"
    raw = load_artifact(ROOT / "data/exp_raw" / NAME / file)
    rows = [r for r in raw["result_rows"] if r["img_id"] == IMG]
    assert [r["obj_id"] for r in rows] == [1]
    ours = bopval.evaluate_scene(raw["__config__"], str(ROOT / "data/bop"),
                                 Parameters(device="cpu"), rows, device="cpu")
    ref, reevaluated = sweep_reference(NAME, file, REEVALUATED_BOP_RUNS)
    assert not reevaluated  # the checked-in errors reproduce
    at = _gt_slice(scene_id, IMG, 1)
    assert at.stop - at.start == 1
    # the image's gt comes first; the gts of images without an estimate here
    # are unmatched
    keys = [k for k in ("adds", "vsd", "vsdbop", "visib") if k in ref]
    mine = {k: np.asarray(ours[k])[:1] for k in keys}
    theirs = {k: np.asarray(ref[k])[at] for k in keys}
    assert np.isinf(np.asarray(ours["vsd"])[1:]).all()
    bad, worst_adds, worst_vsd, _ = compare_errors(mine, theirs, SWEEP_ADDS_REL_TOL,
                                                   SWEEP_VSD_ABS_TOL)
    assert not bad, (bad, worst_adds, worst_vsd)
    assert np.isfinite(mine["vsd"]).all()
