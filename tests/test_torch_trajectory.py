"""Port parity of the offline trajectory evaluation
(``scripts/torch_trajectory_error.py`` against ``scripts/trajectory_error.py``).

On the JAX package's checked-in tracker trajectories
(``data/exp_pro/tracker/{coordinate,bootstrap}.tum`` against their
``*_gt.tum``) the port's script reproduces the checked-in summary
(``*_traj.json``) exactly and the per-frame table (``*_traj.csv``) within
1e-9; on the same arrays its ``associate``, ``quat_angle`` and
``relative_errors`` equal the JAX script's (RPE in float32 in both; equal to
the bit as measured, held within float32 rounding).
"""

import csv
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import torch_trajectory_error as TT  # noqa: E402
import trajectory_error as JT  # noqa: E402

from bayesianposeestimation.jl_tpu.utils.experiment_io import load_tum as j_load_tum  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils.experiment_io import load_tum  # noqa: E402

TRACKER = ROOT / "data/exp_pro/tracker"
FILTERS = ("coordinate", "bootstrap")


def _read_csv(path):
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    return list(rows[0]), np.asarray([[float(v) for v in r.values()] for r in rows])


@pytest.mark.parametrize("name", FILTERS)
def test_script_reproduces_checked_in_outputs(name, tmp_path, capsys):
    out_csv, out_json = tmp_path / f"{name}_traj.csv", tmp_path / f"{name}_traj.json"
    summary = TT.main([str(TRACKER / f"{name}.tum"), str(TRACKER / f"{name}_gt.tum"),
                       "--out-csv", str(out_csv), "--out-json", str(out_json)])
    want = json.loads((TRACKER / f"{name}_traj.json").read_text())
    assert summary == want
    assert json.loads(out_json.read_text()) == want
    assert json.loads(capsys.readouterr().out.splitlines()[0]) == want
    head, got = _read_csv(out_csv)
    ref_head, ref = _read_csv(TRACKER / f"{name}_traj.csv")
    assert head == ref_head
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", FILTERS)
def test_functions_match_the_jax_script(name):
    est, gt = load_tum(TRACKER / f"{name}.tum"), load_tum(TRACKER / f"{name}_gt.tum")
    j_est, j_gt = j_load_tum(TRACKER / f"{name}.tum"), j_load_tum(TRACKER / f"{name}_gt.tum")
    for a, b in zip(est + gt, j_est + j_gt):
        np.testing.assert_array_equal(a, b)
    ie, ig = TT.associate(est[0], gt[0])
    j_ie, j_ig = JT.associate(est[0], gt[0])
    np.testing.assert_array_equal(ie, j_ie)
    np.testing.assert_array_equal(ig, j_ig)
    np.testing.assert_array_equal(TT.quat_angle(est[2][ie], gt[2][ig]),
                                  JT.quat_angle(est[2][ie], gt[2][ig]))
    for delta in (1, 5):
        ours = TT.relative_errors(est[1][ie], est[2][ie], gt[1][ig], gt[2][ig], delta)
        theirs = JT.relative_errors(est[1][ie], est[2][ie], gt[1][ig], gt[2][ig], delta)
        # measured equal to the bit; arccos near 1 turns one float32 ulp of
        # the dot product into ~7e-4 rad, which the rotation bound allows
        np.testing.assert_allclose(ours[0], theirs[0], rtol=0, atol=1e-7)  # metres
        np.testing.assert_allclose(ours[1], theirs[1], rtol=0, atol=1e-3)  # radians


def test_associate_drops_far_stamps_and_no_association_raises():
    est = np.asarray([0.0, 0.101, 0.35])
    gt = np.asarray([0.0, 0.033, 0.066, 0.1, 0.133, 0.3])
    ie, ig = TT.associate(est, gt, max_dt=0.02)
    np.testing.assert_array_equal(ie, [0, 1])
    np.testing.assert_array_equal(ig, [0, 3])
    far = (np.asarray([5.0]), np.zeros((1, 3)), np.asarray([[1.0, 0, 0, 0]]))
    near = (np.asarray([0.0, 1.0]), np.zeros((2, 3)), np.tile([1.0, 0, 0, 0], (2, 1)))
    with pytest.raises(SystemExit):
        TT.evaluate(far, near)
