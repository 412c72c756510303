"""The port's entry points on ported paths, on the CPU at a small size.

``bench_torch.py`` (the counterpart of ``bench.py``) at 3 steps of 8
particles under ``--allow-cpu``: exactly one JSON line with ``bench.py``'s
keys and ``device``, one likelihood evaluation per step and no kernel
launch (the CPU runs the plain version); without a card and without the
flag it raises. ``scripts/torch_smc_bop_test.py``'s CSV formatter on the
JAX package's checked-in scene-1 estimates reproduces
``data/smc_mh_synth-val.csv`` text for text. ``scripts/
torch_inference_time.py``'s merge-by-key keeps the JAX script's rule, and
one grid point runs on the CPU.
"""

import csv
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
import bench_torch  # noqa: E402
import torch_inference_time as TIT  # noqa: E402
import torch_smc_bop_test as TBT  # noqa: E402

from bayesianposeestimation.jl_tpu_torch.utils.artifacts import load_artifact  # noqa: E402


def test_bench_torch_on_the_cpu(capsys):
    assert bench_torch.main(["--allow-cpu", "--n-steps", "3", "--n-particles", "8"]) == 0
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert set(result) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert result["unit"] == "hypotheses/s" and result["device"] == "cpu"
    assert result["value"] > 0
    assert result["vs_baseline"] == round(result["value"] / 1e5, 3)
    record = json.loads(err.split("bench_torch: ", 1)[1].splitlines()[0])
    assert record["evaluations"] == [3, 3, 3]  # one likelihood evaluation per step
    assert record["launches"] == [0, 0, 0]  # the CPU runs the plain version: no launch
    assert record["finite"] and len(record["seconds"]) == 3


def test_bench_torch_refuses_the_cpu_without_the_flag(monkeypatch):
    monkeypatch.delenv("BENCH_ALLOW_CPU", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main(["--n-steps", "3", "--n-particles", "8"])


def test_bench_torch_takes_bench_allow_cpu(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_ALLOW_CPU", "1")
    assert bench_torch.main(["--n-steps", "2", "--n-particles", "4"]) == 0
    assert json.loads(capsys.readouterr().out)["device"] == "cpu"


def test_bop_csv_matches_the_jax_submission():
    rows = load_artifact(ROOT / "data/exp_raw/smc_bop_test/"
                         "dataset=synth,sampler=smc_mh,scene_id=1,testset=val.npz")["result_rows"]
    text = "\n".join([TBT.HEADER] + TBT.submission_lines(rows)) + "\n"
    assert text == (ROOT / "data/smc_mh_synth-val.csv").read_text()


def _row(res, n, ms):
    return dict(resolution=res, n_particles=n, step_time_ms=ms, hyp_per_s=n / ms * 1e3)


def test_inference_time_merge_by_key(tmp_path):
    path = tmp_path / "t.csv"
    TIT.merge_rows(path, [_row(r, n, 1.0) for r in (25, 50) for n in (2, 10)])
    written = TIT.merge_rows(path, [_row(25, 10, 2.5), _row(25, 100, 3.0)])
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert list(rows[0]) == list(TIT.FIELDS)
    keys = [(int(r["resolution"]), int(r["n_particles"])) for r in rows]
    assert keys == [(25, 2), (25, 10), (25, 100), (50, 2), (50, 10)]
    ms = {k: float(r["step_time_ms"]) for k, r in zip(keys, rows)}
    assert ms == {(25, 2): 1.0, (25, 10): 2.5, (25, 100): 3.0, (50, 2): 1.0, (50, 10): 1.0}
    assert len(written) == 5


def test_inference_time_grid_point_on_the_cpu():
    [row] = TIT.grid_rows("monkey", [25], [8], "cpu", max_seconds=0.2)
    assert (row["resolution"], row["n_particles"]) == (25, 8)
    assert row["step_time_ms"] > 0
    assert row["hyp_per_s"] == pytest.approx(8 / row["step_time_ms"] * 1e3)


def test_paired_tests_keep_other_samplers_rows(tmp_path, monkeypatch):
    """scripts/torch_paired_tests.py writes one sampler's rows into
    paired_vs_jax.csv and keeps the rows of the samplers run before."""
    import numpy as np

    import torch_paired_tests as TPT

    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import save_artifact

    for side, adds in (("port", [0.05, 0.2, 0.05]), ("jax", [0.2, 0.2, 0.05])):
        (tmp_path / side / "errors").mkdir(parents=True)
        for sampler in ("smc_mh", "mh_sampler"):
            save_artifact(tmp_path / side / "errors" / f"dataset=synth,sampler={sampler},"
                          "scene_id=1,testset=hardvis.npz",
                          {"adds": np.asarray(adds), "vsd": np.asarray(adds),
                           "visib": np.ones(3)})
    for sampler in ("smc_mh", "mh_sampler", "smc_mh"):
        monkeypatch.setattr(sys, "argv", ["x", str(tmp_path / "port"), str(tmp_path / "jax"),
                                          "--sampler", sampler])
        TPT.main()
    with open(tmp_path / "port" / "paired_vs_jax.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert sorted((r["sampler"], r["metric"]) for r in rows) == [
        ("mh_sampler", "adds"), ("mh_sampler", "vsd"), ("smc_mh", "adds"), ("smc_mh", "vsd")]
    # ADD-S < 0.1: the first gt only the port gets right; VSD < 0.3: all three both
    assert all((r["only_port"], r["only_jax"], r["p_value"])
               == (("1", "0", "1.0") if r["metric"] == "adds" else ("0", "0", "1.0"))
               for r in rows)
