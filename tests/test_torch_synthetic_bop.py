"""Port parity of the synthetic BOP generator, scripts/torch_make_synthetic_bop.py,
against scripts/make_synthetic_bop.py's checked-in output, on the CPU (the
plain version of the depth-only kernel).

* The easy profile at --seed 0 with the rotations of
  data/bop/synth/val/000001/scene_gt.json injected (the JAX script draws them
  from ``jax.random``, which torch does not reproduce) remakes that scene:
  the same objects and instance counts, cam_t_m2c within 1e-9 mm, cam_R_m2c
  within 1e-5, scene_camera.json equal, every mask within IoU 0.98 and every
  visib_fract within 0.01 of the checked-in one (both measured equal), every
  depth PNG within 1 unit (0.1 mm) wherever both scenes' masks agree
  (``chip_smoke.compare_generated_scene``, which phase 15d applies on the
  card). Without injection the rotations are unit quaternions and the rest
  is the same.
* The steri script's generator arguments (--dataset synth_steri --seed 7)
  with data/bop/synth_steri/val/000001's rotations injected remake that
  scene under the same gates.
* The hard profile on one image: the rear instance's visible fraction is the
  one nearest the target among the 16 lateral offsets the script tries, and
  each of the 17 solo renders lies inside its 160x160 window.
* The NumPy draws of the cad profile replay synthcad train scene 1 at
  --seed 77 (renders stubbed: the 81,920-128,000-face models render on the
  card only, chip_smoke.py phase 15d), and the fixture of the JAX script's
  rotation draws at that seed is what ``jax.random`` draws.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch_make_synthetic_bop as gen  # noqa: E402
from chip_smoke import (  # noqa: E402
    JAX_QUATERNIONS,
    compare_generated_scene,
    gt_quaternions,
)

BOP = ROOT / "data/bop"
SYNTH_VAL = BOP / "synth/val/000001"


def _generate(tmp_path, argv, draws=None):
    args = gen.parse_args(["--root", str(tmp_path), "--device", "cpu", *argv])
    it = None if draws is None else iter(draws)
    out = gen.generate(args, None if it is None else lambda: np.asarray(next(it), np.float32))
    return args, out


@pytest.fixture(scope="module")
def easy_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("easy")
    args, out = _generate(root, ["--seed", "0"], gt_quaternions(SYNTH_VAL))
    return out["split_dir"] / "000001", out


def test_easy_profile_remakes_synth_val_scene_1(easy_scene):
    scene, out = easy_scene
    bad, stats = compare_generated_scene(scene, SYNTH_VAL, range(8))
    assert not bad, (bad, stats)
    assert stats["t_mm"] <= 1e-9 and stats["R"] <= 1e-5
    assert stats["min_iou"] >= 0.98 and stats["visib"] <= 0.01
    assert stats["depth_units"] <= 1
    assert out["renders"] == 12  # one solo render per instance, 4 images with two


def test_easy_profile_files_equal_checked_in(easy_scene):
    scene, _ = easy_scene
    for name in ("scene_camera.json",):
        assert json.loads((scene / name).read_text()) == json.loads((SYNTH_VAL / name).read_text())
    ours = json.loads((scene / "scene_gt.json").read_text())
    ref = json.loads((SYNTH_VAL / "scene_gt.json").read_text())
    assert ours.keys() == ref.keys()
    for k in ref:
        assert [g["obj_id"] for g in ours[k]] == [g["obj_id"] for g in ref[k]]
        for a, b in zip(ours[k], ref[k]):
            np.testing.assert_allclose(a["cam_t_m2c"], b["cam_t_m2c"], rtol=0, atol=1e-9)
            np.testing.assert_allclose(a["cam_R_m2c"], b["cam_R_m2c"], rtol=0, atol=1e-5)
    info = json.loads((scene / "scene_gt_info.json").read_text())
    ref_info = json.loads((SYNTH_VAL / "scene_gt_info.json").read_text())
    for k in ref_info:
        for a, b in zip(info[k], ref_info[k]):
            assert abs(a["visib_fract"] - b["visib_fract"]) <= 0.01
    models = scene.parents[1] / "models"
    assert json.loads((models / "models_info.json").read_text()) == json.loads(
        (BOP / "synth/models/models_info.json").read_text())
    assert not (scene.parents[1] / "test_targets_bop19.json").exists()


def test_easy_profile_without_injection(tmp_path, easy_scene):
    """The port's own rotations: unit quaternions, orthonormal R; every
    other output as with the checked-in rotations."""
    _, out = _generate(tmp_path, ["--seed", "0", "--n-images", "3"])
    scene = out["split_dir"] / "000001"
    ours = json.loads((scene / "scene_gt.json").read_text())
    ref = json.loads((SYNTH_VAL / "scene_gt.json").read_text())
    for k in ours:
        for a, b in zip(ours[k], ref[k]):
            assert a["obj_id"] == b["obj_id"]
            np.testing.assert_allclose(a["cam_t_m2c"], b["cam_t_m2c"], rtol=0, atol=1e-9)
            R = np.reshape(a["cam_R_m2c"], (3, 3))
            np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
            assert np.linalg.det(R) == pytest.approx(1.0, abs=1e-5)
    assert json.loads((scene / "scene_camera.json").read_text()) == {
        k: v for k, v in json.loads((SYNTH_VAL / "scene_camera.json").read_text()).items()
        if k in ours}
    draw = gen.quaternion_source(0)
    qs = np.stack([draw() for _ in range(64)])
    assert qs.dtype == np.float32 and qs.shape == (64, 4)
    np.testing.assert_allclose(np.linalg.norm(qs, axis=1), 1.0, atol=1e-6)
    again = gen.quaternion_source(0)
    np.testing.assert_array_equal(again(), qs[0])


def test_steri_arguments_remake_synth_steri_val_scene_1(tmp_path):
    """The arguments scripts/torch_smc_benchmark_steri.py runs the generator
    with (--dataset synth_steri --seed 7), the checked-in rotations
    injected, remake data/bop/synth_steri/val/000001 under the same gates."""
    import torch_smc_benchmark_steri as steri

    ref = BOP / "synth_steri/val/000001"
    argv = steri.generator_argv(steri.parse_args(["--bop-dir", str(tmp_path), "--device",
                                                  "cpu"]))[2:]
    _, out = _generate(tmp_path, argv, gt_quaternions(ref))
    assert out["split_dir"] == tmp_path / "synth_steri/val"
    bad, stats = compare_generated_scene(out["split_dir"] / "000001", ref, range(8))
    assert not bad, (bad, stats)
    assert stats["min_iou"] >= 0.98 and stats["visib"] <= 0.01
    assert stats["depth_units"] <= 1
    assert json.loads((tmp_path / "synth_steri/models/models_info.json").read_text()) == \
        json.loads((BOP / "synth_steri/models/models_info.json").read_text())


def test_hard_profile_picks_the_offset_nearest_the_target(tmp_path, monkeypatch):
    renders = []
    inner = gen.render_solo

    def logged(mesh_dev, cam, t, q, x0, y0):
        full = inner(mesh_dev, cam, t, q, x0, y0)
        renders.append((full, x0, y0))
        return full

    monkeypatch.setattr(gen, "render_solo", logged)
    _, out = _generate(tmp_path, ["--profile", "hard", "--n-images", "1", "--visib-targets",
                                  "0.3"])
    assert out["renders"] == len(renders) == 17
    front = renders[0][0]
    visibs = []
    for full, x0, y0 in renders:
        obj = np.isfinite(full)
        assert obj.any()
        # the whole silhouette inside the window, off its border
        win = np.zeros_like(obj)
        win[y0 + 1:y0 + gen.WINDOW - 1, x0 + 1:x0 + gen.WINDOW - 1] = True
        assert not (obj & ~win).any()
    for rear, _, _ in renders[1:]:
        rendered = np.isfinite(rear)
        vis = rendered & (rear <= np.minimum(front, rear) + 1e-3)
        visibs.append(vis.sum() / max(rendered.sum(), 1))
    info = json.loads((out["split_dir"] / "000001/scene_gt_info.json").read_text())
    chosen = info["0"][1]["visib_fract"]
    assert chosen == pytest.approx(min(visibs, key=lambda v: abs(v - 0.3)), abs=1e-12)
    assert len(set(np.round(visibs, 6))) > 1  # the offsets do move the visibility
    gts = json.loads((out["split_dir"] / "000001/scene_gt.json").read_text())["0"]
    assert [g["obj_id"] for g in gts] == [3, 3]


def test_test_split_writes_the_targets_file(tmp_path):
    _, out = _generate(tmp_path, ["--seed", "0", "--n-images", "1", "--split", "test",
                                  "--no-multi-instance"])
    targets = json.loads((out["split_dir"].parent / "test_targets_bop19.json").read_text())
    assert targets == [{"im_id": 0, "inst_count": 1, "obj_id": 1, "scene_id": 1}]


@pytest.mark.parametrize("split,scene,argv", [
    ("train", 1, ["--split", "train", "--n-scenes", "1", "--seed", "77"]),
    ("val", 5, ["--split", "val", "--scene-offset", "4", "--n-scenes", "1", "--seed", "42"]),
])
def test_cad_profile_numpy_draws_replay(tmp_path, monkeypatch, split, scene, argv):
    """Renders stubbed (inf = nothing drawn): the translations, which come
    from the NumPy stream alone, equal the checked-in synthcad scene's."""
    monkeypatch.setattr(gen, "render_solo", lambda mesh_dev, cam, t, q, x0, y0: np.full(
        (cam.height, cam.width), np.inf, np.float32))
    _, out = _generate(tmp_path, ["--profile", "cad", "--n-images", "3", *argv],
                       [np.array([1.0, 0.0, 0.0, 0.0], np.float32)] * 32)
    ours = json.loads((out["split_dir"] / f"{scene:06d}/scene_gt.json").read_text())
    ref = json.loads((BOP / f"synthcad/{split}/{scene:06d}/scene_gt.json").read_text())
    for k in ours:
        assert [g["obj_id"] for g in ours[k]] == [g["obj_id"] for g in ref[k]]
        for a, b in zip(ours[k], ref[k]):
            np.testing.assert_allclose(a["cam_t_m2c"], b["cam_t_m2c"], rtol=0, atol=1e-9)
    assert out["renders"] > 3  # clutter renders too


def test_jax_rotation_fixture_is_jax_random():
    """tests/fixtures/jax_generator_quaternions.json holds the JAX script's
    draws at --seed 77, and they are the rotations of synthcad train scene 1
    (to the float32 rounding of the TPU that made it)."""
    import jax

    from bayesianposeestimation.jl_tpu import quaternions as JQ

    fixture = json.loads(JAX_QUATERNIONS.read_text())
    key = jax.random.PRNGKey(fixture["seed"])
    for q in fixture["quaternions"]:
        key, kq = jax.random.split(key)
        np.testing.assert_array_equal(np.asarray(JQ.rand_quaternion(kq)),
                                      np.asarray(q, np.float32))
    gt = json.loads((BOP / "synthcad/train/000001/scene_gt.json").read_text())
    from bayesianposeestimation.jl_tpu_torch import quaternions as TQ

    qs = fixture["quaternions"]
    # image 0: two instances (draws 0-1), four clutter (2-5); image 1: draw 6
    for draw, g in ((0, gt["0"][0]), (1, gt["0"][1]), (6, gt["1"][0])):
        R = TQ.quat_to_matrix(torch.tensor(qs[draw], dtype=torch.float32)).numpy()
        np.testing.assert_allclose(R.ravel(), g["cam_R_m2c"], rtol=0, atol=1e-5)


def test_generator_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        gen.main(["--root", str(tmp_path)])
