"""The port's BOP and PLY readers against the spec-authored fixtures, through
both packages on the same bytes, and the host-side conveniences the port
adds beside them.

* The five PLY cases and the seven BOP cases of
  ``tests/test_spec_fixtures.py`` (bytes written from the format specs by
  ``tests/fixtures/make_fixtures.py``, not by either package's writers):
  the port's ``load_ply``, ``gt_dataframe`` / ``gt_rows``, ``gt_info``,
  ``train_targets``, ``test_targets``, the depth and mask readers,
  ``camera_for_row``, ``model_diameter`` and ``load_mesh`` hold the case's
  own expectation and equal the JAX package's reader on the same file.
* ``gt_dataframe`` / ``gt_info_dataframe`` are the JAX DataFrames' rows as
  dicts (millimetres to metres, the extra camera keys ignored).
* ``Sample.names`` / ``merge``, ``Parameters.img_size`` / ``cast`` and
  ``Experiment.camera`` against ``jl_tpu``'s.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from bayesianposeestimation.jl_tpu import parameters as JP
from bayesianposeestimation.jl_tpu import samples as JS
from bayesianposeestimation.jl_tpu.utils import bop as JB
from bayesianposeestimation.jl_tpu_torch import parameters as TP
from bayesianposeestimation.jl_tpu_torch import samples as TSm
from bayesianposeestimation.jl_tpu_torch.utils import bop as TB

FIX = Path(__file__).resolve().parent / "fixtures"
VAL = FIX / "bop" / "specfix" / "val"
MM = 1e-3
TET_VERTS_M = np.array([[0, 0, 0], [0.1, 0, 0], [0, 0.1, 0], [0, 0, 0.1]], np.float32)
# fixture -> the faces the spec gives (the first two hold the tetrahedron)
PLY_CASES = {
    "bop_toolkit_flavor.ply": [[0, 2, 1], [0, 1, 3]],
    "int_count_flavor.ply": [[0, 2, 1], [0, 1, 3]],
    "ascii_quad.ply": [[0, 1, 2], [0, 2, 3]],
    "mixed_quad_binary.ply": [[0, 1, 4], [0, 1, 2], [0, 2, 3]],
}


def _jax_rows(df):
    return df.to_dict("records")


def _row(rows, **where):
    [r] = [r for r in rows if all(r[k] == v for k, v in where.items())]
    return r


def _same_rows(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys(), (a.keys(), b.keys())
        for k in a:
            if isinstance(b[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


# -- PLY flavours --------------------------------------------------------------------


@pytest.mark.parametrize("name", list(PLY_CASES))
def test_ply_flavors_match_the_spec_and_jax(name):
    ours, theirs = TB.load_ply(FIX / "ply" / name), JB.load_ply(FIX / "ply" / name)
    np.testing.assert_array_equal(ours.faces, PLY_CASES[name])
    np.testing.assert_array_equal(ours.faces, theirs.faces)
    np.testing.assert_array_equal(ours.vertices, theirs.vertices)
    assert ours.vertices.dtype == theirs.vertices.dtype
    if name in ("bop_toolkit_flavor.ply", "int_count_flavor.ply"):
        np.testing.assert_allclose(ours.vertices, TET_VERTS_M, atol=1e-7)
    if name == "ascii_quad.ply":
        assert ours.vertices.shape == (4, 3)


def test_ply_big_endian_refused_by_both():
    for reader in (TB.load_ply, JB.load_ply):
        with pytest.raises(ValueError, match="binary_big_endian"):
            reader(FIX / "ply" / "big_endian.ply")


# -- the BOP dataset tree (T-LESS / ITODD flavour) --------------------------------------


def test_gt_dataframe_millimeters_to_meters_and_extra_camera_keys():
    rows = TB.gt_dataframe(VAL, 1)
    assert TB.gt_dataframe is TB.gt_rows and TB.gt_info_dataframe is TB.gt_info
    assert len(rows) == 3
    r = _row(rows, img_id=0, gt_id=0)
    np.testing.assert_allclose(r["gt_t"], [0.010, -0.020, 1.000])
    np.testing.assert_array_equal(r["gt_R"], np.eye(3))
    assert r["depth_scale"] == 0.1
    r2 = _row(rows, img_id=0, gt_id=1)
    assert r2["obj_id"] == 2
    np.testing.assert_array_equal(r2["gt_R"], np.diag([-1.0, -1.0, 1.0]))
    _same_rows(rows, _jax_rows(JB.gt_dataframe(VAL, 1)))


def test_gt_info_dataframe_matches_jax():
    rows = TB.gt_info_dataframe(VAL, 1)
    theirs = _jax_rows(JB.gt_info_dataframe(VAL, 1))
    assert len(rows) == len(theirs) == 3
    for a, b in zip(rows, theirs):
        assert a.keys() == b.keys()
        for k in a:
            # pandas stores a missing bbox as None or NaN
            if a[k] is None:
                assert b[k] is None or (isinstance(b[k], float) and np.isnan(b[k]))
            else:
                assert a[k] == b[k], k


def test_train_targets_join_matches_jax():
    ours = TB.train_targets(VAL, 1)
    theirs = _jax_rows(JB.train_targets(VAL, 1))
    assert [(r["img_id"], r["gt_id"]) for r in ours] == [(r["img_id"], r["gt_id"])
                                                         for r in theirs]
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for k in ("obj_id", "visib_fract", "bbox_visib", "depth_scale", "datasubset_path"):
            assert a[k] == b[k], k
        np.testing.assert_array_equal(a["gt_t"], b["gt_t"])


def test_depth_image_honors_depth_scale():
    row = _row(TB.train_targets(VAL, 1), img_id=0, gt_id=0)
    depth = TB.load_depth_image(row)
    assert depth.shape == (8, 8) and depth.dtype == np.float32
    assert depth[0, 0] == 0.0  # invalid stays 0
    np.testing.assert_allclose(depth[0, 1], 2000 * 0.1 * MM)
    np.testing.assert_allclose(depth[7, 7], 64000 * 0.1 * MM)
    np.testing.assert_array_equal(depth, JB.load_depth_image(row))


def test_visib_fract_and_bbox_joined():
    r = _row(TB.train_targets(VAL, 1), img_id=0, gt_id=1)
    assert r["visib_fract"] == 0.25
    assert r["bbox_visib"] == [300, 200, 10, 40]


def test_test_targets_filters_by_official_list():
    rows = TB.test_targets(VAL, 1)
    # obj 2 of image 0 is not in test_targets_bop19.json; scene 99 ignored
    assert {(r["img_id"], r["obj_id"]) for r in rows} == {(0, 1), (1, 1)}
    theirs = JB.test_targets(VAL, 1)
    assert [(r["img_id"], r["gt_id"], r["obj_id"]) for r in rows] == list(
        zip(theirs.img_id, theirs.gt_id, theirs.obj_id))


def test_mask_visib_naming_and_booleanness():
    rows, jdf = TB.train_targets(VAL, 1), JB.train_targets(VAL, 1)
    for gt_id, n in ((0, 16), (1, 4)):
        m = TB.load_mask_image(_row(rows, img_id=0, gt_id=gt_id))
        assert m.dtype == bool and m.sum() == n
        jm = JB.load_mask_image(jdf[(jdf.img_id == 0) & (jdf.gt_id == gt_id)].iloc[0])
        np.testing.assert_array_equal(m, jm)
    m1 = TB.load_mask_image(_row(rows, img_id=0, gt_id=1))
    assert m1[0, 7] and not m1[7, 0]


def test_camera_for_row_intrinsics():
    cam = TB.camera_for_row(TB.train_targets(VAL, 1)[0])
    assert cam.width == 8 and cam.height == 8
    np.testing.assert_allclose(float(cam.f_x), 572.4114)
    np.testing.assert_allclose(float(cam.c_y), 242.04899)
    jcam = JB.camera_for_row(JB.train_targets(VAL, 1).iloc[0])
    for f in ("width", "height", "f_x", "f_y", "c_x", "c_y", "s", "near", "far"):
        assert float(getattr(cam, f)) == pytest.approx(float(getattr(jcam, f)), rel=1e-7), f


def test_model_diameter_and_mesh_from_row():
    rows, jdf = TB.train_targets(VAL, 1), JB.train_targets(VAL, 1)
    row = _row(rows, img_id=0, gt_id=0)
    assert abs(TB.model_diameter(row) - 0.1732051) < 1e-6
    jrow = jdf[(jdf.img_id == 0) & (jdf.gt_id == 0)].iloc[0]
    assert TB.model_diameter(row) == JB.model_diameter(jrow)
    mesh = TB.load_mesh(row)
    assert mesh.n_vertices == 4 and mesh.n_faces == 2
    np.testing.assert_array_equal(mesh.vertices, JB.load_mesh(jrow).vertices)
    # obj 2 uses the int-count PLY flavour
    row2 = _row(rows, img_id=0, gt_id=1)
    mesh2 = TB.load_mesh(row2)
    assert mesh2.n_faces == 2
    assert np.abs(mesh2.vertices).max() <= 0.1 + 1e-6
    jrow2 = jdf[(jdf.img_id == 0) & (jdf.gt_id == 1)].iloc[0]
    np.testing.assert_array_equal(mesh2.faces, JB.load_mesh(jrow2).faces)


# -- samples and parameters ---------------------------------------------------------------


def test_sample_names_and_merge_match_jax():
    import jax.numpy as jnp

    t, r, o = np.ones((4, 3), np.float32), np.eye(4, dtype=np.float32), np.zeros((4, 2))
    ours = TSm.Sample({"t": torch.as_tensor(t), "r": torch.as_tensor(r)},
                      log_prob=torch.zeros(4), log_like=torch.zeros(4))
    theirs = JS.Sample({"t": jnp.asarray(t), "r": jnp.asarray(r)})
    assert ours.names == theirs.names == ("t", "r")
    for other, jother in ((TSm.Sample({"r": torch.zeros(4, 4), "o": torch.as_tensor(o)}),
                           JS.Sample({"r": jnp.zeros((4, 4)), "o": jnp.asarray(o)})),
                          ({"r": torch.zeros(4, 4), "o": torch.as_tensor(o)},
                           {"r": jnp.zeros((4, 4)), "o": jnp.asarray(o)})):
        merged, jmerged = ours.merge(other), theirs.merge(jother)
        assert merged.names == jmerged.names == ("t", "r", "o")
        for k in merged.names:  # right-biased
            np.testing.assert_array_equal(merged.variables[k].numpy(),
                                          np.asarray(jmerged.variables[k]))
        # the log densities reset: None in the port, -inf in the JAX package
        assert merged.log_prob is None and merged.log_like is None
        assert float(jmerged.log_prob) == -np.inf
    assert ours.names == ("t", "r")  # merge made a new sample


def test_parameters_img_size_and_cast_match_jax():
    ours, theirs = TP.Parameters(width=40, height=30), JP.Parameters(width=40, height=30)
    assert ours.img_size == theirs.img_size == (40, 30)
    for x in (1.5, [1, 2, 3], np.arange(4, dtype=np.float64), torch.arange(3)):
        c = ours.cast(x)
        jc = theirs.cast(x.numpy() if isinstance(x, torch.Tensor) else x)
        assert c.dtype == torch.float32 and str(jc.dtype) == "float32"
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert TP.Parameters(float_type=torch.float64).cast(1).dtype == torch.float64


def test_experiment_camera_matches_jax():
    from bayesianposeestimation.jl_tpu.camera import CvCamera as JCam
    from bayesianposeestimation.jl_tpu_torch.camera import CvCamera

    kw = dict(width=30, height=30, f_x=50.0, f_y=50.0, c_x=15.0, c_y=15.0)
    cam, jcam = CvCamera(**kw), JCam(**kw)
    ours = TP.Experiment(scene={"camera": cam, "verts": None, "faces": None}, prior_o=0.5,
                         prior_t=np.zeros(3))
    theirs = JP.Experiment(scene={"camera": jcam, "verts": None, "faces": None}, prior_o=0.5,
                           prior_t=np.zeros(3))
    assert ours.camera is cam and theirs.camera is jcam
    assert ours.with_depth_image(np.ones((30, 30))).camera is cam
