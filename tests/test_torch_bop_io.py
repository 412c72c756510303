"""Port parity: the BOP reader without pandas or imageio.

The port's PNG decoder (``utils/png.py``) against imageio, bitwise, on the
repository's synthcad depth and mask images and on small PNGs written here
with each of the five row filters; the readers (``train_targets``,
``test_targets``), images, camera, diameter and meshes against
``jl_tpu/utils/bop.py`` on the same files, equal field by field.
"""

import dataclasses
import json
import struct
import zlib
from pathlib import Path

import imageio.v3 as iio
import numpy as np
import pytest

from bayesianposeestimation.jl_tpu.utils import bop as JB
from bayesianposeestimation.jl_tpu.utils import mesh_io as JM
from bayesianposeestimation.jl_tpu.utils.experiment_io import load_img_mesh as j_load_img_mesh
from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
from bayesianposeestimation.jl_tpu_torch.utils import bop as TB
from bayesianposeestimation.jl_tpu_torch.utils import mesh_io as TM
from bayesianposeestimation.jl_tpu_torch.utils.decimate import triangle_budget_for_resolution
from bayesianposeestimation.jl_tpu_torch.utils.experiment_io import load_img_mesh
from bayesianposeestimation.jl_tpu_torch.utils.png import png_size, read_png

ROOT = Path(__file__).resolve().parent.parent
VAL = ROOT / "data/bop/synthcad/val"


def _filters(path):
    """(bit depth, set of row filter types) of a grayscale PNG."""
    data = path.read_bytes()
    w, h, depth = struct.unpack(">IIB", data[16:25])
    off, idat = 8, b""
    while off < len(data):
        n, kind = struct.unpack(">I4s", data[off:off + 8])
        idat += data[off + 8:off + 8 + n] if kind == b"IDAT" else b""
        off += 12 + n
    raw = zlib.decompress(idat)
    stride = w * depth // 8
    return depth, {raw[y * (stride + 1)] for y in range(h)}


def _write_png(path, img, filters, colour=0, interlace=0, depth=None):
    """A few-line PNG encoder: grayscale rows, each with the given filter
    type (cycled), big-endian samples for 16 bits."""
    img = np.asarray(img)
    depth = depth or img.dtype.itemsize * 8
    raw = img.astype(">u2").view(np.uint8) if depth == 16 else img.astype(np.uint8)
    raw = raw.reshape(img.shape[0], -1).astype(np.int32)
    bpp = max(depth // 8, 1)
    out, prev = b"", np.zeros(raw.shape[1], np.int32)
    for y, row in enumerate(raw):
        f = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 0:
            enc = row
        elif f == 1:
            enc = row - left
        elif f == 2:
            enc = row - prev
        elif f == 3:
            enc = row - (left + prev) // 2
        else:
            est = left + prev - upleft
            pa, pb, pc = np.abs(est - left), np.abs(est - prev), np.abs(est - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            enc = row - pred
        out += bytes([f]) + (enc % 256).astype(np.uint8).tobytes()
        prev = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], depth, colour, 0, 0, interlace)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                     + chunk(b"IDAT", zlib.compress(out)) + chunk(b"IEND", b""))


def test_png_decoder_equals_imageio_on_repo_images():
    """Depth (16-bit) and mask (8-bit) images of synthcad val, bitwise; the
    files chosen cover row filters 0, 1, 2 and 4 at both bit depths."""
    paths = sorted(VAL.glob("00000[1-3]/depth/*.png"))[:12] + sorted(
        VAL.glob("000001/mask_visib/*.png"))[:12]
    seen = {8: set(), 16: set()}
    for p in paths:
        depth, filters = _filters(p)
        seen[depth] |= filters
        ours, ref = read_png(p), np.asarray(iio.imread(p))
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref)
        assert png_size(p) == (ref.shape[1], ref.shape[0])
    # one 16-bit file with a None-filtered row (found by scanning the set)
    extra = next(p for p in sorted(ROOT.glob("data/bop/synthcad/*/*/depth/*.png"))
                 if 0 in _filters(p)[1])
    np.testing.assert_array_equal(read_png(extra), np.asarray(iio.imread(extra)))
    seen[16] |= _filters(extra)[1]
    assert {0, 1, 2, 4} <= seen[8] and {0, 1, 2, 4} <= seen[16]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_png_decoder_every_filter(tmp_path, dtype, filt):
    """Each of the five filters, alone and mixed row by row with the others,
    at 8 and 16 bits and an odd width: decoded bitwise equal to the array
    written and to imageio's decode."""
    rng = np.random.default_rng(filt)
    img = rng.integers(0, np.iinfo(dtype).max, (9, 13), dtype=dtype, endpoint=True)
    img[3:6, 4:9] = img[0, 0]  # flat patches, where the filters predict well
    for name, filters in (("one", [filt]), ("mixed", [filt, 4, 1, 3, 2, 0])):
        p = tmp_path / f"{name}.png"
        _write_png(p, img, filters)
        out = read_png(p)
        assert out.dtype == dtype
        np.testing.assert_array_equal(out, img)
        np.testing.assert_array_equal(out, np.asarray(iio.imread(p)))


@pytest.mark.parametrize("bad", [dict(colour=2, depth=4), dict(interlace=1), dict(depth=4)])
def test_png_decoder_raises_on_unsupported_formats(tmp_path, bad):
    """Colour at a bit depth the format does not allow, interlaced and
    sub-byte grayscale images raise instead of misreading."""
    img = np.zeros((4, 6 if bad.get("colour") != 2 else 18), np.uint8)
    p = tmp_path / "bad.png"
    _write_png(p, img, [0], **bad)
    with pytest.raises(ValueError):
        read_png(p)
    (tmp_path / "not.png").write_bytes(b"GIF89a" + bytes(40))
    with pytest.raises(ValueError):
        read_png(tmp_path / "not.png")


def _fields(cam):
    return dataclasses.astuple(cam)


def _assert_rows_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for k, v in b.items():
            if isinstance(v, np.ndarray):
                assert a[k].dtype == v.dtype
                np.testing.assert_array_equal(a[k], v)
            else:
                assert a[k] == v and type(a[k]) is type(v), k


def test_train_targets_match_jax():
    """synthcad val scene 1: every row and field of the port's targets equals
    the JAX DataFrame's (values, dtypes, order)."""
    theirs = [dict(r) for _, r in JB.train_targets(VAL, 1).iterrows()]
    ours = TB.train_targets(VAL, 1)
    assert len(ours) == 18
    _assert_rows_equal(ours, theirs)
    _assert_rows_equal(TB.bop_test_or_train(ROOT / "data/bop", "synthcad", "val", 1), theirs)


@pytest.fixture(scope="module")
def mini_bop(tmp_path_factory):
    """tests/test_bop_io.py's miniature dataset: one scene, two images, one
    object, an ascii PLY and a BOP19 target list naming image 0 only."""
    root = tmp_path_factory.mktemp("bop") / "mini" / "val"
    sdir = root / "000001"
    (sdir / "depth").mkdir(parents=True)
    (sdir / "mask_visib").mkdir()
    models = root.parent / "models"
    models.mkdir()
    K = [500.0, 0.0, 32.0, 0.0, 500.0, 24.0, 0.0, 0.0, 1.0]
    cams, gts, infos = {}, {}, {}
    rng = np.random.default_rng(0)
    for img_id in (0, 1):
        cams[str(img_id)] = {"cam_K": K, "depth_scale": 0.1}
        gts[str(img_id)] = [{"obj_id": 7, "cam_R_m2c": np.eye(3).ravel().tolist(),
                             "cam_t_m2c": [10.0, -20.0, 1000.0]}]
        infos[str(img_id)] = [{"visib_fract": 0.9, "bbox_visib": [10, 8, 20, 16]}]
        depth_mm = rng.integers(8000, 12000, (48, 64)).astype(np.uint16)
        depth_mm[:4] = 0
        iio.imwrite(sdir / "depth" / f"{img_id:06d}.png", depth_mm)
        mask = np.zeros((48, 64), np.uint8)
        mask[8:24, 10:30] = 255
        iio.imwrite(sdir / "mask_visib" / f"{img_id:06d}_000000.png", mask)
    for name, obj in [("scene_camera.json", cams), ("scene_gt.json", gts),
                      ("scene_gt_info.json", infos)]:
        (sdir / name).write_text(json.dumps(obj))
    mesh = JM.icosphere_mesh(50.0, 1)
    ply = ["ply", "format ascii 1.0", f"element vertex {mesh.n_vertices}",
           "property float x", "property float y", "property float z",
           f"element face {mesh.n_faces}", "property list uchar int vertex_indices",
           "end_header"]
    ply += [f"{v[0]} {v[1]} {v[2]}" for v in mesh.vertices]
    ply += [f"3 {f[0]} {f[1]} {f[2]}" for f in mesh.faces]
    (models / "obj_000007.ply").write_text("\n".join(ply))
    (models / "models_info.json").write_text(json.dumps({"7": {"diameter": 100.0}}))
    (root.parent / "test_targets_bop19.json").write_text(json.dumps(
        [{"im_id": 0, "inst_count": 1, "obj_id": 7, "scene_id": 1}]))
    return root


def test_test_targets_and_mini_dataset_match_jax(mini_bop):
    """The BOP19 target filter, the split dispatch, and every loader on the
    miniature dataset (ascii PLY, depth scale 0.1, an invalid band)."""
    ours = TB.test_targets(mini_bop, 1)
    theirs = [dict(r) for _, r in JB.test_targets(mini_bop, 1).iterrows()]
    assert len(ours) == 1 and ours[0]["img_id"] == 0
    _assert_rows_equal(ours, theirs)
    _assert_rows_equal(TB.train_targets(mini_bop, 1),
                       [dict(r) for _, r in JB.train_targets(mini_bop, 1).iterrows()])
    row = TB.train_targets(mini_bop, 1)[1]
    depth = TB.load_depth_image(row)
    assert depth.dtype == np.float32 and depth[0, 0] == 0.0
    np.testing.assert_array_equal(depth, JB.load_depth_image(row))
    np.testing.assert_array_equal(TB.load_depth_image(row, 32, 24),
                                  JB.load_depth_image(row, 32, 24))
    np.testing.assert_array_equal(TB.load_mask_image(row), JB.load_mask_image(row))
    assert _fields(TB.camera_for_row(row, 32, 24)) == _fields(JB.camera_for_row(row, 32, 24))
    m_ours, m_theirs = TB.load_mesh(row), JB.load_mesh(row)
    np.testing.assert_array_equal(m_ours.vertices, m_theirs.vertices)
    np.testing.assert_array_equal(m_ours.faces, m_theirs.faces)
    assert TB.model_diameter(row) == JB.model_diameter(row) == pytest.approx(0.1)


def test_bop_test_or_train_dispatch(mini_bop, tmp_path):
    """A split whose name holds "test" reads the BOP19 list."""
    test_dir = mini_bop.parent / "test"
    if not test_dir.exists():
        test_dir.symlink_to(mini_bop, target_is_directory=True)
    ours = TB.bop_test_or_train(mini_bop.parent.parent, "mini", "test", 1)
    theirs = [dict(r) for _, r in JB.bop_test_or_train(mini_bop.parent.parent, "mini", "test",
                                                        1).iterrows()]
    assert len(ours) == 1
    _assert_rows_equal(ours, theirs)


@pytest.mark.parametrize("img_id", [0, 7])
def test_images_and_camera_match_jax(img_id):
    """Depth (m, float32, invalid 0), the visible masks and the camera of a
    synthcad val image, equal to JAX's; the camera's size comes from the
    PNG header."""
    rows = [r for r in TB.train_targets(VAL, 2) if r["img_id"] == img_id]
    for row in rows:
        np.testing.assert_array_equal(TB.load_depth_image(row), JB.load_depth_image(row))
        np.testing.assert_array_equal(TB.load_mask_image(row), JB.load_mask_image(row))
        np.testing.assert_array_equal(TB.load_segmentation(row, 30, 30),
                                      JB.load_segmentation(row, 30, 30))
        assert _fields(TB.camera_for_row(row)) == _fields(JB.camera_for_row(row))
        assert TB.model_diameter(row) == JB.model_diameter(row)


@pytest.mark.parametrize("obj_id", [1, 2, 3])
def test_meshes_match_jax(obj_id):
    """The three synthcad models (81,920, 128,000 and 102,400 faces) through
    the vectorised PLY path, reoriented, and their 1,800-face decimation
    (the 30x30 budget), as load_img_mesh gives them; all equal to JAX's."""
    row = dict(TB.train_targets(VAL, 1)[0], obj_id=obj_id)
    full, j_full = TB.load_mesh(row), JB.load_mesh(row)
    assert full.n_faces == {1: 81920, 2: 128000, 3: 102400}[obj_id]
    np.testing.assert_array_equal(full.vertices, j_full.vertices)
    np.testing.assert_array_equal(full.faces, j_full.faces)
    path = VAL.parent / "models" / f"obj_{obj_id:06d}.ply"
    np.testing.assert_array_equal(TB.load_ply(path).faces, JB.load_ply(path).faces)
    assert triangle_budget_for_resolution(30, 30) == 1800
    params = Parameters(device="cpu")
    depth, mask, small = load_img_mesh(row, params)
    j_depth, j_mask, j_small = j_load_img_mesh(row, params)
    assert small.n_faces <= 1800
    np.testing.assert_array_equal(small.vertices, j_small.vertices)
    np.testing.assert_array_equal(small.faces, j_small.faces)
    np.testing.assert_array_equal(depth, j_depth)
    np.testing.assert_array_equal(mask, j_mask)


def test_fix_winding_and_mixed_faces(tmp_path):
    """An inward-wound mesh is flipped (as JAX's fix_winding does), and a
    binary PLY with a quad goes through the polygon fallback."""
    cube = TM.cube_mesh(0.1)
    flipped = TM.Mesh(cube.vertices, cube.faces[:, ::-1])
    fixed = TM.fix_winding(flipped)
    np.testing.assert_array_equal(fixed.faces, JM.fix_winding(JM.Mesh(cube.vertices,
                                                                      cube.faces[:, ::-1])).faces)
    np.testing.assert_array_equal(fixed.faces, cube.faces)
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    header = (b"ply\nformat binary_little_endian 1.0\nelement vertex 4\n"
              b"property float x\nproperty float y\nproperty float z\nelement face 2\n"
              b"property list uchar int vertex_indices\nend_header\n")
    body = verts.astype("<f4").tobytes() + struct.pack("<B4i", 4, 0, 1, 2, 3) + struct.pack(
        "<B3i", 3, 0, 2, 3)
    p = tmp_path / "quad.ply"
    p.write_bytes(header + body)
    np.testing.assert_array_equal(TB.load_ply(p).faces, [[0, 1, 2], [0, 2, 3], [0, 2, 3]])
    np.testing.assert_array_equal(TB.load_ply(p).faces, JB.load_ply(p).faces)
    (tmp_path / "big.ply").write_bytes(header.replace(b"binary_little_endian",
                                                      b"binary_big_endian") + body)
    with pytest.raises(ValueError):
        TB.load_ply(tmp_path / "big.ply")
