"""Port parity of the synthetic BOP set's meshes, mesh files and PNG writer.

* The generators of ``jl_tpu_torch.utils.mesh_io`` (``subdivide_mesh``,
  ``_harmonic_field``, ``displaced_icosphere``, ``lathe_mesh``,
  ``torus_mesh``) return bitwise the vertices and faces of
  ``jl_tpu.utils.mesh_io``'s.
* ``save_ply`` (binary and ASCII) and ``save_obj`` write files byte-equal to
  the JAX writers' for the six models of scripts/make_synthetic_bop.py (the
  easy profile's three and the cad profile's three, in millimetres).
* The cad models written by the port's generator are byte-equal to
  data/bop/synthcad/models/*.ply; the synth models equal their checked-in
  ASCII PLYs within 1e-4 mm (an earlier writer printed 4 decimals); every
  diameter equals models_info.json.
* ``write_png`` round-trips through ``read_png`` and imageio reads the same
  array, for uint16 and uint8.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import torch_make_synthetic_bop as gen  # noqa: E402

from bayesianposeestimation.jl_tpu.utils import mesh_io as J  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils import mesh_io as T  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils.bop import load_ply  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils.png import read_png, write_png  # noqa: E402

MODELS = {"synth": "easy", "synthcad": "cad"}


def _shaft(z):  # scripts/make_synthetic_bop.py's cad profile
    r = 0.028 + 0.006 * np.sin(40 * np.pi * z)
    r = r + np.where(np.abs(z) < 0.02, 0.008, 0.0)
    return np.clip(r, 0.008, None)


def _assert_same_mesh(a, b):
    assert a.vertices.dtype == b.vertices.dtype == np.float32
    assert a.faces.dtype == b.faces.dtype == np.int32
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)


@pytest.fixture(scope="module")
def objects():
    """Each profile's objects from the port's generator script."""
    return {dataset: gen.build_objects(profile) for dataset, profile in MODELS.items()}


GENERATORS = {
    "subdivide_mesh": lambda m: m.subdivide_mesh(m.icosphere_mesh(0.03, 1), 2),
    "subdivide_mesh_unit": lambda m: m.subdivide_mesh(m.cube_mesh(0.1), 3, project_unit=True),
    "displaced_icosphere_5": lambda m: m.displaced_icosphere(0.05, 5, seed=3),
    "displaced_icosphere_cad": lambda m: m.displaced_icosphere(0.05, 6, seed=1),
    "lathe_mesh_cad": lambda m: m.lathe_mesh(_shaft, -0.06, 0.06),
    "lathe_mesh_small": lambda m: m.lathe_mesh(lambda z: 0.02 + 0.01 * z, -0.03, 0.05, 12, 20),
    "torus_mesh_cad": lambda m: m.torus_mesh(0.045, 0.016),
    "torus_mesh_small": lambda m: m.torus_mesh(0.03, 0.01, 24, 10),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_match_jax(name):
    _assert_same_mesh(GENERATORS[name](T), GENERATORS[name](J))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_harmonic_field_matches_jax(seed):
    p = np.random.default_rng(seed).normal(size=(50, 3))
    np.testing.assert_array_equal(T._harmonic_field(p, seed), J._harmonic_field(p, seed))


def test_cad_profile_face_counts(objects):
    assert {k: m.n_faces for k, m in objects["synthcad"].items()} == {
        1: 81920, 2: 128000, 3: 102400}


@pytest.mark.parametrize("dataset", list(MODELS))
@pytest.mark.parametrize("obj_id", [1, 2, 3])
def test_writers_byte_equal_to_jax(objects, dataset, obj_id, tmp_path):
    """save_ply binary and ASCII and save_obj on the millimetre model."""
    mesh = objects[dataset][obj_id]
    mm_t = T.Mesh(mesh.vertices * 1000.0, mesh.faces)
    mm_j = J.Mesh(mesh.vertices * 1000.0, mesh.faces)
    for binary in (True, False):
        T.save_ply(str(tmp_path / "t.ply"), mm_t, binary=binary)
        J.save_ply(str(tmp_path / "j.ply"), mm_j, binary=binary)
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes(), binary
    T.save_obj(str(tmp_path / "sub" / "t.obj"), mm_t)
    J.save_obj(str(tmp_path / "sub" / "j.obj"), mm_j)
    assert (tmp_path / "sub" / "t.obj").read_bytes() == (tmp_path / "sub" / "j.obj").read_bytes()
    _assert_same_mesh(T.load_obj(str(tmp_path / "sub" / "t.obj")),
                      J.load_obj(str(tmp_path / "sub" / "j.obj")))


@pytest.mark.parametrize("obj_id", [1, 2, 3])
def test_cad_models_byte_equal_to_checked_in(objects, obj_id, tmp_path):
    mesh = objects["synthcad"][obj_id]
    T.save_ply(str(tmp_path / "m.ply"), T.Mesh(mesh.vertices * 1000.0, mesh.faces), binary=True)
    checked_in = ROOT / f"data/bop/synthcad/models/obj_{obj_id:06d}.ply"
    assert (tmp_path / "m.ply").read_bytes() == checked_in.read_bytes()


@pytest.mark.parametrize("obj_id", [1, 2, 3])
def test_synth_models_equal_checked_in(objects, obj_id):
    """The checked-in ASCII models were written with 4 decimals: the
    port's model agrees within 1e-4 mm, faces exactly."""
    mesh = objects["synth"][obj_id]
    checked_in = load_ply(ROOT / f"data/bop/synth/models/obj_{obj_id:06d}.ply", scale=1.0)
    np.testing.assert_array_equal(checked_in.faces, mesh.faces)
    np.testing.assert_allclose(checked_in.vertices, mesh.vertices * 1000.0, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dataset", list(MODELS))
def test_diameters_equal_models_info(objects, dataset):
    info = json.loads((ROOT / f"data/bop/{dataset}/models/models_info.json").read_text())
    assert {k: v["diameter"] for k, v in info.items()} == {
        str(k): T.mesh_diameter(m) * 1000.0 for k, m in objects[dataset].items()}
    for k, m in objects[dataset].items():
        assert T.mesh_diameter(m) == J.mesh_diameter(J.Mesh(m.vertices, m.faces))


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
@pytest.mark.parametrize("shape", [(480, 640), (7, 5), (1, 1)])
def test_write_png_round_trip(dtype, shape, tmp_path):
    import imageio.v3 as iio

    hi = np.iinfo(dtype).max
    img = np.random.default_rng(shape[0]).integers(0, hi + 1, shape).astype(dtype)
    img.flat[0], img.flat[-1] = hi, 0
    path = tmp_path / "x.png"
    write_png(path, img)
    back = read_png(path)
    assert back.dtype == dtype
    np.testing.assert_array_equal(back, img)
    theirs = iio.imread(path)
    assert theirs.dtype == dtype
    np.testing.assert_array_equal(theirs, img)


def test_write_png_reads_like_the_checked_in_images(tmp_path):
    """A checked-in depth PNG and mask PNG written again decode to the same
    arrays."""
    scene = ROOT / "data/bop/synthcad/train/000001"
    for src in (scene / "depth/000000.png", scene / "mask_visib/000000_000000.png"):
        img = read_png(src)
        write_png(tmp_path / "x.png", img)
        np.testing.assert_array_equal(read_png(tmp_path / "x.png"), img)


@pytest.mark.parametrize("bad", [np.zeros((2, 2), np.float32), np.zeros((2, 2, 3), np.uint8),
                                 np.zeros(4, np.uint16)])
def test_write_png_refuses_other_arrays(bad, tmp_path):
    with pytest.raises(ValueError):
        write_png(tmp_path / "x.png", bad)
