"""The binned raster algorithm of the CUDA kernel, in plain PyTorch on the CPU.

``jl_tpu_torch/csrc/render_score.cu`` tests a live triangle only at the
pixels of a bounding box, keeps a pose's faces in chunks and its image in
tiles of shared memory. Its box rule (``triangle_boxes``), its shared-memory
plan (``launch_plan``) and the algorithm itself
(``render_mu_binned_reference``) live in ``ops/cuda_raster.py`` and are held
here against ``render_mu_reference``, which tests every live triangle at every
pixel:

* the box never loses a pixel: every (triangle, pixel) pair that passes the
  fp32 inside test lies inside the triangle's box;
* the binned algorithm gives the same image bit for bit, also with forced
  small face chunks and image tiles;
* the box without its margin counts the work ``parity_cases.live_pairs`` counts.

The kernel itself needs an H100; ``chip_smoke.py`` holds it against the same
plain versions there (bitwise-equal images).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bayesianposeestimation.jl_tpu.camera import CvCamera as JCam
from bayesianposeestimation.jl_tpu.ops.pallas_raster import pallas_render_depth
from bayesianposeestimation.jl_tpu_torch.camera import CvCamera
from bayesianposeestimation.jl_tpu_torch.ops import cuda_raster
from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import (
    inside_test,
    launch_plan,
    render_depth,
    render_mu_binned_reference,
    render_mu_reference,
    render_score,
    triangle_boxes,
    triangle_forms,
)
from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
from bayesianposeestimation.jl_tpu_torch.utils import mesh_io

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import parity_cases  # noqa: E402  (imports nothing heavy until a case runs)

SHAPES = [(16, 16), (30, 30), (80, 60), (23, 37)]
MESHES = ["cube", "monkey"]


def _camera(w, h, f):
    return CvCamera(width=w, height=h, f_x=f, f_y=f, c_x=(w - 1) / 2, c_y=(h - 1) / 2,
                    near=0.01, far=10.0)


def _scene(mesh_name, w, h, n=4, seed=0):
    """Random rotations of the mesh half a metre away, spanning about a third
    of the image; the last pose hangs over the image's edge."""
    rng = np.random.default_rng(seed)
    mesh = mesh_io.cube_mesh(0.1) if mesh_name == "cube" else mesh_io.monkey_mesh(0.18)
    cam = _camera(w, h, 1.1 * max(w, h))
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = (np.array([0.0, 0.0, 0.5]) + 0.02 * rng.normal(size=(n, 3))).astype(np.float32)
    t[-1, 0] += 0.2  # partly off the viewport
    return (torch.as_tensor(mesh.vertices), torch.as_tensor(mesh.faces), cam,
            torch.as_tensor(t), torch.as_tensor(q))


def _passing_pairs_outside_box(args, backface_cull):
    """(pairs that pass the inside test, those of them outside the box, pairs
    that pass outside the box without its margin)."""
    cam = args[2]
    valid, forms = triangle_forms(*args, backface_cull=backface_cull)
    idx = torch.arange(cam.height * cam.width)
    col, row = idx % cam.width, idx // cam.width
    pu = col.float() - (cam.width - 1) / 2
    pv = row.float() - (cam.height - 1) / 2
    inside, _ = inside_test([x[:, :, None] for x in forms], pu, pv)
    inside &= valid[:, :, None]

    def in_box(box):
        c0, c1, r0, r1 = (b[:, :, None] for b in box)
        return (col >= c0) & (col <= c1) & (row >= r0) & (row <= r1)

    lost = inside & ~in_box(triangle_boxes(*args))
    beyond_extent = inside & ~in_box(triangle_boxes(*args, margin=False))
    return int(inside.sum()), int(lost.sum()), int(beyond_extent.sum())


@pytest.mark.parametrize("backface_cull", [True, False])
@pytest.mark.parametrize("w,h", SHAPES)
@pytest.mark.parametrize("mesh_name", MESHES)
def test_box_holds_every_passing_pixel(mesh_name, w, h, backface_cull):
    args = _scene(mesh_name, w, h, seed=w + h)
    n_inside, n_lost, _ = _passing_pairs_outside_box(args, backface_cull)
    assert n_inside > 50  # the object is in view
    assert n_lost == 0


@pytest.mark.parametrize("backface_cull", [True, False])
@pytest.mark.parametrize("w,h", SHAPES)
@pytest.mark.parametrize("mesh_name", MESHES)
def test_binned_equals_all_pixels_bitwise(mesh_name, w, h, backface_cull):
    args = _scene(mesh_name, w, h, seed=w + h)
    mu = render_mu_reference(*args, backface_cull=backface_cull)
    assert float((mu > 0).float().mean()) > 0.03
    binned = render_mu_binned_reference(*args, backface_cull=backface_cull)
    assert torch.equal(binned, mu)


SLIVER_SCALES = [1e-9, 1e-6, 1e-4, 1e-2, 0.3]


def _soup(seed, sliver_scale, depth_mode, w, h, n_tri=24):
    """Triangles drawn straight in pixel coordinates (a camera of focal length
    1 looking at z = 1 maps x, y to u, v exactly): corners exactly on pixel
    centres, inside the image, well outside it, far away; a third of the
    triangles are slivers (the third corner a hair off the line through the
    other two)."""
    gc = np.array([(w - 1) / 2, (h - 1) / 2])
    rng = np.random.default_rng(seed)

    def corners(n):
        mode = rng.integers(0, 4, size=(n, 1))
        on_centre = np.stack([rng.integers(-2, w + 2, size=n),
                              rng.integers(-2, h + 2, size=n)], 1) - gc
        within = rng.uniform(-0.5, 0.5, size=(n, 2)) * [w, h]
        around = rng.uniform(-3, 3, size=(n, 2)) * [w, h]
        far = rng.normal(size=(n, 2)) * 1e4
        return np.select([mode == 0, mode == 1, mode == 2], [on_centre, within, around], far)

    p0, p1, p2 = corners(n_tri), corners(n_tri), corners(n_tri)
    d = p1 - p0
    normal = np.stack([-d[:, 1], d[:, 0]], 1) / (np.linalg.norm(d, axis=1, keepdims=True) + 1e-12)
    on_line = p0 + rng.uniform(-0.5, 1.5, size=(n_tri, 1)) * d
    off = sliver_scale * rng.uniform(0.1, 1, size=(n_tri, 1)) * rng.choice([-1, 1], (n_tri, 1))
    is_sliver = rng.random((n_tri, 1)) < 1 / 3
    p2 = np.where(is_sliver, on_line + off * normal, p2)
    z = np.ones((n_tri, 3))
    if depth_mode == "mixed":
        z = np.where(rng.random((n_tri, 3)) < 0.5, 1.0, rng.uniform(0.3, 5.0, size=(n_tri, 3)))
    xyz = np.concatenate([np.stack([p0, p1, p2], 1) * z[..., None], z[..., None]], -1)
    verts = torch.as_tensor(xyz.reshape(-1, 3).astype(np.float32))
    faces = torch.arange(3 * n_tri, dtype=torch.int32).reshape(-1, 3)
    return (verts, faces, _camera(w, h, 1.0), torch.zeros(1, 3),
            torch.tensor([[1.0, 0.0, 0.0, 0.0]]))


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.integers(0, 2**32 - 1), st.sampled_from(SLIVER_SCALES),
       st.sampled_from(["flat", "mixed"]), st.sampled_from(SHAPES + [(31, 30)]))
def test_box_and_binned_on_slivers_pixel_centres_and_off_viewport(seed, sliver_scale,
                                                                  depth_mode, shape):
    args = _soup(seed, sliver_scale, depth_mode, *shape)
    _, n_lost, _ = _passing_pairs_outside_box(args, backface_cull=False)
    assert n_lost == 0
    mu = render_mu_reference(*args, backface_cull=False)
    assert torch.equal(render_mu_binned_reference(*args, backface_cull=False), mu)
    assert torch.equal(render_mu_binned_reference(*args, backface_cull=False, face_budget=5,
                                                  pixel_budget=3 * shape[0] + 1), mu)


def test_margin_is_needed_and_vertices_on_centres_are_kept():
    """The soup does reach pixels that pass the test outside the exact
    extent (so the margin is not idle), and a triangle whose corners sit
    exactly on pixel centres keeps those pixels."""
    beyond = 0
    for seed in range(40):
        args = _soup(seed, SLIVER_SCALES[seed % 5], ["flat", "mixed"][seed % 2], 30, 30,
                     n_tri=200)
        n_inside, n_lost, n_beyond = _passing_pairs_outside_box(args, backface_cull=False)
        assert n_lost == 0
        beyond += n_beyond
    assert beyond > 0
    w = h = 9  # pixel centres at integer grid-centred coordinates
    verts = torch.tensor([[-2.0, -2.0, 1.0], [2.0, -2.0, 1.0], [-2.0, 2.0, 1.0]])
    faces = torch.tensor([[0, 2, 1], [0, 1, 2]], dtype=torch.int32)
    args = (verts, faces, _camera(w, h, 1.0), torch.zeros(1, 3),
            torch.tensor([[1.0, 0.0, 0.0, 0.0]]))
    c0, c1, r0, r1 = triangle_boxes(*args)
    assert (c0.tolist(), c1.tolist(), r0.tolist(), r1.tolist()) == (
        [[2, 2]], [[6, 6]], [[2, 2]], [[6, 6]])
    mu = render_mu_binned_reference(*args).reshape(h, w)
    assert torch.equal(mu, render_mu_reference(*args).reshape(h, w))
    assert float(mu[2, 2]) == 1.0 and float(mu[2, 6]) == 1.0 and float(mu[6, 2]) == 1.0
    assert float(mu[6, 6]) == 0.0 and int((mu > 0).sum()) == 15


def test_unwidened_boxes_count_live_pairs_on_a_hand_checked_cube():
    """A 0.1 m cube facing the camera at 1 m, focal length 100 px, 16x16:
    only the front face (z = 0.95) is live; it spans ±5.263 px around the
    centre 7.5, so columns and rows 3..12: two triangles whose boxes are
    both that 10x10 square, 200 pairs."""
    mesh = mesh_io.cube_mesh(0.1)
    args = (torch.as_tensor(mesh.vertices), torch.as_tensor(mesh.faces), _camera(16, 16, 100.0),
            torch.tensor([[0.0, 0.0, 1.0]]), torch.tensor([[1.0, 0.0, 0.0, 0.0]]))
    valid, _ = triangle_forms(*args)
    assert int(valid.sum()) == 2
    c0, c1, r0, r1 = triangle_boxes(*args, margin=False)
    for b, expect in ((c0, 3), (c1, 12), (r0, 3), (r1, 12)):
        assert b[valid].tolist() == [expect, expect]
    area = (c1 - c0 + 1).clamp(min=0) * (r1 - r0 + 1).clamp(min=0)
    assert int(area[valid].sum()) == 200
    assert parity_cases.live_pairs(*args) == 200
    # the margin adds nothing here: the nearest outside centre is 0.26 px away
    assert all(torch.equal(a, b) for a, b in zip(triangle_boxes(*args), (c0, c1, r0, r1)))


@pytest.mark.parametrize("mesh_name,w,h", [("monkey", 30, 30), ("cube", 80, 60),
                                           ("monkey", 23, 37)])
def test_unwidened_boxes_equal_live_pairs(mesh_name, w, h):
    args = _scene(mesh_name, w, h, seed=5)
    valid, _ = triangle_forms(*args)
    c0, c1, r0, r1 = triangle_boxes(*args, margin=False)
    area = (c1 - c0 + 1).clamp(min=0) * (r1 - r0 + 1).clamp(min=0)
    assert int(area[valid].sum()) == parity_cases.live_pairs(*args) > 0


@pytest.mark.parametrize("mesh_name,w,h,face_budget,pixel_budget", [
    ("cube", 23, 37, 7, None), ("cube", 23, 37, None, 50), ("cube", 23, 37, 5, 100),
    ("cube", 23, 37, 1, 1), ("cube", 23, 37, 11, 23), ("monkey", 80, 60, 100, None),
    ("monkey", 80, 60, None, 400), ("monkey", 80, 60, 300, 81), ("monkey", 80, 60, 64, 160),
    ("monkey", 80, 60, 1279, 4799)])
def test_chunked_faces_and_banded_rows_give_the_same_image(mesh_name, w, h, face_budget,
                                                           pixel_budget):
    args = _scene(mesh_name, w, h, n=2, seed=9)
    plan = launch_plan(args[0].shape[0], args[1].shape[0], h, w, face_budget=face_budget,
                       pixel_budget=pixel_budget)
    assert plan["face_cap"] < args[1].shape[0] or plan["band_rows"] * plan["band_cols"] < w * h
    mu = render_mu_reference(*args)
    assert torch.equal(render_mu_binned_reference(*args, face_budget=face_budget,
                                                  pixel_budget=pixel_budget), mu)


@pytest.mark.parametrize("n_verts,n_faces,h,w,n_poses", [
    (642, 1280, 30, 30, 100), (130, 256, 60, 80, 600), (130, 256, 60, 80, 1250),
    (642, 1280, 480, 640, 8), (8, 12, 16, 16, 1), (100_000, 200_000, 1080, 1920, 4),
    (3, 1, 1, 100_000, 2), (0, 0, 4, 4, 1)])
def test_launch_plan_fits_shared_memory_and_covers_the_image(n_verts, n_faces, h, w, n_poses):
    plan = launch_plan(n_verts, n_faces, h, w, n_poses)
    words = ((3 * n_verts if plan["cache_verts"] else 0) + 13 * plan["face_cap"]
             + plan["band_rows"] * plan["band_cols"])
    # dynamic and static shared memory together fit what a block may take
    assert plan["smem_bytes"] == 4 * words
    assert plan["smem_bytes"] + cuda_raster._SMEM_STATIC <= 232448
    assert plan["threads"] == (512 if n_poses <= 264 else 256)
    assert 1 <= plan["face_cap"] <= max(n_faces, 1)
    assert 1 <= plan["band_rows"] <= h and 1 <= plan["band_cols"] <= w
    if 13 * 4 * n_faces + 12 * n_verts + 4 * h * w <= 100_000:  # everything fits at once
        assert plan["cache_verts"] and plan["face_cap"] == max(n_faces, 1)
        assert (plan["band_rows"], plan["band_cols"]) == (h, w)


def test_launch_plan_rejects_bad_tuning_and_the_cpu_ignores_tuning():
    for bad in ({"face_budget": 0}, {"pixel_budget": -1},
                {"pixel_budget": 10**6, "face_budget": 4000}):
        with pytest.raises(ValueError):
            launch_plan(642, 1280, 480, 640, 8, **bad)
    for bad in ({"threads": 100}, {"lanes": 8}):  # the kernel's own choices
        with pytest.raises(TypeError):
            launch_plan(642, 1280, 480, 640, 8, **bad)
    args = _scene("cube", 16, 16, n=2)
    tuning = {"face_budget": 5, "pixel_budget": 40}
    mu = render_depth(*args, device="cpu", tuning=tuning)  # the plain version: no plan
    assert torch.equal(mu, render_depth(*args, device="cpu"))
    z = torch.where(mu[0] > 0, mu[0], torch.full_like(mu[0], torch.inf))
    params = Parameters(width=16, height=16, device="cpu")
    a = render_score(*args, z, 0.7, params, "simple", device="cpu", tuning=tuning)
    b = render_score(*args, z, 0.7, params, "simple", device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("n_verts,n_faces,h,w,n_poses,slices,face_cap", [
    # the BOP evaluation: 3 poses of the 81,920-face model at 100x100 -> about
    # two blocks per SM (88), 931 faces each, one chunk beside the whole image
    (41_000, 81_920, 100, 100, 3, 88, 931),
    # 5 poses of the 128,000-face model: 53 slices of 2,416 faces would not
    # fit one chunk (2,194), so 59 slices of 2,170
    (64_000, 128_000, 100, 100, 5, 59, 2170),
    # from half the SMs on the poses take one block each: the bench shape,
    # the tracking stream's synthesis and the tracking shape (today's launch)
    (642, 1280, 30, 30, 100, 1, 1280), (642, 1280, 60, 80, 120, 1, 1280),
    (130, 256, 60, 80, 600, 1, 256),
    (642, 1280, 30, 30, 65, 5, 256),
    (130, 256, 60, 80, 24, 1, 256),  # a slice keeps at least 256 faces
    (642, 1280, 480, 640, 8, 5, 256),
    (8, 12, 16, 16, 1, 1, 12), (0, 0, 4, 4, 1, 1, 1)])
def test_launch_plan_splits_a_few_poses_faces_over_blocks(n_verts, n_faces, h, w, n_poses,
                                                          slices, face_cap):
    plan = launch_plan(n_verts, n_faces, h, w, n_poses, depth_only=True)
    assert (plan["face_slices"], plan["face_cap"]) == (slices, face_cap)
    assert plan["smem_bytes"] + cuda_raster._SMEM_STATIC <= 232448
    assert plan["face_cap"] == max(1, -(-n_faces // slices))  # a slice is one chunk
    if slices > 1:  # never fewer blocks than fill the card, unless slices get small
        assert n_poses < cuda_raster._SPLIT_BELOW
        assert (n_poses * slices >= cuda_raster._POSES_FILL
                or -(-n_faces // (slices + 1)) < cuda_raster._SLICE_FACES)
    # the score kernels' plan is unchanged: one block per pose
    score = launch_plan(n_verts, n_faces, h, w, n_poses)
    assert score["face_slices"] == 1 and score["threads"] == plan["threads"]


def test_launch_plan_rejects_bad_face_slices():
    for bad in (0, -2):
        with pytest.raises(ValueError):
            launch_plan(642, 1280, 30, 30, 4, face_slices=bad, depth_only=True)
    with pytest.raises(ValueError):  # a score kernel takes one block per pose
        launch_plan(642, 1280, 30, 30, 4, face_slices=2)
    with pytest.raises(ValueError):  # more blocks than a launch can have
        launch_plan(642, 1280, 30, 30, 2**20, face_slices=2**12, depth_only=True)
    forced = launch_plan(642, 1280, 30, 30, 600, face_slices=7, face_budget=50,
                         depth_only=True)
    assert (forced["face_slices"], forced["face_cap"]) == (7, 50)


@pytest.mark.parametrize("mesh_name,w,h,face_slices,face_budget,pixel_budget", [
    ("monkey", 30, 30, 1, None, None), ("monkey", 30, 30, 2, None, None),
    ("monkey", 30, 30, 7, None, None), ("monkey", 80, 60, 64, None, None),
    ("cube", 16, 16, 40, None, None),  # more slices than faces: some are empty
    ("cube", 23, 37, 5, 1, 50),  # slices, one-face chunks and tiles together
    ("monkey", 80, 60, 9, 33, 160), ("monkey", 23, 37, 3, 100, 81)])
def test_face_slices_give_the_same_image(mesh_name, w, h, face_slices, face_budget,
                                         pixel_budget):
    args = _scene(mesh_name, w, h, n=3, seed=4)
    mu = render_mu_reference(*args)
    assert float((mu > 0).float().mean()) > 0.03
    assert torch.equal(render_mu_binned_reference(*args, face_slices=face_slices,
                                                  face_budget=face_budget,
                                                  pixel_budget=pixel_budget), mu)


def test_face_slices_of_a_large_mesh_give_the_same_image():
    """A 5,120-face mesh, 3 poses at 64x64, every face drawn: the automatic
    plan splits each pose into 20 slices of 256 faces."""
    sphere = mesh_io.icosphere_mesh(0.1, 4)
    rng = np.random.default_rng(2)
    q = rng.normal(size=(3, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = (np.array([0.0, 0.0, 0.3]) + 0.02 * rng.normal(size=(3, 3))).astype(np.float32)
    args = (torch.as_tensor(sphere.vertices), torch.as_tensor(sphere.faces),
            _camera(64, 64, 60.0), torch.as_tensor(t), torch.as_tensor(q))
    plan = launch_plan(args[0].shape[0], args[1].shape[0], 64, 64, 3, depth_only=True)
    assert plan["face_slices"] == 20
    mu = render_mu_reference(*args, backface_cull=False)
    assert float((mu > 0).float().mean()) > 0.2
    assert torch.equal(render_mu_binned_reference(*args, backface_cull=False), mu)


def test_binned_reference_matches_pallas_render_depth():
    """The binned algorithm against the TPU kernel run in interpret mode, at
    the tolerances of tests/test_torch_render_depth.py (the two rasterisers
    evaluate the edge functions by different arithmetic)."""
    rng = np.random.default_rng(7)
    mesh = mesh_io.icosphere_mesh(0.06, 1)
    w, h, n = 32, 24, 6
    cam = dict(width=w, height=h, f_x=110.0, f_y=110.0, c_x=(w - 1) / 2, c_y=(h - 1) / 2,
               near=0.01, far=10.0)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = (np.array([0.0, 0.0, 1.0]) + 0.03 * rng.normal(size=(n, 3))).astype(np.float32)
    mu_t = render_mu_binned_reference(
        torch.as_tensor(mesh.vertices), torch.as_tensor(mesh.faces), CvCamera(**cam),
        torch.as_tensor(t), torch.as_tensor(q), face_budget=30, pixel_budget=200)
    mu_t = mu_t.reshape(n, h, w).numpy()
    mu_j = np.asarray(pallas_render_depth(jnp.asarray(mesh.vertices), jnp.asarray(mesh.faces),
                                          JCam(**cam), jnp.asarray(t), jnp.asarray(q), chunk=128))
    assert (mu_j > 0).mean() > 0.05
    assert np.mean((mu_t > 0) != (mu_j > 0)) < 5e-3
    both = (mu_t > 0) & (mu_j > 0)
    assert np.percentile(np.abs(mu_t[both] - mu_j[both]) / mu_j[both], 99) < 1e-4


def test_plan_arguments_match_the_kernel_source():
    """The plan crosses from Python to CUDA as positional integers: the C
    entry points' parameters and ``struct Plan`` take them in the order of
    ``_PLAN_ARGS`` (score kernels) and ``_DEPTH_PLAN_ARGS`` (depth-only)."""
    import re

    src = (Path(cuda_raster.__file__).resolve().parents[1] / "csrc" / "render_score.cu").read_text()

    def params(entry):
        sig = re.search(rf"extern \"C\" int {entry}\((.*?)\)\s*{{", src, re.S).group(1)
        return [p.split()[-1].lstrip("*") for p in sig.split(",")]

    assert params("bpe_render_score")[-6:-1] == list(cuda_raster._PLAN_ARGS)
    assert params("bpe_render_depth")[-7:-1] == list(cuda_raster._DEPTH_PLAN_ARGS)
    assert params("bpe_render_depth")[-1] == "stream"
    plan = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*int ([\w, ]+);", plan, re.M)
    names = [n.strip() for f in fields for n in f.split(",")]
    assert names == list(cuda_raster._DEPTH_PLAN_ARGS[1:])  # threads is the launch's own


def test_box_constants_match_the_kernel_source():
    """The box rule and the plan are written twice, in Python and in CUDA:
    the constants of the two must be the same numbers."""
    src = (Path(cuda_raster.__file__).resolve().parents[1] / "csrc" / "render_score.cu").read_text()

    def constant(name):
        line = next(ln for ln in src.splitlines() if "constexpr" in ln and f" {name} =" in ln)
        return float(line.split("=")[1].split(";")[0].strip().rstrip("fu"))

    assert constant("kFormWords") == cuda_raster._FORM_WORDS
    assert np.float32(constant("kBoxTol")) == np.float32(cuda_raster._BOX_TOL)
    assert np.float32(constant("kBoxErr")) == np.float32(cuda_raster._BOX_ERR)
    assert np.float32(constant("kBoxSlack")) == np.float32(cuda_raster._BOX_SLACK)
    assert constant("kBoxWhole") == cuda_raster._BOX_WHOLE
    assert np.float32(constant("kTol")) == np.float32(cuda_raster._TOL)
    assert constant("kMaxThreads") == 512
    # the static shared memory (two accumulator arrays and three counters)
    # fits its reserve, and the reserve is the same number on both sides
    assert constant("kSmemStatic") == cuda_raster._SMEM_STATIC
    assert constant("kSmemLimit") == cuda_raster._SMEM_LIMIT + cuda_raster._SMEM_STATIC == 232448
    static = 2 * int(constant("kAccumulators")) * 16 * 4 + 3 * 4
    assert -(-static // 16) * 16 <= cuda_raster._SMEM_STATIC


SM_SMEM, RESERVED = 233472, 1024  # an H100 SM's shared memory; the runtime's reserve a block


@pytest.mark.parametrize("n_verts,n_faces,h,w,n_poses,kw,path,face_cap,blocks", [
    # the res100 cell's 20,000 faces at 100x100: ceil(N / 132) blocks an SM, at
    # most 4 of 256 threads (2 of 512) by registers
    (10_002, 20_000, 100, 100, 1000, {}, "resident", 252, 4),
    (10_002, 20_000, 100, 100, 500, {}, "resident", 252, 4),
    (10_002, 20_000, 100, 100, 300, {}, "resident", 626, 3),
    (10_002, 20_000, 100, 100, 200, {}, "resident", 1374, 2),
    (10_002, 20_000, 100, 100, 133, {}, "resident", 1374, 2),
    (10_002, 20_000, 100, 100, 132, {}, "chunked", 2194, 1),  # a block an SM already
    (10_002, 20_000, 100, 100, 100, {}, "chunked", 2194, 1),
    (1_602, 3_200, 40, 40, 1000, {}, "resident", 528, 4),  # the CAD decimation at 40x40
    (10_242, 20_480, 120, 160, 600, {}, "resident", 667, 2),
    (10_002, 20_000, 165, 165, 1000, {}, "chunked", 2194, 1),  # two blocks leave < 128 faces
    (40_962, 81_920, 100, 100, 1000, {}, "resident", 252, 4),  # the evaluation meshes' size
    (10_002, 20_000, 100, 100, 1000, {"depth_only": True}, "chunked", 2194, 1),
    # one block an SM: the face_cap of the plan for no pose count, forced
    (10_002, 20_000, 100, 100, 1000, {"face_budget": 2194}, "chunked", 2194, 1),
    (642, 1280, 30, 30, 100, {}, "one_chunk", 1280, 2),
    (642, 1280, 30, 30, 100, {"face_budget": 400}, "resident", 400, 2),  # forced
    (130, 256, 60, 80, 600, {"face_budget": 85}, "resident", 85, 4),
    (642, 1280, 30, 30, 100, {"face_budget": 400, "pixel_budget": 450}, "banded", 400, 2),
    (642, 1280, 480, 640, 8, {}, "banded", 1280, 1)])
def test_launch_plan_takes_the_resident_path_where_faces_take_chunks_and_the_image_fits(
        n_verts, n_faces, h, w, n_poses, kw, path, face_cap, blocks):
    plan = launch_plan(n_verts, n_faces, h, w, n_poses, **kw)
    assert (plan["path"], plan["face_cap"], plan["blocks_per_sm"]) == (path, face_cap, blocks)
    # the footprint, times the blocks an SM holds, fits the SM, and so do the
    # blocks' registers at 64 a thread
    assert plan["blocks_per_sm"] * (plan["smem_bytes"] + cuda_raster._SMEM_STATIC
                                    + RESERVED) <= SM_SMEM
    assert plan["blocks_per_sm"] * plan["threads"] * 64 <= 65536
    words = ((3 * n_verts if plan["cache_verts"] else 0) + 13 * plan["face_cap"]
             + plan["band_rows"] * plan["band_cols"])
    assert plan["smem_bytes"] == 4 * words
    # the rule shrinks the chunks only where the plan without it (one block
    # an SM: the face_cap of the plan for no pose count) takes the faces in
    # chunks beside the whole image, for a score launch, and to no more
    # blocks than the poses fill
    one_block = launch_plan(n_verts, n_faces, h, w)["face_cap"]
    before = launch_plan(n_verts, n_faces, h, w, n_poses, **{"face_budget": one_block, **kw})
    if plan != before:
        assert "face_budget" not in kw and not kw.get("depth_only")
        assert before["path"] == "chunked" and before["face_cap"] < n_faces
        assert n_poses > cuda_raster._SMS
        assert 2 <= plan["blocks_per_sm"] <= -(-n_poses // cuda_raster._SMS)
        assert plan["face_cap"] >= plan["threads"] // 2
        assert plan["threads"] == before["threads"] and plan["cache_verts"] == before["cache_verts"]
    if plan["path"] == "resident":
        assert (plan["band_rows"], plan["band_cols"]) == (h, w)
        assert plan["face_cap"] < n_faces and plan["blocks_per_sm"] >= 2


@pytest.mark.parametrize("mesh,h,w,n_poses", [
    ("synthcad_obj_1_1800", 30, 30, 100), ("synthcad_obj_2_1800", 30, 30, 100),
    ("synthcad_obj_3_1800", 30, 30, 100), ("monkey_0.18_256", 60, 80, 600)])
def test_score_plans_of_the_benchmark_meshes_are_unchanged(mesh, h, w, n_poses):
    """The `.bop` cell's three 1,800-face meshes at 30x30 and 100 poses and
    the `.synth120` cell's 256-face monkey at 80x60 and 600 poses keep the
    one-chunk plan they had before the resident form existed."""
    with np.load(Path(__file__).resolve().parents[1] / "portbench/data/meshes" / f"{mesh}.npz") as m:
        n_verts, n_faces = m["vertices"].shape[0], m["faces"].shape[0]
    before = {"synthcad_obj_1_1800": (512, 1800, 108024), "synthcad_obj_2_1800": (512, 1800, 108024),
              "synthcad_obj_3_1800": (512, 1800, 108000), "monkey_0.18_256": (256, 256, 34072)}
    threads, face_cap, smem = before[mesh]
    plan = launch_plan(n_verts, n_faces, h, w, n_poses)
    assert {k: plan[k] for k in ("threads", "cache_verts", "face_cap", "band_rows",
                                 "band_cols", "smem_bytes", "face_slices", "path")} == {
        "threads": threads, "cache_verts": True, "face_cap": face_cap, "band_rows": h,
        "band_cols": w, "smem_bytes": smem, "face_slices": 1, "path": "one_chunk"}


@pytest.mark.parametrize("mesh_name,w,h,face_budget", [
    ("monkey", 30, 30, 400), ("monkey", 80, 60, 100), ("monkey", 23, 37, 1),
    ("cube", 16, 16, 5), ("cube", 23, 37, 1)])
def test_binned_reference_under_the_resident_plan_equals_all_pixels(mesh_name, w, h,
                                                                    face_budget):
    args = _scene(mesh_name, w, h, n=3, seed=6)
    plan = launch_plan(args[0].shape[0], args[1].shape[0], h, w, 3, face_budget=face_budget)
    assert plan["path"] == "resident"
    mu = render_mu_reference(*args)
    assert float((mu > 0).float().mean()) > 0.03
    assert torch.equal(render_mu_binned_reference(*args, face_budget=face_budget,
                                                  depth_only=False), mu)


def test_occupancy_entry_point_in_the_kernel_source():
    """The card holds ``blocks_per_sm`` to the runtime's count through this
    entry point (``chip_smoke.occupancy``)."""
    import re

    src = (Path(cuda_raster.__file__).resolve().parents[1] / "csrc" / "render_score.cu").read_text()
    assert re.search(r"extern \"C\" int bpe_score_occupancy\(int epilogue, int with_mu, "
                     r"int threads, int smem_bytes,\s+int\* blocks\)", src)
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in src
