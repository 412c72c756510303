"""The plain reference against hand-worked cases."""

import math
import struct
import zlib

import numpy as np
import pytest
import torch

from portbench.reference import estimate, png, prep, raster, smc
from portbench.reference.score import image_loglike


def _png(rows, depth, filters):
    """A grayscale PNG of ``rows`` (uint8 or uint16 [H, W]) with one filter
    byte per row, the filtered bytes worked out here."""
    h, w = rows.shape
    raw_rows = np.ascontiguousarray(rows, ">u2" if depth == 16 else np.uint8).view(np.uint8)
    raw_rows = raw_rows.reshape(h, -1).astype(np.int64)
    bpp = depth // 8
    out, prev = [], np.zeros(raw_rows.shape[1], np.int64)
    for y, f in enumerate(filters):
        cur = raw_rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - left
        elif f == 2:
            enc = cur - prev
        elif f == 3:
            enc = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            enc = cur - pred
        out.append(np.concatenate([[f], enc % 256]).astype(np.uint8))
        prev = cur

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("depth", [8, 16])
def test_png_every_filter(depth):
    rng = np.random.default_rng(depth)
    img = rng.integers(0, 2**depth, (5, 7)).astype(np.uint16 if depth == 16 else np.uint8)
    got = png.read_gray_png(_png(img, depth, [0, 1, 2, 3, 4]))
    assert got.dtype == img.dtype and np.array_equal(got, img)


def _cam():
    return raster.camera_scalars(10.0, 10.0, 4.0, 3.0, 0.0, 9, 7, 0.01, 10.0)


def test_raster_depth_of_a_facing_triangle():
    # a big triangle at z = 2 m facing the camera covers the grid centre
    verts = torch.tensor([[-1.0, -1.0, 0.0], [-1.0, 1.0, 0.0], [1.0, -1.0, 0.0]])
    faces = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    t = torch.tensor([[0.0, 0.0, 2.0], [0.0, 0.0, 2.0]])
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]])  # identity; half turn about x
    mu = raster.render_depth(verts, faces, _cam(), t, q).reshape(2, 7, 9)
    assert mu[0, 3, 4] == pytest.approx(2.0, rel=1e-6)
    # the hypotenuse x + y = 0 through the centre: the far corner is empty
    assert mu[0, 6, 8] == 0 and mu[0, 0, 0] == pytest.approx(2.0, rel=1e-6)
    # turned about x by pi the triangle faces away and is culled
    assert float(mu[1].abs().sum()) == 0.0
    # a tilted plane: depth is perspective-correct (1 / interpolated 1/z)
    verts2 = torch.tensor([[-5.0, -5.0, -1.0], [-5.0, 5.0, 1.0], [5.0, -5.0, -1.0]])
    mu2 = raster.render_depth(verts2, faces, _cam(), t[:1], q[:1]).reshape(7, 9)
    # the plane z = 2 + y/5: the ray of pixel row r has y = (r - 3)/10 z
    for r in (1, 3, 5):
        expect = 2.0 / (1.0 - (r - 3) / 50.0)
        assert float(mu2[r, 2]) == pytest.approx(expect, rel=1e-5)


P = dict(min_depth=0.5, max_depth=1.5, pixel_theta=1.0, pixel_sigma=0.01,
         association_sigma=0.02, c_reg=50.0)


def _mix(z, mu, sigma, o):
    normal = math.exp(-0.5 * ((z - mu) / sigma) ** 2) / (sigma * math.sqrt(2 * math.pi))
    tail = 0.5 * math.exp(-z / 1.0) / 1.0 + 0.5 / (1.5 - 0.5)
    return o * normal + (1 - o) * tail


def test_image_loglike_fixed_o_and_association():
    mu = torch.tensor([[1.0, 0.0]], dtype=torch.float64)  # an object and a background pixel
    z = torch.tensor([1.005, 1.2], dtype=torch.float64)
    prior = torch.tensor([0.7, 0.7], dtype=torch.float64)
    ll = image_loglike(mu, z, prior, P, "fixed_o", torch.float64)
    by_hand = math.log(_mix(1.005, 1.0, 0.01, 0.7)) + math.log(_mix(1.2, 0.0, 0.01, 0.7))
    assert float(ll[0]) == pytest.approx(50.0 / 2 * by_hand, rel=1e-9)
    ll = image_loglike(mu, z, prior, P, "association", torch.float64)
    p_is = 0.7 * math.exp(-0.5 * 0.25 ** 2) / (0.02 * math.sqrt(2 * math.pi))
    tail = 0.5 * math.exp(-1.005) + 0.5
    o = p_is / (p_is + 0.3 * tail)  # the background pixel keeps its prior
    by_hand = math.log(_mix(1.005, 1.0, 0.01, o)) + math.log(_mix(1.2, 0.0, 0.01, 0.7))
    assert float(ll[0]) == pytest.approx(50.0 / (o + 0.7) * by_hand, rel=1e-9)


def test_prep_on_a_centred_object():
    K = np.array([[500.0, 0.0, 20.0], [0.0, 500.0, 15.0], [0.0, 0.0, 1.0]])
    depth = np.zeros((31, 41), np.float32)
    mask = np.zeros((31, 41), bool)
    mask[13:18, 18:23] = True  # box centre (20, 15), on the principal point
    depth[mask] = 1.0
    point = prep.prior_point(depth, mask, K, diameter=0.1)
    assert np.allclose(point, [0.0, 0.0, 1.025])
    cam = prep.crop_camera(K, point, 0.1, 30, 30)
    side = 500.0 * 1.5 * 0.1 / 1.025  # the crop's side in source pixels
    assert cam["f_x"] == pytest.approx(500.0 * 30 / side)
    assert cam["c_x"] == pytest.approx(side / 2 * 30 / side)
    obs = prep.crop(depth, K, cam, 30, 30)
    assert obs[15, 15] == 1.0 and obs[0, 0] == 0.0


def test_temperatures_and_reweighting():
    temps = smc.temperatures(4, 5)
    assert np.array_equal(temps, np.float32([0.25, 0.5, 0.75, 1.0, 1.0]))
    lw = torch.full((4,), -math.log(4))
    w, resampled = smc.reweight(lw, torch.tensor([0.0, 0.0, 0.0, math.log(3)]), 0.5)
    assert not resampled  # ESS = 36/12 = 3 of 4
    assert torch.allclose(w.exp(), torch.tensor([1 / 6, 1 / 6, 1 / 6, 1 / 2]))
    w, resampled = smc.reweight(lw, torch.tensor([0.0, 0.0, 0.0, 10.0]), 0.5)
    assert resampled and torch.equal(w, torch.full((4,), -math.log(4)))


def test_weighted_pose():
    lw = torch.log(torch.tensor([0.25, 0.75]))
    t = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.4, 1.0]])
    half = math.sqrt(0.5)
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0], [-1.0, 0.0, 0.0, 0.0]])  # one rotation, both signs
    est_t, est_q = estimate.weighted_pose(lw, t, q)
    assert torch.allclose(est_t, torch.tensor([0.0, 0.3, 1.0], dtype=torch.float64))
    assert torch.allclose(est_q, torch.tensor([1.0, 0, 0, 0], dtype=torch.float64))
    qz = torch.tensor([half, 0.0, 0.0, half], dtype=torch.float64)
    assert estimate.rotation_gap(qz, est_q) == pytest.approx(math.pi / 2)


def test_mcmc_states_and_moves():
    """Two chains of five steps: the first moves at steps 2 and 4, the
    second never; each step's state is the distinct state it holds."""
    from portbench.reference.checks import mcmc

    t = torch.zeros(5, 2, 3)
    r = torch.tensor([1.0, 0.0, 0.0, 0.0]).expand(5, 2, 4).clone()
    t[2:, 0, 0] = 0.1
    r[4:, 0] = torch.tensor([0.0, 1.0, 0.0, 0.0])
    moved, first, state = mcmc.states(t, r)
    assert moved[:, 0].tolist() == [True, False, True, False, True]
    assert moved[:, 1].tolist() == [True, False, False, False, False]
    # flat (step, chain) indices: chain 0's states start at 0, 4, 8; chain 1's at 1
    assert first.tolist() == [0, 1, 4, 8]
    assert state.reshape(5, 2).tolist() == [[0, 1], [0, 1], [2, 1], [2, 1], [3, 1]]
