"""Colour images in the port: ``utils.png`` (colour types 2, 3, 4, 6),
``utils.jpeg`` and ``utils.bop.load_color_image``, against imageio and the
JAX package.

PNGs that imageio writes, and PNGs a small encoder here writes at every
bit depth the specification allows for each colour type with each of the
five row filters (alone, and mixed row by row), decode bitwise equal to
``imageio.v3.imread``. JPEGs that Pillow writes at quality 50 and 95 with
4:4:4, 4:2:2 and 4:2:0 chroma and in grayscale (odd sizes, with and without
restart markers), with RGB stored (Adobe transform 0, and with the Adobe
marker taken out so that the component ids decide), and JPEGs a small
baseline encoder here writes at the sampling factors Pillow cannot write
(4:4:0, 4:1:1, mixed ratios, narrow images) and under each colour-space
marker, decode bitwise equal to imageio's decode (libjpeg-turbo's);
progressive and CMYK files raise. ``load_color_image`` of both packages
agrees on a temporary BOP scene.
"""

import struct
import zlib

import imageio.v3 as iio
import numpy as np
import pytest
from PIL import Image

from bayesianposeestimation.jl_tpu.utils import bop as jbop
from bayesianposeestimation.jl_tpu_torch.utils import bop
from bayesianposeestimation.jl_tpu_torch.utils.jpeg import read_jpeg
from bayesianposeestimation.jl_tpu_torch.utils.png import read_png

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _pack(samples, depth):
    """[H, W, C] samples -> [H, stride] bytes as PNG rows store them."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    flat = np.concatenate([flat, np.zeros((h, (-flat.shape[1]) % per), flat.dtype)], axis=1)
    groups = flat.reshape(h, -1, per).astype(np.uint8)
    return sum(groups[:, :, i] << (8 - depth * (i + 1)) for i in range(per)).astype(np.uint8)


def _filter_rows(rows, bpp, filters):
    """PNG row filtering of byte rows [H, stride], filter types cycled."""
    out, prev = b"", np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
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
            enc = row - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out += bytes([f]) + (enc % 256).astype(np.uint8).tobytes()
        prev = row
    return out


def _write_png(path, samples, depth, colour, filters=(0,), extra=b"", interlace=0):
    h, w = samples.shape[:2]
    bpp = max(depth * CHANNELS[colour] // 8, 1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + extra
                     + _chunk(b"IDAT", zlib.compress(_filter_rows(_pack(samples, depth), bpp,
                                                                  filters)))
                     + _chunk(b"IEND", b""))


def _assert_png_equal(path):
    ours, ref = read_png(path), np.asarray(iio.imread(path))
    assert ours.dtype == ref.dtype and ours.shape == ref.shape, (ours.shape, ref.shape)
    np.testing.assert_array_equal(ours, ref)
    return ours


@pytest.mark.parametrize("colour,depth", [(2, 8), (2, 16), (4, 8), (4, 16), (6, 8), (6, 16),
                                          (3, 1), (3, 2), (3, 4), (3, 8)])
def test_png_colour_types_every_filter(tmp_path, colour, depth):
    """Each allowed (colour type, bit depth), an odd width, each filter alone
    and all mixed: bitwise equal to imageio's decode (16-bit colour keeps the
    high byte, 16-bit grey + alpha comes back as RGBA, a palette as RGB)."""
    rng = np.random.default_rng(colour * 100 + depth)
    h, w = 7, 13
    top = 2 ** depth if colour != 3 else min(2 ** depth, 11)
    samples = rng.integers(0, top, (h, w, CHANNELS[colour]))
    samples[2:5, 3:9] = samples[0, 0]  # flat patches, where the filters predict well
    extra = b""
    if colour == 3:
        extra = _chunk(b"PLTE", rng.integers(0, 256, 3 * top, dtype=np.uint8).tobytes())
    for name, filters in [(f"f{f}", (f,)) for f in range(5)] + [("mixed", (4, 1, 3, 2, 0))]:
        p = tmp_path / f"{name}.png"
        _write_png(p, samples, depth, colour, filters, extra)
        out = _assert_png_equal(p)
        if colour in (2, 6) or (colour, depth) == (4, 8):
            expect = samples >> 8 if depth == 16 else samples
            np.testing.assert_array_equal(out, expect.astype(np.uint8))


@pytest.mark.parametrize("channels", [2, 3, 4])
def test_png_written_by_imageio(tmp_path, channels):
    """Grey + alpha, RGB and RGBA files as imageio writes them."""
    img = np.random.default_rng(channels).integers(0, 256, (11, 17, channels), dtype=np.uint8)
    iio.imwrite(tmp_path / "a.png", img)
    np.testing.assert_array_equal(_assert_png_equal(tmp_path / "a.png"), img)


def test_png_palette_transparency_ignored_as_imageio_does(tmp_path):
    rng = np.random.default_rng(9)
    samples = rng.integers(0, 4, (5, 6, 1))
    extra = (_chunk(b"PLTE", rng.integers(0, 256, 12, dtype=np.uint8).tobytes())
             + _chunk(b"tRNS", bytes([0, 128])))
    _write_png(tmp_path / "t.png", samples, 4, 3, extra=extra)
    with pytest.warns(UserWarning):  # Pillow's own note on such files
        assert _assert_png_equal(tmp_path / "t.png").shape == (5, 6, 3)


@pytest.mark.parametrize("bad", [dict(depth=4, colour=2), dict(depth=8, colour=2, interlace=1),
                                 dict(depth=16, colour=3), dict(depth=8, colour=3, plte=False)])
def test_png_colour_raises_on_what_it_cannot_read(tmp_path, bad):
    """A depth the specification does not allow, interlacing, a palette
    image without PLTE: ValueError, not a misread image."""
    samples = np.zeros((4, 5, CHANNELS[bad["colour"]]), np.int64)
    extra = _chunk(b"PLTE", bytes(6)) if bad["colour"] == 3 and bad.get("plte", True) else b""
    _write_png(tmp_path / "bad.png", samples, bad["depth"], bad["colour"], extra=extra,
               interlace=bad.get("interlace", 0))
    with pytest.raises(ValueError):
        read_png(tmp_path / "bad.png")


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / 7.0 + c) * np.cos(yy / 5.0 - c) for c in range(3)],
                    -1)
    return np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)


def _assert_jpeg_equal(path):
    ours, ref = read_jpeg(path), np.asarray(iio.imread(path))
    assert ours.dtype == ref.dtype and ours.shape == ref.shape, (ours.shape, ref.shape)
    np.testing.assert_array_equal(ours, ref)
    return ours


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0", "gray"])
@pytest.mark.parametrize("quality", [50, 95])
def test_jpeg_equals_imageio(tmp_path, quality, subsampling):
    """Pillow's files (odd sizes: partial MCUs and chroma columns; with and
    without restart markers, optimised Huffman tables) against imageio's
    decode of them, bitwise."""
    for (h, w), extra in (((45, 61), {}), ((17, 9), {"restart_marker_blocks": 3}),
                          ((48, 64), {"optimize": True})):
        img = _image(h, w, quality + h)
        if subsampling == "gray":
            im, kw = Image.fromarray(img[..., 0]), {}
        else:
            im, kw = Image.fromarray(img), {"subsampling": ["4:4:4", "4:2:2",
                                                            "4:2:0"].index(subsampling)}
        p = tmp_path / f"{h}x{w}.jpg"
        im.save(p, quality=quality, **kw, **extra)
        _assert_jpeg_equal(p)


def _strip_adobe(data):
    """The JPEG bytes without their APP14 (Adobe) segment."""
    at = data.index(b"\xff\xee")
    (length,) = struct.unpack(">H", data[at + 2:at + 4])
    return data[:at] + data[at + 2 + length:]


@pytest.mark.parametrize("adobe", [True, False])
def test_jpeg_rgb_stored_equals_imageio(tmp_path, adobe):
    """Pillow's ``keep_rgb`` file stores R, G, B (component ids 'R', 'G',
    'B', an Adobe marker with transform 0, no JFIF marker); without the
    Adobe marker the ids decide. Neither is converted from YCbCr."""
    img = _image(21, 34, 5)
    p = tmp_path / "rgb.jpg"
    Image.fromarray(img).save(p, quality=90, keep_rgb=True)
    data = p.read_bytes()
    assert b"Adobe" in data and b"JFIF" not in data
    if not adobe:
        p.write_bytes(_strip_adobe(data))
    _assert_jpeg_equal(p)


def _zigzag():
    """Natural (row-major) index of each zigzag position."""
    cells = sorted(((i, j) for i in range(8) for j in range(8)),
                   key=lambda c: (c[0] + c[1], c[0] if (c[0] + c[1]) % 2 else -c[0]))
    return np.array([i * 8 + j for i, j in cells])


def _write_jpeg(path, planes, factors, ids=(1, 2, 3), app=b"", q=3):
    """A baseline JPEG of full-size uint8 ``planes`` [H, W] at sampling
    ``factors`` [(h, v)] (a plane is subsampled by striding), one flat
    quantisation table ``q``, and Huffman tables where every DC category
    has a 4-bit code and every AC symbol a 9-bit one. It writes what Pillow
    cannot: any sampling factors, any colour-space marker."""
    height, width = planes[0].shape
    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    one = len(planes) == 1  # not interleaved: one block per MCU
    mcux = -(-width // (8 * (1 if one else hmax)))
    mcuy = -(-height // (8 * (1 if one else vmax)))
    dct = np.array([[np.sqrt((1 if k == 0 else 2) / 8) * np.cos((2 * n + 1) * k * np.pi / 16)
                     for n in range(8)] for k in range(8)])
    zz = _zigzag()
    ac_symbols = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]
    ac_code = {sym: i for i, sym in enumerate(ac_symbols)}
    comps = []
    for plane, (h, v) in zip(planes, factors):
        h, v = (1, 1) if one else (h, v)
        sub = plane[::vmax // v, ::hmax // h].astype(float) if not one else plane.astype(float)
        rows, cols = mcuy * v * 8, mcux * h * 8
        sub = np.pad(sub, ((0, rows - sub.shape[0]), (0, cols - sub.shape[1])), mode="edge")
        blocks = sub.reshape(rows // 8, 8, cols // 8, 8).transpose(0, 2, 1, 3) - 128
        coefs = np.rint(np.einsum("uk,yxkl,vl->yxuv", dct, blocks, dct) / q).astype(int)
        comps.append((h, v, coefs.reshape(*coefs.shape[:2], 64)[..., zz].tolist()))
    bits, preds = [], [0] * len(comps)

    def put(value, n):
        bits.append(format(value, f"0{n}b") if n else "")

    def magnitude(x):
        s = abs(x).bit_length()
        put(x if x >= 0 else x + (1 << s) - 1, s)
        return s

    for my in range(mcuy):
        for mx in range(mcux):
            for ci, (h, v, coefs) in enumerate(comps):
                for by in range(v):
                    for bx in range(h):
                        block = coefs[my * v + by][mx * h + bx]
                        diff, preds[ci] = block[0] - preds[ci], block[0]
                        put(abs(diff).bit_length(), 4)
                        magnitude(diff)
                        run = 0
                        for x in block[1:]:
                            if x == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(ac_code[0xF0], 9)
                                run -= 16
                            put(ac_code[(run << 4) | abs(x).bit_length()], 9)
                            magnitude(x)
                            run = 0
                        if run:
                            put(ac_code[0x00], 9)
    stream = "".join(bits)
    stream += "1" * (-len(stream) % 8)
    scan = int(stream, 2).to_bytes(len(stream) // 8, "big").replace(b"\xff", b"\xff\x00")

    def segment(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    n = len(planes)
    sof = struct.pack(">BHHB", 8, height, width, n) + b"".join(
        bytes([ids[i], (h << 4) | v, 0]) for i, (h, v) in enumerate(factors))
    dht = (bytes([0x00]) + bytes([0, 0, 0, 12] + [0] * 12) + bytes(range(12))
           + bytes([0x10]) + bytes([0] * 8 + [len(ac_symbols)] + [0] * 7) + bytes(ac_symbols))
    sos = bytes([n]) + b"".join(bytes([ids[i], 0x00]) for i in range(n)) + bytes([0, 63, 0])
    path.write_bytes(b"\xff\xd8" + app + segment(0xDB, bytes([0]) + bytes([q] * 64))
                     + segment(0xC0, sof) + segment(0xC4, dht) + segment(0xDA, sos) + scan
                     + b"\xff\xd9")


JFIF = b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def _adobe(transform):
    return b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform])


@pytest.mark.parametrize("factors", [
    [(1, 2), (1, 1), (1, 1)],   # 4:4:0: h1v2 triangle upsampling
    [(2, 2), (2, 1), (1, 2)],   # h1v2 and h2v1 in one file
    [(2, 1), (1, 1), (1, 1)],   # 4:2:2
    [(2, 2), (1, 1), (1, 1)],   # 4:2:0
    [(4, 1), (1, 1), (1, 1)],   # 4:1:1: replicated
    [(4, 2), (1, 1), (1, 1)],   # a 4x2 ratio: replicated
    [(4, 1), (2, 1), (1, 1)],   # h2v1 beside a 4x1 ratio
    [(1, 1), (2, 2), (1, 1)],   # luma upsampled, not chroma
    [(2, 2)],                   # one component: not interleaved
], ids=lambda f: "_".join(f"{h}x{v}" for h, v in f))
@pytest.mark.parametrize("size", [(27, 37), (5, 3)])
def test_jpeg_any_sampling_factors_equal_imageio(tmp_path, factors, size):
    """The encoder here at sampling factors Pillow cannot write, at an odd
    size (partial MCUs, odd chroma sizes) and a narrow one (chroma two
    pixels wide or less, where libjpeg replicates instead): bitwise equal
    to imageio's decode."""
    img = _image(*size, sum(h * 4 + v for h, v in factors) + size[0])
    planes = [img[..., c] for c in range(len(factors))]
    p = tmp_path / "x.jpg"
    _write_jpeg(p, planes, factors, app=JFIF if len(factors) == 3 else b"")
    out = _assert_jpeg_equal(p)
    assert out.shape == (size if len(factors) == 1 else (*size, 3))


@pytest.mark.parametrize("marker,ids,stored", [
    ("jfif", b"RGB", "ycc"),    # a JFIF marker means YCbCr, whatever the ids
    ("adobe0", (1, 2, 3), "rgb"),
    ("adobe1", b"RGB", "ycc"),  # the Adobe transform before the ids
    ("none", b"RGB", "rgb"),
    ("none", (1, 2, 3), "ycc"),
    ("none", (7, 8, 9), "ycc"),
])
def test_jpeg_colour_space_markers_as_libjpeg_reads_them(tmp_path, marker, ids, stored):
    """libjpeg's rule for three components: JFIF, else the Adobe transform,
    else ids 'R', 'G', 'B' mean RGB is stored; bitwise equal to imageio."""
    img = _image(13, 22, len(marker))
    app = {"jfif": JFIF, "adobe0": _adobe(0), "adobe1": _adobe(1), "none": b""}[marker]
    p = tmp_path / "x.jpg"
    _write_jpeg(p, [img[..., c] for c in range(3)], [(1, 1)] * 3, ids=tuple(ids), app=app, q=1)
    out = _assert_jpeg_equal(p)
    # q = 1 at 4:4:4: an RGB file comes back near the planes themselves
    near = np.abs(out.astype(int) - img.astype(int)).mean() < 2
    assert near == (stored == "rgb")


@pytest.mark.parametrize("kind", ["progressive", "cmyk"])
def test_jpeg_raises_on_progressive_and_cmyk(tmp_path, kind):
    img = _image(16, 24, 1)
    p = tmp_path / "x.jpg"
    if kind == "progressive":
        Image.fromarray(img).save(p, progressive=True)
        match = "SOF2"
    else:
        Image.fromarray(img).convert("CMYK").save(p)
        match = "4 components"
    with pytest.raises(ValueError, match=match):
        read_jpeg(p)
    with pytest.raises(ValueError, match="not a JPEG"):
        p.write_bytes(b"GIF89a" + bytes(40))
        read_jpeg(p)


@pytest.fixture
def scene(tmp_path):
    """A one-scene BOP split with colour images for images 1-3."""
    split = tmp_path / "ds" / "val"
    sdir = split / "000001"
    for sub in ("rgb", "gray"):
        (sdir / sub).mkdir(parents=True)
    iio.imwrite(sdir / "rgb" / "000001.png", _image(24, 32, 1))
    Image.fromarray(_image(24, 32, 2)).save(sdir / "rgb" / "000002.jpg", quality=80)
    iio.imwrite(sdir / "gray" / "000003.png", _image(24, 32, 3)[..., 0])
    return split


@pytest.mark.parametrize("img_id,size", [(1, None), (2, None), (3, None), (1, (20, 10)),
                                         (2, (40, 30))])
def test_load_color_image_matches_jax(scene, img_id, size):
    row = {"datasubset_path": str(scene), "scene_id": 1, "img_id": img_id}
    kw = {} if size is None else {"width": size[0], "height": size[1]}
    ours, ref = bop.load_color_image(row, **kw), jbop.load_color_image(row, **kw)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def test_load_color_image_missing_raises_in_both(scene):
    row = {"datasubset_path": str(scene), "scene_id": 1, "img_id": 4}
    with pytest.raises(FileNotFoundError):
        jbop.load_color_image(row)
    with pytest.raises(FileNotFoundError):
        bop.load_color_image(row)
