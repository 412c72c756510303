"""A PNG decoder and encoder for the BOP images, on ``zlib`` and NumPy alone.

The BOP datasets store depth as 16-bit and masks as 8-bit grayscale PNGs,
and colour images as RGB. This reads grayscale (colour type 0) at bit depth
8 or 16, RGB (2), grey + alpha (4) and RGBA (6) at 8 or 16, and palette
images (3) at 1, 2, 4 or 8 bits, not interlaced, with any of the five row
filters (None, Sub, Up, Average, Paeth). Anything else raises
``ValueError`` rather than being misread. The result is what
``imageio.v3.imread`` (through Pillow) returns for the same file:

- grayscale: [H, W], ``uint8`` or ``uint16`` (16-bit samples are big-endian
  in the file);
- RGB, grey + alpha, RGBA: [H, W, 3 / 2 / 4] ``uint8``. A 16-bit colour
  sample keeps its high byte, and 16-bit grey + alpha comes back as RGBA
  (the grey repeated), as Pillow opens those files;
- palette: [H, W, 3] ``uint8``, each index looked up in ``PLTE``; a ``tRNS``
  chunk is ignored, as imageio ignores it.

``png_size`` reads the width and height from the header without
decompressing the image. ``write_png`` writes a [H, W] ``uint8`` or
``uint16`` array as a grayscale PNG of that bit depth (filter None on every
row), the format the synthetic BOP generator stores depth and masks in.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["read_png", "png_size", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _header(data: bytes, path):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    length, kind = struct.unpack(">I4s", data[8:16])
    if kind != b"IHDR" or length != 13:
        raise ValueError(f"PNG without a leading IHDR chunk: {path}")
    return struct.unpack(">IIBBBBB", data[16:29])


def png_size(path):
    """(width, height) of a PNG, from its header alone."""
    with open(path, "rb") as fh:
        width, height, *_ = _header(fh.read(29), path)
    return width, height


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: raw [height, 1 + stride] -> [height, stride]
    uint8. Sub is a cumulative sum mod 256 along each byte lane and Up adds
    the previous row, both vectorised; Average and Paeth depend on the bytes
    just reconstructed in the same row and go byte by byte."""
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype = int(raw[y, 0])
        line = raw[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            # x[i] = line[i] + x[i - bpp]: a running sum per byte lane
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:
            cur = line + prev
        elif ftype == 3:
            c, p = line.tolist(), prev.tolist()
            for i in range(stride):
                left = c[i - bpp] if i >= bpp else 0
                c[i] = (c[i] + ((left + p[i]) >> 1)) & 0xFF
            cur = np.asarray(c, np.uint8)
        elif ftype == 4:
            c, p = line.tolist(), prev.tolist()
            for i in range(stride):
                a = c[i - bpp] if i >= bpp else 0
                b = p[i]
                cc = p[i - bpp] if i >= bpp else 0
                est = a + b - cc
                pa, pb, pc = abs(est - a), abs(est - b), abs(est - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                c[i] = (c[i] + pred) & 0xFF
            cur = np.asarray(c, np.uint8)
        else:
            raise ValueError(f"PNG row filter {ftype} is not one of 0-4")
        out[y] = cur
        prev = cur
    return out


# channels per pixel and the bit depths the PNG specification allows, per
# colour type
_COLOUR_TYPES = {0: (1, (8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                 4: (2, (8, 16)), 6: (4, (8, 16))}


def _chunks(data: bytes):
    """(kind, payload) of every chunk after the signature, up to IEND."""
    off = 8
    while off + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[off:off + 8])
        yield kind, data[off + 8:off + 8 + length]
        if kind == b"IEND":
            return
        off += 12 + length


def read_png(path) -> np.ndarray:
    """Decode a PNG (not interlaced) into the array imageio returns for it:
    [H, W] grayscale (uint8 / uint16), [H, W, C] colour (uint8)."""
    with open(path, "rb") as fh:
        data = fh.read()
    width, height, depth, colour, compression, filtering, interlace = _header(data, path)
    if colour not in _COLOUR_TYPES:
        raise ValueError(f"PNG colour type {colour} is not one of 0, 2, 3, 4, 6: {path}")
    channels, depths = _COLOUR_TYPES[colour]
    if depth not in depths:
        raise ValueError(f"PNG bit depth {depth} is not supported for colour type {colour} "
                         f"({', '.join(map(str, depths))}): {path}")
    if interlace != 0:
        raise ValueError(f"interlaced PNG is not supported: {path}")
    if compression != 0 or filtering != 0:
        raise ValueError(f"unknown PNG compression or filter method: {path}")
    idat, palette = [], None
    for kind, payload in _chunks(data):
        if kind == b"IDAT":
            idat.append(payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
    bits = depth * channels
    bpp = max(bits // 8, 1)
    stride = (width * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{height * (stride + 1)}: {path}")
    img = _unfilter(raw.reshape(height, stride + 1), height, stride, bpp)
    if colour == 3:
        return _lookup(img, width, depth, palette, path)
    if depth == 16:
        img = img.view(">u2")
        if colour == 0:
            return img.astype(np.uint16).reshape(height, width)
        img = (img >> 8).astype(np.uint8)
    img = img.reshape(height, width, channels)
    if colour == 0:
        return img[..., 0]
    if colour == 4 and depth == 16:
        return img[..., [0, 0, 0, 1]]
    return img


def _lookup(rows: np.ndarray, width: int, depth: int, palette, path) -> np.ndarray:
    """Palette rows [H, stride] of packed ``depth``-bit indices -> [H, W, 3]."""
    if palette is None:
        raise ValueError(f"palette PNG without a PLTE chunk: {path}")
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    idx = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    idx = idx.reshape(rows.shape[0], rows.shape[1] * per)[:, :width]
    if idx.max(initial=0) >= len(palette):
        raise ValueError(f"palette index {int(idx.max())} beyond the {len(palette)} "
                         f"PLTE entries: {path}")
    return palette[idx]


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def write_png(path, img) -> None:
    """Write a [H, W] ``uint8`` or ``uint16`` array as an 8- or 16-bit
    grayscale PNG (16-bit samples big-endian, as the format stores them)."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes a [H, W] uint8 or uint16 array, not "
                         f"{img.dtype} {img.shape}")
    height, width = img.shape
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img, ">u2" if depth == 16 else np.uint8).view(np.uint8)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows.reshape(height, -1)], axis=1)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE)
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, 0, 0, 0, 0)))
        fh.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        fh.write(_chunk(b"IEND", b""))
