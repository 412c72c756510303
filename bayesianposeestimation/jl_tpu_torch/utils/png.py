"""A PNG decoder and encoder for the BOP images, on ``zlib`` and NumPy alone.

The BOP datasets store depth as 16-bit and masks as 8-bit grayscale PNGs.
This reads exactly those: colour type 0 (grayscale) at bit depth 8 or 16,
not interlaced, with any of the five row filters (None, Sub, Up, Average,
Paeth). Anything else raises ``ValueError`` rather than being misread.
16-bit samples are big-endian in the file and come back as ``uint16``.

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


def read_png(path) -> np.ndarray:
    """Decode a grayscale PNG (bit depth 8 or 16, not interlaced) into a
    [H, W] array, uint8 or uint16."""
    with open(path, "rb") as fh:
        data = fh.read()
    width, height, depth, colour, compression, filtering, interlace = _header(data, path)
    if colour != 0:
        raise ValueError(f"PNG colour type {colour} is not supported (grayscale only): {path}")
    if depth not in (8, 16):
        raise ValueError(f"PNG bit depth {depth} is not supported (8 or 16): {path}")
    if interlace != 0:
        raise ValueError(f"interlaced PNG is not supported: {path}")
    if compression != 0 or filtering != 0:
        raise ValueError(f"unknown PNG compression or filter method: {path}")
    chunks = []
    off = 8
    while off + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[off:off + 8])
        if kind == b"IDAT":
            chunks.append(data[off + 8:off + 8 + length])
        elif kind == b"IEND":
            break
        off += 12 + length
    bpp = depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(chunks)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{height * (stride + 1)}: {path}")
    img = _unfilter(raw.reshape(height, stride + 1), height, stride, bpp)
    if depth == 16:
        return img.view(">u2").astype(np.uint16).reshape(height, width)
    return img.reshape(height, width)


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
