"""Grayscale PNG decoding on ``zlib`` and NumPy (a frozen copy of the BOP
reader's decoder): 8- or 16-bit grayscale, not interlaced, row filters 0-4.
Anything else raises ``ValueError``."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter(raw, height, stride, bpp):
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype = int(raw[y, 0])
        line = raw[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
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


def read_gray_png(data: bytes, name="png") -> np.ndarray:
    """[H, W] uint8 or uint16 of a grayscale PNG's bytes."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"not a PNG file: {name}")
    width, height, depth, colour, comp, filt, interlace = struct.unpack(">IIBBBBB", data[16:29])
    if colour != 0 or depth not in (8, 16) or interlace or comp or filt:
        raise ValueError(f"{name}: only 8/16-bit non-interlaced grayscale PNGs are read")
    idat, off = [], 8
    while off + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[off:off + 8])
        if kind == b"IDAT":
            idat.append(data[off + 8:off + 8 + length])
        if kind == b"IEND":
            break
        off += 12 + length
    bpp = depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{name}: {raw.size} bytes of image data, expected "
                         f"{height * (stride + 1)}")
    img = _unfilter(raw.reshape(height, stride + 1), height, stride, bpp)
    if depth == 16:
        return img.view(">u2").astype(np.uint16).reshape(height, width)
    return img
