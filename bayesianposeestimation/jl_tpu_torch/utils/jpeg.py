"""A baseline JPEG decoder on NumPy, for the BOP colour images.

BOP data sets store colour images as ``rgb/<im_id>.jpg`` or ``.png``; the
JAX package reads them with imageio, which decodes a JPEG through Pillow and
libjpeg-turbo. This decoder follows libjpeg-turbo's default decompression
step by step, so that it returns what imageio returns:

- baseline and extended sequential frames (SOF0, SOF1) at 8 bits, Huffman
  coded, with 1 or 3 components at any sampling factors, in one scan;
  restart intervals (``DRI`` / ``RSTn``);
- dequantisation and libjpeg's integer inverse DCT (``jidctint.c``: 13-bit
  constants, two passes, its rounding and its range-limit table);
- libjpeg's "fancy" (triangle) chroma upsampling for h2v1, h1v2 and h2v2
  (``jdsample.c``: the same weights and rounding biases, edges repeated),
  box replication for any other ratio;
- YCbCr to RGB by libjpeg's fixed-point tables (``jdcolor.c``), which
  implement the JFIF equations; in a file without a JFIF marker, an Adobe
  marker with transform 0 or components named R, G, B mean RGB is stored
  and nothing is converted.

Progressive (SOF2), lossless, hierarchical, arithmetic-coded and 12-bit
files, CMYK or other component counts, and scans that do not hold every
component raise ``ValueError`` naming what they hold; they are not misread.
``read_jpeg`` returns [H, W] ``uint8`` for one component, [H, W, 3]
``uint8`` RGB for three.
"""

from __future__ import annotations

import re
import struct
from array import array

import numpy as np

__all__ = ["read_jpeg"]

# natural (row-major) index of the k-th coefficient in zigzag order
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_UNSUPPORTED = {
    0xC2: "progressive DCT (SOF2)", 0xC3: "lossless (SOF3)",
    0xC5: "differential sequential (SOF5)", 0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)", 0xC8: "JPG extension (SOF8)",
    0xC9: "arithmetic sequential (SOF9)", 0xCA: "arithmetic progressive (SOF10)",
    0xCB: "arithmetic lossless (SOF11)", 0xCC: "arithmetic conditioning (DAC)",
    0xCD: "arithmetic differential sequential (SOF13)",
    0xCE: "arithmetic differential progressive (SOF14)",
    0xCF: "arithmetic differential lossless (SOF15)", 0xDC: "number of lines (DNL)",
}


def _huffman_lookup(counts, symbols, path):
    """A table over every 16-bit window: (code length << 8) | symbol of the
    code the window starts with, 0 where no code matches."""
    table = np.zeros(1 << 16, np.uint16)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError(f"JPEG Huffman table with too many codes: {path}")
            table[code << (16 - length):(code + 1) << (16 - length)] = \
                (length << 8) | symbols[k]
            code, k = code + 1, k + 1
        code <<= 1
    return array("H", table.tobytes())


def _windows(segment: bytes):
    """The entropy-coded ``segment`` (byte stuffing removed) as the 16-bit
    window starting at every bit, padded with one bits past its end."""
    bits = np.unpackbits(np.frombuffer(segment, np.uint8)).astype(np.uint16)
    bits = np.concatenate([bits, np.ones(64, np.uint16)])
    n = bits.size - 16
    w = np.zeros(n, np.uint16)
    for k in range(16):
        w = (w << 1) | bits[k:k + n]
    return array("H", w.tobytes())


def _decode_blocks(w, comps, mcus, mcux, out, path):
    """Huffman-decode the blocks of ``mcus`` MCUs (from MCU ``mcus[0]``) of
    one restart interval into ``out[c]`` (flat natural-order coefficients)."""
    zz = _ZIGZAG.tolist()
    p = 0
    preds = [0] * len(comps)
    try:
        for m in mcus:
            my, mx = divmod(m, mcux)
            for ci, (c, h, v, blocks_x, dc, ac) in enumerate(comps):
                coef = out[c]
                for by in range(v):
                    for bx in range(h):
                        base = ((my * v + by) * blocks_x + mx * h + bx) * 64
                        look = dc[w[p]]
                        if not look:
                            raise ValueError(f"JPEG: bad DC Huffman code: {path}")
                        p += look >> 8
                        s = look & 0xFF
                        if s:
                            val = w[p] >> (16 - s)
                            p += s
                            if val < 1 << (s - 1):
                                val -= (1 << s) - 1
                            preds[ci] += val
                        coef[base] = preds[ci]
                        k = 1
                        while k < 64:
                            look = ac[w[p]]
                            if not look:
                                raise ValueError(f"JPEG: bad AC Huffman code: {path}")
                            p += look >> 8
                            rs = look & 0xFF
                            r, s = rs >> 4, rs & 15
                            if s:
                                k += r
                                if k > 63:
                                    raise ValueError(f"JPEG: AC run past the block: {path}")
                                val = w[p] >> (16 - s)
                                p += s
                                if val < 1 << (s - 1):
                                    val -= (1 << s) - 1
                                coef[base + zz[k]] = val
                                k += 1
                            elif r == 15:
                                k += 16
                            else:
                                break
    except IndexError:
        raise ValueError(f"JPEG entropy-coded data ends early: {path}") from None


def _idct_pass(x, shift):
    """One 1-D pass of libjpeg's jpeg_idct_islow over the 8 coefficient
    arrays ``x``, descaled by ``shift`` bits with rounding."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * 4433                      # FIX(0.541196100)
    tmp2 = z1 + z3 * -15137                    # FIX(1.847759065)
    tmp3 = z1 + z2 * 6270                      # FIX(0.765366865)
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633                      # FIX(1.175875602)
    t0 = t0 * 2446                             # FIX(0.298631336)
    t1 = t1 * 16819                            # FIX(2.053119869)
    t2 = t2 * 25172                            # FIX(3.072711026)
    t3 = t3 * 12299                            # FIX(1.501321110)
    z1 = z1 * -7373                            # FIX(0.899976223)
    z2 = z2 * -20995                           # FIX(2.562915447)
    z3 = z3 * -16069 + z5                      # FIX(1.961570560)
    z4 = z4 * -3196 + z5                       # FIX(0.390180644)
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    r = 1 << (shift - 1)
    return [(tmp10 + t3 + r) >> shift, (tmp11 + t2 + r) >> shift,
            (tmp12 + t1 + r) >> shift, (tmp13 + t0 + r) >> shift,
            (tmp13 - t0 + r) >> shift, (tmp12 - t1 + r) >> shift,
            (tmp11 - t2 + r) >> shift, (tmp10 - t3 + r) >> shift]


# libjpeg's post-IDCT range limit, indexed by the output & 1023: x + 128
# clamped to [0, 255] for x in [-512, 511]
_RANGE_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                               np.arange(0, 128)]).astype(np.uint8)


def _idct(coefs, quant):
    """[n, 64] quantised coefficients (natural order) -> [n, 8, 8] uint8."""
    blocks = (coefs.astype(np.int64) * quant).reshape(-1, 8, 8)
    cols = _idct_pass([blocks[:, k, :] for k in range(8)], 11)   # CONST_BITS - PASS1_BITS
    ws = np.stack(cols, axis=1)
    rows = _idct_pass([ws[:, :, k] for k in range(8)], 18)       # CONST_BITS + PASS1_BITS + 3
    return _RANGE_LIMIT[np.stack(rows, axis=2) & 1023]


def _fancy_h2(x, biases):
    """libjpeg's horizontal triangle upsampling of int rows [..., w]: output
    2j from 3 x[j] + x[j - 1], 2j + 1 from 3 x[j] + x[j + 1] (edges
    repeated), each plus its bias, shifted right by ``biases[2]``."""
    pad = np.concatenate([x[..., :1], x, x[..., -1:]], axis=-1)
    even = (3 * x + pad[..., :-2] + biases[0]) >> biases[2]
    odd = (3 * x + pad[..., 2:] + biases[1]) >> biases[2]
    return np.stack([even, odd], axis=-1).reshape(*x.shape[:-1], 2 * x.shape[-1])


def _upsample(plane, rh, rv):
    """A chroma plane [ch, cw] (its true size) scaled by (rv, rh) as libjpeg
    does by default."""
    x = plane.astype(np.int32)
    w = x.shape[1]
    if (rh, rv) == (2, 1) and w > 2:
        return _fancy_h2(x, (1, 2, 2)).astype(np.uint8)
    if (rh, rv) in ((1, 2), (2, 2)) and (rh == 1 or w > 2):
        pad = np.concatenate([x[:1], x, x[-1:]], axis=0)
        upper = 3 * x + pad[:-2]           # the row above is the further one
        lower = 3 * x + pad[2:]
        if rh == 1:
            rows = [(upper + 1) >> 2, (lower + 2) >> 2]
        else:
            rows = [_fancy_h2(upper, (8, 7, 4)), _fancy_h2(lower, (8, 7, 4))]
        return np.stack(rows, axis=1).reshape(2 * x.shape[0], -1).astype(np.uint8)
    return np.repeat(np.repeat(plane, rv, axis=0), rh, axis=1)


def _ycc_to_rgb(y, cb, cr):
    """libjpeg's ycc_rgb_convert: 16-bit fixed-point tables, rounded."""
    def fix(v):
        return int(v * (1 << 16) + 0.5)

    half = 1 << 15
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    y = y.astype(np.int64)
    r = y + ((fix(1.40200) * cr + half) >> 16)
    g = y + ((-fix(0.34414) * cb + half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def read_jpeg(path) -> np.ndarray:
    """Decode a baseline JPEG file into what imageio returns for it (see the
    module docstring)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"not a JPEG file: {path}")
    quant, dc_tables, ac_tables = {}, {}, {}
    frame, restart, adobe_transform, jfif = None, 0, None, False
    off = 2
    while True:
        ff = data.find(b"\xff", off)
        if ff < 0 or ff + 1 >= len(data):
            raise ValueError(f"JPEG without a scan: {path}")
        marker = data[ff + 1]
        if marker in (0xFF, 0x00) or 0xD0 <= marker <= 0xD7 or marker == 0x01:
            off = ff + 1
            continue
        if marker == 0xD9:
            raise ValueError(f"JPEG ends before its scan: {path}")
        (length,) = struct.unpack(">H", data[ff + 2:ff + 4])
        seg = data[ff + 4:ff + 2 + length]
        off = ff + 2 + length
        if marker in _UNSUPPORTED:
            raise ValueError(f"JPEG marker 0x{marker:02X}: {_UNSUPPORTED[marker]} is not "
                             f"supported (baseline and extended sequential only): {path}")
        if marker in (0xC0, 0xC1):
            precision, height, width, n = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise ValueError(f"JPEG at {precision}-bit precision is not supported "
                                 f"(8 only): {path}")
            if n not in (1, 3):
                raise ValueError(f"JPEG with {n} components (CMYK or other) is not "
                                 f"supported (1 or 3): {path}")
            if height == 0:
                raise ValueError(f"JPEG height set by a DNL marker is not supported: {path}")
            comps = [dict(id=seg[6 + 3 * i], h=seg[7 + 3 * i] >> 4, v=seg[7 + 3 * i] & 15,
                          tq=seg[8 + 3 * i]) for i in range(n)]
            frame = (height, width, comps)
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1:i + 17]
                symbols = seg[i + 17:i + 17 + sum(counts)]
                (dc_tables if tc == 0 else ac_tables)[th] = _huffman_lookup(counts, symbols,
                                                                            path)
                i += 17 + sum(counts)
        elif marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 2 if pq else 1
                vals = np.frombuffer(seg[i + 1:i + 1 + 64 * size], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[_ZIGZAG] = vals
                quant[tq] = table
                i += 1 + 64 * size
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif marker == 0xDA:
            break
    if frame is None:
        raise ValueError(f"JPEG scan without a baseline frame header: {path}")
    height, width, comps = frame
    n_scan = seg[0]
    scan = [(seg[1 + 2 * i], seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15) for i in range(n_scan)]
    if sorted(s[0] for s in scan) != sorted(c["id"] for c in comps):
        raise ValueError(f"JPEG whose first scan does not hold every component (a "
                         f"multi-scan sequential file) is not supported: {path}")
    # the entropy-coded data: up to the first marker that is not RSTn
    end = off
    while True:
        end = data.find(b"\xff", end)
        if end < 0 or end + 1 >= len(data):
            end = len(data)
            break
        if data[end + 1] == 0x00 or 0xD0 <= data[end + 1] <= 0xD7 or data[end + 1] == 0xFF:
            end += 1 if data[end + 1] == 0xFF else 2
            continue
        break
    segments = [s.replace(b"\xff\x00", b"\xff")
                for s in re.split(rb"\xff+[\xd0-\xd7]", data[off:end])]

    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    if len(comps) == 1:            # a one-component scan is not interleaved: a block per MCU
        comps[0]["h"] = comps[0]["v"] = hmax = vmax = 1
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    out, order = [], []
    by_id = {c["id"]: i for i, c in enumerate(comps)}
    for cid, td, ta in scan:
        c = comps[by_id[cid]]
        if td not in dc_tables or ta not in ac_tables or c["tq"] not in quant:
            raise ValueError(f"JPEG scan refers to a missing Huffman or quantisation "
                             f"table: {path}")
        order.append((by_id[cid], c["h"], c["v"], mcux * c["h"], dc_tables[td], ac_tables[ta]))
    for c in comps:
        out.append([0] * (mcux * c["h"] * mcuy * c["v"] * 64))
    total = mcux * mcuy
    interval = restart or total
    if len(segments) < -(-total // interval):
        raise ValueError(f"JPEG holds {len(segments)} restart intervals, expected "
                         f"{-(-total // interval)}: {path}")
    for i, start in enumerate(range(0, total, interval)):
        _decode_blocks(_windows(segments[i]), order, range(start, min(start + interval, total)),
                       mcux, out, path)

    planes = []
    for c, coefs in zip(comps, out):
        blocks = _idct(np.asarray(coefs, np.int64).reshape(-1, 64), quant[c["tq"]])
        bx, by = mcux * c["h"], mcuy * c["v"]
        plane = blocks.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        ch, cw = -(-height * c["v"] // vmax), -(-width * c["h"] // hmax)
        plane = plane[:ch, :cw]
        if (c["h"], c["v"]) != (hmax, vmax):
            if hmax % c["h"] or vmax % c["v"]:
                raise ValueError(f"JPEG sampling factors {c['h']}x{c['v']} do not divide "
                                 f"{hmax}x{vmax}: {path}")
            plane = _upsample(plane, hmax // c["h"], vmax // c["v"])
        planes.append(plane[:height, :width])
    if len(planes) == 1:
        return planes[0]
    # libjpeg's rule: a JFIF file is YCbCr, else an Adobe marker says, else
    # the component ids do
    if jfif:
        rgb_stored = False
    elif adobe_transform is not None:
        rgb_stored = adobe_transform == 0
    else:
        rgb_stored = [c["id"] for c in comps] == [0x52, 0x47, 0x42]
    if rgb_stored:
        return np.stack(planes, axis=-1)
    return _ycc_to_rgb(*planes)
