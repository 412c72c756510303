"""The least time one H100 could take for a ``render_score`` launch: the
larger of its fp32 operations over the fp32 peak and its bytes over the
memory rate (NVIDIA's data sheet, SXM part at 700 W). The operations and
bytes are counted from the launch's inputs by the benchmark itself, in plain
PyTorch (``reference.raster.live_pairs``), so no change to the port moves
them.

Operations: 15 per (live triangle, pixel centre inside its projected box)
pair (three barycentric weights 4 + 4 + 2, the inverse depth 4, the max 1),
90 per (pose, face) (transform, projection, edges, culls, area division) and
per (pose, pixel) the epilogue's count (transcendentals counted as one).
Bytes: every input read once, every output written once."""

from __future__ import annotations



from .reference.raster import live_pairs

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
OPS_PER_PAIR = 15
OPS_PER_FACE = 90
OPS_PER_PIXEL = {"fixed_o": 40, "association": 60, "smooth_association": 200,
                 "uniform_fixed_o": 25, "uniform_association": 45}


def launch_work(verts, faces, cam, t, q, epilogue, hyper=False):
    """(fp32 operations, bytes) of one score launch on poses t [N, 3], q [N, 4]."""
    n, f = t.shape[0], faces.shape[0]
    p = cam["height"] * cam["width"]
    pairs = live_pairs(verts, faces, cam, t, q)
    ops = pairs * OPS_PER_PAIR + n * f * OPS_PER_FACE + n * p * OPS_PER_PIXEL[epilogue]
    nbytes = (verts.numel() + faces.numel() + t.numel() + q.numel() + 2 * p + 2 * n
              + (2 if hyper else 0)) * 4
    return ops, nbytes


def bound_s(ops, nbytes):
    """Seconds the work takes at the peak rates, and which bound it."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def populations_work(verts, faces, cam, ts, qs, epilogue):
    """(summed bound seconds, summed fp32 operations) of one launch on each
    population of ts [S, N, 3], qs [S, N, 4]."""
    total, total_ops = 0.0, 0
    for t, q in zip(ts, qs):
        ops, nbytes = launch_work(verts, faces, cam, t.float(), q.float(), epilogue)
        total += bound_s(ops, nbytes)[0]
        total_ops += ops
    return total, total_ops


