"""The traced slice of a window: ``torch.profiler`` over a few requests,
reduced to what the per-layer readers take.

Sources (copies of the port's profiling arithmetic): the device's busy time
is the union of the device operations' intervals (kernels, copies, fills);
the idle share is 1 - busy / wall of the slice; the host's launch calls are
the profiler's CPU events named in ``HOST_LAUNCH_CALLS``; the benchmark's
named ranges, which the profiler also lays on the device's timeline, are
not device operations; a kernel of
``csrc/render_score.cu`` is one whose name holds one of ``RASTER_KERNELS``,
and its time per launch is the recorded raster kernels' time over the
recorded ``render_score_kernel`` launches, since the profiler can drop
launches from a session (a slice that recorded fewer than the port's own
counter reports is taken again)."""

from __future__ import annotations

import collections
import time

import torch
from torch.profiler import ProfilerActivity, profile

HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                     "cudaMemsetAsync")
RASTER_KERNELS = ("render_score_kernel", "score_background_kernel")
SPAN = "portbench."


def is_raster(name):
    return any(k in name for k in RASTER_KERNELS)


def is_kernel(name):
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


class Slice:
    """One profiled slice: ``with Slice() as s: ...`` around the requests."""

    def __init__(self):
        self.cuda = torch.cuda.is_available()  # without a card: host events alone

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self.prof = profile(activities=[ProfilerActivity.CPU]
                            + ([ProfilerActivity.CUDA] if self.cuda else []))
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        self.events = self.prof.events()
        return False

    def raster_launches(self):
        return sum(1 for e in self.events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "render_score_kernel" in e.name)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(sl: Slice, units: int, counted_launches: int) -> dict:
    """The slice's numbers: busy and wall seconds, device time by name,
    kernels, host launch calls, raster time and launches, and the idle gaps
    named by the benchmark span that was open (innermost) at their middle."""
    dev, spans, host_calls = [], [], 0
    for e in sl.events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a named range's shadow on the device's timeline is no operation
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN)):
                dev.append((e.time_range.start, e.time_range.end, e.name))
        elif e.name in HOST_LAUNCH_CALLS:
            host_calls += 1
        elif e.name.startswith(SPAN):
            spans.append((e.time_range.start, e.time_range.end, e.name[len(SPAN):]))
    merged = _union([(s, e) for s, e, _ in dev])
    busy_us = sum(e - s for s, e in merged)
    by_name = collections.Counter()
    for s, e, name in dev:
        by_name[name] += (e - s) * 1e-6
    raster = [(s, e) for s, e, n in dev if is_raster(n)]
    recorded = sum(1 for _, _, n in dev if "render_score_kernel" in n)
    outer = [s for s in spans if s[2] == "slice"]
    lo, hi = (outer[0][0], outer[0][1]) if outer else (
        merged[0][0] if merged else 0.0, merged[-1][1] if merged else 0.0)
    gaps, prev = [], lo
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))

    def doing(mid):
        inside = [sp for sp in spans if sp[0] <= mid <= sp[1] and sp[2] != "slice"]
        return min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside else "between spans"

    named = sorted(((doing((a + b) / 2), (b - a) * 1e-6) for a, b in gaps),
                   key=lambda g: -g[1])
    return {
        "units": units, "wall_s": sl.wall_s, "busy_s": busy_us * 1e-6,
        "host_calls": host_calls,
        "kernels": sum(1 for _, _, n in dev if is_kernel(n)),
        "nonraster_busy_s": sum((e - s) for s, e, n in dev if not is_raster(n)) * 1e-6,
        "raster_s": sum(e - s for s, e in raster) * 1e-6,
        "raster_recorded": recorded, "raster_counted": counted_launches,
        "device_ops": [[n, v] for n, v in by_name.most_common(10)],
        "idle_gaps": [[n, v] for n, v in named[:10]],
    }
