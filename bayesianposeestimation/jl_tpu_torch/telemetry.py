"""Counts and spans inside the port.

Counts: kernel launches, likelihood evaluations and the like are reported
through ``count``. While a CUDA graph is captured (``recording``) the counts
are recorded, not reported, and every replay reports what its capture
recorded, so ``add_listener`` receives the counts of replayed work too.

Spans: ``span(name)`` times a phase of a request on the host clock
(``time.perf_counter_ns``), in memory. Telemetry is off by default; then
``span`` hands back one shared no-op context (no clock read, nothing
allocated) and the captured runner's step loop reads the flag once per
``advance``. ``enable()`` turns it on: spans are kept, with their parent and
request, in a bounded list (what does not fit is counted as dropped), and
every key reported through ``count`` is summed. A span opened while no
other is open is a request's root; the spans inside it share its request
id. While ``torch.profiler`` records, a span is also a profiler range named
``bpe.<name>``, so it lies on the profiler's clock beside the device's
operations. ``Laps`` splits a loop's host time by the part of it that
runs. ``snapshot()`` returns what was kept since ``reset()``.
Telemetry draws no random number and reads nothing from the device.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

__all__ = ["count", "add_listener", "remove_listener", "recording", "enable", "disable",
           "enabled", "reset", "snapshot", "span", "profiled", "Laps", "SPAN_LIMIT"]

# -- counts a replay reports again --------------------------------------------

_LISTENERS = []
_RECORDING = []


def count(key, n=1):
    """Report ``n`` events of ``key`` (a kernel launch, a likelihood
    evaluation) to the listeners, or, while a graph is captured, record them
    for its replays."""
    if _RECORDING:
        _RECORDING[-1][key] += n
        return
    for fn in tuple(_LISTENERS):
        fn(key, n)


def add_listener(fn):
    """Call ``fn(key, n)`` for every reported event."""
    _LISTENERS.append(fn)


def remove_listener(fn):
    _LISTENERS.remove(fn)


@contextlib.contextmanager
def recording():
    """Record the events reported inside, instead of reporting them: a
    ``Counter`` of what a capture will launch on each replay."""
    tally = collections.Counter()
    _RECORDING.append(tally)
    try:
        yield tally
    finally:
        _RECORDING.pop()


# -- spans --------------------------------------------------------------------

SPAN_LIMIT = 1 << 16  # spans kept between two resets

ON = False  # read by the step loop once per advance
_SPANS = []  # [name, start_ns, end_ns or None, parent index or -1, request id]
_OPEN = []  # the open spans' (index or -1 when dropped, request id), innermost last
_COUNTS = collections.Counter()
_STATE = {"dropped": 0, "requests": 0}
_NULL = contextlib.nullcontext()


def _tally(key, n):
    _COUNTS[key] += n


def enable():
    """Keep spans and sum every reported count from now on."""
    global ON
    if not ON:
        ON = True
        add_listener(_tally)


def disable():
    global ON
    if ON:
        ON = False
        remove_listener(_tally)


def enabled() -> bool:
    return ON


def reset():
    """Forget the spans and counts kept so far (open spans included)."""
    _SPANS.clear()
    _OPEN.clear()
    _COUNTS.clear()
    _STATE.update(dropped=0, requests=0)


def _profiling() -> bool:
    return getattr(torch.autograd.profiler, "_is_profiler_enabled", False)


class Laps:
    """The host time of a loop, summed by the part of it that runs:
    ``laps(part)`` ends the part running (its nanoseconds are added to
    ``ns[part]``) and starts ``part``; ``laps(None)`` starts time that
    counts in no part. While the profiler records, each part is also a
    range ``<prefix><part>``. One clock read per call."""

    __slots__ = ("prefix", "ns", "part", "start", "range", "profiling")

    def __init__(self, prefix):
        self.prefix = prefix
        self.ns = collections.Counter()
        self.part = None
        self.range = None
        self.profiling = _profiling()
        self.start = time.perf_counter_ns()

    def __call__(self, part):
        now = time.perf_counter_ns()
        if self.part is not None:
            self.ns[self.part] += now - self.start
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None
        if self.profiling and part is not None:
            self.range = torch.profiler.record_function(self.prefix + part)
            self.range.__enter__()
        self.part, self.start = part, now


class _Span:
    __slots__ = ("name", "entry", "range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        if _OPEN:
            parent, request = _OPEN[-1]
        else:
            parent, request = -1, _STATE["requests"]
            _STATE["requests"] += 1
        if len(_SPANS) < SPAN_LIMIT:
            self.entry = (len(_SPANS), request)
            _SPANS.append([self.name, 0, None, parent, request])
        else:
            _STATE["dropped"] += 1
            self.entry = (-1, request)
        _OPEN.append(self.entry)
        self.range = torch.profiler.record_function("bpe." + self.name) if _profiling() else None
        if self.range is not None:
            self.range.__enter__()
        if self.entry[0] >= 0:
            _SPANS[self.entry[0]][1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        if _OPEN and _OPEN[-1] is self.entry:
            _OPEN.pop()
            if self.entry[0] >= 0:
                _SPANS[self.entry[0]][2] = end
        return False


def span(name):
    """A context that times ``name`` while telemetry is on."""
    return _Span(name) if ON else _NULL


def profiled(name):
    """A profiler range ``bpe.<name>`` while ``torch.profiler`` records
    (whether or not telemetry is on), else a no-op context: it names the
    device work of a part of a step in an eager profile."""
    return torch.profiler.record_function("bpe." + name) if _profiling() else _NULL


def snapshot() -> dict:
    """What was kept since ``reset()``: ``spans``, a list of dicts (``name``,
    ``start_ns``, ``end_ns`` (None while open), ``parent`` (an index into the
    list, -1 for a root or a dropped parent), ``request``, ``self_ns``: the
    duration less what the span's children cover, None while open);
    ``counts``, a ``Counter`` of every key reported through ``count``; and
    ``dropped``, the spans that did not fit."""
    children = [0] * len(_SPANS)
    for name, start, end, parent, _ in _SPANS:
        if parent >= 0 and end is not None:
            children[parent] += end - start
    spans = [dict(name=name, start_ns=start, end_ns=end, parent=parent, request=request,
                  self_ns=None if end is None else end - start - children[i])
             for i, (name, start, end, parent, request) in enumerate(_SPANS)]
    return {"spans": spans, "counts": collections.Counter(_COUNTS),
            "dropped": _STATE["dropped"]}
