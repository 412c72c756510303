"""The port's own profiler ranges (``bpe.<span>``, ``bpe.step.*``, laid
down while its telemetry is on) are no device operation: their shadows on
the device's timeline count neither as busy time nor as kernels."""

import types

import pytest
import torch

from portbench import trace


def _event(name, start, end, cuda=False):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU,
        is_user_annotation=cuda and name.startswith(("bpe.", "portbench.")))


def test_port_range_shadows_are_no_device_operation():
    """Kernels at 0-10, 40-50 and 70-80 us inside the benchmark's chain span;
    the port's advance and replay ranges, on the host and shadowed on the
    device, over 30-100 and 55-75 us."""
    ev = [_event("portbench.slice", 0, 100), _event("portbench.chain", 0, 100),
          _event("bpe.runner.advance", 30, 100), _event("bpe.step.replay", 55, 75),
          _event("k1", 0, 10, cuda=True), _event("k2", 40, 50, cuda=True),
          _event("k3", 70, 80, cuda=True), _event("bpe.runner.advance", 30, 100, cuda=True),
          _event("bpe.step.replay", 55, 75, cuda=True)]
    s = trace.summarize(types.SimpleNamespace(events=ev, wall_s=100e-6), 1, 0)
    assert s["kernels"] == 3 and s["busy_s"] == pytest.approx(30e-6)
    assert sorted(n for n, _ in s["device_ops"]) == ["k1", "k2", "k3"]
    assert sum(v for _, v in s["idle_gaps"]) == pytest.approx(70e-6)
