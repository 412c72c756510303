"""What the entries share: the sample of requests kept for the check, the
spans, and the meshes."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch

PORTBENCH = Path(__file__).resolve().parents[1]


class Reservoir:
    """A uniform sample of ``k`` of the requests served, drawn from the seed
    (reservoir sampling): which requests it holds depends only on the seed
    and the count served."""

    def __init__(self, k, seed):
        self.k = k
        self.rng = np.random.default_rng([seed, 7])
        self.items, self.seen = [], 0

    def offer(self, make):
        """Keep the request ``make()`` describes, or not; ``make`` is called
        only for a request that is kept."""
        if self.seen < self.k:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = make()
        self.seen += 1


class Spans:
    """Host-clock spans around the calls into each layer, by name; under the
    profiler each is also a named range (``portbench.<name>``), so that the
    trace can say what the host was doing while the device was idle."""

    def __init__(self):
        self.seconds = {}
        self.profiled = False

    @contextlib.contextmanager
    def __call__(self, name):
        rf = (torch.profiler.record_function(f"portbench.{name}") if self.profiled
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)


def load_mesh(name, device):
    """(vertices [V, 3] f32, faces [F, 3] int32) host arrays and device tensors."""
    with np.load(PORTBENCH / "data" / "meshes" / name) as f:
        verts, faces = f["vertices"].astype(np.float32), f["faces"].astype(np.int32)
    return (verts, faces), (torch.as_tensor(verts, device=device),
                            torch.as_tensor(faces, device=device))


def request_seed(seed, i, warm_up=False):
    """The chain seed of request ``i`` (or of warm-up request ``i``): from
    the run's seed and the index."""
    return int(np.random.default_rng([seed, 6 if warm_up else 5, i]).integers(0, 2**62))
