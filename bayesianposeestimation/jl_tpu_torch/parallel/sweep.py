"""Process-level sweep runner: each worker process runs a strided shard of
a config list (host code only).

Counterpart of ``jl_tpu/parallel/sweep.py``. Configs of a sweep are
independent, so workers need no communication: each claims every
``n_workers``-th config from ``worker`` on, and ``produce_or_load`` skips
configs whose artifact exists, so a sweep resumes where it stopped.

    run_sweep(fn, configs, out_dir)          # this process's shard
    WORKER=2 N_WORKERS=8 python script.py    # the shard from the environment
"""

from __future__ import annotations

import os

from ..utils.artifacts import produce_or_load, savename

__all__ = ["shard_configs", "run_sweep"]


def shard_configs(configs, worker: int | None = None, n_workers: int | None = None):
    """This worker's strided shard of ``configs`` (by default from the
    environment's WORKER / N_WORKERS; the whole list without them)."""
    worker = int(os.environ.get("WORKER", 0)) if worker is None else worker
    n_workers = int(os.environ.get("N_WORKERS", 1)) if n_workers is None else n_workers
    return configs[worker::n_workers]


def run_sweep(fn, configs, out_dir, worker=None, n_workers=None, log=print):
    """``fn(config) -> dict`` for each config of this worker's shard, with
    its artifact in ``out_dir``; returns the (config, result) pairs."""
    results = []
    shard = shard_configs(configs, worker, n_workers)
    for i, config in enumerate(shard):
        log(f"[sweep {i + 1}/{len(shard)}] {config}")
        result, _ = produce_or_load(fn, config, out_dir, filename=savename(config))
        results.append((config, result))
    return results
