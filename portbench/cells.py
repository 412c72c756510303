"""A cell and its configuration, found by name: ``workloads/<cell>.json``
names its ``config``, ``configs/<config>.json`` names its ``entry``; the
metrics a cell reports are those ``BENCHMARK.json`` lists for it, each read
by ``end_to_end/<name>.py`` or (per layer) ``metrics/<name>.py``."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def load(name: str):
    """(cell, config) of the cell ``name``."""
    path = HERE / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"portbench: no cell {name!r} ({path})")
    cell = json.loads(path.read_text())
    cell["name"] = name
    config = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    return cell, config


def entry_module(config):
    return importlib.import_module(f"portbench.entries.{config['entry']}")


def _metrics(kind: str, cell: str):
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    e2e = spec["end_to_end"]
    mine = {m["name"] for m in e2e if cell in m.get("workloads", [cell])}
    if kind == "end_to_end":
        return [m for m in e2e if m["name"] in mine]
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def readers(kind: str, cell: str):
    """[(metric entry, read function)] of the cell's ``end_to_end`` or
    ``per_layer`` metrics."""
    out = []
    for m in _metrics(kind, cell):
        path = HERE / ("metrics" if kind == "per_layer" else kind) / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{m['name']}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out.append((m, mod.read))
    return out
