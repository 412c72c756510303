"""The numbers that decide ``correct``: what the timed path produced, held
against the plain reference worked out again from the same raw inputs.

A candidate is either the port (its outputs as the window produced them) or
the lower-precision control (the reference in bfloat16 put in the port's
place). Every number is a largest gap over the records checked; a
non-finite value where the reference is finite (or the reverse) reads inf.

What a record holds and which numbers it gives depends on the entry's
check kind, a module of its own: ``checks/<kind>.py`` (``bop``: SMC on one
image; ``track``: tracked frames; ``mcmc``: one MH chain on one image), as
``checks/__init__.py`` sets out."""

from __future__ import annotations

import importlib
import math
import re
from pathlib import Path

CHECKS = Path(__file__).resolve().parent / "checks"


def kind_module(kind: str):
    """The module of the check kind ``kind``; stops where there is none."""
    path = CHECKS / f"{kind}.py"
    if not re.fullmatch(r"[A-Za-z0-9_]+", kind) or not path.is_file():
        raise SystemExit(f"portbench: no check kind {kind!r} ({path})")
    return importlib.import_module(f"{__package__}.checks.{kind}")


def judge(kind, records, meshes, cfg, device, control=False):
    """{"program": numbers, "control": numbers or None}: the largest of each
    number over the records."""
    mod = kind_module(kind)
    worst = {"program": dict.fromkeys(mod.NUMBERS, 0.0)}
    if control:
        worst["control"] = dict.fromkeys(mod.NUMBERS, 0.0)
    for rec in records:
        mesh = meshes[rec["mesh"]]
        ref = mod.reference(rec, mesh, cfg, device)
        reads = {"program": mod.numbers(mod.program(rec), ref, rec)}
        if control:
            reads["control"] = mod.numbers(mod.reference(rec, mesh, cfg, device, control=True),
                                           ref, rec)
        for side, nums in reads.items():
            for k, v in nums.items():
                worst[side][k] = max(worst[side][k], v if not math.isnan(v) else math.inf)
    worst.setdefault("control", None)
    return worst
