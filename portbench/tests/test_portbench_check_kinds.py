"""A check kind is a file of its own (``reference/checks/<kind>.py``), found
by name. The ``bop`` and ``track`` kinds read, exactly, what the single
``check.py`` they were moved from read (kept frozen as
``fixtures/check_before.py``), on the records of a tiny run of each cell,
for the port and for the control; an unknown kind stops and names the file
it looked for."""

import importlib.util
from pathlib import Path

import pytest

from portbench import calibrate
from portbench.reference import check

_spec = importlib.util.spec_from_file_location(
    "portbench_check_before", Path(__file__).parent / "fixtures" / "check_before.py")
before = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(before)


@pytest.mark.parametrize("name", ["synthcad_smc_mh.bop", "track_coordinate.synth120"])
def test_kind_files_read_as_before(name, tiny):
    cell, config = tiny(name)
    kind, records, meshes, cfg, _ = calibrate.window(cell, config, 20250131, "cpu", 0.0)
    assert records
    new = check.judge(kind, records, meshes, cfg, "cpu", control=True)
    old = before.judge(kind, records, meshes, cfg, "cpu", control=True)
    assert new == old


def test_unknown_kind_names_the_file():
    with pytest.raises(SystemExit, match=r"checks/no_such_kind\.py"):
        check.judge("no_such_kind", [], {}, {}, "cpu")
