"""The command's contract: no result without a card; on the card, each
cell's run at its own size comes out correct."""

import json

import pytest
import torch

from portbench import cells, run

CELLS = ["synthcad_smc_mh.bop", "track_coordinate.synth120", "synthcad_smc_mh.res100_p1000",
         "synthcad_mh.bop"]


def test_without_a_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "3000000017", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_unknown_cell_stops():
    with pytest.raises(SystemExit):
        cells.load("no_such.cell")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, card, capsys):
    rc = run.main(["--workload", name, "--seed", "3000000019", "--seconds", "4",
                   "--trace", "0"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and result["correct"], result
    assert list(result)[-1] == "checks"
