"""Faults of a multiple-try move planted under a run of the port, each by
``FAULTS[name](monkeypatch)``: the check kind ``mtm`` has to read a run with
any of them as not correct (``tests/test_torch_mtm_check.py`` at a test
size on the CPU), and a fault's readings at the cell's own size on the card
show which number sees it. Not part of a benchmark run.

    python3 portbench/tools/mtm_faults.py --workload synthcad_mtm.bop --fault <name> --seeds 11 12

prints, for each seed, the check's numbers of a short window of the cell
(as ``calibrate.py`` serves it) with the fault planted, as one JSON line.
"""

import argparse
import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from bayesianposeestimation.jl_tpu_torch.models import fused  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.samplers import mtm  # noqa: E402


def select_ignores_weights(monkeypatch):
    """The try picked by the Gumbel noise alone, whatever its weight."""
    monkeypatch.setattr(mtm, "gumbel_index",
                        lambda noise, log_weights, axis=0: torch.argmax(noise, dim=axis))


def alpha_of_selected_try(monkeypatch):
    """log α by the MH ratio of the selected try against the state alone."""
    real = mtm.MultipleTry.select

    def select(self, model, prev, new_temp, m, tries, gumbel, aux, record=None):
        selected, _ = real(self, model, prev, new_temp, m, tries, gumbel, aux, record)
        return selected, selected.log_prob - prev.log_prob

    monkeypatch.setattr(mtm.MultipleTry, "select", select)


def reference_without_state(monkeypatch):
    """The reference set's sum without the previous state."""
    monkeypatch.setattr(mtm, "multiple_try_ratio", lambda try_weights, reference_weights:
                        torch.logsumexp(try_weights, dim=0)
                        - torch.logsumexp(reference_weights[:-1], dim=0))


def reference_scored_at_tries(monkeypatch):
    """The reference set's densities those of the first T - 1 tries (a
    [tries, chains] batch flattened from the wrong poses)."""
    real = fused.FusedPosterior.tempered_logdensity_sample
    last = {}

    def scored(self, sample, temp, batch_ndim=1):
        n = sample.variables["t"].shape[0]
        tries = last.get("tries")
        if batch_ndim == 2 and tries is not None and n == tries.variables["t"].shape[0] - 1:
            wrong = real(self, type(sample)({k: v[:-1] for k, v in tries.variables.items()}),
                         temp, 2)
            return sample.set_logdensities(wrong.log_prob, wrong.log_like)
        if batch_ndim == 2:
            last["tries"] = sample
        return real(self, sample, temp, batch_ndim)

    monkeypatch.setattr(fused.FusedPosterior, "tempered_logdensity_sample", scored)


def all_accepted(monkeypatch):
    """Every selected try accepted: the test against the uniforms dropped."""
    monkeypatch.setattr(mtm, "accepts", lambda u, log_alpha: torch.ones_like(u, dtype=torch.bool))


def state_unchanged(monkeypatch):
    """Every multiple-try step returns the state it was given, with a move
    record of zeros."""
    monkeypatch.setattr(mtm.MultipleTry, "step", lambda self, rngs, model, old: (
        old.sample, mtm.MtmState(old.sample, old.temperature, self.empty_record(old.sample))))


FAULTS = {f.__name__: f for f in (select_ignores_weights, alpha_of_selected_try,
                                  reference_without_state, reference_scored_at_tries,
                                  all_accepted, state_unchanged)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from portbench import calibrate, cells

    for seed in args.seeds:
        cell, config = cells.load(args.workload)
        with pytest.MonkeyPatch.context() as mp:
            FAULTS[args.fault](mp)
            out = calibrate.readings(cell, config, seed, args.device, False, 0.0)
        out.update(fault=args.fault, limits=cell["check"]["limits"])
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
