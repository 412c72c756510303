"""Faults planted under a run of the port, each by ``plant(name,
monkeypatch)``: the check has to read a run with any of them as not correct
(``tests/test_portbench_faults.py`` at a test size on the CPU), and a
fault's readings at a cell's own size on the card give a number its upper
reading where the control does not. Not part of a benchmark run.

    python3 portbench/tools/faults.py --workload <cell> --fault <name> --seeds 11 12 13

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

from bayesianposeestimation.jl_tpu_torch import capture  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.models import fused  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.samplers import mh, smc  # noqa: E402


def state_unchanged(monkeypatch):
    """Every SMC or MH step returns the state it was given."""
    for cls in (smc.SequentialMonteCarlo, mh.MetropolisHastings):
        monkeypatch.setattr(cls, "step", lambda self, rngs, model, old: (old.sample, old))


def half_batch(monkeypatch):
    """The likelihood of the first half of the poses; the rest get its mean."""
    real = fused.render_score

    def half(verts, faces, cam, t, q, *args, **kw):
        n = t.shape[0]
        k = max(1, n // 2)
        ell, sum_o = real(verts, faces, cam, t[:k].contiguous(), q[:k].contiguous(), *args, **kw)
        return (torch.cat([ell, ell.mean().expand(n - k)]),
                torch.cat([sum_o, sum_o.mean().expand(n - k)]))

    monkeypatch.setattr(fused, "render_score", half)


def likelihood_moved(monkeypatch):
    """The likelihood of another pose: the render of the pose moved by 5 mm."""
    real = fused.render_score

    def moved(verts, faces, cam, t, q, *args, **kw):
        return real(verts, faces, cam, (t + t.new_tensor([0.005, 0.0, 0.0])).contiguous(), q,
                    *args, **kw)

    monkeypatch.setattr(fused, "render_score", moved)


def all_accepted(monkeypatch):
    """Every MH proposal accepted: the test against the uniforms dropped."""
    monkeypatch.setattr(mh, "mh_kernel", lambda u, proposal, proposed, previous:
                        mh.select_sample(torch.ones_like(u, dtype=torch.bool), proposed,
                                         previous))


def answer_altered(monkeypatch):
    """The chain's last poses moved by 5 mm where they are produced."""
    real = capture.ChainRunner.run

    def run(self, *args, **kw):
        outs, final = real(self, *args, **kw)
        outs["t"][-1] += 0.005
        return outs, final

    monkeypatch.setattr(capture.ChainRunner, "run", run)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, likelihood_moved, all_accepted,
                                  answer_altered)}


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
