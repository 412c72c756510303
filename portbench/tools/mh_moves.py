"""The moves an MH chain made at a tiny acceptance ratio, and how often the
card's uniforms read exactly 0. Not part of a benchmark run.

    python3 portbench/tools/mh_moves.py --workload <mcmc cell> --seeds 11 12 [--zeros 16]

For each seed it serves a window of the cell as ``calibrate.py`` does (as
many requests as a run checks, the same request seeds), then prints one JSON
line: the chains' steps and moves, and every move whose ratio α lies below
1e-7 by the reference (``reference/checks/mcmc.py``), with the ratio the
port's own stored densities give for it (its log density at the step
against the state before, re-tempered by the step's rise in ϕ). A sound MH
step accepts such a move only where its uniform reads 0 (log 0 = -inf).
``--zeros n`` counts the zeros in n × 2^28 float32 draws of ``torch.rand``
on the card from one generator, the draw the MH step makes."""

import argparse
import json
import math
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

LOG10 = math.log(10.0)
SHOWN = -7.0 * LOG10  # moves below α = 1e-7 are listed


def zeros(chunks, seed, device):
    """(draws, zeros, draws under 1e-9) of ``torch.rand`` float32 on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n, zero, tiny = 2 ** 28, 0, 0
    for _ in range(chunks):
        u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
        zero += int((u == 0).sum())
        tiny += int((u < 1e-9).sum())
    return chunks * n, zero, tiny


def low_moves(rec, ref, cfg, k):
    """The moves of record ``k`` below α = 1e-7 by the reference, each with
    the port's own ratio from its stored densities."""
    from portbench.reference import smc

    chain = rec["chain"]
    s = chain["log_prob"].shape[0]
    phi = torch.as_tensor(smc.temperatures(cfg["n_steps"], s)).double()[:, None]
    lp, ll = chain["log_prob"].double(), chain["log_like"].double()
    own = lp[1:] - (lp[:-1] + (phi[1:] - phi[:-1]) * ll[:-1])
    log_alpha = ref["log_alpha"].cpu()
    out = []
    for step, c in torch.nonzero(log_alpha < SHOWN).tolist():
        moved_t = not torch.equal(chain["t"][step + 1, c], chain["t"][step, c])
        moved_r = not torch.equal(chain["r"][step + 1, c], chain["r"][step, c])
        out.append({"record": k, "mesh": rec["mesh"], "step": step + 1, "chain": c,
                    "neg_log10_alpha": -float(log_alpha[step, c]) / LOG10,
                    "port_neg_log10_alpha": -float(own[step, c]) / LOG10,
                    "moved": ("t" if moved_t else "") + ("r" if moved_r else "")})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--zeros", type=int, default=0, help="chunks of 2^28 draws")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from portbench import calibrate, cells
    from portbench.reference.checks import mcmc

    if args.zeros:
        draws, zero, tiny = zeros(args.zeros, 1, args.device)
        print(json.dumps({"draws": draws, "zeros": zero, "under_1e-9": tiny,
                          "zero_share": zero / draws}), flush=True)
    for seed in args.seeds:
        cell, config = cells.load(args.workload)
        kind, records, meshes, cfg, served = calibrate.window(cell, config, seed, args.device,
                                                              0.0)
        steps = moves = 0
        low = []
        for k, rec in enumerate(records):
            ref = mcmc.reference(rec, meshes[rec["mesh"]], cfg, args.device)
            steps += ref["log_alpha"].numel()
            moves += int((~torch.isnan(ref["log_alpha"])).sum())
            low += low_moves(rec, ref, cfg, k)
        print(json.dumps({"seed": seed, "requests": served, "records": len(records),
                          "steps": steps, "moves": moves,
                          "moves_under_1e-9": sum(m["neg_log10_alpha"] > 9 for m in low),
                          "low_moves": low}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
