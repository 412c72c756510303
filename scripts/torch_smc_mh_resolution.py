"""Crop-resolution sweep through the PyTorch/CUDA port (counterpart of
``scripts/smc_mh_resolution.py``): ``smc_mh`` at crops of 2-100 px, either
at the 0.5 s budget per pose (``--mode time``: the step count calibrated to
the budget) or at a fixed step count (``--mode steps``), recording recall,
steps and step time per resolution.

    python scripts/torch_smc_mh_resolution.py --resolutions 15 30 60 --scenes 1 \\
        [--mode steps --n-steps 200] [--device cpu]

Estimates go to data/exp_raw/smc_mh_resolution_cuda/, errors and
resolution_recall.csv to data/exp_pro/smc_mh_resolution_cuda/ under the
current directory. The JAX script's plot waits for the port of
``utils/visualization.py``; the CSV holds its numbers. Runs on the CUDA
device unless ``--device cpu`` is given.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch_smc_bop_val as bopval  # noqa: E402

NAME = "smc_mh_resolution"
TABLE = "resolution_recall.csv"


def parse_args(argv=None):
    ap = bopval.common_args(__doc__)
    ap.add_argument("--resolutions", type=int, nargs="+",
                    default=[2, 5, 10, 15, 20, 25, 30, 40, 50, 75, 100])
    ap.add_argument("--mode", default="time", choices=["time", "steps"])
    ap.add_argument("--n-steps", type=int, default=200, help="step count for --mode steps")
    ap.add_argument("--time-budget", type=float, default=0.5)
    ap.add_argument("--n-particles", type=int, default=100)
    return ap.parse_args(argv)


def configs(args):
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import dict_list

    return dict_list({"sampler": "smc_mh", "dataset": args.dataset, "testset": args.testset,
                      "scene_id": list(args.scenes), "mode": args.mode,
                      "resolution": list(args.resolutions)})


def parameters(config, args):
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters

    return Parameters(n_particles=args.n_particles, time_budget=args.time_budget,
                      n_steps=args.n_steps, device=args.device, **bopval.SWEEP_TUNED)


def run(config, args, cache=None, data_root="data"):
    """One config's estimates and errors: (result, errors)."""
    return bopval.run_config(NAME, config, parameters(config, args), args.bop_dir, args.device,
                             cache=cache, data_root=data_root)


def table(results, args):
    """resolution_recall.csv's rows from (config, result, errors) triples."""
    return [dict(resolution=c["resolution"], mode=c["mode"], scene_id=c["scene_id"],
                 n_steps=int(r["n_steps"]), step_time=float(r["step_time"]),
                 **bopval.scene_recalls(e)) for c, r, e in results]


def main(argv=None):
    bopval.sweep_main(sys.modules[__name__], parse_args(argv), NAME)


if __name__ == "__main__":
    main()
