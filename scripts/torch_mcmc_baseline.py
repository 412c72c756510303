"""MCMC baselines (MH and MTM) on the BOP pipeline through the PyTorch/CUDA
port (counterpart of ``scripts/mcmc_baseline.py``): runs
``torch_smc_bop_val.py``'s sweep with the MCMC samplers at their tuned 10
tries under the experiment name ``mcmc_baseline``.

    python scripts/torch_mcmc_baseline.py --samplers mh_sampler mtm_sampler --scenes 1 \\
        [--device cpu]

Estimates go to data/exp_raw/mcmc_baseline_cuda/, errors and
sampler_recall.csv to data/exp_pro/mcmc_baseline_cuda/ under the current
directory. Runs on the CUDA device unless ``--device cpu`` is given.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch_smc_bop_val as bopval  # noqa: E402

NAME = "mcmc_baseline"
TABLE = "sampler_recall.csv"


def parse_args(argv=None):
    ap = bopval.common_args(__doc__)
    ap.add_argument("--samplers", nargs="+", default=["mh_sampler", "mtm_sampler"])
    ap.add_argument("--time-budget", type=float, default=0.5)
    # the MCMC baselines run with 10 tries (mcmc_baseline.jl:43)
    ap.add_argument("--n-particles", type=int, default=10)
    return ap.parse_args(argv)


def bop_val_argv(args):
    """``torch_smc_bop_val.py``'s arguments for this sweep."""
    return ["--bop-dir", args.bop_dir, "--dataset", args.dataset, "--testset", args.testset,
            "--scenes", *[str(s) for s in args.scenes], "--samplers", *args.samplers,
            "--time-budget", str(args.time_budget), "--n-particles", str(args.n_particles),
            "--experiment-name", NAME, "--device", args.device]


def configs(args):
    return bopval.sweep_configs(bopval.parse_args(bop_val_argv(args)))


def table(results, args):
    """sampler_recall.csv's rows (``torch_smc_bop_val.recall_rows``) from
    (config, result, errors) triples."""
    errors = {}
    for config, _, e in results:
        errors.setdefault(config["sampler"], []).append(e)
    return bopval.recall_rows(errors)[0]


def main(argv=None):
    bopval.main(bop_val_argv(parse_args(argv)))


if __name__ == "__main__":
    main()
