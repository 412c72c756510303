"""Hyperparameter searches for the MCMC baselines through the PyTorch/CUDA
port (counterpart of ``scripts/mcmc_baseline_hyperopt.py``): the search
space and cost (1 - VSD recall) of ``torch_smc_mh_hyperopt.py``, for each of
--samplers in turn, one chain with 10 tries.

    python scripts/torch_mcmc_baseline_hyperopt.py --trials 8 --seed 0
    python scripts/torch_mcmc_baseline_hyperopt.py --dataset synthcad --testset train \\
        --scenes 1 2 --trials 8 --time-budget 0.5 --seed 0 \\
        --samplers mh_sampler mtm_sampler \\
        --experiment-names mcmc_hyperopt_cad_mh mcmc_hyperopt_cad_mtm

Each search writes under data/exp_{raw,pro}/<experiment name>_cuda/; the
experiment names default to mcmc_hyperopt_<sampler>. Runs on the CUDA
device unless ``--device cpu`` is given.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch_smc_bop_val as bopval  # noqa: E402
import torch_smc_mh_hyperopt as hyperopt  # noqa: E402


def parse_args(argv=None):
    ap = bopval.common_args(__doc__)
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--time-budget", type=float, default=0.25)
    ap.add_argument("--samplers", nargs="+", default=["mh_sampler", "mtm_sampler"],
                    choices=[s for s in bopval.SAMPLERS if bopval.is_mcmc(s)])
    ap.add_argument("--experiment-names", nargs="+", default=None,
                    help="one per sampler (default: mcmc_hyperopt_<sampler>)")
    ap.add_argument("--seed", type=int, default=None,
                    help="search RNG seed of every search (default: per sampler)")
    args = ap.parse_args(argv)
    if args.experiment_names is None:
        args.experiment_names = [f"mcmc_hyperopt_{s}" for s in args.samplers]
    if len(args.experiment_names) != len(args.samplers):
        ap.error("--experiment-names takes one name per sampler")
    return args


def search_argvs(args):
    """The ``torch_smc_mh_hyperopt.py`` arguments of each sampler's search."""
    return [["--bop-dir", args.bop_dir, "--dataset", args.dataset, "--testset", args.testset,
             "--scenes", *[str(s) for s in args.scenes], "--trials", str(args.trials),
             "--time-budget", str(args.time_budget), "--sampler", sampler,
             "--n-particles", str(bopval.MCMC_TRIES), "--experiment-name", name,
             "--device", args.device, *(["--seed", str(args.seed)] if args.seed is not None
                                        else [])]
            for sampler, name in zip(args.samplers, args.experiment_names)]


def main(argv=None, data_root="data"):
    args = parse_args(argv)
    results = {}
    for sampler, argv_s in zip(args.samplers, search_argvs(args)):
        print(f"=== hyperopt: {sampler}")
        results[sampler] = hyperopt.main(argv_s, data_root=data_root)
    return results


if __name__ == "__main__":
    main()
