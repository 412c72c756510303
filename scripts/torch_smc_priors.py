"""Prior ablation through the PyTorch/CUDA port (counterpart of
``scripts/smc_priors.py``): ``smc_mh`` with the position prior from a noisy
ground truth (``point``, flat o = o_mask_is), from the segmentation mask
(``mask``, per-pixel mask o-prior) or both (``point_mask``), at 0.5 s per
pose.

    python scripts/torch_smc_priors.py --scenes 1 [--priors point mask] [--device cpu]

Estimates go to data/exp_raw/smc_priors_cuda/, errors and priors_recall.csv
to data/exp_pro/smc_priors_cuda/ under the current directory. Runs on the
CUDA device unless ``--device cpu`` is given.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch_smc_bop_val as bopval  # noqa: E402

NAME = "smc_priors"
TABLE = "priors_recall.csv"
PRIORS = ["point", "mask", "point_mask"]


def parse_args(argv=None):
    ap = bopval.common_args(__doc__)
    ap.add_argument("--priors", nargs="+", default=PRIORS, choices=PRIORS)
    ap.add_argument("--time-budget", type=float, default=0.5)
    ap.add_argument("--n-particles", type=int, default=100)
    return ap.parse_args(argv)


def configs(args):
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import dict_list

    return dict_list({"sampler": "smc_mh", "dataset": args.dataset, "testset": args.testset,
                      "scene_id": list(args.scenes), "prior": list(args.priors)})


def parameters(config, args):
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters

    return Parameters(n_particles=args.n_particles, time_budget=args.time_budget,
                      device=args.device, **bopval.SWEEP_TUNED)


def run(config, args, cache=None, data_root="data"):
    """One config's estimates and errors: (result, errors)."""
    return bopval.run_config(NAME, config, parameters(config, args), args.bop_dir, args.device,
                             cache=cache, data_root=data_root)


def table(results, args):
    """priors_recall.csv's rows from (config, result, errors) triples."""
    return [dict(prior=c["prior"], scene_id=c["scene_id"], **bopval.scene_recalls(e))
            for c, _, e in results]


def main(argv=None):
    bopval.sweep_main(sys.modules[__name__], parse_args(argv), NAME)


if __name__ == "__main__":
    main()
