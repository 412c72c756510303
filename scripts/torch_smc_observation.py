"""Observation-model ablation through the PyTorch/CUDA port (counterpart of
``scripts/smc_observation.py``): ``smc_mh`` with each of the eight fused
score variants (exponential / smooth / uniform pixel tail, with and without
the analytic association and the image regularization) crossed with a
segmentation-mask or flat o-prior, at 0.5 s per pose.

    python scripts/torch_smc_observation.py --scenes 1 \\
        [--variants association smooth simple] [--o-priors mask] [--device cpu]

Estimates go to data/exp_raw/smc_observation_cuda/, errors and
observation_recall.csv to data/exp_pro/smc_observation_cuda/ under the
current directory. Runs on the CUDA device unless ``--device cpu`` is given.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch_smc_bop_val as bopval  # noqa: E402

NAME = "smc_observation"
TABLE = "observation_recall.csv"
VARIANTS = ["association", "association_simple_reg", "simple",
            "smooth", "smooth_simple_reg", "smooth_simple",
            "no_exp", "no_exp_association"]


def parse_args(argv=None):
    ap = bopval.common_args(__doc__)
    ap.add_argument("--variants", nargs="+", default=VARIANTS, choices=VARIANTS)
    ap.add_argument("--o-priors", nargs="+", default=["mask", "flat"], choices=["mask", "flat"])
    ap.add_argument("--time-budget", type=float, default=0.5)
    ap.add_argument("--n-particles", type=int, default=100)
    return ap.parse_args(argv)


def configs(args):
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import dict_list

    return dict_list({"sampler": "smc_mh", "dataset": args.dataset, "testset": args.testset,
                      "scene_id": list(args.scenes), "variant": list(args.variants),
                      "o_prior": list(args.o_priors)})


def parameters(config, args):
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters

    return Parameters(n_particles=args.n_particles, time_budget=args.time_budget,
                      device=args.device, **bopval.SWEEP_TUNED)


def run(config, args, cache=None, data_root="data"):
    """One config's estimates and errors: (result, errors)."""
    return bopval.run_config(NAME, config, parameters(config, args), args.bop_dir, args.device,
                             cache=cache, data_root=data_root)


def table(results, args):
    """observation_recall.csv's rows from (config, result, errors) triples."""
    return [dict(variant=c["variant"], o_prior=c["o_prior"], scene_id=c["scene_id"],
                 **bopval.scene_recalls(e)) for c, _, e in results]


def main(argv=None):
    bopval.sweep_main(sys.modules[__name__], parse_args(argv), NAME)


if __name__ == "__main__":
    main()
