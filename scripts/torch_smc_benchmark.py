"""Recall against compute budget through the PyTorch/CUDA port (counterpart
of ``scripts/smc_benchmark.py``): ``smc_mh`` at n_particles in {10, 50,
100, 250} x pose time budgets in {0.05, 0.1, 0.25, 0.5, 1.2} s, each
dataset at its tuned parameters. Errors are pooled over the scenes of each
(n_particles, pose_time) cell; the table gives VSD recall with its Wilson
interval, ADD-S recall, and the slowest scene's mean time per pose with
whether it kept the budget.

    python scripts/torch_smc_benchmark.py --scenes 1 [--particles 10 100] \\
        [--budgets 0.25 0.5] [--dataset synthcad --experiment-name smc_benchmark_cad] \\
        [--device cpu]

Estimates go to data/exp_raw/<experiment-name>_cuda/, errors and
recall_vs_budget.csv to data/exp_pro/<experiment-name>_cuda/ under the
current directory. The JAX script's plot waits for the port of
``utils/visualization.py``; the CSV holds its numbers. Runs on the CUDA
device unless ``--device cpu`` is given.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch_smc_bop_val as bopval  # noqa: E402

TABLE = "recall_vs_budget.csv"


def parse_args(argv=None, dataset="synth", experiment_name="smc_benchmark"):
    ap = bopval.common_args(__doc__, dataset)
    ap.add_argument("--particles", type=int, nargs="+", default=[10, 50, 100, 250])
    ap.add_argument("--budgets", type=float, nargs="+", default=[0.05, 0.1, 0.25, 0.5, 1.2])
    ap.add_argument("--sampler", default="smc_mh")
    ap.add_argument("--experiment-name", default=experiment_name)
    return ap.parse_args(argv)


def configs(args):
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import dict_list

    return dict_list({"sampler": args.sampler, "dataset": args.dataset,
                      "testset": args.testset, "scene_id": list(args.scenes),
                      "n_particles": list(args.particles), "pose_time": list(args.budgets)})


def tuned(args):
    """The dataset's and sampler's tuned parameters; they are the artifacts'
    signature, so a re-tune cannot mix operating points."""
    return dict(bopval.tuned_parameters(args.dataset, args.sampler))


def parameters(config, args):
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters

    return Parameters(n_particles=config["n_particles"], time_budget=config["pose_time"],
                      device=args.device, **tuned(args))


def run(config, args, cache=None, data_root="data"):
    """One config's estimates and errors: (result, errors)."""
    return bopval.run_config(args.experiment_name, config, parameters(config, args),
                             args.bop_dir, args.device, signature=tuned(args), cache=cache,
                             data_root=data_root)


def table(results, args):
    """recall_vs_budget.csv's rows from (config, result, errors) triples:
    errors pooled over the scenes of each (n_particles, pose_time) cell; the
    budget is kept where every scene's mean time per pose is within it."""
    from bayesianposeestimation.jl_tpu_torch.utils import evaluation as ev

    cells = {}
    for config, result, errors in results:
        mean_time = float(np.mean([r["time"] for r in result["result_rows"]]))
        cell = cells.setdefault((config["n_particles"], config["pose_time"]),
                                dict(vsd=[], adds=[], times=[], scenes=[]))
        cell["vsd"].append(errors["vsd"])
        cell["adds"].append(errors["adds"])
        cell["times"].append(mean_time)
        cell["scenes"].append(config["scene_id"])
    rows = []
    for (n_particles, pose_time), cell in sorted(cells.items()):
        n_vsd = ev.threshold_errors(np.concatenate(cell["vsd"]), ev.BOP18_THETA)
        vsd_lo, vsd_hi = ev.recall_ci(*n_vsd)
        worst_time = max(cell["times"])
        rows.append(dict(sampler=args.sampler, testset=args.testset,
                         scene_id="+".join(str(s) for s in cell["scenes"]),
                         n_particles=n_particles, pose_time=pose_time,
                         vsd_recall=ev.recall(*n_vsd),
                         adds_recall=ev.recall(*ev.threshold_errors(
                             np.concatenate(cell["adds"]), ev.ADDS_THETA)),
                         n_gt=n_vsd[1], vsd_ci_lo=vsd_lo, vsd_ci_hi=vsd_hi,
                         mean_pose_time=worst_time, budget_ok=bool(worst_time <= pose_time)))
    return rows


def main(argv=None, dataset="synth", experiment_name="smc_benchmark"):
    args = parse_args(argv, dataset, experiment_name)
    bopval.sweep_main(sys.modules[__name__], args, args.experiment_name)


if __name__ == "__main__":
    main()
