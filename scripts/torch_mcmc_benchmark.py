"""Recall against compute for the MCMC baselines through the PyTorch/CUDA
port (counterpart of ``scripts/mcmc_benchmark.py``): ``mh_sampler`` and
``mh_local_sampler`` as one chain, ``mtm_sampler`` at 5, 10, 20 and 40
tries, each at pose time budgets of 0.25 and 0.5 s; the table gives recall
with the VSD Wilson interval and the mean time per pose, kept within 1.05x
the budget.

    python scripts/torch_mcmc_benchmark.py --scenes 1 [--mtm-tries 10 40] \\
        [--budgets 0.25] [--mode steps] [--device cpu]

Estimates go to data/exp_raw/mcmc_benchmark_cuda/, errors and
recall_vs_time.csv to data/exp_pro/mcmc_benchmark_cuda/ under the current
directory. ``--mode steps`` runs each config for the ``n_steps`` that the
JAX run of the same config recorded (its artifact under ``--jax-dir``,
by default the checkout's data/exp_raw/mcmc_benchmark)
instead of the time budget, under the experiment name
``mcmc_benchmark_jaxsteps``; its table, recall_vs_steps.csv, gives the step
count and the mean time per run, which no budget bounds. The JAX script's
plot waits for the port of ``utils/visualization.py``; the CSV holds its
numbers. Runs on the CUDA device unless ``--device cpu`` is given.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch_smc_bop_val as bopval  # noqa: E402

NAME = "mcmc_benchmark"
TABLE = "recall_vs_time.csv"
STEPS_NAME = "mcmc_benchmark_jaxsteps"
STEPS_TABLE = "recall_vs_steps.csv"
BUDGET_SLACK = 1.05  # the budget contract: wall <= ~budget per pose
# the JAX run's estimates, whose n_steps --mode steps runs
JAX_RAW = Path(__file__).resolve().parent.parent / "data/exp_raw/mcmc_benchmark"


def parse_args(argv=None):
    ap = bopval.common_args(__doc__)
    ap.add_argument("--mtm-tries", type=int, nargs="+", default=[5, 10, 20, 40])
    ap.add_argument("--budgets", type=float, nargs="+", default=[0.25, 0.5])
    ap.add_argument("--mode", choices=("time", "steps"), default="time",
                    help="steps: each config at the n_steps of the JAX run's artifact")
    ap.add_argument("--jax-dir", default=str(JAX_RAW),
                    help="the JAX run's estimate artifacts, read with --mode steps")
    return ap.parse_args(argv)


def jax_steps(config, args):
    """The ``n_steps`` the JAX run of ``config`` recorded (its artifact in
    ``args.jax_dir``)."""
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import load_artifact, savename

    return int(load_artifact(Path(args.jax_dir) / (savename(config) + ".npz"))["n_steps"])


def configs(args):
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import dict_list

    out = []
    for scene_id in args.scenes:
        for pose_time in args.budgets:
            where = {"pose_time": pose_time, "dataset": args.dataset,
                     "testset": args.testset, "scene_id": scene_id}
            out += dict_list({"sampler": ["mh_sampler", "mh_local_sampler"], "n_particles": 1,
                              **where})
            out += dict_list({"sampler": "mtm_sampler", "n_particles": list(args.mtm_tries),
                              **where})
    return out


def parameters(config, args):
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters

    steps = {"n_steps": jax_steps(config, args)} if args.mode == "steps" else {}
    return Parameters(n_particles=config["n_particles"], time_budget=config["pose_time"],
                      device=args.device, **bopval.SWEEP_TUNED, **steps)


def run(config, args, cache=None, data_root="data"):
    """One config's estimates and errors: (result, errors)."""
    params = parameters(config, args)
    signature = dict(bopval.SWEEP_TUNED)
    if args.mode == "steps":
        signature["n_steps"] = params.n_steps
    return bopval.run_config(STEPS_NAME if args.mode == "steps" else NAME, config, params,
                             args.bop_dir, args.device, signature=signature, cache=cache,
                             data_root=data_root, fixed_steps=args.mode == "steps")


def table(results, args):
    """recall_vs_time.csv's rows from (config, result, errors) triples (with
    --mode steps recall_vs_steps.csv's: the step count and the mean time per
    run in place of the budget's columns)."""
    from bayesianposeestimation.jl_tpu_torch.utils import evaluation as ev

    rows = []
    for config, result, errors in results:
        n_vsd = ev.threshold_errors(errors["vsd"], ev.BOP18_THETA)
        vsd_lo, vsd_hi = ev.recall_ci(*n_vsd)
        recalls = bopval.scene_recalls(errors)
        mean_time = float(np.mean([r["time"] for r in result["result_rows"]]))
        if getattr(args, "mode", "time") == "steps":
            timing = dict(n_steps=int(result["n_steps"]), mean_run_time=mean_time)
        else:
            timing = dict(mean_pose_time=mean_time,
                          budget_ok=bool(mean_time <= BUDGET_SLACK * config["pose_time"]))
        rows.append(dict(
            **{k: v for k, v in config.items() if k not in ("dataset", "testset")},
            adds_recall=recalls["adds_recall"], vsd_recall=recalls["vsd_recall"],
            vsdbop_recall=recalls["vsdbop_recall"], n_gt=n_vsd[1], vsd_ci_lo=vsd_lo,
            vsd_ci_hi=vsd_hi, **timing))
    return rows


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "steps":
        bopval.sweep_main(sys.modules[__name__], args, STEPS_NAME, STEPS_TABLE)
    else:
        bopval.sweep_main(sys.modules[__name__], args, NAME)


if __name__ == "__main__":
    main()
