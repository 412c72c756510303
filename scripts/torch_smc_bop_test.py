"""BOP19 submission CSV through the PyTorch/CUDA port (counterpart of
``scripts/smc_bop_test.py``): per-target pose estimation under the per-pose
time budget, written as the BOP challenge's CSV.

    python scripts/torch_smc_bop_test.py --dataset synth --testset val --scenes 1

Each scene's estimates come from ``torch_smc_bop_val.scene_inference`` with
the split's tuned parameters (``tuned_parameters(dataset, sampler)``) and are
cached as an artifact under data/exp_raw/smc_bop_test_cuda/ (the current
directory's). The CSV has one row per estimate: scene_id, im_id, obj_id,
score (the best log-likelihood), R (row-major, %.9f), t in millimetres
(%.6f) and the image's time, the sum of its estimates' wall seconds (%.4f),
as the BOP19 format counts time per image. The default output is
data/<sampler>_<dataset>-<testset>_cuda.csv. Runs on the CUDA device unless
``--device cpu`` is given (slow: the CPU runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HEADER = "scene_id,im_id,obj_id,score,R,t,time"


def submission_lines(result_rows):
    """The CSV's lines (header first) for one scene's result rows: each
    estimate's rotation from its quaternion, its translation in millimetres,
    and its image's time (the sum over the image's estimates)."""
    from bayesianposeestimation.jl_tpu_torch import quaternions as quat

    by_img = {}
    for r in result_rows:
        by_img.setdefault(r["img_id"], []).append(r)
    lines = []
    for rows in by_img.values():
        img_time = sum(r["time"] for r in rows)
        for r in rows:
            R = quat.quat_to_matrix(torch.as_tensor(np.asarray(r["q"]), dtype=torch.float32))
            R_str = " ".join(f"{v:.9f}" for v in R.numpy().ravel())
            t_str = " ".join(f"{v * 1000.0:.6f}" for v in np.asarray(r["t"]))
            lines.append(f"{r['scene_id']},{r['img_id']},{r['obj_id']},{r['score']:.6f},"
                         f"{R_str},{t_str},{img_time:.4f}")
    return lines


def scene_results(scenes, dataset, testset, sampler, parameters, bop_dir, raw_dir, device):
    """Per scene, the estimates of ``scene_inference`` (loaded from
    ``raw_dir`` when an artifact of the same parameters is there)."""
    import torch_smc_bop_val as bopval

    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import produce_or_load, savename

    signature = dict(n_particles=parameters.n_particles, time_budget=parameters.time_budget,
                     **bopval.tuned_parameters(dataset, sampler))
    results = []
    for scene_id in scenes:
        config = {"sampler": sampler, "dataset": dataset, "testset": testset,
                  "scene_id": scene_id}
        result, _ = produce_or_load(
            lambda c: bopval.scene_inference(c, bop_dir, parameters, device),
            config, raw_dir, filename=savename(config), signature=signature)
        results.append(result)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--bop-dir", default="data/bop")
    ap.add_argument("--dataset", default="synth")
    ap.add_argument("--testset", default="val")
    ap.add_argument("--scenes", type=int, nargs="+", default=[1])
    ap.add_argument("--sampler", default="smc_mh")
    ap.add_argument("--time-budget", type=float, default=0.5)
    ap.add_argument("--n-particles", type=int, default=100)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch_smc_bop_val as bopval

    from bayesianposeestimation.jl_tpu_torch.devices import resolve_device
    from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
    from bayesianposeestimation.jl_tpu_torch.utils.artifacts import datadir

    device = resolve_device(args.device)
    parameters = Parameters(n_particles=args.n_particles, time_budget=args.time_budget,
                            device=device.type,
                            **bopval.tuned_parameters(args.dataset, args.sampler))
    results = scene_results(args.scenes, args.dataset, args.testset, args.sampler, parameters,
                            args.bop_dir, datadir("exp_raw", "smc_bop_test_cuda"), device)
    lines = [HEADER] + [line for res in results for line in submission_lines(res["result_rows"])]
    out = Path(args.out or f"data/{args.sampler}_{args.dataset}-{args.testset}_cuda.csv")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    print(f"wrote BOP submission CSV: {out} ({len(lines) - 1} estimates)")


if __name__ == "__main__":
    main()
