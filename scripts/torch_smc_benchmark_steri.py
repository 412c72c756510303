"""The recall-against-budget sweep on the second dataset through the
PyTorch/CUDA port (counterpart of ``scripts/smc_benchmark_steri.py``):
``torch_smc_benchmark.py`` on ``synth_steri``, whose name makes
``evaluate_scene`` use the stricter ITODD visibility tolerance (5 mm instead
of 15 mm), under the experiment name ``smc_benchmark_steri``.

    python scripts/torch_smc_benchmark_steri.py --scenes 1 --particles 100 \\
        --budgets 0.25 0.5 [--device cpu]

Takes ``torch_smc_benchmark.py``'s arguments. The data set is checked in at
data/bop/synth_steri; where --bop-dir lacks <dataset>/val, the script first
makes it there, as the JAX script does, with the port's generator
(``scripts/torch_make_synthetic_bop.py --dataset synth_steri --seed 7
--root <bop-dir>``, on --device), then runs the sweep.
"""

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch_smc_benchmark as bench  # noqa: E402

DATASET = "synth_steri"
NAME = "smc_benchmark_steri"
SEED = 7  # the JAX script's generator seed


def parse_args(argv=None):
    return bench.parse_args(argv, DATASET, NAME)


def generator_argv(args):
    """The generator's command line that makes the data set in --bop-dir."""
    return [sys.executable, str(Path(__file__).resolve().parent / "torch_make_synthetic_bop.py"),
            "--dataset", args.dataset, "--seed", str(SEED), "--root", str(args.bop_dir),
            "--device", args.device]


def main(argv=None):
    args = parse_args(argv)
    if not (Path(args.bop_dir) / args.dataset / "val").is_dir():
        print(f"generating the {args.dataset} data set in {args.bop_dir}...")
        subprocess.run(generator_argv(args), check=True)
    bench.main(argv, DATASET, NAME)
    return 0


if __name__ == "__main__":
    sys.exit(main())
