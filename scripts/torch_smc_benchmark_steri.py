"""The recall-against-budget sweep on the second dataset through the
PyTorch/CUDA port (counterpart of ``scripts/smc_benchmark_steri.py``):
``torch_smc_benchmark.py`` on ``synth_steri``, whose name makes
``evaluate_scene`` use the stricter ITODD visibility tolerance (5 mm instead
of 15 mm), under the experiment name ``smc_benchmark_steri``.

    python scripts/torch_smc_benchmark_steri.py --scenes 1 --particles 100 \\
        --budgets 0.25 0.5 [--device cpu]

Takes ``torch_smc_benchmark.py``'s arguments. The data set is checked in at
data/bop/synth_steri; where --bop-dir lacks it, the script says so and exits
non-zero (the generator, scripts/make_synthetic_bop.py, is not ported).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch_smc_benchmark as bench  # noqa: E402

DATASET = "synth_steri"
NAME = "smc_benchmark_steri"


def parse_args(argv=None):
    return bench.parse_args(argv, DATASET, NAME)


def main(argv=None):
    args = parse_args(argv)
    split = Path(args.bop_dir) / args.dataset / args.testset
    if not split.is_dir():
        print(f"{split} not found: the {args.dataset} data set is not in {args.bop_dir} "
              "(scripts/make_synthetic_bop.py makes it; it has no port yet)", file=sys.stderr)
        return 1
    bench.main(argv, DATASET, NAME)
    return 0


if __name__ == "__main__":
    sys.exit(main())
