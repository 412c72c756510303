"""Importing the port never initializes the card.

The counterpart of ``tests/test_import_hostonly.py``: in a fresh process,
importing every module of ``jl_tpu_torch`` and every
``scripts/torch_*.py``, ``bench_torch.py``, ``parity_cases.py`` and
``chip_smoke.py`` leaves ``torch.cuda.is_initialized()`` false and imports
neither JAX nor the JAX package nor matplotlib (the card's machine has none: figures are drawn
elsewhere). A kernel is built and launched only inside the call that needs
it.
"""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = """
import importlib, pkgutil, sys
from pathlib import Path
import torch
import bayesianposeestimation.jl_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, "scripts")
scripts = sorted(p.stem for p in Path("scripts").glob("torch_*.py"))
for name in scripts + ["bench_torch", "parity_cases", "chip_smoke"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "matplotlib")
             or m.startswith(("jax.", "matplotlib.", "bayesianposeestimation.jl_tpu.")))
print(len(names), len(scripts), torch.cuda.is_initialized(), bad)
"""


def test_port_import_leaves_the_card_alone():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
                          timeout=300, cwd=str(REPO),
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
                               "HOME": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    n_modules, n_scripts, initialized, jax_modules = proc.stdout.split(maxsplit=3)
    assert int(n_modules) >= 40 and int(n_scripts) >= 19, proc.stdout
    assert initialized == "False", proc.stdout
    assert jax_modules.strip() == "[]", proc.stdout
