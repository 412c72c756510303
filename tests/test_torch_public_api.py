"""The port's public names against the JAX package's.

``import bayesianposeestimation.jl_tpu_torch as bpt`` re-exports the
counterpart of every name and submodule of ``jl_tpu/__init__.py``, each the
object of the matching port module (the Pallas kernels by the names
``JAX_COUNTERPARTS`` gives them); every module of ``jl_tpu`` has a port
module, and every public name of it (functions, classes, their methods,
module constants) is in that module, but for the JAX- and Pallas-only names
``JAX_COUNTERPARTS`` lists. The package and ``utils.visualization`` import
without matplotlib.
"""

import ast
import importlib
import inspect
import subprocess
import sys
from pathlib import Path

import pytest

import bayesianposeestimation.jl_tpu as jl_tpu
import bayesianposeestimation.jl_tpu_torch as bpt
from bayesianposeestimation.jl_tpu_torch import JAX_COUNTERPARTS

REPO = Path(__file__).resolve().parent.parent
JAX_ROOT = REPO / "bayesianposeestimation/jl_tpu"
PORT = "bayesianposeestimation.jl_tpu_torch"


def _package_imports():
    """(module path under the package or "", name) of every name
    jl_tpu/__init__.py imports."""
    tree = ast.parse((JAX_ROOT / "__init__.py").read_text())
    return [(node.module or "", a.name) for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.level == 1 for a in node.names]


def _resolve(path):
    """A dotted path under the port package (module, then attributes)."""
    parts = path.split(".")
    for cut in range(len(parts), -1, -1):
        try:
            obj = importlib.import_module(".".join([PORT, *parts[:cut]]))
        except ModuleNotFoundError:
            continue
        for p in parts[cut:]:
            obj = getattr(obj, p)
        return obj
    raise AssertionError(path)


def _is_submodule(module, name):
    path = JAX_ROOT.joinpath(*module.split("."), name) if module else JAX_ROOT / name
    return path.with_suffix(".py").exists() or (path / "__init__.py").exists()


def test_package_counts_and_version():
    imports = _package_imports()
    modules = [n for m, n in imports if _is_submodule(m, n)]
    assert len(imports) - len(modules) == 129 and len(modules) == 17
    assert bpt.__version__ == jl_tpu.__version__


@pytest.mark.parametrize("module,name", _package_imports(),
                         ids=[f"{m}.{n}".lstrip(".") for m, n in _package_imports()])
def test_every_package_name_has_its_port_counterpart(module, name):
    """The JAX name's counterpart is exported under the same name (or the
    mapped one) and is the very object of the matching port module."""
    if _is_submodule(module, name):
        port_module = importlib.import_module(f"{PORT}.{module}.{name}".replace("..", "."))
        if inspect.ismodule(getattr(jl_tpu, name)):
            assert getattr(bpt, name) is port_module
        else:  # render: the function render.render shadows its module, in both packages
            assert getattr(bpt, name) is getattr(port_module, name)
        return
    key = f"{module}.{name}"
    if key in JAX_COUNTERPARTS:
        stand_in = JAX_COUNTERPARTS[key]
        if stand_in is None:
            assert not hasattr(bpt, name)
        else:
            from bayesianposeestimation.jl_tpu_torch.ops import cuda_raster

            assert module == "ops.pallas_raster"
            assert getattr(bpt, stand_in) is getattr(cuda_raster, name[len("pallas_"):])
        return
    port_module = importlib.import_module(f"{PORT}.{module}") if module else bpt
    assert getattr(bpt, name) is getattr(port_module, name)
    if (module, name) == ("render", "render"):
        # the function shadows the module of that name, in both packages
        assert jl_tpu.render is sys.modules["bayesianposeestimation.jl_tpu.render"].render
        assert bpt.render is sys.modules[f"{PORT}.render"].render and callable(bpt.render)


def _modules():
    out = []
    for path in sorted(JAX_ROOT.rglob("*.py")):
        rel = path.relative_to(JAX_ROOT).with_suffix("")
        out.append(".".join(p for p in rel.parts if p != "__init__") or "")
    return out


def _public_names(path):
    """Top-level functions, classes (with their public methods) and
    constants of a module; a subpackage's ``__init__`` adds the names it
    imports (the package's own are the test above's)."""
    tree = ast.parse(path.read_text())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, ast.FunctionDef) and not m.name.startswith("_")]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names += [t.id for t in targets if isinstance(t, ast.Name)
                      and not t.id.startswith("_")]
        elif (isinstance(node, ast.ImportFrom) and path.name == "__init__.py"
              and path.parent != JAX_ROOT and node.module != "__future__"):
            names += [a.asname or a.name for a in node.names]
    return names


@pytest.mark.parametrize("module", _modules(), ids=lambda m: m or "__init__")
def test_every_jax_module_and_name_has_a_port_counterpart(module):
    """The module's port counterpart exists and holds each public name,
    outside the documented JAX- and Pallas-only names."""
    rel = Path(*module.split(".")) if module else Path()
    path = JAX_ROOT / rel / "__init__.py"
    if not path.exists():
        path = (JAX_ROOT / rel).with_suffix(".py")
    port = JAX_COUNTERPARTS.get(module, module)
    port_module = _resolve(port) if port else bpt
    missing = []
    for name in _public_names(path):
        key = f"{module}.{name}".lstrip(".")
        if key in JAX_COUNTERPARTS:
            if JAX_COUNTERPARTS[key] is not None:
                _resolve(JAX_COUNTERPARTS[key])
            continue
        obj = port_module
        try:
            for part in name.split("."):
                obj = getattr(obj, part)
        except AttributeError:
            missing.append(name)
    assert not missing, f"{module or '__init__'}: {missing}"


def test_counterpart_keys_name_real_jax_names():
    """Every key of the mapping is a module or a public name of jl_tpu."""
    known = set(_modules())
    for module in _modules():
        rel = Path(*module.split(".")) if module else Path()
        path = JAX_ROOT / rel / "__init__.py"
        if not path.exists():
            path = (JAX_ROOT / rel).with_suffix(".py")
        known |= {f"{module}.{n}".lstrip(".") for n in _public_names(path)}
    assert set(JAX_COUNTERPARTS) <= known, set(JAX_COUNTERPARTS) - known


@pytest.mark.parametrize("name", ["TailUniform", "SmoothExponential", "BinaryMixture"])
def test_sample_methods_added_for_parity_draw_as_jax_does(name):
    """The port's draws agree with JAX's in distribution: the means of
    40,000 draws within five standard errors of each other, and each
    package's draws inside the support."""
    import jax
    import numpy as np
    import torch

    from bayesianposeestimation.jl_tpu import distributions as jd
    from bayesianposeestimation.jl_tpu_torch import distributions as td

    def make(d):
        if name == "TailUniform":
            return d.TailUniform(0.5, 1.5)
        if name == "SmoothExponential":
            return d.SmoothExponential(0.0, 0.8, 0.5, 0.02)
        return d.BinaryMixture(d.Normal(1.0, 0.01), d.Uniform(2.0, 3.0), 0.3, 0.7)

    n = 40_000
    ours = make(td).sample(torch.Generator().manual_seed(0), (n,)).numpy()
    ref = np.asarray(make(jd).sample(jax.random.PRNGKey(0), (n,)))
    assert ours.shape == ref.shape == (n,)
    se = np.sqrt((ours.var() + ref.var()) / n)
    assert abs(ours.mean() - ref.mean()) < 5 * se
    for x in (ours, ref):
        if name == "TailUniform":
            assert x.min() >= 0.5 and x.max() <= 1.5
        if name == "BinaryMixture":
            assert abs((x < 1.5).mean() - 0.3) < 0.02


def test_mesh_scaled_matches_jax():
    import numpy as np

    from bayesianposeestimation.jl_tpu.utils import mesh_io as jmesh
    from bayesianposeestimation.jl_tpu_torch.utils import mesh_io as tmesh

    ours, ref = tmesh.cube_mesh(0.1).scaled(2.5), jmesh.cube_mesh(0.1).scaled(2.5)
    np.testing.assert_array_equal(ours.vertices, ref.vertices)
    np.testing.assert_array_equal(ours.faces, ref.faces)


def test_package_and_visualization_import_without_matplotlib():
    code = ("import sys; sys.modules['matplotlib'] = None; "
            "import bayesianposeestimation.jl_tpu_torch as bpt; "
            "from bayesianposeestimation.jl_tpu_torch.utils import visualization as v; "
            "import torch; "
            "print(len(v.__all__), bpt.smc_mh.__module__, torch.cuda.is_initialized(), "
            "sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["12", f"{PORT}.models.experiment_samplers", "False", "[]"]
