"""The no-JAX check compares whole components of module names."""

from portbench.imports import forbidden


def test_port_passes_jax_package_and_jax_fail():
    names = ["bayesianposeestimation", "bayesianposeestimation.jl_tpu_torch",
             "bayesianposeestimation.jl_tpu_torch.ops", "jaxtyping", "flaxen", "numpy",
             "bayesianposeestimation.jl_tpu", "bayesianposeestimation.jl_tpu.ops",
             "jax", "jax.numpy", "jaxlib", "flax.linen"]
    assert forbidden(names) == sorted(["bayesianposeestimation.jl_tpu",
                                       "bayesianposeestimation.jl_tpu.ops", "jax", "jax.numpy",
                                       "jaxlib", "flax.linen"])


def test_the_harness_and_the_port_load_no_jax():
    import sys

    import portbench.calibrate  # noqa: F401
    import portbench.entries.conditioned_chain  # noqa: F401
    import portbench.entries.particle_filter  # noqa: F401
    import portbench.run  # noqa: F401

    assert forbidden(sys.modules) == []


def test_the_reference_loads_neither_the_port_nor_jax():
    """The check kinds and the reference they share, imported alone."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys; import portbench.reference.check as c; "
            "[c.kind_module(k) for k in ('bop', 'track', 'mcmc')]; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('bayesianposeestimation', 'jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[2], check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
