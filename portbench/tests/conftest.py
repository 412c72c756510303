"""The benchmark's own tests: ``python -m pytest portbench/tests``. They
import torch and the port, never JAX. A test marked ``card`` needs a CUDA
device; the ``card`` fixture decides that when the test runs and skips it
otherwise."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"


def tiny_cell(name):
    """The cell ``name`` cut to a size a CPU test run holds: 4 particles and
    5 steps a pose (an MCMC chain: its chains, and 40 steps, so that it
    moves), or 16 particles on 2 clips of 6 frames at 40x30; the check reads
    2 requests."""
    from portbench import cells

    cell, config = cells.load(name)
    if config["entry"] == "conditioned_chain":
        config["n_steps"] = 40 if config.get("estimate") == "chain_best" else 5
        cell["traffic"]["n_particles"] = 4
    else:
        config["n_particles"] = 16
        cell["traffic"].update(n_clips=2, n_frames=6, width=40, height=30)
        cell["check"]["frames"] = 3
    cell["check"]["requests"] = 2
    return cell, config


@pytest.fixture
def tiny():
    return tiny_cell
