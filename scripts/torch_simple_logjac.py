#!/usr/bin/env python3
"""Sampling a constrained distribution through unconstrained proposals, on
the PyTorch/CUDA port.

    python3 scripts/torch_simple_logjac.py [--n-steps 10000] [--device cuda]
    python3 scripts/torch_simple_logjac.py --save-arrays simple_logjac.npz
    python3 scripts/torch_simple_logjac.py --draw-from simple_logjac.npz

The counterpart of scripts/simple_logjac.py: a known Exponential(θ = 3)
sampled through proposals that live in unconstrained log space, on the
port's ``PosteriorModel`` (the posterior is the prior: a constant
likelihood). A symmetric random-walk MH (N(0, 0.1) steps), an independent MH
(N(0, 1.5) draws) and their 0.5 / 0.5 composition each run --n-steps steps
of 8 particles, dropping 500 steps of burn-in and keeping every 5th. The
histogram matches the true density only if the bijector's log-Jacobian is
applied. Prints each chain's mean against θ as the JAX script does.
``--save-arrays`` / ``--draw-from``, --device and --out
(plots/cuda/simple_logjac.pdf) as in scripts/torch_plot_depth_imgs.py.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
from _figures import figure_args, run_figure  # noqa: E402

THETA = 3.0
N_PARTICLES = 8
N_BURN_IN = 500
COLLECT_EVERY = 5
CHAINS = ("symmetric RW", "independent", "composed")
# At 2,000 steps each chain's mean lies within this share of θ: four standard
# deviations of the mean over 16 seeds, in both packages on the CPU (the
# random walk's 0.1 steps in log space mix slowly: sd 0.16 of θ; the others
# 0.014-0.027). tests/test_torch_figure_scripts.py and chip_smoke.py hold the
# chains to it.
CHECK_STEPS = 2000
MEAN_REL_BOUND = {"symmetric RW": 0.65, "independent": 0.12, "composed": 0.12}


def parse_args(argv=None):
    ap = figure_args(__doc__, "plots/cuda/simple_logjac.pdf", bop=False)
    ap.add_argument("--n-steps", type=int, default=10_000)
    return ap.parse_args(argv)


def target_model(theta, device):
    """Posterior == Exponential(theta) prior (constant likelihood)."""
    import torch

    from bayesianposeestimation.jl_tpu_torch.distributions import Exponential, Normal
    from bayesianposeestimation.jl_tpu_torch.graph import BroadcastedNode, DeterministicNode
    from bayesianposeestimation.jl_tpu_torch.posterior import PosteriorModel

    z = BroadcastedNode("z", Exponential, theta)
    m = DeterministicNode("m", lambda z: 0.0 * z, z)
    y = BroadcastedNode("y", Normal, m, 1.0) | torch.zeros((), device=device)
    return PosteriorModel(y)


def samplers(model):
    """The three samplers of the JAX script, by name."""
    from bayesianposeestimation.jl_tpu_torch.distributions import Normal
    from bayesianposeestimation.jl_tpu_torch.graph import BroadcastedNode, sequentialize
    from bayesianposeestimation.jl_tpu_torch.proposals import (
        independent_proposal,
        symmetric_proposal,
    )
    from bayesianposeestimation.jl_tpu_torch.samplers import (
        ComposedSampler,
        MetropolisHastings,
    )
    from bayesianposeestimation.jl_tpu_torch.tempering import ConstantSchedule

    sym = MetropolisHastings(
        symmetric_proposal(sequentialize(BroadcastedNode("z", Normal, 0.0, 0.1)), model),
        ConstantSchedule())
    ind = MetropolisHastings(
        independent_proposal(sequentialize(BroadcastedNode("z", Normal, 0.0, 1.5)), model),
        ConstantSchedule())
    return dict(zip(CHAINS, (sym, ind, ComposedSampler((sym, ind), weights=(0.5, 0.5)))))


def chains(args) -> dict:
    """The model-domain samples of each chain, [kept steps * particles]."""
    from bayesianposeestimation.jl_tpu_torch.devices import resolve_device
    from bayesianposeestimation.jl_tpu_torch.samplers import sample_chain

    device = resolve_device(args.device)
    model = target_model(THETA, device)
    out = {}
    for i, (label, sampler) in enumerate(samplers(model).items()):
        outs, _ = sample_chain(i, model, sampler, n_steps=args.n_steps,
                               n_particles=N_PARTICLES, collect_vars=("z",), device=device,
                               n_burn_in=N_BURN_IN, collect_every=COLLECT_EVERY)
        z = np.exp(outs["z"].cpu().numpy().ravel())  # unconstrained -> model domain
        print(f"{label}: mean {z.mean():.3f} (target {THETA}), "
              f"rel err {abs(z.mean() - THETA) / THETA:.3f}")
        out[label] = z
    return out


def draw_histograms(arrays, out):
    from bayesianposeestimation.jl_tpu_torch.utils.visualization import _plt, diss_defaults

    diss_defaults()
    fig, axes = _plt().subplots(1, 3, figsize=(9, 2.8), sharey=True)
    xs = np.linspace(0, 15, 200)
    pdf = np.exp(-xs / THETA) / THETA
    for ax, label in zip(axes, CHAINS):
        z = arrays[label]
        ax.hist(z[z < 15], bins=np.arange(0, 15.5, 0.5), density=True, alpha=0.6)
        ax.plot(xs, pdf, lw=2)
        ax.set_title(label)
        ax.set_xlabel("z")
    fig.savefig(out)
    return fig


def main(argv=None):
    return run_figure(parse_args(argv), chains, draw_histograms)


if __name__ == "__main__":
    main()
