"""The graph posterior and tempered log densities.

Counterpart of ``jl_tpu/posterior.py``: ``PosteriorModel`` splits a
sequentialized graph into prior and likelihood (the observed nodes), samples
the prior's stochastic variables in the unconstrained domain and evaluates
ℓ_prior + logjac and ℓ_like; ``tempered_logdensity`` and ``retemper``.

Deterministic nodes (the render node μ, the association o) are recomputed in
every evaluation from the sample's variables, as in the JAX package; they
are not carried in samples. An evaluation makes no host synchronisation of
its own: the render node is one ``render_depth`` launch and the rest is
tensor code on the model's device (``chip_smoke.py`` phase 13a checks this
with torch's sync debug mode).
"""

from __future__ import annotations

import torch

from .devices import resolve_device
from .graph import (
    BroadcastedNode,
    ModifierNode,
    bijectors_of,
    device_of,
    evaluate_deterministic,
    logdensityof_graph,
    quaternion_names_of,
    sample_graph,
    sequentialize,
)
from .samples import Sample, to_model_domain, to_unconstrained_domain
from .telemetry import count

__all__ = ["PosteriorModel", "tempered_logdensity", "retemper"]


def _is_stochastic(node):
    inner = node.wrapped if isinstance(node, ModifierNode) else node
    return isinstance(inner, BroadcastedNode)


class PosteriorModel:
    """Posterior of the graph ending in ``root_node``.

    ``device``: where the model's tensors live and its chains run, the device
    of the graph's first tensor (an observation or a constant argument,
    ``graph.device_of``). A graph must hold a tensor on that device."""

    def __init__(self, root_node):
        graph = sequentialize(root_node)
        self.graph = graph
        self.prior = {n: node for n, node in graph.items() if not node.is_observed}
        self.likelihood = {n: node for n, node in graph.items() if node.is_observed}
        # the stochastic prior variables a Sample carries
        self.prior_stochastic = {n: node for n, node in self.prior.items()
                                 if _is_stochastic(node)}
        self.bijectors = bijectors_of(self.prior)
        self.quaternion_names = quaternion_names_of(self.prior)
        device = device_of(graph)
        if device is None:
            raise ValueError("the graph holds no tensor: put its observation on the device")
        self.device = resolve_device(device)

    def sample_prior(self, generator: torch.Generator, n_particles: int) -> Sample:
        """Prior sample in the unconstrained domain, [n_particles, ...]."""
        values = sample_graph(self.prior_stochastic, generator, (n_particles,))
        return to_unconstrained_domain(Sample(values), self.bijectors)

    def prior_and_likelihood(self, sample: Sample, batch_ndim: int = 1):
        """(ℓ_prior + logjac, ℓ_like), each of the leading ``batch_ndim``
        dims of the sample (e.g. [tries, chains])."""
        count(("evaluation", self.device.type))
        model_sample, logjac = to_model_domain(sample, self.bijectors, batch_ndim)
        values = evaluate_deterministic(self.graph, model_sample.variables)
        for name, node in self.likelihood.items():
            values.setdefault(name, node.observation)
        ell_prior = logdensityof_graph(self.prior, values, batch_ndim)
        ell_like = logdensityof_graph(self.likelihood, values, batch_ndim)
        return ell_prior + logjac, ell_like

    def logdensity_sample(self, sample: Sample, batch_ndim: int = 1) -> Sample:
        lp, ll = self.prior_and_likelihood(sample, batch_ndim)
        return sample.set_logdensities(lp + ll, ll)

    def tempered_logdensity_sample(self, sample: Sample, temp, batch_ndim: int = 1) -> Sample:
        """ℓ = ℓ_prior + ϕ·ℓ_like."""
        lp, ll = self.prior_and_likelihood(sample, batch_ndim)
        return sample.set_logdensities(tempered_logdensity(lp, ll, temp), ll)


def retemper(sample, old_temp, new_temp):
    """ℓ_ϕ' = ℓ_ϕ + (ϕ'-ϕ)·ℓ_like from the stored likelihood: no re-render."""
    delta = new_temp - old_temp
    adj = torch.where(delta != 0, delta * sample.log_like, torch.zeros_like(sample.log_like))
    return sample.set_logdensities(sample.log_prob + adj, sample.log_like)


def tempered_logdensity(log_prior, log_likelihood, temp=1.0):
    """ℓ_prior + ϕ·ℓ_like, where ϕ = 0 ignores a -inf likelihood (0 * -inf)."""
    temp = torch.as_tensor(temp, dtype=log_likelihood.dtype, device=log_likelihood.device)
    scaled = torch.where(temp > 0, temp * log_likelihood, torch.zeros_like(log_likelihood))
    return log_prior + scaled
