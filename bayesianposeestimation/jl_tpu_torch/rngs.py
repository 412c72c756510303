"""The random number generators a chain draws from.

JAX threads one key through every step; the port keeps two explicit
``torch.Generator``s instead: ``device`` for all particle noise (on the
tensors' device) and ``host`` (CPU) for choices the host makes, such as which
sub-sampler a ``ComposedSampler`` runs. Drawing those on the host keeps the
step free of device-to-host synchronisation. A captured chain
(``capture.ChainRunner``) registers ``device`` with each of its graphs and
reseeds it per run.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Rngs"]


@dataclass(frozen=True)
class Rngs:
    device: torch.Generator
    host: torch.Generator

    @classmethod
    def from_seed(cls, seed: int, device) -> "Rngs":
        dev = torch.Generator(device=torch.device(device))
        dev.manual_seed(seed)
        host = torch.Generator(device="cpu")
        host.manual_seed(seed + 1)
        return cls(dev, host)

    def reseed(self, seed: int) -> "Rngs":
        """Reseed both generators in place as ``from_seed`` seeds new ones
        (a captured chain keeps its generators: they are registered with its
        graphs)."""
        self.device.manual_seed(seed)
        self.host.manual_seed(seed + 1)
        return self
