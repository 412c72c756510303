"""Sampler-state checkpoints: save an ``SmcState`` or ``MCMCState`` to an
``.npz`` and restore it.

Counterpart of ``jl_tpu/utils/checkpoint.py``, which saves the leaves of a
JAX pytree as ``leaf_0 ... leaf_k``. The port walks its frozen dataclasses in
field order and a dict by sorted key, the order ``jax.tree_util.tree_flatten``
gives for the JAX package's ``SmcState`` / ``MCMCState`` / ``Sample`` (their
fields are the port's, in the same order), and skips ``None`` as JAX does, so
a checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

__all__ = ["save_state", "load_state"]


def _leaves(node):
    """The state's array leaves in pytree order (``None`` has none)."""
    if node is None:
        return []
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [leaf for f in dataclasses.fields(node) for leaf in _leaves(getattr(node, f.name))]
    if isinstance(node, dict):
        return [leaf for k in sorted(node) for leaf in _leaves(node[k])]
    return [node]


def _rebuild(like, leaves, device):
    """``like`` with its leaves taken in order from the iterator ``leaves``:
    each a tensor on the like leaf's device and of its dtype (on ``device``
    where the like leaf is no tensor)."""
    if like is None:
        return None
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return type(like)(**{f.name: _rebuild(getattr(like, f.name), leaves, device)
                             for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        rebuilt = {k: _rebuild(like[k], leaves, device) for k in sorted(like)}
        return {k: rebuilt[k] for k in like}
    value = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(value, dtype=like.dtype, device=like.device)
    return torch.as_tensor(value, device=device)


def save_state(path, state):
    """Write the state's leaves as ``leaf_0 ... leaf_k`` to a compressed
    ``.npz`` (parent directories are created)."""
    data = {f"leaf_{i}": np.asarray(leaf.detach().cpu() if isinstance(leaf, torch.Tensor)
                                    else leaf)
            for i, leaf in enumerate(_leaves(state))}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **data)


def load_state(path, like):
    """Restore a state written by ``save_state`` (of either package) into the
    structure of ``like``, a state of the same kind and variables; the
    tensors land on the like state's device."""
    shape = _leaves(like)
    device = next((x.device for x in shape if isinstance(x, torch.Tensor)), torch.device("cpu"))
    with np.load(path) as f:
        if len(f.files) != len(shape):
            raise ValueError(f"{path}: {len(f.files)} leaves, the like state has {len(shape)}")
        leaves = [f[f"leaf_{i}"] for i in range(len(shape))]
    return _rebuild(like, iter(leaves), device)
