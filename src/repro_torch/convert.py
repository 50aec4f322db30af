"""Convert parameter and cache trees between numpy arrays and torch tensors.

The JAX package's params and caches are nested dicts of arrays (stacked
``blocks`` with a leading ``n_periods`` axis); ``numpy.asarray`` of each
leaf gives the tree this module reads. The port keeps the same layout,
so conversion is leaf by leaf; optimizer and train states keep their
NamedTuple layout (``step``, ``m``, ``v``, ``master``; ``params``,
``opt``). bfloat16 travels through its bit pattern, since numpy has no
bfloat16 of its own (``ml_dtypes`` provides the numpy type on the way
back, where it is installed).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.int16, copy=False)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _port_type(node):
    """The port's NamedTuple of the same name as ``node``'s (the JAX
    ``AdamWState`` and ``TrainState`` map to the port's), else its own type."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim.adamw import AdamWState

    ported = {"AdamWState": AdamWState, "TrainState": TrainState}.get(type(node).__name__)
    return ported if ported is not None and ported._fields == node._fields else type(node)


def _map_tree(fn, tree, new_type):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _map_tree(fn, value, new_type) for key, value in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return new_type(tree)(*(_map_tree(fn, value, new_type) for value in tree))
    return fn(tree)


def to_torch(tree: Any, device="cpu") -> Any:
    """A nested dict of arrays (numpy, or anything ``np.asarray`` takes) → tensors.

    A JAX ``AdamWState`` or ``TrainState`` (with numpy leaves, e.g. from
    ``jax.tree.map(np.asarray, state)``) becomes the port's; ``None``
    (an absent ``master``) stays ``None``.
    """
    return _map_tree(lambda leaf: _leaf_to_torch(leaf, device), tree, _port_type)


def to_numpy(tree: Any) -> Any:
    """A nested dict (or NamedTuple) of tensors → numpy arrays (on the host)."""
    return _map_tree(_leaf_to_numpy, tree, type)
