"""Convert parameter and cache trees between numpy arrays and torch tensors.

The JAX package's params and caches are nested dicts of arrays (stacked
``blocks`` with a leading ``n_periods`` axis); ``numpy.asarray`` of each
leaf gives the tree this module reads. The port keeps the same layout,
so conversion is leaf by leaf. bfloat16 travels through its bit pattern,
since numpy has no bfloat16 of its own (``ml_dtypes`` provides the numpy
type on the way back, where it is installed).
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


def to_torch(tree: Any, device="cpu") -> Any:
    """A nested dict of arrays (numpy, or anything ``np.asarray`` takes) → tensors."""
    if isinstance(tree, dict):
        return {key: to_torch(value, device) for key, value in tree.items()}
    return _leaf_to_torch(tree, device)


def to_numpy(tree: Any) -> Any:
    """A nested dict of tensors → numpy arrays (on the host)."""
    if isinstance(tree, dict):
        return {key: to_numpy(value) for key, value in tree.items()}
    return _leaf_to_numpy(tree)
