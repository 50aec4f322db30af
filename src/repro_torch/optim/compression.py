"""Gradient compression (port of ``repro/optim/compression.py``).

* :func:`int8_roundtrip` — blockwise-scaled int8 quantise→dequantise of
  every gradient leaf (blocks of 2048 elements, absmax / 127 scales),
  which models sending int8 payloads through the data-parallel
  all-reduce.
* :class:`ErrorFeedback` — the compression error is added back to the
  next step's gradient (Stich et al.).

Functions on nested dicts of tensors; the arithmetic is the reference's,
element for element (``torch.round`` rounds half to even, as
``jnp.round`` does).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.lm import tree_map

_BLOCK = 2048


def _quant_leaf(g: torch.Tensor) -> torch.Tensor:
    flat = g.float().reshape(-1)
    n = flat.shape[0]
    pad = (-n) % _BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq.reshape(-1)[:n].reshape(g.shape).to(g.dtype)


def int8_roundtrip(grads: Any) -> Any:
    """Blockwise int8 quantise→dequantise every gradient leaf."""
    return tree_map(_quant_leaf, grads)


class ErrorFeedback(NamedTuple):
    residual: Any


def ef_init(params: Any) -> ErrorFeedback:
    return ErrorFeedback(
        residual=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    )


def ef_compress(grads: Any, state: ErrorFeedback) -> Tuple[Any, ErrorFeedback]:
    """int8 with error feedback: g' = Q(g + r); r ← (g + r) − g'."""
    corrected = tree_map(lambda g, r: g.float() + r, grads, state.residual)
    compressed = tree_map(_quant_leaf, corrected)
    residual = tree_map(lambda c, q: c - q, corrected, compressed)
    return compressed, ErrorFeedback(residual=residual)
