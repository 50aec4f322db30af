"""Seeded weights in the port's parameter layout, made on the device.

Every tensor comes from its own ``torch.Generator``, seeded from the run's
``--seed``, the leaf's path and its layer, so one layer can be made again
on its own: the harness makes the whole tree for the program, and the
reference makes each layer again when it reaches it. Each leaf is made in
the dtype the port's ``Model.cast_params`` gives it (the matmul weights
in the compute dtype, the rest in the param dtype), directly, with no
float32 transient of a bf16 leaf.

What belongs to one architecture comes from the configuration's module
(``servebench/reference/<name>.py``, named by the configuration file's
``"reference"``): ``period(cfg)``, the length of its repeating pattern of
layers; ``layer_leaves(cfg, position)``, the ``(path, shape, init,
scale)`` leaves of one position of that pattern; ``top_leaves(cfg)``,
the leaves outside the layer stack; and ``COMPUTE_LEAVES``, the leaf
names the port casts to the compute dtype. What stays here is generic:
the seeding, the dtypes, and the stacking of each position
``blocks.pos{i}`` over ``n_layers // period`` periods, as
``repro_torch.models.lm`` lays it out.

This module imports nothing of the program; a CPU test holds each
module's layout to the port's own ``init_params`` + ``cast_params``.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterator, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str, float]   # (path, shape, init, scale)


def head_dim(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def leaf_dtype(module, cfg: Dict, path: str) -> torch.dtype:
    name = path.rsplit(".", 1)[-1]
    return getattr(torch, cfg["compute_dtype"] if name in module.COMPUTE_LEAVES
                   else cfg["param_dtype"])


def leaf_seed(seed: int, path: str, layer: int) -> int:
    """A 63-bit generator seed from (run seed, leaf path, layer)."""
    digest = hashlib.sha256(f"{int(seed)}/{path}/{layer}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def fill(out: torch.Tensor, seed: int, path: str, layer: int, init: str, scale: float) -> None:
    """Write leaf ``path`` of ``layer`` (-1 outside the stack) into ``out``, in place."""
    if init == "ones":
        out.fill_(1.0)
    elif init == "zeros":
        out.zero_()
    else:
        gen = torch.Generator(device=out.device).manual_seed(leaf_seed(seed, path, layer))
        out.normal_(0.0, 1.0, generator=gen)
        out.mul_(scale)


def make_leaf(module, cfg: Dict, seed: int, path: str, layer: int, shape, init: str,
              scale: float, device) -> torch.Tensor:
    out = torch.empty(shape, dtype=leaf_dtype(module, cfg, path), device=device)
    fill(out, seed, path, layer, init, scale)
    return out


def _set(tree: Dict, path: str, value) -> None:
    *parents, last = path.split(".")
    for key in parents:
        tree = tree.setdefault(key, {})
    tree[last] = value


def make_params(module, cfg: Dict, seed: int, device) -> Dict:
    """The whole parameter tree in the port's layout: each period position
    ``blocks.pos{i}`` stacked over the periods, the leaf of period ``p``
    made as layer ``p · period + i`` and written in place into the stack."""
    params: Dict = {}
    for path, shape, init, scale in module.top_leaves(cfg):
        _set(params, path, make_leaf(module, cfg, seed, path, -1, shape, init, scale, device))
    period = module.period(cfg)
    if cfg["n_layers"] % period:
        raise ValueError(f"n_layers={cfg['n_layers']} is not a whole number of periods "
                         f"of {period}")
    n = cfg["n_layers"] // period
    for i in range(period):
        for path, shape, init, scale in module.layer_leaves(cfg, i):
            stack = torch.empty((n,) + shape, dtype=leaf_dtype(module, cfg, path),
                                device=device)
            for p in range(n):
                fill(stack[p], seed, path, p * period + i, init, scale)
            _set(params, f"blocks.pos{i}." + path, stack)
    return params


def layer_float32(module, cfg: Dict, seed: int, layer: int,
                  device) -> Dict[str, torch.Tensor]:
    """Layer ``layer``'s leaves (those of its period position) made again,
    as float32: {path: tensor}."""
    leaves = module.layer_leaves(cfg, layer % module.period(cfg))
    return {path: make_leaf(module, cfg, seed, path, layer, shape, init, scale, device).float()
            for path, shape, init, scale in leaves}


def top_float32(module, cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return {path: make_leaf(module, cfg, seed, path, -1, shape, init, scale, device).float()
            for path, shape, init, scale in module.top_leaves(cfg)}


def iter_leaves(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from iter_leaves(value, path + ".")
        else:
            yield path, value
