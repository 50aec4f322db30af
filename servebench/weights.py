"""Seeded weights in the port's parameter layout, made on the device.

Every tensor comes from its own ``torch.Generator``, seeded from the run's
``--seed``, the leaf's path and its layer, so one layer can be made again
on its own: the harness makes the whole tree for the program, and the
reference makes each layer again when it reaches it. Each leaf is made in
the dtype the port's ``Model.cast_params`` gives it (the matmul weights
in the compute dtype, norms, embeddings and the MoE router in the param
dtype), directly, with no float32 transient of a bf16 leaf.

This module imports nothing of the program. The layout it writes (leaf
names, shapes, stacking over layers) is the one ``repro_torch.models.lm``
takes for the ``lm`` family with attention mixers and dense or MoE FFNs;
a CPU test holds it to the port's own ``init_params`` + ``cast_params``.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, List, Tuple

import torch

#: Leaves that the port casts to the compute dtype (``COMPUTE_LEAVES`` of
#: ``repro_torch.models.api``, for the layers this benchmark serves).
COMPUTE_LEAVES = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"})

Leaf = Tuple[str, Tuple[int, ...], str, float]   # (path, shape, init, scale)


def head_dim(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def layer_leaves(cfg: Dict) -> List[Leaf]:
    """The leaves of one layer: (path under ``blocks.pos0``, shape, init, scale)."""
    if cfg["family"] != "lm" or cfg.get("qkv_bias") or cfg.get("qk_norm"):
        raise ValueError("servebench makes weights for lm-family attention models without "
                         "qkv bias or qk-norm")
    d, f, h, kv = cfg["d_model"], cfg["d_ff"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = head_dim(cfg)
    out: List[Leaf] = [("mixer_norm.scale", (d,), "ones", 1.0)]
    if cfg["norm_kind"] == "layernorm":
        out.append(("mixer_norm.bias", (d,), "zeros", 1.0))
    out += [
        ("attn.wq", (d, h * hd), "normal", 1 / math.sqrt(d)),
        ("attn.wk", (d, kv * hd), "normal", 1 / math.sqrt(d)),
        ("attn.wv", (d, kv * hd), "normal", 1 / math.sqrt(d)),
        ("attn.wo", (h * hd, d), "normal", 1 / math.sqrt(h * hd)),
        ("ffn_norm.scale", (d,), "ones", 1.0),
    ]
    if cfg["norm_kind"] == "layernorm":
        out.append(("ffn_norm.bias", (d,), "zeros", 1.0))
    if cfg["mlp_kind"] != "swiglu":
        raise ValueError("servebench makes weights for swiglu FFNs")
    e = cfg.get("moe_experts", 0)
    if e:
        if cfg.get("moe_every", 1) != 1:
            raise ValueError("servebench makes weights for MoE in every layer")
        out += [
            ("moe.router", (d, e), "normal", 1 / math.sqrt(d)),
            ("moe.w_gate", (e, d, f), "normal", 1 / math.sqrt(d)),
            ("moe.w_up", (e, d, f), "normal", 1 / math.sqrt(d)),
            ("moe.w_down", (e, f, d), "normal", 1 / math.sqrt(f)),
        ]
    else:
        out += [
            ("ffn.w_gate", (d, f), "normal", 1 / math.sqrt(d)),
            ("ffn.w_up", (d, f), "normal", 1 / math.sqrt(d)),
            ("ffn.w_down", (f, d), "normal", 1 / math.sqrt(f)),
        ]
    return out


def top_leaves(cfg: Dict) -> List[Leaf]:
    """The leaves outside the layer stack."""
    v, d = cfg["vocab_size"], cfg["d_model"]
    out: List[Leaf] = [("embed.table", (v, d), "normal", 1 / math.sqrt(d)),
                       ("final_norm.scale", (d,), "ones", 1.0)]
    if cfg["norm_kind"] == "layernorm":
        out.append(("final_norm.bias", (d,), "zeros", 1.0))
    if not cfg.get("tie_embeddings"):
        out.append(("lm_head.table", (v, d), "normal", 1 / math.sqrt(d)))
    return out


def leaf_dtype(cfg: Dict, path: str) -> torch.dtype:
    name = path.rsplit(".", 1)[-1]
    return getattr(torch, cfg["compute_dtype"] if name in COMPUTE_LEAVES else cfg["param_dtype"])


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


def make_leaf(cfg: Dict, seed: int, path: str, layer: int, shape, init: str, scale: float,
              device) -> torch.Tensor:
    out = torch.empty(shape, dtype=leaf_dtype(cfg, path), device=device)
    fill(out, seed, path, layer, init, scale)
    return out


def _set(tree: Dict, path: str, value) -> None:
    *parents, last = path.split(".")
    for key in parents:
        tree = tree.setdefault(key, {})
    tree[last] = value


def make_params(cfg: Dict, seed: int, device) -> Dict:
    """The whole parameter tree in the port's layout (``blocks.pos0`` stacked
    over ``n_layers``), each layer's leaves written in place into the stack."""
    params: Dict = {}
    for path, shape, init, scale in top_leaves(cfg):
        _set(params, path, make_leaf(cfg, seed, path, -1, shape, init, scale, device))
    n = cfg["n_layers"]
    for path, shape, init, scale in layer_leaves(cfg):
        stack = torch.empty((n,) + shape, dtype=leaf_dtype(cfg, path), device=device)
        for p in range(n):
            fill(stack[p], seed, path, p, init, scale)
        _set(params, "blocks.pos0." + path, stack)
    return params


def layer_float32(cfg: Dict, seed: int, layer: int, device) -> Dict[str, torch.Tensor]:
    """Layer ``layer``'s leaves made again, as float32: {path: tensor}."""
    return {path: make_leaf(cfg, seed, path, layer, shape, init, scale, device).float()
            for path, shape, init, scale in layer_leaves(cfg)}


def top_float32(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return {path: make_leaf(cfg, seed, path, -1, shape, init, scale, device).float()
            for path, shape, init, scale in top_leaves(cfg)}


def iter_leaves(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from iter_leaves(value, path + ".")
        else:
            yield path, value
