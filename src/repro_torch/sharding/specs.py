"""Sharding policy: partition specs for params, optimizer state, batches
and caches (port of ``repro/sharding/specs.py``, rule for rule).

A spec is a :class:`PartitionSpec`: a tuple with one entry per tensor
dim, each entry ``None``, a mesh axis name or a tuple of axis names, as
JAX's. The rules are name- and shape-based with divisibility
sanitisation: an entry that does not evenly divide its dim is dropped.

Default placement:
  * 2-D weights [d_in, d_out]: column-parallel on the TP axis for
    up-projections, row-parallel for down/out-projections; FSDP shards
    the *other* dim over the data axes for large models.
  * MoE expert stacks [E, ...]: expert-parallel on the TP axis when E
    divides it, otherwise tensor-parallel within experts.
  * Embeddings [V, d]: vocab-parallel (falls back to d).
  * Batches: [B, ...] over (pod, data); KV caches shard T on the TP axis
    for decode (B already covers the data axes), SSM states shard heads.

DTensor places a tensor per *mesh* dim, where a spec names mesh axes per
*tensor* dim: :func:`placements` turns one into the other, and
:class:`NamedSharding` pairs a spec with its mesh, as JAX's does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.config import ModelConfig


class PartitionSpec(tuple):
    """``P("data", None, ("pod", "data"))``: one entry per tensor dim. As in
    JAX, a one-axis tuple entry is stored as the axis name and an empty
    one as None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if len(e) == 0 else e[0] if len(e) == 1 else tuple(e)
            return e

        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self):
        return placements(self.spec, self.mesh)


def placements(spec: PartitionSpec, mesh) -> Tuple:
    """DTensor placements (one per mesh dim) of ``spec`` on ``mesh``.

    A tensor dim over several axes is ``Shard(d)`` on each of their mesh
    dims; DTensor splits mesh dims left to right, which is JAX's
    major-to-minor order when the axes are listed in mesh order (the only
    order the policy produces). A mesh dim no entry names, or one of size
    1, is ``Replicate()``: on one rank the two are the same layout, and a
    size-1 shard would only add copies.
    """
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of {spec} are not in mesh order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def distribute(tensor: torch.Tensor, sharding: NamedSharding):
    """Place a full tensor on ``sharding``'s mesh (each rank keeps its shard)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(tensor, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def reshard(tree: Any, shardings: Any) -> Any:
    """Redistribute each DTensor leaf of ``tree`` onto its sharding in
    ``shardings`` (the out-shardings of a jitted JAX step); a leaf already
    there is returned as it is."""
    from torch.distributed.tensor import DTensor

    def visit(x, s):
        if isinstance(x, dict):
            return {k: visit(x[k], s[k]) for k in x}
        if isinstance(x, tuple):  # TrainState, AdamWState
            items = [visit(a, b) for a, b in zip(x, s)]
            return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
        if x is None or s is None or not isinstance(x, DTensor):
            return x
        target = s.placements
        if tuple(x.placements) == target:
            return x
        return x.redistribute(s.mesh, target)

    return visit(tree, shardings)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    tp_axis: Optional[str] = "model"
    dp_axes: Tuple[str, ...] = ("data",)          # + "pod" on the multipod mesh
    fsdp: bool = True                              # shard params over dp axes too
    fsdp_min_params: int = 2_000_000_000           # only FSDP models above this
    expert_parallel: bool = True                   # EP over tp_axis when divisible
    shard_kv_seq: bool = True                      # decode KV cache: T over TP axis
    # tp_enabled=False → pure DP/FSDP: the "model" axis joins the data axes.
    tp_enabled: bool = True
    # tp_scope="vocab" keeps the model axis out of the layer matmuls (they
    # run data-parallel) but still vocab-shards the embedding table and the
    # CE logits.
    tp_scope: str = "full"            # full | vocab

    def for_mesh(self, mesh) -> "ShardingPolicy":
        dp = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
        if not self.tp_enabled:
            dp = dp + ("model",)
            return dataclasses.replace(self, dp_axes=dp, tp_axis=None)
        return dataclasses.replace(self, dp_axes=dp)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    size = 1
    for a in axes:
        size *= sizes[a]
    return size


def sanitize_spec(spec: PartitionSpec, shape: Tuple[int, ...], mesh) -> PartitionSpec:
    """Drop spec entries that do not divide their dimension evenly."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axes in zip(shape, entries):
        if axes is None:
            out.append(None)
        elif dim % _axis_size(mesh, axes) == 0:
            out.append(axes)
        else:
            out.append(None)
    return P(*out)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

_COLUMN_PARALLEL = (  # [d_model, X] → shard X on TP
    "wq", "wk", "wv", "bq", "bk", "bv", "w_gate", "w_up",
    "in_proj_z", "in_proj_xbc", "in_proj_dt",
)
_ROW_PARALLEL = ("wo", "w_down", "out_proj")  # [X, d_model] → shard X on TP


def param_spec(
    cfg: ModelConfig,
    policy: ShardingPolicy,
    mesh,
    path: Tuple[str, ...],
    shape: Tuple[int, ...],
) -> PartitionSpec:
    names = list(path)
    leaf = names[-1]
    fsdp_on = policy.fsdp and cfg.param_count() >= policy.fsdp_min_params
    fsdp: Optional[Tuple[str, ...]] = policy.dp_axes if fsdp_on else None
    tp = policy.tp_axis
    if policy.tp_scope == "vocab" and leaf not in ("table",):
        # Layer weights run data-parallel; FSDP may use the idle model axis.
        tp = None
        if fsdp is not None:
            fsdp = fsdp + ((policy.tp_axis,) if policy.tp_axis else ())

    # Stacked layer dims (periods / encoder / decoder stacks).
    stacked = any(n in ("blocks", "encoder", "decoder") for n in names[:-1])
    lead: Tuple = (None,) if stacked else ()

    def make(*entries) -> PartitionSpec:
        return sanitize_spec(P(*lead, *entries), shape, mesh)

    ndim = len(shape) - len(lead)

    if leaf == "table":  # embedding / lm_head [V, d]
        return make(tp, fsdp)
    if leaf in ("enc_pos", "dec_pos"):
        return make(None, tp)
    if ndim <= 1:
        # Norm scales, biases (except qkv bias handled below), scalars.
        if leaf in ("bq", "bk", "bv"):
            return make(tp)
        return make(None)
    if leaf == "router":
        return make(fsdp, None)
    if ndim == 3:  # MoE expert stacks [E, in, out]
        # Never shard the contracting (middle) dim: FSDP shards the output dim.
        e = shape[len(lead)]
        if policy.expert_parallel and tp is not None and e % _axis_size(mesh, tp) == 0:
            # Megatron pairing within each expert over the fsdp axis.
            if leaf == "w_down":
                return make(tp, fsdp, None)
            return make(tp, None, fsdp)
        # Non-EP fallback (expert count not TP-divisible): Megatron within
        # experts over TP.
        if leaf in ("w_gate", "w_up"):
            return make(None, fsdp, tp)
        return make(None, tp, fsdp)
    if leaf in _COLUMN_PARALLEL:
        return make(fsdp, tp)
    if leaf in _ROW_PARALLEL:
        return make(tp, fsdp)
    if leaf == "conv_w":  # [W, conv_dim]
        return make(None, tp)
    # Fallback: replicate.
    return make(*([None] * ndim))


def tree_map_with_path(fn, tree, path=()):
    """``fn(path of names, leaf)`` over a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(cfg: ModelConfig, policy: ShardingPolicy, mesh, params_shapes: Any) -> Any:
    """Tree of :class:`NamedSharding` matching a params (shape) tree."""

    def visit(names, leaf):
        return NamedSharding(mesh, param_spec(cfg, policy, mesh, names, tuple(leaf.shape)))

    return tree_map_with_path(visit, params_shapes)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def batch_shardings(
    cfg: ModelConfig,
    policy: ShardingPolicy,
    mesh,
    shape_spec,
    batch_shapes: Dict[str, Any],
) -> Dict[str, NamedSharding]:
    dp = policy.dp_axes
    out: Dict[str, NamedSharding] = {}
    for name, sds in batch_shapes.items():
        if name in ("tokens", "mask"):
            spec = P(dp, None)
        elif name == "frames":       # [B, S, d]
            spec = P(dp, None, policy.tp_axis)
        elif name == "embeds":
            spec = P(dp, None, policy.tp_axis)
        elif name in ("token", "position"):  # decode step [B]
            spec = P(dp)
        else:
            spec = P()
        out[name] = NamedSharding(mesh, sanitize_spec(spec, tuple(sds.shape), mesh))
    return out


def cache_shardings(cfg: ModelConfig, policy: ShardingPolicy, mesh, cache_shapes: Any) -> Any:
    """KV caches: [L, B, T, KV, Dh] — B over dp, T over TP (sequence
    sharding for decode). SSM states: [L, B, H, P, N] — H over TP. Conv
    caches: channel over TP."""
    dp = policy.dp_axes
    tp = policy.tp_axis

    def visit(names, leaf):
        leafname = names[-1]
        shape = tuple(leaf.shape)
        kv_names = ("k", "v", "self_k", "self_v", "cross_k", "cross_v")
        if leafname in ("q", "scale") and len(names) >= 2 and names[-2] in kv_names:
            # int8 KV cache: q mirrors the KV layout; scale drops head_dim.
            seq = tp if policy.shard_kv_seq else None
            spec = P(None, dp, seq, None, None)
        elif leafname in kv_names:
            seq = tp if policy.shard_kv_seq else None
            spec = P(None, dp, seq, None, None)
        elif leafname == "ssm":      # [L, B, H, P, N]
            spec = P(None, dp, tp, None, None)
        elif leafname == "conv":     # [L, B, W-1, C]
            spec = P(None, dp, None, tp)
        else:
            spec = P(*([None] * len(shape)))
        return NamedSharding(mesh, sanitize_spec(spec, shape, mesh))

    return tree_map_with_path(visit, cache_shapes)
