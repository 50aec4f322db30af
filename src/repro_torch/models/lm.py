"""Decoder-only language model covering the lm / hybrid / ssm families
(port of ``repro/models/lm.py``).

The layer stack is ``n_periods`` repetitions of the config's period
pattern: attention or Mamba-2 mixers, with dense, MoE or no FFNs. As in
the JAX package, the parameters and caches of each period position are
stacked along a leading ``n_periods`` axis; the stack is walked by a
Python loop where JAX uses ``lax.scan``. The training forward takes each
stacked param's periods once per call (:func:`unstack`), so the backward
stacks their gradients once, as the transpose of ``scan`` does; serving
indexes one period at a time (:func:`_period`) and updates the caches in
place. Where autograd records, each period runs under the config's
``remat`` policy (:func:`remat_wrap`). granite-4.0-h's scalars (the
embedding, residual, attention and logit multipliers), its NoPE
attention and its shared expert are config fields that add no operation
at their defaults.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import basic
from repro_torch.models.layers.attention import (
    _project_qkv,
    attend_cached,
    attend_full,
    attend_projected,
    init_attention,
    init_kv_cache,
    write_kv_prefix,
)
from repro_torch.models.layers.moe import apply_moe, init_moe
from repro_torch.models.layers.ssm import (
    _mixer_input,
    _mixer_output,
    apply_mamba,
    apply_mamba_step,
    init_mamba,
    init_mamba_cache,
    ssd_chunked,
)
from repro_torch.sharding.ctx import constrain, gather_sequence

AUX_LOSS_WEIGHT = 0.01


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every leaf of a nested dict (and the leaves at the
    same keys of ``rest``, which may hold a subtree where ``tree`` holds a leaf)."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, value, *(r[key] for r in rest))
                for key, value in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of a nested dict (or tuple/list), in insertion order."""
    if isinstance(tree, dict):
        for value in tree.values():
            yield from tree_leaves(value)
    elif isinstance(tree, (tuple, list)):
        for value in tree:
            yield from tree_leaves(value)
    elif tree is not None:
        yield tree


def _period(tree: Dict, p: int) -> Dict:
    """Views of period ``p`` of a stacked tree (writes reach the stack)."""
    return tree_map(lambda leaf: leaf[p], tree)


def unstack(tree: Dict, n: int) -> Iterator[Dict]:
    """The ``n`` periods of a stacked tree, in order, as views of it.

    Each leaf is unbound along its leading axis once, so autograd stacks
    the periods' gradients once into the leaf's gradient. Indexing one
    period at a time (:func:`_period`) would give each period's gradient
    the whole stack's size, zeros but for its slice, added into the
    leaf's gradient ``n`` times. A DTensor leaf is unbound on its local
    shard (:func:`_unbind_local`).
    """
    parts = tree_map(_unbind, tree)
    for p in range(n):
        yield tree_map(lambda period_of: period_of(p), parts)


def _unbind(leaf: torch.Tensor) -> Callable[[int], torch.Tensor]:
    from torch.distributed.tensor import DTensor

    if isinstance(leaf, DTensor):
        return _unbind_local(leaf)
    return torch.unbind(leaf, 0).__getitem__


def _unbind_local(leaf) -> Callable[[int], torch.Tensor]:
    """``torch.unbind(leaf, 0)`` of a DTensor whose leading (stack) axis is
    not sharded, computed on the local shard: each period is a DTensor
    with the leaf's placements, one dim lower, and the leaf's gradient
    comes back with the leaf's placements, at its local size. DTensor's
    own rules for ``unbind`` and ``stack`` are not needed.

    Period ``p`` is wrapped as a DTensor only when it is asked for, just
    before its layers run. Autograd runs the nodes made later in the
    forward first, so a wrapper made then hands its period's gradient,
    resharded to the local shard, to the unbind as soon as the period's
    backward ends; wrappers all made before the first period would run
    after every period, each holding its gradient at the layout the
    layers' backward left it (a whole period's f32 weights under FSDP).
    """
    from torch.distributed.tensor import DTensor, Shard

    placements = tuple(leaf.placements)
    period = tuple(Shard(p.dim - 1) if p.is_shard() else p for p in placements)
    mesh = leaf.device_mesh
    views = torch.unbind(leaf.to_local(grad_placements=placements), 0)
    return lambda p: DTensor.from_local(views[p], mesh, period, run_check=False)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_period(cfg: ModelConfig, generator: torch.Generator, *, device=None) -> Dict:
    """Parameters for one period (pattern of layers)."""
    params: Dict = {}
    for i, (mixer, ffn) in enumerate(cfg.layer_pattern()):
        sub: Dict = {"mixer_norm": basic.init_norm(cfg, device=device)}
        if mixer == "attn":
            sub["attn"] = init_attention(cfg, generator, device=device)
        else:
            sub["mamba"] = init_mamba(cfg, generator, device=device)
        if ffn == "dense":
            sub["ffn_norm"] = basic.init_norm(cfg, device=device)
            sub["ffn"] = basic.init_ffn(cfg, generator, device=device)
        elif ffn == "moe":
            sub["ffn_norm"] = basic.init_norm(cfg, device=device)
            sub["moe"] = init_moe(cfg, generator, device=device)
        params[f"pos{i}"] = sub
    return params


def _fill(stack: Dict, tree: Dict, p: int) -> None:
    for key, value in tree.items():
        if isinstance(value, dict):
            _fill(stack[key], value, p)
        else:
            stack[key][p].copy_(value)


def stack_draws(n: int, draw) -> Dict:
    """``n`` calls of ``draw()`` (a nested dict of tensors) stacked along a
    leading axis. Each stacked leaf is allocated once and filled draw by
    draw, so besides the stack only one draw is alive at a time."""
    stack = None
    for i in range(n):
        tree = draw()
        if stack is None:
            stack = tree_map(
                lambda leaf: torch.empty((n,) + tuple(leaf.shape), dtype=leaf.dtype,
                                         device=leaf.device),
                tree,
            )
        _fill(stack, tree, i)
        del tree
    return stack


def init_params(cfg: ModelConfig, generator: torch.Generator, *, device=None) -> Dict:
    """Random parameters, the periods drawn in order from ``generator``."""
    params: Dict = {"embed": basic.init_embedding(cfg, generator, device=device)}
    params["blocks"] = stack_draws(
        cfg.n_periods, lambda: init_period(cfg, generator, device=device))
    params["final_norm"] = basic.init_norm(cfg, device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = basic.init_embedding(cfg, generator, device=device)
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _ffn(cfg: ModelConfig, ffn: str, sub: Dict, x: torch.Tensor):
    """The residual FFN block of one layer. Returns (x, aux loss or None)."""
    if ffn == "none":
        return x, None
    h = basic.apply_norm(cfg, sub["ffn_norm"], x)
    if ffn == "moe":
        h, aux = apply_moe(cfg, sub["moe"], h)
        return basic.residual(cfg, x, h), aux
    return basic.residual(cfg, x, basic.apply_ffn(cfg, sub["ffn"], h)), None


def _head(cfg: ModelConfig, params: Dict) -> Dict:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def _embed(cfg: ModelConfig, params: Dict, tokens, embeds) -> torch.Tensor:
    if embeds is None:
        return basic.embed(cfg, params["embed"], tokens)
    return embeds.to(basic._dtype(cfg.compute_dtype))


def _positions(x: torch.Tensor) -> torch.Tensor:
    bsz, s = x.shape[0], x.shape[1]
    return torch.arange(s, device=x.device)[None, :].expand(bsz, s)


def _apply_period(
    cfg: ModelConfig,
    period_params: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One period of layers. Returns (x, aux loss)."""
    x = gather_sequence(x)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (mixer, ffn) in enumerate(cfg.layer_pattern()):
        sub = period_params[f"pos{i}"]
        h = basic.apply_norm(cfg, sub["mixer_norm"], x)
        if mixer == "attn":
            h = attend_full(cfg, sub["attn"], h, positions)
        else:
            h = apply_mamba(cfg, sub["mamba"], h)
        x, aux = _ffn(cfg, ffn, sub, basic.residual(cfg, x, h))
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


#: The matmuls whose outputs ``remat="dots"`` keeps (JAX's ``checkpoint_dots``).
_DOT_OPS = (
    torch.ops.aten.mm.default,
    torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default,
)


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(list(_DOT_OPS))


def remat_wrap(cfg: ModelConfig, fn):
    """Counterpart of the JAX ``_remat_wrap``: ``fn`` recomputed in the backward.

    ``"full"`` keeps only ``fn``'s inputs (``torch.utils.checkpoint``),
    ``"dots"`` keeps its matmul outputs too and recomputes the rest
    (selective checkpointing), ``"none"`` returns ``fn``. The wrapper
    checkpoints only where autograd records the call, so serving and
    ``torch.no_grad`` scoring run ``fn`` as it is.
    """
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("dots", "full"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    from torch.utils.checkpoint import checkpoint

    extra = {"context_fn": _dots_context} if cfg.remat == "dots" else {}

    def wrapped(*args):
        if not (torch.is_grad_enabled()
                and any(t.requires_grad for t in tree_leaves(list(args)))):
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **extra)

    return wrapped


def forward(
    cfg: ModelConfig,
    params: Dict,
    tokens: torch.Tensor,
    *,
    embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward pass. Returns (logits [B,S,V] float32, aux loss).

    Each period runs under the config's ``remat`` policy (:func:`remat_wrap`).
    """
    x = _embed(cfg, params, tokens, embeds)
    positions = _positions(x)
    period_fn = remat_wrap(cfg, functools.partial(_apply_period, cfg))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for period_params in unstack(params["blocks"], cfg.n_periods):
        # Sequence parallelism on the residual stream between periods: the
        # carry shards S over the TP axis (see sharding/ctx.py).
        x = constrain(x, ("dp", "tp", None))
        x, aux = period_fn(period_params, x, positions)
        x = constrain(x, ("dp", "tp", None))
        aux_total = aux_total + aux
    x = basic.apply_norm(cfg, params["final_norm"], gather_sequence(x))
    logits = basic.unembed(cfg, _head(cfg, params), x)
    logits = constrain(logits, ("dp", None, "vocab"))  # vocab-parallel CE
    return logits, aux_total


def loss_fn(
    cfg: ModelConfig,
    params: Dict,
    batch: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (+ MoE aux). batch: {"tokens": [B,S], "mask"?: [B,S]}."""
    tokens = batch["tokens"]
    logits, aux = forward(cfg, params, tokens, embeds=batch.get("embeds"))
    nll = basic.next_token_nll(logits, tokens)
    del logits
    mask = batch.get("mask")
    if mask is not None:
        mask = mask[:, 1:].float()
        ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        ce = torch.mean(nll)
    total = ce + AUX_LOSS_WEIGHT * aux
    return total, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode with caches
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, *, device=None
) -> Dict:
    """Stacked per-period cache matching params["blocks"].

    KV caches (in ``dtype``) for attention positions; for Mamba positions
    the conv window and SSM state, float32 whatever ``dtype`` says, as in
    the JAX package.
    """
    cache: Dict = {}
    for i, (mixer, _ffn) in enumerate(cfg.layer_pattern()):
        if mixer == "attn":
            k, v = init_kv_cache(cfg, batch, max_len, dtype, device=device)
            cache[f"pos{i}"] = {"k": k, "v": v}
        else:
            cache[f"pos{i}"] = init_mamba_cache(cfg, batch, device=device)
    return tree_map(
        lambda leaf: leaf.unsqueeze(0).repeat((cfg.n_periods,) + (1,) * leaf.dim()),
        cache,
    )


def prefill(
    cfg: ModelConfig,
    params: Dict,
    tokens: torch.Tensor,
    cache: Dict,
    *,
    embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Process a full prompt, writing the cache in place.

    Attention layers write the prompt's K/V into the cache prefix; Mamba
    layers write their conv window and final SSM state
    (:func:`apply_mamba_with_state`). Returns (logits of the last
    position [B,1,V], cache). Q/K/V are projected once per layer and
    shared by the cache write and the attention (the JAX version projects
    twice; the numbers are the same).
    """
    x = _embed(cfg, params, tokens, embeds)
    s = x.shape[1]
    positions = _positions(x)
    for p in range(cfg.n_periods):
        period_params = _period(params["blocks"], p)
        period_cache = _period(cache, p)
        for i, (mixer, ffn) in enumerate(cfg.layer_pattern()):
            sub = period_params[f"pos{i}"]
            c = period_cache[f"pos{i}"]
            h = basic.apply_norm(cfg, sub["mixer_norm"], x)
            if mixer == "attn":
                q, k, v = _project_qkv(cfg, sub["attn"], h, positions=positions)
                write_kv_prefix(cfg, c["k"], k, s)
                write_kv_prefix(cfg, c["v"], v, s)
                h = attend_projected(cfg, sub["attn"], q, k, v, causal=True)
            else:
                h, _ = apply_mamba_with_state(cfg, sub["mamba"], h, c)
            x, _ = _ffn(cfg, ffn, sub, basic.residual(cfg, x, h))
    x = basic.apply_norm(cfg, params["final_norm"], x)
    logits = basic.unembed(cfg, _head(cfg, params), x[:, -1:, :])
    return logits, cache


def decode_step(
    cfg: ModelConfig,
    params: Dict,
    cache: Dict,
    token: torch.Tensor,       # [B] — the most recent token
    position: torch.Tensor,    # [B] — its cache slot
) -> Tuple[torch.Tensor, Dict]:
    """One incremental decode step. Returns (logits [B,1,V], cache updated in place)."""
    x = basic.embed(cfg, params["embed"], token[:, None])
    position = position.long()
    for p in range(cfg.n_periods):
        period_params = _period(params["blocks"], p)
        period_cache = _period(cache, p)
        for i, (mixer, ffn) in enumerate(cfg.layer_pattern()):
            sub = period_params[f"pos{i}"]
            c = period_cache[f"pos{i}"]
            h = basic.apply_norm(cfg, sub["mixer_norm"], x)
            if mixer == "attn":
                h, _, _ = attend_cached(cfg, sub["attn"], h, c["k"], c["v"], position)
            else:
                h, _ = apply_mamba_step(cfg, sub["mamba"], h, c)
            x, _ = _ffn(cfg, ffn, sub, basic.residual(cfg, x, h))
    x = basic.apply_norm(cfg, params["final_norm"], x)
    logits = basic.unembed(cfg, _head(cfg, params), x)
    return logits, cache


def apply_mamba_with_state(cfg: ModelConfig, params: Dict, x: torch.Tensor, cache: Dict):
    """Like ``apply_mamba``, and fills the decode cache in place (prefill).

    As ``repro/models/lm.py::apply_mamba_with_state``, the scan is the
    plain ``ssd_chunked`` whatever ``use_kernels`` says: the kernel returns
    no final state. The last ``W - 1`` raw conv inputs (float32) and the
    final SSM state are written into ``cache["conv"]`` and ``cache["ssm"]``,
    which may be views of one slot of a replica's cache. Returns
    (out [B,S,D], cache).
    """
    z, xbc_raw, xs, b_mat, c_mat, dt, a = _mixer_input(cfg, params, x)
    y, final_state = ssd_chunked(xs, dt, a, b_mat, c_mat, cfg.ssm_chunk)
    out = _mixer_output(cfg, params, y, xs, z)
    window = xbc_raw[:, -(cfg.ssm_conv - 1):, :].float()
    conv = cache["conv"]
    if window.shape[1] < conv.shape[1]:
        # A prompt shorter than the window (the JAX version fails there):
        # the rows before it stay zero, as the causal conv's padding.
        conv.zero_()
    conv[:, conv.shape[1] - window.shape[1]:].copy_(window)
    cache["ssm"].copy_(final_state)
    return out, cache
