"""Decoder-only language model, ``lm`` family with dense and MoE FFNs
(port of ``repro/models/lm.py``).

The layer stack is ``n_periods`` repetitions of the config's period
pattern. As in the JAX package, the parameters and caches of each
period position are stacked along a leading ``n_periods`` axis; the
stack is walked by a Python loop where JAX uses ``lax.scan``. Caches
are updated in place.

Mamba mixers are not ported yet (ROADMAP Queue A item 2); a config that
needs them raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def check_supported(cfg: ModelConfig) -> None:
    for mixer, _ffn in cfg.layer_pattern():
        if mixer != "attn":
            raise NotImplementedError(
                f"{cfg.name}: mamba mixers are not ported yet "
                "(ROADMAP Queue A item 2: ssd_scan with models/layers/ssm.py)"
            )


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from tree_leaves(value)
    else:
        yield tree


def _period(tree: Dict, p: int) -> Dict:
    """Views of period ``p`` of a stacked tree (writes reach the stack)."""
    return tree_map(lambda leaf: leaf[p], tree)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_period(cfg: ModelConfig, generator: torch.Generator, *, device=None) -> Dict:
    """Parameters for one period (pattern of layers)."""
    params: Dict = {}
    for i, (_mixer, ffn) in enumerate(cfg.layer_pattern()):
        sub: Dict = {
            "mixer_norm": basic.init_norm(cfg, device=device),
            "attn": init_attention(cfg, generator, device=device),
        }
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


def init_params(cfg: ModelConfig, generator: torch.Generator, *, device=None) -> Dict:
    """Random parameters, the periods drawn in order from ``generator``.

    Each stacked leaf is allocated once and filled period by period, so
    besides the stack only one period's draw is alive at a time.
    """
    check_supported(cfg)
    params: Dict = {"embed": basic.init_embedding(cfg, generator, device=device)}
    blocks = None
    for p in range(cfg.n_periods):
        period = init_period(cfg, generator, device=device)
        if blocks is None:
            blocks = tree_map(
                lambda leaf: torch.empty((cfg.n_periods,) + tuple(leaf.shape),
                                         dtype=leaf.dtype, device=leaf.device),
                period,
            )
        _fill(blocks, period, p)
        del period
    params["blocks"] = blocks
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
        return x + h, aux
    return x + basic.apply_ffn(cfg, sub["ffn"], h), None


def _head(cfg: ModelConfig, params: Dict) -> Dict:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def _embed(cfg: ModelConfig, params: Dict, tokens, embeds) -> torch.Tensor:
    if embeds is None:
        return basic.embed(cfg, params["embed"], tokens)
    return embeds.to(basic._dtype(cfg.compute_dtype))


def _positions(x: torch.Tensor) -> torch.Tensor:
    bsz, s = x.shape[0], x.shape[1]
    return torch.arange(s, device=x.device)[None, :].expand(bsz, s)


def forward(
    cfg: ModelConfig,
    params: Dict,
    tokens: torch.Tensor,
    *,
    embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward pass. Returns (logits [B,S,V] float32, aux loss)."""
    check_supported(cfg)
    x = _embed(cfg, params, tokens, embeds)
    positions = _positions(x)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in range(cfg.n_periods):
        period_params = _period(params["blocks"], p)
        for i, (_mixer, ffn) in enumerate(cfg.layer_pattern()):
            sub = period_params[f"pos{i}"]
            h = basic.apply_norm(cfg, sub["mixer_norm"], x)
            x, aux = _ffn(cfg, ffn, sub, x + attend_full(cfg, sub["attn"], h, positions))
            if aux is not None:
                aux_total = aux_total + aux
    x = basic.apply_norm(cfg, params["final_norm"], x)
    logits = basic.unembed(cfg, _head(cfg, params), x)
    return logits, aux_total


# ---------------------------------------------------------------------------
# Serving: prefill + decode with caches
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, *, device=None
) -> Dict:
    """Stacked per-period cache matching params["blocks"]."""
    check_supported(cfg)
    cache: Dict = {}
    for i in range(len(cfg.layer_pattern())):
        k, v = init_kv_cache(cfg, batch, max_len, dtype, device=device)
        cache[f"pos{i}"] = {"k": k, "v": v}
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
    """Process a full prompt, writing its K/V into the cache prefix in place.

    Returns (logits of the last position [B,1,V], cache). Q/K/V are
    projected once per layer and shared by the cache write and the
    attention (the JAX version projects twice; the numbers are the same).
    """
    check_supported(cfg)
    x = _embed(cfg, params, tokens, embeds)
    s = x.shape[1]
    positions = _positions(x)
    for p in range(cfg.n_periods):
        period_params = _period(params["blocks"], p)
        period_cache = _period(cache, p)
        for i, (_mixer, ffn) in enumerate(cfg.layer_pattern()):
            sub = period_params[f"pos{i}"]
            c = period_cache[f"pos{i}"]
            h = basic.apply_norm(cfg, sub["mixer_norm"], x)
            q, k, v = _project_qkv(cfg, sub["attn"], h, positions=positions)
            write_kv_prefix(cfg, c["k"], k, s)
            write_kv_prefix(cfg, c["v"], v, s)
            h = attend_projected(cfg, sub["attn"], q, k, v, causal=True)
            x, _ = _ffn(cfg, ffn, sub, x + h)
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
    check_supported(cfg)
    x = basic.embed(cfg, params["embed"], token[:, None])
    position = position.long()
    for p in range(cfg.n_periods):
        period_params = _period(params["blocks"], p)
        period_cache = _period(cache, p)
        for i, (_mixer, ffn) in enumerate(cfg.layer_pattern()):
            sub = period_params[f"pos{i}"]
            c = period_cache[f"pos{i}"]
            h = basic.apply_norm(cfg, sub["mixer_norm"], x)
            h, _, _ = attend_cached(cfg, sub["attn"], h, c["k"], c["v"], position)
            x, _ = _ffn(cfg, ffn, sub, x + h)
    x = basic.apply_norm(cfg, params["final_norm"], x)
    logits = basic.unembed(cfg, _head(cfg, params), x)
    return logits, cache
