"""Encoder-decoder transformer, the Whisper-small backbone (port of
``repro/models/encdec.py``).

The audio frontend (log-mel + conv downsampling) is a stub, as in the
JAX package: the encoder takes precomputed frame embeddings
``[B, S_enc, d_model]``. Learned positional embeddings, LayerNorm, GELU,
tied embeddings. The parameter tree is the reference's: ``enc_pos``,
``dec_pos``, ``embed``, ``encoder`` and ``decoder`` stacked along a
leading layer axis, ``enc_final_norm`` and ``final_norm``; the cache is
``self_k``, ``self_v``, ``cross_k`` and ``cross_v``, each with a leading
``n_layers`` axis, and is written in place. The encoder's self attention
(non-causal) and the decoder's causal prefill attention run the flash
kernel under ``cfg.use_kernels``; cross attention and decode run the
plain ``_sdpa``, as in the reference. Where autograd records, each layer
runs under the config's ``remat`` policy.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import basic
from repro_torch.models.layers.attention import (
    _project_qkv,
    attend_cached,
    attend_cross,
    attend_cross_projected,
    attend_full,
    attend_projected,
    init_attention,
    init_kv_cache,
    write_kv_prefix,
)
from repro_torch.models.lm import (
    _period,
    _positions,
    remat_wrap,
    stack_draws,
    tree_map,
    unstack,
)
from repro_torch.sharding.ctx import constrain, gather_sequence, split_last


def _init_pos_table(cfg, generator: torch.Generator, n: int, *, device=None) -> torch.Tensor:
    table = torch.randn((n, cfg.d_model), generator=generator, dtype=torch.float32,
                        device=device)
    return (0.01 * table).to(basic._dtype(cfg.param_dtype))


def _enc_layer_params(cfg, generator, *, device=None) -> Dict:
    return {
        "attn_norm": basic.init_norm(cfg, device=device),
        "attn": init_attention(cfg, generator, device=device),
        "ffn_norm": basic.init_norm(cfg, device=device),
        "ffn": basic.init_ffn(cfg, generator, device=device),
    }


def _dec_layer_params(cfg, generator, *, device=None) -> Dict:
    return {
        "self_norm": basic.init_norm(cfg, device=device),
        "self_attn": init_attention(cfg, generator, device=device),
        "cross_norm": basic.init_norm(cfg, device=device),
        "cross_attn": init_attention(cfg, generator, cross=True, device=device),
        "ffn_norm": basic.init_norm(cfg, device=device),
        "ffn": basic.init_ffn(cfg, generator, device=device),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator, *, device=None) -> Dict:
    max_pos = cfg.max_position or 4096
    return {
        "enc_pos": _init_pos_table(cfg, generator, max_pos, device=device),
        "dec_pos": _init_pos_table(cfg, generator, max_pos, device=device),
        "embed": basic.init_embedding(cfg, generator, device=device),
        "encoder": stack_draws(cfg.encoder_layers,
                               lambda: _enc_layer_params(cfg, generator, device=device)),
        "decoder": stack_draws(cfg.n_layers,
                               lambda: _dec_layer_params(cfg, generator, device=device)),
        "enc_final_norm": basic.init_norm(cfg, device=device),
        "final_norm": basic.init_norm(cfg, device=device),
    }


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _enc_layer(cfg: ModelConfig, layer: Dict, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    x = gather_sequence(x)
    h = basic.apply_norm(cfg, layer["attn_norm"], x)
    x = x + attend_full(cfg, layer["attn"], h, positions, causal=False)
    h = basic.apply_norm(cfg, layer["ffn_norm"], x)
    return x + basic.apply_ffn(cfg, layer["ffn"], h)


def encode(cfg: ModelConfig, params: Dict, frames: torch.Tensor) -> torch.Tensor:
    """frames: [B, S_enc, d_model] (stub frontend output) → [B, S_enc, d]."""
    cdt = basic._dtype(cfg.compute_dtype)
    s = frames.shape[1]
    x = frames.to(cdt) + params["enc_pos"][:s].to(cdt)[None]
    positions = _positions(x)
    layer_fn = remat_wrap(cfg, functools.partial(_enc_layer, cfg))
    for layer in unstack(params["encoder"], cfg.encoder_layers):
        x = constrain(x, ("dp", "tp", None))
        x = layer_fn(layer, x, positions)
    return basic.apply_norm(cfg, params["enc_final_norm"], x)


# ---------------------------------------------------------------------------
# Decoder (train forward)
# ---------------------------------------------------------------------------


def _embed_tokens(cfg: ModelConfig, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    cdt = basic._dtype(cfg.compute_dtype)
    x = basic.embed(cfg, params["embed"], tokens)
    return x + params["dec_pos"][: tokens.shape[1]].to(cdt)[None]


def _dec_layer(cfg: ModelConfig, layer: Dict, x: torch.Tensor, positions: torch.Tensor,
               enc_out: torch.Tensor) -> torch.Tensor:
    x = gather_sequence(x)
    h = basic.apply_norm(cfg, layer["self_norm"], x)
    x = x + attend_full(cfg, layer["self_attn"], h, positions, causal=True)
    h = basic.apply_norm(cfg, layer["cross_norm"], x)
    x = x + attend_cross(cfg, layer["cross_attn"], h, enc_out)
    h = basic.apply_norm(cfg, layer["ffn_norm"], x)
    return x + basic.apply_ffn(cfg, layer["ffn"], h)


def decode_full(
    cfg: ModelConfig, params: Dict, tokens: torch.Tensor, enc_out: torch.Tensor
) -> torch.Tensor:
    """Decoder over the whole token sequence. Returns float32 logits [B, S, V]."""
    x = _embed_tokens(cfg, params, tokens)
    positions = _positions(x)
    layer_fn = remat_wrap(cfg, functools.partial(_dec_layer, cfg))
    for layer in unstack(params["decoder"], cfg.n_layers):
        x = constrain(x, ("dp", "tp", None))
        x = layer_fn(layer, x, positions, enc_out)
    x = basic.apply_norm(cfg, params["final_norm"], x)
    logits = basic.unembed(cfg, params["embed"], x)  # tied head (Whisper ties)
    return constrain(logits, ("dp", None, "vocab"))


def loss_fn(
    cfg: ModelConfig, params: Dict, batch: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: {"frames": [B,S_enc,d], "tokens": [B,S_dec]}."""
    enc_out = encode(cfg, params, batch["frames"])
    logits = decode_full(cfg, params, batch["tokens"], enc_out)
    nll = basic.next_token_nll(logits, batch["tokens"])
    del logits
    ce = torch.mean(nll)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32, device=ce.device)}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    enc_len: int,
    dtype=torch.bfloat16,
    *,
    device=None,
) -> Dict:
    k, v = init_kv_cache(cfg, batch, max_len, dtype, device=device)

    def stack(leaf):
        return leaf.unsqueeze(0).repeat((cfg.n_layers,) + (1,) * leaf.dim())

    cross_shape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "self_k": tree_map(stack, k),
        "self_v": tree_map(stack, v),
        "cross_k": torch.zeros(cross_shape, dtype=dtype, device=device),
        "cross_v": torch.zeros(cross_shape, dtype=dtype, device=device),
    }


def prefill(
    cfg: ModelConfig,
    params: Dict,
    frames: torch.Tensor,
    tokens: torch.Tensor,
    cache: Dict,
) -> Tuple[torch.Tensor, Dict]:
    """Encode + decoder prompt pass, writing the self- and cross-KV caches in place.

    The cross cache's length must be the number of frames. Q/K/V are
    projected once per layer and shared by the cache writes and the
    attention (the JAX version projects twice; the numbers are the same).
    Returns (logits of the last position [B,1,V], cache).
    """
    enc_out = encode(cfg, params, frames)
    x = _embed_tokens(cfg, params, tokens)
    s = x.shape[1]
    positions = _positions(x)
    for i in range(cfg.n_layers):
        layer = _period(params["decoder"], i)
        h = basic.apply_norm(cfg, layer["self_norm"], x)
        q, k, v = _project_qkv(cfg, layer["self_attn"], h, positions=positions)
        write_kv_prefix(cfg, _period(cache["self_k"], i), k, s)
        write_kv_prefix(cfg, _period(cache["self_v"], i), v, s)
        x = x + attend_projected(cfg, layer["self_attn"], q, k, v, causal=True)
        h = basic.apply_norm(cfg, layer["cross_norm"], x)
        q, xk, xv = _project_qkv(cfg, layer["cross_attn"], h, kv_input=enc_out,
                                 use_rope=False)
        cache["cross_k"][i].copy_(xk)
        cache["cross_v"][i].copy_(xv)
        x = x + attend_cross_projected(cfg, layer["cross_attn"], q, xk, xv)
        h = basic.apply_norm(cfg, layer["ffn_norm"], x)
        x = x + basic.apply_ffn(cfg, layer["ffn"], h)
    x = basic.apply_norm(cfg, params["final_norm"], x)
    logits = basic.unembed(cfg, params["embed"], x[:, -1:, :])
    return logits, cache


def decode_step(
    cfg: ModelConfig,
    params: Dict,
    cache: Dict,
    token: torch.Tensor,       # [B] — the most recent token
    position: torch.Tensor,    # [B] — its cache slot
) -> Tuple[torch.Tensor, Dict]:
    """One decode step. Returns (logits [B,1,V], cache updated in place).

    The learned position is read per row (``dec_pos[position]``); cross
    attention reads the whole cross cache unmasked, as in the reference.
    """
    cdt = basic._dtype(cfg.compute_dtype)
    position = position.long()
    x = basic.embed(cfg, params["embed"], token[:, None])
    x = x + params["dec_pos"][position].to(cdt)[:, None, :]
    for i in range(cfg.n_layers):
        layer = _period(params["decoder"], i)
        h = basic.apply_norm(cfg, layer["self_norm"], x)
        h, _, _ = attend_cached(cfg, layer["self_attn"], h, _period(cache["self_k"], i),
                                _period(cache["self_v"], i), position)
        x = x + h
        h = basic.apply_norm(cfg, layer["cross_norm"], x)
        # Only q is projected: the encoder's k/v are in the cross cache
        # (a cross block has no bias and no qk-norm).
        q = h.to(cdt) @ layer["cross_attn"]["wq"].to(cdt)
        q = split_last(q, (cfg.n_heads, cfg.head_dim))
        x = x + attend_cross_projected(cfg, layer["cross_attn"], q, cache["cross_k"][i],
                                       cache["cross_v"][i])
        h = basic.apply_norm(cfg, layer["ffn_norm"], x)
        x = x + basic.apply_ffn(cfg, layer["ffn"], h)
    x = basic.apply_norm(cfg, params["final_norm"], x)
    logits = basic.unembed(cfg, params["embed"], x)
    return logits, cache
