"""Grouped-query attention with RoPE / qk-norm / bias variants + KV cache
(port of ``repro/models/layers/attention.py``).

Three entry points:
  * :func:`attend_full`   — full-sequence self attention, causal or not
    (train / prefill, the enc-dec encoder);
  * :func:`attend_cached` — one-step decode against a KV cache;
  * :func:`attend_cross`  — encoder-decoder cross attention.

The full path routes through the hand-written flash-attention kernel
under ``cfg.use_kernels`` (:func:`repro_torch.kernels.ops.flash_attention`,
which runs its plain version on a CPU tensor); otherwise it runs
:func:`_sdpa`, the plain grouped-query attention that decode and cross
attention always use, as in the JAX package. Both scale the scores by
the config's ``attention_multiplier`` where it sets one (granite-4.0-h:
1/128), else by 1/√D; ``pos_embedding="none"`` (NoPE) skips RoPE.

Unlike the JAX functions, which return new caches, the cache writers
here update the cache tensors in place and return them.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.layers.basic import (
    _dtype,
    _init_linear,
    apply_rope,
    rms_norm_headwise,
)
from repro_torch.sharding.ctx import contiguous_grad, matmul, reshape, split_last

NEG_INF = -1e30


def init_attention(cfg, generator: torch.Generator, *, cross: bool = False,
                   device=None) -> Dict:
    """Projections ``wq, wk, wv, wo``; a cross block has no bias and no qk-norm."""
    dtype = _dtype(cfg.param_dtype)
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    params: Dict = {
        "wq": _init_linear(generator, d, h * hd, dtype, device=device),
        "wk": _init_linear(generator, d, kv * hd, dtype, device=device),
        "wv": _init_linear(generator, d, kv * hd, dtype, device=device),
        "wo": _init_linear(generator, h * hd, d, dtype, device=device),
    }
    if cfg.qkv_bias and not cross:
        params["bq"] = torch.zeros((h * hd,), dtype=dtype, device=device)
        params["bk"] = torch.zeros((kv * hd,), dtype=dtype, device=device)
        params["bv"] = torch.zeros((kv * hd,), dtype=dtype, device=device)
    if cfg.qk_norm and not cross:
        params["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        params["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return params


def _project_qkv(
    cfg,
    params: Dict,
    x: torch.Tensor,
    kv_input: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    *,
    use_rope: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q from ``x``; k and v from ``kv_input`` (cross attention) or ``x``."""
    cdt = _dtype(cfg.compute_dtype)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = x.to(cdt)
    kv_src = x if kv_input is None else kv_input.to(cdt)

    q = matmul(x, params["wq"].to(cdt))
    k = matmul(kv_src, params["wk"].to(cdt))
    v = matmul(kv_src, params["wv"].to(cdt))
    if "bq" in params:
        q = q + params["bq"].to(cdt)
        k = k + params["bk"].to(cdt)
        v = v + params["bv"].to(cdt)

    q = split_last(q, (h, hd))
    k = split_last(k, (kv, hd))
    v = split_last(v, (kv, hd))

    if "q_norm" in params:
        q = rms_norm_headwise(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm_headwise(k, params["k_norm"], cfg.norm_eps)

    if use_rope and cfg.pos_embedding == "rope" and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def softmax_scale(cfg) -> Optional[float]:
    """The config's ``attention_multiplier`` where it sets one, else None (1/√D)."""
    return cfg.attention_multiplier or None


def _scaled(scores: torch.Tensor, d: int, scale: Optional[float]) -> torch.Tensor:
    return scores / math.sqrt(d) if scale is None else scores * scale


def _sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: [B,S,H,D]; k,v: [B,T,KV,D] — grouped-query dot-product attention,
    scores times ``scale`` (None: divided by √D).

    On DTensors (a sharding context) each rank attends its own batch rows
    and heads (:func:`repro_torch.sharding.ctx.run_local`); against a
    cache sharded along T over the TP axis (decode), each rank attends its
    own T slice and the softmax is combined across them
    (:func:`_sdpa_t_sharded`).
    """
    if _is_dtensor(q) or _is_dtensor(k):
        return _sdpa_sharded(q, k, v, mask, scale)
    b, s, h, d = q.shape
    kvh = k.shape[2]
    group = h // kvh
    qg = q.reshape(b, s, kvh, group, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = _scaled(scores, d, scale)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    # The einsum's backward hands probs a transposed gradient; made
    # contiguous here (in the compute dtype), it spares the softmax
    # backward the two float32 copies its CUDA kernel would make.
    probs = contiguous_grad(torch.softmax(scores, dim=-1).to(v.dtype))
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


def _sdpa_sharded(q, k, v, mask, scale=None):
    from repro_torch.sharding.ctx import current_tp_size, run_local, tp_group_of

    group = tp_group_of(k, 1)
    mask_dims = (0 if mask is not None and mask.shape[0] > 1 else None, 4)
    if group is not None:  # decode against a T-sharded cache
        fn = functools.partial(_sdpa_t_sharded, group=group, scale=scale)
        return run_local(fn, (q, k, v, mask), [(0, None), (0, 1), (0, 1), mask_dims],
                         [(0, None)], tp_ok=True)
    n_tp = current_tp_size()
    heads_ok = q.shape[2] % n_tp == 0 and k.shape[2] % n_tp == 0
    return run_local(functools.partial(_sdpa, scale=scale), (q, k, v, mask),
                     [(0, 2), (0, 2), (0, 2), (mask_dims[0], None)], [(0, 2)], tp_ok=heads_ok)


def _sdpa_t_sharded(q, k, v, mask, *, group, scale=None):
    """:func:`_sdpa` of one T slice of k/v (and of the mask), combined over
    ``group``: the max and the sum of exponentials are all-reduced before
    the probabilities weight v, and the weighted slices are summed (in
    float32). Forward only (the decode path)."""
    from repro_torch.sharding.vocab import _all_reduce

    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
    scores = _scaled(torch.einsum("bskgd,btkd->bkgst", qg, k).float(), d, scale)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = _all_reduce(scores.amax(dim=-1, keepdim=True), "max", group)
    p = torch.exp(scores - m)
    denom = _all_reduce(p.sum(dim=-1, keepdim=True), "sum", group)
    out = torch.einsum("bkgst,btkd->bskgd", (p / denom).to(v.dtype), v)
    return _all_reduce(out.float(), "sum", group).to(v.dtype).reshape(b, s, h, d)


def attend_projected(
    cfg,
    params: Dict,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Self attention over already projected q/k/v, then the output projection.

    Split out of :func:`attend_full` so that prefill, which also writes
    k/v into the cache, projects once.
    """
    cdt = _dtype(cfg.compute_dtype)
    if cfg.use_kernels:
        from repro_torch.kernels.ops import flash_attention

        out = flash_attention(q, k, v, causal=causal, scale=softmax_scale(cfg))
    else:
        mask = None
        if causal:
            s = q.shape[1]
            mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
            mask = mask[None, None, None, :, :]
        out = _sdpa(q, k, v, mask, softmax_scale(cfg))
    out = reshape(out, (*out.shape[:-2], cfg.n_heads * cfg.head_dim))
    return matmul(out, params["wo"].to(cdt))


def attend_full(
    cfg,
    params: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Full-sequence self attention. x: [B,S,D]; positions: [B,S]."""
    q, k, v = _project_qkv(cfg, params, x, positions=positions)
    return attend_projected(cfg, params, q, k, v, causal=causal)


def attend_cached(
    cfg,
    params: Dict,
    x: torch.Tensor,
    cache_k,
    cache_v,
    position: torch.Tensor,
):
    """One-token decode. x: [B,1,D]; cache_{k,v}: [B,T,KV,Dh]; position: [B].

    Returns (attn output [B,1,D], cache_k, cache_v). The new token's K/V
    are written in place at ``position``; attention masks out cache slots
    beyond ``position``.
    """
    cdt = _dtype(cfg.compute_dtype)
    q, k_new, v_new = _project_qkv(cfg, params, x, positions=position[:, None])
    ref = cache_k["q"] if isinstance(cache_k, dict) else cache_k
    b, t = ref.shape[0], ref.shape[1]

    rows = torch.arange(b, device=ref.device)
    write_kv(cfg, cache_k, k_new[:, 0], rows, position)
    write_kv(cfg, cache_v, v_new[:, 0], rows, position)

    # Mask: only slots <= position are attendable.
    valid = torch.arange(t, device=ref.device)[None, :] <= position[:, None]  # [B,T]
    mask = valid[:, None, None, None, :]  # [B,KV,G,1,T]
    out = _sdpa(q, dequant_kv(cache_k, cdt), dequant_kv(cache_v, cdt), mask,
                softmax_scale(cfg))
    out = reshape(out, (*out.shape[:-2], cfg.n_heads * cfg.head_dim))
    return matmul(out, params["wo"].to(cdt)), cache_k, cache_v


def attend_cross(
    cfg,
    params: Dict,
    x: torch.Tensor,
    enc_out: torch.Tensor,
) -> torch.Tensor:
    """Cross attention (decoder query, encoder memory); no mask, no rope."""
    q, k, v = _project_qkv(cfg, params, x, kv_input=enc_out, use_rope=False)
    return attend_cross_projected(cfg, params, q, k, v)


def attend_cross_projected(cfg, params: Dict, q, k, v) -> torch.Tensor:
    """Unmasked plain attention over already projected encoder k/v (e.g. a
    cross cache, read in the compute dtype), then the output projection."""
    cdt = _dtype(cfg.compute_dtype)
    out = _sdpa(q, k.to(cdt), v.to(cdt), None)
    out = reshape(out, (*out.shape[:-2], cfg.n_heads * cfg.head_dim))
    return matmul(out, params["wo"].to(cdt))


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *, device=None):
    """KV cache pair. With ``cfg.kv_cache_dtype == "int8"`` each of K/V is
    a dict {"q": int8 [B,T,KV,D], "scale": f32 [B,T,KV,1]} (per-token,
    per-head absmax quantisation)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        def q8():
            return {
                "q": torch.zeros(shape, dtype=torch.int8, device=device),
                "scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device),
            }
        return q8(), q8()
    return (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def quant_kv(x: torch.Tensor) -> Dict:
    """Per-(token, head) absmax int8 quantisation of K or V rows."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-20)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequant_kv(c, dtype) -> torch.Tensor:
    if isinstance(c, dict):
        return (c["q"].float() * c["scale"]).to(dtype)
    return c.to(dtype)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _masked_write(cache, new: torch.Tensor, hit: torch.Tensor) -> None:
    """``cache[hit] = new`` in place, for a DTensor cache.

    DTensor has no sharding rule for an indexed write (``index_put_``)
    into a dim it shards, and a decode cache shards T over the TP axis
    (``cache_shardings``). So the write is a ``where`` over the whole
    cache and a ``copy_`` back, which each rank does on its own T slice:
    the same values, with one transient cache-sized buffer per write.
    """
    cache.copy_(torch.where(hit, new.to(cache.dtype), cache))


def write_kv(cfg, cache, new: torch.Tensor, rows, position):
    """Write one token's K or V into the cache at [rows, position], in place."""
    if isinstance(cache, dict):
        enc = quant_kv(new)
        write_kv(cfg, cache["q"], enc["q"], rows, position)
        write_kv(cfg, cache["scale"], enc["scale"], rows, position)
        return cache
    if _is_dtensor(cache):
        # rows is arange(B): one token per row, at that row's position.
        t = cache.shape[1]
        hit = torch.arange(t, device=position.device)[None, :] == position[:, None]
        _masked_write(cache, new[:, None], hit[:, :, None, None])
        return cache
    cache[rows, position] = new.to(cache.dtype)
    return cache


def write_kv_prefix(cfg, cache, new: torch.Tensor, length: int):
    """Write the first ``length`` positions (prefill path), in place."""
    if isinstance(cache, dict):
        enc = quant_kv(new)
        write_kv_prefix(cfg, cache["q"], enc["q"], length)
        write_kv_prefix(cfg, cache["scale"], enc["scale"], length)
        return cache
    if _is_dtensor(cache):
        if length == cache.shape[1]:
            cache.copy_(new.to(cache.dtype))
        else:
            pad = torch.zeros((), dtype=cache.dtype, device=new.device).expand(
                new.shape[0], cache.shape[1] - length, *new.shape[2:])
            hit = torch.arange(cache.shape[1], device=new.device) < length
            _masked_write(cache, torch.cat([new.to(cache.dtype), pad], dim=1),
                          hit[None, :, None, None])
        return cache
    cache[:, :length] = new.to(cache.dtype)
    return cache
