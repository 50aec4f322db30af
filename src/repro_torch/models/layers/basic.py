"""Basic layers: norms, RoPE, embeddings, dense FFNs (port of ``repro/models/layers/basic.py``).

All layers are (init, apply) function pairs over plain dicts of tensors,
in the JAX package's layout. The compute dtype is applied by the
caller; norms always run in float32 and cast back. Initialisers draw
from an explicit ``torch.Generator`` on the target device.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.ctx import current_mesh, matmul, run_local


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg, dim: Optional[int] = None, *, device=None) -> Dict:
    dim = dim or cfg.d_model
    params = {"scale": torch.ones((dim,), dtype=_dtype(cfg.param_dtype), device=device)}
    if cfg.norm_kind == "layernorm":
        params["bias"] = torch.zeros((dim,), dtype=_dtype(cfg.param_dtype), device=device)
    return params


def apply_norm(cfg, params: Dict, x: torch.Tensor) -> torch.Tensor:
    orig_dtype = x.dtype
    x = x.float()
    if cfg.norm_kind == "layernorm":
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, unbiased=False)
        x = (x - mean) * torch.rsqrt(var + cfg.norm_eps)
        x = x * params["scale"].float()
        x = x + params["bias"].float()
    else:  # rmsnorm
        ms = x.square().mean(dim=-1, keepdim=True)
        x = x * torch.rsqrt(ms + cfg.norm_eps)
        x = x * params["scale"].float()
    return x.to(orig_dtype)


def rms_norm_headwise(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head RMS norm for qk-norm (normalises the trailing head_dim)."""
    orig = x.dtype
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(ms + eps) * scale.float()
    return out.to(orig)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)  # [head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE. x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, device=x.device)     # [D/2]
    angles = positions[..., :, None].float() * freqs               # [..., S, D/2]
    cos = torch.cos(angles)[..., :, None, :]                       # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


def init_embedding(cfg, generator: torch.Generator, *, device=None) -> Dict:
    scale = 1.0 / math.sqrt(cfg.d_model)
    table = torch.randn(
        (cfg.vocab_size, cfg.d_model), generator=generator,
        dtype=torch.float32, device=device,
    ) * scale
    return {"table": table.to(_dtype(cfg.param_dtype))}


def embed(cfg, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    from repro_torch.sharding.vocab import vocab_parallel_embed, vocab_sharded_dim

    if vocab_sharded_dim(params["table"], 0) is not None:
        out = vocab_parallel_embed(params["table"], tokens)
    else:
        out = F.embedding(tokens.long(), params["table"])
    if cfg.embedding_multiplier != 1.0:
        out = out * cfg.embedding_multiplier
    return out.to(_dtype(cfg.compute_dtype))


def unembed(cfg, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Project to vocab logits (tied or untied), divided by ``logits_scaling``;
    returns float32 logits."""
    logits = matmul(x.float(), params["table"].float().t())
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    if cfg.logit_softcap > 0:
        cap = cfg.logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per-position next-token cross entropy ``-log_softmax(logits[:, t])[tokens[:, t + 1]]``:
    [B,S,V], [B,S] → [B,S-1].

    The log_softmax runs over the whole logits and the last position is
    dropped after it (each row's values are the same either way): given
    the slice, which is not contiguous, the CUDA kernel would first copy
    all of it (6.4 GB at smollm's B=8 × S=4096). Logits that are a DTensor
    sharded over the vocabulary go through
    :func:`repro_torch.sharding.vocab.vocab_parallel_nll`, which never
    gathers the vocabulary dim. Other DTensor logits, inside a sharding
    context, take the plain path on each rank's batch shard
    (:func:`repro_torch.sharding.ctx.run_local`), so the NLL and its
    gradient stay sharded over the data axes, as GSPMD keeps them (DTensor's
    own rule for the gather's backward builds it at the global batch).
    """
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.sharding.vocab import vocab_sharded_dim, vocab_parallel_nll

    targets = tokens[:, 1:].long()
    if vocab_sharded_dim(logits) is not None:
        return vocab_parallel_nll(logits[:, :-1, :], targets)
    if isinstance(logits, DTensor) and current_mesh() is not None:
        if not isinstance(targets, DTensor):
            mesh = logits.device_mesh
            targets = DTensor.from_local(targets, mesh, [Replicate()] * mesh.ndim,
                                         run_check=False)
        return run_local(_plain_nll, [logits, targets], [(0, None), (0, None)], [(0, None)],
                         tp_ok=False)
    return _plain_nll(logits, targets)


def _plain_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp[:, :-1, :], -1, targets[..., None])[..., 0]


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------


def _init_linear(generator, d_in: int, d_out: int, dtype, *, device=None) -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def init_ffn(cfg, generator: torch.Generator, *, device=None) -> Dict:
    dtype = _dtype(cfg.param_dtype)
    params: Dict = {}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        params["w_gate"] = _init_linear(generator, cfg.d_model, cfg.d_ff, dtype, device=device)
        params["w_up"] = _init_linear(generator, cfg.d_model, cfg.d_ff, dtype, device=device)
        params["w_down"] = _init_linear(generator, cfg.d_ff, cfg.d_model, dtype, device=device)
    else:  # squared_relu | gelu
        params["w_up"] = _init_linear(generator, cfg.d_model, cfg.d_ff, dtype, device=device)
        params["w_down"] = _init_linear(generator, cfg.d_ff, cfg.d_model, dtype, device=device)
    return params


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's default is exact.
    return F.gelu(x, approximate="tanh")


def residual(cfg, x: torch.Tensor, branch: torch.Tensor) -> torch.Tensor:
    """``x + branch``, the branch times ``residual_multiplier`` where that is not 1."""
    if cfg.residual_multiplier != 1.0:
        branch = branch * cfg.residual_multiplier
    return x + branch


def apply_ffn(cfg, params: Dict, x: torch.Tensor) -> torch.Tensor:
    cdt = _dtype(cfg.compute_dtype)
    x = x.to(cdt)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        gate = matmul(x, params["w_gate"].to(cdt))
        up = matmul(x, params["w_up"].to(cdt))
        act = F.silu if cfg.mlp_kind == "swiglu" else _gelu
        h = act(gate) * up
    elif cfg.mlp_kind == "squared_relu":
        h = matmul(x, params["w_up"].to(cdt))
        h = torch.square(F.relu(h))
    elif cfg.mlp_kind == "gelu":
        h = matmul(x, params["w_up"].to(cdt))
        h = _gelu(h)
    else:
        raise ValueError(f"unknown mlp_kind {cfg.mlp_kind!r}")
    return matmul(h, params["w_down"].to(cdt))
