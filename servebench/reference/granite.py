"""The ``granite`` module: the layout, the plain reference and the operation
counts of granite-4.0-h (``model_type`` ``granitemoehybrid``) as the port
serves it (``repro_torch.models.lm``, family ``hybrid``).

The harness loads it by path, as it loads ``reference/lm.py``, which says
what each of its functions is for. The model, written from the published
description and importing nothing of the program:

* the token embedding times ``embedding_multiplier``;
* a period of ``attn_every`` layers: position ``attn_index`` is GQA
  attention with no position encoding (NoPE) and the softmax scale
  ``attention_multiplier`` (in place of 1/√D), every other position a
  Mamba-2 mixer: in-projections to z, x·B·C and dt (no bias), a causal
  depthwise conv of width ``ssm_conv`` with a bias, SiLU, dt =
  softplus(dt + dt_bias), A = -exp(a_log), the SSM run as its recurrence
  token by token (state ← state·exp(dt·A) + dt·x⊗B, y = state·C + D·x),
  then y·SiLU(z) through an RMSNorm over the whole inner width (one
  group) and the out-projection;
* in every layer, after a pre-norm, a mixture of experts (float32
  router softmax, top-k, gates renormalised, which equals the published
  softmax over the top-k logits; ``lm.moe``, the same capacity rule as
  the port's dispatch in a prefill) plus a shared SwiGLU expert of
  width ``shared_expert_ff`` that every token takes;
* both residual branches of a layer times ``residual_multiplier``;
* a final RMSNorm, the tied output projection, the logits divided by
  ``logits_scaling``.

Everything is float32 (``servebench.check`` turns TF32 off), each layer's
weights made again from the seed when it is reached. ``quant="fp8"`` is
the control: every linear layer's inputs rounded to float8 e4m3 first,
as ``lm.linear`` does; the router and the SSM recurrence stay float32.
"""
from __future__ import annotations

import math
import sys
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from servebench import weights as W
from servebench.reference import lm

_MODULE = sys.modules[__name__]

# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------

#: Leaves the port casts to the compute dtype (``COMPUTE_LEAVES`` of
#: ``repro_torch.models.api``, for the layers this module lays out).
COMPUTE_LEAVES = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                            "in_proj_z", "in_proj_xbc", "in_proj_dt", "out_proj"})


def _check(cfg: Dict) -> None:
    if (cfg["family"] != "hybrid" or cfg.get("moe_every", 1) != 1 or not cfg["moe_experts"]
            or not cfg.get("shared_expert_ff") or cfg["mlp_kind"] != "swiglu"
            or cfg["norm_kind"] != "rmsnorm" or cfg.get("pos_embedding") != "none"
            or cfg.get("qkv_bias") or cfg.get("qk_norm") or not cfg.get("tie_embeddings")):
        raise ValueError("the granite module lays out hybrid models with a MoE layer and a "
                         "shared SwiGLU expert in every layer, RMSNorm, NoPE attention without "
                         "bias or qk-norm, and tied embeddings")


def period(cfg: Dict) -> int:
    """One attention layer and ``attn_every - 1`` Mamba-2 layers."""
    _check(cfg)
    return cfg["attn_every"]


def is_attention(cfg: Dict, position: int) -> bool:
    return position % cfg["attn_every"] == cfg["attn_index"]


def _ssm(cfg: Dict):
    """(inner width, heads, head width, groups, state size, conv channels)."""
    di = cfg["ssm_expand"] * cfg["d_model"]
    g, n = cfg["ssm_groups"], cfg["ssm_state"]
    return di, di // cfg["ssm_headdim"], cfg["ssm_headdim"], g, n, di + 2 * g * n


def layer_leaves(cfg: Dict, position: int) -> List[W.Leaf]:
    """The leaves of one period position: (path under ``blocks.pos{i}``, shape, init, scale)."""
    d, e, f, fs = cfg["d_model"], cfg["moe_experts"], cfg["d_ff"], cfg["shared_expert_ff"]
    out: List[W.Leaf] = [("mixer_norm.scale", (d,), "ones", 1.0)]
    if is_attention(cfg, position):
        h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], W.head_dim(cfg)
        out += [
            ("attn.wq", (d, h * hd), "normal", 1 / math.sqrt(d)),
            ("attn.wk", (d, kv * hd), "normal", 1 / math.sqrt(d)),
            ("attn.wv", (d, kv * hd), "normal", 1 / math.sqrt(d)),
            ("attn.wo", (h * hd, d), "normal", 1 / math.sqrt(h * hd)),
        ]
    else:
        di, nh, _, _, _, conv = _ssm(cfg)
        width = cfg["ssm_conv"]
        out += [
            ("mamba.in_proj_z", (d, di), "normal", 1 / math.sqrt(d)),
            ("mamba.in_proj_xbc", (d, conv), "normal", 1 / math.sqrt(d)),
            ("mamba.in_proj_dt", (d, nh), "normal", 1 / math.sqrt(d)),
            ("mamba.conv_w", (width, conv), "normal", 1 / math.sqrt(width)),
            ("mamba.conv_b", (conv,), "normal", 0.1),
            # A = -exp(a_log) about -0.37 to -2.7 (a standard deviation each
            # way), dt = softplus of a normal of variance 1.25: each head keeps
            # its state for one to tens of tokens.
            ("mamba.a_log", (nh,), "normal", 1.0),
            ("mamba.d_skip", (nh,), "ones", 1.0),
            ("mamba.dt_bias", (nh,), "normal", 0.5),
            ("mamba.norm_scale", (di,), "ones", 1.0),
            ("mamba.out_proj", (di, d), "normal", 1 / math.sqrt(di)),
        ]
    out += [
        ("ffn_norm.scale", (d,), "ones", 1.0),
        ("moe.router", (d, e), "normal", 1 / math.sqrt(d)),
        ("moe.w_gate", (e, d, f), "normal", 1 / math.sqrt(d)),
        ("moe.w_up", (e, d, f), "normal", 1 / math.sqrt(d)),
        ("moe.w_down", (e, f, d), "normal", 1 / math.sqrt(f)),
        ("moe.shared.w_gate", (d, fs), "normal", 1 / math.sqrt(d)),
        ("moe.shared.w_up", (d, fs), "normal", 1 / math.sqrt(d)),
        ("moe.shared.w_down", (fs, d), "normal", 1 / math.sqrt(fs)),
    ]
    return out


def top_leaves(cfg: Dict) -> List[W.Leaf]:
    """The tied embedding table and the final norm. The table is drawn at
    1/``embedding_multiplier`` of the usual N(0, 1/d), so that the scaled
    embedding is: at N(0, 1/d) itself, a token's own row would stand some
    eight standard deviations over the other logits at the tied output, and
    random weights would only echo their input."""
    _check(cfg)
    v, d = cfg["vocab_size"], cfg["d_model"]
    return [("embed.table", (v, d), "normal", 1 / (cfg["embedding_multiplier"] * math.sqrt(d))),
            ("final_norm.scale", (d,), "ones", 1.0)]


# ---------------------------------------------------------------------------
# The counts
# ---------------------------------------------------------------------------


def attention_layers(cfg: Dict) -> int:
    """Layers that make one flash call in a prefill: one a period."""
    return cfg["n_layers"] // cfg["attn_every"]


def mamba_layers(cfg: Dict) -> int:
    return cfg["n_layers"] - attention_layers(cfg)


def _attention_params(cfg: Dict) -> int:
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], W.head_dim(cfg)
    return d * h * hd + 2 * d * kv * hd + h * hd * d


def _mamba_params(cfg: Dict) -> int:
    """The in- and out-projections' parameters of one Mamba-2 layer."""
    di, nh, _, _, _, conv = _ssm(cfg)
    return cfg["d_model"] * (di + conv + nh) + di * cfg["d_model"]


def _ffn_params(cfg: Dict) -> int:
    """Parameters one token multiplies through in one MoE block: the router,
    its top-k experts and the shared expert."""
    d = cfg["d_model"]
    return d * cfg["moe_experts"] + 3 * d * (cfg["moe_top_k"] * cfg["d_ff"]
                                             + cfg["shared_expert_ff"])


def ssm_token_flops(cfg: Dict) -> int:
    """One token through one Mamba-2 layer outside its projections: the conv
    (a multiply-add per tap and channel) and the SSM step (the state decayed,
    dt·x⊗B added, the state read out against C: 5 per state element)."""
    _, nh, p, _, n, conv = _ssm(cfg)
    return 2 * cfg["ssm_conv"] * conv + 5 * nh * p * n


def _matmul_params(cfg: Dict) -> int:
    return (attention_layers(cfg) * _attention_params(cfg)
            + mamba_layers(cfg) * _mamba_params(cfg) + cfg["n_layers"] * _ffn_params(cfg))


def attention_flops(cfg: Dict, pairs: int) -> int:
    """The score and value products over ``pairs`` (query, key) pairs, all attention layers."""
    return 4 * cfg["n_heads"] * W.head_dim(cfg) * pairs * attention_layers(cfg)


def decode_token_flops(cfg: Dict, position: int) -> int:
    """Model FLOPs of one decode token written at cache slot ``position``
    (it attends to ``position + 1`` keys), the output projection included."""
    mm = _matmul_params(cfg) + cfg["vocab_size"] * cfg["d_model"]
    return (2 * mm + mamba_layers(cfg) * ssm_token_flops(cfg)
            + attention_flops(cfg, position + 1))


def prefill_flops(cfg: Dict, s: int) -> int:
    """Model FLOPs of a prefill of ``s`` tokens: every token through every
    layer, causal attention, the output projection of the last token."""
    mm = _matmul_params(cfg) * s + cfg["vocab_size"] * cfg["d_model"]
    return (2 * mm + mamba_layers(cfg) * ssm_token_flops(cfg) * s
            + attention_flops(cfg, s * (s + 1) // 2))


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------


def attention(cfg: Dict, lw: Dict[str, torch.Tensor], h: torch.Tensor, quant) -> torch.Tensor:
    """Causal GQA self attention of one sequence ``h`` [L, d], no position
    encoding, scores times ``attention_multiplier``."""
    n_h, n_kv, hd = cfg["n_heads"], cfg["n_kv_heads"], W.head_dim(cfg)
    length = h.shape[0]
    q = lm.linear(h, lw["attn.wq"], quant).view(length, n_h, hd)
    k = lm.linear(h, lw["attn.wk"], quant).view(length, n_kv, hd)
    v = lm.linear(h, lw["attn.wv"], quant).view(length, n_kv, hd)
    k = k.repeat_interleave(n_h // n_kv, dim=1)
    v = v.repeat_interleave(n_h // n_kv, dim=1)
    scores = torch.einsum("shd,thd->hst", q, k) * cfg["attention_multiplier"]
    causal = torch.ones((length, length), dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("hst,thd->shd", torch.softmax(scores, dim=-1), v)
    return lm.linear(out.reshape(length, n_h * hd), lw["attn.wo"], quant)


def mamba(cfg: Dict, lw: Dict[str, torch.Tensor], h: torch.Tensor, quant) -> torch.Tensor:
    """The Mamba-2 mixer of one sequence ``h`` [L, d], its SSM run token by token."""
    di, nh, p, g, n, _ = _ssm(cfg)
    length, width = h.shape[0], cfg["ssm_conv"]
    z = lm.linear(h, lw["mamba.in_proj_z"], quant)
    xbc = lm.linear(h, lw["mamba.in_proj_xbc"], quant)
    dt = F.softplus(lm.linear(h, lw["mamba.in_proj_dt"], quant) + lw["mamba.dt_bias"])
    # causal depthwise conv: each channel over its last `width` inputs, zeros before the first
    padded = torch.cat([xbc.new_zeros((width - 1, xbc.shape[1])), xbc])
    xbc = F.silu(sum(padded[i:i + length] * lw["mamba.conv_w"][i] for i in range(width))
                 + lw["mamba.conv_b"])
    xs = xbc[:, :di].reshape(length, nh, p)
    b = xbc[:, di:di + g * n].reshape(length, g, n).repeat_interleave(nh // g, dim=1)
    c = xbc[:, di + g * n:].reshape(length, g, n).repeat_interleave(nh // g, dim=1)
    decay = torch.exp(dt * -torch.exp(lw["mamba.a_log"]))              # [L, H]
    state = h.new_zeros((nh, p, n))
    ys = []
    for t in range(length):
        state = (state * decay[t][:, None, None]
                 + (dt[t][:, None] * xs[t])[:, :, None] * b[t][:, None, :])
        ys.append((state * c[t][:, None, :]).sum(dim=-1))
    y = torch.stack(ys) + xs * lw["mamba.d_skip"][:, None]
    y = y.reshape(length, di) * F.silu(z)
    y = y / torch.sqrt((y * y).mean(dim=-1, keepdim=True) + cfg["norm_eps"])
    return lm.linear(y * lw["mamba.norm_scale"], lw["mamba.out_proj"], quant)


def layer(cfg: Dict, lw: Dict[str, torch.Tensor], x: torch.Tensor, position: int,
          prompt_len: int, quant=None) -> torch.Tensor:
    """One layer at period ``position`` of one sequence ``x`` [L, d]; rows
    < ``prompt_len`` are the prefill's capacity group."""
    rm = cfg["residual_multiplier"]
    h = lm.norm(cfg, x, lw["mixer_norm.scale"], None)
    mixer = attention if is_attention(cfg, position) else mamba
    x = x + rm * mixer(cfg, lw, h, quant)
    h = lm.norm(cfg, x, lw["ffn_norm.scale"], None)
    shared = lm.swiglu(h, lw["moe.shared.w_gate"], lw["moe.shared.w_up"],
                       lw["moe.shared.w_down"], quant)
    return x + rm * (lm.moe(cfg, lw, h, prompt_len, quant) + shared)


def teacher_forced_logits(
    cfg: Dict,
    seed: int,
    prompts: Sequence[Sequence[int]],
    served: Sequence[Sequence[int]],
    device,
    quant: Optional[str] = None,
    layer_weights: Optional[Callable[[int], Dict[str, torch.Tensor]]] = None,
) -> List[torch.Tensor]:
    """For each prompt and the tokens served after it, the float32 logits
    [len(served), V] at the positions that predicted each served token:
    the reference run once over ``prompt + served[:-1]``, layer by layer,
    each layer's weights made again from ``seed`` (``layer_weights``) and
    freed after it."""
    make_layer = layer_weights or (lambda p: W.layer_float32(_MODULE, cfg, seed, p, device))
    top = W.top_float32(_MODULE, cfg, seed, device)
    table = top["embed.table"]
    xs, starts = [], []
    for prompt, out in zip(prompts, served):
        ids = torch.as_tensor(list(prompt) + list(out[:-1]), dtype=torch.long, device=device)
        xs.append(table[ids] * cfg["embedding_multiplier"])
        starts.append(len(prompt) - 1)
    for p in range(cfg["n_layers"]):
        lw = make_layer(p)
        xs = [layer(cfg, lw, x, p % period(cfg), s + 1, quant) for x, s in zip(xs, starts)]
        del lw
    logits = []
    for x, s in zip(xs, starts):
        h = lm.norm(cfg, x[s:], top["final_norm.scale"], None)
        logits.append(lm.linear(h, table.t(), quant) / cfg["logits_scaling"])
    return logits
