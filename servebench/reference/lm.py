"""The ``lm`` module: the layout, the plain reference and the operation counts
of a decoder-only transformer as the port defines it for the ``lm`` family.

A configuration file names its module with ``"reference"``; the harness
loads it by path (``servebench/reference/<name>.py``) and takes from it
what depends on the architecture:

* the layout: :func:`period`, :func:`layer_leaves`, :func:`top_leaves`
  and :data:`COMPUTE_LEAVES`, from which :mod:`servebench.weights` makes
  the seeded weights in the port's layout;
* the reference: :func:`teacher_forced_logits`, which decides ``correct``;
* the counts: :func:`decode_token_flops`, :func:`prefill_flops` and
  :func:`attention_layers`, which the model and kernel metrics read.

The model (``repro_torch.models.lm``; written from its equations,
importing nothing of the program): token embedding; per layer a pre-norm
(RMSNorm or LayerNorm, eps from the configuration) GQA attention with
half-split RoPE, then a pre-norm SwiGLU FFN, dense or a mixture of
experts in every layer (float32 router softmax, top-k, gates
renormalised to sum to 1); a final norm and the output projection (tied
to the embedding or not). Departures from the published models are the
port's, and the configuration file lists them.

The MoE layer drops what the port's capacity-bounded dispatch drops, so
that both compute the same function: a prefill of S tokens is one group
of capacity ``max(8, round_up(int(1.25 · S · k / E), 8))`` per expert,
and the (token, k) pairs of an expert past that capacity, in token
order, add nothing. A decode step routes one token per slot, fewer than
the capacity floor, so it drops nothing.

:func:`teacher_forced_logits` runs the reference over each prompt and the
tokens the program served after it, layer by layer, making each layer's
weights again from the seed (:mod:`servebench.weights`), so the whole
model is never held in float32. ``quant="fp8"`` is the control: every
linear layer's inputs fake-quantised to float8 e4m3 (weights per tensor,
activations per row) and then multiplied in float32.
"""
from __future__ import annotations

import math
import sys
from typing import Callable, Dict, List, Optional, Sequence

import torch

from servebench import weights as W

#: This module, as :mod:`servebench.weights` takes it, also where the
#: harness has loaded it by path under another name.
_MODULE = sys.modules[__name__]

# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------

#: Leaves that the port casts to the compute dtype (``COMPUTE_LEAVES`` of
#: ``repro_torch.models.api``, for the layers this module lays out).
COMPUTE_LEAVES = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"})


def period(cfg: Dict) -> int:
    """One layer a period: attention and the same FFN in every layer."""
    return 1


def layer_leaves(cfg: Dict, position: int) -> List[W.Leaf]:
    """The leaves of one layer: (path under ``blocks.pos0``, shape, init, scale)."""
    if cfg["family"] != "lm" or cfg.get("qkv_bias") or cfg.get("qk_norm"):
        raise ValueError("servebench makes weights for lm-family attention models without "
                         "qkv bias or qk-norm")
    if position != 0:
        raise ValueError(f"an lm layer has one position, not {position}")
    d, f, h, kv = cfg["d_model"], cfg["d_ff"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = W.head_dim(cfg)
    out: List[W.Leaf] = [("mixer_norm.scale", (d,), "ones", 1.0)]
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


def top_leaves(cfg: Dict) -> List[W.Leaf]:
    """The leaves outside the layer stack."""
    v, d = cfg["vocab_size"], cfg["d_model"]
    out: List[W.Leaf] = [("embed.table", (v, d), "normal", 1 / math.sqrt(d)),
                         ("final_norm.scale", (d,), "ones", 1.0)]
    if cfg["norm_kind"] == "layernorm":
        out.append(("final_norm.bias", (d,), "zeros", 1.0))
    if not cfg.get("tie_embeddings"):
        out.append(("lm_head.table", (v, d), "normal", 1 / math.sqrt(d)))
    return out


# ---------------------------------------------------------------------------
# The counts
# ---------------------------------------------------------------------------


def layer_matmul_params(cfg: Dict) -> int:
    """Parameters one token multiplies through in one layer: the four
    attention projections and the FFN, of a MoE layer the router and the
    top-k experts it is sent to."""
    d, f, h, kv = cfg["d_model"], cfg["d_ff"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = W.head_dim(cfg)
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    ffn = 3 * d * f
    if cfg.get("moe_experts"):
        return attn + cfg["moe_top_k"] * ffn + d * cfg["moe_experts"]
    return attn + ffn


def attention_layers(cfg: Dict) -> int:
    """Layers that make one flash call in a prefill: all of them."""
    return cfg["n_layers"]


def attention_flops(cfg: Dict, pairs: int) -> int:
    """The score and value products over ``pairs`` (query, key) pairs, all layers."""
    return 4 * cfg["n_heads"] * W.head_dim(cfg) * pairs * attention_layers(cfg)


def decode_token_flops(cfg: Dict, position: int) -> int:
    """Model FLOPs of one decode token written at cache slot ``position``
    (it attends to ``position + 1`` keys), the output projection included."""
    mm = cfg["n_layers"] * layer_matmul_params(cfg) + cfg["vocab_size"] * cfg["d_model"]
    return 2 * mm + attention_flops(cfg, position + 1)


def prefill_flops(cfg: Dict, s: int) -> int:
    """Model FLOPs of a prefill of ``s`` tokens: every token through every
    layer, causal attention, the output projection of the last token."""
    mm = cfg["n_layers"] * layer_matmul_params(cfg) * s + cfg["vocab_size"] * cfg["d_model"]
    return 2 * mm + attention_flops(cfg, s * (s + 1) // 2)


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

FP8_MAX = 448.0  # largest finite float8 e4m3


def _fake_fp8(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / FP8_MAX
    return (x / scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str] = None) -> torch.Tensor:
    """``x @ w`` in float32; under ``quant="fp8"`` both inputs rounded to e4m3 first."""
    if quant == "fp8":
        x, w = _fake_fp8(x, -1), _fake_fp8(w, None)
    elif quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return x @ w


def norm(cfg: Dict, x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor]):
    eps = cfg["norm_eps"]
    if cfg["norm_kind"] == "layernorm":
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + eps) * scale + bias
    return x / torch.sqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of ``x`` [L, heads, D] at positions 0..L-1."""
    length, _, d = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angles = torch.arange(length, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(cfg: Dict, lw: Dict[str, torch.Tensor], h: torch.Tensor, quant) -> torch.Tensor:
    """Causal GQA self attention of one sequence ``h`` [L, d]."""
    n_h, n_kv, hd = cfg["n_heads"], cfg["n_kv_heads"], W.head_dim(cfg)
    length = h.shape[0]
    q = linear(h, lw["attn.wq"], quant).view(length, n_h, hd)
    k = linear(h, lw["attn.wk"], quant).view(length, n_kv, hd)
    v = linear(h, lw["attn.wv"], quant).view(length, n_kv, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    group = n_h // n_kv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    scores = torch.einsum("shd,thd->hst", q, k) / math.sqrt(hd)
    causal = torch.ones((length, length), dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("hst,thd->shd", torch.softmax(scores, dim=-1), v)
    return linear(out.reshape(length, n_h * hd), lw["attn.wo"], quant)


def swiglu(h, w_gate, w_up, w_down, quant):
    return linear(torch.nn.functional.silu(linear(h, w_gate, quant)) * linear(h, w_up, quant),
                  w_down, quant)


def moe_capacity(cfg: Dict, n_tokens: int) -> int:
    cap = int(cfg["moe_capacity_factor"] * n_tokens * cfg["moe_top_k"] / cfg["moe_experts"])
    return max(8, (cap + 7) // 8 * 8)


def moe(cfg: Dict, lw: Dict[str, torch.Tensor], h: torch.Tensor, prompt_len: int,
        quant) -> torch.Tensor:
    """The expert FFN of one sequence ``h`` [L, d]; rows < ``prompt_len`` are
    one capacity group (the prefill), each later row its own decode step."""
    e, k = cfg["moe_experts"], cfg["moe_top_k"]
    probs = torch.softmax(h @ lw["moe.router"], dim=-1)
    gates, experts = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    keep = torch.ones_like(gates, dtype=torch.bool)
    cap = moe_capacity(cfg, prompt_len)
    for expert in range(e):
        # (token, k) pairs of this expert within the prompt, in token order
        rows, slots = torch.nonzero(experts[:prompt_len] == expert, as_tuple=True)
        if rows.numel() > cap:
            keep[rows[cap:], slots[cap:]] = False
    out = torch.zeros_like(h)
    for expert in range(e):
        rows, slots = torch.nonzero((experts == expert) & keep, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = swiglu(h[rows], lw["moe.w_gate"][expert], lw["moe.w_up"][expert],
                   lw["moe.w_down"][expert], quant)
        out.index_add_(0, rows, y * gates[rows, slots][:, None])
    return out


def layer(cfg: Dict, lw: Dict[str, torch.Tensor], x: torch.Tensor, prompt_len: int,
          quant=None) -> torch.Tensor:
    """One transformer layer of one sequence ``x`` [L, d]."""
    h = norm(cfg, x, lw["mixer_norm.scale"], lw.get("mixer_norm.bias"))
    x = x + attention(cfg, lw, h, quant)
    h = norm(cfg, x, lw["ffn_norm.scale"], lw.get("ffn_norm.bias"))
    if cfg.get("moe_experts"):
        return x + moe(cfg, lw, h, prompt_len, quant)
    return x + swiglu(h, lw["ffn.w_gate"], lw["ffn.w_up"], lw["ffn.w_down"], quant)


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
    each layer's weights made again from ``seed`` and freed after it."""
    make_layer = layer_weights or (lambda p: W.layer_float32(_MODULE, cfg, seed, p, device))
    top = W.top_float32(_MODULE, cfg, seed, device)
    table = top["embed.table"]
    xs, starts = [], []
    for prompt, out in zip(prompts, served):
        ids = torch.as_tensor(list(prompt) + list(out[:-1]), dtype=torch.long, device=device)
        xs.append(table[ids])
        starts.append(len(prompt) - 1)
    for p in range(cfg["n_layers"]):
        lw = make_layer(p)
        xs = [layer(cfg, lw, x, s + 1, quant) for x, s in zip(xs, starts)]
        del lw
    head = top["embed.table"] if cfg.get("tie_embeddings") else top["lm_head.table"]
    logits = []
    for x, s in zip(xs, starts):
        h = norm(cfg, x[s:], top["final_norm.scale"], top.get("final_norm.bias"))
        logits.append(linear(h, head.t(), quant))
    return logits
