"""Operations and bytes of the served models and kernels, and the chip's peaks.

A frozen copy of the arithmetic the port's ``chip_smoke.py`` uses
(``_bound_ms``, ``_attention_bound_ms``), kept here so that a change to
the program cannot change the yardstick it is measured with.

Peaks: one NVIDIA H100 SXM5 from NVIDIA's data sheet, dense rates at the
700 W limit: 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3.
The served models run in bf16, so bf16 is the peak every share is of.
"""
from __future__ import annotations

from typing import Dict

PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12


def _hd(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def layer_matmul_params(cfg: Dict) -> int:
    """Parameters one token multiplies through in one layer: the four
    attention projections and the FFN, of a MoE layer the router and the
    top-k experts it is sent to."""
    d, f, h, kv = cfg["d_model"], cfg["d_ff"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = _hd(cfg)
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    ffn = 3 * d * f
    if cfg.get("moe_experts"):
        return attn + cfg["moe_top_k"] * ffn + d * cfg["moe_experts"]
    return attn + ffn


def attention_flops(cfg: Dict, pairs: int) -> int:
    """The score and value products over ``pairs`` (query, key) pairs, all layers."""
    return 4 * cfg["n_heads"] * _hd(cfg) * pairs * cfg["n_layers"]


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


def flash_bound_s(cfg: Dict, s: int, elem_bytes: int = 2) -> float:
    """Least H100 seconds of one layer's causal self attention of ``s`` tokens
    (one flash call): Q, K and V read once and O written once, the FLOPs of
    the score pairs the causal mask keeps, the larger of the two times."""
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], _hd(cfg)
    nbytes = elem_bytes * (2 * s * h * hd + 2 * s * kv * hd)
    flops = 4 * h * hd * (s * (s + 1) // 2)
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS_BF16)
