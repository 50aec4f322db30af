"""The chip's peaks, and the least time of one attention layer's flash call.

A frozen copy of the arithmetic the port's ``chip_smoke.py`` uses
(``_bound_ms``, ``_attention_bound_ms``), kept here so that a change to
the program cannot change the yardstick it is measured with.

What depends on the architecture comes from the configuration's module
(``servebench/reference/<name>.py``): ``decode_token_flops(cfg,
position)``, ``prefill_flops(cfg, s)``, and ``attention_layers(cfg)``,
the layers that make one flash call in a prefill. What stays here is
generic: the peaks, and :func:`flash_bound_s`, which depends only on the
attention heads.

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


def flash_bound_s(cfg: Dict, s: int, elem_bytes: int = 2) -> float:
    """Least H100 seconds of one layer's causal self attention of ``s`` tokens
    (one flash call): Q, K and V read once and O written once, the FLOPs of
    the score pairs the causal mask keeps, the larger of the two times."""
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], _hd(cfg)
    nbytes = elem_bytes * (2 * s * h * hd + 2 * s * kv * hd)
    flops = 4 * h * hd * (s * (s + 1) // 2)
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS_BF16)
