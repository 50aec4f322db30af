"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs.

Full configs are exercised only through the dry-run (ShapeDtypeStruct, no
allocation); ``smoke_config()`` shrinks a config to CPU scale while keeping
the family/pattern/variants intact, for the per-arch smoke tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "qwen1_5_0_5b",
    "nemotron_4_15b",
    "qwen3_14b",
    "smollm_135m",
    "chameleon_34b",
    "jamba_1_5_large_398b",
    "whisper_small",
    "grok_1_314b",
    "phi3_5_moe_42b",
    "mamba2_2_7b",
    "granite_4_0_h_small",
]

#: Aliases accepted on the CLI (the assignment's spelling).
ALIASES: Dict[str, str] = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen3-14b": "qwen3_14b",
    "smollm-135m": "smollm_135m",
    "chameleon-34b": "chameleon_34b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "whisper-small": "whisper_small",
    "grok-1-314b": "grok_1_314b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "mamba2-2.7b": "mamba2_2_7b",
    "granite-4.0-h-small": "granite_4_0_h_small",
}


def get_config(arch: str) -> ModelConfig:
    arch_id = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(
            f"unknown architecture {arch!r}; known: {ARCH_IDS} "
            f"(aliases: {sorted(ALIASES)})"
        )
    module = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return module.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {arch_id: get_config(arch_id) for arch_id in ARCH_IDS}


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config: small widths/depths/vocab for CPU."""
    cfg = get_config(arch)
    period = cfg.period
    n_layers = 2 * period
    kv = min(cfg.n_kv_heads, 2)
    heads = max(kv * 2, 2)
    head_dim = 16
    updates = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=head_dim,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        max_position=cfg.max_position and 128,
        encoder_layers=2 if cfg.encoder_layers else 0,
    )
    if cfg.moe_experts:
        updates.update(moe_experts=4, moe_top_k=min(cfg.moe_top_k, 2))
    if cfg.shared_expert_ff:
        updates["shared_expert_ff"] = 96
    if cfg.ssm_state:
        updates.update(ssm_state=16, ssm_headdim=8, ssm_chunk=8)
    return dataclasses.replace(cfg, **updates)
