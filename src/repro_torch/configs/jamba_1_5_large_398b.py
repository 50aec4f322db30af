"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE.
[arXiv:2403.19887; hf]

Period-8 pattern: 1 attention layer (index 3) + 7 Mamba-2 layers; every
other layer's FFN is MoE (16 experts, top-2). ssm_state=128.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    moe_experts=16,
    moe_top_k=2,
    moe_every=2,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    attn_every=8,
    attn_index=3,
    remat="full",
)
