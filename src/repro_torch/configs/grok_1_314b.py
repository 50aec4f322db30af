"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8e top-2. [hf:xai-org/grok-1; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="lm",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    moe_experts=8,
    moe_top_k=2,
    logit_softcap=30.0,
    remat="full",
)
