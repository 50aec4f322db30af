"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16e top-2. [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="lm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    mlp_kind="swiglu",
    norm_kind="layernorm",
    moe_experts=16,
    moe_top_k=2,
    remat="full",
)
