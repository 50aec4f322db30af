"""granite-4.0-h-small [hybrid] — 40L d_model=4096: 36 Mamba-2 (128 heads × 64,
d_state 128, 1 group, conv 4) and 4 GQA NoPE (32H, kv=8, D=128) at 5, 15, 25,
35; every layer MoE 72e top-10 of width 768 beside a shared SwiGLU expert of
1536; embedding × 12, residuals × 0.22, attention scale 1/128, logits ÷ 16;
vocab=100352, tied. [hf:ibm-granite/granite-4.0-h-small config.json]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab_size=100352,
    norm_eps=1e-5,
    norm_kind="rmsnorm",
    mlp_kind="swiglu",
    moe_experts=72,
    moe_top_k=10,
    moe_every=1,
    shared_expert_ff=1536,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    ssm_groups=1,
    attn_every=10,
    attn_index=5,
    pos_embedding="none",
    tie_embeddings=True,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.0078125,
    logits_scaling=16.0,
    remat="full",
)
