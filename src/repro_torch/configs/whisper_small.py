"""whisper-small [audio] — 12L d_model=768 12H (kv=12) d_ff=3072
vocab=51865 — enc-dec, conv frontend (STUB). [arXiv:2212.04356; unverified]

The log-mel + conv2 frontend is a stub: input_specs() provides precomputed
frame embeddings [B, S_enc, d_model]. Learned positions, LayerNorm, GELU.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    qkv_bias=True,
    mlp_kind="gelu",
    norm_kind="layernorm",
    pos_embedding="learned",
    max_position=32768,
    tie_embeddings=True,
    frontend="audio_stub",
    remat="full",
)
