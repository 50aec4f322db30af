"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early-fusion, VQ image tokens. [arXiv:2405.09818; unverified]

Early fusion: images are VQ-tokenised into the shared 65536 vocab, so the
backbone is a plain decoder LM; the VQ tokenizer frontend is a STUB
(input_specs provides token ids that may be text or image codes).
Chameleon uses qk-norm for training stability.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="lm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=10_000.0,
    frontend="vq_stub",
    remat="full",
)
