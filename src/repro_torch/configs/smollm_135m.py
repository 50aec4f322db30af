"""smollm-135m [dense] — 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152 — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]

Also the ~100M end-to-end training example (examples/train_smollm.py).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="lm",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
    remat="full",
)
