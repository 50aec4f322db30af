"""Model configuration — a single dataclass covering all assigned families.

Families:
  * ``lm``     — decoder-only transformer (dense / MoE / VLM-early-fusion)
  * ``hybrid`` — interleaved Mamba-2 + attention (Jamba-style), optional MoE
  * ``ssm``    — pure Mamba-2 (SSD)
  * ``encdec`` — encoder-decoder transformer (Whisper backbone)

Layer heterogeneity is expressed as a *period pattern*: the layer stack is
``n_layers / period`` repetitions of a fixed pattern of (mixer, ffn) pairs,
which lets every family scan over stacked per-period parameters (small HLO,
per-layer remat policy).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # lm | hybrid | ssm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // n_heads

    # --- attention variants ---------------------------------------------
    qkv_bias: bool = False           # qwen1.5
    qk_norm: bool = False            # qwen3, chameleon
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm

    # --- ffn variants ------------------------------------------------------
    mlp_kind: str = "swiglu"         # swiglu | squared_relu | gelu

    # --- MoE ----------------------------------------------------------------
    moe_experts: int = 0             # 0 → dense
    moe_top_k: int = 2
    moe_every: int = 1               # every Nth ffn is MoE (jamba: 2)
    moe_capacity_factor: float = 1.25
    shared_expert_ff: int = 0        # granite-4.0-h: a SwiGLU expert every token takes (0 → none)

    # --- SSM (Mamba-2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # --- hybrid interleave ------------------------------------------------------
    attn_every: int = 0              # period length; one attn layer per period
    attn_index: int = 0              # position of the attention layer in period

    # --- enc-dec ------------------------------------------------------------------
    encoder_layers: int = 0
    pos_embedding: str = "rope"      # rope | learned | none (NoPE: granite-4.0-h)
    max_position: int = 0            # learned-pos table size (0 = seq dependent)
    frontend: str = "none"           # none | audio_stub | vq_stub (see DESIGN.md)

    # --- embeddings / output ----------------------------------------------------
    tie_embeddings: bool = False
    logit_softcap: float = 0.0       # grok uses 30.0

    # --- granite scalars (each at its default adds no operation) -----------------
    embedding_multiplier: float = 1.0  # the token embedding × this
    residual_multiplier: float = 1.0   # every residual branch × this
    attention_multiplier: float = 0.0  # the softmax scale (0 → 1/√head_dim)
    logits_scaling: float = 1.0        # the logits ÷ this

    # --- numerics / execution -----------------------------------------------------
    kv_cache_dtype: str = "compute"  # compute | int8 (quantised KV cache)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "none"              # none | dots | full
    use_kernels: bool = False        # route hot paths through Pallas kernels

    # -------------------------------------------------------------------------

    def __post_init__(self) -> None:
        if self.family not in ("lm", "hybrid", "ssm", "encdec"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.family != "ssm" and self.n_heads > 0:
            if self.head_dim == 0:
                object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
            if self.n_heads % max(1, self.n_kv_heads) != 0:
                raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.family == "hybrid" and self.attn_every <= 0:
            raise ValueError("hybrid family requires attn_every > 0")
        if self.family in ("ssm", "hybrid") and self.ssm_state <= 0:
            raise ValueError(f"{self.family} family requires ssm_state > 0")
        if self.shared_expert_ff and (not self.moe_experts or self.mlp_kind != "swiglu"):
            raise ValueError("a shared expert sits beside swiglu MoE layers")

    # --- derived structure --------------------------------------------------------

    @property
    def period(self) -> int:
        """Length of the repeating layer pattern."""
        if self.family == "hybrid":
            import math

            # Pattern must also align with the MoE interleave.
            return _lcm(self.attn_every, self.moe_every if self.moe_experts else 1)
        if self.family == "lm" and self.moe_experts and self.moe_every > 1:
            return self.moe_every
        return 1

    @property
    def n_periods(self) -> int:
        if self.n_layers % self.period != 0:
            raise ValueError(
                f"n_layers={self.n_layers} not divisible by period={self.period}"
            )
        return self.n_layers // self.period

    def layer_pattern(self) -> List[Tuple[str, str]]:
        """(mixer, ffn) for each layer position within one period.

        mixer ∈ {"attn", "mamba"}; ffn ∈ {"dense", "moe", "none"}.
        Mamba-2 blocks have no separate FFN (the SSD block includes the
        gated expansion) unless the config interleaves MoE (Jamba).
        """
        pattern: List[Tuple[str, str]] = []
        for i in range(self.period):
            if self.family == "ssm":
                mixer = "mamba"
            elif self.family == "hybrid":
                mixer = "attn" if i % self.attn_every == self.attn_index else "mamba"
            else:
                mixer = "attn"
            if self.family == "ssm":
                ffn = "none"
            elif self.moe_experts and i % self.moe_every == self.moe_every - 1:
                ffn = "moe"
            else:
                ffn = "dense"
            pattern.append((mixer, ffn))
        return pattern

    @property
    def d_inner(self) -> int:
        """Mamba-2 expanded inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    # --- parameter counting (for rooflines & reporting) ------------------------------

    def param_count(self) -> int:
        return sum(c for _, c in self.param_breakdown())

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top-k of experts; a shared expert whole)."""
        total = 0
        for name, count in self.param_breakdown():
            if name.endswith(".moe"):
                total += count * self.moe_top_k // max(1, self.moe_experts)
            else:
                total += count
        return total

    def param_breakdown(self) -> List[Tuple[str, int]]:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        items: List[Tuple[str, int]] = [("embed", v * d)]
        if not self.tie_embeddings:
            items.append(("lm_head", v * d))

        def attn_params() -> int:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            bias = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
            qknorm = 2 * hd if self.qk_norm else 0
            return q + kv + o + bias + qknorm

        def dense_ffn() -> int:
            mults = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
            return mults * d * f

        def moe_ffn() -> int:
            return self.moe_experts * dense_ffn() + d * self.moe_experts  # + router

        def shared_ffn() -> int:
            return 3 * d * self.shared_expert_ff

        def mamba_params() -> int:
            di, ns, g = self.d_inner, self.ssm_state, self.ssm_groups
            in_proj = d * (2 * di + 2 * g * ns + self.ssm_nheads)
            conv = self.ssm_conv * (di + 2 * g * ns)
            out_proj = di * d
            extras = 3 * self.ssm_nheads  # A_log, D, dt_bias
            norm = di
            return in_proj + conv + out_proj + extras + norm

        pattern = self.layer_pattern()
        for period_idx in range(self.n_periods):
            for li, (mixer, ffn) in enumerate(pattern):
                tagname = f"layer{period_idx * self.period + li}"
                if mixer == "attn":
                    items.append((f"{tagname}.attn", attn_params() + d))
                else:
                    items.append((f"{tagname}.mamba", mamba_params() + d))
                if ffn == "dense":
                    items.append((f"{tagname}.ffn", dense_ffn() + d))
                elif ffn == "moe":
                    items.append((f"{tagname}.moe", moe_ffn() + d))
                    if self.shared_expert_ff:
                        items.append((f"{tagname}.shared", shared_ffn()))
        if self.family == "encdec":
            # Encoder self-attn + ffn, decoder cross-attn (added to the above
            # decoder stack), learned positions.
            enc = self.encoder_layers * (attn_params() + dense_ffn() + 2 * d)
            cross = self.n_layers * (attn_params() + d)
            pos = (self.max_position or 4096) * d * 2
            items += [("encoder", enc), ("cross_attn", cross), ("pos", pos)]
        items.append(("final_norm", d))
        return items


def _lcm(a: int, b: int) -> int:
    import math

    return a * b // math.gcd(a, b)
