"""Three-term roofline from a traced step (port of ``repro/roofline/analysis.py``).

Terms (seconds, per training/serving step, per device):

  compute    = Σ matmul FLOPs of each dtype / the peak of that dtype
  memory     = bytes written / HBM bandwidth
  collective = Σ wire bytes of each collective / the link rate of its group

The counts are per device: :mod:`repro_torch.roofline.trace` counts the
local shards of one traced call, as ``hlo.py`` counts the SPMD-partitioned
module in the JAX package. Collective wire bytes are each op's result bytes
scaled by the ring-algorithm factor for its group size (AG: (n−1)/n, AR:
2(n−1)/n, RS: (n−1)·result, A2A: (n−1)/n, CP: 1), the JAX package's.

Hardware model: the NVIDIA H100 SXM5 80GB ("NVIDIA H100 80GB HBM3" at a
700 W power limit). Every constant below is a datasheet peak of that card
(dense, no sparsity), not a measurement. A collective whose ranks all sit
in one node of 8 consecutive ranks (8 GPUs on NVLink 4 through NVSwitch)
is charged at the NVLink rate; any other at the cross-node rate of one
400 Gb/s NDR InfiniBand NIC per GPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

# --- NVIDIA H100 SXM5 80GB datasheet peaks -----------------------------------
PEAK_FLOPS = {                 # dense tensor-core / CUDA-core FLOP/s per GPU
    "bfloat16": 989.4e12,
    "float16": 989.4e12,
    "tf32": 494.7e12,          # float32 matmuls with TF32 allowed
    "float32": 66.9e12,        # float32 on the CUDA cores (TF32 off)
}
HBM_BW = 3.35e12               # bytes/s per GPU, HBM3
HBM_BYTES = 80 * 10**9         # HBM3 capacity per GPU (the dry-run reads the card's
                               # own ``total_memory`` where a card is present)
NVLINK_BW = 450e9              # bytes/s per direction per GPU, NVLink 4 (18 links)
NODE_SIZE = 8                  # GPUs per NVLink domain (one HGX H100 node)
CROSS_NODE_BW = 50e9           # bytes/s per GPU across nodes: one 400 Gb/s NIC per GPU

#: Ring-algorithm wire factors applied to the *result* bytes (the JAX package's).
WIRE_FACTOR = {
    "all-gather": lambda n: (n - 1) / n,
    "all-reduce": lambda n: 2 * (n - 1) / n,
    "reduce-scatter": lambda n: float(n - 1),
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}


def link_rate(ranks: Sequence[int]) -> float:
    """Bytes/s per GPU of a collective over ``ranks``: NVLink inside one node
    of ``NODE_SIZE`` consecutive ranks, the NIC otherwise."""
    nodes = {r // NODE_SIZE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else CROSS_NODE_BW


def matmul_peak(dtype: str, tf32: bool = False) -> float:
    if dtype == "float32" and tf32:
        return PEAK_FLOPS["tf32"]
    return PEAK_FLOPS.get(dtype, PEAK_FLOPS["float32"])


# ---------------------------------------------------------------------------
# Terms
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    model_flops_total: float
    model_bytes_min: float          # unavoidable per-device HBM bytes/step
    n_chips: int
    collective_detail: Dict[str, Dict[str, float]]
    flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def model_flops_per_device(self) -> float:
        return self.model_flops_total / self.n_chips

    @property
    def useful_compute_s(self) -> float:
        """Time the *model* FLOPs alone would take at the bf16 peak."""
        return self.model_flops_per_device / PEAK_FLOPS["bfloat16"]

    @property
    def ideal_s(self) -> float:
        """Best achievable step time: model FLOPs at peak or the unavoidable
        HBM traffic (params + cache once), whichever binds."""
        return max(self.useful_compute_s, self.model_bytes_min / HBM_BW)

    @property
    def flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (per device)."""
        if self.flops_per_device <= 0:
            return 0.0
        return self.model_flops_per_device / self.flops_per_device

    @property
    def roofline_fraction(self) -> float:
        """ideal-time / bound-time."""
        if self.bound_s <= 0:
            return 0.0
        return min(1.0, self.ideal_s / self.bound_s)

    def to_json(self) -> Dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "model_flops_total": self.model_flops_total,
            "model_flops_per_device": self.model_flops_per_device,
            "model_bytes_min": self.model_bytes_min,
            "ideal_s": self.ideal_s,
            "flops_ratio": self.flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "n_chips": self.n_chips,
            "collectives": self.collective_detail,
            "flops_by_dtype": self.flops_by_dtype,
        }


def roofline_terms(
    *,
    counts,
    n_chips: int,
    model_flops_total: float,
    model_bytes_min: float = 0.0,
    tf32: bool = False,
) -> RooflineTerms:
    """Terms from :class:`repro_torch.roofline.trace.TraceCounts` of one
    device's share of the step (``tf32``: float32 matmuls ran as TF32)."""
    compute_s = sum(f / matmul_peak(dt, tf32) for dt, f in counts.flops_by_dtype.items())
    collective_s = sum(op.wire_bytes / link_rate(op.group_ranks) for op in counts.collectives
                       if op.wire_bytes > 0)
    return RooflineTerms(
        compute_s=compute_s,
        memory_s=counts.write_bytes / HBM_BW,
        collective_s=collective_s,
        flops_per_device=counts.flops,
        bytes_per_device=counts.write_bytes,
        wire_bytes_per_device=counts.wire_bytes,
        model_flops_total=model_flops_total,
        model_bytes_min=model_bytes_min,
        n_chips=n_chips,
        collective_detail=counts.collective_detail(),
        flops_by_dtype=dict(counts.flops_by_dtype),
    )


def model_bytes_min(cfg, shape, n_chips: int) -> float:
    """Unavoidable per-device HBM bytes per step (roofline ideal floor).

    decode: read active params (bf16) + the full KV/SSM cache once;
    prefill: params + write the cache;
    train: read params + opt state, write params + opt state (fp32 AdamW).
    Activation traffic is excluded (it is the optimisable part).
    """
    n_active = cfg.active_param_count()
    cache = _cache_bytes(cfg, shape)
    if shape.kind == "decode":
        total = 2.0 * n_active + cache
    elif shape.kind == "prefill":
        total = 2.0 * n_active + cache
    else:  # train: p,m,v read+write in fp32 + grads
        total = (4.0 * 2 + 4.0 * 2 + 4.0 * 2 + 4.0) * cfg.param_count()
    return total / n_chips


def _cache_bytes(cfg, shape) -> float:
    """Total KV/SSM cache bytes for this shape (bf16 KV, f32 SSM state)."""
    b, t = shape.global_batch, shape.seq_len
    total = 0.0
    pattern = cfg.layer_pattern()
    per_period_attn = sum(1 for m, _ in pattern if m == "attn")
    per_period_mamba = sum(1 for m, _ in pattern if m == "mamba")
    n_attn = cfg.n_periods * per_period_attn
    n_mamba = cfg.n_periods * per_period_mamba
    if cfg.family == "encdec":
        n_attn = cfg.n_layers * 2  # self + cross
    if n_attn:
        total += n_attn * b * t * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    if n_mamba:
        total += n_mamba * b * (
            cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4
            + (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state) * 4
        )
    return total


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (serve fwd)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence.
    return 2.0 * n_active * shape.global_batch
