"""Deterministic synthetic token pipeline, per-host sharded (port of
``repro/data/pipeline.py``).

Each host materialises only its shard of the global batch
(``batch_at(step, host_index=, host_count=)``), and batches are addressable by step, so a restart from
a checkpoint replays the exact stream and elastic rescaling re-slices
the same stream across another host count.

Tokens and frames come from ``np.random.default_rng`` seeded per (step,
row) and per step, the reference's own generation (its module docstring
speaks of threefry, but ``batch_at`` draws with numpy): this module is a
copy of that numpy code, so every batch is bit-identical to the
reference's. :func:`make_global_batch` returns it as tensors on a device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    # Structured synthetic data: repeated n-gram motifs make the loss
    # learnable (pure uniform noise has constant optimal loss).
    motif_len: int = 16
    n_motifs: int = 64
    frames_dim: int = 0          # >0 → also emit encoder frame embeddings


class SyntheticTokens:
    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._motifs = rng.integers(
            low=0, high=cfg.vocab_size,
            size=(cfg.n_motifs, cfg.motif_len), dtype=np.int64,
        )

    # -- step-indexed access ----------------------------------------------------

    def batch_at(
        self,
        step: int,
        *,
        host_index: int = 0,
        host_count: int = 1,
    ) -> Dict[str, np.ndarray]:
        """The host's slice of global batch #step (deterministic)."""
        cfg = self.cfg
        if cfg.global_batch % host_count != 0:
            raise ValueError(
                f"global batch {cfg.global_batch} not divisible by "
                f"{host_count} hosts"
            )
        per_host = cfg.global_batch // host_count
        rows = np.arange(per_host) + host_index * per_host

        tokens = np.empty((per_host, cfg.seq_len), dtype=np.int32)
        for i, row in enumerate(rows):
            tokens[i] = self._row(step, int(row))
        out: Dict[str, np.ndarray] = {"tokens": tokens}
        if cfg.frames_dim:
            # Stub modality frontend: deterministic pseudo-embeddings.
            rng = np.random.default_rng(
                (cfg.seed * 1_000_003 + step) % (2**63)
            )
            out["frames"] = rng.standard_normal(
                (per_host, cfg.seq_len, cfg.frames_dim), dtype=np.float32
            )
        return out

    def _row(self, step: int, row: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 2_000_003 + step * 1_009 + row) % (2**63)
        )
        seq = rng.integers(0, cfg.vocab_size, size=cfg.seq_len, dtype=np.int64)
        # Plant motifs: ~50% of positions covered by repeated n-grams.
        n_plants = cfg.seq_len // (2 * cfg.motif_len)
        starts = rng.integers(0, max(1, cfg.seq_len - cfg.motif_len), size=n_plants)
        motif_ids = rng.integers(0, cfg.n_motifs, size=n_plants)
        for s, mid in zip(starts, motif_ids):
            seq[s : s + cfg.motif_len] = self._motifs[mid][: cfg.seq_len - s]
        return seq.astype(np.int32)

    # -- iterator convenience ------------------------------------------------------

    def iterate(
        self, start_step: int = 0, *, host_index: int = 0, host_count: int = 1
    ) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step, host_index=host_index, host_count=host_count)
            step += 1


def make_global_batch(
    pipeline: SyntheticTokens,
    step: int,
    device=None,
    shardings: Optional[Dict] = None,
) -> Dict[str, torch.Tensor]:
    """Single-host path: the full global batch #step as tensors on ``device``
    (default ``cuda``); a field named in ``shardings`` is placed on its
    sharding (a DTensor; each rank keeps its shard)."""
    from repro_torch.sharding.specs import distribute

    dev = resolve_device(device)
    out = {}
    for name, arr in pipeline.batch_at(step).items():
        tensor = torch.from_numpy(arr).to(dev, non_blocking=True)
        if shardings is not None and name in shardings:
            tensor = distribute(tensor, shardings[name])
        out[name] = tensor
    return out
