"""Model API of the port (counterpart of ``repro/models/api.py``).

``Model`` exposes the entry points the serving engine calls:

  * ``init_params(generator, device)`` — random weights from an explicit
    ``torch.Generator``;
  * ``cast_params(params)``              — the matmul weights cast to the
    compute dtype once, where the JAX layers cast them on every call;
  * ``init_cache(batch, max_len, enc_len)``
  * ``prefill(params, batch, cache)``    — prompt processing (``batch["frames"]``
    too for ``encdec``)
  * ``decode(params, cache, token, position)`` — incremental decode
  * ``forward(params, tokens)``
  * ``loss(params, batch)``              — the training objective
  * ``input_specs(shape)`` / ``cache_specs(shape)`` — ``meta`` tensors
    standing in for a cell's inputs and caches (the dry-run's
    ``ShapeDtypeStruct``s: shapes and dtypes, no storage)

All four families are ported: ``lm``, ``hybrid`` and ``ssm``
(:mod:`repro_torch.models.lm`: attention and Mamba-2 mixers, dense and
MoE FFNs) and ``encdec`` (:mod:`repro_torch.models.encdec`). With
``use_kernels`` set, full-sequence self attention (prefill, and the
enc-dec encoder) runs the hand-written flash-attention kernel, the MoE
expert FFN the grouped-matmul kernel, and the full-sequence Mamba block
of ``forward``/``loss`` the SSD-scan kernel (serving prefill scans with
the plain ``ssd_chunked``, as the JAX package does). ``loss`` has no
backward through the kernels (each raises, as the Pallas kernels have no
VJP); training runs the plain path (:mod:`repro_torch.launch.steps`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, lm
from repro_torch.models.config import ModelConfig

#: Leaves that feed a matmul in the compute dtype (``.astype(cdt)`` in the
#: JAX layers), the MoE expert stacks and the Mamba projections included;
#: norm scales, embedding tables, the MoE router (which ``route`` reads in
#: float32) and the Mamba conv, decay, skip and dt leaves (read in
#: float32) keep the param dtype.
COMPUTE_LEAVES = frozenset(
    {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_gate", "w_up", "w_down",
     "in_proj_z", "in_proj_xbc", "in_proj_dt", "out_proj"}
)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

#: Sub-quadratic-attention families that run the long_500k cell.
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """long_500k only for the ssm and hybrid families."""
    if shape.name == "long_500k":
        return cfg.family in LONG_CONTEXT_FAMILIES
    return True


_META = torch.device("meta")


class Model:
    def __init__(self, cfg: ModelConfig) -> None:
        self.cfg = cfg

    # -- parameters ---------------------------------------------------------

    def init_params(self, generator: torch.Generator, device=None) -> Dict:
        dev = resolve_device(device)
        if generator.device.type != dev.type:
            raise ValueError(
                f"the generator is on {generator.device} but the params go to {dev}"
            )
        if self.cfg.family == "encdec":
            return encdec.init_params(self.cfg, generator, device=dev)
        return lm.init_params(self.cfg, generator, device=dev)

    def cast_params(self, params: Dict) -> Dict:
        cdt = getattr(torch, self.cfg.compute_dtype)

        def walk(tree):
            return {
                key: walk(value) if isinstance(value, dict)
                else value.to(cdt) if key in COMPUTE_LEAVES else value
                for key, value in tree.items()
            }

        return walk(params)

    # -- serving ------------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, enc_len: int = 0, *, device=None) -> Dict:
        """The serving cache; ``enc_len`` (default ``max_len``) sizes the
        enc-dec cross cache and is ignored by the other families."""
        dtype = getattr(torch, self.cfg.compute_dtype)
        dev = resolve_device(device)
        if self.cfg.family == "encdec":
            return encdec.init_cache(self.cfg, batch, max_len, enc_len or max_len,
                                     dtype=dtype, device=dev)
        return lm.init_cache(self.cfg, batch, max_len, dtype=dtype, device=dev)

    def prefill(self, params: Dict, batch: Dict, cache: Dict):
        if self.cfg.family == "encdec":
            return encdec.prefill(self.cfg, params, batch["frames"], batch["tokens"], cache)
        return lm.prefill(self.cfg, params, batch["tokens"], cache,
                          embeds=batch.get("embeds"))

    def decode(self, params: Dict, cache: Dict, token: torch.Tensor, position: torch.Tensor):
        if self.cfg.family == "encdec":
            return encdec.decode_step(self.cfg, params, cache, token, position)
        return lm.decode_step(self.cfg, params, cache, token, position)

    def forward(self, params: Dict, tokens: torch.Tensor,
                embeds: Optional[torch.Tensor] = None):
        """The decoder-only forward (``lm``, ``hybrid``, ``ssm``)."""
        return lm.forward(self.cfg, params, tokens, embeds=embeds)

    # -- objective ----------------------------------------------------------------

    def loss(self, params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """Next-token cross entropy plus the MoE aux term: (total, {"ce", "aux"})."""
        if self.cfg.family == "encdec":
            return encdec.loss_fn(self.cfg, params, batch)
        return lm.loss_fn(self.cfg, params, batch)

    # -- dry-run stand-ins --------------------------------------------------------

    def input_specs(self, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
        """``meta`` tensors for every model input of this cell.

        ``train``/``prefill``: the token batch (and the stub frontend frames
        for ``encdec``); ``decode``: the one-token step inputs. The cache
        comes from :meth:`cache_specs`, so the dry-run can shard it.
        """
        b, s = shape.global_batch, shape.seq_len
        i32 = torch.int32
        if shape.kind == "decode":
            return {"token": torch.empty((b,), dtype=i32, device=_META),
                    "position": torch.empty((b,), dtype=i32, device=_META)}
        out = {"tokens": torch.empty((b, s), dtype=i32, device=_META)}
        if self.cfg.family == "encdec":
            out = {"frames": torch.empty((b, s, self.cfg.d_model), dtype=torch.bfloat16,
                                         device=_META), **out}
        return out

    def cache_specs(self, shape: ShapeSpec) -> Dict:
        """``meta`` tensors shaped as :meth:`init_cache` (the cross cache at
        ``min(seq_len, 4096)`` frames, as in the JAX package)."""
        dtype = getattr(torch, self.cfg.compute_dtype)
        b, t = shape.global_batch, shape.seq_len
        if self.cfg.family == "encdec":
            return encdec.init_cache(self.cfg, b, t, min(t, 4096), dtype=dtype, device=_META)
        return lm.init_cache(self.cfg, b, t, dtype=dtype, device=_META)
