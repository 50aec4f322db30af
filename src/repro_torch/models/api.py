"""Model API of the port (counterpart of ``repro/models/api.py``).

``Model`` exposes the entry points the serving engine calls:

  * ``init_params(generator, device)`` — random weights from an explicit
    ``torch.Generator``;
  * ``cast_params(params)``              — the matmul weights cast to the
    compute dtype once, where the JAX layers cast them on every call;
  * ``init_cache(batch, max_len)``
  * ``prefill(params, batch, cache)``    — prompt processing
  * ``decode(params, cache, token, position)`` — incremental decode
  * ``forward(params, tokens)``

The ``lm`` family is ported with dense and MoE FFNs (the MoE expert FFN
runs the hand-written grouped-matmul kernel when ``use_kernels`` is set).
Mamba mixers (ROADMAP Queue A item 2) and the ``encdec`` family (item 3)
raise, and training (item 4) has no entry point yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

#: Leaves that feed a matmul in the compute dtype (``.astype(cdt)`` in the
#: JAX layers), the MoE expert stacks included; norm scales, embedding
#: tables and the MoE router (which ``route`` reads in float32) keep the
#: param dtype.
COMPUTE_LEAVES = frozenset(
    {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_gate", "w_up", "w_down"}
)


class Model:
    def __init__(self, cfg: ModelConfig) -> None:
        if cfg.family == "encdec":
            raise NotImplementedError(
                f"{cfg.name}: the encdec family is not ported yet "
                "(ROADMAP Queue A item 3: enc-dec, models/encdec.py)"
            )
        lm.check_supported(cfg)
        self.cfg = cfg

    # -- parameters ---------------------------------------------------------

    def init_params(self, generator: torch.Generator, device=None) -> Dict:
        dev = resolve_device(device)
        if generator.device.type != dev.type:
            raise ValueError(
                f"the generator is on {generator.device} but the params go to {dev}"
            )
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
        dtype = getattr(torch, self.cfg.compute_dtype)
        return lm.init_cache(self.cfg, batch, max_len, dtype=dtype,
                             device=resolve_device(device))

    def prefill(self, params: Dict, batch: Dict, cache: Dict):
        return lm.prefill(self.cfg, params, batch["tokens"], cache,
                          embeds=batch.get("embeds"))

    def decode(self, params: Dict, cache: Dict, token: torch.Tensor, position: torch.Tensor):
        return lm.decode_step(self.cfg, params, cache, token, position)

    def forward(self, params: Dict, tokens: torch.Tensor,
                embeds: Optional[torch.Tensor] = None):
        return lm.forward(self.cfg, params, tokens, embeds=embeds)
