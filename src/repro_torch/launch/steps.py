"""Train / prefill / decode steps (port of the unsharded half of
``repro/launch/steps.py``).

:func:`make_train_step` takes the loss through autograd on the plain
path and applies :func:`repro_torch.optim.adamw.adamw_update`. The
params keep their own dtype (float32 by default): each layer casts its
weights to the compute dtype on every call, inside the graph, so the
gradients reach the params in their dtype, as ``jax.value_and_grad`` of
the JAX step does. Serving's cast-once (``Model.cast_params``) is not
used here. The sharded constructors (``abstract_train_state``,
``train_state_shardings``, ``init_sharded_train_state``) wait for the
port of ``repro/sharding``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.api import Model
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import tree_map
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_update


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def make_train_step(
    cfg: ModelConfig, opt_cfg: AdamWConfig
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """``(state, batch) -> (new state, metrics)``; ``state`` is left as it was.

    Training runs the plain path (``cfg.use_kernels`` False, the JAX
    package's default): the kernels have no backward, nor have the Pallas
    kernels, and a backward through one raises.
    """
    model = Model(cfg)

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        params = tree_map(lambda p: p.detach().requires_grad_(True), state.params)
        loss, parts = model.loss(params, batch)
        loss.backward()
        # A param the loss does not reach gets a zero gradient, as in JAX.
        grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                         params)
        del params
        new_params, new_opt, opt_metrics = adamw_update(opt_cfg, grads, state.opt,
                                                        state.params)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()},
                   **opt_metrics}
        return TrainState(params=new_params, opt=new_opt), metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    model = Model(cfg)

    @torch.no_grad()
    def prefill_step(params, batch: Dict, cache):
        return model.prefill(params, batch, cache)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    model = Model(cfg)

    @torch.no_grad()
    def decode_step(params, cache, token, position):
        return model.decode(params, cache, token, position)

    return decode_step
