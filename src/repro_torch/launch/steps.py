"""Train / prefill / decode steps and the sharded train state (port of
``repro/launch/steps.py``).

:func:`make_train_step` takes the loss through autograd on the plain
path and applies :func:`repro_torch.optim.adamw.adamw_update`. The
params keep their own dtype (float32 by default): each layer casts its
weights to the compute dtype on every call, inside the graph, so the
gradients reach the params in their dtype, as ``jax.value_and_grad`` of
the JAX step does. Serving's cast-once (``Model.cast_params``) is not
used here.

Given a mesh and a policy, the step runs sharded: the state's leaves are
DTensors placed by :func:`train_state_shardings`, the call runs inside
the activation-sharding context (:mod:`repro_torch.sharding.ctx`), and
the new state is redistributed onto the state's shardings, as the
out-shardings of the jitted JAX step do. :func:`abstract_train_state`
gives the state as ``meta`` tensors (the dry-run's shapes) and
:func:`init_sharded_train_state` draws the same numbers as the unsharded
path and places them.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.api import Model
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import tree_map
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_init, adamw_update
from repro_torch.sharding.ctx import activation_sharding
from repro_torch.sharding.specs import (
    NamedSharding,
    P,
    ShardingPolicy,
    distribute,
    param_shardings,
    param_spec,
    reshard,
    sanitize_spec,
    tree_map_with_path,
)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def sharding_context(mesh, policy: Optional[ShardingPolicy]):
    """The activation-sharding context of ``policy`` on ``mesh`` (a null
    context without a mesh). ``policy`` must already be ``for_mesh``'d."""
    if mesh is None:
        return contextlib.nullcontext()
    act_tp = None if policy.tp_scope == "vocab" else policy.tp_axis
    return activation_sharding(mesh, policy.dp_axes, act_tp, vocab_axis=policy.tp_axis)


def _full(x):
    """A metric as a plain tensor (a DTensor gathered whole)."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def make_train_step(
    cfg: ModelConfig, opt_cfg: AdamWConfig, *, mesh=None,
    policy: Optional[ShardingPolicy] = None, state_shardings: Optional[TrainState] = None,
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """``(state, batch) -> (new state, metrics)``; ``state`` is left as it was.

    Training runs the plain path (``cfg.use_kernels`` False, the JAX
    package's default): the kernels have no backward, nor have the Pallas
    kernels, and a backward through one raises. With ``mesh`` and
    ``policy`` the step runs in their sharding context and, given
    ``state_shardings``, returns the new state placed on them.
    """
    model = Model(cfg)
    if mesh is not None:
        policy = (policy or ShardingPolicy()).for_mesh(mesh)

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        with sharding_context(mesh, policy):
            new_state, metrics = _step(state, batch)
        if state_shardings is not None:
            new_state = reshard(new_state, state_shardings)
        return new_state, {k: _full(v) for k, v in metrics.items()}

    def _step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
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


# ---------------------------------------------------------------------------
# Sharded state construction
# ---------------------------------------------------------------------------


def abstract_train_state(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None) -> TrainState:
    """The TrainState as ``meta`` tensors (shapes and dtypes, no storage,
    no random number drawn)."""
    from repro_torch.models import encdec, lm

    meta = torch.device("meta")
    init = encdec.init_params if cfg.family == "encdec" else lm.init_params
    params = init(cfg, torch.Generator(), device=meta)
    return TrainState(params=params, opt=adamw_init(opt_cfg or AdamWConfig(), params))


def train_state_shardings(cfg: ModelConfig, policy: ShardingPolicy, mesh,
                          state: TrainState) -> TrainState:
    """Shardings of a TrainState: the params by :func:`param_shardings`, each
    moment (and master weight) by its param's spec, the step replicated."""
    p_sh = param_shardings(cfg, policy, mesh, state.params)

    def moment_shardings(tree):
        """Int8 moments are {"q": param-shaped int8, "scale":
        param-shape[:-1]+(1,)}: q follows the param's spec, scale drops its
        last entry."""

        def visit(names, leaf):
            if names and names[-1] in ("q", "scale"):
                base = param_spec(cfg, policy, mesh, names[:-1], tuple(leaf.shape))
                if names[-1] == "scale":
                    entries = list(base)[: len(leaf.shape) - 1] + [None]
                    base = sanitize_spec(P(*entries), tuple(leaf.shape), mesh)
                return NamedSharding(mesh, base)
            return NamedSharding(mesh, param_spec(cfg, policy, mesh, names, tuple(leaf.shape)))

        return tree_map_with_path(visit, tree)

    master_sh = (param_shardings(cfg, policy, mesh, state.opt.master)
                 if state.opt.master is not None else None)
    return TrainState(
        params=p_sh,
        opt=AdamWState(step=NamedSharding(mesh, P()), m=moment_shardings(state.opt.m),
                       v=moment_shardings(state.opt.v), master=master_sh),
    )


def place(tree: Any, shardings: Any) -> Any:
    """Each tensor leaf of ``tree`` placed on its sharding (a DTensor)."""
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [place(a, b) for a, b in zip(tree, shardings)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if tree is None:
        return None
    return distribute(tree, shardings)


def init_sharded_train_state(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    mesh,
    policy: ShardingPolicy,
    generator: torch.Generator,
) -> TrainState:
    """The TrainState of the unsharded path, drawn from ``generator`` on the
    mesh's device, each leaf placed on its sharding."""
    policy = policy.for_mesh(mesh)
    params = Model(cfg).init_params(generator, device=mesh.device_type)
    state = TrainState(params=params, opt=adamw_init(opt_cfg, params))
    shardings = train_state_shardings(cfg, policy, mesh, state)
    return place(state, shardings)
