"""AdamW with decoupled weight decay, global-norm clipping, schedules,
int8 moments and optional gradient compression (port of
``repro/optim/adamw.py``).

Functions on nested dicts of tensors, run under ``torch.no_grad()``, not
a ``torch.optim.Optimizer``: the state keeps the reference's layout
(``step``, ``m``, ``v``, ``master``), so a JAX state converts leaf by
leaf (:mod:`repro_torch.convert`) and a checkpoint of either restores
into the other's structure. :func:`adamw_update` returns new tensors and
leaves its inputs as they were, as the JAX function does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.lm import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any              # first moment  (params-like; f32 or int8 + scale)
    v: Any              # second moment (params-like; f32 or int8 + scale)
    master: Any = None  # f32 master weights (when params are bf16)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"      # cosine | linear | constant
    # Gradient compression (repro_torch.optim.compression): None | "int8"
    compression: Optional[str] = None
    # Moment storage: "f32" | "int8" (row-wise absmax int8, 8-bit Adam style).
    moment_dtype: str = "f32"
    # Keep f32 master weights when the model params are bf16.
    master_weights: bool = False


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in float32 step arithmetic."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        frac = torch.clamp(
            (step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
            0.0, 1.0,
        )
        if cfg.schedule == "cosine":
            decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
        else:  # linear
            decay = 1.0 - frac
        decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * decay
    return cfg.lr * warm * decay


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree)))


def clip_by_global_norm(tree: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), norm


# --- int8 moment quantisation -------------------------------------------------
# Row-wise (last-axis absmax) and shape-preserving: `q` mirrors the param's
# shape; `scale` keeps the leading axes and a last axis of 1.


def _q8_zeros(p: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {
        "q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
        "scale": torch.zeros(tuple(p.shape[:-1]) + (1,), dtype=torch.float32, device=p.device),
    }


def _q8_encode(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    x = x.float()
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-20)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def _q8_decode(enc: Dict[str, torch.Tensor]) -> torch.Tensor:
    return enc["q"].float() * enc["scale"]


@torch.no_grad()
def adamw_init(cfg: AdamWConfig, params: Any) -> AdamWState:
    if cfg.moment_dtype == "int8":
        m = tree_map(_q8_zeros, params)
        v = tree_map(_q8_zeros, params)
    else:
        m = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        v = tree_map(torch.clone, m)
    master = None
    if cfg.master_weights:
        master = tree_map(lambda p: p.detach().float().clone(), params)
    device = next(iter(tree_leaves(params))).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=m, v=v, master=master)


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    grads: Any,
    state: AdamWState,
    params: Any,
) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """Returns (new_params, new_state, metrics)."""
    if cfg.compression == "int8":
        from repro_torch.optim.compression import int8_roundtrip

        grads = int8_roundtrip(grads)

    grads, grad_norm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_at(cfg, state.step)
    b1, b2 = cfg.b1, cfg.b2
    step_f = step.float()
    correction1 = 1 - b1 ** step_f
    correction2 = 1 - b2 ** step_f

    int8_moments = cfg.moment_dtype == "int8"
    use_master = cfg.master_weights and state.master is not None

    def upd(p, g, m, v, mw):
        g = g.float()
        if int8_moments:
            m = _q8_decode(m)
            v = _q8_decode(v)
        ref = mw if use_master else p.float()
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        m_hat = m_new / correction1
        v_hat = v_new / correction2
        delta = m_hat / (torch.sqrt(v_hat) + cfg.eps)
        delta = delta + cfg.weight_decay * ref
        ref_new = ref - lr * delta
        if int8_moments:
            m_new = _q8_encode(m_new)
            v_new = _q8_encode(v_new)
        return ref_new.to(p.dtype), m_new, v_new, (ref_new if use_master else None)

    master = state.master if use_master else tree_map(lambda p: None, params)
    out = tree_map(upd, params, grads, state.m, state.v, master)

    def pick(i):
        # ``out`` holds a 4-tuple where ``params`` holds a leaf.
        return tree_map(lambda p, o: o[i], params, out)

    new_master = pick(3) if use_master else state.master
    metrics = {"grad_norm": grad_norm, "lr": lr}
    return pick(0), AdamWState(step=step, m=pick(1), v=pick(2), master=new_master), metrics
