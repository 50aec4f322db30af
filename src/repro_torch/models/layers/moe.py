"""Mixture-of-Experts FFN with top-k routing and capacity-bounded dispatch
(port of ``repro/models/layers/moe.py``).

Tokens are routed by a linear router (float32 softmax, top-k, gates
renormalised, Switch-style auxiliary loss), sorted stably by expert id and
packed into an ``[E, C, d]`` capacity buffer with a sacrificial slot per
expert for the pairs over capacity. The expert FFN is a grouped matmul:
with ``use_kernels`` it goes through :func:`repro_torch.kernels.ops.moe_ffn_gmm`
(the hand-written CUDA kernel on a GPU), else through einsums in the
compute dtype. The outputs are combined with a gate-weighted scatter-add.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers.basic import _dtype, _gelu, _init_linear


def init_moe(cfg, generator: torch.Generator, *, device=None) -> Dict:
    """Router ``[d, E]`` and expert stacks ``[E, d_in, d_out]``, drawn in that order."""
    dtype = _dtype(cfg.param_dtype)
    e, d, f = cfg.moe_experts, cfg.d_model, cfg.d_ff

    def expert_stack(d_in, d_out):
        w = torch.randn((e, d_in, d_out), generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)  # in place: one copy at a time

    params: Dict = {"router": _init_linear(generator, d, e, dtype, device=device)}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        params["w_gate"] = expert_stack(d, f)
        params["w_up"] = expert_stack(d, f)
        params["w_down"] = expert_stack(f, d)
    else:
        params["w_up"] = expert_stack(d, f)
        params["w_down"] = expert_stack(f, d)
    return params


def moe_capacity(cfg, n_tokens: int) -> int:
    cap = int(cfg.moe_capacity_factor * n_tokens * cfg.moe_top_k / cfg.moe_experts)
    return max(8, _round_up(cap, 8))


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def route(cfg, params: Dict, x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router logits → (top-k expert ids [T,k], gates [T,k], aux loss).

    ``torch.topk`` and ``lax.top_k`` may order exactly tied probabilities
    differently; with float32 router logits of real inputs a tie is rare,
    and a parity test that fails on one says so.
    """
    logits = x2d.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                        # [T,E]
    gates, expert_ids = torch.topk(probs, cfg.moe_top_k, dim=-1)  # [T,k]
    gates = gates / gates.sum(dim=-1, keepdim=True)

    # Load-balancing auxiliary loss (Switch-style: fraction-of-tokens ×
    # fraction-of-probability per expert).
    e = cfg.moe_experts
    one_hot = F.one_hot(expert_ids[:, 0], e).float()
    density = one_hot.mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux = (density * density_proxy).sum() * e
    return expert_ids, gates, aux


def apply_moe(cfg, params: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [..., d] → (out [..., d], aux loss scalar).

    Dispatch is group-local in the JAX package, one group per data-parallel
    shard. The port has no data-parallel mesh yet, so there is one group
    (G = 1, as the JAX package has on one device) and the mean of the
    groups' aux losses is that group's.
    """
    cdt = _dtype(cfg.compute_dtype)
    orig_shape = x.shape
    out, aux = _moe_group(cfg, params, x.reshape(-1, orig_shape[-1]))
    return out.reshape(orig_shape).to(cdt), aux.float()


def _moe_group(cfg, params: Dict, x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch + expert FFN + combine for one token group. x2d: [T, d]."""
    cdt = _dtype(cfg.compute_dtype)
    t, d = x2d.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    dev = x2d.device
    # A decode step routes every slot of the replica, free ones too; with
    # at most 8 slots the capacity floor of 8 means a free slot never
    # pushes a real token out of an expert.
    c = moe_capacity(cfg, t)

    expert_ids, gates, aux = route(cfg, params, x2d)

    # ---- dispatch: sort (token,k) pairs by expert, take position-in-expert.
    flat_expert = expert_ids.reshape(-1)                             # [T*k]
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)    # [T*k]
    flat_gate = gates.reshape(-1)

    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    sorted_gate = flat_gate[order]

    # Position of each routed pair within its expert's capacity buffer.
    expert_start = torch.searchsorted(sorted_expert, torch.arange(e, device=dev), right=False)
    pos_in_expert = torch.arange(t * k, device=dev) - expert_start[sorted_expert]
    keep = pos_in_expert < c

    # Scatter tokens into the [E, C, d] buffer. Dropped pairs all go to
    # their expert's sacrificial slot C, the only index written twice,
    # which the view below leaves out (and which no one reads).
    slot = sorted_expert * (c + 1) + torch.where(keep, pos_in_expert, torch.full_like(pos_in_expert, c))
    buffer = torch.zeros((e * (c + 1), d), dtype=cdt, device=dev)
    buffer[slot] = x2d[sorted_token].to(cdt)
    buffer = buffer.view(e, c + 1, d)[:, :c, :]                      # [E,C,d], strided

    # ---- expert computation: grouped matmul.
    if cfg.use_kernels:
        from repro_torch.kernels.ops import moe_ffn_gmm

        h = moe_ffn_gmm(cfg, params, buffer)
    else:
        if cfg.mlp_kind in ("swiglu", "geglu"):
            gate_h = torch.einsum("ecd,edf->ecf", buffer, params["w_gate"].to(cdt))
            up_h = torch.einsum("ecd,edf->ecf", buffer, params["w_up"].to(cdt))
            act = F.silu if cfg.mlp_kind == "swiglu" else _gelu
            h = act(gate_h) * up_h
        elif cfg.mlp_kind == "squared_relu":
            h = torch.einsum("ecd,edf->ecf", buffer, params["w_up"].to(cdt))
            h = torch.square(F.relu(h))
        else:
            h = torch.einsum("ecd,edf->ecf", buffer, params["w_up"].to(cdt))
            h = _gelu(h)
        h = torch.einsum("ecf,efd->ecd", h, params["w_down"].to(cdt))

    # ---- combine: gather expert outputs back to (token, k) pairs.
    h_flat = h.reshape(e * c, d)
    idx = (sorted_expert * c + pos_in_expert).clamp(0, e * c - 1)
    gathered = torch.where(keep[:, None], h_flat[idx], torch.zeros((), dtype=cdt, device=dev))
    weighted = gathered * sorted_gate[:, None].to(cdt)
    # With top-2 routing (every MoE config here) a token receives at most
    # two adds onto zero, and a + b == b + a, so the order of the GPU's
    # atomic adds cannot change the result; with top-3 or more it could.
    out = torch.zeros((t, d), dtype=cdt, device=dev).index_add_(0, sorted_token, weighted)
    return out, aux.float()
