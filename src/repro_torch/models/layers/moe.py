"""Mixture-of-Experts FFN with top-k routing and capacity-bounded dispatch
(port of ``repro/models/layers/moe.py``).

Tokens are routed by a linear router (float32 softmax, top-k, gates
renormalised, Switch-style auxiliary loss), sorted stably by expert id and
packed into an ``[E, C, d]`` capacity buffer with a sacrificial slot per
expert for the pairs over capacity. The expert FFN is a grouped matmul:
with ``use_kernels`` it goes through :func:`repro_torch.kernels.ops.moe_ffn_gmm`
(the hand-written CUDA kernel on a GPU), else through einsums in the
compute dtype, on one group and on G groups (sharded or not) alike. The
outputs are combined with a gate-weighted scatter-add. A shared expert
(``cfg.shared_expert_ff``, granite-4.0-h) is a SwiGLU FFN of every token,
added to the routed output.

Under :func:`counting`, each dispatch also adds the number of distinct
experts its tokens reach to an :class:`ExpertCounter`, on the device.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers.basic import _dtype, _gelu, _init_linear, apply_ffn


def init_moe(cfg, generator: torch.Generator, *, device=None) -> Dict:
    """Router ``[d, E]``, expert stacks ``[E, d_in, d_out]`` and, where the config
    has one, the shared expert's ``[d, F]``, ``[d, F]``, ``[F, d]``, drawn in that order."""
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
    if cfg.shared_expert_ff:
        fs = cfg.shared_expert_ff
        params["shared"] = {"w_gate": _init_linear(generator, d, fs, dtype, device=device),
                            "w_up": _init_linear(generator, d, fs, dtype, device=device),
                            "w_down": _init_linear(generator, fs, d, dtype, device=device)}
    return params


class ExpertCounter:
    """Distinct experts reached, summed over the MoE calls made under
    :func:`counting`, and the number of those calls.

    Counted on the device, so that a CUDA graph captured under
    :func:`counting` counts again at every replay: each call adds the
    number of boundaries between runs of its sorted expert ids (its
    distinct experts less one) to ``boundaries``, in three small kernels
    (the comparison writes int64, so the sum needs no cast of a bool
    tensor first). The host counts the calls, and a graph's replay adds
    the calls its capture made
    (:class:`repro_torch.runtime.compiled.CompiledDecode`).
    """

    def __init__(self, device) -> None:
        self.boundaries = torch.zeros((), dtype=torch.int64, device=device)
        self.calls = 0

    def add(self, sorted_expert: torch.Tensor) -> None:
        """One call whose (token, k) pairs went to ``sorted_expert`` (ascending)."""
        n = sorted_expert.shape[0] - 1
        step = torch.ne(sorted_expert[1:], sorted_expert[:-1],
                        out=torch.empty((n,), dtype=torch.int64, device=sorted_expert.device))
        self.boundaries.add_(step.sum())
        self.calls += 1

    def read(self) -> Tuple[int, int]:
        """(distinct experts summed over the calls, calls); waits for the device."""
        return int(self.boundaries) + self.calls, self.calls

    def reset(self) -> None:
        self.boundaries.zero_()
        self.calls = 0


_COUNTER: contextvars.ContextVar[Optional[ExpertCounter]] = contextvars.ContextVar(
    "moe_expert_counter", default=None)


@contextlib.contextmanager
def counting(counter: ExpertCounter) -> Iterator[ExpertCounter]:
    """Every MoE dispatch inside adds its distinct experts to ``counter``."""
    token = _COUNTER.set(counter)
    try:
        yield counter
    finally:
        _COUNTER.reset(token)


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

    Dispatch is group-local, as in the JAX package: the tokens are split
    into G groups aligned with the data-parallel sharding (G =
    :func:`current_dp_size`, 1 outside a sharding context or when the
    token count does not divide), and the argsort/capacity/scatter
    machinery runs per group, so the sort and the token gather never
    cross devices. The aux loss is the mean of the groups'.

    One plain group (the unsharded path) runs :func:`_moe_group`. Otherwise
    (a DTensor, or G > 1) see :func:`_apply_grouped`.
    """
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.ctx import current_dp_size, reshape

    cdt = _dtype(cfg.compute_dtype)
    orig_shape = x.shape
    d = orig_shape[-1]
    x_flat = reshape(x, (-1, d))
    g = current_dp_size()
    if x_flat.shape[0] % g != 0:
        g = 1
    if g == 1 and not isinstance(x, DTensor):
        out, aux = _moe_group(cfg, params, x_flat)
        return _with_shared(cfg, params, x, out.reshape(orig_shape).to(cdt)), aux.float()
    out, aux = _apply_grouped(cfg, params, x_flat, g)
    return _with_shared(cfg, params, x, reshape(out, orig_shape).to(cdt)), aux.mean().float()


def _with_shared(cfg, params: Dict, x: torch.Tensor, routed: torch.Tensor) -> torch.Tensor:
    """The routed output plus the shared expert's SwiGLU of every token, where
    the config has one (granite-4.0-h), in the compute dtype."""
    if not cfg.shared_expert_ff:
        return routed
    return routed + apply_ffn(cfg, params["shared"], x)


def _apply_grouped(cfg, params: Dict, x_flat, g: int):
    """G token groups: dispatch and combine run per group on each rank's
    own groups; the expert FFN runs on the ``[G, E, C, d]`` buffer.

    DTensor has no sharding rule for the data-dependent ops of the
    dispatch (argsort, searchsorted, the capacity scatter) nor of the
    combine (``index_add_``), so both run on each rank's own groups
    (:func:`repro_torch.sharding.ctx.local_call`, the group dim sharded
    over the data axes): the counterpart of the JAX
    package's ``vmap`` of ``_moe_group`` over groups that GSPMD keeps on
    their devices. The buffer is then constrained to E over the TP axis
    (a local slice of a buffer that is replicated there), so that
    expert-parallel weights multiply without moving; the combine gathers
    the experts' outputs of its group back over TP. Under ``use_kernels``
    the expert FFN is the grouped-matmul kernel's (the JAX package's
    ``vmap`` of ``moe_ffn_gmm``), run on each rank's own groups and
    experts (:func:`_kernel_ffn_local`).
    """
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.sharding.ctx import (
        constrain,
        current_dp_axes,
        current_mesh,
        local_call,
        reshape,
    )
    from repro_torch.sharding.specs import P, placements

    t, d = x_flat.shape
    mesh = current_mesh()
    # The tokens over the data axes only, so that the group dim splits evenly.
    xg = reshape(constrain(x_flat, ("dp", None)), (g, t // g, d))
    dispatch = functools.partial(_dispatch_groups, cfg)
    combine = functools.partial(_combine_groups, t // g)
    if mesh is None or not isinstance(xg, DTensor):  # plain tensors, G groups
        buffer, tok, gate, keep, idx, aux = dispatch(params["router"], xg)
        h = _expert_ffn_groups(cfg, params, buffer)
        return combine(h, tok, gate, keep, idx), aux
    grp = placements(P(current_dp_axes() if g > 1 else None), mesh)
    rep = (Replicate(),) * mesh.ndim
    split = [i for i, p in enumerate(grp) if p.is_shard()]
    buffer, tok, gate, keep, idx, aux = local_call(
        dispatch, (params["router"], xg), (rep, grp), (grp,) * 6, mesh, split)
    buffer = constrain(buffer, ("dp", "tp", None, None))
    if cfg.use_kernels:
        h = _kernel_ffn_local(cfg, params, buffer, mesh)
    else:
        h = _expert_ffn_groups(cfg, params, buffer)
    (out,) = local_call(combine, (h, tok, gate, keep, idx), (grp,) * 5, (grp,), mesh, split)
    return constrain(out, ("dp", None, None)), aux


def _dispatch_groups(cfg, router, xg):
    """:func:`_dispatch` of each group of ``xg`` [G, T, d], stacked (without
    the offsets: an expert's rows of the FFN's buffer are G blocks here)."""
    parts = [_dispatch(cfg, router, xg[i])[:6] for i in range(xg.shape[0])]
    return tuple(torch.stack(field) for field in zip(*parts))


def _combine_groups(t: int, h, tok, gate, keep, idx):
    return torch.stack([_combine(t, h[i], tok[i], gate[i], keep[i], idx[i])
                        for i in range(h.shape[0])])


def _moe_group(cfg, params: Dict, x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch + expert FFN + combine for one token group. x2d: [T, d].

    The FFN gets the dispatch's offsets, so that the kernel skips the
    experts no token reached (their rows are zeros)."""
    buffer, sorted_token, sorted_gate, keep, idx, aux, offsets = _dispatch(
        cfg, params["router"], x2d)
    h = _ffn_of(cfg)(cfg, params, buffer, offsets)
    return _combine(x2d.shape[0], h, sorted_token, sorted_gate, keep, idx), aux


def _dispatch(cfg, router: torch.Tensor, x2d: torch.Tensor):
    """Route one group and pack it into its ``[E, C, d]`` capacity buffer.

    Returns (buffer, sorted token ids, sorted gates, keep mask, buffer row
    of each pair, aux loss, offsets), the second to fifth per routed
    (token, k) pair; offsets [E + 1]: expert e's pairs are
    ``[offsets[e], offsets[e + 1])`` of the sorted ones.
    """
    cdt = _dtype(cfg.compute_dtype)
    t, d = x2d.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    dev = x2d.device
    # A decode step routes every slot of the replica, free ones too; with
    # at most 8 slots the capacity floor of 8 means a free slot never
    # pushes a real token out of an expert.
    c = moe_capacity(cfg, t)

    expert_ids, gates, aux = route(cfg, {"router": router}, x2d)

    # ---- dispatch: sort (token,k) pairs by expert, take position-in-expert.
    flat_expert = expert_ids.reshape(-1)                             # [T*k]
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)    # [T*k]
    flat_gate = gates.reshape(-1)

    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    sorted_gate = flat_gate[order]
    counter = _COUNTER.get()
    if counter is not None:
        counter.add(sorted_expert)

    # Position of each routed pair within its expert's capacity buffer;
    # offsets[E] is T·k.
    offsets = torch.searchsorted(sorted_expert, torch.arange(e + 1, device=dev), right=False)
    pos_in_expert = torch.arange(t * k, device=dev) - offsets[sorted_expert]
    keep = pos_in_expert < c

    # Scatter tokens into the [E, C, d] buffer. Dropped pairs all go to
    # their expert's sacrificial slot C, the only index written twice,
    # which the view below leaves out (and which no one reads).
    slot = sorted_expert * (c + 1) + torch.where(keep, pos_in_expert, torch.full_like(pos_in_expert, c))
    buffer = torch.zeros((e * (c + 1), d), dtype=cdt, device=dev)
    buffer[slot] = x2d[sorted_token].to(cdt)
    buffer = buffer.view(e, c + 1, d)[:, :c, :]                      # [E,C,d], strided
    idx = (sorted_expert * c + pos_in_expert).clamp(0, e * c - 1)
    return buffer, sorted_token, sorted_gate, keep, idx, aux.float(), offsets


def _ffn_of(cfg):
    """The expert FFN of an ``[E, C, d]`` buffer, ``(cfg, params, buffer,
    offsets=None)``: under ``use_kernels``
    :func:`repro_torch.kernels.ops.moe_ffn_gmm` (the grouped-matmul kernel
    on a GPU, its plain version on the CPU), else :func:`_expert_ffn`."""
    if cfg.use_kernels:
        from repro_torch.kernels.ops import moe_ffn_gmm

        return moe_ffn_gmm
    return _expert_ffn


def _expert_ffn(cfg, params: Dict, buffer: torch.Tensor, offsets=None) -> torch.Tensor:
    """The plain expert FFN over an ``[E, C, d]`` buffer, in the compute
    dtype; ``offsets`` (the kernel's) are not needed."""
    cdt = _dtype(cfg.compute_dtype)
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
    return torch.einsum("ecf,efd->ecd", h, params["w_down"].to(cdt))


def _expert_ffn_groups(cfg, params: Dict, buffer: torch.Tensor) -> torch.Tensor:
    """The expert FFN (:func:`_ffn_of`) of a ``[G, E, C, d]`` buffer, as one
    ``[E, G·C, d]`` buffer: each expert multiplies all groups' tokens at
    once (a broadcast over G would leave DTensor a local view it cannot
    take). Rows never mix, so this equals the FFN of each group."""
    from repro_torch.sharding.ctx import reshape

    g, e, c, d = buffer.shape
    h = _ffn_of(cfg)(cfg, params, reshape(buffer.permute(1, 0, 2, 3), (e, g * c, d)))
    return reshape(h, (e, g, c, d)).permute(1, 0, 2, 3)


def _kernel_ffn_local(cfg, params: Dict, buffer, mesh):
    """The kernel's expert FFN of a DTensor ``[G, E, C, d]`` buffer, on each
    rank's own groups and experts (:func:`repro_torch.sharding.ctx.local_call`):
    the kernel takes plain tensors. Each rank gets its experts' stacks
    whole: sharded over E where the buffer shards E (expert parallelism),
    gathered over every other mesh dim. The output has the buffer's
    placements."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.ctx import local_call

    names = [name for name in ("w_gate", "w_up", "w_down") if name in params]
    buf = tuple(buffer.placements)
    stack = tuple(Shard(0) if p.is_shard(1) else Replicate() for p in buf)
    split = [i for i, p in enumerate(buf) if p.is_shard()]

    def ffn(local_buffer, *weights):
        return _expert_ffn_groups(cfg, dict(zip(names, weights)), local_buffer)

    (h,) = local_call(ffn, (buffer, *(params[name] for name in names)),
                      (buf,) + (stack,) * len(names), (buf,), mesh, split)
    return h


def _combine(t: int, h, sorted_token, sorted_gate, keep, idx) -> torch.Tensor:
    """Gather the expert outputs ``h`` [E, C, d] back to (token, k) pairs
    and sum each token's gate-weighted pairs: [T, d]."""
    e, c, d = h.shape
    h_flat = h.reshape(e * c, d)
    gathered = torch.where(keep[:, None], h_flat[idx], torch.zeros((), dtype=h.dtype,
                                                                    device=h.device))
    weighted = gathered * sorted_gate[:, None].to(h.dtype)
    # With top-2 routing (phi, grok) a token receives at most two adds onto
    # zero, and a + b == b + a, so the order of the GPU's atomic adds cannot
    # change the result; with top-3 or more (granite's top-10) it can, by
    # the rounding of the compute dtype.
    return torch.zeros((t, d), dtype=h.dtype, device=h.device).index_add_(0, sorted_token,
                                                                            weighted)
