"""Public kernel entry points of the port (counterparts of ``repro/kernels/ops.py``).

Each takes the model layout and dispatches on where its tensors lie: a
CUDA tensor launches the hand-written kernel (and raises if it cannot),
a CPU tensor runs the plain version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gmm as _gmm
from repro_torch.kernels import mamba_step as _mamba
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import tracks_grad
from repro_torch.kernels.ref import select_first_available_np, select_first_available_torch

# ---------------------------------------------------------------------------
# Scheduler batch-routing op
# ---------------------------------------------------------------------------


def select_first_available(avail_words, orders, *, backend: str = "numpy"):
    """First-set-bit-in-order over availability mask planes (batched).

    The scheduler's mask-plane routing op: ``orders`` is an int32
    ``[m, L]`` plane of candidate positions (one row per distinct
    function hash at a routing stage, ``-1``-padded); ``avail_words`` is
    the stage's uint64 availability bitmask (``[W]``, broadcast across
    rows, or per-row ``[m, W]``). Returns int32 ``[m]`` picks, ``-1``
    where no ordered candidate is available.

    ``backend="numpy"`` (the default, as in the JAX package) runs
    :func:`select_first_available_np`; ``backend="torch"`` runs the same
    computation as torch ops on the host, where the control plane keeps
    its mask planes.
    """
    if backend == "torch":
        return select_first_available_torch(*torch_select_inputs(avail_words, orders)).numpy()
    if backend != "numpy":
        raise ValueError(f"unknown select_first_available backend: {backend!r}")
    return select_first_available_np(avail_words, orders)


def torch_select_inputs(avail_words, orders) -> Tuple[torch.Tensor, torch.Tensor]:
    """The host tensors ``select_first_available(..., backend="torch")``
    hands to :func:`select_first_available_torch`: int64 ``words32`` and
    int64 ``orders``, each with a leading row axis."""
    words = np.ascontiguousarray(avail_words, dtype=np.uint64)
    if words.ndim == 1:
        words = words[None, :]
    # Split each uint64 word into (low, high) halves by value, so
    # position p lives at word p>>5, bit p&31 on any host byte order.
    words32 = np.empty((words.shape[0], 2 * words.shape[1]), dtype=np.int64)
    words32[:, 0::2] = (words & np.uint64(0xFFFFFFFF)).astype(np.int64)
    words32[:, 1::2] = (words >> np.uint64(32)).astype(np.int64)
    ordered = np.ascontiguousarray(orders, dtype=np.int64)
    if ordered.ndim == 1:
        ordered = ordered[None, :]
    return torch.from_numpy(words32), torch.from_numpy(ordered)


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------


def flash_attention(
    q: torch.Tensor,    # [B, S, H, D]   (model layout)
    k: torch.Tensor,    # [B, T, KV, D]
    v: torch.Tensor,    # [B, T, KV, D]
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Forward attention: the CUDA kernel on a CUDA tensor, else the plain version.

    ``scale`` multiplies the scores (None: 1/√D). No gradient on either:
    where autograd records the call, it goes through
    :class:`repro_torch.kernels.flash_attention.FlashAttention`, whose
    backward raises.
    """
    if tracks_grad(q, k, v):
        return _flash.FlashAttention.apply(q, k, v, causal, scale)
    return _flash.flash_attention(q, k, v, causal=causal, scale=scale)


# ---------------------------------------------------------------------------
# MoE grouped matmul FFN
# ---------------------------------------------------------------------------


def gmm(x: torch.Tensor, w: torch.Tensor, offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[e] = x[e] @ w[e]``: the CUDA kernel on a CUDA tensor, else the plain version.

    ``offsets`` (the kernel's alone): each expert's routed pairs, so that
    the kernel skips experts that received none
    (:func:`repro_torch.kernels.gmm.gmm_cuda`). No gradient on either:
    where autograd records the call, it goes through
    :class:`repro_torch.kernels.gmm.Gmm`, whose backward raises.
    """
    if tracks_grad(x, w):
        return _gmm.Gmm.apply(x, w, offsets)
    return _gmm.gmm(x, w, offsets)


def moe_ffn_gmm(cfg, params: Dict, buffer: torch.Tensor,
                offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Expert FFN over the packed ``[E, C, d]`` buffer via grouped matmuls.

    As ``repro/kernels/ops.py::moe_ffn_gmm``: the activation runs in
    float32 and is cast to the buffer's dtype before the down projection.
    ``offsets`` go to all three products: every activation here maps 0 to
    0, so an unreached expert's rows of ``h`` are zeros too.
    """
    cdt = buffer.dtype
    if cfg.mlp_kind in ("swiglu", "geglu"):
        gate = gmm(buffer, params["w_gate"].to(cdt), offsets)
        up = gmm(buffer, params["w_up"].to(cdt), offsets)
        # jax.nn.gelu defaults to the tanh approximation.
        act = F.silu if cfg.mlp_kind == "swiglu" else (lambda v: F.gelu(v, approximate="tanh"))
        h = (act(gate.float()) * up.float()).to(cdt)
    elif cfg.mlp_kind == "squared_relu":
        h = gmm(buffer, params["w_up"].to(cdt), offsets)
        h = torch.square(F.relu(h.float())).to(cdt)
    elif cfg.mlp_kind == "gelu":
        h = gmm(buffer, params["w_up"].to(cdt), offsets)
        h = F.gelu(h.float(), approximate="tanh").to(cdt)
    else:
        raise ValueError(f"unknown mlp_kind {cfg.mlp_kind!r}")
    return gmm(h, params["w_down"].to(cdt), offsets)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------


def ssd_scan(
    x: torch.Tensor,      # [B, S, H, P]  (model layout)
    dt: torch.Tensor,     # [B, S, H]     (post-softplus)
    a: torch.Tensor,      # [H]           (negative)
    b_mat: torch.Tensor,  # [B, S, G, N]
    c_mat: torch.Tensor,  # [B, S, G, N]
    *,
    chunk: int = 256,
) -> Tuple[torch.Tensor, None]:
    """Mamba-2 chunked scan: the CUDA kernel on a CUDA tensor, else the plain version.

    As ``repro/kernels/ops.py::ssd_scan``: pre-scales ``xdt = x·dt`` and
    ``da = dt·A`` in float32, takes the chunk as S where S < chunk, and
    returns ``(y [B, S, H, P] float32, None)`` — no final state. The
    kernel reads the model layout through strides, so the transposes to
    the kernel's ``[B, H, S, *]`` layout are views, not copies. There is
    no gradient: where autograd records the call, it goes through
    :class:`repro_torch.kernels.ssd_scan.SsdScan`, whose backward raises.
    """
    s = x.shape[1]
    dt_f = dt.float()
    xdt = x.float() * dt_f[..., None]                      # [B,S,H,P]
    da = dt_f * a.float()[None, None, :]                   # [B,S,H]
    q = min(chunk, s)
    chunk = q if s % q == 0 else chunk
    args = (xdt.transpose(1, 2), da.transpose(1, 2)[:, :, None, :],
            b_mat.transpose(1, 2), c_mat.transpose(1, 2))
    if tracks_grad(*args):
        y = _ssd.SsdScan.apply(*args, chunk)
    else:
        y = _ssd.ssd_scan(*args, chunk=chunk)
    return y.transpose(1, 2), None


# ---------------------------------------------------------------------------
# Mamba-2 decode step
# ---------------------------------------------------------------------------


def mamba_step(z, xbc, dt_raw, conv, ssm, conv_w, conv_b, dt_bias, a_log, d_skip, norm_scale,
               *, groups: int, eps: float) -> torch.Tensor:
    """One Mamba-2 decode step between the projections: the CUDA kernel on a
    CUDA tensor, else the plain version.

    The port's own kernel (the JAX package's ``ssd_step`` is plain
    ``jnp``): from the in-projection's ``z``, ``xbc`` and ``dt_raw`` and
    the layer's leaves, the conv, the state update, y, the gate and the
    RMS norm, returning ``[B, DI]`` in z's dtype; the float32 ``conv``
    window and ``ssm`` state are updated in place. No gradient: where
    autograd records the call, it goes through
    :class:`repro_torch.kernels.mamba_step.MambaStep`, whose backward raises.
    """
    args = (z, xbc, dt_raw, conv, ssm, conv_w, conv_b, dt_bias, a_log, d_skip, norm_scale)
    if tracks_grad(*args):
        return _mamba.MambaStep.apply(*args, groups, eps)
    return _mamba.mamba_step(*args, groups=groups, eps=eps)
