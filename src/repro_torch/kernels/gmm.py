"""Grouped matmul (the MoE expert FFN) — the CUDA kernel's wrapper.

The kernel (``csrc/gmm.cu``) replaces the Pallas TPU kernel
``repro/kernels/moe_gmm.py::_gmm_kernel`` (reached through ``gmm`` and
``repro/kernels/ops.py::moe_ffn_gmm``). The source says what bounds it
and what its design does about that.

:func:`gmm_cuda` computes ``out[e] = x[e] @ w[e]`` for x ``[E, C, K]``
and w ``[E, K, N]`` with any expert and row strides and a contiguous
last dimension, checks what the kernel accepts and raises on anything
else, allocates the output ``[E, C, N]`` in x's dtype, launches on the
current stream, and counts its launches in the module-level
``launches``. Its plain version is :func:`repro_torch.kernels.ref.gmm_ref`.

``offsets``, optional: an int64 CUDA tensor of E + 1 ascending entries,
expert e's routed pairs being ``[offsets[e], offsets[e + 1])`` of the
MoE dispatch's sorted pairs (its ``searchsorted``). The kernel reads them
on the device at each launch (so a captured CUDA graph follows each
replay's routing), reads no weights of an expert that received no pair,
and writes its output rows as zeros. That is the product itself where,
as in the dispatch's zeroed buffer, such an expert's rows of x are zeros
(and its weights finite): the result equals a call without offsets, bit
for bit. ``None``: every expert is computed. A call with offsets takes
at most ``MAX_LISTED`` experts (``csrc/gmm.cu``); past that its launch
fails. The plain version needs none.

The kernel has no backward, as the Pallas kernel has none: where autograd
records the call, ``ops`` goes through :class:`Gmm`, whose ``backward``
raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, no_backward
from repro_torch.kernels.ref import gmm_ref

NAME = "gmm"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches made by :func:`gmm_cuda` in this process.
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load(NAME)
        fn = lib.gmm_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 4
            + [ctypes.c_int64] * 6
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.gmm_error_string.argtypes = [ctypes.c_int]
        lib.gmm_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.gmm_error_string)
    return _fn


def build() -> None:
    """Compile (if needed) and load the kernel without launching it."""
    _kernel()


def gmm_cuda(x: torch.Tensor, w: torch.Tensor,
             offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[e] = x[e] @ w[e]`` on the card; x ``[E, C, K]``, w ``[E, K, N]``;
    experts without a pair in ``offsets`` skipped (module docstring)."""
    global launches
    for name, t in (("x", x), ("w", w)):
        if not t.is_cuda:
            raise ValueError(f"gmm_cuda: {name} is not a CUDA tensor")
        if t.dim() != 3:
            raise ValueError(f"gmm_cuda: {name} must be 3-D, got {tuple(t.shape)}")
        if t.dtype not in DTYPES or t.dtype != x.dtype:
            raise TypeError(
                f"gmm_cuda: {name} is {t.dtype}; x and w must both be one of {list(DTYPES)}"
            )
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"gmm_cuda: {name}'s last dimension must be contiguous")
    if w.device != x.device:
        raise ValueError("gmm_cuda: x and w are on different devices")
    e, c, k = x.shape
    if w.shape[0] != e or w.shape[1] != k:
        raise ValueError(
            f"gmm_cuda: shapes x {tuple(x.shape)} and w {tuple(w.shape)} do not match"
        )
    n = w.shape[2]
    if offsets is not None:
        if offsets.device != x.device or offsets.dtype != torch.int64:
            raise ValueError("gmm_cuda: offsets must be int64 on x's device")
        if tuple(offsets.shape) != (e + 1,) or offsets.stride(0) != 1:
            raise ValueError(f"gmm_cuda: offsets must be {e + 1} contiguous entries, "
                             f"got {tuple(offsets.shape)}")
    out = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    if e == 0 or c == 0 or n == 0:
        return out
    fn, err_str = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, k, n,
            x.stride(0), x.stride(1), w.stride(0), w.stride(1),
            out.stride(0), out.stride(1),
            None if offsets is None else offsets.data_ptr(), DTYPES[x.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"gmm_cuda: launch failed: {err_str(rc).decode()} ({rc})")
    launches += 1
    return out


def gmm(x: torch.Tensor, w: torch.Tensor,
        offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    return gmm_cuda(x, w, offsets) if x.is_cuda else gmm_ref(x, w)


class Gmm(torch.autograd.Function):
    """The grouped matmul as an autograd node without a gradient.

    ``forward`` runs the kernel on CUDA tensors and the plain version on
    CPU tensors; ``backward`` raises on both, as the Pallas kernel has no
    VJP (:func:`repro_torch.kernels.no_backward`).
    """

    @staticmethod
    def forward(ctx, x, w, offsets=None):
        return gmm(x, w, offsets)

    @staticmethod
    def backward(ctx, grad_out):
        raise no_backward(NAME)
