"""Flash attention (forward) — the CUDA kernel's wrapper.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::_flash_kernel`` (reached through
``flash_attention_bhsd`` and ``repro/kernels/ops.py::flash_attention``).
The source says what bounds it and what its design does about that:
both dtypes run on the tensor cores (``mma.sync``, a ``cp.async`` K/V
ring, P kept in registers), float32 in 3xTF32 (each operand split into
TF32 hi and lo, three products summed in float32). Each is one launch
per call; neither falls back to the other or to the plain version.

:func:`flash_attention_cuda` takes the model layout ``[B, S, H, D]`` with
strides, checks what the kernel accepts and raises on anything else,
allocates the output, launches on the current stream, and counts its
launches in the module-level ``launches``. Its plain version is
:func:`repro_torch.kernels.ref.attention_ref`.

The kernel has no backward, as the Pallas kernel has none: where autograd
records the call, ``ops`` goes through :class:`FlashAttention`, whose
``backward`` raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, no_backward
from repro_torch.kernels.ref import attention_ref

NAME = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches made by :func:`flash_attention_cuda` in this process.
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load(NAME)
        fn = lib.flash_attention_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 6
            + [ctypes.c_int64] * 12
            + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_attention_error_string)
    return _fn


def build() -> None:
    """Compile (if needed) and load the kernel without launching it."""
    _kernel()


def flash_attention_cuda(
    q: torch.Tensor,    # [B, S, H, D]
    k: torch.Tensor,    # [B, T, KV, D]
    v: torch.Tensor,    # [B, T, KV, D]
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``scale`` multiplies the scores; None is 1/√D (the kernel's own)."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention_cuda: {name} is not a CUDA tensor")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_cuda: {name} must be 4-D, got {tuple(t.shape)}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(
                f"flash_attention_cuda: {name} is {t.dtype}; q, k and v must all "
                f"be one of {list(DTYPES)}"
            )
        if t.device != q.device:
            raise ValueError("flash_attention_cuda: q, k and v are on different devices")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention_cuda: {name}'s last dimension must be contiguous")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"flash_attention_cuda: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not match"
        )
    t, kvh = k.shape[1], k.shape[2]
    if kvh == 0 or h % kvh != 0:
        raise ValueError(f"flash_attention_cuda: {h} heads is not a multiple of {kvh} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {d} not in {HEAD_DIMS}")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0 or h == 0:
        return out
    if t == 0:
        raise ValueError("flash_attention_cuda: no keys")
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, kvh, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(causal), DTYPES[q.dtype], 0.0 if scale is None else float(scale), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_cuda: launch failed: {err_str(rc).decode()} ({rc})"
        )
    launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    return attention_ref(q, k, v, causal=causal, scale=scale)


class FlashAttention(torch.autograd.Function):
    """Attention as an autograd node without a gradient.

    ``forward`` runs the kernel on CUDA tensors and the plain version on
    CPU tensors; ``backward`` raises on both, as the Pallas kernel has no
    VJP (:func:`repro_torch.kernels.no_backward`).
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, scale=None):
        return flash_attention(q, k, v, causal=causal, scale=scale)

    @staticmethod
    def backward(ctx, grad_out):
        raise no_backward(NAME)
