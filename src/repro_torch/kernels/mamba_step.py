"""Mamba-2 decode step (one token a slot) — the CUDA kernel's wrapper.

The kernel (``csrc/mamba_step.cu``) replaces no Pallas kernel: the JAX
package's decode step (``repro/models/layers/ssm.py::apply_mamba_step``
and ``ssd_step``) is plain ``jnp``. It runs everything between the
in-projection and the out-projection of
:func:`repro_torch.models.layers.ssm.apply_mamba_step` as two CUDA
kernels: the conv, the SSM state update in place, y and the gate in one
CTA per (head, slot), then the RMS norm and the conv window's roll. The
source says what bounds it and what its design does about that.

:func:`mamba_step_cuda` takes the projections' outputs ``z [B, DI]``,
``xbc [B, DI + 2 G N]`` and ``dt_raw [B, H]`` in float32 or bfloat16, the
float32 cache ``conv [B, W-1, CD]`` and ``ssm [B, H, P, N]``, and the
layer's leaves (any float dtype; cast to float32 where they are not), all
contiguous; it checks what the kernel accepts and raises on anything else
(:func:`unsupported` says why), allocates the output and a float32
scratch, launches on the current stream, raises if a launch failed, and
counts one launch per step in the module-level ``launches``. Its plain
version is :func:`repro_torch.kernels.ref.mamba_step_ref`.

There is no backward: where autograd records the call, ``ops`` goes
through :class:`MambaStep`, whose ``backward`` raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mamba_step_ref

NAME = "mamba_step"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: N a power of two from 4 to MAX_N, P up to MAX_P with P·N up to MAX_HEAD (a
#: head's state is one CTA's registers), 2 to MAX_W conv taps, up to MAX_SLOTS slots.
MAX_N, MAX_P, MAX_HEAD, MAX_W, MAX_SLOTS = 128, 256, 8192, 8, 65535

#: Kernel launches made by :func:`mamba_step_cuda` in this process.
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load(NAME)
        fn = lib.mamba_step_fwd
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mamba_step_error_string.argtypes = [ctypes.c_int]
        lib.mamba_step_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.mamba_step_error_string)
    return _fn


def build() -> None:
    """Compile (if needed) and load the kernel without launching it."""
    _kernel()


def unsupported(z, xbc, dt_raw, conv, ssm, conv_w, conv_b, dt_bias, a_log, d_skip, norm_scale,
                *, groups: int) -> Optional[str]:
    """Why the kernel does not take these tensors, or None where it does.

    Shapes, dtypes, contiguity and the state's alignment only: where the
    tensors lie is the caller's choice (:func:`mamba_step`).
    """
    if z.dtype not in DTYPES or xbc.dtype != z.dtype or dt_raw.dtype != z.dtype:
        return (f"z, xbc and dt_raw are {z.dtype}, {xbc.dtype} and {dt_raw.dtype}; all three "
                f"must be one of {list(DTYPES)}")
    if conv.dtype != torch.float32 or ssm.dtype != torch.float32:
        return f"the conv window is {conv.dtype} and the state {ssm.dtype}; both must be float32"
    if (z.dim(), xbc.dim(), dt_raw.dim(), conv.dim(), ssm.dim()) != (2, 2, 2, 3, 4):
        return "z, xbc and dt_raw must be 2-D, the conv window 3-D and the state 4-D"
    bsz, h, p, n = ssm.shape
    w = conv.shape[1] + 1
    if min(bsz, h, p) < 1:
        return f"the state is {tuple(ssm.shape)}: no slot, head or head dim"
    if groups < 1 or h % groups:
        return f"{h} heads is not a multiple of {groups} groups"
    di, cd = h * p, h * p + 2 * groups * n
    shapes = {"z": (z, (bsz, di)), "xbc": (xbc, (bsz, cd)), "dt_raw": (dt_raw, (bsz, h)),
              "conv": (conv, (bsz, w - 1, cd)), "conv_w": (conv_w, (w, cd)),
              "conv_b": (conv_b, (cd,)), "dt_bias": (dt_bias, (h,)), "a_log": (a_log, (h,)),
              "d_skip": (d_skip, (h,)), "norm_scale": (norm_scale, (di,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            return f"{name} is {tuple(t.shape)}, not {shape}"
    if not (4 <= n <= MAX_N and n & (n - 1) == 0):
        return f"state size {n} is not a power of two from 4 to {MAX_N}"
    if p > MAX_P or p * n > MAX_HEAD:
        return f"head dim {p} at state size {n}: P must be at most {MAX_P} and P·N {MAX_HEAD}"
    if not 2 <= w <= MAX_W:
        return f"{w} conv taps: the kernel takes 2 to {MAX_W}"
    if bsz > MAX_SLOTS:
        return f"{bsz} slots: the kernel takes at most {MAX_SLOTS}"
    if not all(t.is_contiguous() for t in (z, xbc, dt_raw, conv, ssm)):
        return "z, xbc, dt_raw, the conv window and the state must be contiguous"
    if ssm.data_ptr() % 16:
        return "the state must be 16-byte aligned"
    return None


def mamba_step_cuda(z, xbc, dt_raw, conv, ssm, conv_w, conv_b, dt_bias, a_log, d_skip,
                    norm_scale, *, groups: int, eps: float) -> torch.Tensor:
    """The decode step on the card: returns ``[B, DI]`` in z's dtype and
    updates ``conv`` and ``ssm`` in place."""
    global launches
    tensors = (z, xbc, dt_raw, conv, ssm, conv_w, conv_b, dt_bias, a_log, d_skip, norm_scale)
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("mamba_step_cuda: every tensor must be a CUDA tensor")
        if t.device != z.device:
            raise ValueError("mamba_step_cuda: the tensors are on different devices")
    why = unsupported(*tensors, groups=groups)
    if why is not None:
        raise ValueError(f"mamba_step_cuda: {why}")
    bsz, h, p, n = ssm.shape
    leaves = [t.float().contiguous() for t in tensors[5:]]
    fn, err_str = _kernel()
    out = torch.empty_like(z)
    # The gated y [B, H P] and each head's sum of its squares [B, H].
    scratch = torch.empty((bsz * h * (p + 1),), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = fn(z.data_ptr(), xbc.data_ptr(), dt_raw.data_ptr(), conv.data_ptr(),
                ssm.data_ptr(), *(t.data_ptr() for t in leaves), out.data_ptr(),
                scratch.data_ptr(), bsz, h, groups, p, n, conv.shape[1] + 1, float(eps),
                DTYPES[z.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"mamba_step_cuda: launch failed: {err_str(rc).decode()} ({rc})")
    launches += 1
    return out


def mamba_step(z, xbc, dt_raw, conv, ssm, conv_w, conv_b, dt_bias, a_log, d_skip, norm_scale,
               *, groups: int, eps: float) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    fn = mamba_step_cuda if z.is_cuda else mamba_step_ref
    return fn(z, xbc, dt_raw, conv, ssm, conv_w, conv_b, dt_bias, a_log, d_skip, norm_scale,
              groups=groups, eps=eps)


class MambaStep(torch.autograd.Function):
    """The step as an autograd node without a gradient.

    ``forward`` runs the kernel on CUDA tensors and the plain version on
    CPU tensors; ``backward`` raises on both: a decode step is not trained
    through, and the model's forward (``apply_mamba``) never reaches it.
    """

    @staticmethod
    def forward(ctx, z, xbc, dt_raw, conv, ssm, conv_w, conv_b, dt_bias, a_log, d_skip,
                norm_scale, groups, eps):
        return mamba_step(z, xbc, dt_raw, conv, ssm, conv_w, conv_b, dt_bias, a_log, d_skip,
                          norm_scale, groups=groups, eps=eps)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            f"{NAME} has no backward kernel; differentiate the decode step with "
            "use_kernels=False")
