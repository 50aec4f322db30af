"""Mamba-2 chunked SSD scan (forward) — the CUDA kernel's wrapper.

The kernel (``csrc/ssd_scan.cu``) replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py::_ssd_kernel`` (reached through
``ssd_scan_bhsd`` and ``repro/kernels/ops.py::ssd_scan``). One scan is
three CUDA kernels on the tensor cores: each chunk's own state, the
state passed from chunk to chunk, and each chunk's outputs (the first two
only where there is more than one chunk). The source says what bounds it
and what its design does about that.

:func:`ssd_scan_cuda` takes the JAX kernel's layout — xdt ``[B, H, S, P]``
and da ``[B, H, 1, S]`` in float32, B and C ``[B, G, S, N]`` in float32
or bfloat16 — with any strides (a contiguous last dimension for xdt, B
and C), so views of the model layout need no transpose; it checks
what the kernel accepts and raises on anything else, allocates the
float32 output ``[B, H, S, P]`` (as a view of a ``[B, S, H, P]`` tensor,
the model layout) and the float32 scratch that carries the chunk states
between the kernels, launches on the current stream, raises if any of
the launches failed, and counts one launch per scan in the module-level
``launches``. Its plain version is
:func:`repro_torch.kernels.ref.ssd_scan_ref`.

The kernel has no backward, as the Pallas kernel has none: where autograd
records the call, ``ops`` goes through :class:`SsdScan`, whose
``backward`` raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, no_backward
from repro_torch.kernels.ref import ssd_scan_ref

NAME = "ssd_scan"
BC_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 256

#: Kernel launches made by :func:`ssd_scan_cuda` in this process.
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load(NAME)
        fn = lib.ssd_scan_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 7
            + [ctypes.c_int64] * 15
            + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib.ssd_scan_scratch_elems.argtypes = [ctypes.c_int] * 6
        lib.ssd_scan_scratch_elems.restype = ctypes.c_int64
        _fn = (fn, lib.ssd_scan_error_string, lib.ssd_scan_scratch_elems)
    return _fn


def build() -> None:
    """Compile (if needed) and load the kernel without launching it."""
    _kernel()


def _check(xdt, da, b_mat, c_mat, chunk):
    for name, t in (("xdt", xdt), ("da", da), ("b_mat", b_mat), ("c_mat", c_mat)):
        if not t.is_cuda:
            raise ValueError(f"ssd_scan_cuda: {name} is not a CUDA tensor")
        if t.dim() != 4:
            raise ValueError(f"ssd_scan_cuda: {name} must be 4-D, got {tuple(t.shape)}")
        if t.device != xdt.device:
            raise ValueError("ssd_scan_cuda: the inputs are on different devices")
        # da is read one value at a time, at any stride.
        if name != "da" and t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"ssd_scan_cuda: {name}'s last dimension must be contiguous")
    if xdt.dtype != torch.float32 or da.dtype != torch.float32:
        raise TypeError("ssd_scan_cuda: xdt and da must be float32")
    if b_mat.dtype not in BC_DTYPES or c_mat.dtype != b_mat.dtype:
        raise TypeError(
            f"ssd_scan_cuda: b_mat is {b_mat.dtype} and c_mat {c_mat.dtype}; both must be "
            f"one of {list(BC_DTYPES)}"
        )
    bsz, h, s, p = xdt.shape
    g, n = b_mat.shape[1], b_mat.shape[3]
    if tuple(da.shape) != (bsz, h, 1, s):
        raise ValueError(f"ssd_scan_cuda: da must be {(bsz, h, 1, s)}, got {tuple(da.shape)}")
    if tuple(b_mat.shape) != (bsz, g, s, n) or c_mat.shape != b_mat.shape:
        raise ValueError(
            f"ssd_scan_cuda: b_mat {tuple(b_mat.shape)} and c_mat {tuple(c_mat.shape)} "
            f"must both be {(bsz, g, s, n)}"
        )
    if g == 0 or h % g != 0:
        raise ValueError(f"ssd_scan_cuda: {h} heads is not a multiple of {g} groups")
    if not (1 <= p <= MAX_P and 1 <= n <= MAX_N and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(
            f"ssd_scan_cuda: headdim {p}, state {n} and chunk {chunk} must be at most "
            f"{MAX_P}, {MAX_N} and {MAX_CHUNK}"
        )


def ssd_scan_cuda(
    xdt: torch.Tensor,    # [B, H, S, P] float32
    da: torch.Tensor,     # [B, H, 1, S] float32
    b_mat: torch.Tensor,  # [B, G, S, N]
    c_mat: torch.Tensor,  # [B, G, S, N]
    *,
    chunk: int = 256,
) -> torch.Tensor:
    """The chunked scan on the card; returns y ``[B, H, S, P]`` float32."""
    global launches
    _check(xdt, da, b_mat, c_mat, chunk)
    bsz, h, s, p = xdt.shape
    g, n = b_mat.shape[1], b_mat.shape[3]
    out = torch.empty((bsz, s, h, p), dtype=torch.float32, device=xdt.device).transpose(1, 2)
    if bsz == 0 or h == 0 or s == 0:
        return out
    fn, err_str, scratch_elems = _kernel()
    scratch = torch.empty((scratch_elems(bsz, h, s, p, n, chunk),), dtype=torch.float32,
                          device=xdt.device)
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        rc = fn(
            xdt.data_ptr(), da.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch.numel() else None,
            bsz, h, g, s, p, n, chunk,
            *xdt.stride()[:3], da.stride(0), da.stride(1), da.stride(3),
            *b_mat.stride()[:3], *c_mat.stride()[:3], *out.stride()[:3],
            BC_DTYPES[b_mat.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"ssd_scan_cuda: launch failed: {err_str(rc).decode()} ({rc})")
    launches += 1
    return out


def ssd_scan(xdt, da, b_mat, c_mat, *, chunk: int = 256) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if xdt.is_cuda:
        return ssd_scan_cuda(xdt, da, b_mat, c_mat, chunk=chunk)
    return ssd_scan_ref(xdt, da, b_mat, c_mat, chunk=chunk)


class SsdScan(torch.autograd.Function):
    """The scan as an autograd node without a gradient.

    ``forward`` runs the kernel on CUDA tensors and the plain version on
    CPU tensors; ``backward`` raises on both, as the Pallas kernel has no
    VJP (:func:`repro_torch.kernels.no_backward`).
    """

    @staticmethod
    def forward(ctx, xdt, da, b_mat, c_mat, chunk):
        return ssd_scan(xdt, da, b_mat, c_mat, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_y):
        raise no_backward(NAME)
