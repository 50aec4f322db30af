"""TF32 arithmetic in numpy, as the port's kernels run it on Hopper's tensor cores.

Shared by the design tests of the SSD scan and of the float32 flash
attention and grouped matmul (``tests/test_torch_ssd_design.py``,
``tests/test_torch_f32_kernel_design.py``); ``csrc/tf32.cuh`` is the
kernels' side.
"""
import numpy as np


def tf32_round(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: the kernel's ``(bits + 0x1000) & 0xffffe000``."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_trunc(x):
    """float32 as the tensor core reads it in a TF32 product: low 13 bits dropped."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """(hi, lo) as the tensor core reads them: hi = x rounded to TF32, lo =
    x - hi with its low bits dropped."""
    hi = tf32_round(x)
    return hi, tf32_trunc(np.asarray(x, dtype=np.float32) - hi)


def matmul(a, b, mode):
    """``a @ b`` as the kernel's tensor cores compute it, in one step.

    "exact": float64. "3xtf32": hi = tf32(x), lo = x - hi, and
    hi·hi + hi·lo + lo·hi with float32 sums (products of TF32 values are
    exact in float32). "tf32": one product of rounded operands.
    """
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    if mode == "exact":
        return a.astype(np.float64) @ b.astype(np.float64)
    if mode == "tf32":
        return tf32_round(a) @ tf32_round(b)
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return (a_hi @ b_lo + a_lo @ b_hi) + a_hi @ b_hi


def mma_steps(acc, a, b, mode, depth=8):
    """``acc + a @ b`` as a chain of m16n8k8 steps of ``depth`` k each, in
    order of k: per step acc += hi·lo, then lo·hi, then hi·hi in 3xTF32
    (``mma_3xtf32``), one rounded product in TF32, a float64 product in
    "exact". float32 accumulators except in "exact"."""
    dtype = np.float64 if mode == "exact" else np.float32
    acc = np.asarray(acc, dtype=dtype).copy()
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    for k0 in range(0, a.shape[-1], depth):
        ak, bk = a[..., k0:k0 + depth], b[k0:k0 + depth]
        if mode == "exact":
            acc += ak.astype(np.float64) @ bk.astype(np.float64)
        elif mode == "tf32":
            acc += tf32_round(ak) @ tf32_round(bk)
        else:
            a_hi, a_lo = split(ak)
            b_hi, b_lo = split(bk)
            acc += a_hi @ b_lo
            acc += a_lo @ b_hi
            acc += a_hi @ b_hi
    return acc
