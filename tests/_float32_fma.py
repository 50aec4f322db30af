"""A float32 fused multiply-add in torch, as the card's ``fmaf`` computes it.

``fma_f32(a, b, c)`` is ``a * b + c`` rounded once to float32 (to nearest,
ties to even), on any device: the product of two float32 values is exact
in float64, the sum's rounding error is recovered exactly (TwoSum), and the
float64 sum is rounded to odd before its one rounding to float32, which
then equals the single rounding of the exact value (float64 keeps more than
float32's 24 bits plus two). Used by ``tests/test_torch_cuda.py`` to check
the order in which the plain path's einsum sums the conv taps of the
Mamba-2 decode step; ``tests/test_torch_mamba_step.py`` checks it against
exact rational arithmetic. Imported as ``_float32_fma``: pytest puts
``tests/`` on the path (it holds no ``__init__.py``).
"""
import torch


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for float32 tensors (broadcast), rounded once to float32."""
    prod = a.double() * b.double()
    c = c.double()
    s = prod + c
    bb = s - prod
    err = (prod - (s - bb)) + (c - bb)  # s + err == prod + c exactly
    # Round to odd: an inexact sum that landed on an even float64 moves to
    # its neighbour on the side of the exact value.
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()
