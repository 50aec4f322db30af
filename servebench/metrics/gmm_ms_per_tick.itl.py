"""gmm_ms_per_tick.itl: device ms of the grouped-matmul kernels per replica decode step.

Read in the profiled slice: the kernels whose names hold a pattern below
and that started inside a decode step. A time and not a roofline share:
the bytes a step needs depend on which experts its tokens reached, which
nothing counts yet.
"""
from servebench import readers

PATTERNS = ("gmm",)


def read(ctx):
    return readers.kernel_ms_per_tick(ctx, PATTERNS)
