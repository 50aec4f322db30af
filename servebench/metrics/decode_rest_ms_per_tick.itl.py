"""decode_rest_ms_per_tick.itl: device ms per replica decode step outside the grouped matmul.

Read in the profiled slice: every device operation (kernels and the
step's copies) that started inside a decode step, less the grouped-matmul
kernels that ``gmm_ms_per_tick.itl`` reads, over the same decode steps.
The two add up to the step's device time. In a hybrid model's decode
this is mostly the Mamba-2 mixers, the router and the shared expert.
"""
from servebench.readers import kernel_ms_per_tick

GMM = ("gmm",)


def read(ctx):
    total = kernel_ms_per_tick(ctx, ("",))
    if total is None:
        return None
    return total - kernel_ms_per_tick(ctx, GMM)
