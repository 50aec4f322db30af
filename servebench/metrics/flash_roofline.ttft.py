"""flash_roofline.ttft: the flash-attention kernel's share of its roofline in the profiled slice.

The least H100 time of every prefill's attention calls in the slice (one
causal call per attention layer, as many as the configuration's module's
``attention_layers`` gives: Q, K, V read once, O written once, the score
pairs the mask keeps; ``servebench.roofline.flash_bound_s``) over the
device time of the kernels whose names hold a pattern below. The work
comes from each prefill's length and the model's heads, so it reads the
same whatever implements the attention.
"""
from servebench import readers, roofline

PATTERNS = ("flash_fwd",)


def read(ctx):
    layers = ctx.reference.attention_layers(ctx.cfg)
    return readers.kernel_roofline(ctx, PATTERNS,
                                   lambda cfg, s: layers * roofline.flash_bound_s(cfg, s))
