"""Readers shared by the metric files of ``servebench/metrics/``.

Each reads a :class:`servebench.harness.Context` and returns a number, or
None where the run holds nothing to read (the harness then leaves the
metric out of the line).
"""
from __future__ import annotations

from typing import Optional

from servebench import roofline, stats


def ttft_p95_ms(ctx) -> Optional[float]:
    return 1e3 * stats.percentile(stats.ttfts(ctx.records), 95) if ctx.records else None


def itl_p95_ms(ctx) -> Optional[float]:
    gaps = stats.pooled_gaps(ctx.records)
    return 1e3 * stats.percentile(gaps, 95) if gaps else None


def output_tokens_per_s(ctx) -> Optional[float]:
    ws, we = ctx.window
    return stats.tokens_in(ctx.all_records, ws, we) / (we - ws)


def setup_s(ctx) -> float:
    return ctx.setup_s


def route_us_per_request(ctx) -> Optional[float]:
    """Host µs inside ``invoke_batch``, less the ``admit`` calls it makes
    back, per invocation routed (a request routed again while queued
    counts each time)."""
    routed = sum(info for name, _, _, info in ctx.spans if name == "route")
    if not routed:
        return None
    route = sum(t1 - t0 for name, t0, t1, _ in ctx.spans if name == "route")
    admit = sum(t1 - t0 for name, t0, t1, _ in ctx.spans if name.startswith("prefill."))
    return 1e6 * (route - admit) / routed


def decode_tick_ms(ctx) -> Optional[float]:
    """Mean of the window's ``Replica.tick_times`` (one replica's decode
    step, host clock, ending in the step's device sync), ms."""
    if not ctx.tick_times:
        return None
    return 1e3 * sum(ctx.tick_times) / len(ctx.tick_times)


def mfu_decode(ctx) -> Optional[float]:
    """Model FLOPs of the active slots' decode tokens (the configuration's
    module counts them) over the window's decode steps' time at the bf16
    peak, per cent."""
    flops = sum(ctx.reference.decode_token_flops(ctx.cfg, pos)
                for name, _, _, positions in ctx.spans if name == "decode_tick"
                for pos in positions)
    secs = sum(t1 - t0 for name, t0, t1, _ in ctx.spans if name == "decode_tick")
    if not flops or not secs:
        return None
    return 100.0 * flops / (secs * roofline.PEAK_FLOPS_BF16)


def mfu_prefill(ctx) -> Optional[float]:
    """Model FLOPs of the window's prefills (the configuration's module counts
    them) over their ``Replica.prefill_times`` at the bf16 peak, per cent."""
    if not ctx.prefill_times:
        return None
    flops = sum(ctx.reference.prefill_flops(ctx.cfg, s) for s, _ in ctx.prefill_times)
    secs = sum(t for _, t in ctx.prefill_times)
    return 100.0 * flops / (secs * roofline.PEAK_FLOPS_BF16)


def kernel_roofline(ctx, patterns, bound_s_of_prefill) -> Optional[float]:
    """Per cent: the least time of the slice's prefills' calls of a kernel
    over the device time of the kernels whose names hold ``patterns``."""
    sl = ctx.device
    if sl is None or not sl.prefills:
        return None
    device_us, launches = sl.kernel_us(patterns)
    if not launches:
        return None
    bound_s = sum(bound_s_of_prefill(ctx.cfg, s) for s in sl.prefills)
    return 100.0 * bound_s / (device_us / 1e6)


def kernel_ms_per_tick(ctx, patterns) -> Optional[float]:
    """Device ms of the matching kernels that ran inside decode steps, per
    replica decode step, in the profiled slice."""
    sl = ctx.device
    if sl is None:
        return None
    ticks = sl.count("decode_tick")
    if not ticks:
        return None
    return sl.kernel_us_within(patterns, "decode_tick") / 1e3 / ticks


def device_idle_share(ctx) -> Optional[float]:
    """Per cent of the profiled slice in which no device operation ran."""
    sl = ctx.device
    if sl is None or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
