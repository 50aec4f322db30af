"""The arithmetic of the end-to-end metrics, the spreads and the knee."""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence

INF = float("inf")


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100), linear between closest ranks, as
    numpy's default. A missing latency is ``inf``: it sorts last, and a
    percentile that reaches it is ``inf``."""
    if not values:
        return math.nan
    xs = sorted(values)
    rank = (len(xs) - 1) * q / 100.0
    lo = math.floor(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    if frac == 0 or xs[lo] == xs[hi]:
        return xs[lo]
    if math.isinf(xs[hi]):
        return INF
    return xs[lo] + (xs[hi] - xs[lo]) * frac


def ttfts(records: Sequence[Dict]) -> List[float]:
    """Due time → first token, seconds, of each request; ``inf`` where it failed."""
    return [INF if r["failed"] else r["stamps"][0] - r["due"] for r in records]


def pooled_gaps(records: Sequence[Dict]) -> List[float]:
    """Every gap between consecutive output tokens of every request, pooled.
    A failed request misses each of its gaps (``inf``)."""
    out: List[float] = []
    for r in records:
        if r["failed"]:
            out.extend([INF] * max(1, r["max_new_tokens"] - 1))
        else:
            s = r["stamps"]
            out.extend(b - a for a, b in zip(s, s[1:]))
    return out


def tokens_in(records: Sequence[Dict], start: float, end: float) -> int:
    """Output tokens completed in [start, end) over all requests."""
    return sum(1 for r in records for t in r["stamps"] if start <= t < end)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles as a share of the median
    (``statistics.quantiles(values, n=4)``, Python's default method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def knee(points: Sequence[Dict]) -> Optional[float]:
    """The highest offered rate at which the queue at the end of the window
    was no longer than at its start, below the first rate at which it grew
    (``points``: rate, queue_start, queue_end)."""
    best = None
    for p in sorted(points, key=lambda p: p["rate"]):
        if p["queue_end"] > p["queue_start"]:
            break
        best = p["rate"]
    return best
