"""The traced run's device slices: torch.profiler over a short stretch of the window.

The profiler starts and stops between two ``step_once`` calls, so every
host span of the slice is whole in it. Device events are kept as (name,
start µs, duration µs); the spans (``record_function`` ranges named
``route``, ``prefill.*``, ``decode_tick`` and ``step_once``) share their
clock. The profiler drops device events at random on the chip's
machine, so a slice without any is taken again (:class:`Slicer`).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

SPAN_NAMES = ("route", "prefill.first_sight", "prefill.replay", "decode_tick", "step_once")


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def union_us(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Slice:
    """One profiled slice, read."""

    def __init__(self, events, ranges, window_s: float, t_bounds, prefills) -> None:
        self.events: List[Tuple[str, float, float]] = events       # device: name, start, dur
        self.ranges: List[Tuple[str, float, float]] = ranges       # host spans: name, start, end
        self.window_s = window_s
        self.t_bounds = t_bounds                                    # (start, end) µs
        self.prefills: List[int] = prefills                          # prompt lengths admitted
        self.busy = union_us([(s, s + d) for _, s, d in events])
        self.busy_s = sum(e - s for s, e in self.busy) / 1e6

    def kernel_us(self, patterns) -> Tuple[float, int]:
        """(device µs, launches) of the kernels whose name holds any pattern."""
        hits = [d for name, _, d in self.events if any(p in name for p in patterns)]
        return sum(hits), len(hits)

    def kernel_us_within(self, patterns, span: str) -> float:
        """Device µs of the matching kernels that started inside a ``span`` range."""
        ranges = sorted((s, e) for name, s, e in self.ranges if name == span)
        total, j = 0.0, 0
        for name, s, d in sorted(self.events, key=lambda ev: ev[1]):
            if not any(p in name for p in patterns):
                continue
            while j < len(ranges) and ranges[j][1] < s:
                j += 1
            if j < len(ranges) and ranges[j][0] <= s <= ranges[j][1]:
                total += d
        return total

    def count(self, span: str) -> int:
        return sum(1 for name, _, _ in self.ranges if name == span)

    def _innermost(self, t: float) -> str:
        best, best_start = "harness", -1.0
        for name, s, e in self.ranges:
            if s <= t <= e and s > best_start:
                best, best_start = name, s
        return best

    def breakdown(self) -> Dict:
        by_name: Dict[str, float] = {}
        for name, _, d in self.events:
            by_name[name] = by_name.get(name, 0.0) + d / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps: Dict[str, float] = {}
        t0, t1 = self.t_bounds
        edges = [(t0, t0)] + self.busy + [(t1, t1)]
        for (_, a), (b, _) in zip(edges, edges[1:]):
            if b > a:
                where = self._innermost((a + b) / 2)
                gaps[where] = gaps.get(where, 0.0) + (b - a) / 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in idle]}


class Slicer:
    """Starts and stops the profiler between steps: one slice at the end of
    the window, stopped at the first step after the window closes, so that
    the profiler's own work at its stop (seconds) falls after the window.
    A slice that holds no device event is taken again at once, in the
    drain (at most twice)."""

    def __init__(self, slice_s: float, ws: float, we: float) -> None:
        self.slice_s = slice_s
        self.start_at: Optional[float] = max(ws, we - slice_s)
        self.stop_at = we
        self.taken: List[tuple] = []     # (events, ranges, bounds, perf start, perf end)
        self.current = None

    @staticmethod
    def warm() -> None:
        """One short session before the window, so that the profiler's first
        start (CUPTI's set-up, seconds) is set-up and not a stall in the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(8, device="cuda" if torch.cuda.is_available() else "cpu").sum()
            _sync()

    def tick(self, now: float) -> None:
        if self.current is not None:
            prof, start = self.current
            if now >= self.stop_at:
                _sync()
                end = time.perf_counter()
                prof.stop()
                self.current = None
                read = _parse(prof)
                self.taken.append(read + (start, end))
                if not read[0] and len(self.taken) < 3:
                    print(f"[profile] a slice of {end - start:.3f} s held no device event; "
                          "another is taken")
                    self.start_at = time.perf_counter()
                    self.stop_at = self.start_at + self.slice_s
            return
        if self.start_at is not None and now >= self.start_at:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            _sync()
            prof.start()
            self.current = (prof, time.perf_counter())
            self.start_at = None

    def close(self) -> None:
        if self.current is not None:
            self.stop_at = 0.0
            self.tick(float("inf"))

    def result(self, spans) -> Optional[Slice]:
        """The first slice that holds device events, read; None if none does."""
        for events, ranges, bounds, start, end in self.taken:
            if events:
                prefills = [info for name, t0, _, info in spans
                            if name.startswith("prefill.") and start <= t0 < end]
                return Slice(events, ranges, end - start, bounds, prefills)
        return None


def _parse(prof) -> tuple:
    """(device events, host spans, time bounds) of a stopped profiler session."""
    import torch

    events, ranges, bounds = [], [], [float("inf"), 0.0]
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        bounds[0], bounds[1] = min(bounds[0], s), max(bounds[1], t)
        if e.name in SPAN_NAMES:
            # the host's range; on the device the same name marks its annotation
            if e.device_type != torch.autograd.DeviceType.CUDA:
                ranges.append((e.name, float(s), float(t)))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            events.append((e.name, float(s), float(t - s)))
    return events, ranges, tuple(bounds)
