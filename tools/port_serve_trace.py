#!/usr/bin/env python3
"""The serving engine's spans and expert counts over one cell of the serving benchmark.

    python3 tools/port_serve_trace.py CELL SEED [--seconds S] [--root DIR] [--device cpu]

Runs the cell once as ``servebench/run.py --trace 1`` does
(``servebench.harness.run``: the harness's own spans and, on the card, a
profiler slice at the window's end), and in the same process:

* turns the engine's recorder on at the window's start
  (``ServingEngine.recorder``, :mod:`repro_torch.runtime.tracing`);
* arms every replica's expert counter before its decode step is captured
  (``Replica(count_experts=True)``), and reads the counters where the
  profiler slice starts and stops, both times after a synchronise;
* keeps the program's ranges in the slice, by their names
  (``tracing.SPAN_NAMES``): each idle gap is charged to the innermost
  range, the program's included, and their device annotations are not
  counted as device work.

The benchmark's files are not changed: the tool sets this up in its own
process by replacing ``harness.install_spans``, ``devtrace.Slicer``,
``devtrace.SPAN_NAMES`` and the ``Replica`` that ``harness.build`` makes.

Prints the run's ``[run]`` line and result, then one ``[trace]`` JSON
line: the readings below, each over the spans that started in the window
(the slice's, for the device ones), and the slice's idle seconds by
innermost range.

* ``decode_host_ms``: mean of ``replica.step`` less its ``decode.readback``;
  ``admit_host_ms``: mean of ``replica.admit`` less its ``admit.readback``.
* ``ttft_tail_queued_ms``, ``ttft_tail_hold_ms``: over the window's
  requests whose time from submit to the end of the engine step that
  admitted them is at least that time's 95th percentile, the mean of
  submit → start of the placing admission, and of the end of its
  ``admit.readback`` (the first token known) → the end of that
  ``engine.step`` (the token handed out).
* ``gmm_roofline`` (%): the least H100 time of the bytes the slice's
  decode MoE calls need (gate, up and down of each reached expert, and
  each call's ``[E, C, d]``/``[E, C, f]`` activations in and out) over the
  device time of the ``gmm`` kernels started inside a ``replica.step``.
* ``cache_bytes``: each replica's cache by kind (``Replica.cache_bytes``:
  attention's K/V, the Mamba-2 conv windows and SSM states);
  ``merge_bytes``: the bytes each window admission's ``admit.merge``
  copied into its slot (its ``info``; one value a replica's
  configuration), and ``merge_ms`` their mean time.
* ``decode_launches``: each replica's ``Replica.decode_launches``, the
  hand-written kernels' launches one replay of its decode graph makes
  (``mamba_step``: one fused Mamba-2 step a Mamba-2 layer);
  ``decode_step_kernels``: each replica's median count of device kernels
  (copies and fills left out) started inside its ``replica.step`` ranges
  in the slice: the graph's kernels and the step's argmax.
* ``replays_per_loop``: {replicas whose decode step replayed in an
  engine loop: loops} over the window.
* ``span_ms``: mean ms of each span name; ``slice_span_ms`` and
  ``slice_decode_host_ms`` the same over the profiler slice alone (the
  profiler slows the host); ``experts_per_call``, and
  ``experts_skipped_per_call`` (the experts of a call that no token
  reached, whose weights the gmm kernel does not read).
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PEAK_BYTES_PER_S = 3.35e12


def in_window(span, ws, we) -> bool:
    return ws <= span.t0 < we


def host_ms(spans, name, wait, ws, we):
    """Mean ms of the window's ``name`` spans, each less its ``wait`` child."""
    waits = {s.parent: s.t1 - s.t0 for s in spans if s.name == wait}
    values = [s.t1 - s.t0 - waits.get(i, 0.0) for i, s in enumerate(spans)
              if s.name == name and in_window(s, ws, we)]
    return 1e3 * statistics.fmean(values) if values else None


def span_ms(spans, ws, we):
    """{span name: mean ms} over the window."""
    by_name = {}
    for s in spans:
        if in_window(s, ws, we):
            by_name.setdefault(s.name, []).append(s.t1 - s.t0)
    return {name: 1e3 * statistics.fmean(v) for name, v in sorted(by_name.items())}


def _root(spans, i):
    while spans[i].parent is not None:
        i = spans[i].parent
    return spans[i]


def ttft_tail(spans, queued_name, ws, we, q=95.0):
    """(queued ms, hold ms) means over the window's requests at or above the
    ``q``-th percentile of submit → end of the admitting ``engine.step``."""
    from servebench import stats

    admits = {}
    for i, s in enumerate(spans):
        if s.name == "replica.admit":
            admits.setdefault(s.request, []).append(i)
    readback = {s.parent: s for s in spans if s.name == "admit.readback"}
    rows = []
    for s in spans:
        if s.name != queued_name or not in_window(s, ws, we):
            continue
        i = next(i for i in admits[s.request] if spans[i].t0 >= s.t1)
        step = _root(spans, i)
        rows.append((step.t1 - s.t0, s.t1 - s.t0, step.t1 - readback[i].t1))
    if not rows:
        return None, None
    cut = stats.percentile([r[0] for r in rows], q)
    tail = [r for r in rows if r[0] >= cut]
    return (1e3 * statistics.fmean(r[1] for r in tail),
            1e3 * statistics.fmean(r[2] for r in tail))


def gmm_bound_s(cfg, reached, calls, slots) -> float:
    """Least H100 seconds of ``calls`` decode MoE calls over ``slots`` tokens
    that reached ``reached`` experts in all: each reached expert's gate, up
    and down weights read once, each call's activations read and written."""
    d, f, e, k = cfg["d_model"], cfg["d_ff"], cfg["moe_experts"], cfg["moe_top_k"]
    c = max(8, -(-int(cfg["moe_capacity_factor"] * slots * k / e) // 8) * 8)
    nbytes = 2 * (reached * 3 * d * f + calls * 3 * e * c * (d + f))
    return nbytes / PEAK_BYTES_PER_S


def step_kernels(sl, spans, start, end):
    """{replica: median device kernels started inside its ``replica.step``
    ranges of the slice}, copies and fills left out: the slice's ranges
    matched in order to the recorder's spans of the slice (None where their
    numbers differ)."""
    steps = sorted((s for s in spans if s.name == "replica.step" and start <= s.t0 < end),
                   key=lambda s: s.t0)
    ranges = sorted((s, e) for name, s, e in sl.ranges if name == "replica.step")
    if not steps or len(steps) != len(ranges):
        return None
    starts = sorted(s for name, s, _ in sl.events if "Memcpy" not in name and "Memset" not in name)
    by_replica = {}
    for span, (s, e) in zip(steps, ranges):
        n = bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s)
        by_replica.setdefault(span.replica, []).append(n)
    return {name: statistics.median(v) for name, v in sorted(by_replica.items())}


def replays_per_loop(spans, ws, we):
    """{replicas whose decode step replayed: engine loops} over the window's
    ``engine.step`` spans (a ``replica.step`` replays where its ``info``,
    the slots active, is not 0). A token's gap is about the replays of the
    loop that made it, so the share of loops with many sets the ITL tail."""
    loops = {i: 0 for i, s in enumerate(spans) if s.name == "engine.step" and in_window(s, ws, we)}
    for s in spans:
        if s.name == "replica.step" and s.info and s.parent in loops:
            loops[s.parent] += 1
    return dict(sorted(collections.Counter(loops.values()).items()))


def idle_by_range(sl):
    """{innermost range name: idle seconds} of a ``devtrace.Slice``."""
    t0, t1 = sl.t_bounds
    edges = [(t0, t0)] + sl.busy + [(t1, t1)]
    out = {}
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            where = sl._innermost((a + b) / 2)
            out[where] = out.get(where, 0.0) + (b - a) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


class _State:
    def __init__(self):
        self.recorder = None
        self.counters = []
        self.ws = None
        self.reads = []          # (reached, calls) at each slice start and stop
        self.slice = None        # (Slice, perf start, perf end, its two reads)
        self.cache_bytes = {}    # replica name: {kind: bytes}
        self.launches = {}       # replica name: {kernel: launches a decode replay}

    def read_experts(self):
        totals = [c.read() for c in self.counters]
        return (sum(r for r, _ in totals), sum(n for _, n in totals))


def install(state: _State) -> None:
    """Set up the harness's process as the module's docstring says."""
    from servebench import devtrace, harness

    from repro_torch.runtime import serve_engine, tracing

    devtrace.SPAN_NAMES = tuple(devtrace.SPAN_NAMES) + tracing.SPAN_NAMES

    class CountingReplica(serve_engine.Replica):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, count_experts=True, **kwargs)

    serve_engine.Replica = CountingReplica
    install_spans = harness.install_spans

    def at_window_start(dep):
        spans = install_spans(dep)
        state.recorder = dep.engine.recorder
        state.recorder.on = True
        state.counters = [rep.experts for rep in dep.replicas if rep.experts is not None]
        state.cache_bytes = {rep.name: rep.cache_bytes for rep in dep.replicas}
        state.launches = {rep.name: rep.decode_launches for rep in dep.replicas}
        state.ws = time.perf_counter()
        return spans

    harness.install_spans = at_window_start

    class Slicer(devtrace.Slicer):
        def tick(self, now):
            if self.current is None and self.start_at is not None and now >= self.start_at:
                state.reads.append(state.read_experts())
            was = self.current
            super().tick(now)
            if was is not None and self.current is None:
                state.reads.append(state.read_experts())

        def result(self, spans):
            sl = super().result(spans)
            for k, (events, _, _, start, end) in enumerate(self.taken):
                if events:
                    state.slice = (sl, start, end, state.reads[2 * k:2 * k + 2])
                    break
            return sl

    devtrace.Slicer = Slicer


def readings(state: _State, cfg, slots, seconds):
    from repro_torch.runtime import tracing

    spans, ws = state.recorder.spans, state.ws
    we = ws + seconds
    queued, hold = ttft_tail(spans, tracing.QUEUED, ws, we)
    out = {
        "decode_host_ms": host_ms(spans, "replica.step", "decode.readback", ws, we),
        "admit_host_ms": host_ms(spans, "replica.admit", "admit.readback", ws, we),
        "ttft_tail_queued_ms": queued, "ttft_tail_hold_ms": hold,
        "span_ms": span_ms(spans, ws, we),
        "spans": len(spans),
        "cache_bytes": state.cache_bytes,
        "decode_launches": state.launches,
        "replays_per_loop": replays_per_loop(spans, ws, we),
    }
    merges = [s for s in spans if s.name == "admit.merge" and in_window(s, ws, we)]
    if merges:
        out["merge_bytes"] = sorted({s.info for s in merges})
        out["merge_ms"] = 1e3 * statistics.fmean(s.t1 - s.t0 for s in merges)
    if state.slice is not None:
        sl, start, end, reads = state.slice
        idle = idle_by_range(sl)
        total = sum(idle.values())
        program = sum(v for k, v in idle.items() if k in tracing.SPAN_NAMES)
        out.update(idle_s=idle, idle_share_program=program / total if total else None,
                   busy_s=sl.busy_s, window_s=sl.window_s,
                   decode_steps_in_slice=sum(1 for s in spans if s.name == "replica.step"
                                             and start <= s.t0 < end),
                   slice_decode_host_ms=host_ms(spans, "replica.step", "decode.readback",
                                                start, end),
                   slice_span_ms=span_ms(spans, start, end),
                   decode_step_kernels=step_kernels(sl, spans, start, end))
        if state.counters and len(reads) == 2:
            reached, calls = (b - a for a, b in zip(*reads))
            gmm_us = sl.kernel_us_within(("gmm",), "replica.step")
            per_call = reached / calls if calls else None
            out.update(experts_per_call=per_call,
                       experts_skipped_per_call=(cfg["moe_experts"] - per_call
                                                 if calls else None),
                       moe_calls_in_slice=calls, gmm_ms_in_steps=gmm_us / 1e3)
            if calls and gmm_us:
                bound = gmm_bound_s(cfg, reached, calls, slots)
                out["gmm_roofline"] = 100.0 * bound / (gmm_us / 1e6)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell")
    ap.add_argument("seed", type=int)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--root", default=str(ROOT), help="the benchmark's root (BENCHMARK.json)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    from servebench import run as bench_run

    for key, path in bench_run.CACHE_DIRS.items():
        os.environ.setdefault(key, str(path))
    import torch

    from servebench import harness

    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
    state = _State()
    install(state)
    cell = harness.load_cell(Path(args.root), args.cell)
    result = harness.run(cell, args.seed, args.seconds, True, device, t_start,
                         log=lambda line: print(line, flush=True))
    result = {k: v for k, v in result.items() if not k.startswith("_")}
    print(json.dumps(bench_run.clean(result)), flush=True)
    out = {"cell": args.cell, "seed": args.seed,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           **readings(state, cell.config["model"], cell.config["deployment"]["slots"],
                      args.seconds)}
    print("[trace] " + json.dumps(bench_run.clean(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
