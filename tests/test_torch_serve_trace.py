"""``tools/port_serve_trace.py``: the engine's spans and expert counts over a
serving-benchmark cell.

Its readings on hand-made spans and slices, then whole traced runs of two
cells at a tiny size on the CPU, in a subprocess (the tool replaces parts
of the harness in its own process).
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.runtime.tracing import QUEUED, Span  # noqa: E402
from servebench import devtrace  # noqa: E402
from servebench.tests.test_servebench_run import make_tiny_root  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("port_serve_trace",
                                               ROOT / "tools" / "port_serve_trace.py")
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)


def _engine_step(t0, request, queued_at, admit, readback_end, t1, replica="r0"):
    """One engine step admitting ``request``: engine.step > engine.route >
    replica.admit > admit.readback, then replica.step > decode.readback."""
    return [
        Span(QUEUED, queued_at, admit[0], None, replica, request),
        Span("engine.step", t0, t1, None),
        Span("engine.route", t0 + 0.001, admit[1] + 0.001, 1),
        Span("replica.admit", admit[0], admit[1], 2, replica, request, 8),
        Span("admit.readback", readback_end - 0.002, readback_end, 3, replica, request),
        Span("replica.step", admit[1] + 0.002, t1 - 0.001, 1, replica, None, 1),
        Span("decode.readback", t1 - 0.004, t1 - 0.0015, 5, replica),
    ]


def _reindexed(groups):
    """Steps made separately, concatenated with their parents shifted."""
    out = []
    for group in groups:
        base = len(out)
        out += [Span(s.name, s.t0, s.t1, None if s.parent is None else s.parent + base,
                     s.replica, s.request, s.info) for s in group]
    return out


def test_host_ms_is_a_span_less_its_wait():
    spans = _reindexed([
        _engine_step(10.0, 0, 9.99, (10.002, 10.006), 10.006, 10.020),
        _engine_step(10.1, 1, 10.05, (10.102, 10.110), 10.110, 10.130),
    ])
    # replica.step 0.011 less 0.0025; 0.017 less 0.0025
    assert tool.host_ms(spans, "replica.step", "decode.readback", 0, 99) == \
        pytest.approx(1e3 * (0.0085 + 0.0145) / 2)
    assert tool.host_ms(spans, "replica.admit", "admit.readback", 0, 99) == \
        pytest.approx(1e3 * (0.002 + 0.006) / 2)
    # the window holds the second step only
    assert tool.host_ms(spans, "replica.step", "decode.readback", 10.05, 99) == \
        pytest.approx(14.5)
    assert tool.host_ms(spans, "replica.step", "decode.readback", 11, 12) is None


def test_ttft_tail_reads_the_slowest_requests_queue_and_hold():
    groups = [_engine_step(10.0 + i, i, 10.0 + i - 0.001, (10.002 + i, 10.004 + i),
                           10.004 + i, 10.010 + i) for i in range(19)]
    # the slowest request: queued 50 ms, then held 30 ms after its first token
    groups.append(_engine_step(40.0, 19, 39.95, (40.0, 40.005), 40.005, 40.035))
    queued, hold = tool.ttft_tail(_reindexed(groups), QUEUED, 0, 99)
    assert queued == pytest.approx(50.0) and hold == pytest.approx(30.0)
    assert tool.ttft_tail(_reindexed(groups), QUEUED, 100, 101) == (None, None)


def test_gmm_bound_counts_the_reached_experts_weights():
    cfg = {"d_model": 4096, "d_ff": 6400, "moe_experts": 16, "moe_top_k": 2,
           "moe_capacity_factor": 1.25}
    # 4 slots: C = 8; 8 calls reaching 7 experts each
    weights = 56 * 3 * 4096 * 6400 * 2
    acts = 8 * 3 * 16 * 8 * (4096 + 6400) * 2
    assert tool.gmm_bound_s(cfg, 56, 8, 4) == pytest.approx((weights + acts) / 3.35e12)
    assert tool.gmm_bound_s(cfg, 112, 8, 4) > 1.9 * tool.gmm_bound_s(cfg, 56, 8, 4)


def test_idle_is_charged_to_the_innermost_program_span():
    events = [("k", 0.0, 10.0), ("k", 40.0, 10.0), ("k", 90.0, 10.0)]
    ranges = [("decode_tick", 0.0, 100.0), ("replica.step", 1.0, 99.0),
              ("decode.readback", 45.0, 99.0)]
    sl = devtrace.Slice(events, ranges, 1e-4, (0.0, 100.0), [])
    assert tool.idle_by_range(sl) == {"replica.step": pytest.approx(30e-6),
                                      "decode.readback": pytest.approx(40e-6)}


def test_step_kernels_counts_each_replicas_decode_steps():
    """Device kernels started inside each ``replica.step`` range, copies and
    fills left out, matched in order to the recorder's steps."""
    events = [("k1", 1.0, 1.0), ("k2", 2.0, 1.0), ("Memcpy DtoH", 4.0, 1.0), ("k3", 9.0, 1.0),
              ("k", 15.0, 1.0), ("k1", 21.0, 1.0), ("Memset (Device)", 22.0, 1.0),
              ("k2", 23.0, 1.0), ("k1", 41.0, 1.0)]
    ranges = [("replica.step", 0.0, 10.0), ("replica.step", 20.0, 30.0),
              ("replica.step", 40.0, 50.0)]
    sl = devtrace.Slice(events, ranges, 1e-4, (0.0, 50.0), [])
    spans = [Span("replica.step", 5.0, 5.1, None, "r0", None, 2),
             Span("replica.step", 5.2, 5.3, None, "r1", None, 1),
             Span("replica.step", 5.4, 5.5, None, "r0", None, 2)]
    assert tool.step_kernels(sl, spans, 0, 99) == {"r0": 2, "r1": 2}
    assert tool.step_kernels(sl, spans[:2], 0, 99) is None  # the slice's ranges do not match


def test_replays_per_loop_counts_the_replicas_that_replayed():
    """Loops by how many of their ``replica.step`` children replayed (active
    slots, the ``info``, not 0); a loop outside the window is left out."""
    spans = [Span("engine.step", 1.0, 1.1, None),
             Span("replica.step", 1.01, 1.02, 0, "r0", None, 2),
             Span("replica.step", 1.03, 1.04, 0, "r1", None, 0),
             Span("replica.step", 1.05, 1.06, 0, "r2", None, 1),
             Span("engine.step", 2.0, 2.1, None),
             Span("replica.step", 2.01, 2.02, 4, "r0", None, 0),
             Span("engine.step", 3.0, 3.1, None),
             Span("replica.step", 3.01, 3.02, 6, "r0", None, 3),
             Span("engine.step", 9.0, 9.1, None),
             Span("replica.step", 9.01, 9.02, 8, "r0", None, 3)]
    assert tool.replays_per_loop(spans, 0, 5) == {0: 1, 1: 1, 2: 1}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", ["smollm-chat-poisson", "phi-moe-rag-poisson"])
def test_a_traced_cpu_run_reports_the_host_readings(tiny, cell):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "port_serve_trace.py"), cell, str(2**31 + 7),
         "--seconds", "1.5", "--root", str(tiny), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}", OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    result = json.loads(lines[-2])
    assert result["correct"], result["checks"]
    (trace,) = [json.loads(line[len("[trace] "):]) for line in lines
                if line.startswith("[trace] ")]
    for name in ("decode_host_ms", "admit_host_ms", "ttft_tail_queued_ms",
                 "ttft_tail_hold_ms"):
        assert trace[name] is not None and trace[name] >= 0, name
    assert 0 < trace["decode_host_ms"] < trace["span_ms"]["replica.step"]
    assert 0 < trace["admit_host_ms"] < trace["span_ms"]["replica.admit"]
    # a CPU replica decodes eagerly: no graph, no launches a replay
    assert trace["decode_launches"] and not any(trace["decode_launches"].values())
    assert any(int(n) > 0 for n in trace["replays_per_loop"]), trace["replays_per_loop"]
    # the device readings need the card's profiler slice
    assert "gmm_roofline" not in trace and "idle_s" not in trace
    assert "decode_step_kernels" not in trace
