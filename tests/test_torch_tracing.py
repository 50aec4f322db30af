"""The serving engine's spans (``repro_torch.runtime.tracing``) and the MoE
layer's count of the experts a decode step reaches
(``repro_torch.models.layers.moe.ExpertCounter``).

The CPU cases drive a tiny engine and its eager decode. The cases marked
``gpu`` capture the decode graph on the card and skip without one; they
import neither JAX nor the JAX package:

    python -m pytest -q -m gpu tests/test_torch_tracing.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.layers import moe  # noqa: E402
from repro_torch.runtime import compiled, tracing  # noqa: E402
from repro_torch.runtime.serve_engine import Replica, Request, ServingEngine  # noqa: E402

torch.set_num_threads(1)

SLOTS, MAX_LEN = 3, 32
DECODE_CHILDREN = ["decode.inputs", "decode.replay", "decode.readback", "decode.commit"]
ADMIT_CHILDREN = ["admit.inputs", "admit.replay", "admit.merge", "admit.readback"]


def _cfg(arch, **kw):
    return dataclasses.replace(smoke_config(arch), n_layers=2, compute_dtype="float32", **kw)


def _params(cfg, device="cpu", seed=0):
    model = Model(cfg)
    return model.cast_params(model.init_params(
        torch.Generator(device=device).manual_seed(seed), device))


def _engine(n_replicas=2, arch="smollm_135m"):
    cfg = _cfg(arch)
    params = _params(cfg)
    engine = ServingEngine()
    engine.add_controller("C", zone="z")
    for i in range(n_replicas):
        engine.add_replica(Replica(f"r{i}", cfg, params, zone="z", slots=SLOTS,
                                   max_len=MAX_LEN))
    return engine, cfg


def _submit(engine, cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [engine.submit(cfg.name, rng.integers(0, cfg.vocab_size, size=3 + i).tolist(),
                          max_new_tokens=4)
            for i in range(n)]


def _children(spans, index):
    return [s for s in spans if s.parent == index]


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------


def test_a_recorder_is_off_and_shared_by_the_engines_replicas():
    engine, _ = _engine()
    assert engine.recorder.on is False
    assert all(rep.recorder is engine.recorder for rep in engine.replicas.values())


def test_off_records_nothing_and_enters_no_profiler_range():
    engine, cfg = _engine()
    reqs = _submit(engine, cfg, 4)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        engine.run_until_done(max_ticks=50)
    assert all(r.state == "done" for r in reqs)
    assert engine.recorder.spans == []
    assert all(r.submitted_at is None for r in reqs)
    names = {e.name for e in prof.events()}
    assert not names & set(tracing.SPAN_NAMES)


def test_on_enters_a_profiler_range_per_span():
    engine, cfg = _engine()
    engine.recorder.on = True
    _submit(engine, cfg, 2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        engine.step_once()
    ranges = [e.name for e in prof.events() if e.name in tracing.SPAN_NAMES]
    spans = [s.name for s in engine.recorder.spans if s.name != tracing.QUEUED]
    assert sorted(ranges) == sorted(spans)


def test_one_step_yields_the_span_tree():
    engine, cfg = _engine()
    rec = engine.recorder
    rec.on = True
    reqs = _submit(engine, cfg, 4)       # 4 requests, 2 replicas of 3 slots: all placed
    assert all(r.submitted_at is not None for r in reqs)
    engine.step_once()
    spans = rec.spans
    assert {s.name for s in spans} <= set(tracing.SPAN_NAMES) | {tracing.QUEUED}
    for i, s in enumerate(spans):
        assert s.t1 is not None and s.t0 <= s.t1
        if s.parent is not None:
            up = spans[s.parent]
            assert s.parent < i and up.t0 <= s.t0 and s.t1 <= up.t1
            assert s.replica == (up.replica or s.replica)
    (root,) = [i for i, s in enumerate(spans) if s.parent is None and s.name != tracing.QUEUED]
    assert spans[root].name == "engine.step"
    top = [s.name for s in _children(spans, root)]
    assert top == ["engine.heartbeats", "engine.route", "replica.step", "replica.step",
                   "engine.complete", "engine.stragglers"]
    (route,) = [i for i, s in enumerate(spans) if s.name == "engine.route"]
    assert spans[route].info == 4
    admits = [i for i, s in enumerate(spans) if s.name == "replica.admit"]
    assert [spans[i].parent for i in admits] == [route] * 4
    assert sorted(spans[i].request for i in admits) == [r.request_id for r in reqs]
    for i in admits:
        admit = spans[i]
        req = reqs[admit.request]
        assert admit.replica == req.replica and admit.info == len(req.tokens)
        kids = _children(spans, i)
        assert [k.name for k in kids] == ADMIT_CHILDREN
        assert all(k.request == admit.request and k.replica == admit.replica for k in kids)
    queued = [s for s in spans if s.name == tracing.QUEUED]
    assert sorted(q.request for q in queued) == [r.request_id for r in reqs]
    for q in queued:
        (admit,) = [spans[i] for i in admits if spans[i].request == q.request]
        assert q.parent is None and q.t0 == reqs[q.request].submitted_at
        assert q.t0 <= q.t1 <= admit.t0 and q.replica == admit.replica
    steps = [i for i, s in enumerate(spans) if s.name == "replica.step"]
    assert sorted(spans[i].replica for i in steps) == ["r0", "r1"]
    for i in steps:
        assert spans[i].request is None
        assert spans[i].info == len(engine.replicas[spans[i].replica].active)
        assert [k.name for k in _children(spans, i)] == DECODE_CHILDREN


def test_a_replica_reports_its_cache_by_kind_and_a_merge_its_bytes():
    """A hybrid replica holds K/V, conv windows and SSM states side by side;
    each admission's ``admit.merge`` copies one slot's worth of all three."""
    cfg = dataclasses.replace(smoke_config("jamba_1_5_large_398b"), n_layers=8,
                              compute_dtype="float32")
    engine = ServingEngine()
    engine.add_controller("C", zone="z")
    rep = Replica("r0", cfg, _params(cfg), zone="z", slots=SLOTS, max_len=MAX_LEN)
    engine.add_replica(rep)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    per_slot = {
        "kv": 2 * MAX_LEN * cfg.n_kv_heads * cfg.head_dim * 4,
        "conv": 7 * (cfg.ssm_conv - 1) * conv_dim * 4,
        "ssm": 7 * cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4,
    }
    assert rep.cache_bytes == {k: SLOTS * v for k, v in per_slot.items()}
    assert tracing.cache_bytes(rep.cache) == rep.cache_bytes
    engine.recorder.on = True
    _submit(engine, cfg, 2)
    engine.step_once()
    merges = [s for s in engine.recorder.spans if s.name == "admit.merge"]
    assert [s.info for s in merges] == [sum(per_slot.values())] * 2
    dense = _cfg("smollm_135m")
    kv_only = Replica("d", dense, _params(dense), slots=SLOTS, max_len=MAX_LEN).cache_bytes
    assert kv_only["conv"] == kv_only["ssm"] == 0 and kv_only["kv"] > 0


def test_tick_times_and_spans_share_the_clock():
    engine, cfg = _engine(n_replicas=1)
    engine.recorder.on = True
    _submit(engine, cfg, 2)
    engine.step_once()
    rep = engine.replicas["r0"]
    (step,) = [s for s in engine.recorder.spans if s.name == "replica.step"]
    assert 0 < step.t1 - step.t0 <= rep.tick_times[-1]


def test_a_span_closes_when_its_body_raises():
    rec = tracing.Recorder()
    with pytest.raises(KeyError):
        with rec.span("engine.step"):
            with rec.span("engine.route", info=1):
                raise KeyError("x")
    assert [s.t1 is not None for s in rec.spans] == [True, True]
    assert rec.spans[1].parent == 0


# ---------------------------------------------------------------------------
# The expert counter
# ---------------------------------------------------------------------------


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_a_count_is_three_ops_a_call():
    counter = moe.ExpertCounter("cpu")
    ids = torch.tensor([0, 0, 2, 5, 5, 7])
    with _Ops() as mode:
        counter.add(ids)
    # an allocation, then three kernels: no cast before the sum
    ops = [op.overloadpacket.__name__ for op in mode.ops if not op.is_view]
    assert ops == ["empty", "ne", "sum", "add_"]
    counter.add(torch.tensor([3]))
    assert counter.read() == (4 + 1, 2)
    counter.reset()
    assert counter.read() == (0, 0)


def test_a_dense_replica_has_nothing_to_count():
    cfg = _cfg("smollm_135m")
    rep = Replica("r", cfg, _params(cfg), slots=SLOTS, max_len=MAX_LEN, count_experts=True)
    assert rep.experts is None and rep._decode == rep.model.decode


def _drive(rep, steps=6, seed=0):
    """Three requests admitted, then ``steps`` decode steps; each step's logits."""
    rng = np.random.default_rng(seed)
    for i in range(3):
        prompt = rng.integers(0, rep.cfg.vocab_size, size=4 + i).astype(np.int32)
        assert rep.admit(Request(i, rep.cfg.name, prompt, max_new_tokens=20), placement=None)
    decode, logs = rep._decode, []

    def call(*args):
        logits, cache = decode(*args)
        logs.append(logits.clone())
        return logits, cache

    rep._decode = call
    for _ in range(steps):
        rep.step()
    return logs


def test_the_armed_counter_equals_a_count_of_the_routed_experts(monkeypatch):
    cfg = _cfg("phi3_5_moe_42b")
    rep = Replica("r", cfg, _params(cfg), slots=SLOTS, max_len=MAX_LEN, count_experts=True)
    assert rep.experts.read() == (0, 0)
    route, routed, in_step = moe.route, [], [False]

    def recording(*args, **kwargs):
        out = route(*args, **kwargs)
        if in_step[0]:
            routed.append(out[0])
        return out

    monkeypatch.setattr(moe, "route", recording)
    step = rep.step

    def counted_step():
        in_step[0] = True
        try:
            return step()
        finally:
            in_step[0] = False

    rep.step = counted_step
    _drive(rep)
    assert len(routed) == 6 * cfg.n_layers      # every slot, free ones too, every layer
    assert all(ids.shape == (SLOTS, cfg.moe_top_k) for ids in routed)
    want = sum(len(torch.unique(ids)) for ids in routed)
    assert rep.experts.read() == (want, len(routed))
    assert want < len(routed) * cfg.moe_experts  # some call leaves an expert out


def test_the_armed_counter_counts_at_72_experts_top_10(monkeypatch):
    """granite's routing, 8 slots at 72 experts top-10: 80 pairs a call."""
    cfg = dataclasses.replace(smoke_config("granite_4_0_h_small"), n_layers=10, moe_experts=72,
                              moe_top_k=10, compute_dtype="float32")
    rep = Replica("r", cfg, _params(cfg), slots=8, max_len=MAX_LEN, count_experts=True)
    route, routed = moe.route, []

    def recording(*args, **kwargs):
        out = route(*args, **kwargs)
        routed.append(out[0])
        return out

    monkeypatch.setattr(moe, "route", recording)
    rng = np.random.default_rng(1)
    for i in range(5):
        prompt = rng.integers(0, cfg.vocab_size, size=4 + i).astype(np.int32)
        assert rep.admit(Request(i, cfg.name, prompt, max_new_tokens=20), placement=None)
    routed.clear()                       # the prefills', which are not counted
    for _ in range(4):
        rep.step()
    assert len(routed) == 4 * cfg.n_layers
    assert all(ids.shape == (8, 10) for ids in routed)
    want = sum(len(torch.unique(ids)) for ids in routed)
    assert rep.experts.read() == (want, len(routed))
    assert 10 < want / len(routed) < 72


def test_unarmed_decode_is_bit_identical_and_counts_nothing():
    cfg = _cfg("phi3_5_moe_42b")
    params = _params(cfg)
    armed = Replica("a", cfg, params, slots=SLOTS, max_len=MAX_LEN, count_experts=True)
    plain = Replica("p", cfg, params, slots=SLOTS, max_len=MAX_LEN)
    assert plain.experts is None and plain._decode == plain.model.decode
    idle = moe.ExpertCounter("cpu")
    a, p = _drive(armed), _drive(plain)
    assert len(a) == len(p) == 6
    for x, y in zip(a, p):
        assert torch.equal(x, y)
    assert armed.experts.read()[1] == 6 * cfg.n_layers
    assert idle.read() == (0, 0) and int(idle.boundaries) == 0


def test_prefills_are_not_counted():
    cfg = _cfg("phi3_5_moe_42b")
    rep = Replica("r", cfg, _params(cfg), slots=SLOTS, max_len=MAX_LEN, count_experts=True)
    assert rep.admit(Request(0, cfg.name, np.arange(1, 9, dtype=np.int32)), placement=None)
    assert rep.experts.read() == (0, 0)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph, and nvcc to build the kernels)")
    from repro_torch.kernels import _build

    _build.build_all()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("use_kernels", [True, False])
def test_the_armed_graph_counts_as_the_eager_decode(cuda_device, use_kernels):
    """Armed and unarmed graphs and an armed eager decode, one params dict: the
    same logits bit for bit, the same launches a replay, and the graph's count
    equal to the eager one's."""
    cfg = _cfg("phi3_5_moe_42b", use_kernels=use_kernels)
    params = _params(cfg, cuda_device)
    armed = Replica("a", cfg, params, slots=SLOTS, max_len=MAX_LEN, count_experts=True)
    plain = Replica("p", cfg, params, slots=SLOTS, max_len=MAX_LEN)
    eager = Replica("e", cfg, params, slots=SLOTS, max_len=MAX_LEN, count_experts=True)
    eager._decode = compiled.counted(eager.model.decode, eager.experts)
    assert isinstance(armed._decode, compiled.CompiledDecode) and plain._decode.experts is None
    assert armed._decode.launches == plain._decode.launches
    assert armed._decode.moe_calls == cfg.n_layers and plain._decode.moe_calls == 0
    assert armed.experts.read() == (0, 0)          # the warm-up's counts are gone
    a, p, e = _drive(armed), _drive(plain), _drive(eager)
    for x, y in zip(a, p):
        assert torch.equal(x, y)
    for x, y in zip(a, e):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
    assert armed.experts.read() == eager.experts.read()
    assert armed.experts.read()[1] == 6 * cfg.n_layers


@pytest.mark.gpu
def test_an_armed_graph_holds_three_more_kernels_a_moe_call(cuda_device):
    """The device kernels of one replay, armed against unarmed (both replicas
    captured before the profiler runs)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg("phi3_5_moe_42b", use_kernels=True)
    params = _params(cfg, cuda_device)
    reps = {name: Replica(name, cfg, params, slots=SLOTS, max_len=MAX_LEN, count_experts=arm)
            for name, arm in (("armed", True), ("plain", False))}
    tokens = torch.zeros((SLOTS,), dtype=torch.int32, device=cuda_device)
    for rep in reps.values():
        rep._decode(rep.params, rep.cache, tokens, tokens)
    torch.cuda.synchronize()
    kernels = {}
    for name, rep in reps.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rep._decode(rep.params, rep.cache, tokens, tokens)
            torch.cuda.synchronize()
        kernels[name] = sum(1 for ev in prof.events()
                            if ev.device_type == torch.autograd.DeviceType.CUDA
                            and "Memcpy" not in ev.name and "Memset" not in ev.name)
    assert kernels["plain"] > 0
    assert kernels["armed"] - kernels["plain"] == 3 * cfg.n_layers
