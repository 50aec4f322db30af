"""The serving engine's compiled decode step (``repro_torch.runtime.compiled``).

On the CPU a replica decodes eagerly, and the capture's device-agnostic
part, the warm-up then the zeroed cache, is run on a CPU replica: it
leaves the cache as ``init_cache`` made it, and the replica then emits
the tokens of a fresh one and of the JAX engine's replica, whose decode
step is ``jax.jit(model.decode)``.

The cases marked ``gpu`` capture the graph on the card and skip without
one; they import neither JAX nor the JAX package:

    python -m pytest -q -m gpu tests/test_torch_graphs.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.lm import tree_leaves  # noqa: E402
from repro_torch.runtime import compiled  # noqa: E402
from repro_torch.runtime.serve_engine import Replica, Request  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("smollm_135m", "phi3_5_moe_42b", "mamba2_2_7b", "whisper_small")
LM_ARCHS = ARCHS[:3]  # the JAX engine cannot serve enc-dec (see serve_engine.py)
SLOTS, MAX_LEN, NEW = 3, 32, 5
#: (tick of admission, prompt length): the third request waits for the
#: first one's slot, so a slot is refilled between replays.
SCHEDULE = ((0, 4), (1, 7), (2, 3), (5, 6))
TICKS = 12
#: The served widths, for the graph-against-eager cases: each family's
#: published config at 2 layers, {case: (cache length, frames, factor on
#: ``SCHEDULE``'s prompt lengths)}, so prompts of up to 392 tokens (168 for
#: whisper, whose decoder holds 448, over one 30 s window of frames).
PUBLISHED = {"smollm_135m/published": (1024, None, 56),
             "phi3_5_moe_42b/published": (1024, None, 56),
             "mamba2_2_7b/published": (1024, None, 56),
             "whisper_small/published": (448, 1500, 24)}


def _cfg(arch, dtype="float32", **kw):
    family, _, width = arch.partition("/")
    config = get_config(family) if width else smoke_config(family)
    return dataclasses.replace(config, n_layers=2, compute_dtype=dtype, **kw)


def _prompts(cfg, seed=0, scale=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=scale * n).astype(np.int32)
            for _, n in SCHEDULE]


def _drive(rep, request_cls, prompts):
    """Admit ``prompts`` on ``SCHEDULE`` and step ``TICKS`` ticks; the outputs."""
    reqs = [request_cls(request_id=i, model_id=rep.cfg.name, tokens=p, max_new_tokens=NEW)
            for i, p in enumerate(prompts)]
    for tick in range(TICKS):
        for (at, _), req in zip(SCHEDULE, reqs):
            if at == tick:
                assert rep.admit(req, placement=None), f"no free slot at tick {tick}"
        rep.step()
    assert all(r.state == "done" for r in reqs)
    return [list(r.output) for r in reqs]


def _replica(cfg, params, name="r", max_len=MAX_LEN, enc_len=12):
    return Replica(name, cfg, params, zone="z", slots=SLOTS, max_len=max_len,
                   enc_len=enc_len if cfg.family == "encdec" else None)


def _params(cfg, device="cpu", seed=0):
    model = Model(cfg)
    return model.cast_params(model.init_params(
        torch.Generator(device=device).manual_seed(seed), device))


# ---------------------------------------------------------------------------
# The CPU
# ---------------------------------------------------------------------------


def test_a_cpu_replica_decodes_eagerly():
    cfg = _cfg("smollm_135m")
    rep = _replica(cfg, _params(cfg))
    assert rep._decode == rep.model.decode


def test_a_cpu_replica_has_no_decode_launches():
    """``Replica.decode_launches`` reads a captured graph's counts; an eager
    decode, and a failed replica, have none."""
    cfg = _cfg("smollm_135m")
    rep = _replica(cfg, _params(cfg))
    assert rep.decode_launches == {}
    rep.fail()
    assert rep.decode_launches == {}


def test_a_capture_needs_a_cuda_device():
    cfg = _cfg("smollm_135m")
    rep = _replica(cfg, _params(cfg))
    with pytest.raises(ValueError, match="CUDA device"):
        compiled.capture(rep)


def test_a_capture_refuses_a_replica_in_use():
    cfg = _cfg("smollm_135m")
    rep = _replica(cfg, _params(cfg))
    assert rep.admit(Request(0, cfg.name, np.arange(1, 5, dtype=np.int32)), placement=None)
    with pytest.raises(RuntimeError, match="active slots"):
        compiled.capture(rep)


@pytest.mark.parametrize("arch", ARCHS)
def test_warm_up_leaves_a_zero_cache_and_the_tokens_unchanged(arch):
    cfg = _cfg(arch)
    params = _params(cfg)
    warmed, fresh = _replica(cfg, params, "warmed"), _replica(cfg, params, "fresh")
    zeros = torch.zeros((SLOTS,), dtype=torch.int32)
    # One decode call writes every slot (K/V at position 0, conv and SSM state).
    warmed.model.decode(params, warmed.cache, zeros, zeros)
    assert any(bool(leaf.any()) for leaf in tree_leaves(warmed.cache))
    compiled.warm_up(warmed.model.decode, params, warmed.cache, zeros, zeros)
    for leaf, want in zip(tree_leaves(warmed.cache), tree_leaves(fresh.cache)):
        assert leaf.dtype == want.dtype and leaf.shape == want.shape
        assert not bool(leaf.any())
    prompts = _prompts(cfg)
    assert _drive(warmed, Request, prompts) == _drive(fresh, Request, prompts)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_warmed_replica_emits_the_jax_engines_tokens(arch):
    """The warmed port replica against the JAX engine's replica (its decode
    ``jax.jit``-compiled), same params (converted), same schedule."""
    import jax

    from repro.configs import smoke_config as jax_smoke_config
    from repro.models import Model as JaxModel
    from repro.runtime.serve_engine import Replica as JaxReplica
    from repro.runtime.serve_engine import Request as JaxRequest
    from repro_torch import convert

    jcfg = dataclasses.replace(jax_smoke_config(arch), n_layers=2, compute_dtype="float32")
    jparams = JaxModel(jcfg).init_params(jax.random.PRNGKey(0))
    jrep = JaxReplica("j", jcfg, jparams, zone="z", slots=SLOTS, max_len=MAX_LEN)
    cfg = _cfg(arch)
    params = Model(cfg).cast_params(convert.to_torch(jax.tree.map(np.asarray, jparams)))
    rep = _replica(cfg, params)
    zeros = torch.zeros((SLOTS,), dtype=torch.int32)
    compiled.warm_up(rep.model.decode, params, rep.cache, zeros, zeros)
    prompts = _prompts(cfg, seed=1)
    assert _drive(rep, Request, prompts) == _drive(jrep, JaxRequest, prompts)


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


def _recording(rep, out):
    """``rep._decode`` wrapped to keep a float32 copy of each tick's logits."""
    decode = rep._decode

    def call(*args):
        logits, cache = decode(*args)
        out.append(logits.float().cpu())
        return logits, cache

    rep._decode = call


def _graph_and_eager(cfg, device, max_len=MAX_LEN, enc_len=12):
    """(graph replica, eager replica) on ``device`` sharing one params dict."""
    params = _params(cfg, device)
    graph = _replica(cfg, params, "graph", max_len, enc_len)
    eager = _replica(cfg, params, "eager", max_len, enc_len)
    assert isinstance(graph._decode, compiled.CompiledDecode)
    eager._decode = eager.model.decode
    return graph, eager


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernels", [True, False])
def test_graph_decode_equals_eager_in_float32(cuda_device, arch, use_kernels):
    """The same kernels in the same order: tokens equal, logits to 1e-5."""
    cfg = _cfg(arch, use_kernels=use_kernels)
    graph, eager = _graph_and_eager(cfg, cuda_device)
    prompts = _prompts(cfg)
    logs = {"graph": [], "eager": []}
    _recording(graph, logs["graph"])
    _recording(eager, logs["eager"])
    assert _drive(graph, Request, prompts) == _drive(eager, Request, prompts)
    assert len(logs["graph"]) == len(logs["eager"]) > 0
    for a, b in zip(logs["graph"], logs["eager"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS + tuple(PUBLISHED))
def test_graph_decode_equals_eager_in_bfloat16(cuda_device, arch):
    cfg = _cfg(arch, "bfloat16", use_kernels=True)
    max_len, enc_len, scale = PUBLISHED.get(arch, (MAX_LEN, 12, 1))
    graph, eager = _graph_and_eager(cfg, cuda_device, max_len, enc_len)
    prompts = _prompts(cfg, scale=scale)
    logs = {"graph": [], "eager": []}
    _recording(graph, logs["graph"])
    _recording(eager, logs["eager"])
    assert _drive(graph, Request, prompts) == _drive(eager, Request, prompts)
    err = max(float((a - b).abs().max()) for a, b in zip(logs["graph"], logs["eager"]))
    print(f"{arch} bf16: graph vs eager logits max |diff| {err:.3e}")


@pytest.mark.gpu
def test_graph_decode_with_an_int8_kv_cache(cuda_device):
    cfg = _cfg("smollm_135m", kv_cache_dtype="int8", use_kernels=True)
    graph, eager = _graph_and_eager(cfg, cuda_device)
    assert graph.cache["pos0"]["k"]["q"].dtype == torch.int8
    prompts = _prompts(cfg)
    assert _drive(graph, Request, prompts) == _drive(eager, Request, prompts)


@pytest.mark.gpu
def test_kernel_counts_advance_per_replay_and_not_at_capture(cuda_device):
    from repro_torch.kernels import flash_attention, gmm, ssd_scan

    cfg = _cfg("phi3_5_moe_42b", use_kernels=True)
    params = _params(cfg, cuda_device)
    modules = (flash_attention, gmm, ssd_scan)
    before = [m.launches for m in modules]
    rep = _replica(cfg, params)
    assert [m.launches for m in modules] == before  # warm-up and capture leave them
    per_tick = 3 * cfg.n_layers  # gate, up and down of every MoE layer
    assert rep._decode.launches == {"flash_attention": 0, "gmm": per_tick, "ssd_scan": 0,
                                    "mamba_step": 0}
    tokens = torch.zeros((SLOTS,), dtype=torch.int32, device=cuda_device)
    for tick in range(1, 4):
        rep._decode(rep.params, rep.cache, tokens, tokens)
        assert gmm.launches == before[1] + tick * per_tick
    assert flash_attention.launches == before[0] and ssd_scan.launches == before[2]


def _kernels_of(fn, attempts=3):
    """Device kernels of one profiled ``fn()``: the most of ``attempts``
    sessions (the profiler drops device events at random)."""
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for ev in prof.events()
                          if ev.device_type == torch.autograd.DeviceType.CUDA
                          and "Memcpy" not in ev.name and "Memset" not in ev.name))
    return max(counts)


def _replay_kernels(rep, tokens):
    """Device kernels of one profiled replay."""
    return _kernels_of(lambda: rep._decode(rep.params, rep.cache, tokens, tokens))


@pytest.mark.gpu
def test_the_expert_skip_adds_no_kernel_to_a_replay(cuda_device, monkeypatch):
    """phi with 16 experts, of which a 3-slot step reaches at most 6: a graph
    whose gmm calls take the dispatch's offsets against one captured with
    calls that take none. The same logits bit for bit at every replay, and
    the same kernels a replay (the offsets are the dispatch's own
    searchsorted)."""
    from repro_torch.kernels import ops

    cfg = _cfg("phi3_5_moe_42b", "bfloat16", use_kernels=True, moe_experts=16)
    params = _params(cfg, cuda_device)
    skip = _replica(cfg, params, "skip")
    with_offsets = ops.moe_ffn_gmm
    monkeypatch.setattr(ops, "moe_ffn_gmm",
                        lambda cfg, params, buffer, offsets=None: with_offsets(cfg, params, buffer))
    every = _replica(cfg, params, "every")
    monkeypatch.undo()
    for tick in range(4):
        tokens = torch.tensor([11 * tick + 1, 7 * tick + 2, 5 * tick + 3], dtype=torch.int32,
                              device=cuda_device)
        positions = torch.full((SLOTS,), tick, dtype=torch.int32, device=cuda_device)
        a, _ = skip._decode(skip.params, skip.cache, tokens, positions)
        b, _ = every._decode(every.params, every.cache, tokens, positions)
        assert torch.equal(a, b), tick
    tokens = torch.zeros((SLOTS,), dtype=torch.int32, device=cuda_device)
    kernels = {name: _replay_kernels(rep, tokens) for name, rep in (("skip", skip),
                                                                   ("every", every))}
    print(f"kernels a replay ({cfg.n_layers} MoE layers): {kernels}")
    assert kernels["every"] > 0 and kernels["skip"] == kernels["every"]


def _granite(**kw):
    """granite-4.0-h-small at its depth (20 layers: 18 Mamba-2, attention at 5
    and 15) and its Mamba-2 head shape (P 64, N 128, W 4), the rest narrow:
    8 heads of 64, 8 experts top-2."""
    return dataclasses.replace(get_config("granite_4_0_h_small"), n_layers=20, d_model=256,
                               n_heads=4, n_kv_heads=2, head_dim=64, d_ff=64, moe_experts=8,
                               moe_top_k=2, shared_expert_ff=128, vocab_size=256,
                               compute_dtype="bfloat16", use_kernels=True, **kw)


def _mamba_layers(cfg):
    return cfg.n_periods * sum(mixer == "mamba" for mixer, _ in cfg.layer_pattern())


@pytest.mark.gpu
def test_granite_replay_launches_one_fused_step_a_mamba_layer(cuda_device):
    """``CompiledDecode.launches``, as ``Replica.decode_launches`` reads them:
    18 fused steps a granite replay, 0 a phi one."""
    cfg = _granite()
    assert _mamba_layers(cfg) == 18
    rep = _replica(cfg, _params(cfg, cuda_device))
    assert rep.decode_launches == rep._decode.launches
    assert rep.decode_launches["mamba_step"] == 18
    phi = _cfg("phi3_5_moe_42b", "bfloat16", use_kernels=True)
    assert _replica(phi, _params(phi, cuda_device)).decode_launches["mamba_step"] == 0


@pytest.mark.gpu
def test_the_fused_step_takes_kernels_out_of_a_granite_replay(cuda_device, monkeypatch):
    """A granite graph against one captured with the plain step: a replay
    holds 18 x (the plain layer's kernels - the fused layer's) fewer
    kernels, the fused layer runs 2 kernels between its projections, and
    both graphs emit the same tokens."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.layers import ssm

    cfg = _granite()
    params = _params(cfg, cuda_device)
    fused = _replica(cfg, params, "fused")
    monkeypatch.setattr(ops, "mamba_step", ref.mamba_step_ref)
    plain = _replica(cfg, params, "plain")
    monkeypatch.undo()
    tokens = torch.zeros((SLOTS,), dtype=torch.int32, device=cuda_device)
    replay = {name: _replay_kernels(rep, tokens) for name, rep in (("fused", fused),
                                                                  ("plain", plain))}

    # One layer's step eagerly, fused and plain, and its four projections alone.
    layer = {k: v[0] for k, v in params["blocks"]["pos0"]["mamba"].items()}
    cache = {k: v[0].clone() for k, v in fused.cache["pos0"].items()}
    x = torch.randn((SLOTS, 1, cfg.d_model), device=cuda_device).to(torch.bfloat16)
    with torch.no_grad():
        step = {"fused": _kernels_of(lambda: ssm.apply_mamba_step(cfg, layer, x, cache))}
        monkeypatch.setattr(ops, "mamba_step", ref.mamba_step_ref)
        step["plain"] = _kernels_of(lambda: ssm.apply_mamba_step(cfg, layer, x, cache))
        monkeypatch.undo()
        cdt = torch.bfloat16

        def projections():
            z, _, _ = ssm._in_proj(cfg, layer, x[:, 0, :], cdt)
            return z @ layer["out_proj"].to(cdt)

        proj = _kernels_of(projections)
    print(f"kernels a replay {replay}; a layer's step {step}, its projections {proj}")
    assert step["fused"] - proj == 2
    assert replay["plain"] - replay["fused"] == 18 * (step["plain"] - step["fused"]) > 0
    for tick in range(3):
        tok = torch.tensor([11 * tick + 1, 7 * tick + 2, 5 * tick + 3], dtype=torch.int32,
                           device=cuda_device)
        positions = torch.full((SLOTS,), tick, dtype=torch.int32, device=cuda_device)
        a, _ = fused._decode(fused.params, fused.cache, tok, positions)
        b, _ = plain._decode(plain.params, plain.cache, tok, positions)
        assert torch.equal(a.float().argmax(-1), b.float().argmax(-1)), tick


@pytest.mark.gpu
def test_a_capture_on_a_replica_in_use_raises(cuda_device):
    cfg = _cfg("smollm_135m", use_kernels=True)
    rep = _replica(cfg, _params(cfg, cuda_device))
    assert rep.admit(Request(0, cfg.name, np.arange(1, 5, dtype=np.int32)), placement=None)
    with pytest.raises(RuntimeError, match="active slots"):
        compiled.capture(rep)


@pytest.mark.gpu
def test_the_bound_params_and_cache_are_checked(cuda_device):
    cfg = _cfg("smollm_135m", use_kernels=True)
    rep = _replica(cfg, _params(cfg, cuda_device))
    tokens = torch.zeros((SLOTS,), dtype=torch.int32, device=cuda_device)
    other = rep.model.init_cache(SLOTS, MAX_LEN, device=cuda_device)
    with pytest.raises(ValueError, match="bound"):
        rep._decode(rep.params, other, tokens, tokens)
