"""The serving engine's batch-1 prefill and its merge into a slot
(``repro_torch.runtime.compiled``: ``ScratchPrefill``, ``CompiledPrefill``).

The port's replica prefills a prompt into a batch-1 scratch cache and
merges it into the admitted slot, as the JAX engine's replica does with
its ``jax.jit`` prefill into a fresh ``small_cache``
(``repro/runtime/serve_engine.py``). On the CPU the scratch prefill is
eager: the slot caches after each admit are held to the JAX engine's
merged ones, and to the in-place route the port took before (the slot's
views zeroed, then prefilled), in float32 at 1e-5; whisper, which the
JAX engine cannot serve, to JAX ``encdec.prefill`` at the same number of
frames.

The cases marked ``gpu`` capture the prefill graphs on the card and skip
without one; they import neither JAX nor the JAX package:

    python -m pytest -q -m gpu tests/test_torch_prefill_graphs.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.lm import tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime import compiled  # noqa: E402
from repro_torch.runtime.serve_engine import Replica, Request  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("smollm_135m", "phi3_5_moe_42b", "mamba2_2_7b", "whisper_small")
LM_ARCHS = ARCHS[:3]  # the JAX engine cannot serve enc-dec (see serve_engine.py)
SLOTS, MAX_LEN, ENC_LEN = 3, 32, 12
#: (slot freed before the admit, or None; prompt length): slots 0-2 fill,
#: then slot 0 takes a shorter prompt and slot 2 a longer one.
ADMITS = ((None, 9), (None, 5), (None, 7), (0, 4), (2, 11))
TOL = dict(rtol=1e-5, atol=1e-5)
#: The served widths, for the graph-against-eager cases: each family's
#: published config at 2 layers, {case: (cache length, frames, factor on
#: the smoke cases' prompt lengths)}, so prompts of up to 504 tokens (216
#: for whisper, whose decoder holds 448, over one 30 s window of frames).
PUBLISHED = {"smollm_135m/published": (1024, None, 56),
             "phi3_5_moe_42b/published": (1024, None, 56),
             "mamba2_2_7b/published": (1024, None, 56),
             "whisper_small/published": (448, 1500, 24)}


def _cfg(arch, dtype="float32", **kw):
    family, _, width = arch.partition("/")
    if family == "phi3_5_moe_42b":
        kw.setdefault("moe_capacity_factor", 16.0)  # no token dropped at any length here
    config = get_config(family) if width else smoke_config(family)
    return dataclasses.replace(config, n_layers=2, compute_dtype=dtype, **kw)


def _params(cfg, device="cpu", seed=0):
    model = Model(cfg)
    return model.cast_params(model.init_params(
        torch.Generator(device=device).manual_seed(seed), device))


def _replica(cfg, params, name="r"):
    return Replica(name, cfg, params, zone="z", slots=SLOTS, max_len=MAX_LEN,
                   enc_len=ENC_LEN if cfg.family == "encdec" else None)


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=n).astype(np.int32)


def _admit(rep, request_cls, tokens, free=None, rid=0):
    """Admit ``tokens`` after freeing slot ``free``; the slot it took."""
    if free is not None:
        del rep.active[free]
    slot = rep.free_slot()
    assert rep.admit(request_cls(rid, rep.cfg.name, tokens, max_new_tokens=4), placement=None)
    return slot


def _in_place_prefill(rep, slot, tokens):
    """The port's earlier route: the slot's views zeroed, then prefilled in place."""
    slot_cache = tree_map(lambda leaf: leaf[:, slot:slot + 1], rep.cache)
    for leaf in tree_leaves(slot_cache):
        leaf.zero_()
    batch = {"tokens": torch.as_tensor(tokens[None, :], device=rep.device)}
    if rep.cfg.family == "encdec":
        batch["frames"] = torch.zeros((1, rep.enc_len, rep.cfg.d_model), device=rep.device)
    logits, _ = rep.model.prefill(rep.params, batch, slot_cache)
    return logits


def _leaves_close(got, want, **tol):
    """Two cache trees leaf for leaf, matched by key."""
    def close(a, b):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a.float().cpu(), b.float().cpu(), **tol)

    assert len(list(tree_leaves(got))) == len(list(tree_leaves(want)))
    tree_map(close, got, want)


def _slot(cache, slot):
    return tree_map(lambda leaf: leaf[:, slot], cache)


def _jax_pair(arch):
    """(JAX cfg, JAX params, port cfg, port params) on the same weights, float32."""
    import jax

    from repro.configs import smoke_config as jax_smoke_config
    from repro.models import Model as JaxModel

    jcfg = dataclasses.replace(jax_smoke_config(arch), n_layers=2, compute_dtype="float32",
                               **({"moe_capacity_factor": 16.0}
                                  if arch == "phi3_5_moe_42b" else {}))
    jparams = JaxModel(jcfg).init_params(jax.random.PRNGKey(0))
    cfg = _cfg(arch)
    params = Model(cfg).cast_params(convert.to_torch(jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, cfg, params


def _jax_cache_as_torch(cache):
    import jax

    return convert.to_torch(jax.tree.map(np.asarray, cache))


# ---------------------------------------------------------------------------
# The CPU
# ---------------------------------------------------------------------------


def test_a_cpu_replica_prefills_eagerly_into_its_scratch():
    cfg = _cfg("smollm_135m")
    rep = _replica(cfg, _params(cfg))
    assert type(rep._prefill_b1) is compiled.ScratchPrefill
    scratch = rep._prefill_b1.cache
    assert all(leaf.shape[1] == 1 for leaf in tree_leaves(scratch))
    _admit(rep, Request, _prompt(cfg, 5, 0))
    assert rep._prefill_b1.cache is scratch  # made once, reused


def test_a_compiled_prefill_needs_a_cuda_device():
    cfg = _cfg("smollm_135m")
    with pytest.raises(ValueError, match="CUDA device"):
        compiled.CompiledPrefill(Model(cfg), _params(cfg), MAX_LEN, MAX_LEN,
                                 torch.device("cpu"))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_slot_caches_equal_the_jax_engines_merged_cache(arch):
    """After each admit, every slot of the port's cache equals the JAX
    engine's (batch-1 ``jax.jit`` prefill merged in) and the earlier
    in-place route's, in float32 at 1e-5."""
    from repro.runtime.serve_engine import Replica as JaxReplica
    from repro.runtime.serve_engine import Request as JaxRequest

    jcfg, jparams, cfg, params = _jax_pair(arch)
    jrep = JaxReplica("j", jcfg, jparams, zone="z", slots=SLOTS, max_len=MAX_LEN)
    rep, twin = _replica(cfg, params), _replica(cfg, params, "twin")
    for i, (free, n) in enumerate(ADMITS):
        tokens = _prompt(cfg, n, seed=i)
        slot = _admit(rep, Request, tokens, free, rid=i)
        assert _admit(jrep, JaxRequest, tokens, free, rid=i) == slot
        logits = _in_place_prefill(twin, slot, tokens)
        _leaves_close(rep.cache, _jax_cache_as_torch(jrep.cache), **TOL)
        _leaves_close(rep.cache, twin.cache, **TOL)
        assert rep.active[slot].last_token == int(torch.argmax(logits[0, -1]))
        assert rep.active[slot].last_token == jrep.active[slot].last_token


@pytest.mark.parametrize("use_kernels", [False, True])
def test_whisper_slot_cache_equals_jax_encdec_prefill(use_kernels):
    """Each admitted slot holds JAX ``encdec.prefill``'s batch-1 cache at
    ``ENC_LEN`` zero frames (float32, 1e-5), and the in-place route's."""
    import jax.numpy as jnp

    from repro.models import Model as JaxModel

    jcfg, jparams, cfg, params = _jax_pair("whisper_small")
    cfg = dataclasses.replace(cfg, use_kernels=use_kernels)
    rep, twin = _replica(cfg, params), _replica(cfg, params, "twin")
    jmodel = JaxModel(jcfg)
    for i, (free, n) in enumerate(ADMITS):
        tokens = _prompt(cfg, n, seed=i)
        slot = _admit(rep, Request, tokens, free, rid=i)
        _in_place_prefill(twin, slot, tokens)
        j_logits, j_cache = jmodel.prefill(
            jparams, {"tokens": jnp.asarray(tokens[None, :]),
                      "frames": jnp.zeros((1, ENC_LEN, jcfg.d_model), jnp.float32)},
            jmodel.init_cache(1, MAX_LEN, enc_len=ENC_LEN))
        _leaves_close(_slot(rep.cache, slot), _slot(_jax_cache_as_torch(j_cache), 0), **TOL)
        _leaves_close(rep.cache, twin.cache, **TOL)
        assert rep.active[slot].last_token == int(jnp.argmax(j_logits[0, -1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_a_shorter_prompt_leaves_no_stale_rows(arch):
    """A long prompt then a shorter one in the same slot: the slot holds
    exactly what a fresh replica's admit of the short prompt leaves."""
    cfg = _cfg(arch)
    params = _params(cfg)
    rep, fresh = _replica(cfg, params), _replica(cfg, params, "fresh")
    _admit(rep, Request, _prompt(cfg, 20, seed=1))
    short = _prompt(cfg, 4, seed=2)
    assert _admit(rep, Request, short, free=0) == 0
    _admit(fresh, Request, short)
    _leaves_close(_slot(rep.cache, 0), _slot(fresh.cache, 0), rtol=0, atol=0)
    if cfg.family in ("lm", "encdec"):
        k = rep.cache["pos0"]["k"] if cfg.family == "lm" else rep.cache["self_k"]
        assert not bool(k[:, 0, 4:].any())


def test_a_mamba_prompt_shorter_than_the_window_zero_fills_it():
    cfg = _cfg("mamba2_2_7b")
    params = _params(cfg)
    rep = _replica(cfg, params)
    _admit(rep, Request, _prompt(cfg, 9, seed=3))
    assert bool(rep.cache["pos0"]["conv"][:, 0].any())
    tokens = _prompt(cfg, 1, seed=4)
    assert _admit(rep, Request, tokens, free=0) == 0
    conv = rep.cache["pos0"]["conv"][:, 0]                   # [P, W - 1, C]
    assert conv.shape[1] == cfg.ssm_conv - 1
    assert not bool(conv[:, :-1].any())                     # the rows before the prompt
    assert bool(conv[:, -1].any())
    model = Model(cfg)
    _, want = model.prefill(params, {"tokens": torch.as_tensor(tokens[None, :])},
                            model.init_cache(1, MAX_LEN, device="cpu"))
    _leaves_close(_slot(rep.cache, 0), _slot(want, 0), rtol=0, atol=0)


def test_an_int8_kv_cache_merges_leaf_for_leaf():
    cfg = _cfg("smollm_135m", kv_cache_dtype="int8")
    params = _params(cfg)
    rep, twin = _replica(cfg, params), _replica(cfg, params, "twin")
    assert rep.cache["pos0"]["k"]["q"].dtype == torch.int8
    for i, (free, n) in enumerate(ADMITS):
        tokens = _prompt(cfg, n, seed=i)
        slot = _admit(rep, Request, tokens, free, rid=i)
        _in_place_prefill(twin, slot, tokens)
        _leaves_close(rep.cache, twin.cache, rtol=0, atol=0)
    assert bool(rep.cache["pos0"]["k"]["scale"][:, 2, :11].all())


@pytest.mark.parametrize("arch", ARCHS)
def test_an_admit_leaves_the_other_slots_bit_for_bit(arch):
    cfg = _cfg(arch)
    rep = _replica(cfg, _params(cfg))
    gen = torch.Generator().manual_seed(5)
    for leaf in tree_leaves(rep.cache):
        leaf.copy_(torch.randint(-100, 100, leaf.shape, generator=gen).to(leaf.dtype))
    others = {s: [leaf[:, s].clone() for leaf in tree_leaves(rep.cache)] for s in (0, 2)}
    rep.active = {0: None, 2: None}  # slots 0 and 2 serving
    assert _admit(rep, Request, _prompt(cfg, 6, seed=6)) == 1
    for s, saved in others.items():
        for leaf, want in zip(tree_leaves(rep.cache), saved):
            assert torch.equal(leaf[:, s], want)


#: Prompt lengths of the token runs: several repeat, as on a replica that
#: sees the same lengths again.
MIX_LENGTHS = (3, 6, 9, 6, 3, 3, 9, 6, 12, 3, 6, 9)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_greedy_tokens_equal_the_jax_engines(arch):
    """The launcher's deployment on both engines, float32, prompts whose
    lengths repeat: the same placements and greedy tokens."""
    import jax

    from repro_torch.launch import serve as serve_mod
    from tests.test_torch_serving import _jax_serve

    jcfg, jparams, cfg, params = _jax_pair(arch)
    rng = np.random.default_rng(8)
    tags = ["interactive", "batch", None]
    requests = [(rng.integers(0, cfg.vocab_size, size=n).tolist(), tags[i % 3])
                for i, n in enumerate(MIX_LENGTHS)]
    jax_reqs = _jax_serve(jcfg, jparams, requests, max_new_tokens=5, max_len=MAX_LEN)
    result = serve_mod.serve(cfg, device="cpu", requests=requests,
                             params=convert.to_torch(jax.tree.map(np.asarray, jparams)),
                             max_new_tokens=5, max_len=MAX_LEN, use_kernels=True)
    assert all(r.state == "done" for r in result.requests + jax_reqs)
    assert [r.replica for r in result.requests] == [r.replica for r in jax_reqs]
    assert [r.output for r in result.requests] == [r.output for r in jax_reqs]


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


def _graph_and_eager(cfg, device, max_len=MAX_LEN, enc_len=ENC_LEN):
    """(CompiledPrefill, ScratchPrefill) of one model and params on ``device``."""
    params, model = _params(cfg, device), Model(cfg)
    enc_len = enc_len if cfg.family == "encdec" else max_len
    return (compiled.CompiledPrefill(model, params, max_len, enc_len, device),
            compiled.ScratchPrefill(model, params, max_len, enc_len, device))


def _check_lengths(graph, eager, cfg, lengths, device):
    """Each length through both, a fresh prompt each time: float32 logits
    and scratch caches to 1e-5, bf16 greedy tokens equal."""
    for i, n in enumerate(lengths):
        prompt = torch.as_tensor(_prompt(cfg, n, seed=10 + i)[None, :], device=device)
        g_logits, g_cache = graph(prompt)
        e_logits, e_cache = eager(prompt)
        if cfg.compute_dtype == "float32":
            torch.testing.assert_close(g_logits, e_logits, **TOL)
            _leaves_close(g_cache, e_cache, **TOL)
        else:
            assert int(torch.argmax(g_logits[0, -1])) == int(torch.argmax(e_logits[0, -1]))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_prefill_equals_eager(cuda_device, arch, dtype):
    cfg = _cfg(arch, dtype, use_kernels=True)
    graph, eager = _graph_and_eager(cfg, cuda_device)
    _check_lengths(graph, eager, cfg, (5, 9, 5, 5, 9), cuda_device)
    assert (graph.captures, graph.replays) == (2, 3)


@pytest.mark.gpu
def test_graph_prefill_with_an_int8_kv_cache(cuda_device):
    cfg = _cfg("smollm_135m", kv_cache_dtype="int8", use_kernels=True)
    graph, eager = _graph_and_eager(cfg, cuda_device)
    assert graph.cache["pos0"]["k"]["q"].dtype == torch.int8
    _check_lengths(graph, eager, cfg, (5, 9, 5, 9), cuda_device)
    assert (graph.captures, graph.replays) == (2, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS + tuple(PUBLISHED))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_replays_out_of_capture_order_equal_eager(cuda_device, arch, dtype):
    cfg = _cfg(arch, dtype, use_kernels=True)
    max_len, enc_len, scale = PUBLISHED.get(arch, (MAX_LEN, ENC_LEN, 1))
    graph, eager = _graph_and_eager(cfg, cuda_device, max_len, enc_len)
    _check_lengths(graph, eager, cfg, [scale * n for n in (5, 9, 7, 9, 5, 9, 7)], cuda_device)
    assert sorted(graph.graphs) == [5 * scale, 7 * scale, 9 * scale] and graph.replays == 4


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_capture_beside_active_slots_leaves_them_bit_for_bit(cuda_device, arch, dtype):
    """The two active slots come out bit for bit; the new one holds the
    eager prefill's greedy token and, in float32, its scratch cache to 1e-5."""
    cfg = _cfg(arch, dtype, use_kernels=True)
    rep = _replica(cfg, _params(cfg, cuda_device))
    assert isinstance(rep._prefill_b1, compiled.CompiledPrefill)
    _admit(rep, Request, _prompt(cfg, 5, seed=0))
    _admit(rep, Request, _prompt(cfg, 8, seed=1), rid=1)
    rep.step()
    saved = {s: [leaf[:, s].clone() for leaf in tree_leaves(rep.cache)] for s in (0, 1)}
    tokens = _prompt(cfg, 6, seed=2)
    assert _admit(rep, Request, tokens, rid=2) == 2  # a new length: captured
    torch.cuda.synchronize()
    assert rep._prefill_b1.captures == 3
    for s, want in saved.items():
        for leaf, w in zip(tree_leaves(rep.cache), want):
            assert torch.equal(leaf[:, s], w)
    eager = compiled.ScratchPrefill(rep.model, rep.params, rep.max_len, rep.enc_len, rep.device)
    e_logits, e_cache = eager(torch.as_tensor(tokens[None, :], device=cuda_device))
    assert rep.active[2].last_token == int(torch.argmax(e_logits[0, -1]))
    if dtype == "float32":
        _leaves_close(tree_map(lambda leaf: leaf[:, 2:3], rep.cache), e_cache, **TOL)


#: One prefill's launches at 2 (decoder) layers: flash once per attention
#: layer (whisper's 2 encoder layers too), gmm once per expert product; the
#: Mamba-2 prefill scans with the plain ``ssd_chunked``.
PREFILL_LAUNCHES = {"smollm_135m": (2, 0), "phi3_5_moe_42b": (2, 6), "mamba2_2_7b": (0, 0),
                    "whisper_small": (4, 0)}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_counts_one_capture_per_length_and_launches_per_replay(cuda_device, arch):
    """A first sight counts its eager pass (one prefill's launches) and no
    capture; each replay adds the graph's launches."""
    from repro_torch.kernels import launch_counts

    cfg = _cfg(arch, use_kernels=True)
    graph, _ = _graph_and_eager(cfg, cuda_device)
    flash, gmm = PREFILL_LAUNCHES[arch]
    per_prefill = {"flash_attention": flash, "gmm": gmm, "ssd_scan": 0, "mamba_step": 0}
    seen = []
    for i, n in enumerate((4, 7, 4, 4, 7, 10)):
        before = launch_counts()
        graph(torch.as_tensor(_prompt(cfg, n, seed=i)[None, :], device=cuda_device))
        added = {k: v - before[k] for k, v in launch_counts().items()}
        assert added == per_prefill, (n, added)
        seen.append(n)
        assert graph.captures == len(set(seen))
        assert graph.replays == len(seen) - len(set(seen))
    assert all(launches == per_prefill for launches in graph.launches.values())


@pytest.mark.gpu
def test_the_pool_holds_about_one_graphs_temporaries(cuda_device):
    """Graphs of near lengths share the pool's blocks: four captures hold
    well under twice the first one's memory (their sum would be ~4x)."""
    cfg = _cfg("smollm_135m", use_kernels=True, d_model=256, d_ff=1024)
    params = _params(cfg, cuda_device)
    graph = compiled.CompiledPrefill(Model(cfg), params, 512, 512, cuda_device)
    sizes = []
    for n in (500, 499, 498, 497):
        graph(torch.as_tensor(_prompt(cfg, n, seed=n)[None, :], device=cuda_device))
        sizes.append(graph.pool_bytes())
    print(f"pool bytes after each capture: {sizes}")
    assert 0 < sizes[0] and sizes[-1] < 2 * sizes[0]


@pytest.mark.gpu
def test_fail_releases_the_prefill_graphs(cuda_device):
    import gc

    cfg = _cfg("smollm_135m", use_kernels=True)
    rep = _replica(cfg, _params(cfg, cuda_device))
    _admit(rep, Request, _prompt(cfg, 5, seed=0))
    prefill = rep._prefill_b1
    pool = prefill.pool
    assert prefill.captures == 1 and prefill.pool_bytes() > 0
    del prefill
    rep.fail()
    assert rep._prefill_b1 is None and rep._decode is None
    assert not rep.admit(Request(1, cfg.name, _prompt(cfg, 5, seed=1)), placement=None)
    gc.collect()
    torch.cuda.empty_cache()
    assert not any(tuple(seg["segment_pool_id"]) == tuple(pool)
                   for seg in torch.cuda.memory_snapshot())
