"""granite-4.0-h in the port, on the CPU at a tiny size.

The port's prefill then decode steps through its cache against the
benchmark's plain reference (``servebench/reference/granite.py``: the
Mamba-2 SSM as a token-by-token recurrence, the experts on the tokens
routed to them, NoPE attention at the config's scale), on seeded random
weights in float32; then each piece granite adds (the shared expert,
NoPE with the 1/128 softmax scale in the flash and the decode paths, the
three multipliers), the configuration file, the 8-slot decode dispatch
at 72 experts top-10, and the op counts of smollm's and phi's decode
steps, which the new options at their defaults must leave as they were.
"""
import collections
import dataclasses
import json
import math
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import Model, ModelConfig  # noqa: E402
from repro_torch.models.layers import attention, basic, moe  # noqa: E402
from servebench import harness  # noqa: E402
from servebench import weights as W  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CELL = "granite-decode-poisson"
#: d 64, 4 Mamba-2 heads of 32, 8 experts top-2 beside a shared expert,
#: attention at position 1 of every 2 layers; the granite scalars as published
#: but the attention scale, which is 1/16 at D=16 as 1/128 is at D=128.
TINY = dict(name="granite-tiny", family="hybrid", n_layers=4, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=32, vocab_size=128, norm_eps=1e-5,
            norm_kind="rmsnorm", mlp_kind="swiglu", moe_experts=8, moe_top_k=2, moe_every=1,
            moe_capacity_factor=1.25, shared_expert_ff=48, ssm_state=16, ssm_headdim=32,
            ssm_expand=2, ssm_conv=4, ssm_chunk=8, ssm_groups=1, attn_every=2, attn_index=1,
            pos_embedding="none", tie_embeddings=True, embedding_multiplier=12.0,
            residual_multiplier=0.22, attention_multiplier=1 / 16, logits_scaling=16.0,
            compute_dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def granite():
    return harness.load_reference(REPO / "servebench", {"reference": "granite"}, "granite")


def _served_logits(model, params, prompt, served):
    """The port's prefill, then one decode step per served token but the last:
    the logits at every position that predicted a served token."""
    cache = model.init_cache(1, 64, device="cpu")
    logits, cache = model.prefill(params, {"tokens": torch.tensor([prompt])}, cache)
    rows = [logits[0, -1]]
    for i, tok in enumerate(served[:-1]):
        logits, cache = model.decode(params, cache, torch.tensor([tok]),
                                     torch.tensor([len(prompt) + i]))
        rows.append(logits[0, -1])
    return torch.stack(rows)


@pytest.mark.parametrize("use_kernels,crowd", [(False, False), (True, False), (False, True)],
                         ids=["plain", "kernels", "over_capacity"])
def test_prefill_then_decode_equals_the_reference(granite, use_kernels, crowd):
    """Both in float32 on one seed's weights; the port's prefill scans in
    chunks where the reference steps token by token, so they differ by the
    order of float32 sums alone (~1e-8 here). The logits are ~0.02 wide
    (÷16, the table at 1/12 of N(0, 1/d)): 1e-6 absolute is a hundred
    times the rounding and a tenth of what float8 inputs move them by.
    ``crowd`` biases every router to two experts, so the prefill drops
    pairs over capacity as the reference's rule says."""
    cfg = dict(TINY, use_kernels=use_kernels)
    seed = 2**33 + 11
    model = Model(ModelConfig(**cfg))
    params = W.make_params(granite, cfg, seed, "cpu")
    layer_weights = None
    if crowd:
        for pos in params["blocks"].values():
            pos["moe"]["router"][:, :, :2] += 5.0

        def layer_weights(p):
            lw = W.layer_float32(granite, cfg, seed, p, "cpu")
            lw["moe.router"][:, :2] += 5.0
            return lw
    prompt, served = list(range(5, 35)), [3, 8, 13, 99, 7, 64]
    got = _served_logits(model, params, prompt, served)
    want = granite.teacher_forced_logits(cfg, seed, [prompt], [served], "cpu",
                                         layer_weights=layer_weights)[0]
    assert got.shape == (len(served), cfg["vocab_size"])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    # the fp8 control lies far outside that tolerance
    low = granite.teacher_forced_logits(cfg, seed, [prompt], [served], "cpu", quant="fp8",
                                        layer_weights=layer_weights)[0]
    assert float((low - want).abs().max()) > 10 * 1e-6


def test_the_reference_lays_out_the_period(granite):
    """Attention at ``attn_index`` of every ``attn_every`` layers, Mamba-2 elsewhere."""
    assert [granite.is_attention(TINY, p) for p in range(4)] == [False, True, False, True]
    assert granite.period(TINY) == 2 and granite.attention_layers(TINY) == 2


# ---------------------------------------------------------------------------
# The pieces granite adds
# ---------------------------------------------------------------------------


def _tiny_model(**kw):
    cfg = ModelConfig(**dict(TINY, **kw))
    model = Model(cfg)
    return cfg, model, model.init_params(torch.Generator().manual_seed(3), "cpu")


def test_the_shared_expert_is_added_for_every_token():
    cfg, _, params = _tiny_model()
    p = params["blocks"]["pos0"]["moe"]
    layer = {k: v[0] for k, v in p.items() if k != "shared"}
    shared = {k: v[0] for k, v in p["shared"].items()}
    assert shared["w_gate"].shape == (64, 48) and shared["w_down"].shape == (48, 64)
    x = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(1))
    out, _ = moe.apply_moe(cfg, dict(layer, shared=shared), x)
    routed, _ = moe.apply_moe(dataclasses.replace(cfg, shared_expert_ff=0), layer, x)
    swiglu = (F.silu(x @ shared["w_gate"]) * (x @ shared["w_up"])) @ shared["w_down"]
    torch.testing.assert_close(out, routed + swiglu, rtol=1e-5, atol=1e-6)
    assert float(swiglu.abs().max()) > 1e-2


def test_the_shared_expert_is_counted_whole():
    cfg = ModelConfig(**TINY)
    no_shared = dataclasses.replace(cfg, shared_expert_ff=0)
    shared = 3 * 64 * 48
    assert cfg.param_count() - no_shared.param_count() == cfg.n_layers * shared
    assert cfg.active_param_count() - no_shared.active_param_count() == cfg.n_layers * shared
    with pytest.raises(ValueError, match="shared expert"):
        dataclasses.replace(cfg, moe_experts=0)


def test_the_published_sizes():
    cfg = get_config("granite_4_0_h_small")
    assert cfg.layer_pattern().count(("attn", "moe")) == 1 and cfg.period == 10
    assert round(cfg.param_count() / 1e9, 1) == 32.2          # "32B-A9B"
    assert round(cfg.active_param_count() / 1e9, 1) == 8.8
    assert cfg.d_inner // cfg.ssm_headdim == 128 and cfg.head_dim == 128


def _qkv(seed=0, s=6, h=4, kv=2, d=16):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(1, s, h, d, generator=g), torch.randn(1, s, kv, d, generator=g),
            torch.randn(1, s, kv, d, generator=g))


def _plain_attention(q, k, v, scale):
    group = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(group, dim=2), v.repeat_interleave(group, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k) * scale
    s = q.shape[1]
    scores = scores.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), float("-inf"))
    return torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), v)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["sdpa", "flash"])
def test_prefill_attention_takes_the_configs_scale(use_kernels):
    """The full-sequence path (the flash kernel's plain version under
    ``use_kernels``) scales the scores by ``attention_multiplier``."""
    cfg, _, params = _tiny_model(use_kernels=use_kernels, attention_multiplier=1 / 128)
    sub = {k: v[0] for k, v in params["blocks"]["pos1"]["attn"].items()}
    q, k, v = _qkv()
    out = attention.attend_projected(cfg, sub, q, k, v, causal=True)
    want = _plain_attention(q, k, v, 1 / 128).reshape(1, 6, 64) @ sub["wo"]
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    default = attention.attend_projected(
        dataclasses.replace(cfg, attention_multiplier=0.0), sub, q, k, v, causal=True)
    assert float((default - want).abs().max()) > 1e-3


def test_decode_attention_takes_the_configs_scale_and_no_rope():
    """One decode step at position 5 against the cache of the 5 tokens before:
    the same attention over the 6 tokens' projections, unrotated."""
    cfg, _, params = _tiny_model(attention_multiplier=1 / 128)
    sub = {k: v[0] for k, v in params["blocks"]["pos1"]["attn"].items()}
    x = torch.randn(1, 6, 64, generator=torch.Generator().manual_seed(4))
    q, k, v = (torch.matmul(x, sub[w]).view(1, 6, -1, 16) for w in ("wq", "wk", "wv"))
    pq, pk, pv = attention._project_qkv(cfg, sub, x, positions=torch.arange(6)[None])
    assert torch.equal(pq, q) and torch.equal(pk, k)            # NoPE: nothing rotated
    ck, cv = attention.init_kv_cache(cfg, 1, 8, torch.float32)
    ck[:, :5], cv[:, :5] = k[:, :5], v[:, :5]
    out, _, _ = attention.attend_cached(cfg, sub, x[:, 5:], ck, cv, torch.tensor([5]))
    want = _plain_attention(q, k, v, 1 / 128)[:, 5:].reshape(1, 1, 64) @ sub["wo"]
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)


def test_rope_configs_still_rotate():
    cfg, _, params = _tiny_model(pos_embedding="rope")
    sub = {k: v[0] for k, v in params["blocks"]["pos1"]["attn"].items()}
    x = torch.randn(1, 6, 64, generator=torch.Generator().manual_seed(4))
    pq, _, _ = attention._project_qkv(cfg, sub, x, positions=torch.arange(6)[None])
    assert not torch.equal(pq, (x @ sub["wq"]).view(1, 6, -1, 16))


def test_the_embedding_multiplier():
    cfg, _, params = _tiny_model()
    tokens = torch.tensor([[3, 9, 1]])
    got = basic.embed(cfg, params["embed"], tokens)
    torch.testing.assert_close(got, 12.0 * params["embed"]["table"][tokens])


def test_the_residual_multiplier():
    cfg, _, _ = _tiny_model()
    x, h = torch.ones(3), torch.full((3,), 2.0)
    torch.testing.assert_close(basic.residual(cfg, x, h), torch.full((3,), 1.44))
    plain = dataclasses.replace(cfg, residual_multiplier=1.0)
    assert torch.equal(basic.residual(plain, x, h), x + h)


def test_the_logits_scaling():
    cfg, _, params = _tiny_model()
    x = torch.randn(2, 64, generator=torch.Generator().manual_seed(2))
    want = x @ params["embed"]["table"].t() / 16.0
    torch.testing.assert_close(basic.unembed(cfg, params["embed"], x), want)


# ---------------------------------------------------------------------------
# The configuration and the decode dispatch
# ---------------------------------------------------------------------------


def test_the_cell_loads_the_granite_module_and_its_layout():
    """``load_cell`` on the repository's file; at a tiny size (one period of
    10) the module's weights have the port's leaf names, shapes and dtypes."""
    cell = harness.load_cell(REPO, CELL)
    assert Path(cell.reference.__file__).name == "granite.py"
    assert [m.name for m in cell.end_to_end] == ["itl_p95_ms", "setup_s"]
    assert "decode_rest_ms_per_tick.itl" in [m.name for m in cell.per_layer]
    model = cell.config["model"]
    ModelConfig(**model)
    tiny = dict(model, n_layers=10, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32,
                vocab_size=256, moe_experts=8, shared_expert_ff=48, ssm_state=16,
                ssm_headdim=32)
    port_model = Model(ModelConfig(**tiny))
    port = port_model.cast_params(port_model.init_params(torch.Generator().manual_seed(0), "cpu"))
    ours = W.make_params(cell.reference, tiny, 7, "cpu")
    want = {k: (tuple(v.shape), v.dtype) for k, v in W.iter_leaves(port)}
    got = {k: (tuple(v.shape), v.dtype) for k, v in W.iter_leaves(ours)}
    assert got == want
    assert got["blocks.pos5.attn.wq"] == ((1, 64, 64), torch.bfloat16)
    assert got["blocks.pos0.mamba.a_log"] == ((1, 4), torch.float32)
    assert got["blocks.pos0.moe.shared.w_down"] == ((1, 48, 64), torch.bfloat16)


def test_the_file_states_the_published_keys_it_runs():
    """The published keys at the top of the file agree with the port's
    ``model``; the two it cuts are listed as reduced, with their published values."""
    conf = json.loads((REPO / "servebench/configs/granite-4.0-h-small-20l.json").read_text())
    m = conf["model"]
    assert conf["reduced"] == ["num_hidden_layers", "layer_types"]
    assert conf["published"]["num_hidden_layers"] == 40 == len(conf["published"]["layer_types"])
    assert conf["layer_types"] == conf["published"]["layer_types"][:m["n_layers"]]
    assert conf["num_hidden_layers"] == m["n_layers"] == 20
    attn = [i for i, t in enumerate(conf["layer_types"]) if t == "attention"]
    assert attn == [i for i in range(20) if i % m["attn_every"] == m["attn_index"]]
    pairs = {"hidden_size": "d_model", "intermediate_size": "d_ff", "vocab_size": "vocab_size",
             "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
             "num_local_experts": "moe_experts", "num_experts_per_tok": "moe_top_k",
             "shared_intermediate_size": "shared_expert_ff", "mamba_d_state": "ssm_state",
             "mamba_d_head": "ssm_headdim", "mamba_expand": "ssm_expand",
             "mamba_d_conv": "ssm_conv", "mamba_chunk_size": "ssm_chunk",
             "mamba_n_groups": "ssm_groups", "rms_norm_eps": "norm_eps",
             "tie_word_embeddings": "tie_embeddings", "embedding_multiplier":
             "embedding_multiplier", "residual_multiplier": "residual_multiplier",
             "attention_multiplier": "attention_multiplier",
             "logits_scaling": "logits_scaling"}
    for hf, port in pairs.items():
        assert conf[hf] == m[port], hf
    assert m["d_model"] * m["ssm_expand"] // m["ssm_headdim"] == conf["mamba_n_heads"]
    assert conf["position_embedding_type"] == "nope" and m["pos_embedding"] == "none"
    assert conf["deployment"]["slots"] == 8


def test_eight_slots_at_72_experts_top_10_drop_no_pair():
    """A decode step routes 80 pairs; an expert takes a token once, so at most
    8 pairs against the capacity's floor of 8, even with every token sent to
    the same 10 experts."""
    cfg = get_config("granite_4_0_h_small")
    assert moe.moe_capacity(cfg, 8) == 8
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(8, 64, generator=gen).abs()    # positive: a bias below wins every row
    small = dataclasses.replace(cfg, d_model=64)
    for bias in (0.0, 50.0):
        router = torch.randn(64, 72, generator=gen)
        router[:, :10] += bias                     # bias: every token to experts 0-9
        _, _, _, keep, _, _, offsets = moe._dispatch(small, router, x)
        assert keep.shape == (80,) and bool(keep.all())
        per_expert = offsets[1:] - offsets[:-1]
        assert int(per_expert.max()) <= 8 and int(offsets[-1]) == 80
        if bias:
            assert per_expert[:10].tolist() == [8] * 10


# ---------------------------------------------------------------------------
# The defaults add no operation
# ---------------------------------------------------------------------------


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


_SMOLLM = {"_softmax": 2, "_to_copy": 30, "_unsafe_view": 19, "add": 13, "arange": 8, "bmm": 4,
           "cat": 4, "clone": 4, "cos": 4, "div": 6, "embedding": 1, "full_like": 2,
           "index_put_": 4, "le": 2, "mean": 5, "mm": 15, "mul": 36, "permute": 20, "pow": 9,
           "reciprocal": 4, "rsqrt": 5, "select": 26, "silu": 2, "sin": 4, "split": 4,
           "sub": 4, "t": 1, "unsqueeze": 37, "view": 39, "where": 2}
_PHI = {"_local_scalar_dense": 4, "_softmax": 4, "_to_copy": 36, "_unsafe_view": 13, "add": 22,
        "aminmax": 2, "arange": 14, "bmm": 10, "cat": 4, "clamp": 2, "clone": 6, "cos": 4,
        "div": 8, "embedding": 1, "expand": 2, "full_like": 4, "index": 12, "index_add_": 2,
        "index_put_": 6, "le": 2, "lt": 2, "mean": 9, "mm": 11, "mul": 46, "permute": 50,
        "pow": 4, "reciprocal": 4, "rsqrt": 5, "scatter_": 2, "searchsorted": 2, "select": 34,
        "silu": 2, "sin": 4, "slice": 2, "sort": 2, "split": 4, "sub": 11, "sum": 4, "t": 1,
        "topk": 2, "unsqueeze": 57, "var": 5, "view": 71, "where": 6, "zeros": 8}
#: The aten ops of one eager decode step of each smoke config (4 slots, a
#: 32-position cache), counted on the tree before granite's options existed
#: (with the kernels, phi's expert weights are cast once more a call).
OP_COUNTS = {
    ("smollm_135m", False): _SMOLLM,
    ("smollm_135m", True): _SMOLLM,
    ("phi3_5_moe_42b", False): _PHI,
    ("phi3_5_moe_42b", True): dict(_PHI, _to_copy=60),
}


@pytest.mark.parametrize("arch,use_kernels", sorted(OP_COUNTS),
                         ids=[f"{a}-{'kernels' if k else 'plain'}" for a, k in sorted(OP_COUNTS)])
def test_decode_runs_the_ops_it_ran_before(arch, use_kernels):
    cfg = dataclasses.replace(smoke_config(arch), use_kernels=use_kernels)
    model = Model(cfg)
    params = model.cast_params(model.init_params(torch.Generator().manual_seed(0), "cpu"))
    cache = model.init_cache(4, 32, device="cpu")
    tokens = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    positions = torch.tensor([0, 3, 5, 7], dtype=torch.int32)
    with torch.no_grad():
        model.decode(params, cache, tokens, positions)
        with _Count() as mode:
            model.decode(params, cache, tokens, positions)
    assert dict(mode.ops) == OP_COUNTS[(arch, use_kernels)]


# ---------------------------------------------------------------------------
# The cell, whole, at a tiny size
# ---------------------------------------------------------------------------


def test_a_tiny_granite_cell_runs_correct(tmp_path):
    """The benchmark's files at a tiny size (``make_tiny_root``), granite's
    configuration cut to TINY's widths: a traced run on the CPU, served by the
    port and judged by the granite module, comes out correct."""
    from servebench.tests.test_servebench_run import TINY_LIMITS, _run, make_tiny_root

    root = make_tiny_root(tmp_path)
    path = root / "servebench/configs/granite-4.0-h-small-20l.json"
    conf = json.loads(path.read_text())
    conf["model"].update({k: TINY[k] for k in (
        "n_layers", "attn_every", "attn_index", "ssm_headdim", "ssm_state", "ssm_chunk",
        "moe_top_k", "moe_experts", "shared_expert_ff", "attention_multiplier")})
    path.write_text(json.dumps(conf))
    t0 = time.perf_counter()
    c, res = _run(root, CELL, seed=2**33 + 9, trace=True)
    assert res["correct"], res["checks"]
    assert res["checks"]["mean_logit_gap"]["value"] < TINY_LIMITS["mean_logit_gap"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["metrics"]["mfu_decode.itl"]["value"] > 0
    assert time.perf_counter() - t0 < 120
    assert math.isfinite(res["metrics"]["decode_tick_ms.itl"]["value"])
