"""The benchmark's arithmetic on the CPU: traffic, statistics, operation and byte counts."""
from __future__ import annotations

import collections
import json
import math
from pathlib import Path

import numpy as np
import pytest

from servebench import roofline, stats, traffic
from servebench.reference import lm

BENCH = Path(__file__).resolve().parents[1]


def _mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


# -- traffic -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["chat-poisson", "decode-poisson", "rag-poisson"])
def test_open_loop_same_seed_same_schedule(name):
    a = traffic.open_loop(_mix(name), 2**31 + 7, 30.0, 1000)
    b = traffic.open_loop(_mix(name), 2**31 + 7, 30.0, 1000)
    assert [(i.arrival_s, i.prompt_len, i.max_new_tokens, i.tag) for i in a] == \
           [(i.arrival_s, i.prompt_len, i.max_new_tokens, i.tag) for i in b]
    assert all((x.tokens == y.tokens).all() for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["chat-poisson", "decode-poisson", "rag-poisson"])
def test_open_loop_seeds_share_the_work(name):
    """Two seeds send the same multiset of sizes, tags and gaps, in another order."""
    a = traffic.open_loop(_mix(name), 11, 30.0, 1000)
    b = traffic.open_loop(_mix(name), 12, 30.0, 1000)

    def sizes(items):
        return sorted((i.prompt_len, i.max_new_tokens, i.tag or "") for i in items)

    def gaps(items):
        """Every gap, the one from the last arrival to the horizon included."""
        t = [i.arrival_s for i in items] + [30.0]
        return np.sort(np.diff(t))

    assert sizes(a) == sizes(b)
    assert [i.prompt_len for i in a] != [i.prompt_len for i in b]
    assert np.allclose(gaps(a), gaps(b), rtol=0, atol=1e-9)   # one multiset, closing gap too
    for items in (a, b):                                      # the gaps fill the horizon
        t = [i.arrival_s for i in items]
        assert t[0] == 0.0 and t[-1] < 30.0 and (gaps(items) > 0).all()
    assert not all((x.tokens[:4] == y.tokens[:4]).all() for x, y in zip(a, b)
                   if len(x.tokens) >= 4 and len(y.tokens) >= 4)


@pytest.mark.parametrize("block", [1, 16, 50])
def test_open_loop_shuffle_block_keeps_each_seconds_load(block):
    """With ``shuffle_block`` every seed sends the same arrival times, and the
    same sizes and tags within each block of that many, in its own order."""
    mix = dict(_mix("chat-poisson"), shuffle_block=block)
    a = traffic.open_loop(mix, 11, 30.0, 1000)
    b = traffic.open_loop(mix, 2**31 + 12, 30.0, 1000)
    assert len(a) == len(b) == math.ceil(mix["rate_per_s"] * 30.0)
    assert [i.arrival_s for i in a] == [i.arrival_s for i in b]

    def sizes(items):
        return [(i.prompt_len, i.max_new_tokens, i.tag or "") for i in items]

    for start in range(0, len(a), block):
        assert sorted(sizes(a[start:start + block])) == sorted(sizes(b[start:start + block]))
    assert (sizes(a) != sizes(b)) == (block > 1)
    whole = traffic.open_loop(dict(mix, shuffle_block=None), 11, 30.0, 1000)
    assert sorted(sizes(whole)) == sorted(sizes(a))


def test_open_loop_distributions():
    mix = _mix("chat-poisson")
    items = traffic.open_loop(mix, 3, 400.0, 49152, rate=10.0)
    n = len(items)
    assert n == 4000
    prompt = np.array([i.prompt_len for i in items])
    output = np.array([i.max_new_tokens for i in items])
    assert prompt.min() >= 32 and prompt.max() <= 768 and (prompt % 32 == 0).all()
    assert 16 <= output.min() and output.max() <= 256
    assert (prompt + output <= mix["max_total"]).all()
    # lognormal medians, before the grid rounds prompts up by < 32
    assert 180 <= np.median(prompt) <= 240
    assert 58 <= np.median(output) <= 70
    # Poisson: mean gap 1 / rate, coefficient of variation about 1
    gaps = np.diff([i.arrival_s for i in items])
    assert gaps.mean() == pytest.approx(0.1, rel=0.06)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, rel=0.08)
    tags = collections.Counter(i.tag for i in items)
    assert tags["interactive"] / n == pytest.approx(0.5, abs=0.03)
    assert tags["batch"] / n == pytest.approx(0.3, abs=0.03)
    assert tags[None] / n == pytest.approx(0.2, abs=0.03)


def test_uniform_prompts_on_the_grid():
    items = traffic.open_loop(_mix("rag-poisson"), 5, 300.0, 32064)
    prompt = np.array([i.prompt_len for i in items])
    assert set(prompt) <= set(range(384, 961, 32))
    assert len(set(prompt)) == 19


def test_closed_loop_functions_and_popularity():
    mix = _mix("invoke-closed")
    items = traffic.closed_loop(mix, 9, 20000, 49152)
    by_len = collections.Counter(i.prompt_len for i in items)
    lens = [f["prompt"] for f in mix["functions"]]
    assert set(by_len) == set(lens)
    counts = [by_len[p] for p in lens]
    assert counts == sorted(counts, reverse=True)        # Zipf: first most popular
    expect = 1.0 / np.arange(1, 9) ** mix["zipf_s"]
    assert counts[0] / len(items) == pytest.approx(expect[0] / expect.sum(), rel=0.05)
    tag_of = {f["prompt"]: f["tag"] or None for f in mix["functions"]}
    assert all(i.tag == tag_of[i.prompt_len] for i in items)
    assert all(4 <= i.max_new_tokens <= 32 for i in items)
    again = traffic.closed_loop(mix, 9, 20000, 49152)
    assert [(i.prompt_len, i.max_new_tokens) for i in items] == \
           [(i.prompt_len, i.max_new_tokens) for i in again]


# -- statistics ------------------------------------------------------------------


def test_percentile_matches_numpy_and_failures_are_infinite():
    xs = list(np.random.default_rng(0).random(101))
    for q in (50, 95, 99):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    # 100 values, 4 failed: the 95th percentile lies among the finite ones
    vals = list(range(96)) + [stats.INF] * 4
    assert math.isfinite(stats.percentile(vals, 95))
    vals = list(range(94)) + [stats.INF] * 6
    assert stats.percentile(vals, 95) == stats.INF


def test_ttft_gaps_and_rate():
    recs = [
        {"due": 1.0, "stamps": [1.5, 1.5, 1.6, 1.8], "failed": False, "max_new_tokens": 4},
        {"due": 2.0, "stamps": [2.25, 2.5], "failed": False, "max_new_tokens": 2},
        {"due": 3.0, "stamps": [3.5], "failed": True, "max_new_tokens": 3},
    ]
    assert stats.ttfts(recs) == [0.5, 0.25, stats.INF]
    gaps = stats.pooled_gaps(recs)
    assert sorted(gaps[:3]) == pytest.approx([0.0, 0.1, 0.2])
    assert gaps[3] == pytest.approx(0.25)
    assert gaps[4:] == [stats.INF, stats.INF]
    assert stats.tokens_in(recs, 1.55, 2.5) == 3   # 1.6, 1.8, 2.25


def test_spread_and_knee():
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx((5.25 - 1.75) / 3.5)
    points = [{"rate": 10, "queue_start": 0, "queue_end": 0},
              {"rate": 20, "queue_start": 1, "queue_end": 1},
              {"rate": 30, "queue_start": 3, "queue_end": 40},
              {"rate": 40, "queue_start": 2, "queue_end": 1}]
    assert stats.knee(points) == 20        # the last rate before the queue first grew
    assert stats.knee(points[2:3]) is None


# -- operations and bytes ----------------------------------------------------------

TINY = {"d_model": 8, "d_ff": 16, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4,
        "vocab_size": 10, "n_layers": 3}


def test_flash_bound_by_hand():
    # S=4, H=2, KV=1, D=4, bf16: bytes 2*(2*4*2*4 + 2*4*1*4) = 192
    # pairs 10 → flops 4*2*4*10 = 320
    assert roofline.flash_bound_s(TINY, 4) == pytest.approx(
        max(192 / roofline.PEAK_BYTES_PER_S, 320 / roofline.PEAK_FLOPS_BF16))
    # phi's head shape at S=960 is bound by its operations
    phi = {"n_heads": 32, "n_kv_heads": 8, "d_model": 4096, "head_dim": 128}
    flops = 4 * 32 * 128 * (960 * 961 // 2)
    assert roofline.flash_bound_s(phi, 960) == pytest.approx(flops / 989e12)


def test_model_flops_by_hand():
    # attention 8*8 + 2*8*4 + 8*8 = 192, swiglu 3*8*16 = 384 → 576 a layer
    assert lm.layer_matmul_params(TINY) == 576
    # decode at position 5: 2*(3*576 + 10*8) + 4*2*4*6*3
    assert lm.decode_token_flops(TINY, 5) == 2 * (1728 + 80) + 576
    # prefill of 4: 2*(3*576*4 + 80) + 4*2*4*10*3
    assert lm.prefill_flops(TINY, 4) == 2 * (6912 + 80) + 960
    moe = dict(TINY, moe_experts=4, moe_top_k=2)
    assert lm.layer_matmul_params(moe) == 192 + 2 * 384 + 8 * 4


def test_model_flops_match_the_ports_parameter_count():
    """2 × the port's active parameters (less the embedding lookup) per token."""
    from repro_torch.configs.phi3_5_moe_42b import CONFIG as PHI
    from repro_torch.configs.smollm_135m import CONFIG as SMOL
    import dataclasses

    for c in (SMOL, dataclasses.replace(PHI, n_layers=8)):
        cfg = dataclasses.asdict(c)
        d, n = c.d_model, c.n_layers
        share = c.moe_top_k / c.moe_experts if c.moe_experts else 1.0
        # the port counts top_k/E of a MoE layer's router and FFN norm
        norms = d * (n + 1) + n * d * share
        params = c.active_param_count() - norms - (0 if c.tie_embeddings else c.vocab_size * d)
        if c.moe_experts:   # this benchmark counts all of the router
            params += n * d * (c.moe_experts - c.moe_top_k)
        pos0 = lm.decode_token_flops(cfg, 0) - lm.attention_flops(cfg, 1)
        assert pos0 == pytest.approx(2 * params, rel=1e-9)


# -- the router's placement rule ------------------------------------------------


def _replicas(slots):
    rep = collections.namedtuple("Rep", "zone slots")
    return [rep("edge", slots), rep("edge", slots), rep("cloud", slots), rep("cloud", slots)]


@pytest.mark.parametrize("tag, k, controller, in_use, bad", [
    ("interactive", 0, "EdgeCtl", (11, 16, 0, 0), 0),    # edge with room: edge
    ("interactive", 2, "CloudCtl", (11, 12, 0, 0), 1),   # edge-0 at 69%: not cloud
    ("interactive", 2, "EdgeCtl", (12, 13, 0, 0), 0),    # both edge at 75% or more: cloud
    ("interactive", 1, "EdgeCtl", (12, 13, 0, 0), 1),    # ... and no longer edge
    ("interactive", 1, "EdgeCtl", (12, 13, 16, 16), 0),  # cloud full: the default, any with room
    ("batch", 3, "CloudCtl", (0, 0, 15, 3), 0),
    ("batch", 0, "CloudCtl", (0, 0, 15, 3), 1),          # batch off cloud
    ("batch", 3, "EdgeCtl", (0, 0, 15, 3), 1),           # batch not by CloudCtl
    ("batch", 0, "EdgeCtl", (0, 0, 16, 16), 1),          # cloud full: the script fails it
    (None, 1, "EdgeCtl", (0, 15, 0, 0), 0),              # untagged: any with room
    (None, 1, "EdgeCtl", (0, 16, 0, 0), 1),              # ... but not a full one
    (None, 2, "CloudCtl", (0, 0, 0, None), 0),           # a dead replica is no candidate
    ("unknown", 0, "EdgeCtl", (0, 0, 0, 0), 0),          # a tag the script lacks: the default
])
def test_placement_rule_by_hand(tag, k, controller, in_use, bad):
    from servebench import check

    rules = json.loads((BENCH / "configs" / "smollm-135m.json").read_text())["placement"]
    got = check.placement_checks([(tag, k, controller, in_use)], _replicas(16), rules)
    assert got == {"placement_violations": {"value": bad, "limit": 0}}


def test_both_configurations_transcribe_one_script():
    confs = [json.loads(p.read_text()) for p in sorted((BENCH / "configs").glob("*.json"))]
    assert len({c["tapp_script"] for c in confs}) == 1
    assert len({json.dumps(c["placement"]) for c in confs}) == 1
