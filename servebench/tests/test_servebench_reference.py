"""The reference and the seeded weights on the CPU, at a tiny size."""
from __future__ import annotations

import math

import pytest
import torch

from servebench import weights as W
from servebench.reference import lm

DENSE = {"family": "lm", "n_layers": 2, "d_model": 32, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 8, "d_ff": 48, "vocab_size": 64, "norm_kind": "rmsnorm", "norm_eps": 1e-5,
         "mlp_kind": "swiglu", "rope_theta": 10000.0, "tie_embeddings": True,
         "moe_experts": 0, "moe_top_k": 2, "moe_capacity_factor": 1.25,
         "compute_dtype": "float32", "param_dtype": "float32"}
MOE = dict(DENSE, norm_kind="layernorm", tie_embeddings=False, moe_experts=4)


def _slow_logits(cfg, seed, ids, prompt_len, layer_weights=None):
    """The same model written out position by position, head by head and
    token by token, with the capacity rule as a count per expert."""
    top = W.top_float32(lm, cfg, seed, "cpu")
    hd, nh, nkv = W.head_dim(cfg), cfg["n_heads"], cfg["n_kv_heads"]
    x = [top["embed.table"][t].clone() for t in ids]
    n = len(ids)

    def nrm(v, scale, bias):
        if cfg["norm_kind"] == "layernorm":
            mu = sum(v.tolist()) / v.numel()
            var = sum((a - mu) ** 2 for a in v.tolist()) / v.numel()
            return (v - mu) / math.sqrt(var + cfg["norm_eps"]) * scale + bias
        ms = sum(a * a for a in v.tolist()) / v.numel()
        return v / math.sqrt(ms + cfg["norm_eps"]) * scale

    def rot(v, pos):
        half = hd // 2
        out = v.clone()
        for i in range(half):
            ang = pos / cfg["rope_theta"] ** (2 * i / hd)
            a, b = float(v[i]), float(v[i + half])
            out[i] = a * math.cos(ang) - b * math.sin(ang)
            out[i + half] = b * math.cos(ang) + a * math.sin(ang)
        return out

    def ffn(h, wg, wu, wd):
        g, u = h @ wg, h @ wu
        return (g / (1 + torch.exp(-g)) * u) @ wd

    for p in range(cfg["n_layers"]):
        lw = layer_weights(p) if layer_weights else W.layer_float32(lm, cfg, seed, p, "cpu")
        hs = [nrm(v, lw["mixer_norm.scale"], lw.get("mixer_norm.bias")) for v in x]
        q = [rot_heads for rot_heads in
             [[rot((h @ lw["attn.wq"])[j * hd:(j + 1) * hd], t) for j in range(nh)]
              for t, h in enumerate(hs)]]
        k = [[rot((h @ lw["attn.wk"])[j * hd:(j + 1) * hd], t) for j in range(nkv)]
             for t, h in enumerate(hs)]
        v = [[(h @ lw["attn.wv"])[j * hd:(j + 1) * hd] for j in range(nkv)] for h in hs]
        new = []
        for t in range(n):
            heads = []
            for j in range(nh):
                kv = j // (nh // nkv)
                s = torch.tensor([float(q[t][j] @ k[u][kv]) / math.sqrt(hd) for u in range(t + 1)])
                w = torch.softmax(s, 0)
                heads.append(sum(w[u] * v[u][kv] for u in range(t + 1)))
            new.append(x[t] + torch.cat(heads) @ lw["attn.wo"])
        x = new
        hs = [nrm(v_, lw["ffn_norm.scale"], lw.get("ffn_norm.bias")) for v_ in x]
        if not cfg["moe_experts"]:
            x = [x[t] + ffn(hs[t], lw["ffn.w_gate"], lw["ffn.w_up"], lw["ffn.w_down"])
                 for t in range(n)]
            continue
        cap = lm.moe_capacity(cfg, prompt_len)
        used = [0] * cfg["moe_experts"]
        out = []
        for t in range(n):
            probs = torch.softmax(hs[t] @ lw["moe.router"], 0)
            g, e = torch.topk(probs, cfg["moe_top_k"])
            g = g / g.sum()
            y = torch.zeros_like(x[t])
            for gate, ex in zip(g.tolist(), e.tolist()):
                if t < prompt_len:
                    used[ex] += 1
                    if used[ex] > cap:
                        continue
                y = y + gate * ffn(hs[t], lw["moe.w_gate"][ex], lw["moe.w_up"][ex],
                                   lw["moe.w_down"][ex])
            out.append(x[t] + y)
        x = out
    head = top["embed.table"] if cfg["tie_embeddings"] else top["lm_head.table"]
    return torch.stack([nrm(v_, top["final_norm.scale"], top.get("final_norm.bias")) @ head.t()
                        for v_ in x[prompt_len - 1:]])


@pytest.mark.parametrize("cfg", [DENSE, MOE], ids=["dense", "moe"])
def test_reference_against_an_explicit_loop(cfg):
    seed = 2**33 + 5
    prompt, served = list(range(3, 15)), [7, 1, 9, 2]
    got = lm.teacher_forced_logits(cfg, seed, [prompt], [served], "cpu")[0]
    want = _slow_logits(cfg, seed, prompt + served[:-1], len(prompt))
    assert got.shape == (len(served), cfg["vocab_size"])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_the_capacity_rule_drops_what_the_count_drops():
    """A router that sends every token to experts 0 and 1 fills their
    capacity in a 24-token prompt; the explicit count agrees."""
    cfg = dict(MOE, n_layers=1)
    seed = 3
    router = torch.zeros(cfg["d_model"], cfg["moe_experts"])
    router[:, :2] = 5.0

    def layer_weights(p):
        lw = W.layer_float32(lm, cfg, seed, p, "cpu")
        lw["moe.router"] = router + 0.01 * lw["moe.router"]
        return lw

    prompt = [(5 * i) % 64 for i in range(24)]
    got = lm.teacher_forced_logits(cfg, seed, [prompt], [[1, 2]], "cpu",
                                   layer_weights=layer_weights)[0]
    assert lm.moe_capacity(cfg, 24) == 16         # experts 0 and 1 get 24 tokens each
    want = _slow_logits(cfg, seed, prompt + [1], len(prompt), layer_weights)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cfg,crowd", [(DENSE, False), (MOE, False), (MOE, True)],
                         ids=["dense", "moe", "moe_over_capacity"])
def test_reference_against_the_ports_prefill_and_decode(cfg, crowd):
    """The port's own prefill then decode steps through its cache, in float32
    on the CPU, on the same seeded weights: the reference's logits at every
    served position. ``crowd`` biases the router to two experts, so the
    prefill drops pairs over capacity."""
    from repro_torch.models import Model, ModelConfig

    seed = 77
    mc = ModelConfig(name="t", **{k: v for k, v in cfg.items()})
    model = Model(mc)
    params = W.make_params(lm, cfg, seed, "cpu")
    layer_weights = None
    if crowd:
        params["blocks"]["pos0"]["moe"]["router"][:, :, :2] += 5.0

        def layer_weights(p):
            lw = W.layer_float32(lm, cfg, seed, p, "cpu")
            lw["moe.router"][:, :2] += 5.0
            return lw
    prompt, served = list(range(5, 25)), [3, 8, 13]
    cache = model.init_cache(1, 64, device="cpu")
    logits, cache = model.prefill(params, {"tokens": torch.tensor([prompt])}, cache)
    rows = [logits[0, -1]]
    for i, tok in enumerate(served[:-1]):
        logits, cache = model.decode(params, cache, torch.tensor([tok]),
                                     torch.tensor([len(prompt) + i]))
        rows.append(logits[0, -1])
    ref = lm.teacher_forced_logits(cfg, seed, [prompt], [served], "cpu",
                                   layer_weights=layer_weights)[0]
    torch.testing.assert_close(torch.stack(rows), ref, rtol=1e-4, atol=1e-4)


def test_weights_in_the_ports_layout():
    """Leaf names, shapes and dtypes equal the port's ``init_params`` then
    ``cast_params`` (bf16 matmul weights, float32 norms, tables and router)."""
    from repro_torch.models import Model, ModelConfig

    for cfg in (dict(DENSE, compute_dtype="bfloat16"), dict(MOE, compute_dtype="bfloat16")):
        model = Model(ModelConfig(name="t", **cfg))
        port = model.cast_params(model.init_params(torch.Generator().manual_seed(0), "cpu"))
        ours = W.make_params(lm, cfg, 5, "cpu")
        want = {k: (tuple(v.shape), v.dtype) for k, v in W.iter_leaves(port)}
        got = {k: (tuple(v.shape), v.dtype) for k, v in W.iter_leaves(ours)}
        assert got == want


def test_each_layer_is_made_again_alike():
    cfg = dict(MOE, compute_dtype="bfloat16")
    params = W.make_params(lm, cfg, 2**40 + 1, "cpu")
    for p in range(cfg["n_layers"]):
        again = W.layer_float32(lm, cfg, 2**40 + 1, p, "cpu")
        for path, t in again.items():
            leaf = params["blocks"]["pos0"]
            for key in path.split("."):
                leaf = leaf[key]
            assert torch.equal(leaf[p].float(), t), path
    other = W.layer_float32(lm, cfg, 2**40 + 2, 0, "cpu")
    same = W.layer_float32(lm, cfg, 2**40 + 1, 0, "cpu")
    assert not torch.equal(other["attn.wq"], same["attn.wq"])


def test_fake_fp8_rounds_to_three_mantissa_bits():
    x = torch.tensor([[1.0, 1.0625, 1.125, 448.0]])
    q = lm._fake_fp8(x, -1)
    assert q[0, 0] == 1.0 and q[0, 3] == 448.0
    assert q[0, 1] in (1.0, 1.125)      # halfway between two e4m3 values
