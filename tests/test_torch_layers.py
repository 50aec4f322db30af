"""The port's layers (``repro_torch.models.layers``) vs the JAX layers.

Every function of ``basic.py``, ``attention.py``, ``moe.py`` and
``ssm.py`` on the ported paths gets the same numpy inputs and parameters
on both sides. Float32 agrees
to ~1e-6 (the sums run in different orders), hence 1e-5; bfloat16 uses
the reference's own 2e-2.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models.layers import attention as jatt  # noqa: E402
from repro.models.layers import basic as jbasic  # noqa: E402
from repro.models.layers import moe as jmoe  # noqa: E402
from repro.models.layers import ssm as jssm  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models.layers import attention as tatt  # noqa: E402
from repro_torch.models.layers import basic as tbasic  # noqa: E402
from repro_torch.models.layers import moe as tmoe  # noqa: E402
from repro_torch.models.layers import ssm as tssm  # noqa: E402

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _cfgs(arch="smollm_135m", **kw):
    kw.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(jax_smoke_config(arch), **kw),
            dataclasses.replace(smoke_config(arch), **kw))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _attn_params(rng, cfg):
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    p = {
        "wq": _rand(rng, d, h * hd, scale=d ** -0.5),
        "wk": _rand(rng, d, kv * hd, scale=d ** -0.5),
        "wv": _rand(rng, d, kv * hd, scale=d ** -0.5),
        "wo": _rand(rng, h * hd, d, scale=(h * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        p.update(bq=_rand(rng, h * hd, scale=0.1), bk=_rand(rng, kv * hd, scale=0.1),
                 bv=_rand(rng, kv * hd, scale=0.1))
    if cfg.qk_norm:
        p.update(q_norm=1 + _rand(rng, hd, scale=0.1), k_norm=1 + _rand(rng, hd, scale=0.1))
    return p


class TestBasic:
    @pytest.mark.parametrize("norm_kind", ["rmsnorm", "layernorm"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_apply_norm(self, norm_kind, dtype):
        jc, tc = _cfgs(norm_kind=norm_kind)
        rng = np.random.default_rng(0)
        x = _rand(rng, 2, 5, jc.d_model, scale=3.0)
        params = {"scale": 1 + _rand(rng, jc.d_model, scale=0.1)}
        if norm_kind == "layernorm":
            params["bias"] = _rand(rng, jc.d_model, scale=0.1)
        out = tbasic.apply_norm(tc, _t(params), _t(x).to(getattr(torch, dtype)))
        expect = jbasic.apply_norm(jc, _j(params), _j(x).astype(dtype))
        assert str(out.dtype).endswith(dtype)
        np.testing.assert_allclose(_np(out), _np(expect), **(F32 if dtype == "float32" else BF16))

    def test_rms_norm_headwise(self):
        rng = np.random.default_rng(1)
        x, scale = _rand(rng, 2, 3, 4, 16), 1 + _rand(rng, 16, scale=0.1)
        np.testing.assert_allclose(
            _np(tbasic.rms_norm_headwise(_t(x), _t(scale), 1e-6)),
            _np(jbasic.rms_norm_headwise(_j(x), _j(scale), 1e-6)), **F32)

    @pytest.mark.parametrize("head_dim,theta", [(16, 10_000.0), (64, 1_000_000.0)])
    def test_rope(self, head_dim, theta):
        rng = np.random.default_rng(2)
        x = _rand(rng, 2, 7, 3, head_dim)
        positions = rng.integers(0, 500, size=(2, 7)).astype(np.int32)
        np.testing.assert_allclose(
            _np(tbasic.rope_frequencies(head_dim, theta)),
            _np(jbasic.rope_frequencies(head_dim, theta)), rtol=1e-6)
        # The angles reach ~500 rad, where float32 sin/cos differ by ulps.
        np.testing.assert_allclose(
            _np(tbasic.apply_rope(_t(x), _t(positions), theta)),
            _np(jbasic.apply_rope(_j(x), _j(positions), theta)), rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("softcap", [0.0, 5.0])
    def test_embed_and_unembed(self, softcap):
        jc, tc = _cfgs(logit_softcap=softcap)
        rng = np.random.default_rng(3)
        table = _rand(rng, jc.vocab_size, jc.d_model)
        tokens = rng.integers(0, jc.vocab_size, size=(2, 9)).astype(np.int32)
        emb_t = tbasic.embed(tc, {"table": _t(table)}, _t(tokens))
        emb_j = jbasic.embed(jc, {"table": _j(table)}, _j(tokens))
        np.testing.assert_array_equal(_np(emb_t), _np(emb_j))
        logits_t = tbasic.unembed(tc, {"table": _t(table)}, emb_t)
        logits_j = jbasic.unembed(jc, {"table": _j(table)}, emb_j)
        assert logits_t.dtype == torch.float32
        np.testing.assert_allclose(_np(logits_t), _np(logits_j), rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("mlp_kind", ["swiglu", "geglu", "squared_relu", "gelu"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_apply_ffn(self, mlp_kind, dtype):
        jc, tc = _cfgs(mlp_kind=mlp_kind, compute_dtype=dtype)
        rng = np.random.default_rng(4)
        d, f = jc.d_model, jc.d_ff
        params = {"w_up": _rand(rng, d, f, scale=d ** -0.5),
                  "w_down": _rand(rng, f, d, scale=f ** -0.5)}
        if mlp_kind in ("swiglu", "geglu"):
            params["w_gate"] = _rand(rng, d, f, scale=d ** -0.5)
        x = _rand(rng, 2, 5, d)
        out = tbasic.apply_ffn(tc, _t(params), _t(x))
        expect = jbasic.apply_ffn(jc, _j(params), _j(x))
        np.testing.assert_allclose(_np(out), _np(expect), **(F32 if dtype == "float32" else BF16))

    @pytest.mark.parametrize("arch", ["nemotron_4_15b", "qwen1_5_0_5b", "qwen3_14b"])
    def test_init_shapes_match_reference(self, arch):
        import jax

        jc, tc = _cfgs(arch)
        gen, key = torch.Generator().manual_seed(0), jax.random.PRNGKey(0)
        for name, t_tree, j_tree in [
            ("ffn", tbasic.init_ffn(tc, gen), jbasic.init_ffn(jc, key)),
            ("norm", tbasic.init_norm(tc), jbasic.init_norm(jc)),
            ("embed", tbasic.init_embedding(tc, gen), jbasic.init_embedding(jc, key)),
            ("attn", tatt.init_attention(tc, gen), jatt.init_attention(jc, key)),
        ]:
            assert t_tree.keys() == j_tree.keys(), name
            for key in t_tree:
                assert tuple(t_tree[key].shape) == tuple(j_tree[key].shape), (name, key)
                assert str(t_tree[key].dtype).split(".")[-1] == str(j_tree[key].dtype)


ATTN_ARCHS = ["smollm_135m", "qwen1_5_0_5b", "qwen3_14b"]  # plain, qkv bias, qk-norm


class TestAttention:
    @pytest.mark.parametrize("arch", ATTN_ARCHS)
    def test_project_qkv(self, arch):
        jc, tc = _cfgs(arch)
        rng = np.random.default_rng(5)
        params = _attn_params(rng, jc)
        x = _rand(rng, 2, 6, jc.d_model)
        positions = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
        for got, want in zip(
            tatt._project_qkv(tc, _t(params), _t(x), positions=_t(positions)),
            jatt._project_qkv(jc, _j(params), _j(x), positions=_j(positions)),
        ):
            np.testing.assert_allclose(_np(got), _np(want), **F32)

    def test_sdpa_with_mask(self):
        rng = np.random.default_rng(6)
        q, k, v = _rand(rng, 2, 5, 4, 16), _rand(rng, 2, 7, 2, 16), _rand(rng, 2, 7, 2, 16)
        mask = rng.integers(0, 2, size=(2, 1, 1, 5, 7)).astype(bool)
        mask[..., 0] = True
        np.testing.assert_allclose(
            _np(tatt._sdpa(_t(q), _t(k), _t(v), _t(mask))),
            _np(jatt._sdpa(_j(q), _j(k), _j(v), _j(mask))), **F32)

    @pytest.mark.parametrize("arch", ATTN_ARCHS)
    @pytest.mark.parametrize("use_kernels", [False, True])
    def test_attend_full(self, arch, use_kernels):
        jc, tc = _cfgs(arch, use_kernels=use_kernels)
        rng = np.random.default_rng(7)
        params = _attn_params(rng, jc)
        x = _rand(rng, 2, 12, jc.d_model)
        positions = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
        np.testing.assert_allclose(
            _np(tatt.attend_full(tc, _t(params), _t(x), _t(positions))),
            _np(jatt.attend_full(jc, _j(params), _j(x), _j(positions))), **F32)

    @pytest.mark.parametrize("kv_cache_dtype", ["compute", "int8"])
    def test_attend_cached_masks_past_position(self, kv_cache_dtype):
        jc, tc = _cfgs(kv_cache_dtype=kv_cache_dtype)
        rng = np.random.default_rng(8)
        params = _attn_params(rng, jc)
        b, t = 3, 10
        # Garbage past each row's position must not leak into the output.
        kv_shape = (b, t, jc.n_kv_heads, jc.head_dim)
        k_np, v_np = _rand(rng, *kv_shape, scale=5.0), _rand(rng, *kv_shape, scale=5.0)
        if kv_cache_dtype == "int8":
            ck_np = {k: np.asarray(a) for k, a in jatt.quant_kv(jnp.asarray(k_np)).items()}
            cv_np = {k: np.asarray(a) for k, a in jatt.quant_kv(jnp.asarray(v_np)).items()}
        else:
            ck_np, cv_np = k_np, v_np
        x = _rand(rng, b, 1, jc.d_model)
        position = np.array([0, 4, 9], np.int32)
        out_t, ck_t, cv_t = tatt.attend_cached(tc, _t(params), _t(x), _t(ck_np), _t(cv_np),
                                               _t(position).long())
        out_j, ck_j, cv_j = jatt.attend_cached(jc, _j(params), _j(x), _j(ck_np), _j(cv_np),
                                               _j(position))
        np.testing.assert_allclose(_np(out_t), _np(out_j), **F32)
        if kv_cache_dtype == "int8":
            for key in ("q", "scale"):
                np.testing.assert_allclose(_np(ck_t[key]), _np(ck_j[key]), **F32)
                np.testing.assert_allclose(_np(cv_t[key]), _np(cv_j[key]), **F32)
        else:
            np.testing.assert_allclose(_np(ck_t), _np(ck_j), **F32)
            np.testing.assert_allclose(_np(cv_t), _np(cv_j), **F32)
        # Changing what lies past the positions changes nothing.
        poisoned = (k_np.copy(), v_np.copy())
        for row, pos in enumerate(position):
            poisoned[0][row, pos + 1:] = 1e3
            poisoned[1][row, pos + 1:] = -1e3
        if kv_cache_dtype == "int8":
            poisoned = tuple({k: torch.from_numpy(np.array(a)) for k, a in
                              jatt.quant_kv(jnp.asarray(p)).items()} for p in poisoned)
        else:
            poisoned = tuple(torch.from_numpy(p) for p in poisoned)
        out_p, _, _ = tatt.attend_cached(tc, _t(params), _t(x), *poisoned, _t(position).long())
        np.testing.assert_allclose(_np(out_p), _np(out_t), **F32)

    @pytest.mark.parametrize("kv_cache_dtype", ["compute", "int8"])
    def test_kv_cache_init_and_writes(self, kv_cache_dtype):
        jc, tc = _cfgs(kv_cache_dtype=kv_cache_dtype)
        rng = np.random.default_rng(9)
        tk, _ = tatt.init_kv_cache(tc, 2, 8, torch.float32)
        jk, _ = jatt.init_kv_cache(jc, 2, 8, jnp.float32)
        new_prefix = _rand(rng, 2, 5, jc.n_kv_heads, jc.head_dim)
        tk = tatt.write_kv_prefix(tc, tk, _t(new_prefix), 5)
        jk = jatt.write_kv_prefix(jc, jk, _j(new_prefix), 5)
        new_one = _rand(rng, 2, jc.n_kv_heads, jc.head_dim)
        rows, pos = np.arange(2), np.array([5, 7], np.int32)
        tk = tatt.write_kv(tc, tk, _t(new_one), _t(rows), _t(pos).long())
        jk = jatt.write_kv(jc, jk, _j(new_one), _j(rows), _j(pos))
        if kv_cache_dtype == "int8":
            assert tk.keys() == jk.keys()
            for key in tk:
                assert str(tk[key].dtype).split(".")[-1] == str(jk[key].dtype)
                np.testing.assert_allclose(_np(tk[key]), _np(jk[key]), **F32)
        else:
            np.testing.assert_allclose(_np(tk), _np(jk), **F32)

    def test_quant_dequant(self):
        rng = np.random.default_rng(10)
        x = _rand(rng, 3, 4, 2, 16, scale=4.0)
        x[0, 0, 0] = 0.0  # all-zero row: the scale floor
        qt, qj = tatt.quant_kv(_t(x)), jatt.quant_kv(_j(x))
        np.testing.assert_array_equal(qt["q"].numpy(), np.asarray(qj["q"]))
        np.testing.assert_allclose(qt["scale"].numpy(), np.asarray(qj["scale"]), rtol=1e-6)
        np.testing.assert_allclose(
            _np(tatt.dequant_kv(qt, torch.float32)), _np(jatt.dequant_kv(qj, jnp.float32)),
            rtol=1e-6)


MOE_ARCHS = ["phi3_5_moe_42b", "grok_1_314b"]  # swiglu + layernorm, geglu + rmsnorm


def _moe_params(rng, cfg):
    e, d, f = cfg.moe_experts, cfg.d_model, cfg.d_ff
    p = {"router": _rand(rng, d, e, scale=d ** -0.5),
         "w_up": _rand(rng, e, d, f, scale=d ** -0.5),
         "w_down": _rand(rng, e, f, d, scale=f ** -0.5)}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        p["w_gate"] = _rand(rng, e, d, f, scale=d ** -0.5)
    return p


def _pairs_dropped(cfg, ids, n_tokens):
    """(token, k) pairs over their expert's capacity, from the router's ids."""
    counts = np.bincount(np.asarray(ids).reshape(-1), minlength=cfg.moe_experts)
    return int(np.maximum(counts - tmoe.moe_capacity(cfg, n_tokens), 0).sum())


class TestMoe:
    def test_capacity_matches_reference(self):
        for arch in MOE_ARCHS:
            jc, tc = _cfgs(arch)
            for factor in (1.0, 1.25, 2.0, 16.0):
                jf = dataclasses.replace(jc, moe_capacity_factor=factor)
                tf = dataclasses.replace(tc, moe_capacity_factor=factor)
                for t in range(1, 2049):
                    assert tmoe.moe_capacity(tf, t) == jmoe.moe_capacity(jf, t), (arch, factor, t)

    @pytest.mark.parametrize("arch", MOE_ARCHS)
    def test_init_shapes_match_reference(self, arch):
        import jax

        jc, tc = _cfgs(arch)
        t_tree = tmoe.init_moe(tc, torch.Generator().manual_seed(0))
        j_tree = jmoe.init_moe(jc, jax.random.PRNGKey(0))
        assert t_tree.keys() == j_tree.keys()
        for key in t_tree:
            assert tuple(t_tree[key].shape) == tuple(j_tree[key].shape), key
            assert str(t_tree[key].dtype).split(".")[-1] == str(j_tree[key].dtype)

    @pytest.mark.parametrize("arch", MOE_ARCHS)
    def test_route(self, arch):
        jc, tc = _cfgs(arch)
        rng = np.random.default_rng(11)
        params = _moe_params(rng, jc)
        x = _rand(rng, 96, jc.d_model)
        ids_t, gates_t, aux_t = tmoe.route(tc, _t(params), _t(x))
        ids_j, gates_j, aux_j = jmoe.route(jc, _j(params), _j(x))
        # A mismatch of ids here would mean an exact tie in the router's
        # probabilities, which torch.topk and lax.top_k may order differently.
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        np.testing.assert_allclose(_np(gates_t), _np(gates_j), **F32)
        np.testing.assert_allclose(float(aux_t), float(aux_j), **F32)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("use_kernels", [False, True])
    @pytest.mark.parametrize("arch", MOE_ARCHS)
    def test_apply_moe(self, arch, use_kernels, dtype):
        jc, tc = _cfgs(arch, use_kernels=use_kernels, compute_dtype=dtype)
        rng = np.random.default_rng(12)
        params = _moe_params(rng, jc)
        x = _rand(rng, 2, 24, jc.d_model)
        out_t, aux_t = tmoe.apply_moe(tc, _t(params), _t(x).to(getattr(torch, dtype)))
        out_j, aux_j = jmoe.apply_moe(jc, _j(params), _j(x).astype(dtype))
        assert out_t.dtype == getattr(torch, dtype) and aux_t.dtype == torch.float32
        assert out_t.shape == x.shape
        tol = F32 if dtype == "float32" else BF16
        np.testing.assert_allclose(_np(out_t), _np(out_j), **tol)
        np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-4)

    @pytest.mark.parametrize("factor,drops", [(1.25, True), (16.0, False)])
    def test_apply_moe_with_and_without_drops(self, factor, drops):
        """At the default factor this input overflows an expert (pairs are
        dropped, by the sacrificial slot); at 16 nothing is dropped."""
        jc, tc = _cfgs("phi3_5_moe_42b", moe_capacity_factor=factor, use_kernels=True)
        rng = np.random.default_rng(13)
        params = _moe_params(rng, jc)
        # Push every token towards expert 0, so that its 40 slots overflow.
        r0 = params["router"][:, 0]
        x = _rand(rng, 1, 64, jc.d_model) + 3.0 * r0 / np.linalg.norm(r0)
        ids, _, _ = tmoe.route(tc, _t(params), _t(x[0]))
        assert (_pairs_dropped(tc, ids, 64) > 0) == drops
        out_t, _ = tmoe.apply_moe(tc, _t(params), _t(x))
        out_j, _ = jmoe.apply_moe(jc, _j(params), _j(x))
        np.testing.assert_allclose(_np(out_t), _np(out_j), **F32)

    @pytest.mark.parametrize("use_kernels", [False, True])
    @pytest.mark.parametrize("tokens", [1, 3])
    def test_apply_moe_with_unreached_experts(self, tokens, use_kernels):
        """A decode step's few tokens over 16 experts: the dispatch's offsets
        count each expert's pairs (most experts none, which the kernel
        skips), and the output still matches the JAX package's."""
        jc, tc = _cfgs("phi3_5_moe_42b", moe_experts=16, use_kernels=use_kernels)
        rng = np.random.default_rng(14)
        params = _moe_params(rng, jc)
        x = _rand(rng, tokens, 1, jc.d_model)
        ids, _, _ = tmoe.route(tc, _t(params), _t(x[:, 0]))
        offsets = tmoe._dispatch(tc, _t(params["router"]), _t(x[:, 0]))[-1]
        counts = np.bincount(ids.numpy().reshape(-1), minlength=16)
        np.testing.assert_array_equal(np.diff(offsets.numpy()), counts)
        assert offsets[0] == 0 and (counts == 0).sum() >= 16 - 2 * tokens
        out_t, _ = tmoe.apply_moe(tc, _t(params), _t(x))
        out_j, _ = jmoe.apply_moe(jc, _j(params), _j(x))
        np.testing.assert_allclose(_np(out_t), _np(out_j), **F32)

    @pytest.mark.parametrize("use_kernels", [False, True])
    def test_the_expert_ffn_gets_the_dispatchs_offsets(self, monkeypatch, use_kernels):
        """``_moe_group`` hands the dispatch's offsets to the expert FFN it
        picks: the kernel's, which skips by them, or the plain one."""
        from repro_torch.kernels import ops

        jc, tc = _cfgs("phi3_5_moe_42b", moe_experts=16, use_kernels=use_kernels)
        rng = np.random.default_rng(15)
        params = _t(_moe_params(rng, jc))
        x = _t(_rand(rng, 3, jc.d_model))
        target, name = (ops, "moe_ffn_gmm") if use_kernels else (tmoe, "_expert_ffn")
        ffn, seen = getattr(target, name), []

        def spy(cfg, params, buffer, offsets=None):
            seen.append(offsets)
            return ffn(cfg, params, buffer, offsets)

        monkeypatch.setattr(target, name, spy)
        tmoe._moe_group(tc, params, x)
        expect = tmoe._dispatch(tc, params["router"], x)[-1]
        assert len(seen) == 1 and torch.equal(seen[0], expect)


def _ssd_inputs(rng, b, s, h, p, g, n):
    """Inputs as the Mamba block makes them: dt = softplus(...) > 0, A < 0."""
    x = _rand(rng, b, s, h, p)
    dt = np.log1p(np.exp(_rand(rng, b, s, h))).astype(np.float32)
    a = -np.exp(_rand(rng, h, scale=0.5)).astype(np.float32)
    return x, dt, a, _rand(rng, b, s, g, n), _rand(rng, b, s, g, n)


def _mamba_params(rng, cfg):
    d, di, g, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_nheads
    conv_dim = di + 2 * g * n
    return {
        "in_proj_z": _rand(rng, d, di, scale=d ** -0.5),
        "in_proj_xbc": _rand(rng, d, conv_dim, scale=d ** -0.5),
        "in_proj_dt": _rand(rng, d, h, scale=d ** -0.5),
        "conv_w": _rand(rng, cfg.ssm_conv, conv_dim, scale=0.5),
        "conv_b": _rand(rng, conv_dim, scale=0.1),
        "a_log": np.log(np.linspace(1.0, 16.0, h)).astype(np.float32),
        "d_skip": 1 + _rand(rng, h, scale=0.1),
        "dt_bias": np.log(np.expm1(np.exp(rng.uniform(np.log(1e-3), np.log(0.1), h))))
        .astype(np.float32),
        "norm_scale": 1 + _rand(rng, di, scale=0.1),
        "out_proj": _rand(rng, di, d, scale=di ** -0.5),
    }


SSM_ARCHS = ["mamba2_2_7b", "jamba_1_5_large_398b"]


class TestSsm:
    def test_segsum(self):
        a = _rand(np.random.default_rng(20), 2, 3, 9)
        np.testing.assert_allclose(_np(tssm.segsum(_t(a))), _np(jssm.segsum(_j(a))), **F32)

    @pytest.mark.parametrize("with_initial_state", [False, True])
    @pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
        (2, 32, 4, 8, 1, 16, 8), (1, 30, 4, 8, 2, 8, 8), (2, 5, 2, 4, 1, 8, 8),
    ])
    def test_ssd_chunked(self, b, s, h, p, g, n, chunk, with_initial_state):
        rng = np.random.default_rng(21)
        inputs = _ssd_inputs(rng, b, s, h, p, g, n)
        init = _rand(rng, b, h, p, n) if with_initial_state else None
        y_t, st_t = tssm.ssd_chunked(*map(_t, inputs), chunk,
                                     None if init is None else _t(init))
        y_j, st_j = jssm.ssd_chunked(*map(_j, inputs), chunk,
                                     None if init is None else _j(init))
        assert y_t.dtype == st_t.dtype == torch.float32
        assert tuple(st_t.shape) == (b, h, p, n)
        np.testing.assert_allclose(_np(y_t), _np(y_j), **F32)
        np.testing.assert_allclose(_np(st_t), _np(st_j), **F32)

    def test_ssd_step(self):
        rng = np.random.default_rng(22)
        b, h, p, g, n = 3, 4, 8, 2, 16
        x, dt = _rand(rng, b, h, p), np.log1p(np.exp(_rand(rng, b, h))).astype(np.float32)
        a = -np.exp(_rand(rng, h, scale=0.5)).astype(np.float32)
        b_vec, c_vec, state = _rand(rng, b, g, n), _rand(rng, b, g, n), _rand(rng, b, h, p, n)
        args = (x, dt, a, b_vec, c_vec, state)
        for got, want in zip(tssm.ssd_step(*map(_t, args)), jssm.ssd_step(*map(_j, args))):
            np.testing.assert_allclose(_np(got), _np(want), **F32)

    def test_steps_continue_the_chunked_scan(self):
        """ssd_step from ssd_chunked's final state gives the next output of
        a scan over the longer sequence (decode continues prefill)."""
        rng = np.random.default_rng(23)
        x, dt, a, bm, cm = map(_t, _ssd_inputs(rng, 1, 17, 2, 4, 1, 8))
        y_all, _ = tssm.ssd_chunked(x, dt, a, bm, cm, 8)
        _, state = tssm.ssd_chunked(x[:, :16], dt[:, :16], a, bm[:, :16], cm[:, :16], 8)
        y_step, _ = tssm.ssd_step(x[:, 16], dt[:, 16], a, bm[:, 16], cm[:, 16], state)
        np.testing.assert_allclose(_np(y_step), _np(y_all[:, 16]), **F32)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_causal_conv(self, dtype):
        rng = np.random.default_rng(24)
        x, w, bias = _rand(rng, 2, 7, 12), _rand(rng, 4, 12), _rand(rng, 12)
        out = tssm._causal_conv(_t(x).to(getattr(torch, dtype)), _t(w), _t(bias))
        expect = jssm._causal_conv(_j(x).astype(dtype), _j(w), _j(bias))
        assert str(out.dtype).endswith(dtype)
        np.testing.assert_allclose(_np(out), _np(expect), **(F32 if dtype == "float32" else BF16))

    def test_gated_rmsnorm(self):
        rng = np.random.default_rng(25)
        y, z, scale = _rand(rng, 2, 5, 16), _rand(rng, 2, 5, 16), 1 + _rand(rng, 16, scale=0.1)
        out = tssm._gated_rmsnorm(_t(y), _t(z), _t(scale), 1e-5)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(_np(out), _np(jssm._gated_rmsnorm(_j(y), _j(z), _j(scale),
                                                                     1e-5)), **F32)

    @pytest.mark.parametrize("arch", SSM_ARCHS)
    @pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
    def test_init_shapes_match_reference(self, arch, param_dtype):
        import jax

        jc, tc = _cfgs(arch, param_dtype=param_dtype)
        t_tree = tssm.init_mamba(tc, torch.Generator().manual_seed(0))
        j_tree = jssm.init_mamba(jc, jax.random.PRNGKey(0))
        assert t_tree.keys() == j_tree.keys()
        for key in t_tree:
            assert tuple(t_tree[key].shape) == tuple(j_tree[key].shape), key
            assert str(t_tree[key].dtype).split(".")[-1] == str(j_tree[key].dtype), key
        # The deterministic leaves are equal; dt_bias is softplus⁻¹ of [1e-3, 0.1].
        for key in ("a_log", "d_skip", "conv_b", "norm_scale"):
            np.testing.assert_allclose(_np(t_tree[key]), _np(j_tree[key]), rtol=1e-6)
        dt = torch.nn.functional.softplus(t_tree["dt_bias"])
        assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("use_kernels", [False, True])
    @pytest.mark.parametrize("s", [16, 13, 5])  # chunk multiple, ragged tail, S < chunk
    def test_apply_mamba(self, s, use_kernels, dtype):
        jc, tc = _cfgs("mamba2_2_7b", use_kernels=use_kernels, compute_dtype=dtype)
        rng = np.random.default_rng(26)
        params = _mamba_params(rng, jc)
        x = _rand(rng, 2, s, jc.d_model)
        out_t = tssm.apply_mamba(tc, _t(params), _t(x).to(getattr(torch, dtype)))
        out_j = jssm.apply_mamba(jc, _j(params), _j(x).astype(dtype))
        assert out_t.dtype == getattr(torch, dtype) and out_t.shape == x.shape
        np.testing.assert_allclose(_np(out_t), _np(out_j), **(F32 if dtype == "float32" else BF16))

    def test_apply_mamba_with_initial_state(self):
        jc, tc = _cfgs("mamba2_2_7b")
        rng = np.random.default_rng(27)
        params = _mamba_params(rng, jc)
        x = _rand(rng, 2, 12, jc.d_model)
        init = _rand(rng, 2, jc.ssm_nheads, jc.ssm_headdim, jc.ssm_state)
        np.testing.assert_allclose(
            _np(tssm.apply_mamba(tc, _t(params), _t(x), initial_state=_t(init))),
            _np(jssm.apply_mamba(jc, _j(params), _j(x), initial_state=_j(init))), **F32)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_apply_mamba_step(self, dtype):
        jc, tc = _cfgs("mamba2_2_7b", compute_dtype=dtype)
        rng = np.random.default_rng(28)
        params = _mamba_params(rng, jc)
        x = _rand(rng, 3, 1, jc.d_model)
        cache = {k: _rand(rng, *v.shape) for k, v in tssm.init_mamba_cache(tc, 3).items()}
        t_cache = _t(cache)
        out_t, t_cache = tssm.apply_mamba_step(tc, _t(params), _t(x).to(getattr(torch, dtype)),
                                               t_cache)
        out_j, j_cache = jssm.apply_mamba_step(jc, _j(params), _j(x).astype(dtype), _j(cache))
        tol = F32 if dtype == "float32" else BF16
        np.testing.assert_allclose(_np(out_t), _np(out_j), **tol)
        for key in ("conv", "ssm"):
            assert t_cache[key].dtype == torch.float32
            assert str(j_cache[key].dtype) == "float32"
            np.testing.assert_allclose(_np(t_cache[key]), _np(j_cache[key]), **tol)

    def test_step_leaves_other_rows_alone(self):
        """A decode step updates each row's cache from that row alone, so a
        free slot's step leaves the other slots' state as it was."""
        _, tc = _cfgs("mamba2_2_7b")
        rng = np.random.default_rng(29)
        params = _t(_mamba_params(rng, tc))
        cache = _t({k: _rand(rng, *v.shape) for k, v in tssm.init_mamba_cache(tc, 3).items()})
        x = _t(_rand(rng, 3, 1, tc.d_model))
        alone = {k: v[1:2].clone() for k, v in cache.items()}
        out_all, _ = tssm.apply_mamba_step(tc, params, x, cache)
        out_one, _ = tssm.apply_mamba_step(tc, params, x[1:2], alone)
        np.testing.assert_allclose(_np(out_all[1:2]), _np(out_one), **F32)
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(_np(cache[key][1:2]), _np(alone[key]), **F32)

    @pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
    def test_cache_is_float32(self, compute_dtype):
        jc, tc = _cfgs("mamba2_2_7b", compute_dtype=compute_dtype)
        t_cache = tssm.init_mamba_cache(tc, 2)
        j_cache = jssm.init_mamba_cache(jc, 2)
        for key in ("conv", "ssm"):
            assert t_cache[key].dtype == torch.float32
            assert tuple(t_cache[key].shape) == tuple(j_cache[key].shape)
            assert str(j_cache[key].dtype) == "float32"
