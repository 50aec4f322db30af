"""The port's ``Model`` vs the JAX ``Model`` on converted parameters.

JAX draws the parameters; ``repro_torch.convert`` carries them over, so
both sides run the same weights on the same numpy tokens. In float32
the logits agree to ~1e-6 (sums in another order), hence 1e-4; bfloat16
uses the reference's own 2e-2.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch import convert, resolve_device  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import basic as tbasic  # noqa: E402

torch.set_num_threads(1)

DENSE_ARCHS = ["smollm_135m", "qwen1_5_0_5b", "qwen3_14b", "nemotron_4_15b", "chameleon_34b"]
MOE_ARCHS = ["phi3_5_moe_42b", "grok_1_314b"]
SSM_ARCHS = ["mamba2_2_7b", "jamba_1_5_large_398b"]  # ssm; hybrid (attn + mamba + MoE)
F32 = dict(rtol=1e-4, atol=1e-4)


def _setup(arch, **kw):
    kw.setdefault("compute_dtype", "float32")
    jcfg = dataclasses.replace(jax_smoke_config(arch), **kw)
    tcfg = dataclasses.replace(smoke_config(arch), **kw)
    jparams = JaxModel(jcfg).init_params(jax.random.PRNGKey(0))
    tparams = convert.to_torch(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, b=2, s=13, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_trees_close(t_tree, j_tree, **tol):
    j_np = jax.tree.map(np.asarray, j_tree)
    t_np = convert.to_numpy(t_tree)
    assert jax.tree.structure(t_np) == jax.tree.structure(j_np)
    for a, b in zip(jax.tree.leaves(t_np), jax.tree.leaves(j_np)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32), **tol)


class TestConvert:
    @pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
    def test_round_trip(self, param_dtype):
        cfg = dataclasses.replace(jax_smoke_config("qwen1_5_0_5b"), param_dtype=param_dtype)
        np_params = jax.tree.map(np.asarray, JaxModel(cfg).init_params(jax.random.PRNGKey(1)))
        t_params = convert.to_torch(np_params)
        leaf = t_params["blocks"]["pos0"]["attn"]["wq"]
        assert leaf.dtype == getattr(torch, param_dtype)
        assert leaf.shape[0] == cfg.n_periods  # the stacked period axis is kept
        back = convert.to_numpy(t_params)
        assert jax.tree.structure(back) == jax.tree.structure(np_params)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))

    def test_init_params_structure_matches_reference(self):
        jcfg, tcfg, jparams, _ = _setup("qwen3_14b")
        tparams = Model(tcfg).init_params(torch.Generator().manual_seed(0), "cpu")
        j_shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
        t_shapes = lm.tree_map(lambda t: tuple(t.shape), tparams)
        assert t_shapes == j_shapes


class TestModelParity:
    @pytest.mark.parametrize("use_kernels", [False, True])
    @pytest.mark.parametrize("arch", DENSE_ARCHS + MOE_ARCHS + SSM_ARCHS)
    def test_prefill_and_decode_match_jax(self, arch, use_kernels):
        jcfg, tcfg, jparams, tparams = _setup(arch, use_kernels=use_kernels)
        jm, tm = JaxModel(jcfg), Model(tcfg)
        toks = _tokens(jcfg)
        s = toks.shape[1] - 1

        j_logits, j_cache = jm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :s])},
                                       jm.init_cache(2, 32))
        t_logits, t_cache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :s])},
                                       tm.init_cache(2, 32, device="cpu"))
        np.testing.assert_allclose(_np(t_logits), _np(j_logits), **F32)
        _assert_trees_close(t_cache, j_cache, **F32)

        pos = np.full((2,), s, np.int32)
        j_step, j_cache = jm.decode(jparams, j_cache, jnp.asarray(toks[:, s]), jnp.asarray(pos))
        t_step, t_cache = tm.decode(tparams, t_cache, torch.from_numpy(toks[:, s]),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(_np(t_step), _np(j_step), **F32)
        _assert_trees_close(t_cache, j_cache, **F32)
        assert int(torch.argmax(t_step[0, 0])) == int(jnp.argmax(j_step[0, 0]))

    @pytest.mark.parametrize("arch", ["smollm_135m", "qwen3_14b"] + MOE_ARCHS + ["mamba2_2_7b"])
    def test_prefill_matches_jax_in_bfloat16(self, arch):
        jcfg, tcfg, jparams, tparams = _setup(arch, compute_dtype="bfloat16", use_kernels=True)
        toks = _tokens(jcfg, s=12, seed=3)
        jm, tm = JaxModel(jcfg), Model(tcfg)
        j_logits, _ = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, jm.init_cache(2, 16))
        t_logits, _ = tm.prefill(tm.cast_params(tparams), {"tokens": torch.from_numpy(toks)},
                                 tm.init_cache(2, 16, device="cpu"))
        # The two frameworks round to bf16 at different points of each layer,
        # so the whole model is held to 2e-2 of the logits' scale.
        err = float(np.abs(_np(t_logits) - _np(j_logits)).max())
        scale = float(np.abs(_np(j_logits)).max())
        assert err / scale < 2e-2, (err, scale)

    def test_hybrid_prefill_in_bfloat16_is_within_the_references_own_noise(self):
        """jamba's smoke config is 16 layers of attention, Mamba and MoE, and
        in bf16 its logits move by ~46% of their scale against the JAX
        model's own float32 logits (rounding flips amplified by depth and
        by top-2 routing flips). The port's bf16 logits must stay within a
        quarter of that distance of JAX's bf16 logits (they are at ~5%)."""
        jcfg, tcfg, jparams, tparams = _setup("jamba_1_5_large_398b",
                                              compute_dtype="bfloat16", use_kernels=True)
        j32 = dataclasses.replace(jcfg, compute_dtype="float32")
        toks = _tokens(jcfg, s=12, seed=3)
        jm, tm = JaxModel(jcfg), Model(tcfg)
        j_logits, _ = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, jm.init_cache(2, 16))
        f_logits, _ = JaxModel(j32).prefill(jparams, {"tokens": jnp.asarray(toks)},
                                            JaxModel(j32).init_cache(2, 16))
        t_logits, _ = tm.prefill(tm.cast_params(tparams), {"tokens": torch.from_numpy(toks)},
                                 tm.init_cache(2, 16, device="cpu"))
        port_err = float(np.abs(_np(t_logits) - _np(j_logits)).max())
        ref_noise = float(np.abs(_np(j_logits) - _np(f_logits)).max())
        assert port_err < 0.25 * ref_noise, (port_err, ref_noise)

    @pytest.mark.parametrize("use_kernels", [False, True])
    @pytest.mark.parametrize("arch", DENSE_ARCHS + MOE_ARCHS + SSM_ARCHS)
    def test_forward_matches_jax(self, arch, use_kernels):
        from repro.models import lm as jax_lm

        jcfg, tcfg, jparams, tparams = _setup(arch, use_kernels=use_kernels)
        toks = _tokens(jcfg, s=9, seed=1)
        j_logits, j_aux = jax_lm.forward(jcfg, jparams, jnp.asarray(toks))
        t_logits, aux = Model(tcfg).forward(tparams, torch.from_numpy(toks))
        assert aux.dtype == torch.float32 and aux.dim() == 0
        if tcfg.moe_experts:
            assert float(aux) > 0.0  # the sum over the MoE layers
        else:
            assert float(aux) == float(j_aux) == 0.0
        np.testing.assert_allclose(float(aux), float(j_aux), **F32)
        np.testing.assert_allclose(_np(t_logits), _np(j_logits), **F32)

    @pytest.mark.parametrize("with_mask", [False, True])
    @pytest.mark.parametrize("use_kernels", [False, True])
    @pytest.mark.parametrize("arch", ["smollm_135m", "phi3_5_moe_42b"] + SSM_ARCHS)
    def test_loss_matches_jax(self, arch, use_kernels, with_mask):
        """``Model.loss`` against the JAX ``Model.loss`` in float32: with
        ``use_kernels`` the JAX side runs the Pallas kernels in interpret
        mode and the port their plain versions (the SSD scan included)."""
        jcfg, tcfg, jparams, tparams = _setup(arch, use_kernels=use_kernels)
        toks = _tokens(jcfg, s=16, seed=4)
        batch_np = {"tokens": toks}
        if with_mask:
            mask = np.ones_like(toks)
            mask[0, :5] = 0
            mask[1, 11:] = 0
            batch_np["mask"] = mask
        j_total, j_parts = JaxModel(jcfg).loss(
            jparams, {k: jnp.asarray(v) for k, v in batch_np.items()})
        t_total, t_parts = Model(tcfg).loss(
            tparams, {k: torch.from_numpy(v) for k, v in batch_np.items()})
        assert t_total.dtype == torch.float32 and t_total.dim() == 0
        np.testing.assert_allclose(float(t_total), float(j_total), **F32)
        np.testing.assert_allclose(float(t_parts["ce"]), float(j_parts["ce"]), **F32)
        np.testing.assert_allclose(float(t_parts["aux"]), float(j_parts["aux"]), **F32)

    def test_loss_with_and_without_the_kernel_agree(self):
        """As tests/test_kernels.py::test_use_kernels_config_path for
        mamba2: the scan through ``ops.ssd_scan`` and through
        ``ssd_chunked`` give the same loss (2e-3, the reference's bound)."""
        cfg = dataclasses.replace(smoke_config("mamba2_2_7b"), compute_dtype="float32")
        params = Model(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
        toks = torch.from_numpy(_tokens(cfg, s=16, seed=5))
        on, _ = Model(dataclasses.replace(cfg, use_kernels=True)).loss(params, {"tokens": toks})
        off, _ = Model(cfg).loss(params, {"tokens": toks})
        assert abs(float(on) - float(off)) < 2e-3

    def test_backward_through_the_kernel_path_raises(self):
        cfg = dataclasses.replace(smoke_config("mamba2_2_7b"), compute_dtype="float32",
                                  use_kernels=True)
        params = Model(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
        for leaf in lm.tree_leaves(params):
            leaf.requires_grad_(True)
        total, _ = Model(cfg).loss(params, {"tokens": torch.from_numpy(_tokens(cfg, s=8))})
        with pytest.raises(NotImplementedError, match="has no backward kernel.*use_kernels=False"):
            total.backward()
        # Without the kernel the plain scan is differentiable.
        off, _ = Model(dataclasses.replace(cfg, use_kernels=False)).loss(
            params, {"tokens": torch.from_numpy(_tokens(cfg, s=8))})
        off.backward()
        assert params["blocks"]["pos0"]["mamba"]["in_proj_xbc"].grad is not None


    @pytest.mark.parametrize("arch,kernel", [
        ("smollm_135m", "flash_attention"),    # dense: attention is the only kernel
        ("qwen1_5_0_5b", "flash_attention"),
        ("phi3_5_moe_42b", "gmm"),             # the last layer's expert FFN is met first
    ])
    def test_backward_through_flash_and_gmm_raises(self, arch, kernel):
        """As the mamba2 case above, for attention and the MoE FFN: each kernel
        is an autograd node whose backward raises (the Pallas kernels have no
        VJP, and ``jax.grad`` through them in interpret mode fails too). With
        ``use_kernels`` off, every parameter gets a gradient."""
        cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32", use_kernels=True)
        params = Model(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
        for leaf in lm.tree_leaves(params):
            leaf.requires_grad_(True)
        toks = torch.from_numpy(_tokens(cfg, s=8))
        total, _ = Model(cfg).loss(params, {"tokens": toks})
        with pytest.raises(NotImplementedError, match=f"{kernel} has no backward"):
            total.backward()
        off, _ = Model(dataclasses.replace(cfg, use_kernels=False)).loss(params, {"tokens": toks})
        off.backward()
        assert all(leaf.grad is not None for leaf in lm.tree_leaves(params))
        attn = params["blocks"]["pos0"]["attn"]
        assert all(float(attn[key].grad.abs().sum()) > 0 for key in ("wq", "wk", "wv", "wo"))
        if cfg.moe_experts:
            moe = params["blocks"]["pos0"]["moe"]
            assert all(float(moe[key].grad.abs().sum()) > 0
                       for key in ("w_gate", "w_up", "w_down"))


class TestModelPort:
    @pytest.mark.parametrize("arch", DENSE_ARCHS + MOE_ARCHS + SSM_ARCHS)
    def test_decode_matches_forward(self, arch):
        """As tests/test_models_smoke.py::test_decode_matches_forward, on the
        port: the capacity factor is high enough that no token is dropped,
        since capacity drops differ between routing a whole prompt and one
        token by design."""
        cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32",
                                  moe_capacity_factor=16.0)
        model = Model(cfg)
        params = model.init_params(torch.Generator().manual_seed(0), "cpu")
        bsz, s = 2, 12
        toks = torch.from_numpy(_tokens(cfg, b=bsz, s=s + 1, seed=2))
        full = model.forward(params, toks)[0][:, -1, :]
        cache = model.init_cache(bsz, 32, device="cpu")
        _, cache = model.prefill(params, {"tokens": toks[:, :s]}, cache)
        step, _ = model.decode(params, cache, toks[:, s], torch.full((bsz,), s))
        err = float((full - step[:, 0, :]).abs().max())
        scale = float(full.abs().max()) + 1e-9
        assert err / scale < 1e-4, (arch, err, scale)

    def test_cast_params_casts_the_mamba_projections_only(self):
        cfg = dataclasses.replace(smoke_config("mamba2_2_7b"), compute_dtype="bfloat16")
        model = Model(cfg)
        mamba = model.cast_params(
            model.init_params(torch.Generator().manual_seed(0), "cpu"))["blocks"]["pos0"]["mamba"]
        for key in ("in_proj_z", "in_proj_xbc", "in_proj_dt", "out_proj"):
            assert mamba[key].dtype == torch.bfloat16, key
        for key in ("conv_w", "conv_b", "a_log", "d_skip", "dt_bias", "norm_scale"):
            assert mamba[key].dtype == torch.float32, key

    @pytest.mark.parametrize("arch", SSM_ARCHS)
    def test_init_params_structure_matches_reference_ssm(self, arch):
        jcfg, tcfg, jparams, _ = _setup(arch)
        tparams = Model(tcfg).init_params(torch.Generator().manual_seed(0), "cpu")
        j_meta = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jparams)
        t_meta = lm.tree_map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tparams)
        assert t_meta == j_meta

    @pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
    def test_mamba_cache_is_float32(self, compute_dtype):
        cfg = dataclasses.replace(smoke_config("jamba_1_5_large_398b"),
                                  compute_dtype=compute_dtype)
        cache = Model(cfg).init_cache(3, 16, device="cpu")
        for i, (mixer, _) in enumerate(cfg.layer_pattern()):
            c = cache[f"pos{i}"]
            if mixer == "attn":
                assert c["k"].dtype == getattr(torch, compute_dtype)
            else:
                assert c["conv"].dtype == c["ssm"].dtype == torch.float32
                assert tuple(c["ssm"].shape) == (cfg.n_periods, 3, cfg.ssm_nheads,
                                                 cfg.ssm_headdim, cfg.ssm_state)

    def test_cast_params_casts_matmul_weights_once(self):
        cfg = dataclasses.replace(smoke_config("qwen1_5_0_5b"), compute_dtype="bfloat16")
        model = Model(cfg)
        params = model.cast_params(model.init_params(torch.Generator().manual_seed(0), "cpu"))
        attn = params["blocks"]["pos0"]["attn"]
        assert attn["wq"].dtype == attn["bq"].dtype == torch.bfloat16
        assert params["blocks"]["pos0"]["ffn"]["w_up"].dtype == torch.bfloat16
        assert params["blocks"]["pos0"]["mixer_norm"]["scale"].dtype == torch.float32
        assert params["embed"]["table"].dtype == torch.float32

    def test_init_params_keeps_the_draw_order_of_stacked_periods(self):
        """Filling the stack in place draws what stacking each period did."""
        cfg = smoke_config("smollm_135m")
        params = lm.init_params(cfg, torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(0)
        embed = tbasic.init_embedding(cfg, gen)
        periods = [lm.init_period(cfg, gen) for _ in range(cfg.n_periods)]
        final_norm = tbasic.init_norm(cfg)

        def stack(trees):
            if isinstance(trees[0], dict):
                return {key: stack([t[key] for t in trees]) for key in trees[0]}
            return torch.stack(trees)

        expect = {"embed": embed, "blocks": stack(periods), "final_norm": final_norm}
        if not cfg.tie_embeddings:
            expect["lm_head"] = tbasic.init_embedding(cfg, gen)
        got_leaves, want_leaves = list(lm.tree_leaves(params)), list(lm.tree_leaves(expect))
        assert lm.tree_map(lambda t: tuple(t.shape), params) == \
            lm.tree_map(lambda t: tuple(t.shape), expect)
        for got, want in zip(got_leaves, want_leaves):
            assert torch.equal(got, want)

    @pytest.mark.parametrize("arch", MOE_ARCHS)
    def test_moe_models_build_and_serve(self, arch):
        from repro_torch.launch import serve as serve_mod

        cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32")
        model = Model(cfg)
        params = model.init_params(torch.Generator().manual_seed(0), "cpu")
        moe = params["blocks"]["pos0"]["moe"]
        assert tuple(moe["w_up"].shape) == (cfg.n_periods, cfg.moe_experts, cfg.d_model,
                                            cfg.d_ff)
        assert model.cast_params(params)["blocks"]["pos0"]["moe"]["router"].dtype == \
            torch.float32
        result = serve_mod.serve(cfg, device="cpu", params=params,
                                 requests=serve_mod.default_requests(6),
                                 max_new_tokens=3, max_len=32)
        assert all(r.state == "done" and len(r.output) == 3 for r in result.requests)
        assert all(0 <= tok < cfg.vocab_size for r in result.requests for tok in r.output)

    def test_cuda_is_the_default_device(self):
        if torch.cuda.is_available():
            assert resolve_device().type == "cuda"
            return
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError):
            Model(smoke_config("smollm_135m")).init_params(torch.Generator())
        assert resolve_device("cpu").type == "cpu"
