"""The port's enc-dec family (``repro_torch.models.encdec``) vs the JAX package.

JAX draws whisper-small's smoke parameters; every leaf is then moved by
seeded noise (so the zero biases and unit norms of a fresh draw are
exercised too) and both sides run the same numpy weights, frames and
tokens. Tolerances: float32 to 1e-4 of the reference's scale (sums in
another order), bfloat16 to the reference's own 2e-2 of scale. The
serving check compares the port's engine with a greedy loop over the JAX
model functions: the JAX engine cannot serve enc-dec (it feeds frames as
long as the prompt into a cross cache of ``max_len``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.models.layers import attention as jax_attention  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import Model, encdec, lm  # noqa: E402
from repro_torch.models.layers import attention  # noqa: E402

torch.set_num_threads(1)

ARCH = "whisper_small"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max abs error / the reference's max abs


def _setup(**kw):
    kw.setdefault("compute_dtype", "float32")
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **kw)
    tcfg = dataclasses.replace(smoke_config(ARCH), **kw)
    rng = np.random.default_rng(7)
    np_params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
        JaxModel(jcfg).init_params(jax.random.PRNGKey(0)),
    )
    return jcfg, tcfg, jax.tree.map(jnp.asarray, np_params), convert.to_torch(np_params)


def _inputs(cfg, b=2, s_enc=10, s_dec=9, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, s_enc, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s_dec)).astype(np.int32)
    return frames, tokens


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype="float32"):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max()) + 1e-9
    assert err / scale <= TOL[dtype], (err, scale)


def test_param_tree_matches_reference():
    jcfg, tcfg, jparams, _ = _setup()
    tparams = Model(tcfg).init_params(torch.Generator().manual_seed(0), "cpu")
    j_shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jparams)
    t_shapes = lm.tree_map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]), tparams)
    assert t_shapes == j_shapes
    cross = tparams["decoder"]["cross_attn"]
    assert sorted(cross) == ["wk", "wo", "wq", "wv"]  # no bias, no qk-norm
    assert "bq" in tparams["decoder"]["self_attn"] and "bq" in tparams["encoder"]["attn"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_cross_matches_jax(dtype):
    jcfg, tcfg, jparams, tparams = _setup(compute_dtype=dtype)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 11, jcfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["decoder"]["cross_attn"])
    tp = lm.tree_map(lambda t: t[0], tparams["decoder"]["cross_attn"])
    want = jax_attention.attend_cross(jcfg, jp, jnp.asarray(x), jnp.asarray(enc))
    got = attention.attend_cross(tcfg, tp, torch.from_numpy(x), torch.from_numpy(enc))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("what", ["encode", "decode_full", "loss_fn"])
def test_model_functions_match_jax(what, dtype):
    jcfg, tcfg, jparams, tparams = _setup(compute_dtype=dtype)
    frames, tokens = _inputs(jcfg)
    jf, jt = jnp.asarray(frames), jnp.asarray(tokens)
    tf, tt = torch.from_numpy(frames), torch.from_numpy(tokens)
    if what == "encode":
        _close(encdec.encode(tcfg, tparams, tf), jax_encdec.encode(jcfg, jparams, jf), dtype)
    elif what == "decode_full":
        j_enc = jax_encdec.encode(jcfg, jparams, jf)
        t_enc = encdec.encode(tcfg, tparams, tf)
        _close(encdec.decode_full(tcfg, tparams, tt, t_enc),
               jax_encdec.decode_full(jcfg, jparams, jt, j_enc), dtype)
    else:
        batch = {"frames": tf, "tokens": tt}
        got, parts = Model(tcfg).loss(tparams, batch)
        want, _ = JaxModel(jcfg).loss(jparams, {"frames": jf, "tokens": jt})
        _close(got, want, dtype)
        assert float(parts["aux"]) == 0.0 and float(parts["ce"]) == float(got)


def test_prefill_caches_and_decode_step_match_jax():
    jcfg, tcfg, jparams, tparams = _setup()
    frames, tokens = _inputs(jcfg, s_enc=12, s_dec=7, seed=2)
    jm, tm = JaxModel(jcfg), Model(tcfg)
    s, enc_len, max_len = tokens.shape[1] - 1, frames.shape[1], 16
    j_logits, j_cache = jm.prefill(
        jparams, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens[:, :s])},
        jm.init_cache(2, max_len, enc_len=enc_len))
    t_logits, t_cache = tm.prefill(
        tparams, {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens[:, :s])},
        tm.init_cache(2, max_len, enc_len=enc_len, device="cpu"))
    _close(t_logits, j_logits)
    assert sorted(t_cache) == sorted(j_cache) == ["cross_k", "cross_v", "self_k", "self_v"]
    for key in t_cache:
        assert tuple(t_cache[key].shape) == tuple(j_cache[key].shape)
        _close(t_cache[key], j_cache[key])

    pos = np.full((2,), s, np.int32)
    j_step, j_cache = jm.decode(jparams, j_cache, jnp.asarray(tokens[:, s]), jnp.asarray(pos))
    t_step, t_cache = tm.decode(tparams, t_cache, torch.from_numpy(tokens[:, s]),
                                torch.from_numpy(pos))
    _close(t_step, j_step)
    for key in t_cache:
        _close(t_cache[key], j_cache[key])


def test_decode_matches_forward():
    """As ``tests/test_models_smoke.py::test_decode_matches_forward``."""
    _, tcfg, _, tparams = _setup()
    frames, tokens = _inputs(tcfg, s_enc=12, s_dec=13, seed=4)
    tf, tt = torch.from_numpy(frames), torch.from_numpy(tokens)
    s = tokens.shape[1] - 1
    model = Model(tcfg)
    full = encdec.decode_full(tcfg, tparams, tt, encdec.encode(tcfg, tparams, tf))[:, -1, :]
    _, cache = model.prefill(tparams, {"frames": tf, "tokens": tt[:, :s]},
                             model.init_cache(2, 32, enc_len=frames.shape[1], device="cpu"))
    step, _ = model.decode(tparams, cache, tt[:, s], torch.full((2,), s, dtype=torch.int32))
    err = float((full - step[:, 0, :]).abs().max())
    assert err / (float(full.abs().max()) + 1e-9) < 1e-4


@pytest.mark.parametrize("what", ["encode", "prefill"])
def test_use_kernels_on_the_cpu_equals_plain(what):
    """On the CPU the flash wrapper runs its plain version, non-causal in the encoder."""
    _, tcfg, _, tparams = _setup()
    frames, tokens = _inputs(tcfg, s_enc=12, s_dec=7, seed=5)
    tf, tt = torch.from_numpy(frames), torch.from_numpy(tokens)
    out = {}
    for use_kernels in (False, True):
        cfg = dataclasses.replace(tcfg, use_kernels=use_kernels)
        if what == "encode":
            out[use_kernels] = encdec.encode(cfg, tparams, tf)
        else:
            model = Model(cfg)
            out[use_kernels], _ = model.prefill(
                tparams, {"frames": tf, "tokens": tt},
                model.init_cache(2, 16, enc_len=12, device="cpu"))
    torch.testing.assert_close(out[True], out[False], rtol=1e-5, atol=1e-5)


def _jax_greedy(cfg, params, prompt, max_new_tokens, max_len, enc_len):
    """Greedy decoding through the JAX model functions, one request at a time,
    with zero frames of ``enc_len`` (what the port's engine feeds)."""
    model = JaxModel(cfg)
    frames = jnp.zeros((1, enc_len, cfg.d_model), jnp.float32)
    logits, cache = model.prefill(
        params, {"frames": frames, "tokens": jnp.asarray([prompt], jnp.int32)},
        model.init_cache(1, max_len, enc_len=enc_len))
    out = [int(jnp.argmax(logits[0, -1]))]
    position = len(prompt)
    while len(out) < max_new_tokens and position < max_len - 1:
        logits, cache = model.decode(params, cache, jnp.asarray([out[-1]], jnp.int32),
                                     jnp.asarray([position], jnp.int32))
        out.append(int(jnp.argmax(logits[0, 0])))
        position += 1
    return out


@pytest.mark.parametrize("use_kernels", [False, True])
def test_engine_serves_whisper_like_the_jax_model_loop(use_kernels):
    """Each request's float32 greedy tokens through the port's tAPP engine
    equal a greedy loop over JAX ``encdec.prefill``/``decode_step``."""
    jcfg, tcfg, jparams, tparams = _setup()
    max_len, enc_len, new = 24, 20, 5
    rng = np.random.default_rng(11)
    requests = [(rng.integers(0, tcfg.vocab_size, size=int(rng.integers(2, 9))).tolist(), tag)
                for tag in ("interactive", "batch", None, "interactive", "batch", None)]
    result = serve_mod.serve(tcfg, device="cpu", requests=requests, params=tparams,
                             max_new_tokens=new, max_len=max_len, enc_len=enc_len,
                             use_kernels=use_kernels)
    assert all(r.state == "done" for r in result.requests)
    rep = next(iter(result.engine.replicas.values()))
    assert rep.enc_len == enc_len and rep.cache["cross_k"].shape[2] == enc_len
    for (prompt, _), req in zip(requests, result.requests):
        assert req.output == _jax_greedy(jcfg, jparams, prompt, new, max_len, enc_len)
