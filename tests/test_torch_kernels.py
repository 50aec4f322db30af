"""The port's kernel entry points vs the JAX package's, on the same numpy inputs.

On the CPU the port's ``flash_attention``, ``gmm`` and ``ssd_scan`` run
their plain versions (``attention_ref``, ``gmm_ref``, ``ssd_scan_ref``);
the JAX side runs the Pallas kernels in interpret mode, as
``tests/test_kernels.py`` does. The CUDA
kernels themselves are checked on the card by ``tests/test_torch_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_bhsd  # noqa: E402
from repro.kernels.moe_gmm import gmm as jax_gmm  # noqa: E402
from repro.kernels.ops import flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels.ops import moe_ffn_gmm as jax_moe_ffn_gmm  # noqa: E402
from repro.kernels.ops import ssd_scan as jax_ssd_scan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.gmm import gmm_cuda  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    attention_ref,
    gmm_ref,
    ssd_quadratic_ref,
    ssd_scan_ref,
)
from repro_torch.kernels.ssd_scan import ssd_scan_cuda  # noqa: E402

torch.set_num_threads(1)

# bf16: the reference's own tolerance (tests/test_kernels.py); f32: the
# two sides sum in different orders, so agreement is to ~1e-6.
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}

SWEEP = [  # tests/test_kernels.py's flash sweep: causal at s == t, non-causal s != t
    (2, 128, 128, 4, 2, 64, True, 64, 64),
    (1, 256, 256, 8, 8, 128, True, 128, 128),
    (2, 96, 96, 4, 1, 64, True, 64, 64),
    (1, 64, 256, 4, 4, 64, False, 64, 64),
    (1, 32, 32, 2, 2, 32, True, 32, 32),
    (2, 64, 64, 4, 2, 16, True, 32, 32),   # the smoke configs' head_dim
    (1, 32, 64, 2, 2, 16, False, 32, 32),
]


def _qkv(b, s, t, h, kv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    return q, k, v


def _both(arrays, dtype):
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


class TestFlashAttention:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,s,t,h,kv,d,causal,bq,bk", SWEEP)
    def test_matches_pallas_kernel(self, dtype, b, s, t, h, kv, d, causal, bq, bk):
        (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, s, t, h, kv, d), dtype)
        expect = flash_attention_bhsd(
            jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3), jv.transpose(0, 2, 1, 3),
            causal=causal, bq=bq, bk=bk, interpret=True,
        ).transpose(0, 2, 1, 3)
        out = ops.flash_attention(tq, tk, tv, causal=causal)
        assert out.dtype == tq.dtype and out.shape == tq.shape
        np.testing.assert_allclose(_f32(out), _f32(expect), **TOL[dtype])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_model_layout_wrapper(self, dtype):
        (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 64, 64, 4, 2, 32, seed=1), dtype)
        expect = jax_flash_attention(jq, jk, jv, causal=True, bq=32, bk=32)
        out = ops.flash_attention(tq, tk, tv, causal=True)
        np.testing.assert_allclose(_f32(out), _f32(expect), **TOL[dtype])

    def test_matches_jax_oracle_at_equal_lengths(self):
        q, k, v = _qkv(1, 48, 48, 6, 3, 16, seed=2)
        expect = jax_ref.ref_attention(
            *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)), causal=True
        ).transpose(0, 2, 1, 3)
        out = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(expect), **TOL["float32"])

    def test_causal_mask_is_top_left(self):
        """For s != t the port follows the Pallas kernel (row >= col), not
        the JAX oracle's bottom-right alignment."""
        (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 32, 64, 2, 2, 32, seed=3), "float32")
        expect = flash_attention_bhsd(
            jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3), jv.transpose(0, 2, 1, 3),
            causal=True, bq=32, bk=32, interpret=True,
        ).transpose(0, 2, 1, 3)
        out = attention_ref(tq, tk, tv, causal=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(expect), **TOL["float32"])

    def test_constant_values_give_that_constant(self):
        q, k, _ = _qkv(1, 64, 64, 2, 2, 32, seed=4)
        v = np.ones((1, 64, 2, 32), np.float32)
        out = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
        np.testing.assert_allclose(out.numpy(), 1.0, rtol=1e-5)

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 1, 64))
        with pytest.raises(ValueError, match="not a CUDA tensor"):
            flash_attention_cuda(q, k, v)


GMM_SHAPES = [  # tests/test_kernels.py's gmm sweep: (e, c, k, n, bc, bn, bk)
    (4, 64, 32, 48, 32, 32, 32),
    (2, 100, 64, 64, 32, 32, 32),   # the Pallas wrapper's padding path
    (8, 16, 128, 256, 16, 128, 64),
    (1, 8, 8, 8, 8, 8, 8),
]


class TestGmm:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("e,c,k,n,bc,bn,bk", GMM_SHAPES)
    def test_matches_pallas_kernel(self, dtype, e, c, k, n, bc, bn, bk):
        rng = np.random.default_rng(e * 1000 + c)
        arrays = (rng.standard_normal((e, c, k)).astype(np.float32),
                  rng.standard_normal((e, k, n)).astype(np.float32))
        (jx, jw), (tx, tw) = _both(arrays, dtype)
        expect = jax_gmm(jx, jw, bc=bc, bn=bn, bk=bk, interpret=True)
        out = ops.gmm(tx, tw)
        assert out.dtype == tx.dtype and tuple(out.shape) == (e, c, n)
        np.testing.assert_allclose(_f32(out), _f32(expect), **TOL[dtype])

    def test_plain_version_matches_jax_oracle_on_a_strided_view(self):
        """The capacity buffer reaches gmm as a view without its drop slot."""
        rng = np.random.default_rng(5)
        padded = rng.standard_normal((3, 9, 40)).astype(np.float32)
        w = rng.standard_normal((3, 40, 24)).astype(np.float32)
        view = torch.from_numpy(padded)[:, :8, :]
        assert not view.is_contiguous()
        expect = jax_ref.ref_gmm(jnp.asarray(padded[:, :8, :]), jnp.asarray(w))
        out = gmm_ref(view, torch.from_numpy(w))
        np.testing.assert_allclose(out.numpy(), np.asarray(expect), **TOL["float32"])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("mlp_kind", ["swiglu", "geglu", "squared_relu", "gelu"])
    def test_moe_ffn_matches_jax(self, mlp_kind, dtype):
        from repro.configs import smoke_config as jax_smoke_config
        from repro_torch.configs import smoke_config

        jcfg = dataclasses.replace(jax_smoke_config("phi3_5_moe_42b"), mlp_kind=mlp_kind)
        tcfg = dataclasses.replace(smoke_config("phi3_5_moe_42b"), mlp_kind=mlp_kind)
        e, d, f = jcfg.moe_experts, jcfg.d_model, jcfg.d_ff
        rng = np.random.default_rng(6)
        params = {"w_up": rng.standard_normal((e, d, f)).astype(np.float32) * d ** -0.5,
                  "w_down": rng.standard_normal((e, f, d)).astype(np.float32) * f ** -0.5}
        if mlp_kind in ("swiglu", "geglu"):
            params["w_gate"] = rng.standard_normal((e, d, f)).astype(np.float32) * d ** -0.5
        buffer = rng.standard_normal((e, 16, d)).astype(np.float32)
        (jbuf,), (tbuf,) = _both([buffer], dtype)
        expect = jax_moe_ffn_gmm(jcfg, {key: jnp.asarray(v) for key, v in params.items()}, jbuf)
        out = ops.moe_ffn_gmm(tcfg, {key: torch.from_numpy(v) for key, v in params.items()},
                              tbuf)
        assert out.dtype == tbuf.dtype and out.shape == tbuf.shape
        # f32: the activation and three products sum in another order (as
        # tests/test_kernels.py's composition test, 2e-4); bf16: 2e-2.
        tol = dict(rtol=2e-4, atol=2e-4) if dtype == "float32" else TOL[dtype]
        np.testing.assert_allclose(_f32(out), _f32(expect), **tol)

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        x, w = torch.zeros((2, 8, 16)), torch.zeros((2, 16, 8))
        with pytest.raises(ValueError, match="not a CUDA tensor"):
            gmm_cuda(x, w)


SSD_SHAPES = [  # tests/test_kernels.py's sweep (b, s, h, p, g, n, chunk), then S < chunk
    (2, 128, 4, 16, 1, 32, 32),
    (1, 64, 2, 8, 2, 16, 16),
    (1, 96, 4, 16, 1, 32, 32),      # the padding path
    (2, 32, 8, 8, 1, 8, 8),
    (1, 20, 2, 8, 1, 16, 32),       # S < chunk: the chunk becomes S
]


def _ssd_inputs(b, s, h, p, g, n, seed=0):
    """As tests/test_kernels.py draws them: dt = softplus(normal), A = -exp(normal)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, a, bm, cm


class TestSsdScan:
    # The reference's own tolerance (tests/test_kernels.py::TestSsdScan):
    # float32 throughout, the sums in another order.
    TOL = dict(rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("bc_dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
    def test_matches_pallas_kernel_and_quadratic_oracle(self, b, s, h, p, g, n, chunk,
                                                        bc_dtype):
        x, dt, a, bm, cm = _ssd_inputs(b, s, h, p, g, n)
        (jbm, jcm), (tbm, tcm) = _both([bm, cm], bc_dtype)
        expect, j_state = jax_ssd_scan(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a),
                                       jbm, jcm, chunk=chunk)
        out, state = ops.ssd_scan(torch.from_numpy(x), torch.from_numpy(dt),
                                  torch.from_numpy(a), tbm, tcm, chunk=chunk)
        assert state is None and j_state is None  # no final state, as in JAX
        assert out.dtype == torch.float32 and tuple(out.shape) == (b, s, h, p)
        np.testing.assert_allclose(out.numpy(), np.asarray(expect), **self.TOL)
        # The O(S²) oracle on the same (bf16-rounded) B and C.
        xdt = torch.from_numpy(x * dt[..., None]).transpose(1, 2)
        da = torch.from_numpy(dt * a[None, None, :]).transpose(1, 2)
        oracle = ssd_quadratic_ref(xdt, da, tbm.transpose(1, 2), tcm.transpose(1, 2))
        np.testing.assert_allclose(out.numpy(), oracle.transpose(1, 2).numpy(), **self.TOL)

    @pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES[:2])
    def test_quadratic_oracle_matches_jax_ref(self, b, s, h, p, g, n, chunk):
        x, dt, a, bm, cm = _ssd_inputs(b, s, h, p, g, n, seed=1)
        xdt = (x * dt[..., None]).transpose(0, 2, 1, 3)
        da = (dt * a[None, None, :]).transpose(0, 2, 1)
        bh, ch = bm.transpose(0, 2, 1, 3), cm.transpose(0, 2, 1, 3)
        expect = jax_ref.ref_ssd(*map(jnp.asarray, (xdt, da, bh, ch)))
        out = ssd_quadratic_ref(*map(torch.from_numpy, (np.ascontiguousarray(xdt),
                                                        np.ascontiguousarray(da),
                                                        np.ascontiguousarray(bh),
                                                        np.ascontiguousarray(ch))))
        np.testing.assert_allclose(out.numpy(), np.asarray(expect), **self.TOL)

    def test_plain_version_takes_the_kernel_layout(self):
        """ssd_scan_ref on the kernel layout ([B,H,S,P], da [B,H,1,S]) against
        the Pallas kernel called on that layout, ragged tail included."""
        from repro.kernels.ssd_scan import ssd_scan_bhsd

        x, dt, a, bm, cm = _ssd_inputs(2, 40, 4, 8, 2, 16, seed=2)
        xdt = np.ascontiguousarray((x * dt[..., None]).transpose(0, 2, 1, 3))
        da = np.ascontiguousarray((dt * a[None, None, :]).transpose(0, 2, 1)[:, :, None, :])
        bh = np.ascontiguousarray(bm.transpose(0, 2, 1, 3))
        ch = np.ascontiguousarray(cm.transpose(0, 2, 1, 3))
        expect = ssd_scan_bhsd(*map(jnp.asarray, (xdt, da, bh, ch)), chunk=16, interpret=True)
        out = ssd_scan_ref(*map(torch.from_numpy, (xdt, da, bh, ch)), chunk=16)
        assert tuple(out.shape) == (2, 4, 40, 8)
        np.testing.assert_allclose(out.numpy(), np.asarray(expect), **self.TOL)

    def test_no_gradient(self):
        x, dt, a, bm, cm = map(torch.from_numpy, _ssd_inputs(1, 16, 2, 8, 1, 8))
        x.requires_grad_(True)
        y, _ = ops.ssd_scan(x, dt, a, bm, cm, chunk=8)
        with pytest.raises(NotImplementedError, match="has no backward kernel.*use_kernels=False"):
            y.sum().backward()

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        xdt, da = torch.zeros((1, 2, 8, 8)), torch.zeros((1, 2, 1, 8))
        bm = torch.zeros((1, 1, 8, 16))
        with pytest.raises(ValueError, match="not a CUDA tensor"):
            ssd_scan_cuda(xdt, da, bm, bm, chunk=8)


class TestSelectFirstAvailable:
    @staticmethod
    def _case(seed, m, width, positions, per_row):
        rng = np.random.default_rng(seed)
        nwords = (positions + 63) // 64
        shape = (m, nwords) if per_row else (nwords,)
        words = rng.integers(0, 2**63, size=shape, dtype=np.uint64)
        words |= rng.integers(0, 2, size=shape, dtype=np.uint64) << np.uint64(63)
        words &= rng.integers(0, 2**63, size=shape, dtype=np.uint64)  # sparser
        orders = np.full((m, width), -1, np.int32)
        for row in range(m):
            n = int(rng.integers(0, width + 1))
            orders[row, :n] = rng.permutation(positions)[:n]
        return words, orders

    @pytest.mark.parametrize("backend", ["numpy", "torch"])
    @pytest.mark.parametrize("per_row", [False, True])
    @pytest.mark.parametrize("seed,m,width,positions", [
        (0, 1, 4, 8), (1, 7, 33, 70), (2, 16, 128, 200), (3, 5, 64, 64),
    ])
    def test_matches_reference(self, backend, per_row, seed, m, width, positions):
        words, orders = self._case(seed, m, width, positions, per_row)
        expect = jax_ref.select_first_available_np(words, orders)
        out = ops.select_first_available(words, orders, backend=backend)
        assert out.dtype == np.int32
        np.testing.assert_array_equal(out, expect)

    @pytest.mark.parametrize("backend", ["numpy", "torch"])
    def test_one_dimensional_order_and_empty_mask(self, backend):
        words = np.zeros(2, np.uint64)
        orders = np.array([5, 70, -1], np.int32)
        np.testing.assert_array_equal(
            ops.select_first_available(words, orders, backend=backend), [-1]
        )
        words[1] = np.uint64(1) << np.uint64(6)  # position 70
        np.testing.assert_array_equal(
            ops.select_first_available(words, orders, backend=backend), [70]
        )

    def test_unknown_backend_raises(self):
        with pytest.raises(ValueError):
            ops.select_first_available(np.zeros(1, np.uint64), np.zeros((1, 1), np.int32),
                                       backend="jax")
