"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips without a CUDA device. This file imports
neither JAX nor the JAX package, so it runs on a machine with the card:

    python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import gmm as gmm_mod  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.gmm import gmm_cuda  # noqa: E402
from repro_torch.kernels.ref import attention_ref, gmm_ref  # noqa: E402

torch.set_num_threads(1)


def _qkv(b, s, t, h, kv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, t, kv, d)).astype(np.float32),
            rng.standard_normal((b, t, kv, d)).astype(np.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    return torch.device("cuda")


@pytest.mark.gpu
class TestFlashAttentionCuda:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,s,h,kv,d", [
        (1, 128, 9, 3, 64), (1, 200, 9, 3, 64), (2, 96, 4, 1, 128), (1, 1, 2, 2, 64),
    ])
    def test_kernel_matches_plain_version(self, cuda_device, dtype, b, s, h, kv, d):
        q, k, v = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
                   for a in _qkv(b, s, s, h, kv, d))
        out = flash_attention_cuda(q, k, v, causal=True)
        expect = attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == "bfloat16" else 1e-4
        torch.testing.assert_close(out.float(), expect.float(), rtol=tol, atol=tol)

    def test_strided_inputs_and_non_causal(self, cuda_device):
        qkv = torch.from_numpy(_qkv(1, 64, 64, 4, 4, 64)[0]).to(cuda_device)
        fused = torch.cat([qkv, qkv.flip(1), qkv * 0.5], dim=2)  # [B,S,3H,D]
        q, k, v = fused[:, :, :4], fused[:, :, 4:8], fused[:, :, 8:]
        out = flash_attention_cuda(q, k, v, causal=False)
        torch.testing.assert_close(out, attention_ref(q, k, v, causal=False),
                                   rtol=1e-4, atol=1e-4)

    def test_rejects_unsupported_head_dim(self, cuda_device):
        q = torch.zeros((1, 8, 2, 32), device=cuda_device)
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention_cuda(q, q, q)


def _gmm_inputs(device, dtype, e, c, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((e, c, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((e, k, n)) * k ** -0.5).astype(np.float32))
    return x.to(device, dtype), w.to(device, dtype)


@pytest.mark.gpu
class TestGmmCuda:
    # bf16: the output is rounded to bf16 after an f32 sum, as in the plain
    # version, so they differ by an ulp at most; f32: sums in another order.
    TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("e,c,k,n", [
        (16, 8, 4096, 6400), (16, 80, 6400, 4096),   # serving shapes: decode, prefill
        (4, 24, 256, 136), (2, 50, 512, 256),          # the 32- and 64-row tiles
        (3, 5, 100, 72), (2, 130, 33, 7),              # ragged; C over one CTA's rows
    ])
    def test_kernel_matches_plain_version(self, cuda_device, dtype, e, c, k, n):
        x, w = _gmm_inputs(cuda_device, dtype, e, c, k, n)
        out = gmm_cuda(x, w)
        expect = gmm_ref(x, w)
        torch.cuda.synchronize()
        assert out.dtype == dtype and tuple(out.shape) == (e, c, n)
        tol = self.TOL[dtype]
        torch.testing.assert_close(out.float(), expect.float(), rtol=tol, atol=tol)

    def test_strided_capacity_view(self, cuda_device):
        x, w = _gmm_inputs(cuda_device, torch.bfloat16, 4, 9, 256, 128)
        view = x[:, :8, :]  # the buffer without its sacrificial slot
        torch.testing.assert_close(gmm_cuda(view, w).float(), gmm_ref(view, w).float(),
                                   rtol=2e-2, atol=2e-2)

    def test_counts_each_launch(self, cuda_device):
        x, w = _gmm_inputs(cuda_device, torch.bfloat16, 2, 8, 64, 64)
        before = gmm_mod.launches
        for _ in range(3):
            gmm_cuda(x, w)
        assert gmm_mod.launches == before + 3

    def test_rejects_mixed_dtypes(self, cuda_device):
        x, w = _gmm_inputs(cuda_device, torch.bfloat16, 2, 8, 64, 64)
        with pytest.raises(TypeError):
            gmm_cuda(x, w.float())
