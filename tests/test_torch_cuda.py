"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips without a CUDA device. This file imports
neither JAX nor the JAX package, so it runs on a machine with the card:

    python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402

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
