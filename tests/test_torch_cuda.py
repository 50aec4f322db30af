"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips without a CUDA device. This file imports
neither JAX nor the JAX package, so it runs on a machine with the card:

    python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import gmm as gmm_mod  # noqa: E402
from repro_torch.kernels import mamba_step as mamba_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.gmm import gmm_cuda  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    attention_ref,
    gmm_ref,
    mamba_step_ref,
    ssd_quadratic_ref,
    ssd_scan_ref,
)
from repro_torch.kernels.ssd_scan import ssd_scan_cuda  # noqa: E402
from _float32_fma import fma_f32  # noqa: E402

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
    # bf16: the kernel rounds P to bf16 before P·V (2^-9 relative per entry)
    # and sums in another order than the plain version; f32: 3xTF32 products
    # (~2^-21 relative each, tests/test_torch_f32_kernel_design.py), an
    # approximate exp2, sums in another order.
    TOL = {"bfloat16": 2e-2, "float32": 1e-4}

    def _check(self, out, q, k, v, causal, dtype):
        expect = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert out.dtype == q.dtype and out.shape == q.shape
        tol = self.TOL[dtype]
        torch.testing.assert_close(out.float(), expect.float(), rtol=tol, atol=tol)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,s,h,kv,d", [
        (1, 128, 9, 3, 64), (1, 200, 9, 3, 64), (2, 96, 4, 1, 128), (1, 1, 2, 2, 64),
        (1, 200, 32, 8, 128),                        # D=128 at a ragged S
        (1, 1, 32, 8, 128),                          # one token
        (1, 1024, 9, 3, 64), (1, 1024, 32, 8, 128),  # S = T = the serving cache length
    ])
    def test_kernel_matches_plain_version(self, cuda_device, dtype, b, s, h, kv, d):
        q, k, v = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
                   for a in _qkv(b, s, s, h, kv, d))
        self._check(flash_attention_cuda(q, k, v, causal=True), q, k, v, True, dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_whisper_encoder_shape_non_causal(self, cuda_device, dtype):
        """whisper-small's encoder: 1500 frames (23 full 64-row tiles and a
        ragged one of 28), 12 heads of 64, no mask."""
        q, k, v = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
                   for a in _qkv(1, 1500, 1500, 12, 12, 64, seed=4))
        self._check(flash_attention_cuda(q, k, v, causal=False), q, k, v, False, dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_strided_inputs_and_non_causal(self, cuda_device, dtype):
        qkv = torch.from_numpy(_qkv(1, 64, 64, 4, 4, 64)[0]).to(cuda_device, getattr(torch, dtype))
        fused = torch.cat([qkv, qkv.flip(1), qkv * 0.5], dim=2)  # [B,S,3H,D]
        q, k, v = fused[:, :, :4], fused[:, :, 4:8], fused[:, :, 8:]
        self._check(flash_attention_cuda(q, k, v, causal=False), q, k, v, False, dtype)

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("s,t,h,kv,d", [(100, 300, 9, 3, 64), (64, 200, 32, 8, 128)])
    def test_fewer_queries_than_keys(self, cuda_device, dtype, causal, s, t, h, kv, d):
        """S < T; causal masks top-left (row >= col), as the Pallas kernel."""
        q, k, v = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
                   for a in _qkv(1, s, t, h, kv, d, seed=1))
        self._check(flash_attention_cuda(q, k, v, causal=causal), q, k, v, causal, dtype)

    @pytest.mark.parametrize("d", [64, 128])
    def test_unaligned_bf16_inputs(self, cuda_device, d):
        """Base addresses and strides that are not multiples of 16 bytes take
        the same tensor-core kernel with element-wise loads."""
        b, s, h, kv = 2, 130, 4, 2
        flat = torch.from_numpy(np.concatenate([a.ravel() for a in _qkv(b, s, s, h, kv, d)]))
        buf = torch.zeros(flat.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
        buf[1:] = flat.to(cuda_device, torch.bfloat16)     # every view starts 2 bytes off
        nq, nk = b * s * h * d, b * s * kv * d
        q = buf[1:1 + nq].view(b, s, h, d)
        k = buf[1 + nq:1 + nq + nk].view(b, s, kv, d)
        v = buf[1 + nq + nk:].view(b, s, kv, d)
        assert q.data_ptr() % 16 != 0
        self._check(flash_attention_cuda(q, k, v, causal=True), q, k, v, True, "bfloat16")

    @pytest.mark.parametrize("d", [16, 64, 128])
    def test_unaligned_f32_inputs(self, cuda_device, d):
        """float32 views 4 bytes off a 16-byte boundary take the 3xTF32 kernel
        with element-wise loads."""
        b, s, h, kv = 2, 130, 4, 2
        q, k, v = (_misaligned(torch.from_numpy(a).to(cuda_device))
                   for a in _qkv(b, s, s, h, kv, d))
        assert q.data_ptr() % 16 != 0
        self._check(flash_attention_cuda(q, k, v, causal=True), q, k, v, True, "float32")

    @pytest.mark.parametrize("aligned", [True, False])
    @pytest.mark.parametrize("dtype,kernel", [("float32", "flash_fwd_3xtf32_kernel"),
                                              ("bfloat16", "flash_fwd_bf16_kernel")])
    def test_route(self, cuda_device, dtype, kernel, aligned):
        """float32 runs the 3xTF32 kernel and bf16 the bf16 one, one launch,
        with cp.async loads where the inputs are 16-byte aligned (the
        template's VEC = true) and element-wise loads where not."""
        q, k, v = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
                   for a in _qkv(1, 200, 200, 9, 3, 64))
        if not aligned:
            q, k, v = (_misaligned(x) for x in (q, k, v))
        flash_attention_cuda(q, k, v, causal=True)  # warm: build and load outside the profile
        ran = _kernels_run(lambda: flash_attention_cuda(q, k, v, causal=True), "flash")
        assert len(ran) == 1, ran
        name = next(iter(ran))
        assert kernel in name and f"<64, {'true' if aligned else 'false'}>" in name, ran

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_counts_one_launch_per_call(self, cuda_device, dtype):
        q, k, v = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
                   for a in _qkv(1, 200, 200, 9, 3, 64))
        before = flash_mod.launches
        flash_attention_cuda(q, k, v, causal=True)
        assert flash_mod.launches == before + 1

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,s,t,h,kv,d", [
        (2, 64, 64, 4, 2, 16), (1, 130, 130, 4, 2, 16), (1, 7, 100, 2, 1, 16),
        (2, 64, 64, 4, 2, 32), (1, 200, 200, 8, 2, 32), (1, 50, 129, 2, 2, 32),
    ])
    def test_small_head_dims(self, cuda_device, dtype, causal, b, s, t, h, kv, d):
        """The head dims the Pallas kernel runs at in the reference's tests
        (32) and the smoke configs (16), at ragged S and T."""
        q, k, v = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
                   for a in _qkv(b, s, t, h, kv, d, seed=3))
        self._check(flash_attention_cuda(q, k, v, causal=causal), q, k, v, causal, dtype)

    def test_backward_raises(self, cuda_device):
        q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16).requires_grad_(True)
                   for a in _qkv(1, 64, 64, 4, 2, 64))
        before = flash_mod.launches
        out = ops.flash_attention(q, k, v, causal=True)
        assert flash_mod.launches == before + 1 and out.grad_fn is not None
        with pytest.raises(NotImplementedError, match="has no backward kernel.*use_kernels=False"):
            out.float().sum().backward()

    def test_rejects_unsupported_head_dim(self, cuda_device):
        q = torch.zeros((1, 8, 2, 24), device=cuda_device)
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention_cuda(q, q, q)


def _gmm_inputs(device, dtype, e, c, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((e, c, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((e, k, n)) * k ** -0.5).astype(np.float32))
    return x.to(device, dtype), w.to(device, dtype)


def _misaligned(t):
    """A copy of ``t`` whose storage starts one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _profiled(fn):
    """The names of the device kernels one ``fn()`` ran, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _kernels_run(fn, part, attempts=3):
    """Names of the device kernels with ``part`` in their name that a
    profiled ``fn()`` ran on the card: up to ``attempts`` calls, until the
    profiler shows one (on the H100 it returned sessions without any
    device event at random, and in runs of this whole file for every
    session after about a minute: PERF.md, PR 22)."""
    for _ in range(attempts):
        ran = {name for name in _profiled(fn) if part in name}
        if ran:
            break
    return ran


def _gmm_kernels_run(x, w):
    """Names of the gmm kernels one profiled ``gmm_cuda(x, w)`` ran on the card."""
    return _kernels_run(lambda: gmm_cuda(x, w), "gmm")


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

    @pytest.mark.parametrize("strided", [False, True])
    @pytest.mark.parametrize("c", [8, 16, 80, 136, 264])
    @pytest.mark.parametrize("k,n", [(200, 200), (4104, 136), (64, 40)])
    def test_wgmma_path_at_every_c_tile(self, cuda_device, c, k, n, strided):
        """bf16 at the serving C (8, 16, 80), C past the first design's
        128-row tile (136) and past wgmma's N limit of 256 (264); K and N not
        multiples of the 64-deep stage or the 128-column work item (N = 40
        leaves the second consumer's weight box wholly past N); x contiguous
        or the capacity buffer's view without its drop slot."""
        x, w = _gmm_inputs(cuda_device, torch.bfloat16, 3, c + strided, k, n, seed=c)
        if strided:
            x = x[:, :c, :]
            assert not x.is_contiguous()
        out = gmm_cuda(x, w)
        expect = gmm_ref(x, w)
        torch.cuda.synchronize()
        assert out.dtype == torch.bfloat16 and tuple(out.shape) == (3, c, n)
        torch.testing.assert_close(out.float(), expect.float(), rtol=2e-2, atol=2e-2)
        ran = _gmm_kernels_run(x, w)
        assert len(ran) == 1 and "gmm_wgmma_kernel" in next(iter(ran)), ran

    @pytest.mark.parametrize("dtype,e,c,k,n,kernel", [
        (torch.bfloat16, 2, 8, 64, 64, "gmm_wgmma_kernel"),
        (torch.bfloat16, 3, 5, 100, 72, "simt"),  # rows of 200 bytes: TMA cannot address them
        (torch.float32, 2, 8, 64, 64, "gmm_3xtf32_kernel"),
        (torch.float32, 3, 5, 100, 72, "gmm_3xtf32_kernel"),  # rows of 400 bytes
        (torch.float32, 3, 5, 99, 72, "simt"),    # rows of 396 bytes
    ])
    def test_route(self, cuda_device, dtype, e, c, k, n, kernel):
        """Inputs TMA can address run the Hopper design (bf16 wgmma, float32
        3xTF32); the others the first design's kernel, one launch either way."""
        x, w = _gmm_inputs(cuda_device, dtype, e, c, k, n)
        gmm_cuda(x, w)  # warm: build and load outside the profile
        ran = _gmm_kernels_run(x, w)
        assert len(ran) == 1, ran
        assert kernel in next(iter(ran)), ran

    @pytest.mark.parametrize("strided", [False, True])
    @pytest.mark.parametrize("c", [5, 8, 16, 40, 64, 80, 100, 136, 264])
    @pytest.mark.parametrize("k,n", [(200, 200), (4104, 136), (64, 40)])
    def test_3xtf32_path_at_every_c_tile(self, cuda_device, c, k, n, strided):
        """float32 at every C tile of the 3xTF32 kernel (8 ... 80, and C
        past 80 in even tiles), K and N not multiples of the 32-deep stage
        or the 128-column work item (N = 40 leaves three of a stage's four
        weight boxes wholly past N), x contiguous or the capacity buffer's
        view without its drop slot."""
        x, w = _gmm_inputs(cuda_device, torch.float32, 3, c + strided, k, n, seed=c)
        if strided:
            x = x[:, :c, :]
            assert not x.is_contiguous()
        out = gmm_cuda(x, w)
        expect = gmm_ref(x, w)
        torch.cuda.synchronize()
        assert out.dtype == torch.float32 and tuple(out.shape) == (3, c, n)
        torch.testing.assert_close(out, expect, rtol=1e-4, atol=1e-4)
        ran = _gmm_kernels_run(x, w)
        assert len(ran) == 1 and "gmm_3xtf32_kernel" in next(iter(ran)), ran

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_bit_identical_across_calls(self, cuda_device, dtype):
        x, w = _gmm_inputs(cuda_device, dtype, 16, 80, 4096, 640)
        first, second = gmm_cuda(x, w), gmm_cuda(x, w)
        torch.cuda.synchronize()
        assert torch.equal(first, second)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_backward_raises(self, cuda_device, dtype):
        x, w = _gmm_inputs(cuda_device, dtype, 2, 8, 64, 64)
        w.requires_grad_(True)
        before = gmm_mod.launches
        out = ops.gmm(x, w)
        assert gmm_mod.launches == before + 1 and out.grad_fn is not None
        with pytest.raises(NotImplementedError, match="has no backward kernel.*use_kernels=False"):
            out.float().sum().backward()

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


# Pairs routed to each of 16 experts: none reached, one, some (one over a
# C of 8), all (some partly filled).
ROUTINGS = {
    "none": [0] * 16,
    "one": [0] * 5 + [3] + [0] * 10,
    "some": [0, 2, 0, 0, 1, 0, 9, 0, 0, 0, 1, 0, 0, 3, 0, 1],
    "all": [1, 2, 8, 3, 1, 1, 5, 2, 1, 4, 1, 7, 2, 1, 3, 90],
}


def _offsets(counts, device):
    return torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int64,
                        device=device)


def _routed(x, counts):
    """``x`` with each expert's rows past its pairs zeroed, as the MoE
    dispatch leaves its capacity buffer."""
    live = torch.tensor(counts, device=x.device)[:, None] > torch.arange(x.shape[1],
                                                                         device=x.device)
    return torch.where(live[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


@pytest.mark.gpu
class TestGmmOffsetsCuda:
    """gmm with each expert's routed pairs (``offsets``) skips the experts
    that received none and equals, bit for bit, the call without them on
    the same zero-padded buffer, on every route."""

    @pytest.mark.parametrize("routing", list(ROUTINGS))
    @pytest.mark.parametrize("c", [8, 80])
    @pytest.mark.parametrize("k,route", [(256, "tma"), (99, "simt")])  # rows of 99: TMA cannot
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_equals_the_call_without_offsets(self, cuda_device, dtype, k, route, c, routing):
        counts = ROUTINGS[routing]
        x, w = _gmm_inputs(cuda_device, dtype, 16, c, k, 320, seed=c + k)
        x = _routed(x, counts)
        out = gmm_cuda(x, w, _offsets(counts, cuda_device))
        expect = gmm_cuda(x, w)
        torch.cuda.synchronize()
        assert torch.equal(out, expect)
        assert torch.equal(out, torch.zeros_like(out)) == (routing == "none")

    @pytest.mark.parametrize("c,k,n", [(8, 4096, 6400), (8, 6400, 4096), (80, 4096, 6400)])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_serving_shapes(self, cuda_device, dtype, c, k, n):
        """phi's widths: decode with 6 experts reached (and one over C = 8)
        and prefill with every expert reached, through the capacity
        buffer's strided view."""
        counts = ROUTINGS["some"] if c == 8 else [c - 3 * (e % 4) for e in range(16)]
        x, w = _gmm_inputs(cuda_device, dtype, 16, c + 1, k, n, seed=k)
        x = _routed(x, counts)[:, :c, :]
        out = gmm_cuda(x, w, _offsets(counts, cuda_device))
        expect = gmm_cuda(x, w)
        torch.cuda.synchronize()
        assert torch.equal(out, expect)

    @pytest.mark.parametrize("k", [256, 99])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_reads_no_weights_of_unreached_experts(self, cuda_device, dtype, k):
        """An unreached expert's weights set to NaN: its rows come out as
        zeros (its product is not taken), the other rows as with finite ones."""
        counts = ROUTINGS["some"]
        x, w = _gmm_inputs(cuda_device, dtype, 16, 8, k, 320)
        x = _routed(x, counts)
        expect = gmm_cuda(x, w)
        unreached = torch.tensor(counts, device=cuda_device) == 0
        w[unreached] = float("nan")
        out = gmm_cuda(x, w, _offsets(counts, cuda_device))
        torch.cuda.synchronize()
        assert torch.equal(out, expect)
        assert torch.isnan(gmm_cuda(x, w)[unreached]).all()

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_captured_graph_follows_each_replays_counts(self, cuda_device, dtype):
        """Offsets and buffer written between replays of one captured call:
        each replay equals the uncaptured call on its routing."""
        x_static = torch.zeros((16, 8, 256), dtype=dtype, device=cuda_device)
        off_static = torch.zeros((17,), dtype=torch.int64, device=cuda_device)
        _, w = _gmm_inputs(cuda_device, dtype, 16, 8, 256, 320)
        gmm_cuda(x_static, w, off_static)  # build and load outside the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = gmm_cuda(x_static, w, off_static)
        for i, routing in enumerate(["some", "all", "none", "one", "some"]):
            counts = ROUTINGS[routing]
            x, _ = _gmm_inputs(cuda_device, dtype, 16, 8, 256, 320, seed=i)
            x = _routed(x, counts)
            x_static.copy_(x)
            off_static.copy_(_offsets(counts, cuda_device))
            graph.replay()
            expect = gmm_cuda(x, w)
            torch.cuda.synchronize()
            assert torch.equal(out, expect), routing

    def test_rejects_bad_offsets(self, cuda_device):
        x, w = _gmm_inputs(cuda_device, torch.bfloat16, 2, 8, 64, 64)
        for bad in (torch.zeros(2, dtype=torch.int64, device=cuda_device),
                    torch.zeros(3, dtype=torch.int32, device=cuda_device),
                    torch.zeros(3, dtype=torch.int64)):
            with pytest.raises(ValueError, match="offsets"):
                gmm_cuda(x, w, bad)


@pytest.mark.gpu
class TestMoeSkipCuda:
    """The MoE layer under ``use_kernels`` at phi3.5-MoE's widths: the
    kernel given the dispatch's offsets gives the bits of the kernel
    without them, for random routing of a decode step's slots."""

    @pytest.mark.parametrize("tokens", [1, 4])
    @pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
    def test_apply_moe_equals_the_call_without_offsets(self, cuda_device, monkeypatch,
                                                        dtype, tokens):
        import dataclasses

        from repro_torch.configs.registry import get_config
        from repro_torch.models.layers import moe

        cfg = dataclasses.replace(get_config("phi3_5_moe_42b"), use_kernels=True,
                                  compute_dtype=dtype, param_dtype=dtype)
        params = moe.init_moe(cfg, torch.Generator(cuda_device).manual_seed(0),
                              device=cuda_device)
        with_offsets = ops.moe_ffn_gmm

        def without_offsets(cfg, params, buffer, offsets=None):
            return with_offsets(cfg, params, buffer)

        reached = []
        for seed in range(4):
            gen = torch.Generator(cuda_device).manual_seed(100 + seed)
            x = torch.randn((tokens, 1, cfg.d_model), generator=gen, device=cuda_device)
            x = x.to(getattr(torch, dtype))
            counter = moe.ExpertCounter(cuda_device)
            with moe.counting(counter):
                out, aux = moe.apply_moe(cfg, params, x)
            reached.append(counter.read()[0])
            monkeypatch.setattr(ops, "moe_ffn_gmm", without_offsets)
            expect, aux_expect = moe.apply_moe(cfg, params, x)
            monkeypatch.setattr(ops, "moe_ffn_gmm", with_offsets)
            torch.cuda.synchronize()
            assert torch.equal(out, expect) and torch.equal(aux, aux_expect)
        assert max(reached) <= 2 * tokens < cfg.moe_experts  # experts were skipped


def _ssd_inputs(device, bc_dtype, b, h, s, p, g, n, seed=0, dt_range=(1e-3, 0.2), a_min=1.0):
    """Kernel layout; dt log-uniform in ``dt_range`` and A from -a_min to -16
    (by default dt in [0.001, 0.2] and A in [-16, -1], as the model makes them)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, s, p)).astype(np.float32)
    dt = np.exp(rng.uniform(*np.log(dt_range), (b, h, s))).astype(np.float32)
    a = -np.linspace(a_min, 16.0, h).astype(np.float32)
    bm = rng.standard_normal((b, g, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, g, s, n)).astype(np.float32)
    xdt = torch.from_numpy(x * dt[..., None]).to(device)
    da = torch.from_numpy(dt * a[None, :, None])[:, :, None, :].to(device)
    return (xdt, da, torch.from_numpy(bm).to(device, bc_dtype),
            torch.from_numpy(cm).to(device, bc_dtype))


def _ssd_quadratic64(xdt, da, bm, cm):
    """The scan as one [S, S] decay mask per head, in float64 (CPU tensors)."""
    hpg = xdt.shape[1] // bm.shape[1]
    cum = torch.cumsum(da, dim=-1)
    mask = torch.ones(cum.shape[-1], cum.shape[-1], dtype=torch.bool).tril()
    decay = torch.exp((cum[..., :, None] - cum[..., None, :]).clamp(max=0)) * mask
    cb = cm.repeat_interleave(hpg, 1) @ bm.repeat_interleave(hpg, 1).transpose(-1, -2)
    return (cb * decay) @ xdt


@pytest.mark.gpu
class TestSsdScanCuda:
    # Float32 arithmetic on both sides (bf16 B/C are widened exactly), sums
    # in another order: the reference's own 1e-4 (tests/test_kernels.py).
    TOL = 1e-4

    @pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b,h,s,p,g,n,chunk", [
        (2, 80, 4096, 64, 1, 128, 256),   # the loss path's shape
        (1, 80, 1000, 64, 1, 128, 256),   # a ragged last chunk
        (1, 80, 100, 64, 1, 128, 100),    # S < chunk: the chunk is S
        (2, 4, 128, 16, 1, 32, 32),       # tests/test_kernels.py's shapes, G = 2 included
        (1, 2, 64, 8, 2, 16, 16),
        (1, 4, 96, 16, 1, 32, 32),
        (2, 8, 32, 8, 1, 8, 8),
        # Heads of different groups in one launch; at these sizes the chunk-scan
        # kernel takes 4 heads of a group per CTA, so C.B^T is shared across a
        # block of heads (G = 2: four blocks per group; G = 8: two).
        (2, 32, 2048, 64, 2, 128, 256),
        (2, 64, 1024, 64, 8, 128, 256),
        (1, 16, 300, 64, 2, 128, 64),     # G = 2, ragged last chunk, nc = 5
        (2, 8, 160, 64, 1, 128, 16),      # chunk 16, nc = 10
        (1, 8, 250, 64, 1, 128, 100),     # chunk 100, ragged, nc = 3
        (1, 4, 50, 16, 1, 32, 100),       # S < chunk: one ragged chunk, no state stages
        (1, 8, 700, 48, 2, 96, 128),      # P and N below the tile, ragged, nc = 6
        (1, 4, 77, 5, 1, 7, 16),          # P, N not multiples of 4: element-wise loads
    ])
    def test_kernel_matches_plain_version(self, cuda_device, bc_dtype, b, h, s, p, g, n,
                                          chunk):
        xdt, da, bm, cm = _ssd_inputs(cuda_device, bc_dtype, b, h, s, p, g, n)
        out = ssd_scan_cuda(xdt, da, bm, cm, chunk=chunk)
        expect = ssd_scan_ref(xdt, da, bm, cm, chunk=chunk)
        torch.cuda.synchronize()
        assert out.dtype == torch.float32 and tuple(out.shape) == (b, h, s, p)
        torch.testing.assert_close(out, expect, rtol=self.TOL, atol=self.TOL)

    @pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b,h,s,p,g,n,chunk", [
        (1, 8, 1000, 64, 2, 128, 256),
        (1, 4, 300, 16, 1, 32, 64),
    ])
    def test_large_decays(self, cuda_device, bc_dtype, b, h, s, p, g, n, chunk):
        """dt has no upper limit in Mamba-2. At A = -16 with dt in [0.8, 2],
        seven rows of da sum past float32's exp range (a decay factor taken
        across a k-step would overflow): held to the plain version. With dt
        from 0.001 to 2, small decays follow large prefix sums, where the
        plain version's float32 cumsum is itself about the tolerance off:
        held to a float64 quadratic oracle."""
        xdt, da, bm, cm = _ssd_inputs(cuda_device, bc_dtype, b, h, s, p, g, n, seed=4,
                                      dt_range=(0.8, 2.0), a_min=16.0)
        out = ssd_scan_cuda(xdt, da, bm, cm, chunk=chunk)
        torch.testing.assert_close(out, ssd_scan_ref(xdt, da, bm, cm, chunk=chunk),
                                   rtol=self.TOL, atol=self.TOL)
        xdt, da, bm, cm = _ssd_inputs(cuda_device, bc_dtype, b, h, s, p, g, n, seed=5,
                                      dt_range=(1e-3, 2.0), a_min=16.0)
        out = ssd_scan_cuda(xdt, da, bm, cm, chunk=chunk)
        args = [t.double().cpu() for t in (xdt, da[:, :, 0], bm, cm)]
        expect = _ssd_quadratic64(*args)
        torch.testing.assert_close(out.double().cpu(), expect, rtol=self.TOL, atol=self.TOL)

    def test_matches_quadratic_oracle(self, cuda_device):
        xdt, da, bm, cm = _ssd_inputs(cuda_device, torch.float32, 1, 4, 300, 16, 2, 32, seed=1)
        out = ssd_scan_cuda(xdt, da, bm, cm, chunk=64)
        torch.testing.assert_close(out, ssd_quadratic_ref(xdt, da[:, :, 0], bm, cm),
                                   rtol=self.TOL, atol=self.TOL)

    def test_model_layout_reaches_the_kernel_and_counts(self, cuda_device):
        """ops.ssd_scan on CUDA tensors launches the kernel (the count
        rises by one per call) on strided views of the model layout, and
        never runs the plain version."""
        rng = np.random.default_rng(2)
        b, s, h, p, g, n = 2, 200, 8, 16, 1, 32
        x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32)).to(cuda_device)
        dt = torch.from_numpy(rng.uniform(1e-3, 0.1, (b, s, h)).astype(np.float32)).to(cuda_device)
        a = -torch.linspace(1.0, 16.0, h, device=cuda_device)
        xbc = torch.from_numpy(rng.standard_normal((b, s, 2 * g * n + 7)).astype(np.float32))
        xbc = xbc.to(cuda_device, torch.bfloat16)
        bm = xbc[..., 7:7 + g * n].reshape(b, s, g, n)    # views, as the Mamba block slices
        cm = xbc[..., 7 + g * n:].reshape(b, s, g, n)
        before = ssd_mod.launches
        y, state = ops.ssd_scan(x, dt, a, bm, cm, chunk=64)
        assert ssd_mod.launches == before + 1 and state is None
        xdt = (x * dt[..., None]).transpose(1, 2)
        da = (dt * a).transpose(1, 2)[:, :, None, :]
        expect = ssd_scan_ref(xdt, da, bm.transpose(1, 2), cm.transpose(1, 2), chunk=64)
        torch.testing.assert_close(y, expect.transpose(1, 2), rtol=self.TOL, atol=self.TOL)

    def test_backward_raises(self, cuda_device):
        xdt, da, bm, cm = _ssd_inputs(cuda_device, torch.float32, 1, 2, 16, 8, 1, 16)
        xdt.requires_grad_(True)
        y = ssd_mod.SsdScan.apply(xdt, da, bm, cm, 8)
        with pytest.raises(NotImplementedError, match="has no backward kernel.*use_kernels=False"):
            y.sum().backward()

    @pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
    def test_bit_identical_across_calls(self, cuda_device, bc_dtype):
        """No atomics and no order that changes between calls: two calls on
        the same inputs give the same bits."""
        xdt, da, bm, cm = _ssd_inputs(cuda_device, bc_dtype, 2, 16, 1100, 64, 2, 128, seed=3)
        first = ssd_scan_cuda(xdt, da, bm, cm, chunk=256)
        second = ssd_scan_cuda(xdt, da, bm, cm, chunk=256)
        torch.cuda.synchronize()
        assert torch.equal(first, second)

    @pytest.mark.parametrize("s,stages", [
        (1000, ("ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_chunk_scan_kernel")),
        (200, ("ssd_chunk_scan_kernel",)),
    ])
    def test_device_kernels_per_call(self, cuda_device, s, stages):
        """One scan call runs the three stages where there is more than one
        chunk, and only the chunk scan (no state stage) where there is one;
        it still counts one launch."""
        xdt, da, bm, cm = _ssd_inputs(cuda_device, torch.bfloat16, 1, 8, s, 64, 1, 128)
        ssd_scan_cuda(xdt, da, bm, cm, chunk=256)  # build and warm
        torch.cuda.synchronize()
        before, calls, names, ran = ssd_mod.launches, 0, [], ()
        while ran != stages and calls < 3:  # the profiler may drop some of a call's events
            names = _profiled(lambda: ssd_scan_cuda(xdt, da, bm, cm, chunk=256))
            calls += 1
            ran = tuple(st for st in ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                                      "ssd_chunk_scan_kernel") if any(st in nm for nm in names))
        assert ran == stages, names
        assert sum(any(st in nm for st in stages) for nm in names) == len(stages), names
        assert ssd_mod.launches - before == calls

    @pytest.mark.parametrize("p,n,chunk", [(128, 64, 64), (64, 256, 64), (64, 128, 512)])
    def test_rejects_unsupported_sizes(self, cuda_device, p, n, chunk):
        xdt, da, bm, cm = _ssd_inputs(cuda_device, torch.float32, 1, 2, 16, p, 1, n)
        with pytest.raises(ValueError, match="at most"):
            ssd_scan_cuda(xdt, da, bm, cm, chunk=chunk)


def _mamba_inputs(device, dtype, b, h, p, n, g=1, w=4, seed=0):
    """A decode step's inputs at the model's ranges: the projections' z, xbc
    and dt_raw in ``dtype``, a float32 window and state, the layer's float32
    leaves (conv weights ~1/sqrt(W), dt ~ softplus(N(-2, 1)), A = -exp(a_log))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    di, cd = h * p, h * p + 2 * g * n

    def r(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return (r(b, di).to(dtype), r(b, cd).to(dtype), (r(b, h) - 2).to(dtype),
            r(b, w - 1, cd), r(b, h, p, n), r(w, cd) / w ** 0.5, r(cd) * 0.1, r(h) * 0.5,
            r(h), 1 + 0.1 * r(h), 1 + 0.1 * r(di))


def _bf16_excess(a, b):
    """The largest |a - b| over its allowance: one bf16 spacing at
    max(|a|, |b|), beside 1e-5 of b's scale (where y nearly cancels, the
    float32 sums' order moves it by more than its own bf16 spacing). At most
    1 where a is within one ulp of b or within float32 noise of the scale."""
    a, b = a.float(), b.float()
    top = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    ulp = 2.0 ** (torch.floor(torch.log2(top)) - 7)
    return float(((a - b).abs() / (ulp + 1e-5 * float(b.abs().max()))).max())


@pytest.mark.gpu
class TestMambaStepCuda:
    """The fused decode step against ``mamba_step_ref``: the same float32
    operations and roundings but for the order of float32 sums (the dot
    products over N, the norm's mean), so float32 agrees to 1e-5 of each
    tensor's scale, a bf16 output to one bf16 ulp (beside 1e-5 of its scale,
    ``_bf16_excess``), and the rolled window exactly; the state is float32 in
    both dtypes."""

    def _check(self, args, groups):
        mine = [t.clone() if i in (3, 4) else t for i, t in enumerate(args)]
        out = mamba_mod.mamba_step_cuda(*mine, groups=groups, eps=1e-5)
        expect = mamba_step_ref(*args, groups=groups, eps=1e-5)
        torch.cuda.synchronize()
        assert out.dtype == expect.dtype and out.shape == expect.shape
        for got, want in ((mine[4], args[4]),) + (((out, expect),)
                                                   if out.dtype == torch.float32 else ()):
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-5 * float(want.abs().max()))
        if out.dtype == torch.bfloat16:
            assert _bf16_excess(out, expect) <= 1.0
        assert torch.equal(mine[3], args[3])
        return out, mine

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b,h", [(1, 128), (8, 128), (8, 80)])  # granite's, mamba2-2.7b's
    def test_kernel_matches_plain_version(self, cuda_device, dtype, b, h):
        self._check(_mamba_inputs(cuda_device, dtype, b, h, 64, 128), groups=1)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b,h,p,n,g,w", [
        (3, 16, 8, 16, 1, 4),     # the smoke configs' widths
        (2, 8, 8, 16, 2, 4),      # two groups
        (2, 4, 3, 4, 2, 2),       # a row of one float4, two taps
        (1, 2, 32, 128, 1, 3),    # three taps (the general conv)
        (2, 3, 33, 64, 3, 5),     # ragged rows, five taps
    ])
    def test_other_shapes(self, cuda_device, dtype, b, h, p, n, g, w):
        self._check(_mamba_inputs(cuda_device, dtype, b, h, p, n, g, w, seed=1), groups=g)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_in_a_captured_graph_replayed_three_times(self, cuda_device, dtype):
        """Granite's widths at 8 slots: a graph of one step replayed on new
        projections three times carries the state and window as the plain
        version run three times does."""
        args = list(_mamba_inputs(cuda_device, dtype, 8, 128, 64, 128, seed=2))
        mine = [t.clone() if i in (3, 4) else t for i, t in enumerate(args)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            mamba_mod.mamba_step_cuda(*mine, groups=1, eps=1e-5)  # build and warm
        torch.cuda.current_stream().wait_stream(side)
        mamba_step_ref(*args, groups=1, eps=1e-5)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = mamba_mod.mamba_step_cuda(*mine, groups=1, eps=1e-5)
        for replay in range(3):
            new = _mamba_inputs(cuda_device, dtype, 8, 128, 64, 128, seed=10 + replay)
            for i in range(3):
                args[i].copy_(new[i])
            graph.replay()
            expect = mamba_step_ref(*args, groups=1, eps=1e-5)
            torch.cuda.synchronize()
            torch.testing.assert_close(mine[4], args[4], rtol=1e-5,
                                       atol=1e-5 * float(args[4].abs().max()))
            assert torch.equal(mine[3], args[3]), replay
            if dtype == torch.bfloat16:
                assert _bf16_excess(out, expect) <= 1.0, replay
            else:
                torch.testing.assert_close(out, expect, rtol=1e-5,
                                           atol=1e-5 * float(expect.abs().max()))

    def test_two_device_kernels_and_one_launch_a_call(self, cuda_device):
        args = _mamba_inputs(cuda_device, torch.bfloat16, 8, 128, 64, 128)
        mamba_mod.mamba_step_cuda(*args, groups=1, eps=1e-5)  # build and warm
        torch.cuda.synchronize()
        before, calls, names = mamba_mod.launches, 0, []
        while calls < 3:  # the profiler may drop some of a call's events
            names = _profiled(lambda: mamba_mod.mamba_step_cuda(*args, groups=1, eps=1e-5))
            calls += 1
            if len(names) == 2:
                break
        assert sorted(nm.split("<")[0].split("::")[-1] for nm in names) == [
            "mamba_norm_kernel", "mamba_state_kernel"], names
        assert mamba_mod.launches - before == calls

    def test_bit_identical_across_calls(self, cuda_device):
        args = _mamba_inputs(cuda_device, torch.bfloat16, 8, 80, 64, 128, seed=4)
        first = [t.clone() if i in (3, 4) else t for i, t in enumerate(args)]
        second = [t.clone() if i in (3, 4) else t for i, t in enumerate(args)]
        a = mamba_mod.mamba_step_cuda(*first, groups=1, eps=1e-5)
        b = mamba_mod.mamba_step_cuda(*second, groups=1, eps=1e-5)
        torch.cuda.synchronize()
        assert torch.equal(a, b) and torch.equal(first[4], second[4])

    def test_backward_raises(self, cuda_device):
        args = list(_mamba_inputs(cuda_device, torch.float32, 1, 4, 8, 16))
        args[0].requires_grad_(True)
        out = ops.mamba_step(*args, groups=1, eps=1e-5)
        with pytest.raises(NotImplementedError, match="no backward kernel"):
            out.sum().backward()

    def test_rejects_what_it_does_not_take(self, cuda_device):
        args = list(_mamba_inputs(cuda_device, torch.float32, 1, 4, 8, 12))
        with pytest.raises(ValueError, match="power of two"):
            mamba_mod.mamba_step_cuda(*args, groups=1, eps=1e-5)
        args = list(_mamba_inputs(cuda_device, torch.float32, 1, 4, 8, 16))
        args[2] = args[2].cpu()
        with pytest.raises(ValueError, match="CUDA tensor"):
            mamba_mod.mamba_step_cuda(*args, groups=1, eps=1e-5)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b,h,p,n,g,w", [
        (8, 128, 64, 128, 1, 4),  # granite-4.0-h-small's mixer, 8 slots
        (4, 80, 64, 128, 1, 4),   # mamba2-2.7b's
        (4, 16, 8, 16, 1, 4),     # the CLI's mamba2 smoke config
    ])  # chip_smoke.py's MAMBA_SHAPES
    def test_the_plain_conv_sums_its_taps_in_the_kernels_order(self, cuda_device, dtype,
                                                                b, h, p, n, g, w):
        """The kernel sums the four taps as fma(x1, w1, x0 w0) + fma(x3, w3,
        x2 w2), the order the plain path's einsum takes on the card, so that
        xs, B and C round to the compute dtype as there. The order is not
        promised by the library that runs the einsum: a change shows here,
        before the state and output checks above fail by ~1e-3."""
        z, xbc, _, conv, _, conv_w, *_ = _mamba_inputs(cuda_device, dtype, b, h, p, n, g, w,
                                                       seed=6)
        window = torch.cat([conv.float(), xbc[:, None, :].float()], dim=1)
        plain = torch.einsum("bwc,wc->bc", window, conv_w.float())
        x, wt = window.transpose(0, 1), conv_w[:, None, :]
        kernel = fma_f32(x[1], wt[1], x[0] * wt[0]) + fma_f32(x[3], wt[3], x[2] * wt[2])
        assert torch.equal(plain, kernel), float((plain - kernel).abs().max())

    def test_the_layer_raises_where_the_kernel_does_not_take_the_step(self, cuda_device):
        """A step on the card under ``use_kernels`` goes to the kernel, which
        raises on a compute dtype it does not take; it does not run the
        plain ops instead."""
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.models.layers import ssm

        cfg = dataclasses.replace(get_config("mamba2_2_7b"), d_model=256,
                                  compute_dtype="float16", use_kernels=True)
        params = ssm.init_mamba(cfg, torch.Generator(device=cuda_device).manual_seed(5),
                                device=cuda_device)
        cache = ssm.init_mamba_cache(cfg, 2, device=cuda_device)
        x = torch.randn((2, 1, cfg.d_model), device=cuda_device).half()
        with torch.no_grad(), pytest.raises(ValueError, match="must be one of"):
            ssm.apply_mamba_step(cfg, params, x, cache)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_the_layer_takes_the_kernel(self, cuda_device, dtype):
        """``apply_mamba_step`` under ``use_kernels`` at mamba2-2.7b's head
        shape launches the kernel once and agrees with the plain ops."""
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.models.layers import ssm

        cfg = dataclasses.replace(get_config("mamba2_2_7b"), d_model=1024, compute_dtype=dtype,
                                  use_kernels=True)
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        params = ssm.init_mamba(cfg, gen, device=cuda_device)
        params = {k: v.to(getattr(torch, dtype)) if k.startswith(("in_proj", "out_proj")) else v
                  for k, v in params.items()}
        cache = {k: torch.randn(v.shape, generator=gen, device=cuda_device)
                 for k, v in ssm.init_mamba_cache(cfg, 4, device=cuda_device).items()}
        plain = {k: v.clone() for k, v in cache.items()}
        x = torch.randn((4, 1, cfg.d_model), generator=gen, device=cuda_device)
        x = x.to(getattr(torch, dtype))
        before = mamba_mod.launches
        with torch.no_grad():
            out, _ = ssm.apply_mamba_step(cfg, params, x, cache)
            expect, _ = ssm.apply_mamba_step(dataclasses.replace(cfg, use_kernels=False),
                                             params, x, plain)
        torch.cuda.synchronize()
        assert mamba_mod.launches - before == 1
        tol = 1e-5 if dtype == "float32" else 2e-2
        torch.testing.assert_close(out.float(), expect.float(), rtol=tol, atol=tol)
        assert torch.equal(cache["conv"], plain["conv"])
        torch.testing.assert_close(cache["ssm"], plain["ssm"], rtol=1e-5,
                                   atol=1e-5 * float(plain["ssm"].abs().max()))
