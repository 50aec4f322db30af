"""The fused Mamba-2 decode step on the CPU: its plain version, its wrapper's
refusals and limits, and the layer's choice of path.

``repro_torch.kernels.ref.mamba_step_ref`` is the plain version of
``csrc/mamba_step.cu``: it must equal the plain ops of
``apply_mamba_step`` bit for bit, since both run the same arithmetic.
On a CPU tensor ``apply_mamba_step`` runs the ops it ran before the kernel
existed, counted here; the kernel itself is checked on the card by
``tests/test_torch_cuda.py::TestMambaStepCuda``.
"""
import collections
import dataclasses
import re
from fractions import Fraction
from pathlib import Path

import numpy as np

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import KERNELS, launch_counts, ops  # noqa: E402
from repro_torch.kernels import mamba_step as ms  # noqa: E402
from repro_torch.kernels.ref import mamba_step_ref  # noqa: E402
from repro_torch.models.layers import ssm  # noqa: E402
from _float32_fma import fma_f32  # noqa: E402

torch.set_num_threads(1)

SOURCE = Path(ssm.__file__).resolve().parents[2] / "kernels" / "csrc" / "mamba_step.cu"


def _layer(dtype="float32", groups=1, batch=3, seed=0, **kw):
    """A smoke-width Mamba-2 layer with leaves moved off their init values,
    a random cache and an input: (cfg, params, cache, x)."""
    cfg = dataclasses.replace(smoke_config("mamba2_2_7b"), compute_dtype=dtype,
                              ssm_groups=groups, **kw)
    gen = torch.Generator().manual_seed(seed)
    params = ssm.init_mamba(cfg, gen)
    params = {k: v + 0.1 * torch.randn(v.shape, generator=gen).to(v.dtype)
              for k, v in params.items()}
    cache = {k: torch.randn(v.shape, generator=gen)
             for k, v in ssm.init_mamba_cache(cfg, batch).items()}
    x = torch.randn((batch, 1, cfg.d_model), generator=gen).to(getattr(torch, dtype))
    return cfg, params, cache, x


def _step_args(cfg, params, cache, x):
    cdt = getattr(torch, cfg.compute_dtype)
    z, xbc, dt_raw = ssm._in_proj(cfg, params, x[:, 0, :], cdt)
    return (z, xbc, dt_raw, cache["conv"], cache["ssm"],
            *(params[k] for k in ssm._STEP_LEAVES))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_equals_the_layers_plain_path(dtype, groups, batch):
    """Output, conv window and state bit for bit, through the out-projection."""
    cfg, params, cache, x = _layer(dtype, groups, batch)
    mine = {k: v.clone() for k, v in cache.items()}
    out, _ = ssm.apply_mamba_step(cfg, params, x, cache)
    y = mamba_step_ref(*_step_args(cfg, params, mine, x), groups=groups, eps=cfg.norm_eps)
    assert y.dtype == x.dtype and tuple(y.shape) == (batch, cfg.d_inner)
    assert torch.equal((y @ params["out_proj"].to(x.dtype))[:, None, :], out)
    for key in ("conv", "ssm"):
        assert torch.equal(mine[key], cache[key]), key


def test_ops_runs_the_plain_version_on_cpu_tensors():
    cfg, params, cache, x = _layer("bfloat16")
    mine = {k: v.clone() for k, v in cache.items()}
    before = launch_counts()["mamba_step"]
    y = ops.mamba_step(*_step_args(cfg, params, cache, x), groups=1, eps=cfg.norm_eps)
    expect = mamba_step_ref(*_step_args(cfg, params, mine, x), groups=1, eps=cfg.norm_eps)
    assert torch.equal(y, expect)
    assert all(torch.equal(cache[k], mine[k]) for k in cache)
    assert launch_counts()["mamba_step"] == before  # no kernel ran


def test_the_kernel_is_counted():
    assert "mamba_step" in KERNELS and "mamba_step" in launch_counts()


def test_no_gradient():
    cfg, params, cache, x = _layer()
    args = list(_step_args(cfg, params, cache, x))
    args[0] = args[0].detach().requires_grad_(True)
    y = ops.mamba_step(*args, groups=1, eps=cfg.norm_eps)
    with pytest.raises(NotImplementedError, match="no backward kernel.*use_kernels=False"):
        y.float().sum().backward()


def test_cuda_wrapper_refuses_cpu_tensors():
    cfg, params, cache, x = _layer()
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ms.mamba_step_cuda(*_step_args(cfg, params, cache, x), groups=1, eps=cfg.norm_eps)


def _edit(args, index, tensor):
    args = list(args)
    args[index] = tensor
    return args


#: (name, edit of the arguments, groups, the refusal's words)
REFUSALS = [
    ("float16", lambda a: [t.half() if i < 3 else t for i, t in enumerate(a)], 1, "must be one of"),
    ("mixed", lambda a: _edit(a, 1, a[1].bfloat16()), 1, "must be one of"),
    ("bf16 state", lambda a: _edit(a, 4, a[4].bfloat16()), 1, "must be float32"),
    ("rank", lambda a: _edit(a, 0, a[0][:, None]), 1, "2-D"),
    ("groups", lambda a: a, 3, "not a multiple of 3 groups"),
    ("xbc width", lambda a: _edit(a, 1, a[1][:, :-2]), 1, "xbc is"),
    ("conv_w", lambda a: _edit(a, 5, a[5][:, :-1]), 1, "conv_w is"),
    ("state 12", lambda a: _edit(a, 4, a[4][..., :12].contiguous()), 1, "xbc is"),
    ("non-contiguous", lambda a: _edit(a, 4, a[4].transpose(0, 1).contiguous().transpose(0, 1)),
     1, "contiguous"),
]


@pytest.mark.parametrize("name,edit,groups,words", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_unsupported_says_why(name, edit, groups, words):
    cfg, params, cache, x = _layer()
    args = _step_args(cfg, params, cache, x)
    assert ms.unsupported(*args, groups=1) is None
    why = ms.unsupported(*edit(args), groups=groups)
    assert why is not None and words in why, why


@pytest.mark.parametrize("n,taps,words", [(12, 4, "power of two"), (256, 4, "power of two"),
                                          (16, 9, "conv taps"), (16, 1, "conv taps")])
def test_unsupported_sizes(n, taps, words):
    """A state size the kernel does not tile, and conv widths outside 2..8."""
    cfg, params, cache, x = _layer(ssm_state=n, ssm_conv=taps)
    why = ms.unsupported(*_step_args(cfg, params, cache, x), groups=1)
    assert why is not None and words in why, why


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "granite_4_0_h_small", "jamba_1_5_large_398b"])
def test_published_widths_are_taken(arch):
    """The three Mamba-2 models' decode steps go to the kernel: P 64, N 128,
    W 4 (meta tensors, so no memory)."""
    cfg = get_config(arch)
    dev = torch.device("meta")
    cache = ssm.init_mamba_cache(cfg, 8, device=dev)
    h, g, n, di = cfg.ssm_nheads, cfg.ssm_groups, cfg.ssm_state, cfg.d_inner
    cd = di + 2 * g * n
    bf = torch.bfloat16
    args = (torch.empty((8, di), dtype=bf, device=dev), torch.empty((8, cd), dtype=bf, device=dev),
            torch.empty((8, h), dtype=bf, device=dev), cache["conv"], cache["ssm"],
            torch.empty((cfg.ssm_conv, cd), device=dev), torch.empty((cd,), device=dev),
            *(torch.empty((h,), device=dev) for _ in range(3)), torch.empty((di,), device=dev))
    assert ms.unsupported(*args, groups=g) is None


# ---------------------------------------------------------------------------
# The CPU path runs the ops it ran before the kernel existed
# ---------------------------------------------------------------------------


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


_STEP = {"add": 5, "bmm": 2, "cat": 1, "clone": 2, "copy_": 2, "exp": 2, "expand": 2, "mean": 1,
         "mm": 4, "mul": 8, "neg": 1, "permute": 13, "pow": 1, "rsqrt": 1, "select": 1,
         "silu": 2, "slice": 4, "softplus": 1, "unsqueeze": 16, "view": 14}
#: The aten ops of one eager ``apply_mamba_step`` on CPU tensors (mamba2's
#: smoke widths, 3 slots), counted on the tree before the fused kernel existed.
STEP_OPS = {"float32": _STEP, "bfloat16": dict(_STEP, _to_copy=13)}


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("dtype", sorted(STEP_OPS))
def test_cpu_step_runs_the_ops_it_ran_before(dtype, use_kernels):
    cfg = dataclasses.replace(smoke_config("mamba2_2_7b"), use_kernels=use_kernels,
                              compute_dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    params = ssm.init_mamba(cfg, gen)
    cache = ssm.init_mamba_cache(cfg, 3)
    x = torch.randn(3, 1, cfg.d_model, generator=gen).to(getattr(torch, dtype))
    with torch.no_grad():
        ssm.apply_mamba_step(cfg, params, x, cache)
        with _Count() as mode:
            ssm.apply_mamba_step(cfg, params, x, cache)
    assert dict(mode.ops) == STEP_OPS[dtype]


# ---------------------------------------------------------------------------
# The wrapper's limits are the kernel's
# ---------------------------------------------------------------------------


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())[1])


def test_the_wrappers_limits_are_the_sources():
    """A head's state is one CTA's registers: THREADS x VECS float4."""
    assert _constant("THREADS") * _constant("VECS") * 4 == ms.MAX_HEAD
    assert (_constant("PMAX"), _constant("NMAX"), _constant("WMAX")) == (
        ms.MAX_P, ms.MAX_N, ms.MAX_W)


@pytest.mark.parametrize("p,n", [(128, 128), (512, 4)])
def test_a_head_larger_than_a_ctas_registers_is_refused(p, n):
    cfg, params, cache, x = _layer(ssm_headdim=p, ssm_state=n, d_model=512)
    why = ms.unsupported(*_step_args(cfg, params, cache, x), groups=1)
    assert why is not None and "P must be at most" in why, why


# ---------------------------------------------------------------------------
# The float32 FMA the card test of the conv's tap order emulates
# ---------------------------------------------------------------------------


def _exact_fma_f32(a, b, c):
    """a * b + c in rationals, rounded once to float32 (ties to even)."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(x))
    cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.float32(v).view(np.uint32)) & 1))


def _fma_cases(kind):
    gen = torch.Generator().manual_seed(7)
    if kind == "random":
        a, b, c = (torch.randn(2000, generator=gen) * 4 ** torch.randint(-3, 4, (2000,),
                                                                         generator=gen)
                   for _ in range(3))
        return a, b, c
    # a * b exactly on a float32 midpoint, c far below a float64 ulp of it:
    # one rounding of the float64 sum to float32 breaks the tie the wrong way.
    one = 1 + 2.0 ** -12
    a = torch.full((8,), one) * torch.tensor([1, -1, 1, -1, 2, -2, 0.5, -0.5])
    b = torch.full((8,), one)
    c = torch.tensor([1, 1, -1, -1, 1, -1, 1, -1]) * 2.0 ** -80
    return a, b, c


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_fma_f32_rounds_once(kind):
    a, b, c = _fma_cases(kind)
    got = fma_f32(a, b, c)
    want = torch.tensor([_exact_fma_f32(x, y, z) for x, y, z in zip(a.tolist(), b.tolist(),
                                                                   c.tolist())])
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    if kind == "ties":  # the double rounding the emulation avoids
        assert not torch.equal((a.double() * b.double() + c.double()).float(), want)
