"""Mamba-2 (SSD — state-space duality) mixer block (port of ``repro/models/layers/ssm.py``).

The chunked SSD algorithm (Dao & Gu, arXiv:2405.21060): within a chunk
the recurrence runs in its dual quadratic form, across chunks a linear
recurrence carries the ``[H, P, N]`` state; :func:`ssd_step` is the
one-token recurrence for decode. Under ``cfg.use_kernels``,
:func:`apply_mamba` runs the scan through the hand-written CUDA kernel
(:func:`repro_torch.kernels.ops.ssd_scan`), as the JAX block runs the
Pallas kernel, and :func:`apply_mamba_step` on the card runs its step
between the projections as one fused kernel of the port's own
(:func:`repro_torch.kernels.ops.mamba_step`; the JAX step is plain
``jnp``); everything else is plain PyTorch in the JAX layout.

Unlike the JAX functions, which return new caches, the cache writers
here update the cache tensors in place and return them.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers.basic import _dtype, _init_linear
from repro_torch.sharding.ctx import matmul, reshape, run_local, split_last

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_mamba(cfg, generator: torch.Generator, *, device=None) -> Dict:
    """The JAX block's leaves, shapes and dtypes, drawn from ``generator``."""
    dtype = _dtype(cfg.param_dtype)
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_nheads
    conv_dim = di + 2 * g * n
    f32 = torch.float32
    params = {
        "in_proj_z": _init_linear(generator, d, di, dtype, device=device),
        "in_proj_xbc": _init_linear(generator, d, di + 2 * g * n, dtype, device=device),
        "in_proj_dt": _init_linear(generator, d, h, dtype, device=device),
        "conv_w": (
            torch.randn((cfg.ssm_conv, conv_dim), generator=generator, dtype=f32, device=device)
            * (1.0 / math.sqrt(cfg.ssm_conv))
        ).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=device)),
        "d_skip": torch.ones((h,), dtype=f32, device=device),
    }
    # dt = exp(u), u uniform in [log 0.001, log 0.1]; the bias is softplus⁻¹(dt).
    lo, hi = math.log(0.001), math.log(0.1)
    u = torch.rand((h,), generator=generator, dtype=f32, device=device) * (hi - lo) + lo
    params["dt_bias"] = torch.log(torch.expm1(torch.exp(u)))
    params["norm_scale"] = torch.ones((di,), dtype=dtype, device=device)
    params["out_proj"] = _init_linear(generator, di, d, dtype, device=device)
    return params


# ---------------------------------------------------------------------------
# SSD core (chunked scan) — plain PyTorch; the CUDA kernel mirrors the
# intra-chunk dual form.
# ---------------------------------------------------------------------------


def segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise segment sums: out[..., i, j] = sum_{j<k<=i} a[k].

    a: [..., Q] → [..., Q, Q] with -1e30 above the diagonal.
    """
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, torch.full_like(diff, NEG_INF))


def ssd_chunked(
    x: torch.Tensor,        # [B,S,H,P]
    dt: torch.Tensor,       # [B,S,H]    (post-softplus, positive)
    a: torch.Tensor,        # [H]        (negative; A = -exp(a_log))
    b_mat: torch.Tensor,    # [B,S,G,N]
    c_mat: torch.Tensor,    # [B,S,G,N]
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # [B,H,P,N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y [B,S,H,P] float32, final_state [B,H,P,N] float32).

    The JAX version's ``lax.scan`` over chunks is a Python loop that emits
    the state at each chunk's start. On DTensors each rank scans its own
    batch rows and heads (:func:`repro_torch.sharding.ctx.run_local`).
    """
    if _any_dtensor(x, dt, b_mat):
        g = b_mat.shape[2]
        fn = functools.partial(_ssd_chunked_local, chunk=chunk)
        bc = (0, None) if g == 1 else (0, 2)
        return run_local(fn, (x, dt, a, b_mat, c_mat, initial_state),
                         [(0, 2), (0, 2), (None, 0), bc, bc, (0, 1)],
                         [(0, 2), (0, 1)], tp_ok=_heads_ok(x.shape[2], g))
    return _ssd_chunked_local(x, dt, a, b_mat, c_mat, initial_state, chunk=chunk)


def _any_dtensor(*xs) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(x, DTensor) for x in xs)


def _heads_ok(h: int, g: int) -> bool:
    """Heads (and their B/C groups) can be split over the TP axis."""
    from repro_torch.sharding.ctx import current_tp_size

    n = current_tp_size()
    return h % n == 0 and (g == 1 or g % n == 0)


def _ssd_chunked_local(x, dt, a, b_mat, c_mat, initial_state, *, chunk):
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    orig_s = s
    if s % chunk != 0:
        # dt = 0 on padded steps makes both the decay (exp(0) = 1) and the
        # input (x·dt = 0) identities, so the final state is unaffected.
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    hpg = h // g

    f32 = torch.float32
    dt = dt.to(f32)
    da = dt * a.to(f32)[None, None, :]                              # [B,S,H]
    xdt = x.to(f32) * dt[..., None]                                  # [B,S,H,P]

    da_c = da.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)         # [B,H,C,Q]
    x_c = xdt.reshape(bsz, nc, chunk, h, p)                          # [B,C,Q,H,P]
    b_h = b_mat.to(f32).reshape(bsz, nc, chunk, g, n).repeat_interleave(hpg, dim=3)
    c_h = c_mat.to(f32).reshape(bsz, nc, chunk, g, n).repeat_interleave(hpg, dim=3)

    cum = torch.cumsum(da_c, dim=-1)                                 # [B,H,C,Q]
    l_mat = torch.exp(segsum(da_c))                                  # [B,H,C,Q,Q]

    # 1) Intra-chunk (dual quadratic form), contracted pairwise in the
    # JAX einsum's order: C·B over n, the decay mask, then x over s.
    cb = torch.einsum("bclhn,bcshn->bhcls", c_h, b_h)
    y_intra = torch.einsum("bhcls,bcshp->bclhp", cb * l_mat, x_c)

    # 2) Per-chunk final states: decay each position to the chunk end.
    decay_to_end = torch.exp(cum[..., -1:] - cum)                    # [B,H,C,Q]
    states = torch.einsum("bcshn,bhcs,bcshp->bchpn", b_h, decay_to_end, x_c)

    # 3) Inter-chunk recurrence over chunks, emitting each chunk's start state.
    chunk_decay = torch.exp(cum[..., -1])                            # [B,H,C]
    carry = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    starts = []
    for c in range(nc):
        starts.append(carry)
        carry = carry * chunk_decay[:, :, c, None, None] + states[:, c]
    start_states = torch.stack(starts, dim=1)                        # [B,C,H,P,N]

    # 4) Inter-chunk contribution: state at chunk start, decayed to l.
    state_decay = torch.exp(cum)                                     # [B,H,C,Q]
    y_inter = torch.einsum("bclhn,bhcl,bchpn->bclhp", c_h, state_decay, start_states)

    y = (y_intra + y_inter).reshape(bsz, s, h, p)[:, :orig_s]
    return y, carry


def ssd_step(
    x: torch.Tensor,       # [B,H,P]
    dt: torch.Tensor,      # [B,H]
    a: torch.Tensor,       # [H]
    b_vec: torch.Tensor,   # [B,G,N]
    c_vec: torch.Tensor,   # [B,G,N]
    state: torch.Tensor,   # [B,H,P,N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step of the SSD recurrence. Returns (y [B,H,P], new state)."""
    if _any_dtensor(x, b_vec, state):
        bc = (0, None) if b_vec.shape[1] == 1 else (0, 1)
        return run_local(ssd_step, (x, dt, a, b_vec, c_vec, state),
                         [(0, 1), (0, 1), (None, 0), bc, bc, (0, 1)],
                         [(0, 1), (0, 1)], tp_ok=_heads_ok(x.shape[1], b_vec.shape[1]))
    f32 = torch.float32
    hpg = x.shape[1] // b_vec.shape[1]
    dt = dt.to(f32)
    decay = torch.exp(dt * a.to(f32)[None, :])                       # [B,H]
    b_h = b_vec.to(f32).repeat_interleave(hpg, dim=1)                # [B,H,N]
    c_h = c_vec.to(f32).repeat_interleave(hpg, dim=1)
    dbx = torch.einsum("bh,bhn,bhp->bhpn", dt, b_h, x.to(f32))
    state = state * decay[..., None, None] + dbx
    y = torch.einsum("bhpn,bhn->bhp", state, c_h)
    return y, state


# ---------------------------------------------------------------------------
# Full Mamba-2 block
# ---------------------------------------------------------------------------


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float):
    yf = y.float() * F.silu(z.float())
    ms = yf.square().mean(dim=-1, keepdim=True)
    return yf * torch.rsqrt(ms + eps) * scale.float()


def _in_proj(cfg, params: Dict, x: torch.Tensor, cdt):
    z = matmul(x, params["in_proj_z"].to(cdt))
    xbc = matmul(x, params["in_proj_xbc"].to(cdt))
    dt = matmul(x, params["in_proj_dt"].to(cdt))
    return z, xbc, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. x: [B,S,C]; w: [W,C]. Sums in float32.

    On DTensors each rank convolves its own batch rows and channels
    (:func:`repro_torch.sharding.ctx.run_local`)."""
    if _any_dtensor(x, w):
        from repro_torch.sharding.ctx import current_tp_size

        return run_local(_causal_conv, (x, w, b), [(0, 2), (None, 1), (None, 0)], [(0, 2)],
                         tp_ok=x.shape[2] % current_tp_size() == 0)
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):  # unrolled: width is 4
        out = out + pad[:, i:i + x.shape[1], :].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _split_xbc(cfg, xbc: torch.Tensor):
    """xs [..., H, P], B [..., G, N], C [..., G, N] out of the conv output."""
    di, g, n, h, p = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    xs = split_last(xbc[..., :di], (h, p))
    b_mat = split_last(xbc[..., di:di + g * n], (g, n))
    c_mat = split_last(xbc[..., di + g * n:], (g, n))
    return xs, b_mat, c_mat


def _mixer_input(cfg, params: Dict, x: torch.Tensor):
    """In-projection, conv, SiLU and the split: (z, xbc_raw, xs, B, C, dt, A)."""
    cdt = _dtype(cfg.compute_dtype)
    z, xbc_raw, dt_raw = _in_proj(cfg, params, x.to(cdt), cdt)
    xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    xbc = F.silu(xbc.float()).to(cdt)
    xs, b_mat, c_mat = _split_xbc(cfg, xbc)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None, :])
    a = -torch.exp(params["a_log"])
    return z, xbc_raw, xs, b_mat, c_mat, dt, a


def _mixer_output(cfg, params: Dict, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor):
    """D skip, gated RMS norm and the out-projection of a [B,S,H,P] scan output."""
    cdt = _dtype(cfg.compute_dtype)
    bsz, s = y.shape[0], y.shape[1]
    y = y + xs.float() * params["d_skip"][None, None, :, None]
    y = reshape(y, (bsz, s, cfg.d_inner))
    y = _gated_rmsnorm(y, z, params["norm_scale"], cfg.norm_eps).to(cdt)
    return matmul(y, params["out_proj"].to(cdt))


def apply_mamba(cfg, params: Dict, x: torch.Tensor, *, initial_state=None) -> torch.Tensor:
    """Full-sequence Mamba-2 block. x: [B,S,D] → [B,S,D].

    Under ``cfg.use_kernels`` the scan is the CUDA kernel (the plain
    version on a CPU tensor), which, as in the JAX block, takes no
    ``initial_state``.
    """
    z, _, xs, b_mat, c_mat, dt, a = _mixer_input(cfg, params, x)
    if cfg.use_kernels:
        from repro_torch.kernels.ops import ssd_scan

        y, _ = ssd_scan(xs, dt, a, b_mat, c_mat, chunk=cfg.ssm_chunk)
    else:
        y, _ = ssd_chunked(xs, dt, a, b_mat, c_mat, cfg.ssm_chunk, initial_state)
    return _mixer_output(cfg, params, y, xs, z)


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------


def init_mamba_cache(cfg, batch: int, *, device=None) -> Dict:
    """Zeroed conv window and SSM state, float32 whatever the compute dtype
    (the JAX ``lm.init_cache`` never passes its dtype argument)."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=f32, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state),
                           dtype=f32, device=device),
    }


#: The layer's leaves the fused decode step reads, in its argument order.
_STEP_LEAVES = ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip", "norm_scale")


def apply_mamba_step(cfg, params: Dict, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. x: [B,1,D] → ([B,1,D], cache updated in place).

    Under ``cfg.use_kernels`` a step on CUDA tensors that are not DTensors
    runs everything between the projections as
    :func:`repro_torch.kernels.ops.mamba_step`, two kernels, which raises
    where the kernel does not take the tensors; a CPU or sharded step runs
    the plain ops below.
    """
    cdt = _dtype(cfg.compute_dtype)
    bsz = x.shape[0]
    z, xbc, dt_raw = _in_proj(cfg, params, x[:, 0, :].to(cdt), cdt)
    if cfg.use_kernels and z.is_cuda and not _any_dtensor(z, cache["ssm"]):
        from repro_torch.kernels.ops import mamba_step

        y = mamba_step(z, xbc, dt_raw, cache["conv"], cache["ssm"],
                       *(params[k] for k in _STEP_LEAVES), groups=cfg.ssm_groups,
                       eps=cfg.norm_eps)
        return (y @ params["out_proj"].to(cdt))[:, None, :], cache

    # Rolling conv buffer: window = [cache | current], in float32 as the
    # JAX concatenation of the float32 cache with xbc promotes to.
    window = torch.cat([cache["conv"].float(), xbc[:, None, :].float()], dim=1)  # [B,W,C]
    conv_out = torch.einsum("bwc,wc->bc", window, params["conv_w"].float()) \
        + params["conv_b"].float()
    xbc_t = F.silu(conv_out).to(cdt)

    xs, b_vec, c_vec = _split_xbc(cfg, xbc_t)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, :])
    a = -torch.exp(params["a_log"])

    y, new_ssm = ssd_step(xs, dt, a, b_vec, c_vec, cache["ssm"])
    y = y + xs.float() * params["d_skip"][None, :, None]
    y = reshape(y, (bsz, cfg.d_inner))
    y = _gated_rmsnorm(y, z, params["norm_scale"], cfg.norm_eps).to(cdt)
    out = (y @ params["out_proj"].to(cdt))[:, None, :]
    cache["conv"].copy_(window[:, 1:, :])
    cache["ssm"].copy_(new_ssm)
    return out, cache
