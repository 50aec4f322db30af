"""Plain versions of the port's kernels (the allclose references).

Deliberately naive — materialised scores, a bit-gather over the whole
order plane, a float32 einsum for the grouped matmul, whole-chunk
matrices for the SSD scan — so that the tests and ``chip_smoke.py``
compare two independent implementations. On a CPU tensor the kernel wrappers in
:mod:`repro_torch.kernels.ops` run these.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def select_first_available_np(avail_words, orders):
    """Numpy reference for the scheduler's batch-routing kernel.

    ``avail_words`` — uint64 availability bitmask planes, shape ``[W]``
    (one mask shared by every row) or ``[m, W]`` (per-row masks); bit
    ``p`` of the flattened mask is set iff candidate position ``p`` is
    available. ``orders`` — int32 ``[m, L]`` candidate positions in
    preference order, right-padded with ``-1``.

    Returns int32 ``[m]``: for each row, the first position in its order
    whose availability bit is set, or ``-1`` when none is. Equivalent to
    the scalar ``ItemIndex.pick_*`` scan, resolved for all rows at once
    via a bit-gather and an argmax over the extracted order plane.
    """
    orders = np.ascontiguousarray(orders, dtype=np.int64)
    if orders.ndim == 1:
        orders = orders[None, :]
    m, _l = orders.shape
    words = np.ascontiguousarray(avail_words, dtype=np.uint64)
    if words.ndim == 1:
        words = words[None, :]
    valid = orders >= 0
    safe = np.where(valid, orders, 0)
    gathered = np.take_along_axis(
        np.broadcast_to(words, (m, words.shape[1])), safe >> 6, axis=1
    )
    bits = (gathered >> (safe & 63).astype(np.uint64)) & np.uint64(1)
    hit = (bits != 0) & valid
    found = hit.any(axis=1)
    first = hit.argmax(axis=1)
    picks = np.take_along_axis(orders, first[:, None], axis=1)[:, 0]
    return np.where(found, picks, -1).astype(np.int32)


def select_first_available_torch(words32: torch.Tensor, orders: torch.Tensor) -> torch.Tensor:
    """The same picks as torch tensor ops.

    ``words32``: int64 ``[m or 1, 2W]`` holding each uint64 mask word
    split into (low, high) 32-bit halves, low half at even indices (torch
    has no shift on uint64), so position ``p`` lives at word ``p >> 5``,
    bit ``p & 31``. ``orders``: int32 or int64 ``[m, L]``, ``-1``-padded.
    Returns int32 ``[m]``.
    """
    orders = orders.long()
    valid = orders >= 0
    safe = torch.where(valid, orders, torch.zeros_like(orders))
    gathered = torch.gather(
        words32.expand(orders.shape[0], words32.shape[-1]), 1, safe >> 5
    )
    hit = (((gathered >> (safe & 31)) & 1) != 0) & valid
    found = hit.any(dim=1)
    # argmax over bool picks the first True; cast because argmax wants numbers.
    first = hit.to(torch.int8).argmax(dim=1)
    picks = torch.gather(orders, 1, first[:, None])[:, 0]
    return torch.where(found, picks, torch.full_like(picks, -1)).to(torch.int32)


def attention_ref(
    q: torch.Tensor,    # [B, S, H, D]
    k: torch.Tensor,    # [B, T, KV, D]
    v: torch.Tensor,    # [B, T, KV, D]
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention with the Pallas flash kernel's masking, in the model layout;
    the scores times ``scale`` (None: 1/√D).

    Causal masking is top-left aligned (``row >= col``, as in
    ``repro/kernels/flash_attention.py``), which equals the usual
    bottom-right alignment only when ``S == T`` — the only causal case
    ``attend_full`` produces. Scores and softmax run in float32; the
    output is in q's dtype.
    """
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    qf = q.float().transpose(1, 2)                                   # [B,H,S,D]
    kf = k.float().transpose(1, 2).repeat_interleave(group, dim=1)   # [B,H,T,D]
    vf = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    scale = 1.0 / (d ** 0.5) if scale is None else scale
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        rows = torch.arange(s, device=q.device)[:, None]
        cols = torch.arange(t, device=q.device)[None, :]
        scores = torch.where(rows >= cols, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs, vf)                                    # [B,H,S,D]
    return out.transpose(1, 2).to(q.dtype)


def gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped matmul ``out[e] = x[e] @ w[e]``: x ``[E, C, K]``, w ``[E, K, N]``.

    A float32 einsum whose result is cast to x's dtype, as the JAX
    package's ``ref_gmm``.
    """
    return torch.einsum("eck,ekn->ecn", x.float(), w.float()).to(x.dtype)


def ssd_scan_ref(
    xdt: torch.Tensor,    # [B, H, S, P]  x * dt, float32
    da: torch.Tensor,     # [B, H, 1, S]  dt * A, float32
    b_mat: torch.Tensor,  # [B, G, S, N]
    c_mat: torch.Tensor,  # [B, G, S, N]
    *,
    chunk: int = 256,
) -> torch.Tensor:
    """The chunked SSD scan as the Pallas ``_ssd_kernel`` computes it.

    Per (b, h) and chunk of ``chunk`` rows, in order: the intra-chunk dual
    form ``(C Bᵀ ⊙ exp(segsum(da))) xdt`` plus the carried ``[P, N]`` state
    decayed to each row, then the state update. The state starts at zero;
    a ragged last chunk is zero-padded (da = 0 and xdt = 0 make the padded
    rows inert). Whole ``[Q, Q]`` matrices per chunk, in float32. Returns
    y ``[B, H, S, P]`` float32.
    """
    bsz, h, s, p = xdt.shape
    g, n = b_mat.shape[1], b_mat.shape[3]
    hpg = h // g
    pad = (-s) % chunk
    xdt = torch.nn.functional.pad(xdt.float(), (0, 0, 0, pad))
    da = torch.nn.functional.pad(da.float()[:, :, 0, :], (0, pad))
    b_h = torch.nn.functional.pad(b_mat.float(), (0, 0, 0, pad)).repeat_interleave(hpg, dim=1)
    c_h = torch.nn.functional.pad(c_mat.float(), (0, 0, 0, pad)).repeat_interleave(hpg, dim=1)
    rows = torch.arange(chunk, device=xdt.device)
    causal = rows[:, None] >= rows[None, :]
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=xdt.device)
    out = []
    for c0 in range(0, s + pad, chunk):
        x_c = xdt[:, :, c0:c0 + chunk]                   # [B,H,Q,P]
        b_c = b_h[:, :, c0:c0 + chunk]                   # [B,H,Q,N]
        c_c = c_h[:, :, c0:c0 + chunk]
        cum = torch.cumsum(da[:, :, c0:c0 + chunk], dim=-1)  # [B,H,Q]
        diff = cum[..., :, None] - cum[..., None, :]
        l_mat = torch.exp(torch.where(causal, diff, torch.full_like(diff, NEG_INF)))
        cb = torch.matmul(c_c, b_c.transpose(-1, -2))    # [B,H,Q,Q]
        y_intra = torch.matmul(cb * l_mat, x_c)
        y_inter = torch.matmul(c_c * torch.exp(cum)[..., None], state.transpose(-1, -2))
        out.append(y_intra + y_inter)
        decay_to_end = torch.exp(cum[..., -1:] - cum)    # [B,H,Q]
        s_c = torch.matmul((x_c * decay_to_end[..., None]).transpose(-1, -2), b_c)  # [B,H,P,N]
        state = state * torch.exp(cum[..., -1])[..., None, None] + s_c
    return torch.cat(out, dim=2)[:, :, :s]


def ssd_quadratic_ref(
    xdt: torch.Tensor,    # [B, H, S, P]
    da: torch.Tensor,     # [B, H, S]
    b_mat: torch.Tensor,  # [B, G, S, N]
    c_mat: torch.Tensor,  # [B, G, S, N]
) -> torch.Tensor:
    """Quadratic (full-sequence dual form) SSD, O(S²): the tests' oracle.

    The counterpart of the JAX package's ``ref_ssd``: one ``[S, S]`` decay
    mask over the whole sequence, no chunks and no carried state.
    """
    h, s = xdt.shape[1], xdt.shape[2]
    hpg = h // b_mat.shape[1]
    bf = b_mat.float().repeat_interleave(hpg, dim=1)     # [B,H,S,N]
    cf = c_mat.float().repeat_interleave(hpg, dim=1)
    cum = torch.cumsum(da.float(), dim=-1)               # [B,H,S]
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=xdt.device).tril()
    l_mat = torch.exp(torch.where(mask, diff, torch.full_like(diff, NEG_INF)))
    cb = torch.matmul(cf, bf.transpose(-1, -2))
    return torch.matmul(cb * l_mat, xdt.float())


def mamba_step_ref(
    z: torch.Tensor,           # [B, DI]   the compute dtype
    xbc: torch.Tensor,         # [B, CD]   CD = DI + 2 G N
    dt_raw: torch.Tensor,      # [B, H]
    conv: torch.Tensor,        # [B, W-1, CD] float32, updated in place
    ssm: torch.Tensor,         # [B, H, P, N] float32, updated in place
    conv_w: torch.Tensor,      # [W, CD]
    conv_b: torch.Tensor,      # [CD]
    dt_bias: torch.Tensor,     # [H]
    a_log: torch.Tensor,       # [H]
    d_skip: torch.Tensor,      # [H]
    norm_scale: torch.Tensor,  # [DI]
    *,
    groups: int,
    eps: float,
) -> torch.Tensor:
    """One Mamba-2 decode step between the in- and out-projections.

    The ops of ``repro_torch.models.layers.ssm.apply_mamba_step``'s plain
    path, in its order and at its roundings: the causal conv over the
    float32 window ``[conv | xbc]`` with SiLU, rounded to z's dtype;
    ``dt = softplus(dt_raw + dt_bias)``; the state decayed by
    ``exp(dt · -exp(a_log))`` plus ``dt B ⊗ x``; ``y = state · C + D x``;
    the gate ``y · silu(z)`` and the RMS norm with ``norm_scale``. Writes
    the new state and the rolled window into ``ssm`` and ``conv`` and
    returns the output ``[B, DI]`` in z's dtype.
    """
    import torch.nn.functional as F

    bsz, di = z.shape
    h = dt_raw.shape[1]
    n = (xbc.shape[1] - di) // (2 * groups)
    window = torch.cat([conv.float(), xbc[:, None, :].float()], dim=1)          # [B,W,CD]
    conv_out = torch.einsum("bwc,wc->bc", window, conv_w.float()) + conv_b.float()
    xbc_t = F.silu(conv_out).to(z.dtype)
    xs = xbc_t[:, :di].reshape(bsz, h, di // h)
    b_vec = xbc_t[:, di:di + groups * n].reshape(bsz, groups, n)
    c_vec = xbc_t[:, di + groups * n:].reshape(bsz, groups, n)
    dt = F.softplus(dt_raw.float() + dt_bias[None, :])
    a = -torch.exp(a_log)
    decay = torch.exp(dt * a.to(torch.float32)[None, :])                          # [B,H]
    b_h = b_vec.float().repeat_interleave(h // groups, dim=1)                     # [B,H,N]
    c_h = c_vec.float().repeat_interleave(h // groups, dim=1)
    dbx = torch.einsum("bh,bhn,bhp->bhpn", dt, b_h, xs.float())
    state = ssm * decay[..., None, None] + dbx
    y = torch.einsum("bhpn,bhn->bhp", state, c_h)
    y = (y + xs.float() * d_skip[None, :, None]).reshape(bsz, di)
    yf = y.float() * F.silu(z.float())
    ms = yf.square().mean(dim=-1, keepdim=True)
    out = (yf * torch.rsqrt(ms + eps) * norm_scale.float()).to(z.dtype)
    conv.copy_(window[:, 1:, :])
    ssm.copy_(state)
    return out
