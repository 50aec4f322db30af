"""The SSD-scan kernel's design, modelled in numpy and held to the references.

``csrc/ssd_scan.cu`` splits the scan into three kernels: each chunk's own
state, the state passed from chunk to chunk, and each chunk's outputs in
64-row blocks whose C·Bᵀ serves a block of heads. ``StageModel`` below
computes the same way, step for step: float64 prefix sums kept as float32
pairs, the decay factored per 8-column k-step off the diagonal and formed
directly on it, products in the kernel's
3xTF32 arithmetic (or exactly, or in single TF32). It is held to the
port's plain ``ssd_scan_ref`` and to the JAX package's Pallas kernel in
interpret mode, and shows why the kernel splits its float32 operands:
3xTF32 stays well inside the 1e-4 tolerance the kernel is held to on the
card, single TF32 does not.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_scan_bhsd  # noqa: E402
from repro_torch.kernels.ref import ssd_scan_ref  # noqa: E402
from tests._tf32 import matmul, tf32_round  # noqa: E402

torch.set_num_threads(1)

SSD_TOL = 1e-4  # the kernel against ssd_scan_ref on the card (chip_smoke.py)
LOG2E = 1.4426950408889634
ROWS = 64       # rows of a chunk-scan block, 16 a warp
KSTEP = 8       # k values of one mma / wgmma step


# ---------------------------------------------------------------------------
# The kernel's stage decomposition
# ---------------------------------------------------------------------------


def chunk_cum(da_chunk, q):
    """float64 prefix sum of da over a chunk (rows >= q repeat cum[q-1])."""
    d = np.zeros(len(da_chunk), dtype=np.float64)
    d[:q] = da_chunk[:q]
    return np.cumsum(d)


def decay_factors(cum, r, s):
    """exp(cum[r] - cum[s]) for s <= r as the chunk scan forms it: a row
    factor and a column factor, whose product is the decay.

    The prefix sums are scaled by log2(e) and held as float32 pairs. Off the
    diagonal (``s | 7`` at or before the first row of r's 16-row warp tile)
    the decay is exp(cum[r] - cum[s | 7]) · exp(cum[s | 7] - cum[s]), both at
    most 1; on the diagonal's 8-column steps it is exp(cum[r] - cum[s]) and
    the column factor 1. Where s > r the values are not used.
    """
    c2 = cum * LOG2E
    hi = c2.astype(np.float32)
    lo = (c2 - hi.astype(np.float64)).astype(np.float32)
    k = np.minimum(s | (KSTEP - 1), len(cum) - 1)  # rows past q repeat cum[q-1]
    off = k <= (r & ~15)
    with np.errstate(over="ignore"):
        row = np.where(off, np.exp2((hi[r] - hi[k]) + (lo[r] - lo[k])),
                       np.exp2((hi[r] - hi[s]) + (lo[r] - lo[s])))
    col = np.where(off, np.exp((cum[k] - cum[s]).astype(np.float32)), np.float32(1))
    return row, col


class StageModel:
    """The three kernels of ``ssd_scan.cu`` in numpy, on the kernel layout."""

    def __init__(self, mode="3xtf32", heads_per_block=2):
        self.mode = mode
        self.hb = heads_per_block

    def __call__(self, xdt, da, bm, cm, chunk):
        states, decay = self.chunk_states(xdt, da, bm, chunk)
        self.state_pass(states, decay)
        return self.chunk_scan(xdt, da, bm, cm, chunk, states)

    def chunk_states(self, xdt, da, bm, chunk):
        """Stage 1: (xdt · exp(cum[Q-1] - cum))ᵀ · B of every chunk but the
        last, and exp(cum[Q-1]); chunks before the last are whole."""
        bsz, h, s, p = xdt.shape
        g, n = bm.shape[1], bm.shape[3]
        nc = math.ceil(s / chunk)
        states = np.zeros((bsz, h, max(nc - 1, 0), p, n), dtype=np.float32)
        decay = np.zeros((bsz, h, max(nc - 1, 0)), dtype=np.float32)
        for b in range(bsz):
            for hh in range(h):
                gg = hh // (h // g)
                for c in range(nc - 1):
                    rows = slice(c * chunk, (c + 1) * chunk)
                    cum = chunk_cum(da[b, hh, 0, rows], chunk)
                    w = np.exp((cum[-1] - cum).astype(np.float32))
                    xw = (xdt[b, hh, rows] * w[:, None]).astype(np.float32)
                    states[b, hh, c] = matmul(xw.T, bm[b, gg, rows], self.mode)
                    decay[b, hh, c] = np.exp(np.float32(cum[-1]))
        return states, decay

    @staticmethod
    def state_pass(states, decay):
        """Stage 2, in place: states[c] becomes the state entering chunk c + 1."""
        for c in range(1, states.shape[2]):
            states[:, :, c] = states[:, :, c - 1] * decay[:, :, c, None, None] + states[:, :, c]

    def chunk_scan(self, xdt, da, bm, cm, chunk, states):
        """Stage 3: per (b, chunk, 64-row block, group, block of heads), C·Bᵀ
        once, then per head exp(cum) (C·startᵀ) + (C·Bᵀ ∘ L)·xdt."""
        bsz, h, s, p = xdt.shape
        g = bm.shape[1]
        hpg = h // g
        nc = math.ceil(s / chunk)
        y = np.zeros(xdt.shape, dtype=np.float32)
        for b in range(bsz):
            for c in range(nc):
                row0 = c * chunk
                q = min(chunk, s - row0)
                for l0 in range(0, q, ROWS):
                    s_end = min(l0 + ROWS, q)
                    r = np.arange(l0, s_end)
                    for gg in range(g):
                        c_rows = cm[b, gg, row0 + l0:row0 + s_end].astype(np.float32)
                        b_rows = bm[b, gg, row0:row0 + s_end].astype(np.float32)
                        cb = matmul(c_rows, b_rows.T, self.mode).astype(np.float32)
                        for h0 in range(gg * hpg, (gg + 1) * hpg, self.hb):
                            for hh in range(h0, min(h0 + self.hb, (gg + 1) * hpg)):
                                y[b, hh, row0 + l0:row0 + s_end] = self._head(
                                    xdt[b, hh, row0:row0 + s_end], da[b, hh, 0, row0:row0 + q],
                                    cb, c_rows, states[b, hh, c - 1] if c > 0 else None,
                                    r, s_end, q)
        return y

    def _head(self, x_rows, da_chunk, cb, c_rows, start, r, s_end, q):
        cum = chunk_cum(da_chunk, q)
        c2 = cum * LOG2E
        hi = c2.astype(np.float32)
        lo = (c2 - hi.astype(np.float64)).astype(np.float32)
        cols = np.arange(s_end)
        row, col = decay_factors(cum, r[:, None], cols[None, :])
        with np.errstate(invalid="ignore", over="ignore"):  # s > r: inf, zeroed below
            scores = np.where(cols[None, :] <= r[:, None], (cb * row) * col, np.float32(0))
        out = matmul(scores.astype(np.float32), x_rows, self.mode).astype(np.float32)
        if start is not None:
            ecum = np.exp2(hi[r]) * (np.float32(1) + lo[r] * np.float32(math.log(2)))
            carried = matmul(c_rows, start.T, self.mode).astype(np.float32)
            out = carried * ecum[:, None] + out
        return out


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


MODEL_DT = (1e-3, 0.2)   # the model's dt range (as chip_smoke.py draws it)
LARGE_DT = (0.8, 2.0)    # dt with no upper limit: at A = -16, 7 rows of |da| > 88


def ssd_inputs(b, h, s, p, g, n, bf16_bc=False, seed=0, dt_range=MODEL_DT, a_min=1.0):
    """The kernel layout: dt log-uniform in ``dt_range``, A from -a_min to
    -16 over the heads (the model's ranges by default)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, s, p)).astype(np.float32)
    dt = np.exp(rng.uniform(*np.log(dt_range), (b, h, s))).astype(np.float32)
    a = -np.linspace(a_min, 16.0, h).astype(np.float32)
    bm = rng.standard_normal((b, g, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, g, s, n)).astype(np.float32)
    if bf16_bc:  # bf16-valued B and C, held in float32
        bm = torch.from_numpy(bm).bfloat16().float().numpy()
        cm = torch.from_numpy(cm).bfloat16().float().numpy()
    xdt = (x * dt[..., None]).astype(np.float32)
    da = (dt * a[None, :, None]).astype(np.float32)[:, :, None, :]
    return xdt, da, bm, cm


SHAPES = [  # (B, H, S, P, G, N, chunk)
    (2, 4, 128, 16, 1, 32, 32),    # four whole chunks, one group
    (1, 4, 100, 8, 2, 16, 32),     # G = 2, a ragged last chunk
    (1, 6, 150, 16, 3, 16, 64),    # G = 3, row blocks of 64 in a chunk of 64, ragged
    (1, 2, 20, 8, 2, 16, 32),      # S < chunk: one chunk, no state stages
    (1, 4, 300, 8, 1, 16, 128),    # chunk of two row blocks, ragged, nc = 3
]


def plain(xdt, da, bm, cm, chunk):
    return ssd_scan_ref(*map(torch.from_numpy, (xdt, da, bm, cm)), chunk=chunk).numpy()


class TestStageModel:
    @pytest.mark.parametrize("mode", ["exact", "3xtf32"])
    @pytest.mark.parametrize("b,h,s,p,g,n,chunk", SHAPES)
    def test_matches_plain_reference(self, b, h, s, p, g, n, chunk, mode):
        xdt, da, bm, cm = ssd_inputs(b, h, s, p, g, n, seed=1)
        out = StageModel(mode)(xdt, da, bm, cm, chunk)
        np.testing.assert_allclose(out, plain(xdt, da, bm, cm, chunk),
                                   rtol=SSD_TOL, atol=SSD_TOL)

    @pytest.mark.parametrize("b,h,s,p,g,n,chunk", [SHAPES[0], SHAPES[1], SHAPES[3]])
    def test_matches_pallas_kernel(self, b, h, s, p, g, n, chunk):
        xdt, da, bm, cm = ssd_inputs(b, h, s, p, g, n, seed=2)
        expect = ssd_scan_bhsd(*map(jnp.asarray, (xdt, da, bm, cm)), chunk=chunk,
                               interpret=True)
        out = StageModel("3xtf32")(xdt, da, bm, cm, chunk)
        np.testing.assert_allclose(out, np.asarray(expect), rtol=SSD_TOL, atol=SSD_TOL)

    @pytest.mark.parametrize("heads_per_block", [1, 2, 3])
    def test_head_blocks_do_not_change_the_result(self, heads_per_block):
        """C·Bᵀ shared across a block of heads gives each head what its own would."""
        xdt, da, bm, cm = ssd_inputs(1, 6, 70, 8, 2, 16, seed=3)
        ref_out = StageModel("exact", heads_per_block=1)(xdt, da, bm, cm, 32)
        out = StageModel("exact", heads_per_block=heads_per_block)(xdt, da, bm, cm, 32)
        np.testing.assert_array_equal(out, ref_out)

    def test_state_pass_is_the_chunk_recurrence(self):
        """In place, states[c] becomes start[c+1] = start[c]·decay[c] + state[c]."""
        rng = np.random.default_rng(4)
        states = rng.standard_normal((2, 3, 5, 4, 6)).astype(np.float32)
        decay = rng.uniform(0.1, 1.0, (2, 3, 5)).astype(np.float32)
        expect = np.zeros_like(states)
        start = np.zeros_like(states[:, :, 0])
        for c in range(5):
            start = start * decay[:, :, c, None, None] + states[:, :, c]
            expect[:, :, c] = start
        got = states.copy()
        StageModel.state_pass(got, decay)
        np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("dt_range", [MODEL_DT, LARGE_DT], ids=["model_dt", "large_dt"])
    def test_factored_decay_matches_direct_exp(self, dt_range):
        """The decay as the chunk scan forms it keeps exp(cum[r] - cum[s])
        within 1e-5 relative (a tenth of the kernel's tolerance) wherever it is
        above 1e-30, and within 1e-30 below that (where terms are far under the
        tolerance): the float32 rounding of the exponent, which grows with
        |cum[r] - cum[s]|. At A = -16 with dt up to 2, where seven rows of da
        sum past float32's exp range, every value stays finite."""
        rng = np.random.default_rng(5)
        da = -16 * np.exp(rng.uniform(*np.log(dt_range), 256))
        cum = np.cumsum(da)
        r, s = np.tril_indices(256)
        row, col = decay_factors(cum, r, s)
        e = row * col
        assert np.isfinite(e).all()
        np.testing.assert_allclose(e, np.exp(cum[r] - cum[s]), rtol=1e-5, atol=1e-30)

    @pytest.mark.parametrize("mode", ["exact", "3xtf32"])
    @pytest.mark.parametrize("b,h,s,p,g,n,chunk", [SHAPES[1], SHAPES[4]])
    def test_large_dt_matches_plain_reference(self, b, h, s, p, g, n, chunk, mode):
        """dt in [0.8, 2] at A = -16 (dt has no upper limit in Mamba-2): decays
        of seven rows below exp(-88), where a factor taken from the k-step's
        first column would overflow."""
        xdt, da, bm, cm = ssd_inputs(b, h, s, p, g, n, seed=8, dt_range=LARGE_DT, a_min=16.0)
        out = StageModel(mode)(xdt, da, bm, cm, chunk)
        np.testing.assert_allclose(out, plain(xdt, da, bm, cm, chunk),
                                   rtol=SSD_TOL, atol=SSD_TOL)

    def test_mixed_large_dt_matches_float64(self):
        """dt from 1e-3 to 2 at A = -16, held to a float64 quadratic oracle:
        the kernel's float64 prefix sums keep small decays exact after large
        ones. (The plain version's float32 cumsum reaches ~|4000| here, and its
        own error is about the tolerance, so the oracle is float64.)"""
        b, h, s, p, g, n, chunk = 1, 4, 300, 16, 2, 32, 128
        xdt, da, bm, cm = ssd_inputs(b, h, s, p, g, n, seed=9, dt_range=(1e-3, 2.0), a_min=16.0)
        out = StageModel("3xtf32")(xdt, da, bm, cm, chunk)
        np.testing.assert_allclose(out, quadratic64(xdt, da, bm, cm), rtol=SSD_TOL, atol=SSD_TOL)


def quadratic64(xdt, da, bm, cm):
    """The scan as one [S, S] decay mask per head, all in float64."""
    h, hpg = xdt.shape[1], xdt.shape[1] // bm.shape[1]
    out = np.zeros(xdt.shape)
    for b in range(xdt.shape[0]):
        for hh in range(h):
            cum = np.cumsum(da[b, hh, 0].astype(np.float64))
            mask = np.tril(np.exp(np.minimum(cum[:, None] - cum[None, :], 0.0)))
            cb = cm[b, hh // hpg].astype(np.float64) @ bm[b, hh // hpg].astype(np.float64).T
            out[b, hh] = (cb * mask) @ xdt[b, hh].astype(np.float64)
    return out


class TestTf32Precision:
    # A reduced loss-like shape: mamba2-2.7b's P, N and chunk, four heads of
    # the model's range of A, S cut to four chunks; bf16-valued B and C as the
    # bf16 model path passes them.
    SHAPE = (1, 4, 1024, 64, 1, 128, 256)

    @pytest.fixture(scope="class")
    def runs(self):
        b, h, s, p, g, n, chunk = self.SHAPE
        xdt, da, bm, cm = ssd_inputs(b, h, s, p, g, n, bf16_bc=True, seed=6)
        exact = StageModel("exact")(xdt, da, bm, cm, chunk).astype(np.float64)
        bound = SSD_TOL + SSD_TOL * np.abs(exact)
        return {mode: np.max(np.abs(StageModel(mode)(xdt, da, bm, cm, chunk) - exact) / bound)
                for mode in ("3xtf32", "tf32")}

    def test_split_products_stay_within_a_tenth_of_the_tolerance(self, runs):
        assert runs["3xtf32"] <= 0.1, runs

    def test_single_tf32_exceeds_the_tolerance(self, runs):
        assert runs["tf32"] > 1.0, runs

    def test_rounding_matches_round_half_away(self):
        rng = np.random.default_rng(7)
        x = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-6, 6, 4096)).astype(np.float32)
        got = tf32_round(x).astype(np.float64)
        # Nearest multiple of the TF32 ulp (2^(e-10)), ties away from zero.
        e = np.floor(np.log2(np.abs(x.astype(np.float64))))
        ulp = 2.0 ** (e - 10)
        want = np.sign(x) * np.floor(np.abs(x.astype(np.float64)) / ulp + 0.5) * ulp
        np.testing.assert_array_equal(got, want)


class TestSharedLayout:
    """The kernel's 128-byte-swizzled K-major planes (``sw_off``)."""

    @staticmethod
    def sw_off(n, c):
        return ((n >> 3) << 8) + ((n & 7) << 5) + ((c ^ (n & 7)) << 2)

    @pytest.mark.parametrize("rows", [64, 128])  # stage 3's xdt and state planes, stage 1's B
    def test_every_chunk_has_its_own_place(self, rows):
        offs = {self.sw_off(n, c) for n in range(rows) for c in range(8)}
        assert len(offs) == rows * 8
        assert min(offs) == 0 and max(offs) == rows * 32 - 4

    def test_a_quarter_warp_stores_to_distinct_banks(self):
        """Eight consecutive threads store chunks cq = 0..7 of one row: 16-byte
        stores that land in eight different 16-byte bank groups."""
        for n in range(64):
            groups = {(self.sw_off(n, cq) // 4) % 8 for cq in range(8)}
            assert len(groups) == 8
