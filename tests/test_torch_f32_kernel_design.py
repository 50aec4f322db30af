"""The float32 flash-attention and grouped-matmul kernels' designs, in numpy.

``csrc/flash_attention.cu``'s ``flash_fwd_3xtf32_kernel`` and
``csrc/gmm.cu``'s ``gmm_3xtf32_kernel`` multiply float32 on the tensor
cores as mma.sync m16n8k8 in 3xTF32 (``csrc/tf32.cuh``). ``FlashModel`` and
``GmmModel`` below compute the same way, step for step: the same tiles,
the same 8-deep product steps in the same arithmetic (3xTF32, or exactly,
or in single TF32), the flash kernel's masking and online softmax in log2
units. Each is held to the port's plain version and to the JAX package's
Pallas kernel in interpret mode. The precision tests show why the kernels
split their operands: 3xTF32 stays well inside the 1e-4 the kernels are
held to on the card (``chip_smoke.py``), single TF32 does not.

The index tests rebuild each mma's operands from the kernels' per-lane
reads, in the PTX fragment layout of m16n8k8 (tf32), and check that the
products are the ones meant: P feeding P·V from S's accumulator without a
shuffle, Q·Kᵀ over a permuted k, the float4 order of the flash output, and
the gmm's permuted k rows. The bank tests check that those reads hit 32
different banks of shared memory per access phase, and that without the
padding (flash) or the row choice (gmm) they would not.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_bhsd  # noqa: E402
from repro.kernels.moe_gmm import gmm as jax_gmm  # noqa: E402
from repro_torch.kernels.ref import attention_ref, gmm_ref  # noqa: E402
from tests._tf32 import mma_steps  # noqa: E402

torch.set_num_threads(1)

#: The kernels against their plain versions on the card (chip_smoke.py's
#: float32 TOL): 3xTF32 keeps ~2^-21 of each product, the sums run in
#: another order, and the flash kernel's exp2 is approximate (~2 ulp).
F32_TOL = 1e-4
NEG_INF = np.float32(-1e30)
LOG2E = 1.4426950408889634
BM = 64  # flash: query rows per CTA


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------


def flash_tile_keys(d):
    """Keys per K/V tile: 64, and 32 at D = 128 (two CTAs an SM in 101 KB)."""
    return 32 if d > 64 else 64


class FlashModel:
    """``flash_fwd_3xtf32_kernel`` in numpy, on the model layout [B, S, H, D].

    Per (batch, head, 64-row q tile): key tiles in order, those past the
    causal diagonal skipped; S = Q Kᵀ and O += P V as 8-deep mma steps; the
    mask only on tiles that cross the diagonal or the key end; the online
    softmax in log2 units, the scale and log2 e folded into one multiply-add
    per score (a single rounding, as ``fmaf``); O divided by the row sum at
    the end. Rows past S are computed on zeros and dropped, as the kernel
    does not store them.
    """

    def __init__(self, mode="3xtf32"):
        self.mode = mode

    def __call__(self, q, k, v, causal):
        b, s, h, d = q.shape
        t, kvh = k.shape[1], k.shape[2]
        kn = flash_tile_keys(d)
        scale_log2 = np.float32(np.float32(1.0 / math.sqrt(d)) * np.float32(LOG2E))
        out = np.zeros(q.shape, dtype=np.float32)
        for bi in range(b):
            for hh in range(h):
                kh = hh // (h // kvh)
                for q0 in range(0, s, BM):
                    rows = np.arange(q0, q0 + BM)
                    qt = np.zeros((BM, d), np.float32)
                    qt[:min(BM, s - q0)] = q[bi, q0:q0 + BM, hh]
                    kv_end = min(t, q0 + BM) if causal else t
                    m = np.full(BM, NEG_INF, np.float32)
                    l_sum = np.zeros(BM, np.float32)
                    o = np.zeros((BM, d), np.float32)
                    for k0 in range(0, kv_end, kn):
                        kt = np.zeros((kn, d), np.float32)
                        vt = np.zeros((kn, d), np.float32)
                        kt[:min(kn, t - k0)] = k[bi, k0:k0 + kn, kh]
                        vt[:min(kn, t - k0)] = v[bi, k0:k0 + kn, kh]
                        sc = mma_steps(np.zeros((BM, kn)), qt, kt.T, self.mode)
                        sc = sc.astype(np.float32)
                        if k0 + kn > t or (causal and k0 + kn - 1 > q0):
                            cols = k0 + np.arange(kn)
                            masked = ((cols[None, :] >= t)
                                      | (causal & (cols[None, :] > rows[:, None])))
                            sc = np.where(masked, NEG_INF, sc)
                        m_new = np.maximum(m, sc.max(axis=1) * scale_log2)
                        alpha = np.exp2(m - m_new)
                        m = m_new
                        p = np.exp2((sc.astype(np.float64) * scale_log2 - m[:, None])
                                    .astype(np.float32))
                        l_sum = l_sum * alpha + p.sum(axis=1, dtype=np.float32)
                        o = mma_steps(o * alpha[:, None], p, vt, self.mode).astype(np.float32)
                    keep = min(BM, s - q0)
                    out[bi, q0:q0 + keep, hh] = (o / np.maximum(l_sum, 1e-30)[:, None])[:keep]
        return out


def qkv(b, s, t, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, t, kvh, d)).astype(np.float32),
            rng.standard_normal((b, t, kvh, d)).astype(np.float32))


def flash_plain(q, k, v, causal):
    return attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()


FLASH_SHAPES = [  # (B, S, T, H, KV, D, causal)
    (1, 3, 3, 4, 2, 16, True),      # the CLI's prompt: one partial tile
    (1, 1, 1, 9, 3, 64, True),      # [topology]'s prompts of 1-3 tokens
    (1, 2, 2, 9, 3, 64, True),
    (1, 3, 3, 9, 3, 64, True),
    (2, 77, 77, 4, 2, 16, True),    # ragged S at the small head dims
    (1, 77, 77, 4, 2, 32, False),
    (1, 130, 130, 9, 3, 64, True),  # three q tiles, the last ragged
    (1, 70, 70, 4, 4, 64, False),
    (1, 100, 100, 4, 2, 128, True),  # D = 128: 32-key tiles, a tile past every row
    (1, 40, 150, 4, 2, 128, False),
    (1, 50, 130, 4, 2, 64, True),   # S < T, causal top-left
    (1, 20, 70, 2, 1, 32, False),   # S < T
]


class TestFlashModel:
    @pytest.mark.parametrize("mode", ["exact", "3xtf32"])
    @pytest.mark.parametrize("b,s,t,h,kvh,d,causal", FLASH_SHAPES)
    def test_matches_plain_reference(self, b, s, t, h, kvh, d, causal, mode):
        q, k, v = qkv(b, s, t, h, kvh, d, seed=1)
        np.testing.assert_allclose(FlashModel(mode)(q, k, v, causal), flash_plain(q, k, v, causal),
                                   rtol=F32_TOL, atol=F32_TOL)

    @pytest.mark.parametrize("b,s,t,h,kvh,d,causal",
                             [FLASH_SHAPES[i] for i in (0, 3, 6, 8, 10, 11)])
    def test_matches_pallas_kernel(self, b, s, t, h, kvh, d, causal):
        q, k, v = qkv(b, s, t, h, kvh, d, seed=2)
        bq = min(64, s)
        expect = flash_attention_bhsd(
            *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)),
            causal=causal, bq=bq, bk=bq, interpret=True).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(FlashModel("3xtf32")(q, k, v, causal), np.asarray(expect),
                                   rtol=F32_TOL, atol=F32_TOL)

    def test_rows_masked_in_a_whole_tile_get_nothing_from_it(self):
        """At D = 128 a 64-row q tile meets 32-key tiles: rows 0-31 see
        every key of tile 32-63 masked. Their running max stays that of tile
        0, so the masked tile adds exp2(-huge) = 0, and each row equals
        attention over its own keys alone."""
        q, k, v = qkv(1, 64, 64, 1, 1, 128, seed=3)
        out = FlashModel("exact")(q, k, v, causal=True)
        for r in (0, 5, 31):
            np.testing.assert_allclose(
                out[0, r], flash_plain(q[:, r:r + 1], k[:, :r + 1], v[:, :r + 1], False)[0, 0],
                rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Grouped matmul
# ---------------------------------------------------------------------------

GMM_BK = 32         # k per stage: one 128-byte row of float32
GMM_COLS = 128      # output columns per work item
GMM_NT = (8, 16, 32, 48, 64, 80)  # the instantiated C tiles


def gmm_c_tile(c):
    """``hopper::launch_f32``'s C tile: the least width that holds an even
    share of C in as few tiles of at most 80 as hold it."""
    tiles = -(-c // 80)
    rows = -(-c // tiles)
    return next(nt for nt in GMM_NT if rows <= nt)


def gmm_k_rows(t):
    """The rows of an 8-row k step that mma k indices t and t + 4 read
    (``ra``, ``rb`` in the kernel): 2t + p(t) and 2t + 1 - p(t), p(t) =
    (t ^ (t >> 1)) & 1."""
    p = (t ^ (t >> 1)) & 1
    return 2 * t + p, 2 * t + 1 - p


#: The k step's rows in the order of the mma's k index (0..7).
GMM_STEP_ROWS = [gmm_k_rows(t)[0] for t in range(4)] + [gmm_k_rows(t)[1] for t in range(4)]


class GmmModel:
    """``gmm_3xtf32_kernel`` in numpy.

    Per (expert, 128 columns, C tile of ``gmm_c_tile(C)`` rows): the k loop
    in stages of 32 (K past its end zero-filled, as TMA does), each stage
    four 8-deep mma steps whose k index i reads row ``GMM_STEP_ROWS[i]`` of
    the step, summed into a partial started at zero and then added to the
    output's float32 accumulator, stage after stage in order of k.
    """

    def __init__(self, mode="3xtf32"):
        self.mode = mode

    def __call__(self, x, w):
        e, c, k = x.shape
        n = w.shape[2]
        kp = -(-k // GMM_BK) * GMM_BK
        xp = np.zeros((e, c, kp), np.float32)
        wp = np.zeros((e, kp, n), np.float32)
        xp[:, :, :k], wp[:, :k] = x, w
        perm = np.concatenate([s + np.array(GMM_STEP_ROWS) for s in range(0, kp, 8)])
        nt = gmm_c_tile(c)
        out = np.zeros((e, c, n), np.float32)
        for ei in range(e):
            for n0 in range(0, n, GMM_COLS):
                for c0 in range(0, c, nt):
                    xs = xp[ei, c0:c0 + nt][:, perm]
                    ws = wp[ei, :, n0:n0 + GMM_COLS][perm]
                    acc = np.zeros((xs.shape[0], ws.shape[1]),
                                   np.float64 if self.mode == "exact" else np.float32)
                    for k0 in range(0, kp, GMM_BK):
                        acc += mma_steps(np.zeros_like(acc), xs[:, k0:k0 + GMM_BK],
                                         ws[k0:k0 + GMM_BK], self.mode)
                    out[ei, c0:c0 + nt, n0:n0 + GMM_COLS] = acc
        return out


def gmm_inputs(e, c, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, c, k)).astype(np.float32),
            (rng.standard_normal((e, k, n)) * k ** -0.5).astype(np.float32))


GMM_SHAPES = [  # (E, C, K, N): C of 5, 8 and 80 at narrow K and N, ragged K and N
    (3, 5, 100, 72),
    (2, 8, 64, 64),
    (4, 8, 96, 200),
    (2, 80, 64, 136),
    (2, 80, 33, 40),
    (1, 136, 48, 24),   # two C tiles of 68 in tiles of 80
    (1, 81, 200, 40),   # two C tiles of 41 in tiles of 48; seven stages of k
]


class TestGmmModel:
    @pytest.mark.parametrize("mode", ["exact", "3xtf32"])
    @pytest.mark.parametrize("e,c,k,n", GMM_SHAPES)
    def test_matches_plain_reference(self, e, c, k, n, mode):
        x, w = gmm_inputs(e, c, k, n, seed=1)
        expect = gmm_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(GmmModel(mode)(x, w), expect, rtol=F32_TOL, atol=F32_TOL)

    @pytest.mark.parametrize("e,c,k,n", GMM_SHAPES[:4])
    def test_matches_pallas_kernel(self, e, c, k, n):
        x, w = gmm_inputs(e, c, k, n, seed=2)
        expect = jax_gmm(jnp.asarray(x), jnp.asarray(w), interpret=True)
        np.testing.assert_allclose(GmmModel("3xtf32")(x, w), np.asarray(expect),
                                   rtol=F32_TOL, atol=F32_TOL)

    @pytest.mark.parametrize("c,tile", [(1, 8), (5, 8), (8, 8), (9, 16), (16, 16), (17, 32),
                                        (33, 48), (49, 64), (80, 80), (81, 48), (128, 64),
                                        (136, 80), (264, 80), (300, 80)])
    def test_c_tile(self, c, tile):
        """The tile holds an even share of C; tiles of it cover C."""
        assert gmm_c_tile(c) == tile
        assert -(-c // tile) * tile >= c


# ---------------------------------------------------------------------------
# Precision: why the operands are split
# ---------------------------------------------------------------------------


def tolerance_share(got, exact):
    """max |got - exact| / (tol + tol |exact|): 1 is the edge of allclose at F32_TOL."""
    return float(np.max(np.abs(got - exact) / (F32_TOL + F32_TOL * np.abs(exact))))


class TestTf32Precision:
    @pytest.fixture(scope="class")
    def flash_runs(self):
        """A reduced whisper-encoder shape: 12 heads cut to 2, S = T cut from
        1500 to 192, non-causal, D = 64; and a causal D = 128 one."""
        out = {}
        for name, (shape, causal) in {"d64": ((1, 192, 192, 2, 2, 64), False),
                                      "d128": ((1, 128, 128, 2, 1, 128), True)}.items():
            q, k, v = qkv(*shape, seed=5)
            exact = FlashModel("exact")(q, k, v, causal).astype(np.float64)
            for mode in ("3xtf32", "tf32"):
                out[(name, mode)] = tolerance_share(FlashModel(mode)(q, k, v, causal), exact)
        return out

    @pytest.fixture(scope="class")
    def gmm_runs(self):
        """phi3.5-MoE's decode C = 8 at K = 1024 (4096 cut), N = 64."""
        x, w = gmm_inputs(2, 8, 1024, 64, seed=6)
        exact = GmmModel("exact")(x, w).astype(np.float64)
        return {mode: tolerance_share(GmmModel(mode)(x, w), exact) for mode in ("3xtf32", "tf32")}

    @pytest.mark.parametrize("shape", ["d64", "d128"])
    def test_flash_split_products_stay_within_a_tenth_of_the_tolerance(self, flash_runs, shape):
        assert flash_runs[(shape, "3xtf32")] <= 0.1, flash_runs

    @pytest.mark.parametrize("shape", ["d64", "d128"])
    def test_flash_single_tf32_exceeds_the_tolerance(self, flash_runs, shape):
        assert flash_runs[(shape, "tf32")] > 1.0, flash_runs

    def test_gmm_split_products_stay_within_a_tenth_of_the_tolerance(self, gmm_runs):
        assert gmm_runs["3xtf32"] <= 0.1, gmm_runs

    def test_gmm_single_tf32_exceeds_the_tolerance(self, gmm_runs):
        assert gmm_runs["tf32"] > 1.0, gmm_runs


# ---------------------------------------------------------------------------
# Fragments: the PTX layout of mma.sync m16n8k8 (tf32), lane = 4 g + t
# ---------------------------------------------------------------------------

LANES = [(lane, lane >> 2, lane & 3) for lane in range(32)]


def a_coords(g, t):
    """(row, k) of a0..a3: A is 16 x 8, row-major."""
    return [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]


def b_coords(g, t):
    """(k, n) of b0, b1: B is 8 x 8."""
    return [(t, g), (t + 4, g)]


def d_coords(g, t):
    """(row, n) of d0..d3: D is 16 x 8."""
    return [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]


def mma(a_frags, b_frags):
    """D = A B from per-lane fragments, returned as per-lane D fragments."""
    a = np.zeros((16, 8))
    b = np.zeros((8, 8))
    for lane, g, t in LANES:
        for (r, c), val in zip(a_coords(g, t), a_frags[lane]):
            a[r, c] = val
        for (r, c), val in zip(b_coords(g, t), b_frags[lane]):
            b[r, c] = val
    d = a @ b
    return [[d[r, c] for r, c in d_coords(g, t)] for _, g, t in LANES]


class TestFlashFragments:
    def test_layout_covers_each_matrix_once(self):
        for coords, shape in ((a_coords, (16, 8)), (b_coords, (8, 8)), (d_coords, (16, 8))):
            seen = [rc for _, g, t in LANES for rc in coords(g, t)]
            assert sorted(seen) == [(r, c) for r in range(shape[0]) for c in range(shape[1])]

    def test_qk_over_paired_dims(self):
        """S's block = Q Kᵀ over 8 dims when k = t reads dim 2t and k = t + 4
        dim 2t + 1: Q's A fragment {top.x, bot.x, top.y, bot.y} and K's B
        fragment (kb.x, kb.y) from float2 reads at column 2t."""
        rng = np.random.default_rng(0)
        q, k = rng.standard_normal((16, 8)), rng.standard_normal((8, 8))  # 16 rows, 8 keys
        a = [[q[g, 2 * t], q[g + 8, 2 * t], q[g, 2 * t + 1], q[g + 8, 2 * t + 1]]
             for _, g, t in LANES]
        b = [[k[g, 2 * t], k[g, 2 * t + 1]] for _, g, t in LANES]
        s = q @ k.T
        for (_, g, t), d in zip(LANES, mma(a, b)):
            np.testing.assert_allclose(d, [s[r, c] for r, c in d_coords(g, t)])

    def test_p_feeds_pv_from_the_accumulator_without_a_shuffle(self):
        """P's A fragment is {s0, s2, s1, s3} of S's accumulator when k = t
        stands for key 2t and k = t + 4 for key 2t + 1: every lane's A
        entries are P at (row, key of k), with no value from another lane."""
        rng = np.random.default_rng(1)
        p = rng.standard_normal((16, 8))
        acc = [[p[r, c] for r, c in d_coords(g, t)] for _, g, t in LANES]
        key = lambda kk: 2 * kk if kk < 4 else 2 * (kk - 4) + 1  # noqa: E731
        for (lane, g, t) in LANES:
            s0, s1, s2, s3 = acc[lane]
            for (r, kk), val in zip(a_coords(g, t), [s0, s2, s1, s3]):
                assert val == p[r, key(kk)]

    @pytest.mark.parametrize("d", [16, 32, 64, 128])
    def test_pv_pairs_and_the_float4_store(self, d):
        """O = P V for one key block: V read as float2 at (key 2t, dim 16 m
        + 2g) and (key 2t + 1, ...) feeds blocks 2m (.x) and 2m + 1 (.y); the
        thread's outputs of a row, (o[2m][0], o[2m+1][0], o[2m][1],
        o[2m+1][1]), are dims 16 m + 4t ... + 3."""
        rng = np.random.default_rng(2)
        p, v = rng.standard_normal((16, 8)), rng.standard_normal((8, d))
        acc = [[p[r, c] for r, c in d_coords(g, t)] for _, g, t in LANES]
        a = [[s[0], s[2], s[1], s[3]] for s in acc]
        o = np.zeros((16, d))
        for mp in range(d // 16):
            lo = mma(a, [[v[2 * t, 16 * mp + 2 * g], v[2 * t + 1, 16 * mp + 2 * g]]
                         for _, g, t in LANES])
            hi = mma(a, [[v[2 * t, 16 * mp + 2 * g + 1], v[2 * t + 1, 16 * mp + 2 * g + 1]]
                         for _, g, t in LANES])
            for (lane, g, t) in LANES:
                for r in range(2):
                    o[g + 8 * r, 16 * mp + 4 * t:16 * mp + 4 * t + 4] = [
                        lo[lane][2 * r], hi[lane][2 * r], lo[lane][2 * r + 1], hi[lane][2 * r + 1]]
        np.testing.assert_allclose(o, p @ v, atol=1e-12)


class TestGmmFragments:
    def test_step_rows_are_a_permutation(self):
        assert sorted(GMM_STEP_ROWS) == list(range(8))

    def test_swapped_product_over_the_chosen_rows(self):
        """out^T's 16 columns x 8 rows of C = Wᵀ X over an 8-deep step, with
        A = w[row][column] at rows ra, rb and columns g, g + 8, and B =
        x[c = g][row] at the same rows."""
        rng = np.random.default_rng(3)
        w = rng.standard_normal((8, 16))  # [k, this warp's 16 columns]
        x = rng.standard_normal((8, 8))   # [8 rows of C, k]
        a, b = [], []
        for _, g, t in LANES:
            ra, rb = gmm_k_rows(t)
            a.append([w[ra, g], w[ra, g + 8], w[rb, g], w[rb, g + 8]])
            b.append([x[g, ra], x[g, rb]])
        out_t = w.T @ x.T
        for (_, g, t), d in zip(LANES, mma(a, b)):
            np.testing.assert_allclose(d, [out_t[r, c] for r, c in d_coords(g, t)])


# ---------------------------------------------------------------------------
# Shared-memory banks
# ---------------------------------------------------------------------------


def conflict_free(word_addrs, width):
    """Whether one warp's access of ``width`` 32-bit words a lane (1: scalar,
    2: float2) runs at one wavefront per phase: the 32 words of each phase
    (the whole warp, or each half-warp of 16 lanes for 8-byte accesses) in
    32 different banks, or at one address."""
    lanes_per_phase = 32 // width
    for p0 in range(0, 32, lanes_per_phase):
        words = {a + i for a in word_addrs[p0:p0 + lanes_per_phase] for i in range(width)}
        if len({w % 32 for w in words}) != len(words):
            return False
    return True


def flash_row_strides(d):
    """The kernel's padded rows (floats): Q and K D + 8, V D + 4."""
    return d + 8, d + 4


class TestFlashBanks:
    @pytest.mark.parametrize("d", [16, 32, 64, 128])
    def test_q_and_k_float2_reads(self, d):
        ldk, _ = flash_row_strides(d)
        for kk in range(d // 8):
            for warp in range(4):
                for half in range(2):
                    q = [(warp * 16 + g + 8 * half) * ldk + 8 * kk + 2 * t for _, g, t in LANES]
                    assert conflict_free(q, 2)
            for n in range(flash_tile_keys(d) // 8):
                assert conflict_free([(8 * n + g) * ldk + 8 * kk + 2 * t for _, g, t in LANES], 2)

    @pytest.mark.parametrize("d", [16, 32, 64, 128])
    def test_v_float2_reads(self, d):
        _, ldv = flash_row_strides(d)
        for kb in range(flash_tile_keys(d) // 8):
            for mp in range(d // 16):
                for key in (0, 1):  # v0 (key 2t), v1 (key 2t + 1)
                    addrs = [(8 * kb + 2 * t + key) * ldv + 16 * mp + 2 * g for _, g, t in LANES]
                    assert conflict_free(addrs, 2)

    @pytest.mark.parametrize("d", [32, 64, 128])
    def test_unpadded_rows_would_conflict(self, d):
        """Rows of D floats (a multiple of 32 words) put every row's column in
        one bank: K's and V's reads would take 4 wavefronts a phase."""
        assert not conflict_free([g * d + 2 * t for _, g, t in LANES], 2)
        assert not conflict_free([2 * t * d + 2 * g for _, g, t in LANES], 2)


def sw128_word(row, col):
    """``hopper::sw128`` in words: float ``col`` of row ``row`` of a box of
    128-byte rows under TMA's 128-byte swizzle."""
    return (row * 128 + ((((col >> 2) ^ row) & 7) << 4) + ((col & 3) << 2)) // 4


class TestGmmBanks:
    def test_weight_reads(self):
        """a0-a3: rows 8 kk + ra or rb, columns 16 (wq & 1) + g (+ 8)."""
        for kk in range(GMM_BK // 8):
            for half in (0, 16):
                for plus in (0, 8):
                    for pick in (0, 1):
                        addrs = [sw128_word(8 * kk + gmm_k_rows(t)[pick], half + g + plus)
                                 for _, g, t in LANES]
                        assert conflict_free(addrs, 1)

    def test_x_reads(self):
        """b0, b1: row 8 j + g of the C tile, columns 8 kk + ra or rb."""
        for j in range(16):
            for kk in range(GMM_BK // 8):
                for pick in (0, 1):
                    addrs = [sw128_word(8 * j + g, 8 * kk + gmm_k_rows(t)[pick])
                             for _, g, t in LANES]
                    assert conflict_free(addrs, 1)

    def test_the_plain_row_order_would_conflict(self):
        """k = t reading row t: rows 0 and 1 XOR the same pair of chunks."""
        assert not conflict_free([sw128_word(t, g) for _, g, t in LANES], 1)
