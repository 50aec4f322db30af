// Flash attention (forward) for Hopper, written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_bhsd`
// in repro/kernels/flash_attention.py (and the layout transposes of its
// model-layout wrapper `flash_attention` in repro/kernels/ops.py).
//
// Computes, per (batch, head), softmax(Q K^T / sqrt(D)) V with the Pallas
// kernel's masking: causal is top-left aligned (row >= col), columns at or
// past the key length are masked, GQA reads kv head h / (H / KV) in place
// without repeating K/V. The running max, sum and accumulator are float32
// and the output is written in q's dtype.
//
// Layout: the model's [B, S, H, D] (and [B, T, KV, D] for K/V), with any
// batch/sequence/head strides and a contiguous last dimension, so no
// transposes are needed around the call. D is 16, 32, 64 or 128 (the head dims
// the Pallas kernel is run at); bf16 or float32.
//
// What bounds it: at the serving shapes (B=1, S=T <= 512; smollm-135m's
// H=9, KV=3, D=64, phi3.5-MoE's H=32, KV=8, D=128) one call moves at most
// ~1.6 MB (smollm) or ~10.5 MB (phi), 0.5 us and 3.1 us at 3.35 TB/s, and
// its bf16 products would take less than that on the tensor cores. What
// sets the time is latency: a launch costs a few microseconds, the causal
// key loop of the last q tile is S/64 tiles long and runs in order in one
// CTA, and ceil(S/64) * H CTAs (72 for smollm at S=512) do not fill 132
// SMs, so each SM runs one or two CTAs of 4 warps with little to overlap.
//
// bfloat16 design (the serving dtype). One CTA of 4 warps per (64-row q
// tile, head, batch); each warp owns 16 query rows. Products run on the
// tensor cores as mma.sync m16n8k16 (bf16 in, f32 accumulate), operands
// loaded from shared memory with ldmatrix (.trans for V). K/V tiles of 64
// keys stay bf16 in shared memory and arrive by 16-byte cp.async into a
// ring of three slots (tile j's V is read, tile j+1's K is read, tile j+2
// is in flight), with one barrier per tile; the ragged edge is zero-filled
// by cp.async's src-size operand, and an XOR swizzle of the 16-byte chunks
// keeps ldmatrix free of bank conflicts. Q and the ring take 56 KB at D=64
// and 112 KB at D=128 (two CTAs per SM). The key loop is software-
// pipelined: each step issues Q K^T of tile j+1 before the softmax and P V
// of tile j, so the tensor cores work while the same warp does tile j's
// exponentials. S accumulates in f32 registers; the mask is applied there,
// only on tiles that cross the diagonal or the key end; the scale and
// log2 e fold into one FMA before ex2; the online softmax reduces each row
// over the 4 lanes that hold it with shuffles. P never leaves registers:
// the m16n8 accumulator layout of S is the m16n8k16 A layout, so P is
// rounded to bf16 and fed straight into P V. That rounding is the one
// difference from the Pallas body, which multiplies P in f32: it is at
// most 2^-9 relative per entry, well inside the bf16 tolerance of 2e-2. Q
// fragments stay in registers at D=64; at D=128 they are re-read from
// shared memory at each step, which frees the registers the pipelined S
// needs (no spills in either). Causal tiles past the diagonal are never
// visited, and blocks take q tiles heaviest first, with the blocks that
// share an SM with the heaviest taking the lightest. Inputs whose base
// address or strides are not multiples of 16 bytes take the same kernel
// with element-wise loads in place of cp.async. The 64-key tile and the
// block order were chosen by measurement on the H100 (PERF.md): 128-key
// tiles were slower at the serving shapes and spill at D=128.
//
// float32 design: a CUDA-core kernel, only ever instantiated for
// float32. It does the Pallas body's f32
// arithmetic exactly (no TF32), which is what keeps the f32 greedy tokens
// identical with the kernel on and off, and it beats SDPA in f32 at the
// serving shapes. One CTA of 256 threads per (64-row q tile, head, batch)
// stages Q and each 64-key K/V tile in shared memory as f32; each thread
// owns a 4x4 block of the score tile and 4 x D/16 accumulator entries.
// There is no path from a bf16 call to it: dtype picks the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;  // query rows per CTA
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t sqb, sqs, sqh;  // element strides; the last dimension is contiguous
  int64_t skb, sks, skh;
  int64_t svb, svs, svh;
  int64_t sob, sos, soh;
  int S, T, H, KV;
  float scale;
  int causal;
  int sms;  // the card's SMs (the bf16 kernel's block order)
};

// ---------------------------------------------------------------------------
// bfloat16: tensor cores, cp.async ring, P in registers
// ---------------------------------------------------------------------------

namespace tc {

constexpr int WARPS = 4;           // 16 query rows each: BM = 64
constexpr int THREADS = 32 * WARPS;
constexpr int KN = 64;             // keys per K/V tile
constexpr int STAGES = 3;          // ring slots: tile j (V read), j + 1 (K read), j + 2 (loading)
static_assert(KN % 16 == 0, "key tile");

// One Q tile and STAGES K and V tiles, bf16: 56 KB at D=64, 112 KB at D=128.
template <int D>
constexpr size_t smem_bytes() {
  return (size_t)D * 2 * (BM + 2 * STAGES * KN);
}

// Byte offset of 16-byte chunk `c` of row `r` in a [rows][D] bf16 tile.
// The 8 rows that one ldmatrix reads at one logical chunk must land in the
// 8 different 16-byte bank groups of a 128-byte line. At D >= 64 a row
// spans whole lines and the chunk is stored at c ^ (r & 7). At D = 32 (4
// chunks) and D = 16 (2 chunks) a line holds 2 or 4 rows, which already
// sit in different groups, so the XOR takes the row's line, masked to the
// row's chunk count: c ^ ((r >> 1) & 3) and c ^ ((r >> 2) & 1). The
// pattern repeats every 8 rows at every D.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int CHUNKS = D / 8;
  if constexpr (CHUNKS >= 8) {
    return (uint32_t)(r * D * 2 + ((c ^ (r & 7)) << 4));
  } else {
    constexpr int SHIFT = CHUNKS == 4 ? 1 : 2;  // rows per 128-byte line: 2 or 4
    return (uint32_t)(r * D * 2 + ((c ^ ((r >> SHIFT) & (CHUNKS - 1))) << 4));
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a (16x16, row-major) * b (16x8, column-major); bf16 in, f32 sums.
// Not volatile: it touches no memory, so the compiler may move it past the
// (volatile, in program order) ldmatrix loads of the next step.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair: `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {  // 2^x; -1e30 gives 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A thread's share of a [ROWS][D] bf16 tile: 16-byte chunk c = tid %
// CHUNKS of rows r0 + it * RSTEP, r0 = tid / CHUNKS. RSTEP is a multiple
// of 8, so every row of the share has the swizzle of r0 and the shared and
// global addresses only step by constants.
template <int D>
struct Share {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim");
  static constexpr int CHUNKS = D / 8;
  static constexpr int RSTEP = THREADS / CHUNKS;
  static_assert(RSTEP % 8 == 0, "the swizzle must repeat every RSTEP rows");
};

// `src` is row r0's chunk in device memory; rows at or past `rows_left` are
// zeros (their copies read nothing, from the valid `fallback`). VEC: 16-byte
// cp.async copies (base and strides 16-byte aligned); else element-wise
// loads, for any alignment.
template <int D, int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          int64_t stride, int rows_left,
                                          const __nv_bfloat16* fallback) {
  constexpr int RSTEP = Share<D>::RSTEP;
  static_assert(ROWS % RSTEP == 0, "tile rows");
  // At D=128, opaque to the compiler, so that it recomputes the rows'
  // offsets here instead of keeping all of them in registers across the
  // key loop (ptxas spilled otherwise; at D=64 keeping them is faster).
  int64_t rstep = RSTEP * stride;
  if constexpr (D > 64) asm volatile("" : "+l"(rstep));
#pragma unroll
  for (int it = 0; it < ROWS / RSTEP; ++it) {
    const bool ok = it * RSTEP < rows_left;
    const __nv_bfloat16* from = src + it * rstep;
    const uint32_t to = dst + it * RSTEP * D * 2;
    if constexpr (VEC) {
      cp_async16(to, ok ? from : fallback, ok ? 16 : 0);
    } else {
      uint16_t e[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (ok) {
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(from);
#pragma unroll
        for (int x = 0; x < 8; ++x) e[x] = s16[x];
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(to),
                   "r"(e[0] | (uint32_t)e[1] << 16), "r"(e[2] | (uint32_t)e[3] << 16),
                   "r"(e[4] | (uint32_t)e[5] << 16), "r"(e[6] | (uint32_t)e[7] << 16)
                   : "memory");
    }
  }
}

template <int D, bool VEC>
__global__ void __launch_bounds__(THREADS) flash_fwd_bf16_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  constexpr int KV_TILE = KN * D * 2;  // bytes of one K or V tile
  constexpr int DK = D / 16;   // 16-deep steps of Q K^T
  constexpr int NS = KN / 8;   // 8-key column blocks of S
  constexpr int KP = KN / 16;  // 16-key steps of P V
  constexpr int NO = D / 8;    // 8-wide column blocks of O
  using bf16 = __nv_bfloat16;

  const uint32_t sq = static_cast<uint32_t>(__cvta_generic_to_shared(smem_tc));
  const uint32_t sk = sq + BM * D * 2;        // STAGES K tiles
  const uint32_t sv = sk + STAGES * KV_TILE;  // STAGES V tiles

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // the mma fragments' row and column pair
  // Which (q tile, head, batch) this block takes. Blocks are dispatched in
  // order of blockIdx.x, first one to each SM, and a causal q tile near the
  // end loops over the most keys. The first sms blocks take the heaviest
  // tiles and the rest the lightest first, so the block that shares an SM
  // with a heavy one is a light one and the SMs' loads even out.
  const int n_qt = (p.S + BM - 1) / BM;
  const int n_blocks = gridDim.x;  // n_qt x heads x batches
  int rank = blockIdx.x;           // by weight: 0 is a heaviest q tile
  if (rank >= p.sms) rank = n_blocks - 1 - (rank - p.sms);
  const int hb = n_blocks / n_qt, by_weight = rank / hb, h = rank % hb % p.H, b = rank % hb / p.H;
  const int qt = p.causal ? n_qt - 1 - by_weight : by_weight;
  const int q0 = qt * BM;
  const int kh = h / (p.H / p.KV);

  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.sqb + h * p.sqh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.skb + kh * p.skh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.svb + kh * p.svh;
  bf16* op = static_cast<bf16*>(p.o) + b * p.sob + h * p.soh;

  // Causal: key tiles that start past this q tile's last row are skipped.
  const int kv_end = p.causal ? min(p.T, q0 + BM) : p.T;
  const int n_tiles = (kv_end + KN - 1) / KN;

  // This thread's share of every tile (see Share): row r0, chunk c.
  const int r0 = tid / Share<D>::CHUNKS, c = tid % Share<D>::CHUNKS;
  const uint32_t share = swz<D>(r0, c);
  const bf16* kthr = kp + r0 * p.sks + c * 8;
  const bf16* vthr = vp + r0 * p.svs + c * 8;
  // Key tile t into its ring slot: one commit group for K, one for V. A
  // group past the last tile is empty, which keeps the count the waits
  // rely on.
  auto load_kv = [&](int t) {
    const uint32_t slot = (t % STAGES) * KV_TILE + share;
    const int rows_left = p.T - t * KN - r0;
    if (t < n_tiles)
      load_tile<D, KN, VEC>(sk + slot, kthr + (int64_t)t * KN * p.sks, p.sks, rows_left, kp);
    cp_async_commit();
    if (t < n_tiles)
      load_tile<D, KN, VEC>(sv + slot, vthr + (int64_t)t * KN * p.svs, p.svs, rows_left, vp);
    cp_async_commit();
  };

  // S = Q K^T for this warp's 16 rows and key tile t. Each 16-deep step
  // loads all its K fragments before its products, so the loads' latency
  // is paid once per step, not once per product. At D=64 the warp's Q
  // fragments stay in registers (16 of them; 4 and 8 at D=16 and 32); at D=128 they are read from
  // the Q tile in shared memory at each step instead, which frees the 32
  // registers that the next tile's S needs (ptxas spilled otherwise).
  constexpr bool Q_IN_REGS = D <= 64;
  auto q_frag = [&](uint32_t (&a)[4], int kk) {
    ldmatrix_x4(a, sq + swz<D>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
  };
  uint32_t qf[Q_IN_REGS ? DK : 1][4];
  auto qk = [&](float (&s)[NS][4], int t) {
    const uint32_t kt = sk + (t % STAGES) * KV_TILE;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t qa[4], kb[NS / 2][4];  // Q's A fragment; B fragments of key blocks 2i, 2i + 1
      if constexpr (!Q_IN_REGS) q_frag(qa, kk);
#pragma unroll
      for (int i = 0; i < NS / 2; ++i)
        ldmatrix_x4(kb[i], kt + swz<D>(i * 16 + (lane & 7) + ((lane >> 4) << 3),
                                       kk * 2 + ((lane >> 3) & 1)));
      const uint32_t(&a)[4] = Q_IN_REGS ? qf[Q_IN_REGS ? kk : 0] : qa;
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) {
        mma_bf16(s[2 * i], a, kb[i][0], kb[i][1]);
        mma_bf16(s[2 * i + 1], a, kb[i][2], kb[i][3]);
      }
    }
  };

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // rows g and g + 8 of this warp, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  const float scale_log2 = p.scale * 1.4426950408889634f;
  const int row_g = q0 + warp * 16 + g;

  // One step: softmax and P V of tile j, with the products Q K^T of tile
  // j + 1 issued first, so the tensor cores work on them while the same
  // warp does tile j's exponentials.
  float s[NS][4];
  auto step = [&](int j, auto has_next) {
    cp_async_wait<1>();  // this thread's K tile j + 1 and V tile j copies have landed
    __syncthreads();     // everyone's; and tile j - 1's slot is no longer read
    load_kv(j + 2);

    // Mask only where the tile crosses the diagonal or the key end.
    // s[n][e] is row row_g + 8 * (e >> 1), key k0 + 8n + 2 * t4 + (e & 1).
    const int k0 = j * KN;
    if (k0 + KN > p.T || (p.causal && k0 + KN - 1 > q0)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + 2 * t4 + (e & 1);
          const bool out = col >= p.T || (p.causal && col > row_g + 8 * (e >> 1));
          s[n][e] = out ? NEG_INF : s[n][e];
        }
    }

    float s_next[NS][4];
    if constexpr (decltype(has_next)::value) qk(s_next, j + 1);

    // Online softmax in log2 units (the scale and log2 e folded into one
    // FMA per score); the 4 lanes of a quad hold one row's KN scores.
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      const float alpha = exp2_approx(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    // P = exp2(S scale log2 e - m), rounded to bf16 in the A layout of
    // m16n8k16: key step kk is S's key blocks 2kk (a0, a1) and 2kk + 1
    // (a2, a3). A masked score gives exactly 0.
    uint32_t pf[KP][4];
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* sb = s[2 * kk + half];
        const float p0 = exp2_approx(fmaf(sb[0], scale_log2, -m[0]));
        const float p1 = exp2_approx(fmaf(sb[1], scale_log2, -m[0]));
        const float p2 = exp2_approx(fmaf(sb[2], scale_log2, -m[1]));
        const float p3 = exp2_approx(fmaf(sb[3], scale_log2, -m[1]));
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pf[kk][2 * half] = pack_bf16(p0, p1);
        pf[kk][2 * half + 1] = pack_bf16(p2, p3);
      }
    }

    // O += P V, V fragments loaded four at a time (eight would spill at
    // D=128); D=16 and D=32 have only one and two pairs of output blocks.
    constexpr int VB = NO / 2 < 4 ? NO / 2 : 4;
    const uint32_t vt = sv + (j % STAGES) * KV_TILE;
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
#pragma unroll
      for (int i0 = 0; i0 < NO / 2; i0 += VB) {
        uint32_t vb[VB][4];  // B fragments of output blocks 2i and 2i + 1
#pragma unroll
        for (int i = 0; i < VB; ++i)
          ldmatrix_x4_trans(vb[i], vt + swz<D>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                               2 * (i0 + i) + (lane >> 4)));
#pragma unroll
        for (int i = 0; i < VB; ++i) {
          mma_bf16(o[2 * (i0 + i)], pf[kk], vb[i][0], vb[i][1]);
          mma_bf16(o[2 * (i0 + i) + 1], pf[kk], vb[i][2], vb[i][3]);
        }
      }
    }

    if constexpr (decltype(has_next)::value) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = s_next[n][e];
    }
  };

  // Q rides in the first commit group with K tile 0; V 0, K 1 and V 1 follow.
  load_tile<D, BM, VEC>(sq + share, qp + (int64_t)(q0 + r0) * p.sqs + c * 8, p.sqs,
                        p.S - q0 - r0, qp);
  load_kv(0);
  load_kv(1);
  cp_async_wait<3>();  // this thread's Q and K tile 0 copies have landed
  __syncthreads();
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) q_frag(qf[kk], kk);
  }
  qk(s, 0);
  for (int j = 0; j + 1 < n_tiles; ++j) step(j, std::true_type{});
  step(n_tiles - 1, std::false_type{});
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row_g + 8 * r;
    if (row >= p.S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* dst = op + row * p.sos + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

// The SM count of each device, read once (0: not read yet).
constexpr int MAX_DEVICES = 64;
int sm_count[MAX_DEVICES];

// Opts one instantiation in to its shared memory, once per device.
template <int D, bool VEC>
cudaError_t set_smem(int dev) {
  static bool done[MAX_DEVICES];
  if (done[dev]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes<D>());
  done[dev] = err == cudaSuccess;
  return err;
}

template <int D>
cudaError_t launch_bf16(Params p, int B, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  const bool vec =
      ((reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
        reinterpret_cast<uintptr_t>(p.v)) & 15) == 0 &&
      ((p.sqb | p.sqs | p.sqh | p.skb | p.sks | p.skh | p.svb | p.svs | p.svh) & 7) == 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  p.sms = sm_count[dev];
  err = vec ? set_smem<D, true>(dev) : set_smem<D, false>(dev);
  if (err != cudaSuccess) return err;
  void (*kernel)(Params) = vec ? &flash_fwd_bf16_kernel<D, true> : &flash_fwd_bf16_kernel<D, false>;
  const unsigned blocks = (unsigned)((p.S + BM - 1) / BM) * p.H * B;
  kernel<<<blocks, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel (float32 only)
// ---------------------------------------------------------------------------

namespace cc {

constexpr int BN = 64;        // keys per K/V tile
constexpr int THREADS = 256;  // 16 x 16 threads

template <int D>
constexpr size_t smem_bytes() {
  // Qs [BM][D+1], Ks [BN][D+1], Vs [BN][D], Ps [BM][BN+1], all float32.
  return sizeof(float) * (BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32_kernel(Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * (D + 1);
  float* Vs = Ks + BN * (D + 1);
  float* Ps = Vs + BN * D;

  constexpr int RM = BM / 16;  // rows per thread
  constexpr int RN = BN / 16;  // score columns per thread
  constexpr int RD = D / 16;   // output dims per thread

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (p.H / p.KV);

  const float* qp = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* kp = static_cast<const float*>(p.k) + b * p.skb + kh * p.skh;
  const float* vp = static_cast<const float*>(p.v) + b * p.svb + kh * p.svh;
  float* op = static_cast<float*>(p.o) + b * p.sob + h * p.soh;

  // The Q tile, once. Rows past S read as zero and are never stored.
  for (int i = tid; i < BM * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    Qs[r * (D + 1) + d] = row < p.S ? qp[row * p.sqs + d] : 0.f;
  }

  float m_i[RM], l_i[RM], acc[RM][RD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[i][c] = 0.f;
  }

  // Causal: key tiles that start past this q tile's last row are skipped.
  const int kv_end = p.causal ? min(p.T, q0 + BM) : p.T;
  const int n_tiles = (kv_end + BN - 1) / BN;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BN;
    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are finished
    for (int i = tid; i < BN * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int col = k0 + r;
      const bool ok = col < p.T;
      Ks[r * (D + 1) + d] = ok ? kp[col * p.sks + d] : 0.f;
      Vs[r * D + d] = ok ? vp[col * p.svs + d] : 0.f;
    }
    __syncthreads();

    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.f;

#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RM], kv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < RN; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if ((p.causal && row < col) || col >= p.T) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // The 16 lanes holding this row are one half-warp.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float e = expf(s[i][j] - m_new);
        Ps[r * (BN + 1) + tx + 16 * j] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = alpha * l_i[i] + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < RD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // the whole P tile is in shared memory

#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = Ps[(ty + 16 * i) * (BN + 1) + n];
#pragma unroll
      for (int c = 0; c < RD; ++c) {
        const float vv = Vs[n * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.S) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < RD; ++c)
      op[row * p.sos + tx + 16 * c] = acc[i][c] / l;
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + BM - 1) / BM, p.H, B);
  flash_fwd_f32_kernel<D><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace cc

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). dtype: 0 float32
// (the CUDA-core kernel), 1 bfloat16 (the tensor-core kernel). Strides are
// in elements.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T, int H, int KV, int D,
                        int64_t sqb, int64_t sqs, int64_t sqh,
                        int64_t skb, int64_t sks, int64_t skh,
                        int64_t svb, int64_t svs, int64_t svh,
                        int64_t sob, int64_t sos, int64_t soh,
                        int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.sqb = sqb; p.sqs = sqs; p.sqh = sqh;
  p.skb = skb; p.sks = sks; p.skh = skh;
  p.svb = svb; p.svs = svs; p.svh = svh;
  p.sob = sob; p.sos = sos; p.soh = soh;
  p.S = S; p.T = T; p.H = H; p.KV = KV;
  p.scale = (float)(1.0 / sqrt((double)D));
  p.causal = causal;
  p.sms = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 16) return (int)cc::launch_f32<16>(p, B, st);
  if (dtype == 0 && D == 32) return (int)cc::launch_f32<32>(p, B, st);
  if (dtype == 0 && D == 64) return (int)cc::launch_f32<64>(p, B, st);
  if (dtype == 0 && D == 128) return (int)cc::launch_f32<128>(p, B, st);
  if (dtype == 1 && D == 16) return (int)tc::launch_bf16<16>(p, B, st);
  if (dtype == 1 && D == 32) return (int)tc::launch_bf16<32>(p, B, st);
  if (dtype == 1 && D == 64) return (int)tc::launch_bf16<64>(p, B, st);
  if (dtype == 1 && D == 128) return (int)tc::launch_bf16<128>(p, B, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
