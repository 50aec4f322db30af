// Flash attention (forward) for Hopper, written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_bhsd`
// in repro/kernels/flash_attention.py (and the layout transposes of its
// model-layout wrapper `flash_attention` in repro/kernels/ops.py).
//
// Computes, per (batch, head), softmax(Q K^T scale) V (scale 1/sqrt(D) unless
// the caller gives one, as granite-4.0-h's 1/128) with the Pallas
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
// float32 design (namespace tf): the same skeleton on the tensor cores in
// 3xTF32. Each float32 operand is split x = hi + lo (hi = x rounded to TF32)
// as it is read, and every product is hi.hi + hi.lo + lo.hi summed in f32
// on mma.sync m16n8k8 (tf32.cuh): about float32 accuracy, where one TF32
// product would miss the 1e-4 the kernel is held to (the numpy model in
// tests/test_torch_f32_kernel_design.py shows both). What bounds it: at
// whisper's encoder (S = T = 1500, 12 heads of 64, non-causal) 6.9 GFLOP,
// 42 us as 3xTF32 at 495 TFLOP/s against 103 us on the CUDA cores; at the
// serving prompts, as in bf16, latency. Against bf16 the f32 design differs
// in three places. (1) No ldmatrix takes 32-bit elements transposed, so
// operands are float2 shared-memory reads, and rows are padded (Q and K to
// D + 8 floats, V to D + 4) so that a warp's reads hit 32 banks. (2) The
// A fragment of m16n8k8 wants columns t and t + 4 where S's accumulator
// holds 2t and 2t + 1: the k index of P V stands for keys 2t and 2t + 1
// instead (V read to match), so P feeds P V from registers without a
// shuffle. (3) Tiles take twice the bytes: the ring has two slots, and a
// tile 64 keys (32 at D = 128), which keeps two CTAs on an SM (87 KB at
// D = 64, 101 KB at D = 128). Operands are split in registers, by each
// warp, not once per tile into hi and lo planes in shared memory: planes
// would double the shared-memory reads per product, the scarcer of the
// two (a tile's products read K and V once per warp, and the reads already
// take about as long as the tensor cores do). Inputs whose base address or
// strides are not multiples of 16 bytes take the same kernel with
// element-wise loads in place of cp.async. There is no path from a bf16
// call to it, or from an f32 call to the bf16 kernel: dtype picks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32.cuh"

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
  int sms;  // the card's SMs (the kernels' block order)
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

// The current device and its SM count (the kernels' block order).
cudaError_t device_sms(int* dev, int* sms) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sm_count[*dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[*dev], cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
  }
  *sms = sm_count[*dev];
  return cudaSuccess;
}

// Opts `kernel` in to `bytes` of shared memory, once per device (`done`:
// the kernel's own flags).
cudaError_t set_smem(void (*kernel)(Params), size_t bytes, bool (&done)[MAX_DEVICES], int dev) {
  if (done[dev]) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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
  cudaError_t err = device_sms(&dev, &p.sms);
  if (err != cudaSuccess) return err;
  static bool done[2][MAX_DEVICES];  // by VEC
  void (*kernel)(Params) = vec ? &flash_fwd_bf16_kernel<D, true> : &flash_fwd_bf16_kernel<D, false>;
  err = set_smem(kernel, bytes, done[vec], dev);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((p.S + BM - 1) / BM) * p.H * B;
  kernel<<<blocks, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: tensor cores in 3xTF32, cp.async ring, P in registers
// ---------------------------------------------------------------------------

namespace tf {

constexpr int THREADS = tc::THREADS;  // 4 warps, 16 query rows each: BM = 64
constexpr int STAGES = 2;             // ring slots: tile j (read), tile j + 1 (loading)

// Tile geometry in float32. Rows are padded so that each warp's fragment
// reads hit 32 different banks (tests/test_torch_f32_kernel_design.py):
// Q and K are read as float2 at row g, column 2t of a k-step (a half-warp's
// 16 lanes at 8 g + 2 t mod 32: a row of D + 8 floats); V as float2 at row
// 2t, column 2g (8 t + 2 g mod 32: D + 4). At D = 128 a tile holds 32 keys,
// so that Q and the two-slot ring (101 KB) leave room for two CTAs an SM;
// at D <= 64 it holds 64 (87 KB at D = 64).
template <int D>
struct F32 {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim");
  static constexpr int KN = D > 64 ? 32 : 64;  // keys per K/V tile
  static constexpr int LDK = D + 8;            // floats per Q and K row
  static constexpr int LDV = D + 4;            // floats per V row
  static constexpr int CHUNKS = D / 4;         // 16-byte chunks per row
  static constexpr int RSTEP = THREADS / CHUNKS;  // rows one pass of the copies covers
  static constexpr int Q_FLOATS = BM * LDK;
  static constexpr int K_FLOATS = KN * LDK;
  static constexpr int V_FLOATS = KN * LDV;
  static constexpr size_t SMEM_BYTES =
      sizeof(float) * (Q_FLOATS + STAGES * (K_FLOATS + V_FLOATS));
  static_assert(KN % RSTEP == 0 && BM % RSTEP == 0, "tile rows");
};

// A thread's share of a [ROWS][D] float32 tile of row stride LD (floats):
// 16-byte chunk c = tid % CHUNKS of rows r0 + it * RSTEP, r0 = tid / CHUNKS.
// `dst` and `src` point at row r0's chunk; rows at or past `rows_left` are
// zeros (their copies read nothing, from the valid `fallback`). VEC: 16-byte
// cp.async copies (base and strides 16-byte aligned); else element-wise
// loads, for any alignment.
template <int D, int LD, int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(uint32_t dst, const float* src, int64_t stride,
                                          int rows_left, const float* fallback) {
  constexpr int RSTEP = F32<D>::RSTEP;
#pragma unroll
  for (int it = 0; it < ROWS / RSTEP; ++it) {
    const bool ok = it * RSTEP < rows_left;
    const float* from = src + it * RSTEP * stride;
    const uint32_t to = dst + it * RSTEP * LD * 4;
    if constexpr (VEC) {
      tc::cp_async16(to, ok ? from : fallback, ok ? 16 : 0);
    } else {
      float e[4] = {0.f, 0.f, 0.f, 0.f};
      if (ok) {
#pragma unroll
        for (int x = 0; x < 4; ++x) e[x] = from[x];
      }
      asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(to), "f"(e[0]),
                   "f"(e[1]), "f"(e[2]), "f"(e[3]) : "memory");
    }
  }
}

// The float32 kernel. Its skeleton is the bf16 kernel's: one CTA of 4 warps
// per (64-row q tile, head, batch), heaviest q tiles first; K/V tiles by
// cp.async into a ring; S, the online softmax and O in f32 registers; the
// mask only on tiles that cross the diagonal or the key end. The products
// are mma.sync m16n8k8 in 3xTF32 (tf32.cuh), every operand split in
// registers as it is read.
//
// Each mma's k index is free to stand for any of its 8 keys or dims, as long
// as A and B agree (and its n index for any of 8 output dims, as long as the
// store agrees); these choices make every operand a float2 read and P a
// register rename:
//  - Q K^T, d-step kk: k = t is dim 8 kk + 2t and k = t + 4 dim 8 kk + 2t + 1,
//    so a row's pair (a0, a2) and a key's pair (b0, b1) are adjacent floats.
//  - P V, key block j: k = t is key 8 j + 2t and k = t + 4 key 8 j + 2t + 1,
//    the two columns S's accumulator holds in a thread: the A fragment of P
//    is {s0, s2, s1, s3} of S's, no shuffle (the m16n8 accumulator holds
//    columns 2t, 2t + 1, the A fragment columns t, t + 4).
//  - P V, dims 16 m ... 16 m + 15 as the n sides of two mma: n = g is dim
//    16 m + 2g of the first and 16 m + 2g + 1 of the second, so one float2
//    of a V row feeds both, and the thread's four outputs of a row are the
//    adjacent dims 16 m + 4t ... + 3 (one float4 store).
template <int D, bool VEC>
__global__ void __launch_bounds__(THREADS) flash_fwd_3xtf32_kernel(Params p) {
  using L = F32<D>;
  constexpr int KN = L::KN;
  constexpr int NS = KN / 8;  // 8-key blocks of S
  constexpr int DK = D / 8;   // 8-deep steps of Q K^T
  constexpr int NP = D / 16;  // pairs of 8-wide O blocks
  extern __shared__ __align__(16) float smem_f32[];
  const float* Qs = smem_f32;
  const float* Ks = Qs + L::Q_FLOATS;
  const float* Vs = Ks + STAGES * L::K_FLOATS;
  const uint32_t sq = static_cast<uint32_t>(__cvta_generic_to_shared(smem_f32));
  const uint32_t sk = sq + 4 * L::Q_FLOATS;
  const uint32_t sv = sk + 4 * STAGES * L::K_FLOATS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // Which (q tile, head, batch): as the bf16 kernel, heaviest first.
  const int n_qt = (p.S + BM - 1) / BM;
  const int n_blocks = gridDim.x;
  int rank = blockIdx.x;
  if (rank >= p.sms) rank = n_blocks - 1 - (rank - p.sms);
  const int hb = n_blocks / n_qt, by_weight = rank / hb, h = rank % hb % p.H, b = rank % hb / p.H;
  const int qt = p.causal ? n_qt - 1 - by_weight : by_weight;
  const int q0 = qt * BM;
  const int kh = h / (p.H / p.KV);

  const float* qp = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* kp = static_cast<const float*>(p.k) + b * p.skb + kh * p.skh;
  const float* vp = static_cast<const float*>(p.v) + b * p.svb + kh * p.svh;
  float* op = static_cast<float*>(p.o) + b * p.sob + h * p.soh;

  const int kv_end = p.causal ? min(p.T, q0 + BM) : p.T;
  const int n_tiles = (kv_end + KN - 1) / KN;

  const int r0 = tid / L::CHUNKS, c = tid % L::CHUNKS;
  const float* kthr = kp + r0 * p.sks + 4 * c;
  const float* vthr = vp + r0 * p.svs + 4 * c;
  // Key tile t into its slot, K and V in one commit group.
  auto load_kv = [&](int t) {
    if (t >= n_tiles) return;
    const int slot = t % STAGES;
    const int rows_left = p.T - t * KN - r0;
    load_tile<D, L::LDK, KN, VEC>(sk + 4 * (slot * L::K_FLOATS + r0 * L::LDK + 4 * c),
                                  kthr + (int64_t)t * KN * p.sks, p.sks, rows_left, kp);
    load_tile<D, L::LDV, KN, VEC>(sv + 4 * (slot * L::V_FLOATS + r0 * L::LDV + 4 * c),
                                  vthr + (int64_t)t * KN * p.svs, p.svs, rows_left, vp);
    tc::cp_async_commit();
  };

  // Q's A fragment of d-step kk: rows warp * 16 + g and + 8, dims 8 kk + 2t
  // and + 1. At D <= 64 the fragments stay in registers for the whole key
  // loop (raw: split as they are used, which keeps the kernel off 168
  // registers and a spill); at D = 128 they are re-read at each tile,
  // which leaves the registers to O.
  constexpr bool Q_IN_REGS = D <= 64;
  const float* qrow = Qs + (warp * 16 + g) * L::LDK + 2 * t4;
  auto q_frag = [&](float (&a)[4], int kk) {
    const float2 top = *reinterpret_cast<const float2*>(qrow + 8 * kk);
    const float2 bot = *reinterpret_cast<const float2*>(qrow + 8 * L::LDK + 8 * kk);
    a[0] = top.x;
    a[1] = bot.x;
    a[2] = top.y;
    a[3] = bot.y;
  };
  float qf[Q_IN_REGS ? DK : 1][4];

  float o[2 * NP][4];
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // rows g and g + 8 of this warp, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  const float scale_log2 = p.scale * 1.4426950408889634f;
  const int row_g = q0 + warp * 16 + g;

  // Q rides in the first commit group with K/V tile 0.
  load_tile<D, L::LDK, BM, VEC>(sq + 4 * (r0 * L::LDK + 4 * c),
                                qp + (int64_t)(q0 + r0) * p.sqs + 4 * c, p.sqs,
                                p.S - q0 - r0, qp);
  load_kv(0);

  for (int j = 0; j < n_tiles; ++j) {
    tc::cp_async_wait<0>();  // this thread's copies of tile j (and Q) have landed
    __syncthreads();         // everyone's; and tile j - 1's slot is no longer read
    load_kv(j + 1);
    if (Q_IN_REGS && j == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) q_frag(qf[Q_IN_REGS ? kk : 0], kk);
    }
    const float* Kt = Ks + (j % STAGES) * L::K_FLOATS + g * L::LDK + 2 * t4;
    const float* Vt = Vs + (j % STAGES) * L::V_FLOATS + 2 * t4 * L::LDV + 2 * g;

    // S = Q K^T for this warp's 16 rows: s[n] is key block n.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    // Odd d-steps sum into a second set, added at the end: two chains of
    // dependent mma per key block instead of one (at D = 128, 4 key
    // blocks, one chain was 48 mma long; the split measured 1.4x faster
    // there and 1.1x at D = 64).
    float s_odd[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_odd[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      float qa[4];
      if constexpr (!Q_IN_REGS) q_frag(qa, kk);
      uint32_t ahi[4], alo[4];
      split_frag(Q_IN_REGS ? qf[Q_IN_REGS ? kk : 0] : qa, ahi, alo);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float2 kb = *reinterpret_cast<const float2*>(Kt + n * 8 * L::LDK + 8 * kk);
        mma_3xtf32(kk & 1 ? s_odd[n] : s[n], ahi, alo, kb.x, kb.y);
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += s_odd[n][e];

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

    // Online softmax in log2 units; the 4 lanes of a quad hold one row.
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
      const float alpha = tc::exp2_approx(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < 2 * NP; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = tc::exp2_approx(fmaf(s[n][e], scale_log2, -m[e >> 1]));
        l[e >> 1] += s[n][e];
      }
    }

    // O += P V, key block by key block: P's A fragment is {s0, s2, s1, s3}.
#pragma unroll
    for (int kb = 0; kb < NS; ++kb) {
      uint32_t phi[4], plo[4];
      const float a[4] = {s[kb][0], s[kb][2], s[kb][1], s[kb][3]};
      split_frag(a, phi, plo);
#pragma unroll
      for (int mp = 0; mp < NP; ++mp) {
        const float* v = Vt + kb * 8 * L::LDV + 16 * mp;
        const float2 v0 = *reinterpret_cast<const float2*>(v);            // key 8 kb + 2t
        const float2 v1 = *reinterpret_cast<const float2*>(v + L::LDV);   // key 8 kb + 2t + 1
        mma_3xtf32(o[2 * mp], phi, plo, v0.x, v1.x);
        mma_3xtf32(o[2 * mp + 1], phi, plo, v0.y, v1.y);
      }
    }
  }

  // o[2 mp][e] is dim 16 mp + 4 t4 + 2 (e & 1), o[2 mp + 1][e] the dim after
  // it, of row row_g + 8 (e >> 1).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row_g + 8 * r;
    if (row >= p.S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* dst = op + row * p.sos + 4 * t4;
#pragma unroll
    for (int mp = 0; mp < NP; ++mp)
      *reinterpret_cast<float4*>(dst + 16 * mp) =
          make_float4(o[2 * mp][2 * r] * inv, o[2 * mp + 1][2 * r] * inv,
                      o[2 * mp][2 * r + 1] * inv, o[2 * mp + 1][2 * r + 1] * inv);
  }
}

template <int D>
cudaError_t launch_f32(Params p, int B, cudaStream_t stream) {
  // The output is stored as float4: the wrapper's own contiguous tensor.
  if ((reinterpret_cast<uintptr_t>(p.o) & 15) != 0 || ((p.sob | p.sos | p.soh) & 3) != 0)
    return cudaErrorMisalignedAddress;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
        reinterpret_cast<uintptr_t>(p.v)) & 15) == 0 &&
      ((p.sqb | p.sqs | p.sqh | p.skb | p.sks | p.skh | p.svb | p.svs | p.svh) & 3) == 0;
  int dev = 0;
  cudaError_t err = tc::device_sms(&dev, &p.sms);
  if (err != cudaSuccess) return err;
  static bool done[2][tc::MAX_DEVICES];  // by VEC
  void (*kernel)(Params) =
      vec ? &flash_fwd_3xtf32_kernel<D, true> : &flash_fwd_3xtf32_kernel<D, false>;
  err = tc::set_smem(kernel, F32<D>::SMEM_BYTES, done[vec], dev);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((p.S + BM - 1) / BM) * p.H * B;
  kernel<<<blocks, THREADS, F32<D>::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tf

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). dtype: 0 float32
// (the 3xTF32 kernel), 1 bfloat16. Strides are in elements. scale multiplies
// the scores; 0 (or less) is 1/sqrt(D).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T, int H, int KV, int D,
                        int64_t sqb, int64_t sqs, int64_t sqh,
                        int64_t skb, int64_t sks, int64_t skh,
                        int64_t svb, int64_t svs, int64_t svh,
                        int64_t sob, int64_t sos, int64_t soh,
                        int causal, int dtype, float scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.sqb = sqb; p.sqs = sqs; p.sqh = sqh;
  p.skb = skb; p.sks = sks; p.skh = skh;
  p.svb = svb; p.svs = svs; p.svh = svh;
  p.sob = sob; p.sos = sos; p.soh = soh;
  p.S = S; p.T = T; p.H = H; p.KV = KV;
  p.scale = scale > 0.f ? scale : (float)(1.0 / sqrt((double)D));
  p.causal = causal;
  p.sms = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 16) return (int)tf::launch_f32<16>(p, B, st);
  if (dtype == 0 && D == 32) return (int)tf::launch_f32<32>(p, B, st);
  if (dtype == 0 && D == 64) return (int)tf::launch_f32<64>(p, B, st);
  if (dtype == 0 && D == 128) return (int)tf::launch_f32<128>(p, B, st);
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
