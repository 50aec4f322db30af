// Mamba-2 chunked SSD scan (forward) for Hopper, written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_scan_bhsd` in
// repro/kernels/ssd_scan.py (reached through `ssd_scan` in
// repro/kernels/ops.py, which pre-scales xdt = x * dt and da = dt * A).
//
// For each (b, h), with g = h / (H / G), chunks of Q rows, cum the in-chunk
// prefix sum of da and the [P, N] state starting at zero:
//   y[l]  = sum_{s <= l} (C[l] . B[s]) exp(cum[l] - cum[s]) xdt[s]
//           + exp(cum[l]) C[l] . start^T
//   start(next chunk) = start exp(cum[Q-1]) + sum_s exp(cum[Q-1] - cum[s]) xdt[s] (x) B[s]
// xdt, da and y are float32; B and C are float32 or bfloat16.
//
// Design. The TPU kernel carries the state in VMEM across a sequential
// grid axis. Here the scan is split along the decomposition of the plain
// path's `ssd_chunked` (and of the Mamba-2 paper's GPU algorithm, section 6)
// into three kernels, so that only the [P, N] recurrence is serial:
//   1. ssd_chunk_state_kernel, one CTA (a warpgroup) per (chunk but the last,
//      h, b): the chunk's own state (xdt * exp(cum[Q-1] - cum))^T . B, a
//      [P x Q] . [Q x N] product, into a float32 scratch [B, H, nc-1, P, NS]
//      (NS = N rounded up to 4), and exp(cum[Q-1]) beside it.
//   2. ssd_state_pass_kernel, elementwise over (b, h, p, n): turns the chunk
//      states into start states in place, in chunk order.
//   3. ssd_chunk_scan_kernel, one CTA (a warpgroup) per (64-row block, chunk,
//      group, b, block of up to 8 heads of the group), the longest row blocks
//      launched first: C . B^T for its rows once, kept in shared memory, then
//      for each head exp(cum) * (C . start^T) + (C.B^T o L) . xdt, y written
//      once.
// With one chunk there is no incoming state and stages 1 and 2 do not run.
// Prefix sums of da are warp-shuffle scans in float64, kept as float pairs
// (hi + lo), so cum[l] - cum[s] is accurate to float32 rounding of the
// difference itself, not of cum. Off the diagonal the decay exp(cum[l] -
// cum[s]) is exp(cum[l] - cum[s | 7]) exp(cum[s | 7] - cum[s]): one exp a
// row per 8 columns, and a per-column factor; as da <= 0 both factors are at
// most 1 for any dt, so neither overflows. On the diagonal's 8-column steps
// (where l < s | 7 can be) it is formed directly.
//
// Arithmetic. Every product runs on the tensor cores. A float32 operand is
// split x = hi + lo, hi = x rounded to TF32 and lo = x - hi, and a product is
// hi.hi + hi.lo + lo.hi accumulated in float32 (3xTF32, about float32
// accuracy; a single TF32 product keeps ~3 decimal digits, too few for the
// 1e-4 the plain path is held to). bfloat16 values are exact in TF32, so the
// state update with bf16 B takes two passes, and C . B^T with bf16 B and C
// is one bf16 mma.sync (m16n8k16) whose products are exact in the float32
// accumulator; with float32 B and C it is 3xTF32 mma.sync (m16n8k8). The
// other products are wgmma (tf32): stage 1's m64n128k8 with both operands in
// shared memory, stage 3's m64n64k8 with the scores or exp(cum) o C as A in
// registers. A wgmma operand in shared memory is K-major (TF32 has no
// transposed form), so xdt and B are transposed as they are stored, in
// 128-byte-swizzled 8-row atoms. Only wgmma writes stage 3's accumulators
// (the first of a head starts them afresh): a write by other instructions
// makes the compiler serialize the wgmmas.
//
// Memory. Operands move in slabs of 32 rows (k values) and are split into
// hi and lo planes as they are stored to shared memory. Stage 1's slabs
// arrive by cp.async into a ring of raw slots ahead of use; stage 3's go
// through registers, the next slab's loads issued before the current one is
// computed. Ragged chunks, chunk < 16, P < 64 and N < 128 are zero-filled in
// the loads and masked at the stores; any strides with a contiguous last
// dimension are taken (16-byte loads where the addresses allow, element-wise
// loads elsewhere), so the model layout needs no transpose.
//
// What bounds it: operations. At B=2, S=4096, H=80, P=64, N=128, Q=256 the
// least work is ~31 GFLOP against ~342 MB of inputs and output; in 3xTF32
// (two passes for the state update with bf16 B) at 495 TFLOP/s of dense TF32
// the floor is ~0.17 ms (bf16 B/C; ~0.19 ms float32), against ~0.10 ms for
// the bytes. The scratch adds ~0.33 GB of traffic (stage 1 writes it, stage 2
// reads and rewrites it, stage 3 reads it). Measured, every stage runs far
// from both floors: a slab costs about the same whatever it holds, so the
// time goes to each CTA's chain of slab steps, not to the tensor cores or
// the bytes (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

constexpr int THREADS = 128;   // stages 1 and 3: one warpgroup
constexpr int PMAX = 64;       // head dim P, at most
constexpr int NMAX = 128;      // state dim N, at most
constexpr int QMAX = 256;      // chunk Q, at most
constexpr int RB = 64;         // stage 3: rows per CTA, 16 per warp
constexpr int HB_MAX = 8;      // stage 3: heads per CTA, at most
constexpr int C16_LD = 136;    // bf16 [row][n] tiles (68 words a row, 4 mod 32)
constexpr int C32_LD = 132;    // float [row][n] tiles (4 mod 32)

struct Params {
  const float* xdt;  // [B, H, S, P]
  const float* da;   // [B, H, S] (stride sas along S)
  const void* b;     // [B, G, S, N]
  const void* c;     // [B, G, S, N]
  float* y;          // [B, H, S, P]
  float* states;     // [B, H, nc-1, P, NS] scratch
  float* decay;      // [B, H, nc-1] scratch
  int B, H, G, S, P, N, Q, NS, nc;
  int hb, nhbg, nrb;        // stage 3: heads per CTA, head blocks per group, row blocks
  int cb_floats;            // stage 3: shared memory for C.B^T, in floats
  int64_t sxb, sxh, sxs;    // element strides; each last dimension is contiguous
  int64_t sab, sah, sas;
  int64_t sbb, sbg, sbs;
  int64_t scb, scg, scs;
  int64_t syb, syh, sys;
  // Every input 16-byte addressable with P and N whole 16-byte vectors, y
  // 8-byte addressable: vector loads (stage 1's by cp.async) and 8-byte
  // stores of y; otherwise element-wise loads and stores throughout.
  bool vec;
};

// ---------------------------------------------------------------------------
// Tensor-core and conversion helpers
// ---------------------------------------------------------------------------

// split, fbits and mma_tf32 (m16n8k8) are in tf32.cuh.

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {  // 2^x, ~2 ulp
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr double LOG2E = 1.4426950408889634;

// bfloat16 bits to float (exact).
__device__ __forceinline__ float bf16_to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

template <typename T> struct Raw;
template <> struct Raw<float> { using type = uint32_t; };
template <> struct Raw<__nv_bfloat16> { using type = uint16_t; };

// 16 bytes of row r, columns c .. c + 16/sizeof(T) - 1 of a row-major source
// (row stride `stride` elements); rows >= vrows and columns >= vcols read as 0.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* src, int64_t stride, int r, int c, int vrows,
                                        int vcols, bool vec) {
  using R = typename Raw<T>::type;
  constexpr int V = 16 / sizeof(T);
  if (r >= vrows || c >= vcols) return make_uint4(0u, 0u, 0u, 0u);
  const R* p = reinterpret_cast<const R*>(src) + r * stride + c;
  if (vec && c + V <= vcols) return __ldg(reinterpret_cast<const uint4*>(p));
  R tmp[V];
#pragma unroll
  for (int i = 0; i < V; ++i) tmp[i] = (c + i < vcols) ? p[i] : R(0);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (V == 4)
      w[i] = tmp[i];
    else
      w[i] = static_cast<uint32_t>(tmp[2 * i]) | (static_cast<uint32_t>(tmp[2 * i + 1]) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float4 as_f4(uint4 v) {
  return make_float4(__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                     __uint_as_float(v.w));
}

// A plane holds B[k][n] (32 k) K-major as wgmma reads it with the 128-byte
// swizzle: row n (128 bytes) at byte (n / 8) * 1024 + (n % 8) * 128, its
// 16-byte chunk c (k = 4c .. 4c + 3) at chunk c ^ (n % 8). Offset in floats.
__device__ __forceinline__ int sw_off(int n, int c) {
  return ((n >> 3) << 8) + ((n & 7) << 5) + ((c ^ (n & 7)) << 2);
}

__device__ __forceinline__ void put_split(float* hi, float* lo, int off, float4 v) {
  float4 h, l;
  split(v.x, h.x, l.x);
  split(v.y, h.y, l.y);
  split(v.z, h.z, l.z);
  split(v.w, h.w, l.w);
  *reinterpret_cast<float4*>(hi + off) = h;
  *reinterpret_cast<float4*>(lo + off) = l;
}

// wgmma shared-memory descriptor of a 128-byte-swizzled K-major tile: 8-row
// atoms 1024 bytes apart (the leading offset is unused with this swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(1024 >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma that writes them.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Stores by threads become visible to wgmma's (async proxy) reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes global -> shared without registers; bytes = 0 writes zeros.
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

// d[64 x 64] (+)= A[64 x 8] B[8 x 64], tf32 in, float32 sums; A from registers
// (each warp its 16 rows, the mma.m16n8k8 A layout), B K-major in shared
// memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}


// d[64 x 128] += A[64 x 8] B[8 x 128], tf32 in, float32 sums; A and B both
// K-major in shared memory.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// In-chunk prefix sum of da over a warpgroup, in float64: thread t owns R
// consecutive rows (rows >= q read as 0, so they repeat cum[q - 1]); a warp
// scan of the threads' totals, then the warps'. Two halves around a
// __syncthreads(): warp_part writes the warp totals, finish reads them.
// ---------------------------------------------------------------------------

struct ChunkScan {
  // Thread t owns rows R t .. R t + R - 1; `tot` holds one double a warp.
  static constexpr int R = QMAX / THREADS;
  double run[R];                       // inclusive sums over the thread's own rows
  double inc;                          // inclusive warp scan of the thread totals

  // da of the chunk's rows (0 past q), into registers ahead of use.
  __device__ __forceinline__ static void load(const Params& p, const float* da, int q,
                                              float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = R * threadIdx.x + i;
      d[i] = r < q ? da[r * p.sas] : 0.f;
    }
  }

  // First half: writes the warp totals to `tot`.
  __device__ __forceinline__ void warp_part(const float (&d)[R], double* tot) {
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < R; ++i) run[i] = s += static_cast<double>(d[i]);
    const int lane = threadIdx.x & 31;
    inc = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    if (lane == 31) tot[threadIdx.x >> 5] = inc;
  }

  // Second half, after a __syncthreads(): cum of the thread's rows; returns
  // the chunk's total.
  __device__ __forceinline__ double finish(const double* tot, double (&cum)[R]) const {
    const int warp = threadIdx.x >> 5;
    double before = 0.0, total = 0.0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      const double t = tot[w];
      if (w < warp) before += t;
      total += t;
    }
    const double excl = before + inc - run[R - 1];
#pragma unroll
    for (int i = 0; i < R; ++i) cum[i] = excl + run[i];
    return total;
  }
};

// ---------------------------------------------------------------------------
// Stage 1: each chunk's own state, (xdt w)^T . B, [P x Q] . [Q x N]
// ---------------------------------------------------------------------------

// The warpgroup computes a chunk's whole 64 x 128 state as wgmma m64n128k8,
// both operands K-major in shared memory (rows p of x w, rows n of B; 32 s
// a slab). Slabs arrive by 16-byte cp.async, whole rows a warp, into a ring
// of raw slots two (float32: one) slabs ahead of the one being split into
// the planes; inputs cp.async cannot take (unaligned, or P, N off a 16-byte
// multiple) go through registers into the same slots.
template <typename T>
struct Stage1Cfg {
  static constexpr bool BF = sizeof(T) == 2;
  static constexpr int XPL = PMAX * 32;        // floats: an x w plane, 64 rows of 32 s
  static constexpr int BPL = NMAX * 32;        // floats: a B plane, 128 rows of 32 s
  static constexpr int BPLANES = BF ? 1 : 2;   // bf16 B is exact in TF32: no lo plane
  static constexpr int XCH = PMAX / 4;         // 16-byte chunks in a raw xdt row
  static constexpr int BCH = NMAX * (int)sizeof(T) / 16;  // ... in a raw B row
  static constexpr int RAW = 32 * (XCH + BCH) * 4;         // floats: one raw slot
  static constexpr int RS = BF ? 3 : 2;        // raw slots
  static constexpr size_t SMEM = 1024 + sizeof(float) * (2 * XPL + BPLANES * BPL + RS * RAW + QMAX) +
                                 sizeof(double) * (THREADS / 32);
};

// Raw slot rows keep their 16-byte chunks XOR-swizzled by row / 4, so that
// eight threads reading one chunk of rows 4 cq + e (cq = 0 .. 7) hit eight
// bank groups. Offset in floats of chunk c of row r, rows of `ch` chunks.
__device__ __forceinline__ int raw_off(int r, int c, int ch) {
  return r * ch * 4 + ((c ^ ((r >> 2) & 7)) << 2);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_chunk_state_kernel(Params p) {
  using Cfg = Stage1Cfg<T>;
  using Scan = ChunkScan;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  float* xw_hi = reinterpret_cast<float*>(smem_raw + ((1024 - (raw_addr & 1023)) & 1023));
  float* xw_lo = xw_hi + Cfg::XPL;
  float* b_hi = xw_lo + Cfg::XPL;
  float* b_lo = b_hi + Cfg::BPL;               // float32 B only
  float* ring = b_hi + Cfg::BPLANES * Cfg::BPL;  // RS raw slots: xdt [32][XCH], B [32][BCH] chunks
  float* wts = ring + Cfg::RS * Cfg::RAW;      // [QMAX] exp(cum[q-1] - cum)
  double* tot = reinterpret_cast<double*>(wts + QMAX);
  const uint32_t xh_addr = static_cast<uint32_t>(__cvta_generic_to_shared(xw_hi));
  const uint32_t xl_addr = xh_addr + Cfg::XPL * 4;
  const uint32_t bh_addr = xl_addr + Cfg::XPL * 4;
  const uint32_t bl_addr = bh_addr + Cfg::BPL * 4;
  const uint32_t ring_addr = static_cast<uint32_t>(__cvta_generic_to_shared(ring));

  const int c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  const int cq = tid & 7, mq = tid >> 3;  // slab quad: 16-byte chunk (4 s), column group
  const int q = p.Q;  // every chunk but the last is whole
  const int nslab = (q + 31) / 32;
  const int64_t row0 = (int64_t)c * p.Q;

  const float* xdt = p.xdt + bi * p.sxb + h * p.sxh + row0 * p.sxs;
  const float* da = p.da + bi * p.sab + h * p.sah + row0 * p.sas;
  const T* bm = static_cast<const T*>(p.b) + bi * p.sbb + g * p.sbg + row0 * p.sbs;

  // Slab t into raw slot t % RS: xdt then B, rows past q and columns past P
  // and N zero.
  auto issue = [&](int t) {
    const int s0 = 32 * t;
    float* slot = ring + (t % Cfg::RS) * Cfg::RAW;
    const uint32_t slot_addr = ring_addr + (t % Cfg::RS) * Cfg::RAW * 4;
#pragma unroll
    for (int i = 0; i < 32 * Cfg::XCH / THREADS; ++i) {
      const int v = tid + THREADS * i, r = v / Cfg::XCH, ch = v % Cfg::XCH;
      const int off = raw_off(r, ch, Cfg::XCH);
      if (p.vec) {
        const bool ok = r < q - s0 && 4 * ch < p.P;
        cp_async16(slot_addr + off * 4, ok ? xdt + (s0 + r) * p.sxs + 4 * ch : xdt, ok ? 16 : 0);
      } else {
        *reinterpret_cast<uint4*>(slot + off) =
            load16(xdt + s0 * p.sxs, p.sxs, r, 4 * ch, q - s0, p.P, false);
      }
    }
    constexpr int V = 16 / (int)sizeof(T);
#pragma unroll
    for (int i = 0; i < 32 * Cfg::BCH / THREADS; ++i) {
      const int v = tid + THREADS * i, r = v / Cfg::BCH, ch = v % Cfg::BCH;
      const int off = 32 * Cfg::XCH * 4 + raw_off(r, ch, Cfg::BCH);
      if (p.vec) {
        const bool ok = r < q - s0 && V * ch < p.N;
        cp_async16(slot_addr + off * 4, ok ? bm + (s0 + r) * p.sbs + V * ch : bm, ok ? 16 : 0);
      } else {
        *reinterpret_cast<uint4*>(slot + off) =
            load16(bm + s0 * p.sbs, p.sbs, r, V * ch, q - s0, p.N, false);
      }
    }
  };
#pragma unroll
  for (int t = 0; t < Cfg::RS - 1; ++t) {
    if (t < nslab) issue(t);
    cp_async_commit();
  }

  // cum, then the weights exp(cum[q-1] - cum[s]) and the chunk's decay.
  float d[Scan::R];
  Scan::load(p, da, q, d);
  Scan sc;
  sc.warp_part(d, tot);
  __syncthreads();
  double cum[Scan::R];
  const double total = sc.finish(tot, cum);
#pragma unroll
  for (int i = 0; i < Scan::R; ++i) {
    const int r = Scan::R * tid + i;
    wts[r] = r < q ? expf(static_cast<float>(total - cum[i])) : 0.f;
  }
  if (tid == 0)
    p.decay[((int64_t)bi * p.H + h) * (p.nc - 1) + c] = expf(static_cast<float>(total));

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int t = 0; t < nslab; ++t) {
    const int s0 = 32 * t;
    cp_async_wait<Cfg::RS - 2>();  // this thread's copies of slab t have landed
    __syncthreads();  // every thread's have; the previous slab's wgmmas are done; wts written
    const float* slot = ring + (t % Cfg::RS) * Cfg::RAW;
    {  // x w, transposed to rows p: column 4 mq + j, rows 4 cq .. 4 cq + 3
      float w[4];
      float4 x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w[e] = wts[min(s0 + 4 * cq + e, QMAX - 1)];
        x[e] = *reinterpret_cast<const float4*>(slot + raw_off(4 * cq + e, mq, Cfg::XCH));
      }
      put_split(xw_hi, xw_lo, sw_off(4 * mq + 0, cq),
                make_float4(x[0].x * w[0], x[1].x * w[1], x[2].x * w[2], x[3].x * w[3]));
      put_split(xw_hi, xw_lo, sw_off(4 * mq + 1, cq),
                make_float4(x[0].y * w[0], x[1].y * w[1], x[2].y * w[2], x[3].y * w[3]));
      put_split(xw_hi, xw_lo, sw_off(4 * mq + 2, cq),
                make_float4(x[0].z * w[0], x[1].z * w[1], x[2].z * w[2], x[3].z * w[3]));
      put_split(xw_hi, xw_lo, sw_off(4 * mq + 3, cq),
                make_float4(x[0].w * w[0], x[1].w * w[1], x[2].w * w[2], x[3].w * w[3]));
    }
    const float* braw = slot + 32 * Cfg::XCH * 4;
    if constexpr (Cfg::BF) {  // B, transposed to rows n = 8 mq + j, exact in float32
      uint4 bv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        bv[e] = *reinterpret_cast<const uint4*>(braw + raw_off(4 * cq + e, mq, Cfg::BCH));
      const uint32_t v[4][4] = {{bv[0].x, bv[0].y, bv[0].z, bv[0].w},
                                {bv[1].x, bv[1].y, bv[1].z, bv[1].w},
                                {bv[2].x, bv[2].y, bv[2].z, bv[2].w},
                                {bv[3].x, bv[3].y, bv[3].z, bv[3].w}};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float f[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f[e] = __uint_as_float(j & 1 ? v[e][j >> 1] & 0xffff0000u : v[e][j >> 1] << 16);
        *reinterpret_cast<float4*>(b_hi + sw_off(8 * mq + j, cq)) =
            make_float4(f[0], f[1], f[2], f[3]);
      }
    } else {  // B, transposed to rows n = 4 (mq + 16 i) + j, split
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float4 y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[e] = *reinterpret_cast<const float4*>(braw + raw_off(4 * cq + e, mq + 16 * i, Cfg::BCH));
        const int n = 4 * (mq + 16 * i);
        put_split(b_hi, b_lo, sw_off(n + 0, cq), make_float4(y[0].x, y[1].x, y[2].x, y[3].x));
        put_split(b_hi, b_lo, sw_off(n + 1, cq), make_float4(y[0].y, y[1].y, y[2].y, y[3].y));
        put_split(b_hi, b_lo, sw_off(n + 2, cq), make_float4(y[0].z, y[1].z, y[2].z, y[3].z));
        put_split(b_hi, b_lo, sw_off(n + 3, cq), make_float4(y[0].w, y[1].w, y[2].w, y[3].w));
      }
    }
    fence_async_smem();
    __syncthreads();  // the planes are written; slab t - 1's raw slot is free
    if (t + Cfg::RS - 1 < nslab) issue(t + Cfg::RS - 1);
    cp_async_commit();

    // acc += (x w)^T B over the slab's 32 s: lo.hi terms first; two passes
    // where B is bf16, three where it is float32.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (Cfg::BF) {
        wgmma_n128(acc, sw128_desc(xl_addr + 32 * kk), sw128_desc(bh_addr + 32 * kk));
      } else {
        wgmma_n128(acc, sw128_desc(xh_addr + 32 * kk), sw128_desc(bl_addr + 32 * kk));
        wgmma_n128(acc, sw128_desc(xl_addr + 32 * kk), sw128_desc(bh_addr + 32 * kk));
      }
      wgmma_n128(acc, sw128_desc(xh_addr + 32 * kk), sw128_desc(bh_addr + 32 * kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
  }

  // The state, rows p = 16 warp + gr (+ 8), columns n = 8 j + 2 t4 (+ 1).
  float* out = p.states + (((int64_t)bi * p.H + h) * (p.nc - 1) + c) * (int64_t)p.P * p.NS;
  const int pr0 = warp * 16 + gr;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = 8 * j + 2 * t4;
    if (n < p.NS) {
      if (pr0 < p.P)
        *reinterpret_cast<float2*>(out + pr0 * p.NS + n) = make_float2(acc[4 * j], acc[4 * j + 1]);
      if (pr0 + 8 < p.P)
        *reinterpret_cast<float2*>(out + (pr0 + 8) * p.NS + n) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Stage 2: start states, in place: buf[c] <- buf[c-1] * decay[c] + buf[c],
// so buf[c] holds the state entering chunk c + 1.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256) ssd_state_pass_kernel(Params p) {
  const int h = blockIdx.y, bi = blockIdx.z;
  const int64_t per_chunk4 = (int64_t)p.P * p.NS / 4;
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= per_chunk4) return;
  const int nc1 = p.nc - 1;
  float4* base = reinterpret_cast<float4*>(p.states) +
                 ((int64_t)bi * p.H + h) * nc1 * per_chunk4 + i;
  const float* dec = p.decay + ((int64_t)bi * p.H + h) * nc1;
  float4 carry = base[0];
  for (int c0 = 1; c0 < nc1; c0 += 4) {
    float4 st[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c0 + k < nc1) st[k] = base[(c0 + k) * per_chunk4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k < nc1) {
        const float d = dec[c0 + k];
        carry.x = fmaf(carry.x, d, st[k].x);
        carry.y = fmaf(carry.y, d, st[k].y);
        carry.z = fmaf(carry.z, d, st[k].z);
        carry.w = fmaf(carry.w, d, st[k].w);
        base[(c0 + k) * per_chunk4] = carry;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Stage 3: outputs of one 64-row block of one chunk for a block of heads
// ---------------------------------------------------------------------------

// Two CTAs an SM. C.B^T of the block's rows is mma.sync (bf16 in, or
// 3xTF32), once for all its heads; the two per-head products are wgmma
// m64n64k8 (tf32): the scores or exp(cum) o C as A from registers, xdt or
// the start state as a K-major B in shared memory.

template <typename T>
struct Stage3Cfg {
  static constexpr bool BF = sizeof(T) == 2;
  static constexpr int SB = BF ? 32 : 8;  // B rows a slab of the C.B^T phase
  static constexpr int VB = SB * NMAX * (int)sizeof(T) / 16 / THREADS;  // its vectors a thread
  static constexpr int SK = 32;            // k values (xdt rows, state columns) a slab
  static constexpr int PLANE = PMAX * SK;  // floats: 64 rows of 128 bytes
  static constexpr int C_FLOATS = BF ? RB * C16_LD / 2 : RB * C32_LD;
};

// C.B^T is kept per warp: the 16 rows of warp w and the columns they read,
// at row stride l0 + 16 w + 20 (4 mod 16: conflict-free fragment loads).
__device__ __host__ __forceinline__ int cb_ld(int l0, int w) { return l0 + 16 * w + 20; }
__device__ __host__ __forceinline__ int cb_base(int l0, int w) {
  return 16 * w * (l0 + 8 * (w - 1) + 20);  // 16 x the strides of warps 0 .. w - 1
}

// Shared memory: {hi, lo} planes (1024-byte aligned) | C.B^T | C rows |
// cum_hi, cum_lo, fcol [QMAX] | 4 warp totals.
template <typename T>
constexpr size_t stage3_smem_bytes(int cb_floats) {
  return 1024 + sizeof(float) * (2 * (size_t)Stage3Cfg<T>::PLANE + (size_t)cb_floats +
                                 Stage3Cfg<T>::C_FLOATS + 3 * QMAX) +
         sizeof(double) * 4;
}

// One k-step of a per-head product on the warpgroup: acc += A . B over 8 k,
// in three passes (lo.hi terms first); the first k-step of a head starts acc
// afresh (accumulate = 0). The caller fences before and commits and waits
// after a slab's k-steps.
__device__ __forceinline__ void wgmma3(float (&acc)[32], const uint32_t (&ahi)[4],
                                       const uint32_t (&alo)[4], uint32_t hi_addr,
                                       uint32_t lo_addr, int kk, int accumulate) {
  wgmma_tf32(acc, ahi, sw128_desc(lo_addr + 32 * kk), accumulate);
  wgmma_tf32(acc, alo, sw128_desc(hi_addr + 32 * kk), 1);
  wgmma_tf32(acc, ahi, sw128_desc(hi_addr + 32 * kk), 1);
}

__device__ __forceinline__ void split_frag(const float (&v)[4], uint32_t (&ahi)[4],
                                           uint32_t (&alo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float hi, lo;
    split(v[e], hi, lo);
    ahi[e] = fbits(hi);
    alo[e] = fbits(lo);
  }
}

// The decayed scores of one row tile (rows r0, r0 + 8) at one k-step
// (columns sk + t4, sk + t4 + 4), split into TF32 hi and lo A fragments, from
// log2(e)-scaled prefix sums held as float pairs (ch, cl). Off the diagonal
// (every column at or before the tile's rows): L[r][s] = exp(cum[r] -
// cum[sk + 7]) exp(cum[sk + 7] - cum[s]), one exp2 a row and the column
// factors fa, fb. With da <= 0 both factors are at most 1: neither
// overflows, and where one flushes to zero, L is below float32's range too.
__device__ __forceinline__ void score_frag(const float* row_a, const float* row_b, int sk,
                                           int t4, float ch0, float cl0, float ch1, float cl1,
                                           float kh, float kl, float fa, float fb,
                                           uint32_t (&ahi)[4], uint32_t (&alo)[4]) {
  const int ca = sk + t4, cb2 = ca + 4;
  const float e0 = exp2_approx((ch0 - kh) + (cl0 - kl));  // exp(cum[r0] - cum[sk + 7])
  const float e1 = exp2_approx((ch1 - kh) + (cl1 - kl));
  const float v[4] = {row_a[ca] * e0 * fa, row_b[ca] * e1 * fa, row_a[cb2] * e0 * fb,
                      row_b[cb2] * e1 * fb};
  split_frag(v, ahi, alo);
}

// On the diagonal's k-steps: L[r][s] = exp(cum[r] - cum[s]) directly, the
// pairs with s > r zeroed.
__device__ __forceinline__ void score_frag_diag(const float* row_a, const float* row_b, int r0,
                                                int sk, int t4, float ch0, float cl0, float ch1,
                                                float cl1, const float* cum_hi,
                                                const float* cum_lo, uint32_t (&ahi)[4],
                                                uint32_t (&alo)[4]) {
  const int ca = sk + t4, cb2 = ca + 4;
  const float ha = cum_hi[ca], la = cum_lo[ca], hb = cum_hi[cb2], lb = cum_lo[cb2];
  const float v[4] = {
      ca <= r0 ? row_a[ca] * exp2_approx((ch0 - ha) + (cl0 - la)) : 0.f,
      ca <= r0 + 8 ? row_b[ca] * exp2_approx((ch1 - ha) + (cl1 - la)) : 0.f,
      cb2 <= r0 ? row_a[cb2] * exp2_approx((ch0 - hb) + (cl0 - lb)) : 0.f,
      cb2 <= r0 + 8 ? row_b[cb2] * exp2_approx((ch1 - hb) + (cl1 - lb)) : 0.f};
  split_frag(v, ahi, alo);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) ssd_chunk_scan_kernel(Params p) {
  using Cfg = Stage3Cfg<T>;
  using Scan = ChunkScan;
  constexpr bool BF = Cfg::BF;
  constexpr int SK = Cfg::SK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  float* pl_hi = reinterpret_cast<float*>(smem_raw + ((1024 - (raw_addr & 1023)) & 1023));
  float* pl_lo = pl_hi + Cfg::PLANE;
  const uint32_t hi_addr = static_cast<uint32_t>(__cvta_generic_to_shared(pl_hi));
  const uint32_t lo_addr = hi_addr + Cfg::PLANE * 4;
  float* cb = pl_lo + Cfg::PLANE;       // C.B^T of the block's rows, per warp
  float* cs = cb + p.cb_floats;         // C rows: bf16 [RB][C16_LD] or float [RB][C32_LD]
  float* cum_hi = cs + Cfg::C_FLOATS;   // [QMAX] log2(e) cum = cum_hi + cum_lo
  float* cum_lo = cum_hi + QMAX;
  float* fcol = cum_lo + QMAX;          // [QMAX] exp(cum[s | 7] - cum[s])
  double* tot = reinterpret_cast<double*>(fcol + QMAX);

  // Block order: the longest row blocks (last in the chunk) first, so the
  // grid ends on short blocks.
  int idx = blockIdx.x;
  const int per_rb = p.B * p.nc * p.G * p.nhbg;
  const int rb = p.nrb - 1 - idx / per_rb;
  idx %= per_rb;
  const int hbi = idx % p.nhbg;
  idx /= p.nhbg;
  const int g = idx % p.G;
  idx /= p.G;
  const int c = idx % p.nc;
  const int bi = idx / p.nc;

  const int hpg = p.H / p.G;
  const int h0 = g * hpg + hbi * p.hb;
  const int nheads = min(p.hb, hpg - hbi * p.hb);
  const int64_t row0 = (int64_t)c * p.Q;
  const int q = min(p.Q, p.S - (int)row0);
  const int l0 = rb * RB;
  if (l0 >= q) return;
  const int s_end = min(l0 + RB, q);  // source rows this block reads

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  const int wr = warp * 16;                        // the warp's first row in the block
  const bool active = l0 + wr < q;
  const int smax = min(l0 + wr + 15, s_end - 1);  // last source row the warp's rows read
  const int r0 = l0 + wr + gr;                     // this thread's rows in the chunk: r0, r0 + 8
  const int cq = tid & 7, mq = tid >> 3;           // slab quad: 16-byte chunk (4 k), column group
  const int ldw = cb_ld(l0, warp);                 // the warp's C.B^T rows
  float* cb_w = cb + cb_base(l0, warp);

  const T* bm = static_cast<const T*>(p.b) + bi * p.sbb + g * p.sbg + row0 * p.sbs;
  const T* cm = static_cast<const T*>(p.c) + bi * p.scb + g * p.scg + row0 * p.scs;
  constexpr int BVPR = NMAX * (int)sizeof(T) / 16;  // 16-byte vectors in a B or C row

  // C rows l0 .. l0 + 63, zero past q and N.
  {
    constexpr int LD = BF ? C16_LD : C32_LD;  // in elements of T
    T* ct = reinterpret_cast<T*>(cs);
    for (int v = tid; v < RB * BVPR; v += THREADS) {
      const int r = v / BVPR, col = (v % BVPR) * (16 / (int)sizeof(T));
      *reinterpret_cast<uint4*>(ct + r * LD + col) =
          load16(cm + l0 * p.scs, p.scs, r, col, q - l0, p.N, p.vec);
    }
  }

  // The slab stream: B slabs for C.B^T, then per head the start state in
  // slabs of SK columns (not in the first chunk) and xdt in slabs of SK rows.
  const int nb = (s_end + Cfg::SB - 1) / Cfg::SB;
  const int ninter = c > 0 ? (p.N + SK - 1) / SK : 0;
  const int nintra = (s_end + SK - 1) / SK;
  const int per_head = ninter + nintra;
  const int total = nb + nheads * per_head;

  uint4 stg[4];
  auto stage = [&](int t) {
    if (t < nb) {
      const int s0 = t * Cfg::SB;
#pragma unroll
      for (int i = 0; i < Cfg::VB; ++i) {
        const int v = tid + THREADS * i;
        stg[i] = load16(bm + s0 * p.sbs, p.sbs, v / BVPR, (v % BVPR) * (16 / (int)sizeof(T)),
                        q - s0, p.N, p.vec);
      }
      return;
    }
    const int h = h0 + (t - nb) / per_head, k = (t - nb) % per_head;
    if (k < ninter) {  // start[p][SK k .. SK k + SK - 1] from the scratch: rows 4 mq + j
      const float* st = p.states +
                        (((int64_t)bi * p.H + h) * (p.nc - 1) + (c - 1)) * (int64_t)p.P * p.NS +
                        SK * k;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        stg[j] = load16(st, p.NS, 4 * mq + j, 4 * cq, p.P, p.NS - SK * k, true);
    } else {  // xdt rows 4 cq + e of the slab, columns 4 mq .. 4 mq + 3
      const int s0 = SK * (k - ninter);
      const float* xs = p.xdt + bi * p.sxb + h * p.sxh + (row0 + s0) * p.sxs;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        stg[e] = load16(xs, p.sxs, 4 * cq + e, 4 * mq, q - s0, p.P, p.vec);
    }
  };

  float dnext[Scan::R];  // da of the next head, loaded ahead
  Scan::load(p, p.da + bi * p.sab + h0 * p.sah + row0 * p.sas, q, dnext);
  stage(0);

  // ---- C.B^T for the block's rows, once for all its heads ------------------
  for (int t = 0; t < nb; ++t) {
    __syncthreads();  // C rows stored; the previous slab is read
#pragma unroll
    for (int i = 0; i < Cfg::VB; ++i) {
      const int v = tid + THREADS * i;
      const int r = v / BVPR;
      if constexpr (BF) {
        const int col = (v % BVPR) * 8;
        *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(pl_hi) + r * C16_LD + col) =
            stg[i];
      } else {  // hi [SB][C32_LD], then lo
        const int col = (v % BVPR) * 4;
        const float4 x = as_f4(stg[i]);
        float4 hi, lo;
        split(x.x, hi.x, lo.x);
        split(x.y, hi.y, lo.y);
        split(x.z, hi.z, lo.z);
        split(x.w, hi.w, lo.w);
        *reinterpret_cast<float4*>(pl_hi + r * C32_LD + col) = hi;
        *reinterpret_cast<float4*>(pl_hi + (Cfg::SB + r) * C32_LD + col) = lo;
      }
    }
    __syncthreads();
    stage(t + 1);  // t + 1 < total: every block has at least one head
    const int s0 = t * Cfg::SB;
    if (!active || s0 > smax) continue;
    constexpr int NJ = Cfg::SB / 8;               // column tiles in the slab
    const int nj = min(NJ, (smax - s0) / 8 + 1);  // those at or below the warp's last row
    float a4[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) a4[j][0] = a4[j][1] = a4[j][2] = a4[j][3] = 0.f;
    if constexpr (BF) {
      const uint32_t* c32 = reinterpret_cast<const uint32_t*>(cs);     // [RB][68] words
      const uint32_t* b32 = reinterpret_cast<const uint32_t*>(pl_hi);  // [SB][68] words
#pragma unroll
      for (int kk = 0; kk < NMAX / 16; ++kk) {
        const int ca = (wr + gr) * (C16_LD / 2) + 8 * kk + t4;
        const uint32_t a[4] = {c32[ca], c32[ca + 8 * (C16_LD / 2)], c32[ca + 4],
                               c32[ca + 8 * (C16_LD / 2) + 4]};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int o = (8 * j + gr) * (C16_LD / 2) + 8 * kk + t4;
          mma_bf16(a4[j], a, b32[o], b32[o + 4]);
        }
      }
    } else {
      // One column tile of 8 B rows. Six accumulators (three product terms,
      // even and odd k-steps) keep the mma chains short.
      float part[6][4];
#pragma unroll
      for (int e = 0; e < 6; ++e) part[e][0] = part[e][1] = part[e][2] = part[e][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NMAX / 8; ++kk) {
        const int ca = (wr + gr) * C32_LD + 8 * kk + t4;
        uint32_t ahi[4], alo[4];
        const float av[4] = {cs[ca], cs[ca + 8 * C32_LD], cs[ca + 4], cs[ca + 8 * C32_LD + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float hi, lo;
          split(av[e], hi, lo);
          ahi[e] = fbits(hi);
          alo[e] = fbits(lo);
        }
        const int o = gr * C32_LD + 8 * kk + t4;
        const uint32_t bh0 = fbits(pl_hi[o]), bh1 = fbits(pl_hi[o + 4]);
        const int ol = o + Cfg::SB * C32_LD;
        mma_tf32(part[kk & 1], ahi, fbits(pl_hi[ol]), fbits(pl_hi[ol + 4]));
        mma_tf32(part[2 + (kk & 1)], alo, bh0, bh1);
        mma_tf32(part[4 + (kk & 1)], ahi, bh0, bh1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a4[0][e] = ((part[0][e] + part[1][e]) + (part[2][e] + part[3][e])) +
                   (part[4][e] + part[5][e]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
        float* o = cb_w + gr * ldw + s0 + 8 * j + 2 * t4;
        *reinterpret_cast<float2*>(o) = make_float2(a4[j][0], a4[j][1]);
        *reinterpret_cast<float2*>(o + 8 * ldw) = make_float2(a4[j][2], a4[j][3]);
      }
    }
  }

  // ---- per head: (exp(cum) o C).start^T + (C.B^T o L) xdt ------------------
  // The accumulators are written only by wgmma (a write by other instructions
  // would make the compiler serialize the wgmmas): the first of a head starts
  // them afresh, and exp(cum) scales the C rows of the carried product.
  float acc[32];
  float ch0 = 0.f, cl0 = 0.f, ch1 = 0.f, cl1 = 0.f;  // scaled cum of rows r0, r0 + 8 (hi, lo)
  float ec0 = 0.f, ec1 = 0.f;                         // exp(cum) of rows r0, r0 + 8
  const float* cb_row_a = cb_w + gr * ldw;
  const float* cb_row_b = cb_row_a + 8 * ldw;
  for (int t = nb; t < total; ++t) {
    const int hh = (t - nb) / per_head, k = (t - nb) % per_head;
    const bool head_start = k == 0;
    __syncthreads();  // every warp is done with the planes and the cum arrays
    if (k < ninter) {
#pragma unroll
      for (int j = 0; j < 4; ++j) put_split(pl_hi, pl_lo, sw_off(4 * mq + j, cq), as_f4(stg[j]));
    } else {  // transpose the 4 x 4 quad: column 4 mq + j, rows 4 cq .. 4 cq + 3
      const float4 x0 = as_f4(stg[0]), x1 = as_f4(stg[1]), x2 = as_f4(stg[2]),
                   x3 = as_f4(stg[3]);
      put_split(pl_hi, pl_lo, sw_off(4 * mq + 0, cq), make_float4(x0.x, x1.x, x2.x, x3.x));
      put_split(pl_hi, pl_lo, sw_off(4 * mq + 1, cq), make_float4(x0.y, x1.y, x2.y, x3.y));
      put_split(pl_hi, pl_lo, sw_off(4 * mq + 2, cq), make_float4(x0.z, x1.z, x2.z, x3.z));
      put_split(pl_hi, pl_lo, sw_off(4 * mq + 3, cq), make_float4(x0.w, x1.w, x2.w, x3.w));
    }
    fence_async_smem();
    Scan sc;
    if (head_start) sc.warp_part(dnext, tot);
    __syncthreads();
    if (head_start) {
      double cum[Scan::R];
      sc.finish(tot, cum);
      // cum of row 8 m + 7, the last of the thread's group of 8 rows.
      const double c8 = __shfl_sync(0xffffffffu, cum[Scan::R - 1], lane | (8 / Scan::R - 1));
#pragma unroll
      for (int e = 0; e < Scan::R; ++e) {
        const int r = Scan::R * tid + e;
        const double c2 = cum[e] * LOG2E;
        const float hi = static_cast<float>(c2);
        cum_hi[r] = hi;
        cum_lo[r] = static_cast<float>(c2 - static_cast<double>(hi));
        fcol[r] = expf(static_cast<float>(c8 - cum[e]));
      }
      if (hh + 1 < nheads)
        Scan::load(p, p.da + bi * p.sab + (h0 + hh + 1) * p.sah + row0 * p.sas, q, dnext);
    }
    if (t + 1 < total) stage(t + 1);
    if (head_start) {
      __syncthreads();  // cum arrays written
      ch0 = cum_hi[min(r0, QMAX - 1)];
      cl0 = cum_lo[min(r0, QMAX - 1)];
      ch1 = cum_hi[min(r0 + 8, QMAX - 1)];
      cl1 = cum_lo[min(r0 + 8, QMAX - 1)];
      constexpr float LN2 = 0.6931471805599453f;
      ec0 = exp2f(ch0) * (1.f + cl0 * LN2);
      ec1 = exp2f(ch1) * (1.f + cl1 * LN2);
    }
    // The slab's four k-steps: the A fragments first, then their wgmmas back
    // to back, then one wait.
    uint32_t ahi[4][4], alo[4][4];
    if (k < ninter) {
      // acc += (exp(cum) o C)[rows][n] . start[p][n] over this slab's SK columns n.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int n = SK * k + 8 * kk;
        float av[4];
        if constexpr (BF) {
          const uint16_t* c16 = reinterpret_cast<const uint16_t*>(cs);
          const int ca = (wr + gr) * C16_LD + n + t4;
          av[0] = bf16_to_f32(c16[ca]);
          av[1] = bf16_to_f32(c16[ca + 8 * C16_LD]);
          av[2] = bf16_to_f32(c16[ca + 4]);
          av[3] = bf16_to_f32(c16[ca + 8 * C16_LD + 4]);
        } else {
          const int ca = (wr + gr) * C32_LD + n + t4;
          av[0] = cs[ca];
          av[1] = cs[ca + 8 * C32_LD];
          av[2] = cs[ca + 4];
          av[3] = cs[ca + 8 * C32_LD + 4];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // rows r0 (e = 0, 2) and r0 + 8 (e = 1, 3)
          float hi, lo;
          split(av[e] * (e & 1 ? ec1 : ec0), hi, lo);
          ahi[kk][e] = fbits(hi);
          alo[kk][e] = fbits(lo);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma3(acc, ahi[kk], alo[kk], hi_addr, lo_addr, kk, k > 0 || kk > 0);
      wgmma_commit();
    } else {
      const int si = k - ninter;
      // acc += (C.B^T o L)[rows][s] . xdt[s][p] over this slab's source rows
      // below s_end; a warp's k-steps past its own rows add zeros.
      const int nk = min(SK / 8, (s_end - SK * si + 7) / 8);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int sk = SK * si + 8 * kk;
#pragma unroll
        for (int e = 0; e < 4; ++e) ahi[kk][e] = alo[kk][e] = 0u;
        if (kk < nk && sk <= smax) {
          if (sk + 7 <= l0 + wr)  // every pair of this k-step has s <= sk + 7 <= r
            score_frag(cb_row_a, cb_row_b, sk, t4, ch0, cl0, ch1, cl1, cum_hi[sk + 7],
                       cum_lo[sk + 7], fcol[sk + t4], fcol[sk + t4 + 4], ahi[kk], alo[kk]);
          else
            score_frag_diag(cb_row_a, cb_row_b, r0, sk, t4, ch0, cl0, ch1, cl1, cum_hi, cum_lo,
                            ahi[kk], alo[kk]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < nk)
          wgmma3(acc, ahi[kk], alo[kk], hi_addr, lo_addr, kk, ninter > 0 || si > 0 || kk > 0);
      wgmma_commit();
    }
    wgmma_wait_all();
    fence_acc(acc);
    if (k == per_head - 1 && active) {  // the head's rows are done: write y
      float* y = p.y + bi * p.syb + (int64_t)(h0 + hh) * p.syh;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t4;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = r0 + 8 * e;
          const int i = 4 * j + 2 * e;
          const float v0 = acc[i], v1 = acc[i + 1];
          if (r < q && col < p.P) {
            float* o = y + (row0 + r) * p.sys + col;
            if (p.vec) {  // whole 8-byte pairs: full 32-byte sectors a row
              *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
            } else {
              o[0] = v0;
              if (col + 1 < p.P) o[1] = v1;
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

bool aligned16(const void* ptr, int64_t stride, int esize) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (stride * esize) % 16 == 0;
}

template <typename T>
cudaError_t launch(Params& p, cudaStream_t stream) {
  const int esize = sizeof(T);
  p.vec = aligned16(p.xdt, p.sxs, 4) && aligned16(p.xdt, p.sxh, 4) &&
          aligned16(p.xdt, p.sxb, 4) && aligned16(p.b, p.sbs, esize) &&
          aligned16(p.b, p.sbg, esize) && aligned16(p.b, p.sbb, esize) &&
          aligned16(p.c, p.scs, esize) && aligned16(p.c, p.scg, esize) &&
          aligned16(p.c, p.scb, esize) && p.P % 4 == 0 && p.N % (16 / esize) == 0 &&
          reinterpret_cast<uintptr_t>(p.y) % 8 == 0 && p.syb % 2 == 0 && p.syh % 2 == 0 &&
          p.sys % 2 == 0;
  if (p.nc > 1) {
    cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Stage1Cfg<T>::SMEM);
    if (err != cudaSuccess) return err;
    ssd_chunk_state_kernel<T><<<dim3(p.nc - 1, p.H, p.B), THREADS, Stage1Cfg<T>::SMEM, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int per_chunk4 = p.P * p.NS / 4;
    ssd_state_pass_kernel<<<dim3((per_chunk4 + 255) / 256, p.H, p.B), 256, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // Heads per CTA: 8, halved while the grid would not fill every SM twice.
  const int hpg = p.H / p.G;
  p.nrb = (p.Q + RB - 1) / RB;
  const int l0max = RB * (p.nrb - 1);
  p.cb_floats = cb_base(l0max, 4);  // the four warps' strides, times 16
  p.hb = HB_MAX;
  auto ctas = [&](int hb) { return (int64_t)p.nrb * p.B * p.nc * p.G * ((hpg + hb - 1) / hb); };
  while (p.hb > 1 && ctas(p.hb) < 2 * num_sms()) p.hb /= 2;
  if (p.hb > hpg) p.hb = hpg;
  p.nhbg = (hpg + p.hb - 1) / p.hb;
  const int64_t grid = ctas(p.hb);
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem = stage3_smem_bytes<T>(p.cb_floats);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_scan_kernel<T><<<(unsigned)grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

int chunks(int S, int Q) { return (S + Q - 1) / Q; }
int state_stride(int N) { return (N + 3) / 4 * 4; }

}  // namespace

extern "C" {

// Float32 elements of scratch one call needs: the chunk states
// [B, H, nc-1, P, NS] and their decays [B, H, nc-1]; 0 when nc = 1.
int64_t ssd_scan_scratch_elems(int B, int H, int S, int P, int N, int Q) {
  const int nc = chunks(S, Q);
  if (nc <= 1) return 0;
  return (int64_t)B * H * (nc - 1) * ((int64_t)P * state_stride(N) + 1);
}

// Returns the cudaError_t of the first failed launch (0 on success).
// bc_dtype: 0 float32, 1 bfloat16. Strides are in elements; each last
// dimension is contiguous. `scratch` holds ssd_scan_scratch_elems floats.
int ssd_scan_fwd(const void* xdt, const void* da, const void* b, const void* c, void* y,
                 void* scratch, int B, int H, int G, int S, int P, int N, int Q,
                 int64_t sxb, int64_t sxh, int64_t sxs,
                 int64_t sab, int64_t sah, int64_t sas,
                 int64_t sbb, int64_t sbg, int64_t sbs,
                 int64_t scb, int64_t scg, int64_t scs,
                 int64_t syb, int64_t syh, int64_t sys,
                 int bc_dtype, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || S <= 0 || P <= 0 || N <= 0 || Q <= 0 ||
      H % G != 0 || P > PMAX || N > NMAX || Q > QMAX || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xdt = static_cast<const float*>(xdt);
  p.da = static_cast<const float*>(da);
  p.b = b;
  p.c = c;
  p.y = static_cast<float*>(y);
  p.B = B; p.H = H; p.G = G; p.S = S; p.P = P; p.N = N; p.Q = Q;
  p.NS = state_stride(N);
  p.nc = chunks(S, Q);
  if (p.nc > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  p.states = static_cast<float*>(scratch);
  p.decay = p.nc > 1 ? p.states + (int64_t)B * H * (p.nc - 1) * P * p.NS : nullptr;
  p.sxb = sxb; p.sxh = sxh; p.sxs = sxs;
  p.sab = sab; p.sah = sah; p.sas = sas;
  p.sbb = sbb; p.sbg = sbg; p.sbs = sbs;
  p.scb = scb; p.scg = scg; p.scs = scs;
  p.syb = syb; p.syh = syh; p.sys = sys;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0) return (int)launch<float>(p, st);
  if (bc_dtype == 1) return (int)launch<__nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
