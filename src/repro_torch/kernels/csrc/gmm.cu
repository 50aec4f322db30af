// Grouped matmul (the MoE expert FFN) for Hopper, written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_gmm_kernel` / `gmm` in
// repro/kernels/moe_gmm.py (three calls make one expert FFN, through
// `moe_ffn_gmm` in repro/kernels/ops.py).
//
// Computes out[e] = x[e] @ w[e] for x [E, C, K] and w [E, K, N], both
// bfloat16 or both float32, summing in float32 and writing the output in
// x's dtype. Any expert and row strides are taken, with a contiguous last
// dimension, so the capacity buffer's view that drops the sacrificial slot
// needs no copy. Ragged C, K and N are masked in the kernel: there are no
// padding copies like the Pallas wrapper's `jnp.pad`.
//
// What bounds it: the weights' bytes. At the decode shape
// [16,8,4096] x [16,4096,6400] one call reads 839 MB of bf16 weights and
// does 6.7 GFLOP, so its least time on an H100 (3.35 TB/s, 989 TFLOP/s
// bf16) is 251 us; at the prefill shape of a 512-token prompt (C = 80) it
// does 67 GFLOP on 866 MB, about 80 operations per byte against the card's
// ~295, so it is still bound by the bytes (258 us). In float32 the weights
// take twice the bytes (502 us at C = 8, 517 us at C = 80); on the CUDA
// cores (67 TFLOP/s) C = 80 would be bound by its operations (1002 us),
// while 3xTF32 on the tensor cores (three TF32 products, 495 TFLOP/s) puts
// them at 41 us and 407 us, under the bytes at every serving shape. The
// design's one aim is to stream the weights from device memory at close to
// the card's rate.
//
// bfloat16 design (the serving path; namespace hopper). Swap A and B: the
// kernel computes out[e]^T = w[e]^T x[e]^T, so a 64-column slice of the
// weights is the 64-row M side of wgmma (an MN-major A operand in shared
// memory, the transpose bit set) and the C rows of x are its narrow N side
// (m64nNTk16, NT = 8 ... 256 from a fixed set, the least that holds C or a
// C tile when C > 256). Every serving shape (C = 8 ... 80) runs with the
// accumulator at NT/2 floats a thread and no padding of the weights. One
// persistent CTA per SM walks the work list (expert, 128 output columns, C
// tile) in a fixed order: no CTA waits for a wave to drain, and a CTA's
// next item streams in while it writes the last one out.
// Each CTA has three roles in one block of 288 threads: two consumer
// warpgroups, each owning 64 of the 128 columns, and one producer warp
// whose lane 0 keeps a ring of shared-memory stages full with TMA
// (cp.async.bulk.tensor): per stage a 64-deep slice of the weights (two
// 64 x 64 boxes, one per consumer) and the C x 64 slice of x that both
// consumers read, all with the 128-byte swizzle that wgmma reads without
// bank conflicts. Full and empty mbarriers hand the stages back and forth,
// so there is no __syncthreads in the main loop and no per-thread address
// arithmetic for the copies. K, C and N past the tensors' ends are
// zero-filled by TMA; the epilogue converts the f32 accumulators to bf16
// and stores them from registers, transposed back to [C, N], with the
// ragged edges of C and N masked. Each output element is summed once, in
// order of k, by one thread: no split of K and no atomics, so results do
// not change from call to call. The tensor maps (x as a 3-D map over its
// strided view, w as a 3-D map over [E, K, N]) are encoded on the host at
// each call through the CUDA driver entry point that the runtime hands out, so
// the library links no libcuda. The ring has four stages (104 KB at
// C = 80, 68 KB at C = 8): 64 KB of weights in flight per SM, 8.4 MB on
// the card, which covers the memory's latency at 3.35 TB/s; deeper rings
// measured slower (see hopper::STAGES).
//
// float32 design (gmm_3xtf32_kernel, namespace hopper): the same grid,
// roles, work order and TMA ring (3-D float32 maps, 32-deep stages, 64 KB
// of weights in flight per SM), with the products on mma.sync m16n8k8 in
// 3xTF32 (tf32.cuh): each float32 operand split into TF32 hi and lo, hi.hi
// + hi.lo + lo.hi summed in float32, about float32 accuracy. The comment
// above the kernel says why mma.sync and not wgmma, and how its reads of
// the swizzled stages avoid bank conflicts. Results are bit-identical from
// call to call, as in bf16.
//
// Inputs whose base addresses or strides are not multiples of 16 bytes
// (which TMA cannot address), bfloat16 and float32, take the kernel of the
// first design (namespace simt): one CTA of 256 threads per (expert,
// 128-column tile, 128 rows of C) looping over K, loading element by
// element; float32 multiplies on the CUDA cores, bfloat16 on WMMA 16x16x16
// fragments.
//
// Experts that received no token. A call may pass `offsets`, E + 1
// ascending int64 on the device: expert e's routed pairs are
// [offsets[e], offsets[e + 1]) of the dispatch's sorted pairs (the
// searchsorted that places them), so it holds min(offsets[e + 1] -
// offsets[e], C) live rows. The dispatch zeroes the buffer before it
// scatters, so an expert with none has all-zero rows and, for finite
// weights, all-zero outputs: the kernel writes those zeros and reads none of
// its weights. The counts are read on the device at every launch, so a CUDA
// graph that captured the call skips the experts of each replay's routing.
// In the Hopper kernels, warp 0 of every CTA lists the experts in shared
// memory at the start (those with a row, ascending, then the others), and
// the persistent walk runs over that list (the identity where every expert
// was reached, as in a prefill): the work items of reached
// experts first, in the order of a call without offsets, which both the
// producer and the consumers walk; then the items of unreached experts, which
// the consumers alone walk, storing zeros from a zeroed accumulator through
// the same epilogue (no load, no barrier). The grid is still sized for all
// experts; CTAs without a live item only store zeros. The simt kernel's CTA
// of an unreached expert skips its K loop and stores zeros. Nothing else
// changes: live items sum in the same order, so outputs are bit-identical
// to a call without offsets on the same buffer. Without offsets (null),
// every expert is live, as before.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "tf32.cuh"

namespace {

struct Params {
  const void* x;
  const void* w;
  void* o;
  int C, K, N;
  int64_t sxe, sxc;  // element strides; the last dimension is contiguous
  int64_t swe, swk;
  int64_t soe, soc;
  const long long* offsets;  // E + 1 on the device, or null: every expert live
};

// Experts a call with offsets may have: the Hopper kernels list them in
// shared memory.
constexpr int MAX_LISTED = 1024;

// Whether expert e received a row (always, without offsets).
__device__ __forceinline__ bool reached(const Params& p, int e) {
  return p.offsets == nullptr || p.offsets[e + 1] > p.offsets[e];
}

// ---------------------------------------------------------------------------
// Inputs TMA cannot address, bfloat16 and float32: the first design's kernel
// ---------------------------------------------------------------------------

namespace simt {

constexpr int ROWS = 128;     // rows of C per CTA
constexpr int BN = 128;       // output columns per CTA
constexpr int BK = 32;        // contraction depth of one stage
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;

template <typename T>
struct Tile {
  static constexpr int VW = 16 / sizeof(T);    // elements in 16 bytes
  static constexpr int XLD = BK + VW;          // padded rows: fewer bank conflicts
  static constexpr int WLD = BN + VW;
  static constexpr int X_ELEMS = ROWS * XLD;
  static constexpr int W_ELEMS = BK * WLD;
  // float32: three (106 KB); bfloat16: five, under ~100 KB, so two CTAs
  // fit on an SM.
  static constexpr int STAGES = sizeof(T) == 4 ? 3 : 5;
  static constexpr size_t STAGE_BYTES = sizeof(T) * (X_ELEMS + W_ELEMS);
  static constexpr size_t SMEM_BYTES = STAGES * STAGE_BYTES;
};

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Stage the x tile (rows [m0, m0 + xrows), depth [k0, k0 + BK)) and the w
// tile (depth [k0, k0 + BK), columns [n0, n0 + BN)) element by element, at
// any alignment; zeros past C, K, N.
template <typename T>
__device__ __forceinline__ void load_tile(const Params& p, const T* xe, const T* we,
                                          T* xs, T* ws, int m0, int xrows, int n0,
                                          int k0, int tid) {
  using TL = Tile<T>;
  const T zero = from_f32<T>(0.f);
  for (int i = tid; i < xrows * BK; i += THREADS) {
    const int r = i / BK, c = i % BK;
    const int m = m0 + r, k = k0 + c;
    xs[r * TL::XLD + c] = (m < p.C && k < p.K) ? xe[m * p.sxc + k] : zero;
  }
  for (int i = tid; i < BK * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int k = k0 + r, n = n0 + c;
    ws[r * TL::WLD + c] = (k < p.K && n < p.N) ? we[k * p.swk + n] : zero;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) gmm_kernel(Params p) {
  using TL = Tile<T>;
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int MF = ROWS / 16;  // 16-row WMMA fragments (bf16)
  constexpr int MI = ROWS / 8;   // row groups of 8 (float32)
  extern __shared__ __align__(128) unsigned char smem[];
  T* const stage0 = reinterpret_cast<T*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * ROWS;
  const int e = blockIdx.z;
  const int mrows = min(ROWS, p.C - m0);
  const int xrows = min(ROWS, (mrows + 15) & ~15);
  const T* xe = static_cast<const T*>(p.x) + e * p.sxe;
  const T* we = static_cast<const T*>(p.w) + e * p.swe;
  T* oe = static_cast<T*>(p.o) + e * p.soe;
  // An expert no row reached loads nothing and stores its zeroed sums.
  const int nk = reached(p, e) ? (p.K + BK - 1) / BK : 0;

  auto xs_of = [&](int s) { return stage0 + s * (TL::X_ELEMS + TL::W_ELEMS); };
  auto ws_of = [&](int s) { return xs_of(s) + TL::X_ELEMS; };

  // Accumulators: only one of the two is used, by `if constexpr` below.
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc16[BF16 ? MF : 1];
  float acc32[BF16 ? 1 : MI][4];
  const int mf = (mrows + 15) / 16;
  const int mi = (mrows + 7) / 8;
  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < MF; ++i) nvcuda::wmma::fill_fragment(acc16[i], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc32[i][j] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < TL::STAGES - 1; ++s)
    if (s < nk) load_tile<T>(p, xe, we, xs_of(s), ws_of(s), m0, xrows, n0, s * BK, tid);

  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // tile kt is stored; stage kt-1 is free again
    const int next = kt + TL::STAGES - 1;
    if (next < nk) {
      const int s = next % TL::STAGES;
      load_tile<T>(p, xe, we, xs_of(s), ws_of(s), m0, xrows, n0, next * BK, tid);
    }

    const T* xs = xs_of(kt % TL::STAGES);
    const T* ws = ws_of(kt % TL::STAGES);
    if constexpr (BF16) {
      using namespace nvcuda;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, ws + kk * TL::WLD + warp * 16, TL::WLD);
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          if (i < mf) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
            wmma::load_matrix_sync(a, xs + i * 16 * TL::XLD + kk, TL::XLD);
            wmma::mma_sync(acc16[i], a, b, acc16[i]);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = to_f32(ws[kk * TL::WLD + lane + 32 * j]);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          if (i < mi) {
            const float xv = to_f32(xs[(warp + WARPS * i) * TL::XLD + kk]);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc32[i][j] = fmaf(xv, wv[j], acc32[i][j]);
          }
        }
      }
    }
  }

  if constexpr (BF16) {
    // Fragments go through a per-warp 16x16 float scratch (the layout of a
    // fragment's elements is opaque), then out with the ragged edge masked.
    __syncthreads();  // the stages are no longer read; reuse them
    float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
#pragma unroll
    for (int i = 0; i < MF; ++i) {
      if (i < mf) {
        nvcuda::wmma::store_matrix_sync(scratch, acc16[i], 16, nvcuda::wmma::mem_row_major);
        __syncwarp();
        for (int j = lane; j < 256; j += 32) {
          const int m = m0 + i * 16 + j / 16, n = n0 + warp * 16 + j % 16;
          if (m < p.C && n < p.N) oe[m * p.soc + n] = from_f32<T>(scratch[j]);
        }
        __syncwarp();
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int m = m0 + warp + WARPS * i;
      if (i < mi && m < p.C) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + lane + 32 * j;
          if (n < p.N) oe[m * p.soc + n] = from_f32<T>(acc32[i][j]);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, int E, cudaStream_t stream) {
  constexpr size_t bytes = Tile<T>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      gmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.N + BN - 1) / BN, (p.C + ROWS - 1) / ROWS, E);
  gmm_kernel<T><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16 on Hopper: swap-AB wgmma, TMA ring, persistent grid
// ---------------------------------------------------------------------------

namespace hopper {

constexpr int BK = 64;                     // contraction depth of one stage (128 bytes of bf16)
constexpr int CONSUMERS = 2;               // consumer warpgroups, 64 output columns each
constexpr int COLS = 64 * CONSUMERS;       // output columns per work item
constexpr int THREADS = 128 * CONSUMERS + 32;  // and one producer warp
constexpr int W_BOX = BK * 64 * 2;         // bytes of one 64-deep, 64-column weight box
// Stages in flight per SM. Measured on the H100 at the serving shapes:
// four beat deeper rings (6, 8 and 10 were 1-4% slower at C = 80 and no
// faster at C = 8), and three lost at every shape.
constexpr int STAGES = 4;

// The ring for a C tile of NT rows: per stage the CONSUMERS weight boxes
// and the x tile; then the full and empty barriers, and 1 KB to align the
// ring to the swizzle atom.
template <int NT>
struct Ring {
  static constexpr int X_BYTES = NT * BK * 2;  // a multiple of 1024: the swizzle atom
  static constexpr int STAGE_BYTES = CONSUMERS * W_BOX + X_BYTES;
  static constexpr size_t SMEM_BYTES = (size_t)STAGES * STAGE_BYTES + 16 * STAGES + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Waits for the phase of `bar` with this parity to complete. A wait that
// outlasts ~2^26 tries (seconds) can only be a fault of the kernel: it
// traps, so the call fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 26)) asm volatile("trap;");
  }
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// A box of a 3-D tensor map (coordinates innermost first) into shared
// memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor for a tile stored with the 128-byte
// swizzle (rows of 128 bytes, 8-row atoms of 1024 bytes). Both byte
// offsets are 1024: for the MN-major weights the stride between 8-deep
// groups of k (the only second atom a 64-row M side has); for the
// K-major x tile the stride between 8-row groups of C.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
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

// d[64 x N] (+)= A[64 x 16] B[16 x N]: bf16 from shared memory, f32 sums;
// A MN-major (the transpose bit), B K-major; scale_d = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_tn(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tn<8>(float (&d)[4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tn<16>(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tn<32>(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tn<48>(float (&d)[24], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tn<64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tn<80>(float (&d)[40], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tn<128>(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tn<192>(float (&d)[96], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tn<256>(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

struct Work {
  int e, n0, c0;
};

// The experts in the order the CTAs walk them, in shared memory: with
// offsets, the reached experts ascending, then the others.
struct ExpertList {
  int order[MAX_LISTED];
  int reached;  // how many of `order` received a row
};

// Warp 0 fills `list` from the call's offsets; the caller syncs the block.
__device__ __forceinline__ void list_experts(const Params& p, int E, ExpertList& list) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  int hits = 0, misses = 0;
  for (int base = 0; base < E; base += 32) {
    const int e = base + lane;
    const bool in = e < E, hit = in && reached(p, e);
    const unsigned hit_mask = __ballot_sync(~0u, hit), miss_mask = __ballot_sync(~0u, in && !hit);
    if (hit) list.order[hits + __popc(hit_mask & below)] = e;
    else if (in) list.order[E - 1 - misses - __popc(miss_mask & below)] = e;  // from the end
    hits += __popc(hit_mask);
    misses += __popc(miss_mask);
  }
  if (lane == 0) list.reached = hits;
}

// Work item t of E x (N / COLS) x (C / NT) over the expert at list position
// t / (n_nt n_ct) (`order`, or the identity without offsets): C tiles
// fastest, so the C tiles that share a weight tile run side by side and
// share it in L2.
__device__ __forceinline__ Work work_of(int t, int n_nt, int n_ct, int NT, const int* order) {
  const int ct = t % n_ct, nt = (t / n_ct) % n_nt, i = t / (n_ct * n_nt);
  return Work{order != nullptr ? order[i] : i, nt * COLS, ct * NT};
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
    gmm_wgmma_kernel(__grid_constant__ const CUtensorMap xmap,
                     __grid_constant__ const CUtensorMap wmap, Params p, int E) {
  using R = Ring<NT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t bars = ring + STAGES * R::STAGE_BYTES;  // full[s] at bars + 8s, empty[s] after
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  // Stage s: the weight boxes of consumer 0 and 1, then the x tile.
  auto w_tile = [&](int s, int cg) { return ring + s * R::STAGE_BYTES + cg * W_BOX; };
  auto x_tile = [&](int s) { return ring + s * R::STAGE_BYTES + CONSUMERS * W_BOX; };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);                // the producer's arrive.expect_tx
      mbar_init(empty(s), 4 * CONSUMERS);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __shared__ ExpertList list;
  if (p.offsets != nullptr && warp == 0) list_experts(p, E, list);
  __syncthreads();

  const int n_nt = (p.N + COLS - 1) / COLS, n_ct = (p.C + NT - 1) / NT;
  const int n_work = E * n_nt * n_ct;
  // Items [0, n_live) are the reached experts'; the rest store zeros.
  const int n_reached = p.offsets != nullptr ? list.reached : E;
  const int n_live = n_reached * n_nt * n_ct;
  const int* order = n_reached < E ? list.order : nullptr;  // all reached: the identity
  const int nk = (p.K + BK - 1) / BK;

  if (warp == 4 * CONSUMERS) {
    // Producer: lane 0 issues every copy, in the consumers' order.
    if (lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_live; t += gridDim.x) {
        const Work w = work_of(t, n_nt, n_ct, NT, order);
        // A second weight box wholly past N is not loaded; its consumer's
        // columns are all masked in the epilogue.
        const bool second = w.n0 + 64 < p.N;
        const uint32_t bytes = R::X_BYTES + (second ? 2 : 1) * W_BOX;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(empty(s), phase ^ 1);  // the stage's last use was consumed
          mbar_expect_tx(full(s), bytes);
          tma_load_3d(x_tile(s), &xmap, full(s), kb * BK, w.c0, w.e);
          tma_load_3d(w_tile(s, 0), &wmap, full(s), w.n0, kb * BK, w.e);
          if (second) tma_load_3d(w_tile(s, 1), &wmap, full(s), w.n0 + 64, kb * BK, w.e);
          if (++s == STAGES) { s = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // Consumers: warpgroup cg owns columns n0 + 64 cg ... + 63.
    const int cg = warp >> 2, wq = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);
    int s = 0;
    uint32_t phase = 0;
    float acc[NT / 2];
    for (int t = blockIdx.x; t < n_work; t += gridDim.x) {
      const Work w = work_of(t, n_nt, n_ct, NT, order);
      if (t >= n_live) {  // an unreached expert: zeros, nothing loaded
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
      }
      for (int kb = 0; kb < (t < n_live ? nk : 0); ++kb) {
        mbar_wait(full(s), phase);
        wgmma_fence();
        const uint32_t a0 = w_tile(s, cg), b0 = x_tile(s);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          // 16 deeper: 16 rows of 128 bytes in A, 32 bytes along B's swizzled rows.
          wgmma_tn<NT>(acc, smem_desc(a0 + kk * 2048), smem_desc(b0 + kk * 32),
                       kb > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(empty(s));
        if (++s == STAGES) { s = 0; phase ^= 1; }
      }
      // acc[4j + 2h + b] is column n0 + 64 cg + 16 wq + g + 8h of the
      // weights (row of out^T) and row c0 + 8j + 2 t4 + b of x.
      const int64_t obase = (int64_t)w.e * p.soe;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = w.n0 + 64 * cg + 16 * wq + g + 8 * h;
        if (n >= p.N) continue;
#pragma unroll
        for (int j = 0; j < NT / 8; ++j)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int c = w.c0 + 8 * j + 2 * t4 + b;
            if (c < p.C) out[obase + (int64_t)c * p.soc + n] = __float2bfloat16(acc[4 * j + 2 * h + b]);
          }
      }
    }
  }
}

// float32 (gmm_3xtf32_kernel): the same persistent grid, work list, roles
// and TMA ring, with 3xTF32 mma.sync (tf32.cuh) in place of wgmma. A TF32
// wgmma operand in shared memory must be K-major, and the weights [K, N]
// are N-major; mma.sync takes both operands from registers, and its N = 8
// is decode's C = 8. (wgmma with the weights as its register A and x split
// into hi and lo planes measured no faster on the H100, and its two stages
// in flight fit 168 registers only up to a 48-row C tile: PERF.md, PR 22.) A stage is 32 deep (one 128-byte row of f32): four
// 32-column weight boxes and the C x 32 x tile, 128-byte swizzled. Consumer
// warp w of warpgroup cg owns output columns 64 cg + 16 w ... + 15 (the A
// side: w^T, rows of out^T) for every C tile column (the B side: x^T, 8 at
// a time). Each k index of an m16n8k8 step stands for a row of the stage
// chosen so that both operands are read without bank conflicts: k = t is
// row 2t + p(t) and k = t + 4 row 2t + 1 - p(t) of the step's 8, p(t) =
// (t ^ (t >> 1)) & 1 (tests/test_torch_f32_kernel_design.py). Operands are
// split into TF32 hi and lo in registers as they are read.
constexpr int F32_BK = 32;                          // contraction depth of one stage
constexpr int F32_BOX_COLS = 32;                    // weight columns per TMA box: 128 bytes
constexpr int F32_BOXES = COLS / F32_BOX_COLS;      // weight boxes per stage
constexpr int F32_BOX = F32_BK * F32_BOX_COLS * 4;  // bytes of one weight box
// 64 KB of weights in flight per SM, as the bf16 ring's four stages.
constexpr int F32_STAGES = 4;

template <int NT>
struct F32Ring {
  static constexpr int X_BYTES = NT * F32_BK * 4;  // NT rows of 128 bytes: a multiple of 1024
  static constexpr int STAGE_BYTES = F32_BOXES * F32_BOX + X_BYTES;
  static constexpr size_t SMEM_BYTES = (size_t)F32_STAGES * STAGE_BYTES + 16 * F32_STAGES + 1024;
};

// Byte offset of float `col` of row `row` in a box of 128-byte rows stored
// with TMA's 128-byte swizzle: 16-byte chunk c of row r lands at c ^ (r % 8).
__device__ __forceinline__ uint32_t sw128(int row, int col) {
  return (uint32_t)(row * 128 + ((((col >> 2) ^ row) & 7) << 4) + ((col & 3) << 2));
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
    gmm_3xtf32_kernel(__grid_constant__ const CUtensorMap xmap,
                      __grid_constant__ const CUtensorMap wmap, Params p, int E) {
  using R = F32Ring<NT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring = (raw + 1023) & ~1023u;
  const unsigned char* ring_ptr = smem_raw + (ring - raw);
  const uint32_t bars = ring + F32_STAGES * R::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (F32_STAGES + s); };
  // Stage s: the F32_BOXES weight boxes, then the x tile.
  auto w_box = [&](int s, int i) { return s * R::STAGE_BYTES + i * F32_BOX; };
  auto x_tile = [&](int s) { return s * R::STAGE_BYTES + F32_BOXES * F32_BOX; };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < F32_STAGES; ++s) {
      mbar_init(full(s), 1);                // the producer's arrive.expect_tx
      mbar_init(empty(s), 4 * CONSUMERS);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __shared__ ExpertList list;
  if (p.offsets != nullptr && warp == 0) list_experts(p, E, list);
  __syncthreads();

  const int n_nt = (p.N + COLS - 1) / COLS, n_ct = (p.C + NT - 1) / NT;
  const int n_work = E * n_nt * n_ct;
  const int n_reached = p.offsets != nullptr ? list.reached : E;
  const int n_live = n_reached * n_nt * n_ct;
  const int* order = n_reached < E ? list.order : nullptr;
  const int nk = (p.K + F32_BK - 1) / F32_BK;

  if (warp == 4 * CONSUMERS) {
    // Producer: lane 0 issues every copy, in the consumers' order. Weight
    // boxes wholly past N are not loaded; their columns are masked.
    if (lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_live; t += gridDim.x) {
        const Work w = work_of(t, n_nt, n_ct, NT, order);
        const int boxes = min(F32_BOXES, (p.N - w.n0 + F32_BOX_COLS - 1) / F32_BOX_COLS);
        const uint32_t bytes = R::X_BYTES + boxes * F32_BOX;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(empty(s), phase ^ 1);
          mbar_expect_tx(full(s), bytes);
          tma_load_3d(ring + x_tile(s), &xmap, full(s), kb * F32_BK, w.c0, w.e);
          for (int i = 0; i < boxes; ++i)
            tma_load_3d(ring + w_box(s, i), &wmap, full(s), w.n0 + i * F32_BOX_COLS,
                        kb * F32_BK, w.e);
          if (++s == F32_STAGES) { s = 0; phase ^= 1; }
        }
      }
    }
  } else {
    const int cg = warp >> 2, wq = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const int par = (t4 ^ (t4 >> 1)) & 1;
    const int ra = 2 * t4 + par, rb = 2 * t4 + 1 - par;  // the rows k = t and k = t + 4 read
    const int box = 2 * cg + (wq >> 1), cb = 16 * (wq & 1) + g;  // this lane's column: cb, cb + 8
    float* out = static_cast<float*>(p.o);
    int s = 0;
    uint32_t phase = 0;
    float acc[NT / 8][4];
    for (int t = blockIdx.x; t < n_work; t += gridDim.x) {
      const Work w = work_of(t, n_nt, n_ct, NT, order);
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int kb = 0; kb < (t < n_live ? nk : 0); ++kb) {  // an unreached expert: zeros
        mbar_wait(full(s), phase);
        const unsigned char* wt = ring_ptr + w_box(s, box);
        const unsigned char* xt = ring_ptr + x_tile(s);
        auto at = [](const unsigned char* tile, int row, int col) {
          return *reinterpret_cast<const float*>(tile + sw128(row, col));
        };
        // The stage's products go to a partial sum started at zero, added to
        // acc in float32 after: an mma adds its products to its accumulator
        // with truncation, which over a whole K (1600 chained mma at K =
        // 4096) measured up to 2.4e-4 off on the H100, growing with K.
        float part[NT / 8][4];
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < F32_BK / 8; ++kk) {
          // A = w^T: rows cb and cb + 8 of this warp's 16, k rows ra and rb.
          const float a[4] = {at(wt, 8 * kk + ra, cb), at(wt, 8 * kk + ra, cb + 8),
                              at(wt, 8 * kk + rb, cb), at(wt, 8 * kk + rb, cb + 8)};
          uint32_t ahi[4], alo[4];
          split_frag(a, ahi, alo);
#pragma unroll
          for (int j = 0; j < NT / 8; ++j)  // B = x^T: rows 8j + g of the C tile
            mma_3xtf32(part[j], ahi, alo, at(xt, 8 * j + g, 8 * kk + ra),
                       at(xt, 8 * j + g, 8 * kk + rb));
        }
        __syncwarp();  // every lane's reads of the stage are done
        if (lane == 0) mbar_arrive(empty(s));
        if (++s == F32_STAGES) { s = 0; phase ^= 1; }
#pragma unroll
        for (int j = 0; j < NT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
      }
      // acc[j][e] is column n0 + 64 cg + 16 wq + g + 8 (e >> 1) of the
      // weights and row c0 + 8j + 2 t4 + (e & 1) of x.
      const int64_t obase = (int64_t)w.e * p.soe;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = w.n0 + 64 * cg + 16 * wq + g + 8 * (e >> 1);
          const int c = w.c0 + 8 * j + 2 * t4 + (e & 1);
          if (n < p.N && c < p.C) out[obase + (int64_t)c * p.soc + n] = acc[j][e];
        }
    }
  }
}

// The SM count of each device, read once (0: not read yet).
constexpr int MAX_DEVICES = 64;
int sm_count[MAX_DEVICES];

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the CUDA driver through the runtime (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 3-D map of `elem`-byte elements (bf16 or float32; dims and strides in
// elements, innermost first; the innermost is contiguous) read in boxes of
// `box`, 128-byte swizzled, zeros past the ends.
bool encode(CUtensorMap* map, const void* base, int elem, uint64_t d0, uint64_t d1, uint64_t d2,
            int64_t stride1, int64_t stride2, uint32_t box0, uint32_t box1) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  // A size-1 dimension's stride is never stepped: give it a valid one.
  if (d1 == 1) stride1 = (int64_t)(d0 + 7) / 8 * 8;
  if (d2 == 1) stride2 = stride1 * (int64_t)d1;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {(cuuint64_t)(stride1 * elem), (cuuint64_t)(stride2 * elem)};
  const cuuint32_t boxes[3] = {box0, box1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            3, const_cast<void*>(base), dims, strides, boxes, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What TMA can address: 16-byte aligned bases and positive strides that
// are multiples of 16 bytes (a size-1 dimension's stride is never stepped,
// so it does not count), for elements of `elem` bytes.
bool addressable(const Params& p, int E, int elem) {
  const int64_t vec = 16 / elem;
  const auto al = [vec](int64_t stride, int64_t size) {
    return size == 1 || (stride > 0 && stride % vec == 0);
  };
  return ((reinterpret_cast<uintptr_t>(p.x) | reinterpret_cast<uintptr_t>(p.w)) & 15) == 0 &&
         al(p.sxe, E) && al(p.sxc, p.C) && al(p.swe, E) && al(p.swk, p.K);
}

// Reads the device's SM count once and opts `kernel` in to `bytes` of
// shared memory once per device (`attr_set` is the kernel's own flags).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes, bool (&attr_set)[MAX_DEVICES], int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  *sms = sm_count[dev];
  return cudaSuccess;
}

template <int NT>
cudaError_t launch_nt(const Params& p, int E, cudaStream_t stream) {
  constexpr size_t bytes = Ring<NT>::SMEM_BYTES;
  static bool attr_set[MAX_DEVICES];
  int sms = 0;
  cudaError_t err = prepare(gmm_wgmma_kernel<NT>, bytes, attr_set, &sms);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, wmap;
  if (!encode(&xmap, p.x, 2, p.K, p.C, E, p.sxc, p.sxe, BK, NT) ||
      !encode(&wmap, p.w, 2, p.N, p.K, E, p.swk, p.swe, 64, BK))
    return cudaErrorInvalidValue;
  const long n_work = (long)E * ((p.N + COLS - 1) / COLS) * ((p.C + NT - 1) / NT);
  const int grid = (int)(n_work < sms ? n_work : sms);
  gmm_wgmma_kernel<NT><<<grid, THREADS, bytes, stream>>>(xmap, wmap, p, E);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_f32_nt(const Params& p, int E, cudaStream_t stream) {
  constexpr size_t bytes = F32Ring<NT>::SMEM_BYTES;
  static bool attr_set[MAX_DEVICES];
  int sms = 0;
  cudaError_t err = prepare(gmm_3xtf32_kernel<NT>, bytes, attr_set, &sms);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, wmap;
  if (!encode(&xmap, p.x, 4, p.K, p.C, E, p.sxc, p.sxe, F32_BK, NT) ||
      !encode(&wmap, p.w, 4, p.N, p.K, E, p.swk, p.swe, F32_BOX_COLS, F32_BK))
    return cudaErrorInvalidValue;
  const long n_work = (long)E * ((p.N + COLS - 1) / COLS) * ((p.C + NT - 1) / NT);
  const int grid = (int)(n_work < sms ? n_work : sms);
  gmm_3xtf32_kernel<NT><<<grid, THREADS, bytes, stream>>>(xmap, wmap, p, E);
  return cudaGetLastError();
}

// The C tile: the least of the instantiated widths that holds C, or, past
// 256 rows, an even share of C in as few tiles as hold it.
cudaError_t launch(const Params& p, int E, cudaStream_t stream) {
  const int tiles = (p.C + 255) / 256;
  const int rows = (p.C + tiles - 1) / tiles;
  if (rows <= 8) return launch_nt<8>(p, E, stream);
  if (rows <= 16) return launch_nt<16>(p, E, stream);
  if (rows <= 32) return launch_nt<32>(p, E, stream);
  if (rows <= 48) return launch_nt<48>(p, E, stream);
  if (rows <= 64) return launch_nt<64>(p, E, stream);
  if (rows <= 80) return launch_nt<80>(p, E, stream);
  if (rows <= 128) return launch_nt<128>(p, E, stream);
  if (rows <= 192) return launch_nt<192>(p, E, stream);
  return launch_nt<256>(p, E, stream);
}

// float32: the same choice from widths up to 80 (the accumulators and
// their partial sums take NT floats a thread).
cudaError_t launch_f32(const Params& p, int E, cudaStream_t stream) {
  const int tiles = (p.C + 79) / 80;
  const int rows = (p.C + tiles - 1) / tiles;
  if (rows <= 8) return launch_f32_nt<8>(p, E, stream);
  if (rows <= 16) return launch_f32_nt<16>(p, E, stream);
  if (rows <= 32) return launch_f32_nt<32>(p, E, stream);
  if (rows <= 48) return launch_f32_nt<48>(p, E, stream);
  if (rows <= 64) return launch_f32_nt<64>(p, E, stream);
  return launch_f32_nt<80>(p, E, stream);
}

}  // namespace hopper
}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). dtype: 0 float32,
// 1 bfloat16. Strides are in elements; each last dimension is contiguous.
// offsets: null, or E + 1 ascending int64 on the device (the header says
// what they mean), E at most MAX_LISTED.
int gmm_fwd(const void* x, const void* w, void* o, int E, int C, int K, int N,
            int64_t sxe, int64_t sxc, int64_t swe, int64_t swk, int64_t soe, int64_t soc,
            const void* offsets, int dtype, void* stream) {
  if (E <= 0 || C <= 0 || K <= 0 || N <= 0 || E > 65535 ||
      (C + simt::ROWS - 1) / simt::ROWS > 65535 || (offsets != nullptr && E > MAX_LISTED))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.w = w; p.o = o;
  p.C = C; p.K = K; p.N = N;
  p.sxe = sxe; p.sxc = sxc;
  p.swe = swe; p.swk = swk;
  p.soe = soe; p.soc = soc;
  p.offsets = static_cast<const long long*>(offsets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(hopper::addressable(p, E, 4) ? hopper::launch_f32(p, E, st)
                                              : simt::launch<float>(p, E, st));
  if (dtype == 1)
    return (int)(hopper::addressable(p, E, 2) ? hopper::launch(p, E, st)
                                              : simt::launch<__nv_bfloat16>(p, E, st));
  return (int)cudaErrorInvalidValue;
}

const char* gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
