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
// Design. The Pallas grid (E, C/bc, N/bn, K/bk) carries an f32 accumulator
// in VMEM across its sequential k axis. On the card blocks run in any
// order, so each CTA of 256 threads owns one (expert, 128-column output
// tile, ROWS rows of C) and loops over K itself, with the accumulator in
// registers. ROWS is the least of 16, 32, 64, 80 and 128 that holds C, so
// a decode step (C = 8) spends neither registers nor shared memory on rows
// it does not have, and more CTAs fit on an SM; a prefill of 512 tokens
// (C = 80) gets an 80-row tile with six stages in flight. At the serving shapes
// C <= 80, so one CTA covers every row of its expert and each weight is
// read from device memory once. Tiles of x (ROWS x 32) and w (32 x 128)
// stream through a ring of shared-memory stages filled by 16-byte
// `cp.async` copies (zero-filled past the ragged edge), so several weight
// tiles are in flight while the previous one is multiplied. Inputs whose sizes, strides or base addresses are not
// multiples of 16 bytes take the same kernel with element-wise loads.
// bfloat16 multiplies on the tensor cores through WMMA 16x16x16 fragments
// (each warp owns 16 columns and every 16-row fragment of C that holds
// rows); float32 multiplies on the CUDA cores (each thread owns rows
// warp + 8i and columns lane + 32j), so float32 stays float32.
//
// What bounds it: the weights' bytes. At the decode shape
// [16,8,4096] x [16,4096,6400] one call reads 839 MB of bf16 weights and
// does 6.7 GFLOP, so its least time on an H100 (3.35 TB/s, 989 TFLOP/s
// bf16) is 251 us; at the prefill shape of a 512-token prompt (C = 80) it
// does 67 GFLOP on 866 MB, still bound by the bytes (258 us). Reading the
// weights once, in 16-byte copies with several stages in flight, is what
// the design does about it. Not done yet: wgmma and TMA, a persistent
// grid sized to the SMs, skipping experts that received no token.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_ROWS = 128; // rows of C per CTA, at most
constexpr int BN = 128;       // output columns per CTA
constexpr int BK = 32;        // contraction depth of one stage
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;

struct Params {
  const void* x;
  const void* w;
  void* o;
  int C, K, N;
  int64_t sxe, sxc;  // element strides; the last dimension is contiguous
  int64_t swe, swk;
  int64_t soe, soc;
};

template <typename T, int ROWS>
struct Tile {
  static constexpr int VW = 16 / sizeof(T);    // elements in one 16-byte copy
  static constexpr int XLD = BK + VW;          // padded rows: fewer bank conflicts,
  static constexpr int WLD = BN + VW;          // and still 16-byte aligned
  static constexpr int X_ELEMS = ROWS * XLD;
  static constexpr int W_ELEMS = BK * WLD;
  // bf16: deeper rings where the x tile is large enough to need them (all
  // stay under ~100 KB, so two CTAs fit on an SM); float32: three.
  static constexpr int STAGES = sizeof(T) == 4 ? 3 : ROWS <= 32 ? 4 : ROWS <= 80 ? 6 : 5;
  static constexpr size_t STAGE_BYTES = sizeof(T) * (X_ELEMS + W_ELEMS);
  static constexpr size_t SMEM_BYTES = STAGES * STAGE_BYTES;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes from global to shared memory, asynchronously; `bytes` = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage the x tile (rows [m0, m0 + xrows), depth [k0, k0 + BK)) and the w
// tile (depth [k0, k0 + BK), columns [n0, n0 + BN)); zeros past C, K, N.
template <typename T, bool VEC, int ROWS>
__device__ __forceinline__ void load_tile(const Params& p, const T* xe, const T* we,
                                          T* xs, T* ws, int m0, int xrows, int n0,
                                          int k0, int tid) {
  using TL = Tile<T, ROWS>;
  if constexpr (VEC) {
    constexpr int XCH = BK / TL::VW;
    for (int i = tid; i < xrows * XCH; i += THREADS) {
      const int r = i / XCH, c = (i % XCH) * TL::VW;
      const int m = m0 + r, k = k0 + c;
      const bool ok = m < p.C && k < p.K;  // K % VW == 0: a copy is all in or all out
      cp_async16(xs + r * TL::XLD + c, ok ? xe + m * p.sxc + k : xe, ok ? 16 : 0);
    }
    constexpr int WCH = BN / TL::VW;
    for (int i = tid; i < BK * WCH; i += THREADS) {
      const int r = i / WCH, c = (i % WCH) * TL::VW;
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < p.K && n < p.N;
      cp_async16(ws + r * TL::WLD + c, ok ? we + k * p.swk + n : we, ok ? 16 : 0);
    }
  } else {
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
}

template <typename T, bool VEC, int ROWS>
__global__ void __launch_bounds__(THREADS) gmm_kernel(Params p) {
  using TL = Tile<T, ROWS>;
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
  const int nk = (p.K + BK - 1) / BK;

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
  for (int s = 0; s < TL::STAGES - 1; ++s) {
    if (s < nk) load_tile<T, VEC, ROWS>(p, xe, we, xs_of(s), ws_of(s), m0, xrows, n0, s * BK, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<TL::STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();                  // ... everyone's; stage kt-1 is free again
    const int next = kt + TL::STAGES - 1;
    if (next < nk) {
      const int s = next % TL::STAGES;
      load_tile<T, VEC, ROWS>(p, xe, we, xs_of(s), ws_of(s), m0, xrows, n0, next * BK, tid);
    }
    cp_async_commit();

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
    cp_async_wait<0>();
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

template <typename T, bool VEC, int ROWS>
cudaError_t launch(const Params& p, int E, cudaStream_t stream) {
  constexpr size_t bytes = Tile<T, ROWS>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      gmm_kernel<T, VEC, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.N + BN - 1) / BN, (p.C + ROWS - 1) / ROWS, E);
  gmm_kernel<T, VEC, ROWS><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
bool vectorizable(const void* x, const void* w, const Params& p) {
  constexpr int VW = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
         p.K % VW == 0 && p.N % VW == 0 && p.sxe % VW == 0 && p.sxc % VW == 0 &&
         p.swe % VW == 0 && p.swk % VW == 0;
}

// The row tile that holds C (up to 128); element-wise loads, off the
// serving path, take the 128-row tile only.
template <typename T>
cudaError_t dispatch(const Params& p, int E, cudaStream_t stream) {
  if (!vectorizable<T>(p.x, p.w, p)) return launch<T, false, 128>(p, E, stream);
  if (p.C <= 16) return launch<T, true, 16>(p, E, stream);
  if (p.C <= 32) return launch<T, true, 32>(p, E, stream);
  if (p.C <= 64) return launch<T, true, 64>(p, E, stream);
  if (p.C <= 80) return launch<T, true, 80>(p, E, stream);
  return launch<T, true, 128>(p, E, stream);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). dtype: 0 float32,
// 1 bfloat16. Strides are in elements; each last dimension is contiguous.
int gmm_fwd(const void* x, const void* w, void* o, int E, int C, int K, int N,
            int64_t sxe, int64_t sxc, int64_t swe, int64_t swk, int64_t soe, int64_t soc,
            int dtype, void* stream) {
  if (E <= 0 || C <= 0 || K <= 0 || N <= 0 || E > 65535 ||
      (C + MAX_ROWS - 1) / MAX_ROWS > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.w = w; p.o = o;
  p.C = C; p.K = K; p.N = N;
  p.sxe = sxe; p.sxc = sxc;
  p.swe = swe; p.swk = swk;
  p.soe = soe; p.soc = soc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(p, E, st);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(p, E, st);
  return (int)cudaErrorInvalidValue;
}

const char* gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
