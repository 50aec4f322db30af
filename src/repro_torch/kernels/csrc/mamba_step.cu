// Mamba-2 decode step (one token a slot) for Hopper, written by hand in CUDA C++.
//
// Replaces no TPU kernel: the JAX package's decode step (`apply_mamba_step`
// and `ssd_step` in repro/models/layers/ssm.py) is plain jnp. It is the part
// of the port's `apply_mamba_step` (repro_torch/models/layers/ssm.py) between
// the in-projection and the out-projection, for each slot b and head h, with
// g = h / (H / G), W conv taps and T the compute dtype:
//   window  = [conv[b] | xbc[b]]                           (float32, [W, CD])
//   xbc_t   = T(silu(sum_w window[w] * conv_w[w] + conv_b))  only the channels
//             of x (head h), B and C (group g) are formed
//   dt      = softplus(dt_raw[b, h] + dt_bias[h])
//   decay   = exp(dt * -exp(a_log[h]))
//   state   = state * decay + (dt * B) (x) x                  in place, [P, N]
//   y[p]    = state[p] . C + x[p] * d_skip[h]
//   gated   = y * silu(z[b, h P + p])
//   out[b]  = T(gated * rsqrt(mean(gated^2 over d_inner) + eps) * norm_scale)
//   conv[b] = window[1:]                                     in place
// Every float32 operation and rounding to T is where the plain path has it;
// only the order of float32 sums differs (the dot products over N, the
// norm's mean). The conv's four taps are summed as
// fma(x1, w1, x0 w0) + fma(x3, w3, x2 w2), the order cuBLAS takes in the
// plain path's einsum (measured on the H100: identical over 1.35M outputs),
// so that xs, B and C round to T as there.
//
// What bounds it: bytes. The float32 state is [B, H, P, N] (granite-4.0-h at
// 8 slots: 8 x 128 x 64 x 128, 33.5 MB a layer) and is read once and written
// once; the conv window ([B, W-1, CD], 0.8 MB) once each; the rest is under
// 1%. ~68.8 MB a layer is ~20.5 us at 3.35 TB/s; a few hundred FLOPs a state
// row are nothing beside it. The plain ops move the state ~9 times.
//
// Design. Two kernels, in stream order:
//   1. mamba_state_kernel, one CTA of 256 threads per (head, slot), whose
//      [P, N] state is at most TILE floats (granite: 64 rows, 32 KB, 1024
//      CTAs). It issues the head's loads (16-byte, evict-first) into
//      registers before anything else, forms its x channels and silu(z),
//      and its group's B and C channels, in shared memory while they are in
//      flight, then updates the rows, stores them, reduces y over N with
//      warp shuffles (a row is N/4 lanes) and writes the gated y and the
//      head's sum of squares to a float32 scratch.
//   2. mamba_norm_kernel, one thread per channel: the slot's sum of squares
//      over its heads (in a fixed order, so every CTA of a slot gets the
//      same norm), the output in T, and the roll of the window, whose B and
//      C channels every head's CTAs of kernel 1 read: the stream orders the
//      two kernels.
// Measured on the H100 (PERF.md, granite's widths in bf16): kernel 1 takes
// ~26.3 us where a plain copy of the state's bytes takes ~24.3, kernel 2
// ~2.7 us. Kernel 1 holds a head's state in 32 registers a thread, which caps it
// at four CTAs a multiprocessor; three (no cap) were slower, and so were
// staging the state in shared memory by cp.async (a head a CTA, or
// persistent CTAs with the next head in flight), an L2 bulk prefetch ahead
// of the loads, a head cut into CTAs of 8 or 16 KB, and rolling the x channels
// in kernel 1.
// One kernel, whose last CTA of a slot normalises it (an atomic count), took
// 35.8 us: the fence before the count waits for the CTA's state stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;                 // kernel 1
constexpr int MIN_CTAS = 4;                  // kernel 1's CTAs a multiprocessor, at least
constexpr int WARPS = THREADS / 32;
constexpr int VECS = 8;                      // float4 of a tile a thread
constexpr int TILE = THREADS * VECS * 4;     // state floats a head, at most: 8192
constexpr int NMAX = 128;                    // state dim N: a power of two, 4..128
constexpr int PMAX = 256;                    // head dim P
constexpr int WMAX = 8;                      // conv taps
constexpr int NORM_THREADS = 256;            // kernel 2

struct Params {
  const void* z;             // [B, DI] T
  const void* xbc;           // [B, CD] T
  const void* dt_raw;        // [B, H] T
  float* conv;               // [B, W-1, CD]
  float* ssm;                // [B, H, P, N]
  const float* conv_w;       // [W, CD]
  const float* conv_b;       // [CD]
  const float* dt_bias;      // [H]
  const float* a_log;        // [H]
  const float* d_skip;       // [H]
  const float* norm_scale;   // [DI]
  void* out;                 // [B, DI] T
  float* gated;              // [B, DI] scratch
  float* sumsq;              // [B, H] scratch
  int B, H, G, P, N, W, DI, CD;
  float eps;
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// x / (1 + exp(-x)) and the softplus at beta 1, threshold 20: PyTorch's
// float formulas on the card.
__device__ __forceinline__ float silu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));
}

__device__ __forceinline__ float softplus(float v) {
  return v > 20.0f ? v : log1pf(expf(v));
}

// silu(conv + bias) of one channel, rounded to T: `window` and `conv_w`
// point at the channel (rows `cd` apart), `newest` is its input this step;
// the taps are summed in pairs (above). KW taps, or `taps` where KW is 0.
template <typename T, int KW>
__device__ __forceinline__ float conv_silu(const float* window, const float* conv_w,
                                           float bias, float newest, int cd, int taps) {
  const int W = KW > 0 ? KW : taps;
  float acc = 0.0f;
#pragma unroll
  for (int w = 0; w < (KW > 0 ? KW : WMAX); w += 2) {
    if (w >= W) break;
    const float x0 = w < W - 1 ? window[w * cd] : newest;
    float pair = __fmul_rn(x0, conv_w[w * cd]);
    if (w + 1 < W) {
      const float x1 = w + 1 < W - 1 ? window[(w + 1) * cd] : newest;
      pair = fmaf(x1, conv_w[(w + 1) * cd], pair);
    }
    acc = w == 0 ? pair : __fadd_rn(acc, pair);
  }
  return to_f<T>(from_f<T>(silu(__fadd_rn(acc, bias))));
}

template <typename T, int KW>
__global__ void __launch_bounds__(THREADS, MIN_CTAS) mamba_state_kernel(const Params p) {
  __shared__ float s_x[PMAX];                  // x of the head, rounded to T
  __shared__ float s_sz[PMAX];                 // silu(z) of the head
  __shared__ __align__(16) float s_db[NMAX];   // dt * B of the head's group
  __shared__ __align__(16) float s_c[NMAX];    // C of the head's group
  __shared__ float s_sq[WARPS];

  const int head = blockIdx.x;  // b * H + h
  const int b = head / p.H, h = head - b * p.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = p.N, nv = N >> 2, shift = __ffs(nv) - 1;
  const int rows = p.P, total = rows * nv;
  float4* tile = reinterpret_cast<float4*>(p.ssm + (int64_t)head * rows * N);

  // The head's loads first: the channels below are formed under them.
  float4 s[VECS];
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const int e = tid + i * THREADS;
    if (e < total) s[i] = __ldcs(tile + e);
  }

  const int CD = p.CD, c0 = h * rows;  // the head's first x channel (and z column)
  const T* z = static_cast<const T*>(p.z) + (int64_t)b * p.DI + c0;
  const T* xbc = static_cast<const T*>(p.xbc) + (int64_t)b * CD;
  const float* window = p.conv + (int64_t)b * (p.W - 1) * CD;
  const float dt = softplus(
      __fadd_rn(to_f<T>(static_cast<const T*>(p.dt_raw)[head]), p.dt_bias[h]));
  const float decay = expf(__fmul_rn(dt, -expf(p.a_log[h])));
  const int g = h / (p.H / p.G);
  // i in [0, rows): x channels; [rows, rows+N): B; [rows+N, rows+2N): C;
  // [rows+2N, 2 rows+2N): z.
  for (int i = tid; i < 2 * (rows + N); i += THREADS) {
    if (i >= rows + 2 * N) {
      const int j = i - rows - 2 * N;
      s_sz[j] = silu(to_f<T>(z[j]));
      continue;
    }
    const int c = i < rows ? c0 + i
                : i < rows + N ? p.DI + g * N + (i - rows)
                : p.DI + (p.G + g) * N + (i - rows - N);
    const float v = conv_silu<T, KW>(window + c, p.conv_w + c, p.conv_b[c], to_f<T>(xbc[c]),
                                     CD, p.W);
    if (i < rows) s_x[i] = v;
    else if (i < rows + N) s_db[i - rows] = __fmul_rn(dt, v);
    else s_c[i - rows - N] = v;
  }
  __syncthreads();

  const float dsk = p.d_skip[h];
  float* gated = p.gated + (int64_t)b * p.DI + c0;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const int e = tid + i * THREADS;
    const int row = e >> shift, v = e & (nv - 1);
    float part_y = 0.0f;
    if (e < total) {
      const float xr = s_x[row];
      const float4 db = reinterpret_cast<const float4*>(s_db)[v];
      const float4 cc = reinterpret_cast<const float4*>(s_c)[v];
      float4 st = s[i];
      st.x = __fadd_rn(__fmul_rn(st.x, decay), __fmul_rn(db.x, xr));
      st.y = __fadd_rn(__fmul_rn(st.y, decay), __fmul_rn(db.y, xr));
      st.z = __fadd_rn(__fmul_rn(st.z, decay), __fmul_rn(db.z, xr));
      st.w = __fadd_rn(__fmul_rn(st.w, decay), __fmul_rn(db.w, xr));
      __stcs(tile + e, st);
      part_y = fmaf(st.w, cc.w, fmaf(st.z, cc.z, fmaf(st.y, cc.y, st.x * cc.x)));
    }
    // A row is nv aligned lanes; a warp with no live element skips (uniform).
    if (i * THREADS + warp * 32 < total) {
      for (int off = nv >> 1; off > 0; off >>= 1)
        part_y += __shfl_xor_sync(0xffffffffu, part_y, off);
    }
    if (e < total && v == 0) {
      const float y = __fadd_rn(part_y, __fmul_rn(s_x[row], dsk));
      const float gv = __fmul_rn(y, s_sz[row]);
      gated[row] = gv;
      sq = fmaf(gv, gv, sq);
    }
  }
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (lane == 0) s_sq[warp] = sq;
  __syncthreads();
  if (tid == 0) {
    float tile_sq = 0.0f;
    for (int w = 0; w < WARPS; ++w) tile_sq += s_sq[w];
    p.sumsq[head] = tile_sq;
  }
}

template <typename T>
__global__ void __launch_bounds__(NORM_THREADS) mamba_norm_kernel(const Params p) {
  constexpr int NORM_WARPS = NORM_THREADS / 32;
  __shared__ float s_sq[NORM_WARPS];
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * NORM_THREADS + tid;
  const int CD = p.CD, W = p.W;

  // This thread's loads first, then the slot's sum of squares over its heads
  // (in the same order in every CTA): one round trip to L2, not two.
  const int64_t at = (int64_t)b * p.DI + i;
  const bool has_out = i < p.DI;
  const float gv = has_out ? p.gated[at] : 0.0f, scale = has_out ? p.norm_scale[i] : 0.0f;
  float* window = p.conv + (int64_t)b * (W - 1) * CD + i;
  float shifted[WMAX - 2];
  float newest = 0.0f;
  if (i < CD) {
#pragma unroll
    for (int w = 0; w < WMAX - 2; ++w)
      if (w + 2 < W) shifted[w] = window[(w + 1) * CD];
    newest = to_f<T>(static_cast<const T*>(p.xbc)[(int64_t)b * CD + i]);
  }
  float sq = 0.0f;
  for (int k = tid; k < p.H; k += NORM_THREADS) sq += p.sumsq[(int64_t)b * p.H + k];
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (lane == 0) s_sq[warp] = sq;
  __syncthreads();
  float total_sq = 0.0f;
  for (int w = 0; w < NORM_WARPS; ++w) total_sq += s_sq[w];
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(total_sq, (float)p.DI), p.eps));

  if (has_out) static_cast<T*>(p.out)[at] = from_f<T>(__fmul_rn(__fmul_rn(gv, r), scale));
  if (i < CD) {
#pragma unroll
    for (int w = 0; w < WMAX - 2; ++w)
      if (w + 2 < W) window[w * CD] = shifted[w];
    window[(W - 2) * CD] = newest;
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t st) {
  if (p.W == 4) mamba_state_kernel<T, 4><<<p.B * p.H, THREADS, 0, st>>>(p);
  else mamba_state_kernel<T, 0><<<p.B * p.H, THREADS, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mamba_norm_kernel<T><<<dim3((p.CD + NORM_THREADS - 1) / NORM_THREADS, p.B), NORM_THREADS, 0,
                         st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the first failed launch (0 on success).
// dtype (of z, xbc, dt_raw and out): 0 float32, 1 bfloat16. Every tensor is
// contiguous, the state 16-byte aligned; the float32 parameters are
// contiguous too. `scratch` holds B * H * (P + 1) floats: the gated y and
// the heads' sums of squares.
int mamba_step_fwd(const void* z, const void* xbc, const void* dt_raw, void* conv, void* ssm,
                   const void* conv_w, const void* conv_b, const void* dt_bias,
                   const void* a_log, const void* d_skip, const void* norm_scale, void* out,
                   void* scratch, int B, int H, int G, int P, int N, int W, float eps,
                   int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P > PMAX ||
      N < 4 || N > NMAX || (N & (N - 1)) != 0 || P * N > TILE || W < 2 || W > WMAX ||
      (int64_t)B * H > 0x7fffffff ||
      (int64_t)(W - 1) * (H * P + 2 * G * N) > 0x7fffffff ||
      reinterpret_cast<uintptr_t>(ssm) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.z = z; p.xbc = xbc; p.dt_raw = dt_raw;
  p.conv = static_cast<float*>(conv);
  p.ssm = static_cast<float*>(ssm);
  p.conv_w = static_cast<const float*>(conv_w);
  p.conv_b = static_cast<const float*>(conv_b);
  p.dt_bias = static_cast<const float*>(dt_bias);
  p.a_log = static_cast<const float*>(a_log);
  p.d_skip = static_cast<const float*>(d_skip);
  p.norm_scale = static_cast<const float*>(norm_scale);
  p.out = out;
  p.gated = static_cast<float*>(scratch);
  p.sumsq = p.gated + (int64_t)B * H * P;
  p.B = B; p.H = H; p.G = G; p.P = P; p.N = N; p.W = W;
  p.DI = H * P;
  p.CD = H * P + 2 * G * N;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}

const char* mamba_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
