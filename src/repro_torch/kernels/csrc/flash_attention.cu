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
// transposes are needed around the call. D is 64 or 128; bf16 or float32.
//
// Design: one CTA of 256 threads per (64-row q tile, head, batch). The Q
// tile lives in shared memory for the whole CTA; the CTA loops over 64-key
// K/V tiles, staging each in shared memory as float32, and keeps the
// online-softmax state in registers. Each thread owns a 4x4 block of the
// 64x64 score tile (rows ty+16i, columns tx+16j) and 4 x D/16 entries of
// the output accumulator; the 16 threads that share a row reduce its max
// and sum with warp shuffles. Causal tiles entirely above the diagonal are
// never visited; the ragged key edge is masked. Shared-memory rows are
// padded by one float so the column-strided reads hit distinct banks.
//
// What bounds it: at the serving path's shapes (B=1, H=9, KV=3, D=64,
// S=T=64..512) one call moves at most ~1.6 MB and does ~0.3 GFLOP, so
// its least time on an H100 is well under a microsecond; a call is bound
// by launch latency and by having only ceil(S/64)*H CTAs (72 at S=512)
// for 132 SMs, not by bytes or FLOPs. This first version does its
// arithmetic in float32 on the CUDA cores, like the Pallas body, and makes
// no use of wgmma or TMA; those, and splitting the key loop to fill the
// card, are for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per CTA
constexpr int BN = 64;        // keys per K/V tile
constexpr int THREADS = 256;  // 16 x 16 threads
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
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // Qs [BM][D+1], Ks [BN][D+1], Vs [BN][D], Ps [BM][BN+1], all float32.
  return sizeof(float) * (BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
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

  const T* qp = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* kp = static_cast<const T*>(p.k) + b * p.skb + kh * p.skh;
  const T* vp = static_cast<const T*>(p.v) + b * p.svb + kh * p.svh;
  T* op = static_cast<T*>(p.o) + b * p.sob + h * p.soh;

  // The Q tile, once. Rows past S read as zero and are never stored.
  for (int i = tid; i < BM * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    Qs[r * (D + 1) + d] = row < p.S ? to_f32(qp[row * p.sqs + d]) : 0.f;
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
      Ks[r * (D + 1) + d] = ok ? to_f32(kp[col * p.sks + d]) : 0.f;
      Vs[r * D + d] = ok ? to_f32(vp[col * p.svs + d]) : 0.f;
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
      op[row * p.sos + tx + 16 * c] = from_f32<T>(acc[i][c] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + BM - 1) / BM, p.H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). dtype: 0 float32,
// 1 bfloat16. Strides are in elements.
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return (int)launch<float, 64>(p, B, st);
  if (dtype == 0 && D == 128) return (int)launch<float, 128>(p, B, st);
  if (dtype == 1 && D == 64) return (int)launch<__nv_bfloat16, 64>(p, B, st);
  if (dtype == 1 && D == 128) return (int)launch<__nv_bfloat16, 128>(p, B, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
