// Mamba-2 chunked SSD scan (forward) for Hopper, written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_scan_bhsd` in
// repro/kernels/ssd_scan.py (reached through `ssd_scan` in
// repro/kernels/ops.py, which pre-scales xdt = x * dt and da = dt * A).
//
// For each (b, h), with g = h / (H / G), the chunks of Q rows are walked
// in order with cum the in-chunk prefix sum of da:
//   y[l]  = sum_{s <= l} (C[l] . B[s]) exp(cum[l] - cum[s]) xdt[s]
//           + exp(cum[l]) C[l] . state^T
//   state = state exp(cum[Q-1]) + sum_s exp(cum[Q-1] - cum[s]) xdt[s] (x) B[s]
// The state is a float32 [P, N] matrix that starts at zero. xdt, da and y
// are float32; B and C are float32 or bfloat16 (converted on load). All
// arithmetic is float32 on the CUDA cores (no TF32), so the kernel path
// and the plain path agree in float32.
//
// Design. The TPU kernel carries the state in VMEM scratch across a
// sequential grid axis. On the card no state carries between blocks, so
// one CTA of 256 threads owns one (b, h) and loops over the chunks
// itself, with the state kept transposed ([N][P]) in shared memory. Inside
// a chunk the Q x Q decay-masked product is tiled like a causal attention
// without softmax: 64 output rows at a time, and for each, 32 source rows
// at a time at or below the diagonal. Four small products, each a
// register-tiled loop over shared-memory tiles read as float4:
//   (a) scores C . B^T (64 x 32, over N), masked and decayed, stored S^T;
//   (b) y += S . xdt (64 x P, over the 32 source rows);
//   (c) y  = exp(cum) * C . state^T (64 x P, over N), before (b);
//   (d) state^T += B^T . (xdt * decay) (N x P, over the chunk's rows).
// The ragged last chunk (S not a multiple of Q) and sizes below the
// tile (P < 64, N < 128, Q < 64) are masked or zero-filled in the loads:
// there are no padding copies like the Pallas wrapper's `jnp.pad`. Any
// strides are taken with a contiguous last dimension, so the model
// layout [B, S, H, P] reaches the kernel without a transpose. The prefix
// sum is taken by one thread in order, as `jnp.cumsum` on the host.
//
// What bounds it: operations. At B=2, S=4096, H=80, P=64, N=128, Q=256 the
// least work is ~32.5 GFLOP against ~342 MB of inputs and output, so on an
// H100 (67 TFLOP/s float32 on the CUDA cores, 3.35 TB/s) its floor is
// ~0.49 ms by operations against ~0.10 ms by bytes. Register tiles of
// 4 x 4 to 8 x 4 per thread, read from shared memory as float4, keep the
// FMA units fed; 104 KB of shared memory per CTA lets two CTAs share an
// SM. Not done yet: tensor cores (mma/wgmma in tf32x3 or bf16 splits),
// C . B^T computed once per group instead of once per head, splitting
// P or the chunks across CTAs for more parallelism, TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16 thread grid (ty, tx)
constexpr int PMAX = 64;      // head dim P, at most
constexpr int NMAX = 128;     // state dim N, at most
constexpr int QMAX = 256;     // chunk Q, at most
constexpr int RB = 64;        // output rows per row block
constexpr int SB = 32;        // source rows per column block
constexpr int LDN = NMAX + 4; // C and B tiles: [rows][LDN]
constexpr int LDP = PMAX + 4; // xdt tile [SB][LDP], state^T [NMAX][LDP]
constexpr int LDT = RB + 4;   // score tile S^T: [SB][LDT]

constexpr int STATE_FLOATS = NMAX * LDP;
constexpr int CTILE_FLOATS = RB * LDN;
constexpr int BTILE_FLOATS = SB * LDN;
constexpr int XTILE_FLOATS = SB * LDP;
constexpr int STILE_FLOATS = SB * LDT;
constexpr size_t SMEM_BYTES =
    sizeof(float) * (STATE_FLOATS + CTILE_FLOATS + BTILE_FLOATS + XTILE_FLOATS +
                     STILE_FLOATS + 3 * QMAX);

struct Params {
  const float* xdt;  // [B, H, S, P]
  const float* da;   // [B, H, S]
  const void* b;     // [B, G, S, N]
  const void* c;     // [B, G, S, N]
  float* y;          // [B, H, S, P]
  int H, G, S, P, N, Q;
  int64_t sxb, sxh, sxs;  // element strides; each last dimension is contiguous
  int64_t sab, sah, sas;
  int64_t sbb, sbg, sbs;
  int64_t scb, scg, scs;
  int64_t syb, syh, sys;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// rows x NMAX tile of a [S, N] slab (row stride `stride`), zeros past
// `valid` rows and past N columns.
template <typename T>
__device__ __forceinline__ void load_n_tile(float* dst, const T* src, int64_t stride,
                                            int rows, int valid, int N, int tid) {
  for (int i = tid; i < rows * NMAX; i += THREADS) {
    const int r = i / NMAX, n = i % NMAX;
    dst[r * LDN + n] = (r < valid && n < N) ? to_f32(src[r * stride + n]) : 0.f;
  }
}

// SB x PMAX tile of xdt, zeros past `valid` rows and past P columns.
__device__ __forceinline__ void load_x_tile(float* dst, const float* src, int64_t stride,
                                            int valid, int P, int tid) {
  for (int i = tid; i < SB * PMAX; i += THREADS) {
    const int r = i / PMAX, p = i % PMAX;
    dst[r * LDP + p] = (r < valid && p < P) ? src[r * stride + p] : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) ssd_scan_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* state_t = smem;                       // [NMAX][LDP]  state^T
  float* ctile = state_t + STATE_FLOATS;       // [RB][LDN]    C rows
  float* btile = ctile + CTILE_FLOATS;         // [SB][LDN]    B rows
  float* xtile = btile + BTILE_FLOATS;         // [SB][LDP]    xdt rows
  float* stile = xtile + XTILE_FLOATS;         // [SB][LDT]    masked scores, transposed
  float* cum = stile + STILE_FLOATS;           // [QMAX]       prefix sum of da
  float* ecum = cum + QMAX;                    // [QMAX]       exp(cum), 0 past the chunk
  float* eend = ecum + QMAX;                   // [QMAX]       exp(cum[q-1] - cum)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int n4 = (p.N + 3) & ~3;

  const float* xdt = p.xdt + bi * p.sxb + h * p.sxh;
  const float* da = p.da + bi * p.sab + h * p.sah;
  const T* bmat = static_cast<const T*>(p.b) + bi * p.sbb + g * p.sbg;
  const T* cmat = static_cast<const T*>(p.c) + bi * p.scb + g * p.scg;
  float* y = p.y + bi * p.syb + h * p.syh;

  for (int i = tid; i < STATE_FLOATS; i += THREADS) state_t[i] = 0.f;

  for (int c0 = 0; c0 < p.S; c0 += p.Q) {
    const int q = min(p.Q, p.S - c0);

    // -- prefix sum of da over the chunk, in order ------------------------------
    __syncthreads();  // the previous chunk is done with cum/ecum/eend and state_t
    for (int i = tid; i < QMAX; i += THREADS) cum[i] = i < q ? da[(c0 + i) * p.sas] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < q; ++i) {
        run += cum[i];
        cum[i] = run;
      }
      for (int i = q; i < QMAX; ++i) cum[i] = run;
    }
    __syncthreads();
    const float cum_last = cum[q - 1];
    for (int i = tid; i < QMAX; i += THREADS) {
      ecum[i] = i < q ? expf(cum[i]) : 0.f;
      eend[i] = i < q ? expf(cum_last - cum[i]) : 0.f;
    }

    // -- outputs, 64 rows at a time -----------------------------------------------
    for (int l0 = 0; l0 < q; l0 += RB) {
      const int lrows = min(RB, q - l0);
      __syncthreads();  // ctile free; ecum/eend written
      load_n_tile(ctile, cmat + (int64_t)(c0 + l0) * p.scs, p.scs, RB, lrows, p.N, tid);
      __syncthreads();

      // (c) acc[i][j] = exp(cum[l]) * sum_n C[l][n] state[p][n], rows l = ty*4+i,
      // columns p = tx*4+j. The state is zero in the first chunk.
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      if (c0 > 0) {
#pragma unroll 2
        for (int n = 0; n < n4; n += 4) {
          float4 cv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = ld4(ctile + (ty * 4 + i) * LDN + n);
          const float4 s0 = ld4(state_t + (n + 0) * LDP + tx * 4);
          const float4 s1 = ld4(state_t + (n + 1) * LDP + tx * 4);
          const float4 s2 = ld4(state_t + (n + 2) * LDP + tx * 4);
          const float4 s3 = ld4(state_t + (n + 3) * LDP + tx * 4);
          const float sv[4][4] = {{s0.x, s0.y, s0.z, s0.w}, {s1.x, s1.y, s1.z, s1.w},
                                  {s2.x, s2.y, s2.z, s2.w}, {s3.x, s3.y, s3.z, s3.w}};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float cc[4] = {cv[i].x, cv[i].y, cv[i].z, cv[i].w};
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cc[k], sv[k][j], acc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = ecum[l0 + ty * 4 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] *= e;
        }
      }

      // Source blocks at or below the diagonal of this row block.
      for (int s0 = 0; s0 < l0 + lrows; s0 += SB) {
        const int srows = min(SB, q - s0);
        __syncthreads();  // btile/xtile/stile free
        load_n_tile(btile, bmat + (int64_t)(c0 + s0) * p.sbs, p.sbs, SB, srows, p.N, tid);
        load_x_tile(xtile, xdt + (int64_t)(c0 + s0) * p.sxs, p.sxs, srows, p.P, tid);
        __syncthreads();

        // (a) scores for rows l = ty*4+i and source columns s = tx+16j.
        float sc[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 2
        for (int n = 0; n < n4; n += 4) {
          float4 cv[4], bv[2];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = ld4(ctile + (ty * 4 + i) * LDN + n);
#pragma unroll
          for (int j = 0; j < 2; ++j) bv[j] = ld4(btile + (tx + 16 * j) * LDN + n);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              sc[i][j] = fmaf(cv[i].x, bv[j].x, sc[i][j]);
              sc[i][j] = fmaf(cv[i].y, bv[j].y, sc[i][j]);
              sc[i][j] = fmaf(cv[i].z, bv[j].z, sc[i][j]);
              sc[i][j] = fmaf(cv[i].w, bv[j].w, sc[i][j]);
            }
        }
        // Decay exp(cum[l] - cum[s]) where s <= l < q, else 0; store transposed.
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int s = s0 + tx + 16 * j;
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int l = l0 + ty * 4 + i;
            v[i] = (s <= l && l < q) ? sc[i][j] * expf(cum[l] - cum[s]) : 0.f;
          }
          *reinterpret_cast<float4*>(stile + (tx + 16 * j) * LDT + ty * 4) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
        __syncthreads();

        // (b) acc[i][j] += sum_s S[l][s] xdt[s][p], rows l = ty*4+i, columns p = tx*4+j.
#pragma unroll 4
        for (int s = 0; s < SB; ++s) {
          const float4 a = ld4(stile + s * LDT + ty * 4);
          const float4 x = ld4(xtile + s * LDP + tx * 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + ty * 4 + i;
        if (l < q) {
          float* row = y + (int64_t)(c0 + l) * p.sys;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = tx * 4 + j;
            if (col < p.P) row[col] = acc[i][j];
          }
        }
      }
    }

    // -- state update (not needed after the last chunk: no final state is returned)
    if (c0 + p.Q >= p.S) break;
    // (d) state^T[n][p] = state^T[n][p] exp(cum[q-1]) + sum_s B[s][n] xdt[s][p] eend[s],
    // rows n = ty*8+i, columns p = tx*4+j; each thread reads and writes only its own.
    float st[8][4];
    const float chunk_decay = expf(cum_last);
    __syncthreads();  // every read of state_t in (c) is done
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 o = ld4(state_t + (ty * 8 + i) * LDP + tx * 4);
      st[i][0] = o.x * chunk_decay;
      st[i][1] = o.y * chunk_decay;
      st[i][2] = o.z * chunk_decay;
      st[i][3] = o.w * chunk_decay;
    }
    for (int s0 = 0; s0 < q; s0 += SB) {
      const int srows = min(SB, q - s0);
      __syncthreads();
      load_n_tile(btile, bmat + (int64_t)(c0 + s0) * p.sbs, p.sbs, SB, srows, p.N, tid);
      load_x_tile(xtile, xdt + (int64_t)(c0 + s0) * p.sxs, p.sxs, srows, p.P, tid);
      __syncthreads();
#pragma unroll 4
      for (int s = 0; s < SB; ++s) {
        const float d = eend[s0 + s];
        const float4 x = ld4(xtile + s * LDP + tx * 4);
        const float xv[4] = {x.x * d, x.y * d, x.z * d, x.w * d};
        const float4 b0 = ld4(btile + s * LDN + ty * 8);
        const float4 b1 = ld4(btile + s * LDN + ty * 8 + 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) st[i][j] = fmaf(bv[i], xv[j], st[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(state_t + (ty * 8 + i) * LDP + tx * 4) =
          make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(p.H, B);
  ssd_scan_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). bc_dtype: 0 float32,
// 1 bfloat16. Strides are in elements; each last dimension is contiguous.
int ssd_scan_fwd(const void* xdt, const void* da, const void* b, const void* c, void* y,
                 int B, int H, int G, int S, int P, int N, int Q,
                 int64_t sxb, int64_t sxh, int64_t sxs,
                 int64_t sab, int64_t sah, int64_t sas,
                 int64_t sbb, int64_t sbg, int64_t sbs,
                 int64_t scb, int64_t scg, int64_t scs,
                 int64_t syb, int64_t syh, int64_t sys,
                 int bc_dtype, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || S <= 0 || P <= 0 || N <= 0 || Q <= 0 ||
      H % G != 0 || P > PMAX || N > NMAX || Q > QMAX || B > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xdt = static_cast<const float*>(xdt);
  p.da = static_cast<const float*>(da);
  p.b = b;
  p.c = c;
  p.y = static_cast<float*>(y);
  p.H = H; p.G = G; p.S = S; p.P = P; p.N = N; p.Q = Q;
  p.sxb = sxb; p.sxh = sxh; p.sxs = sxs;
  p.sab = sab; p.sah = sah; p.sas = sas;
  p.sbb = sbb; p.sbg = sbg; p.sbs = sbs;
  p.scb = scb; p.scg = scg; p.scs = scs;
  p.syb = syb; p.syh = syh; p.sys = sys;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0) return (int)launch<float>(p, B, st);
  if (bc_dtype == 1) return (int)launch<__nv_bfloat16>(p, B, st);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
