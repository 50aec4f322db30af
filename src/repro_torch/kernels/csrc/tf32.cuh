// 3xTF32 on Hopper's tensor cores: the float32 products of flash_attention.cu,
// gmm.cu and ssd_scan.cu.
//
// A float32 operand is split x = hi + lo, hi = x rounded to TF32 and lo = x -
// hi, and a product is hi.hi + hi.lo + lo.hi accumulated in float32 (about
// float32 accuracy; one TF32 product keeps ~3 decimal digits, too few for the
// 1e-4 the plain versions are held to: tests/test_torch_ssd_design.py and
// tests/test_torch_f32_kernel_design.py model both in numpy).
#pragma once

#include <stdint.h>

// Inline functions with external linkage: unused ones draw no warning.

// x = hi + lo with hi = x rounded to TF32 (to nearest, ties away from zero,
// as cvt.rna, in two integer operations) and lo = x - hi exactly. The tensor
// core reads lo's top 19 bits, which leaves ~2^-21 of x out of a product.
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
  lo = x - hi;
}

__device__ __forceinline__ uint32_t fbits(float x) { return __float_as_uint(x); }

// d += a (16x8, row-major) * b (8x8, column-major); tf32 in, float32 sums.
// Fragments (g = lane / 4, t = lane % 4): a = {A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}, d = {D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the A fragment already split (ahi, alo), b0 and b1 raw.
// The two small terms first, then hi.hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], float b0, float b1) {
  float h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(d, ahi, fbits(l0), fbits(l1));
  mma_tf32(d, alo, fbits(h0), fbits(h1));
  mma_tf32(d, ahi, fbits(h0), fbits(h1));
}

// A fragment {a0, a1, a2, a3} split into its hi and lo parts.
__device__ __forceinline__ void split_frag(const float (&a)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float h, l;
    split(a[e], h, l);
    hi[e] = fbits(h);
    lo[e] = fbits(l);
  }
}
