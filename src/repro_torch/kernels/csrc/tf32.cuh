// 3xTF32 products on Hopper's tensor cores (mma.sync m16n8k8), shared by
// mvn_quad.cu, flash_attention.cu and ssd_scan.cu.
//
// A float32 operand a is split into hi, a rounded to TF32 (10 mantissa
// bits, ties away from zero: half a unit of the 13 dropped bits added to
// the magnitude, then those bits cleared), and lo = a - hi, exact, whose
// low 13 bits the TF32 mma ignores. A product is accumulated in float32 as
// lo*hi + hi*lo + hi*hi; lo*lo, about 2^-22 of it, is dropped. That keeps
// float32 accuracy (rtol 1e-5 to 2e-4 against the plain versions) where
// one TF32 pass (about 1e-3) does not. The split is integer work on the
// CUDA cores (cvt.rna.tf32.f32 was slower on the card).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}
// four at once, from floats or from the raw bits ldmatrix delivers
__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&h)[4],
                                       uint32_t (&l)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(v[e], h[e], l[e]);
}
__device__ __forceinline__ void split4(const uint32_t (&bits)[4],
                                       uint32_t (&h)[4], uint32_t (&l)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(bits[e]), h[e], l[e]);
}
// d += a b: a 16 x 8 TF32 (row), b 8 x 8 TF32 (col), d 16 x 8 float32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b in 3xTF32: lo*hi + hi*lo + hi*hi, in that order
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}
// the same, b's fragment packed as (hi b0, hi b1, lo b0, lo b1)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float4 b) {
  mma3(d, ah, al, __float_as_uint(b.x), __float_as_uint(b.y),
       __float_as_uint(b.z), __float_as_uint(b.w));
}
