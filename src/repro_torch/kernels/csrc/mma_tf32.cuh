// Tensor-core products in float32 accuracy ("3xTF32"), shared by the port's kernels.
//
// x = hi + lo, both TF32, and a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi (the
// dropped a_lo b_lo is ~2^-22 of a b). Each product is an m16n8k8 `mma.sync` with float32
// sums. Included by wkv6.cu, flash_attention_fwd.cu, flash_attention_bwd.cu and
// decode_attention.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// x rounded to TF32 (its top 19 bits), to nearest with ties away from zero: the bits of
// cvt.rna.tf32.f32 for every finite x, in two integer operations where sm_90 spends about
// ten on the conversion.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct Tf32x2 {
  uint32_t hi, lo;
};

__device__ __forceinline__ Tf32x2 split(float x) {
  const uint32_t hi = tf32(x);
  return {hi, tf32(x - __uint_as_float(hi))};
}

// d += a b, m16n8k8: a 16 x 8 row-major, b 8 x 8 column-major, float32 sums. Fragments
// (g = lane / 4, q = lane % 4): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4);
// b0 (q, g), b1 (q + 4, g); d0 (g, 2q), d1 (g, 2q + 1), d2 (g + 8, 2q), d3 (g + 8, 2q + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A_EXACT: a has no lo part (bfloat16 values are exact in TF32), so a_lo b_hi is left out.
template <bool A_EXACT>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Tf32x2 (&a)[4],
                                           const Tf32x2 (&b)[2]) {
  if (!A_EXACT) mma_tf32(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

}  // namespace
