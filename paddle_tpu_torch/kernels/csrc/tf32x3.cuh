// float32-accurate products on the TF32 tensor cores (sm_80 and later), the
// "3xTF32" scheme: each float32 operand x is split into big = tf32(x) and
// small = x - big, and a product a . b is summed as a_small . b_big + a_big
// . b_small + a_big . b_big in float32 (a_small . b_small, about 2^-22 of
// |a b|, is dropped). tf32 keeps 10 explicit mantissa bits, so big is
// within 2^-11 of x, and the tensor core reads small to 10 bits as well:
// big + small is within 2^-21 of x, and a product's relative error is
// about 2^-20, against 2^-11 for one TF32 product. Used by the float32
// flash forward and backward (flash_fwd_f32.cu, flash_bwd_f32.cu) through
// flash_f32_tiles.cuh.
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, for lane
// l of the warp with g = l / 4 and t = l % 4, as (row, column):
//   A (16 x 8):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):   b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// An operand register holds a float32 bit pattern; the tensor core reads its
// sign, exponent and top 10 mantissa bits and ignores the 13 below.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// x = big + small: big is x rounded to tf32, to nearest with ties away from
// zero (the rounding of cvt.rna.tf32.f32, which sm_90a compiles to a guard,
// an add and a select; here an add and a mask, two instructions), and small
// = x - big exactly, which the tensor core truncates to tf32. A NaN x may
// wrap big, but small stays NaN and carries it into the product.
__device__ inline void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a . b for one m16n8k8 tile (fragments as laid out above)
__device__ inline void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                           uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b to float32 accuracy: the two small cross terms first, then
// big . big, into the same float32 accumulator. a_big/a_small are A
// fragments (a0..a3), b_big/b_small B fragments (b0, b1), of the split
// halves of the same operands.
__device__ inline void mma_tf32x3(float (&c)[4], const uint32_t (&a_big)[4],
                                  const uint32_t (&a_small)[4],
                                  const uint32_t (&b_big)[2],
                                  const uint32_t (&b_small)[2]) {
  mma(c, a_small, b_big[0], b_big[1]);
  mma(c, a_big, b_small[0], b_small[1]);
  mma(c, a_big, b_big[0], b_big[1]);
}

}  // namespace tf32x3
