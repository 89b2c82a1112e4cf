// The element type of the 16-bit flash kernels (flash_fwd_16.cuh,
// flash_bwd_16.cuh): bf16 or float16 operands of mma.sync m16n8k16 with
// float32 sums. A library defines FLASH_ELEM (__nv_bfloat16 or __half)
// and FLASH_SUFFIX (bf16 or f16, the suffix of its C entries) before it
// includes a kernel header; everything else is the same code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#define FLASH_CAT_(a, b) a##b
#define FLASH_CAT(a, b) FLASH_CAT_(a, b)
// the C entry `base` of this library's element type, e.g. flash_fwd_bf16
#define FLASH_ENTRY(base) FLASH_CAT(base, FLASH_SUFFIX)

namespace elem16 {

template <typename T>
constexpr bool kHalf = std::is_same<T, __half>::value;

// c += a . b for one m16n8k16 tile, 16-bit in, float32 sums
template <typename T>
__device__ inline void mma(float (&c)[4], const uint32_t (&a)[4],
                           uint32_t b0, uint32_t b1) {
  if constexpr (kHalf<T>) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two floats -> one register of two elements, each rounded to nearest
// even (the lower column in the low half)
template <typename T>
__device__ inline uint32_t pack(float lo, float hi) {
  if constexpr (kHalf<T>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

template <typename T>
__device__ inline T from_float(float x) {
  if constexpr (kHalf<T>) {
    return __float2half_rn(x);
  } else {
    return __float2bfloat16_rn(x);
  }
}

}  // namespace elem16
