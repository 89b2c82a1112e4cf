// Asynchronous copies from global to shared memory (sm_80 and later),
// shared by the kernels that stage tiles in a ring: the bf16 flash forward
// (flash_fwd_bf16.cu) and backward (flash_bwd_bf16.cu), the float32 ones
// (flash_fwd_f32.cu, flash_bwd_f32.cu, through flash_f32_tiles.cuh) and the
// mixed chunk/verify kernel (mixed_attention.cu). A copy issued now lands while
// the block computes on an earlier tile; wait<N>() returns once at most N
// committed groups are still in flight, and a __syncthreads() after it
// makes the data visible to the whole block.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cpasync {

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst (both 16-byte aligned); when !in, dst is
// zero-filled and src is not read
__device__ inline void copy16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

// 4 bytes from src to dst (both 4-byte aligned); when !in, dst is
// zero-filled and src is not read
__device__ inline void copy4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

// close the group of copies this thread issued since the last commit
__device__ inline void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ inline void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace cpasync
