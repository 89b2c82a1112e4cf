// Flash attention forward for sm_90a, bf16 inputs, head_dim 64 or 128,
// behind the plain C entry flash_fwd_bf16: the kernel of flash_fwd_16.cuh
// (which says what it replaces, computes and how) on bf16 operands.
#include <cuda_bf16.h>
#define FLASH_ELEM __nv_bfloat16
#define FLASH_SUFFIX bf16
#include "flash_fwd_16.cuh"
