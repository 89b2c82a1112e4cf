// Flash attention backward for sm_90a, bf16 inputs, head_dim 64 or 128,
// behind the plain C entries flash_bwd_dkdv_bf16 and flash_bwd_dq_bf16: the
// kernels of flash_bwd_16.cuh (which says what they replace, compute and
// how) on bf16 operands.
#include <cuda_bf16.h>
#define FLASH_ELEM __nv_bfloat16
#define FLASH_SUFFIX bf16
#include "flash_bwd_16.cuh"
