// Flash attention backward for sm_90a, float16 inputs, head_dim 64 or 128,
// behind the plain C entries flash_bwd_dkdv_f16 and flash_bwd_dq_f16: the
// kernels of flash_bwd_16.cuh on float16 operands (mma.sync m16n8k16 .f16,
// float32 sums; p rounded to float16 before P^T dO, dS to float16 before
// dS^T Q and dS K: under a loss scale dS and the gradients can overflow to
// inf where the JAX kernel's do, and GradScaler skips that step). Replaces
// paddle_tpu/kernels/flash_attention.py::_bwd_dkdv_kernel (:167) and
// ::_bwd_dq_kernel (:227) for float16.
#include <cuda_fp16.h>
#define FLASH_ELEM __half
#define FLASH_SUFFIX f16
#include "flash_bwd_16.cuh"
