// Flash attention forward for sm_90a, float16 inputs, head_dim 64 or 128,
// behind the plain C entry flash_fwd_f16: the kernel of flash_fwd_16.cuh
// on float16 operands (mma.sync m16n8k16 .f16, float32 sums; p rounded to
// float16 before its product with v). Replaces paddle_tpu/kernels/
// flash_attention.py::_fwd_kernel (:61) for float16, which AMP O2 float16
// training reaches.
#include <cuda_fp16.h>
#define FLASH_ELEM __half
#define FLASH_SUFFIX f16
#include "flash_fwd_16.cuh"
