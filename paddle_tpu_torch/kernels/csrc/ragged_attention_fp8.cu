// Ragged paged attention over fp8 (e4m3) K/V code pages with float32
// scale pools, dequantized as each page is staged; unsplit and with the
// flash-decode KV split (see ragged_attention.cuh). Replaces the
// quantized branch of paddle_tpu/kernels/paged_attention.py::
// _ragged_kernel and ::_ragged_split_kernel for fp8 pages.
#include "ragged_attention.cuh"

RAGGED_ATTENTION_ENTRY(ragged_attention_fp8, __nv_fp8_e4m3)
