// Ragged paged attention over fp8 (e4m3) K/V code pages with float16 scale
// pools, each scale widened to float32 as the page is staged; unsplit and
// with the flash-decode KV split (see ragged_attention.cuh). Replaces the
// quantized branch of paddle_tpu/kernels/paged_attention.py::
// _ragged_kernel and ::_ragged_split_kernel for fp8 (e4m3) pages whose scales
// are stored in float16 (ks_ref[0].astype(jnp.float32) there).
#include "ragged_attention.cuh"

// the page type, named once: the macro takes no comma in its argument
using Pages = paged::Scaled<__nv_fp8_e4m3, __half>;
RAGGED_ATTENTION_ENTRY(ragged_attention_fp8_f16, Pages)
