// Ragged paged attention over int8 K/V code pages with bfloat16 scale
// pools, each scale widened to float32 as the page is staged; unsplit and
// with the flash-decode KV split (see ragged_attention.cuh). Replaces the
// quantized branch of paddle_tpu/kernels/paged_attention.py::
// _ragged_kernel and ::_ragged_split_kernel for int8 pages whose scales
// are stored in bfloat16 (ks_ref[0].astype(jnp.float32) there).
#include "ragged_attention.cuh"

// the page type, named once: the macro takes no comma in its argument
using Pages = paged::Scaled<int8_t, __nv_bfloat16>;
RAGGED_ATTENTION_ENTRY(ragged_attention_int8_bf16, Pages)
