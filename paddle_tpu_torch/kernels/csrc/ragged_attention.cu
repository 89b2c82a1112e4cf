// Ragged paged attention over float32 K/V pages, unsplit and with the
// flash-decode KV split (the kernels and their design notes are in
// ragged_attention.cuh). Replaces the float variants of
// paddle_tpu/kernels/paged_attention.py::_ragged_kernel and
// ::_ragged_split_kernel.
#include "ragged_attention.cuh"

RAGGED_ATTENTION_ENTRY(ragged_attention_f32, float)
