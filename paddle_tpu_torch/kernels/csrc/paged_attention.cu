// Paged decode attention for sm_90a: one query token per slot attends
// that slot's float32 K/V pages through its page-table row.
//
// Replaces paddle_tpu/kernels/paged_attention.py::_decode_kernel,
// reached through paged_attention_pallas, the attention of the per-tier
// decode graph (lm_decode). Semantics, as there: q [B, H, D], pools
// [P, page, H, D], page_table [B, pages_per_seq], seq_lens [B] the
// post-append lengths; slot b's query sits at position seq_lens[b] - 1
// and sees every key position < seq_lens[b]. A slot with seq_len 0
// outputs exactly 0 (the Pallas kernel's l == 0 guard).
//
// Bound. Every K and V position a slot can see is read once (4 B per
// element), plus q and out; the arithmetic is 4 * D float32 operations
// per (slot, key, head), well under one per byte: the kernel is bound by
// the bytes of the pages it streams (49 MB at eight GPT-2-small slots of
// ~1000 tokens, 0.015 ms at 3.35 TB/s).
//
// Design. The Pallas kernel walks a slot's pages as a sequential grid
// axis and carries the online-softmax state across it. Here one block
// owns one (head, slot) and splits the slot's visible pages across its
// warps (paged_walk.cuh): at eight slots of twelve heads that is only 96
// blocks for 132 SMs, so a block takes 16 warps when their page slices
// fit in shared memory (4 otherwise), and a 1000-token slot's 63 pages
// come to four per warp. The warps merge in fixed order: reruns are
// bit-identical. Tensor cores, TMA and a copy pipeline are later work.
#include "paged_walk.cuh"

namespace {

struct DecodeParams {
  const float* q;            // [B, H, D]
  paged::Pools<float> pools;
  const int* page_table;     // [B, pages_per_seq]
  const int* seq_lens;       // [B]
  float* out;                // [B, H, D]
  int pages_per_seq;
  float sm_scale;
};

template <int WARPS, int DPL>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_kernel(const DecodeParams a) {
  const int H = a.pools.H, D = a.pools.D;
  const int h = blockIdx.x, b = blockIdx.y;
  const int seq_len = a.seq_lens[b];
  const int n_pages = paged::visible_pages(seq_len, a.pools.page_size,
                                           a.pages_per_seq);
  const size_t row = ((size_t)b * H + h) * D;
  float* o = a.out + row;
  extern __shared__ float smem[];
  paged::attend_tile<float, 1, WARPS, DPL>(
      a.pools, a.page_table + (size_t)b * a.pages_per_seq, h, a.q + row,
      (size_t)D, a.sm_scale, 1, seq_len - 1, seq_len, 0, n_pages, smem,
      [&](int, int d, float, float lt, float at) {
        o[d] = lt == 0.f ? 0.f : at / lt;
      });
}

template <int WARPS>
cudaError_t launch_warps(dim3 grid, cudaStream_t s, const DecodeParams& a) {
  const size_t smem = (size_t)paged::smem_floats(
      WARPS, 1, a.pools.D, a.pools.page_size) * sizeof(float);
  switch ((a.pools.D + 31) / 32) {
    case 1: return paged::launch(paged_decode_kernel<WARPS, 1>, grid,
                                 WARPS * 32, smem, s, a);
    case 2: return paged::launch(paged_decode_kernel<WARPS, 2>, grid,
                                 WARPS * 32, smem, s, a);
    case 3: return paged::launch(paged_decode_kernel<WARPS, 3>, grid,
                                 WARPS * 32, smem, s, a);
    default: return paged::launch(paged_decode_kernel<WARPS, 4>, grid,
                                  WARPS * 32, smem, s, a);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() after the launch
// (0 = cudaSuccess). Takes D <= 128 and page_size <= 32; every output
// element is written.
extern "C" int paged_attention_f32(const float* q, const float* k_pool,
                                   const float* v_pool,
                                   const int* page_table,
                                   const int* seq_lens, float* out, int B,
                                   int H, int D, int page_size,
                                   int pages_per_seq, float sm_scale,
                                   void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (D < 1 || D > 128 || page_size < 1 || page_size > 32
      || pages_per_seq < 1 || H < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const DecodeParams a{q, {k_pool, v_pool, nullptr, nullptr, H, D, page_size},
                       page_table, seq_lens, out, pages_per_seq, sm_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, B);
  if (paged::smem_floats(16, 1, D, page_size) * sizeof(float)
      <= (size_t)paged::kMaxSmemBytes)
    return (int)launch_warps<16>(grid, s, a);
  return (int)launch_warps<4>(grid, s, a);
}
