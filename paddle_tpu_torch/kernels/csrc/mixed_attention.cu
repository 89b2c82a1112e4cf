// Mixed (chunk / verify) paged attention for sm_90a: a block of T query
// tokens per slot attends that slot's float32 K/V pages causally
// through its page-table row.
//
// Replaces paddle_tpu/kernels/paged_attention.py::_mixed_kernel,
// reached through mixed_attention_pallas, the attention of the per-tier
// chunk-prefill graph (lm_chunk_prefill: one slot, T = chunk width) and
// of the speculative verify graph (lm_verify: every slot, T = 1 +
// drafts). Semantics, as there: q [B, T, H, D], pools [P, page, H, D],
// page_table [B, pages_per_seq], seq_lens [B] post-append lengths,
// q_lens [B]; query t of slot b sits at position seq_lens[b] - q_lens[b]
// + t and sees every key position <= its own and < seq_lens[b]. Rows
// t >= q_lens[b] are padding: their position lies past seq_len, so only
// the < seq_len mask binds and they attend the whole context (they are
// not zeroed, unlike the ragged kernel's padding). A slot with seq_len
// 0 outputs exactly 0 on every row (the l == 0 guard).
//
// Bound. At the chunk shape (one slot, 512 queries after 512 resident
// tokens, GPT-2-small heads) the work is 4 * D float32 operations per
// visible (query, key) pair and head, ~1.2 GFLOP against ~9 MB of K, V,
// q and out: bound by float32 operations (0.018 ms at 67 TFLOP/s). At
// the verify shape (eight slots of 1 + 4 tokens) it streams each slot's
// pages once per query tile and is bound by their bytes.
//
// Design. The Pallas kernel walks a slot's pages as a sequential grid
// axis with a [T * H, D] state in VMEM. Here one block owns one (tile
// of kTQ query rows, head, slot) and walks only the pages the tile's
// last row can see (never past seq_len), split across its warps with
// the fixed-order merge of paged_walk.cuh; each output row has one
// writer, no atomics, and reruns are bit-identical. Tensor cores, TMA
// and a copy pipeline are later work.
#include "paged_walk.cuh"

namespace {

constexpr int kTQ = 16;        // query rows of one slot per block
constexpr int kWarps = 4;      // warps per block, striding the page walk

struct MixedParams {
  const float* q;            // [B, T, H, D]
  paged::Pools<float> pools;
  const int* page_table;     // [B, pages_per_seq]
  const int* seq_lens;       // [B]
  const int* q_lens;         // [B]
  float* out;                // [B, T, H, D]
  int T, pages_per_seq;
  float sm_scale;
};

template <int DPL>
__global__ void __launch_bounds__(kWarps * 32)
mixed_attention_kernel(const MixedParams a) {
  const int H = a.pools.H, D = a.pools.D;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * kTQ;
  const int nq = min(kTQ, a.T - t0);
  const int seq_len = a.seq_lens[b];
  const int pos0 = seq_len - a.q_lens[b] + t0;   // row t0's position
  // keys the tile can see: up to its last row's position, below seq_len
  const int n_pages = paged::visible_pages(min(seq_len, pos0 + nq),
                                           a.pools.page_size,
                                           a.pages_per_seq);
  const size_t row0 = ((size_t)b * a.T + t0) * H + h;   // (b, t0, h)
  extern __shared__ float smem[];
  paged::attend_tile<float, kTQ, kWarps, DPL>(
      a.pools, a.page_table + (size_t)b * a.pages_per_seq, h,
      a.q + row0 * D, (size_t)H * D, a.sm_scale, nq, pos0, seq_len, 0,
      n_pages, smem,
      [&](int i, int d, float, float lt, float at) {
        a.out[(row0 + (size_t)i * H) * D + d] = lt == 0.f ? 0.f : at / lt;
      });
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() after the launch
// (0 = cudaSuccess). Takes D <= 128 and page_size <= 32; every output
// element is written.
extern "C" int mixed_attention_f32(const float* q, const float* k_pool,
                                   const float* v_pool,
                                   const int* page_table,
                                   const int* seq_lens, const int* q_lens,
                                   float* out, int B, int T, int H, int D,
                                   int page_size, int pages_per_seq,
                                   float sm_scale, void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  if (D < 1 || D > 128 || page_size < 1 || page_size > 32
      || pages_per_seq < 1 || H < 1 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const MixedParams a{q, {k_pool, v_pool, nullptr, nullptr, H, D, page_size},
                      page_table, seq_lens, q_lens, out, T, pages_per_seq,
                      sm_scale};
  const dim3 grid((T + kTQ - 1) / kTQ, H, B);
  const size_t smem =
      (size_t)paged::smem_floats(kWarps, kTQ, D, page_size) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = kWarps * 32;
  switch ((D + 31) / 32) {
    case 1: return (int)paged::launch(mixed_attention_kernel<1>, grid,
                                      threads, smem, s, a);
    case 2: return (int)paged::launch(mixed_attention_kernel<2>, grid,
                                      threads, smem, s, a);
    case 3: return (int)paged::launch(mixed_attention_kernel<3>, grid,
                                      threads, smem, s, a);
    default: return (int)paged::launch(mixed_attention_kernel<4>, grid,
                                       threads, smem, s, a);
  }
}
