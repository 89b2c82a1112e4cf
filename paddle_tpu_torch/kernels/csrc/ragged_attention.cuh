// Ragged paged attention over a flat token block, for sm_90a: float32,
// int8 or fp8 (e4m3) K/V pages, unsplit or with the flash-decode KV
// split. Each ragged_attention*.cu instantiates it for one page type.
//
// Replaces paddle_tpu/kernels/paged_attention.py::_ragged_kernel (float
// and quantized branches), reached through ragged_attention_pallas, and
// ::_ragged_split_kernel (float and quantized), reached through
// _ragged_pallas_split. Semantics, as there: row b owns the flat tokens
// [q_starts[b], q_starts[b] + q_lens[b]); token t of row b sits at global
// position kv_lens[b] - q_lens[b] + t and attends to every pool position
// kv_pos with kv_pos < kv_lens[b] and kv_pos <= its own position,
// through row b's page table. A token whose softmax is empty outputs
// exactly 0. Tokens covered by no row are never written: the caller
// hands in a zeroed output, so bucket padding stays exactly 0.
//
// Quantized pages. A code pool holds 1-byte codes [P, page, H, D] and a
// float32 scale pool [P, page, H] holds one scale per position and head.
// When a warp stages a page into shared memory it loads four codes per
// 32-bit word and writes code * scale as float32 — the product
// dequantize_kv forms — so everything after staging is the float path.
//
// Bound. Every resident K and V byte a row can see must be read once
// (codes at 1 B plus 4 B of scale per position and head when
// quantized), plus q and out; the arithmetic is ~4*D float32 flops per
// (query, key) pair outside the tensor cores. At the serving engine's
// decode shapes that is well under one flop per byte, far below the
// H100's ~20 float32 flops per byte of HBM bandwidth: the kernel is
// bound by the bytes of the pages it streams.
//
// Design. The Pallas kernels run a sequential grid and carry one
// online-softmax state per flat token across the whole grid; on a GPU
// that order would serialize. Here every block owns one (q-tile of kTQ
// tokens of row b, head h) and walks only the pages the tile can see (up
// to its last query position), so work follows the ragged token and KV
// counts, and blocks of tiles past their row's q_len exit at once. Inside
// a block the page walk is split across kWarps warps (warp w takes pages
// w, w + kWarps, ...); each warp stages its page's K and V for head h in
// its own shared-memory slice and keeps a float32 online-softmax state
// (m, l, acc) per query in registers. The warps' states merge once at
// the end in fixed warp order. The staging, the walk and the merge are
// paged_walk.cuh's, shared with the decode and mixed kernels.
//
// The KV split. A long row's walk is still one block per (tile, head);
// at decode that is few blocks for 132 SMs. With split_pages = sp the
// grid grows a chunk axis: block (tile, h, b, c) walks only pages
// [c * sp, (c + 1) * sp) of the tile's visible pages and writes its
// merged partial (m, l, acc) to a float32 workspace [n_chunks, N, H,
// D + 2]; a chunk past the tile's last visible key writes the identity
// (NEG_INF, 0, 0) and reads no page. A second kernel merges chunks
// 0 .. n_chunks - 1 in that fixed order with the merge of
// ragged_attention_lax_split and writes acc / (l == 0 ? 1 : l). No
// atomics anywhere: two runs give the same bits. Tensor cores, TMA and
// a deeper copy pipeline are later work.
#pragma once

#include "paged_walk.cuh"

namespace ragged {

using paged::Code;
using paged::kNegInf;

constexpr int kTQ = 16;        // query tokens of one row per block
constexpr int kWarps = 4;      // warps per block, striding the page walk
constexpr int kCombineThreads = 128;

template <typename T>
struct Params {
  const float* q;            // [N, H, D]
  paged::Pools<T> pools;     // [P, page, H, D] (+ scales [P, page, H])
  const int* page_table;     // [B, pages_per_seq]
  const int* kv_lens;        // [B]
  const int* q_starts;
  const int* q_lens;
  float* out;                // [N, H, D], zeroed by the caller
  float* ws;                 // split: [n_chunks, N, H, D + 2]
  int N, pages_per_seq, split_pages, n_chunks;
  float sm_scale;
};

template <typename T, bool kSplit, int DPL>   // DPL = ceil(D / 32)
__global__ void __launch_bounds__(kWarps * 32)
ragged_attention_kernel(const Params<T> a) {
  const int H = a.pools.H, D = a.pools.D, page_size = a.pools.page_size;
  const int h = blockIdx.y;
  const int b = kSplit ? (int)blockIdx.z / a.n_chunks : (int)blockIdx.z;
  const int c = kSplit ? (int)blockIdx.z - b * a.n_chunks : 0;
  const int q_len = a.q_lens[b];
  const int t0 = blockIdx.x * kTQ;
  if (t0 >= q_len) return;                 // idle row or tile past q_len
  const int nq = min(kTQ, q_len - t0);
  const int kv_len = a.kv_lens[b];
  const int tok0 = a.q_starts[b] + t0;     // flat index of tile token 0
  const int pos0 = kv_len - q_len + t0;    // its global position
  // keys the tile can see: positions up to its last query's position
  const int n_pages = paged::visible_pages(min(kv_len, pos0 + nq),
                                           page_size, a.pages_per_seq);
  const int p_begin = kSplit ? c * a.split_pages : 0;
  const int p_end = kSplit ? min(p_begin + a.split_pages, n_pages) : n_pages;
  const int W = D + 2;                     // one (m, l, acc[D]) record

  if (kSplit && p_begin >= p_end) {        // chunk past the visible keys
    for (int e = threadIdx.x; e < nq * W; e += blockDim.x) {
      const int i = e / W, r = e - i * W;
      a.ws[(((size_t)c * a.N + tok0 + i) * H + h) * W + r] =
          r == 0 ? kNegInf : 0.f;
    }
    return;
  }

  extern __shared__ float smem[];
  paged::attend_tile<T, kTQ, kWarps, DPL>(
      a.pools, a.page_table + (size_t)b * a.pages_per_seq, h,
      a.q + ((size_t)tok0 * H + h) * D, (size_t)H * D, a.sm_scale, nq, pos0,
      kv_len, p_begin, p_end, smem,
      [&](int i, int d, float mt, float lt, float at) {
        if (kSplit) {
          float* rec = a.ws + (((size_t)c * a.N + tok0 + i) * H + h) * W;
          if (d == 0) {
            rec[0] = mt;
            rec[1] = lt;
          }
          rec[2 + d] = at;
        } else {
          a.out[((size_t)(tok0 + i) * H + h) * D + d] =
              lt == 0.f ? 0.f : at / lt;
        }
      });
}

// Merge the split's chunk partials in chunk order (the fixed-order
// combine of ragged_attention_lax_split) and normalize.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
ragged_split_combine_kernel(const Params<T> a) {
  const int H = a.pools.H, D = a.pools.D, W = D + 2;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_len = a.q_lens[b];
  const int t0 = blockIdx.x * kTQ;
  if (t0 >= q_len) return;
  const int nq = min(kTQ, q_len - t0);
  const int tok0 = a.q_starts[b] + t0;
  for (int e = threadIdx.x; e < nq * D; e += blockDim.x) {
    const int i = e / D, d = e - i * D;
    float m = kNegInf, l = 0.f, acc = 0.f;
    for (int c = 0; c < a.n_chunks; ++c) {
      const float* rec = a.ws + (((size_t)c * a.N + tok0 + i) * H + h) * W;
      const float mc = rec[0];
      const float m_new = fmaxf(m, mc);
      const float alpha = expf(m - m_new);
      const float beta = expf(mc - m_new);
      l = l * alpha + rec[1] * beta;
      acc = acc * alpha + rec[2 + d] * beta;
      m = m_new;
    }
    a.out[((size_t)(tok0 + i) * H + h) * D + d] =
        acc / (l == 0.f ? 1.f : l);
  }
}

template <typename T, bool kSplit>
cudaError_t launch_dpl(dim3 grid, size_t smem, cudaStream_t s,
                       const Params<T>& a) {
  const int threads = kWarps * 32;
  switch ((a.pools.D + 31) / 32) {
    case 1: return paged::launch(ragged_attention_kernel<T, kSplit, 1>, grid,
                                 threads, smem, s, a);
    case 2: return paged::launch(ragged_attention_kernel<T, kSplit, 2>, grid,
                                 threads, smem, s, a);
    case 3: return paged::launch(ragged_attention_kernel<T, kSplit, 3>, grid,
                                 threads, smem, s, a);
    default: return paged::launch(ragged_attention_kernel<T, kSplit, 4>,
                                  grid, threads, smem, s, a);
  }
}

// The body of every C entry point. Launches on `stream`; returns
// cudaGetLastError() after the launches (0 = cudaSuccess). Takes
// D <= 128 and page_size <= 32; split_pages > 0 selects the KV split
// (the caller decides when it pays: split_active in paged_attention.py),
// which needs `workspace` [n_chunks, N, H, D + 2] with
// n_chunks = ceil(pages_per_seq / split_pages).
template <typename T>
int launch(const float* q, const void* k_pool, const void* v_pool,
           const float* k_scale, const float* v_scale,
           const int* page_table, const int* kv_lens, const int* q_starts,
           const int* q_lens, float* out, float* workspace, int N, int B,
           int H, int D, int page_size, int pages_per_seq, int max_q_len,
           int split_pages, float sm_scale, void* stream) {
  if (B <= 0 || N <= 0 || max_q_len <= 0) return (int)cudaSuccess;
  if (D < 1 || D > 128 || page_size < 1 || page_size > 32
      || pages_per_seq < 1 || H < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (Code<T>::kQuant && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool split = split_pages > 0;
  const int n_chunks = split ? (pages_per_seq + split_pages - 1) / split_pages
                             : 1;
  if (split && workspace == nullptr) return (int)cudaErrorInvalidValue;
  if ((long long)B * n_chunks > 65535) return (int)cudaErrorInvalidValue;
  const paged::Pools<T> pools{static_cast<const T*>(k_pool),
                              static_cast<const T*>(v_pool), k_scale,
                              v_scale, H, D, page_size};
  const Params<T> a{q, pools, page_table, kv_lens, q_starts, q_lens, out,
                    workspace, N, pages_per_seq, split_pages, n_chunks,
                    sm_scale};
  const int tiles = (max_q_len + kTQ - 1) / kTQ;
  const size_t smem =
      (size_t)paged::smem_floats(kWarps, kTQ, D, page_size) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!split)
    return (int)launch_dpl<T, false>(dim3(tiles, H, B), smem, s, a);
  cudaError_t e = launch_dpl<T, true>(dim3(tiles, H, B * n_chunks), smem, s,
                                      a);
  if (e != cudaSuccess) return (int)e;
  ragged_split_combine_kernel<T><<<dim3(tiles, H, B), kCombineThreads, 0,
                                   s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace ragged

// One C entry point per page type, all with this signature.
#define RAGGED_ATTENTION_ENTRY(NAME, T)                                     \
  extern "C" int NAME(const float* q, const void* k_pool,                   \
                      const void* v_pool, const float* k_scale,             \
                      const float* v_scale, const int* page_table,          \
                      const int* kv_lens, const int* q_starts,              \
                      const int* q_lens, float* out, float* workspace,      \
                      int N, int B, int H, int D, int page_size,            \
                      int pages_per_seq, int max_q_len, int split_pages,    \
                      float sm_scale, void* stream) {                       \
    return ragged::launch<T>(q, k_pool, v_pool, k_scale, v_scale,           \
                             page_table, kv_lens, q_starts, q_lens, out,    \
                             workspace, N, B, H, D, page_size,              \
                             pages_per_seq, max_q_len, split_pages,         \
                             sm_scale, stream);                             \
  }
