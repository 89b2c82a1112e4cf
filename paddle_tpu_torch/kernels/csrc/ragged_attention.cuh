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
// the end in fixed warp order.
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

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ragged {

constexpr int kTQ = 16;        // query tokens of one row per block
constexpr int kWarps = 4;      // warps per block, striding the page walk
constexpr float kNegInf = -1e30f;   // NEG_INF of the JAX kernels (finite)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCombineThreads = 128;

// page element -> float32: plain for float pools, code * scale for
// 1-byte code pools (from the code's raw byte)
template <typename T> struct Code;
template <> struct Code<float> {
  static constexpr bool kQuant = false;
};
template <> struct Code<int8_t> {
  static constexpr bool kQuant = true;
  __device__ static float to_float(uint32_t bits) {
    return (float)(int8_t)(uint8_t)(bits & 0xffu);
  }
};
template <> struct Code<__nv_fp8_e4m3> {
  static constexpr bool kQuant = true;
  __device__ static float to_float(uint32_t bits) {
    __nv_fp8_e4m3 v;
    v.__x = (__nv_fp8_storage_t)(bits & 0xffu);
    return static_cast<float>(v);
  }
};

template <typename T>
struct Params {
  const float* q;            // [N, H, D]
  const T* k_pool;           // [P, page, H, D]
  const T* v_pool;
  const float* k_scale;      // [P, page, H] (code pools only)
  const float* v_scale;
  const int* page_table;     // [B, pages_per_seq]
  const int* kv_lens;        // [B]
  const int* q_starts;
  const int* q_lens;
  float* out;                // [N, H, D], zeroed by the caller
  float* ws;                 // split: [n_chunks, N, H, D + 2]
  int N, H, D, page_size, pages_per_seq, split_pages, n_chunks;
  float sm_scale;
};

// Shared memory in floats: the pre-scaled query tile, then a region
// that holds each warp's staged K/V page during the walk and the
// warps' partial states during the merge.
__host__ __device__ inline int walk_floats(int D, int page_size) {
  return kWarps * page_size * (2 * D + 1);
}
__host__ __device__ inline int merge_floats(int D) {
  return kWarps * kTQ * (D + 2);
}
__host__ __device__ inline int smem_floats(int D, int page_size) {
  const int w = walk_floats(D, page_size), m = merge_floats(D);
  return kTQ * D + (w > m ? w : m);
}

// One warp stages page `page` of head h: K rows padded to D + 1 floats
// (lane-per-key reads hit distinct banks), V rows of D floats.
template <typename T>
__device__ inline void stage_page(const Params<T>& a, int page, int h,
                                  int lane, float* ks, float* vs) {
  const int D = a.D, H = a.H, ps = a.page_size, Dk = D + 1;
  if constexpr (!Code<T>::kQuant) {
    for (int e = lane; e < ps * D; e += 32) {
      const int j = e / D, d = e - j * D;
      const size_t g = ((size_t)(page * ps + j) * H + h) * D + d;
      ks[j * Dk + d] = a.k_pool[g];
      vs[j * D + d] = a.v_pool[g];
    }
  } else {
    const uint8_t* kb = reinterpret_cast<const uint8_t*>(a.k_pool);
    const uint8_t* vb = reinterpret_cast<const uint8_t*>(a.v_pool);
    if ((D & 3) == 0) {                      // four codes per load
      const int D4 = D >> 2;
      for (int e = lane; e < ps * D4; e += 32) {
        const int j = e / D4, d = (e - j * D4) * 4;
        const size_t row = (size_t)(page * ps + j) * H + h;
        const uint32_t kw =
            *reinterpret_cast<const uint32_t*>(kb + row * D + d);
        const uint32_t vw =
            *reinterpret_cast<const uint32_t*>(vb + row * D + d);
        const float ksc = a.k_scale[row], vsc = a.v_scale[row];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ks[j * Dk + d + i] = Code<T>::to_float(kw >> (8 * i)) * ksc;
          vs[j * D + d + i] = Code<T>::to_float(vw >> (8 * i)) * vsc;
        }
      }
    } else {
      for (int e = lane; e < ps * D; e += 32) {
        const int j = e / D, d = e - j * D;
        const size_t row = (size_t)(page * ps + j) * H + h;
        ks[j * Dk + d] = Code<T>::to_float(kb[row * D + d]) * a.k_scale[row];
        vs[j * D + d] = Code<T>::to_float(vb[row * D + d]) * a.v_scale[row];
      }
    }
  }
}

template <typename T, bool kSplit, int DPL>   // DPL = ceil(D / 32)
__global__ void __launch_bounds__(kWarps * 32)
ragged_attention_kernel(const Params<T> a) {
  const int H = a.H, D = a.D, page_size = a.page_size;
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
  const int n_keys = max(0, min(kv_len, pos0 + nq));
  const int n_pages = min((n_keys + page_size - 1) / page_size,
                          a.pages_per_seq);
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
  float* qs = smem;                        // [kTQ][D], pre-scaled
  float* region = smem + kTQ * D;
  for (int e = threadIdx.x; e < nq * D; e += blockDim.x) {
    const int i = e / D, d = e - i * D;
    qs[e] = a.q[((size_t)(tok0 + i) * H + h) * D + d] * a.sm_scale;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int Dk = D + 1;
  float* ks = region + warp * page_size * (2 * D + 1);  // [page][D + 1]
  float* vs = ks + page_size * Dk;                      // [page][D]

  float m[kTQ], l[kTQ], acc[kTQ][DPL];
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < DPL; ++cc) acc[i][cc] = 0.f;
  }

  for (int p = p_begin + warp; p < p_end; p += kWarps) {
    const int page = a.page_table[(size_t)b * a.pages_per_seq + p];
    stage_page<T>(a, page, h, lane, ks, vs);
    __syncwarp();
    const int kv_pos = p * page_size + lane;   // lane j scores key j
#pragma unroll
    for (int i = 0; i < kTQ; ++i) {
      if (i < nq) {                            // uniform across the warp
        const bool valid = lane < page_size && kv_pos < kv_len
                           && kv_pos <= pos0 + i;
        float s = kNegInf;
        if (valid) {
          const float* qi = qs + i * D;
          const float* kj = ks + lane * Dk;
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot = fmaf(qi[d], kj[d], dot);
          s = dot;
        }
        float mx = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_new = fmaxf(m[i], mx);
        const float pj = valid ? expf(s - m_new) : 0.f;
        float psum = pj;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          psum += __shfl_xor_sync(kFull, psum, o);
        const float alpha = expf(m[i] - m_new);
        l[i] = l[i] * alpha + psum;
#pragma unroll
        for (int cc = 0; cc < DPL; ++cc) acc[i][cc] *= alpha;
        for (int j = 0; j < page_size; ++j) {
          const float pb = __shfl_sync(kFull, pj, j);
#pragma unroll
          for (int cc = 0; cc < DPL; ++cc) {
            const int d = lane + 32 * cc;
            if (d < D) acc[i][cc] = fmaf(pb, vs[j * D + d], acc[i][cc]);
          }
        }
        m[i] = m_new;
      }
    }
    __syncwarp();                              // page slice free again
  }

  // merge the warps' partial states in fixed warp order
  __syncthreads();                             // walk slices now reused
  float* parts = region;                       // [kWarps][kTQ][D + 2]
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    if (i < nq) {
      float* rec = parts + (warp * kTQ + i) * W;
      if (lane == 0) {
        rec[0] = m[i];
        rec[1] = l[i];
      }
#pragma unroll
      for (int cc = 0; cc < DPL; ++cc) {
        const int d = lane + 32 * cc;
        if (d < D) rec[2 + d] = acc[i][cc];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nq * D; e += blockDim.x) {
    const int i = e / D, d = e - i * D;
    float mt = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      mt = fmaxf(mt, parts[(w * kTQ + i) * W]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* rec = parts + (w * kTQ + i) * W;
      const float sc = expf(rec[0] - mt);
      lt = fmaf(rec[1], sc, lt);
      at = fmaf(rec[2 + d], sc, at);
    }
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
  }
}

// Merge the split's chunk partials in chunk order (the fixed-order
// combine of ragged_attention_lax_split) and normalize.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
ragged_split_combine_kernel(const Params<T> a) {
  const int H = a.H, D = a.D, W = D + 2;
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

template <typename T, bool kSplit, int DPL>
cudaError_t launch_walk(dim3 grid, size_t smem, cudaStream_t stream,
                        const Params<T>& a) {
  auto kernel = ragged_attention_kernel<T, kSplit, DPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kSplit>
cudaError_t launch_dpl(dim3 grid, size_t smem, cudaStream_t s,
                       const Params<T>& a) {
  switch ((a.D + 31) / 32) {
    case 1: return launch_walk<T, kSplit, 1>(grid, smem, s, a);
    case 2: return launch_walk<T, kSplit, 2>(grid, smem, s, a);
    case 3: return launch_walk<T, kSplit, 3>(grid, smem, s, a);
    default: return launch_walk<T, kSplit, 4>(grid, smem, s, a);
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
  Params<T> a{q, static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
              k_scale, v_scale, page_table, kv_lens, q_starts, q_lens, out,
              workspace, N, H, D, page_size, pages_per_seq,
              split_pages, n_chunks, sm_scale};
  const int tiles = (max_q_len + kTQ - 1) / kTQ;
  const size_t smem = (size_t)smem_floats(D, page_size) * sizeof(float);
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
