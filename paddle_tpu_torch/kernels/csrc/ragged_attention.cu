// Ragged paged attention over a flat token block, float32, for sm_90a.
//
// Replaces paddle_tpu/kernels/paged_attention.py::_ragged_kernel (its
// float variant), which the JAX package reaches through
// ragged_attention_pallas. Semantics, as there: row b owns the flat
// tokens [q_starts[b], q_starts[b] + q_lens[b]); token t of row b sits
// at global position kv_lens[b] - q_lens[b] + t and attends to every
// pool position kv_pos with kv_pos < kv_lens[b] and kv_pos <= its own
// position, through row b's page table. A token whose softmax is empty
// outputs exactly 0. Tokens covered by no row are never written: the
// caller hands in a zeroed output, so bucket padding stays exactly 0.
//
// Bound. Every resident K and V byte a row can see must be read once
// (plus q and out), and the arithmetic is ~4*D flops per (query, key)
// pair in float32 outside the tensor cores. At the serving engine's
// decode shapes that is ~0.25 flop per byte, far below the H100's
// ~20 float32 flops per byte of HBM bandwidth: the kernel is bound by
// the bytes of the K/V pages it streams.
//
// Design. The Pallas kernel runs a sequential (rows, pages) grid and
// carries one online-softmax state per flat token across the WHOLE
// grid; on a GPU that order would serialize. Here every block owns one
// (q-tile of kTQ tokens of row b, head h) and walks only the pages the
// tile can see (up to its last query position), so work follows the
// ragged token and KV counts, and blocks of rows or tiles past their
// row's q_len exit at once. Inside a block the page walk is split
// across kWarps warps (warp w takes pages w, w + kWarps, ...), so a
// one-token decode row still keeps four warps streaming pages; each
// warp stages its page's K and V for head h in its own shared-memory
// slice (one coalesced row of D floats per key) and keeps a float32
// online-softmax state (m, l, acc) per query in registers. The warps'
// partial states merge once at the end in fixed warp order, the same
// associative (m, l, acc) merge the JAX KV-split reference uses, so a
// run is deterministic. Tensor cores, TMA and a deeper copy pipeline
// are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTQ = 16;        // query tokens of one row per block
constexpr int kWarps = 4;      // warps per block, striding the page walk
constexpr float kNegInf = -1e30f;   // NEG_INF of the JAX kernels (finite)
constexpr unsigned kFull = 0xffffffffu;

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

template <int DPL>   // ceil(D / 32): head-dim elements each lane owns
__global__ void __launch_bounds__(kWarps * 32)
ragged_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k_pool,
                        const float* __restrict__ v_pool,
                        const int* __restrict__ page_table,
                        const int* __restrict__ kv_lens,
                        const int* __restrict__ q_starts,
                        const int* __restrict__ q_lens,
                        float* __restrict__ out,
                        int H, int D, int page_size, int pages_per_seq,
                        float sm_scale) {
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_len = q_lens[b];
  const int t0 = blockIdx.x * kTQ;
  if (t0 >= q_len) return;                 // idle row or tile past q_len
  const int nq = min(kTQ, q_len - t0);
  const int kv_len = kv_lens[b];
  const int tok0 = q_starts[b] + t0;       // flat index of tile token 0
  const int pos0 = kv_len - q_len + t0;    // its global position
  // keys the tile can see: positions up to its last query's position
  const int n_keys = max(0, min(kv_len, pos0 + nq));
  const int n_pages = (n_keys + page_size - 1) / page_size;

  extern __shared__ float smem[];
  float* qs = smem;                        // [kTQ][D], pre-scaled
  float* region = smem + kTQ * D;
  for (int e = threadIdx.x; e < nq * D; e += blockDim.x) {
    const int i = e / D, d = e - i * D;
    qs[e] = q[((size_t)(tok0 + i) * H + h) * D + d] * sm_scale;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int Dk = D + 1;                    // padded K rows: lane-per-key
                                           // reads hit distinct banks
  float* ks = region + warp * page_size * (2 * D + 1);  // [page][D + 1]
  float* vs = ks + page_size * Dk;                      // [page][D]

  float m[kTQ], l[kTQ], acc[kTQ][DPL];
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }

  for (int p = warp; p < n_pages; p += kWarps) {
    const int page = page_table[(size_t)b * pages_per_seq + p];
    for (int e = lane; e < page_size * D; e += 32) {
      const int j = e / D, d = e - j * D;
      const size_t g = ((size_t)(page * page_size + j) * H + h) * D + d;
      ks[j * Dk + d] = k_pool[g];
      vs[j * D + d] = v_pool[g];
    }
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
        for (int c = 0; c < DPL; ++c) acc[i][c] *= alpha;
        for (int j = 0; j < page_size; ++j) {
          const float pb = __shfl_sync(kFull, pj, j);
#pragma unroll
          for (int c = 0; c < DPL; ++c) {
            const int d = lane + 32 * c;
            if (d < D) acc[i][c] = fmaf(pb, vs[j * D + d], acc[i][c]);
          }
        }
        m[i] = m_new;
      }
    }
    __syncwarp();                              // page slice free again
  }

  // merge the warps' partial states in fixed warp order
  __syncthreads();                             // walk slices now reused
  const int W = D + 2;
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
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        if (d < D) rec[2 + d] = acc[i][c];
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
    out[((size_t)(tok0 + i) * H + h) * D + d] = lt == 0.f ? 0.f : at / lt;
  }
}

template <int DPL>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const float* q, const float* k_pool, const float* v_pool,
                   const int* page_table, const int* kv_lens,
                   const int* q_starts, const int* q_lens, float* out,
                   int H, int D, int page_size, int pages_per_seq,
                   float sm_scale) {
  auto kernel = ragged_attention_kernel<DPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      q, k_pool, v_pool, page_table, kv_lens, q_starts, q_lens, out, H, D,
      page_size, pages_per_seq, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch
// (0 = cudaSuccess). Takes D <= 128 and page_size <= 32.
int ragged_attention_f32(const float* q, const float* k_pool,
                         const float* v_pool, const int* page_table,
                         const int* kv_lens, const int* q_starts,
                         const int* q_lens, float* out, int B, int H, int D,
                         int page_size, int pages_per_seq, int max_q_len,
                         float sm_scale, void* stream) {
  if (B <= 0 || max_q_len <= 0) return (int)cudaSuccess;
  if (D < 1 || D > 128 || page_size < 1 || page_size > 32)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((max_q_len + kTQ - 1) / kTQ, H, B);
  const size_t smem = (size_t)smem_floats(D, page_size) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch ((D + 31) / 32) {
    case 1: e = launch<1>(grid, smem, s, q, k_pool, v_pool, page_table,
                          kv_lens, q_starts, q_lens, out, H, D, page_size,
                          pages_per_seq, sm_scale); break;
    case 2: e = launch<2>(grid, smem, s, q, k_pool, v_pool, page_table,
                          kv_lens, q_starts, q_lens, out, H, D, page_size,
                          pages_per_seq, sm_scale); break;
    case 3: e = launch<3>(grid, smem, s, q, k_pool, v_pool, page_table,
                          kv_lens, q_starts, q_lens, out, H, D, page_size,
                          pages_per_seq, sm_scale); break;
    default: e = launch<4>(grid, smem, s, q, k_pool, v_pool, page_table,
                           kv_lens, q_starts, q_lens, out, H, D, page_size,
                           pages_per_seq, sm_scale); break;
  }
  return (int)e;
}

}  // extern "C"
