// Mixed (chunk / verify) paged attention for sm_90a: a block of T query
// tokens per slot attends that slot's float32 K/V pages causally
// through its page-table row.
//
// Replaces paddle_tpu/kernels/paged_attention.py::_mixed_kernel (:219),
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
// q and out: bound by float32 operations, 0.018 ms at 67 TFLOP/s. At the
// verify shape (eight slots of 1 + 4 tokens near 1000 positions) it must
// read each slot's K/V once, ~49 MB: bound by bytes, 0.0146 ms at 3.35
// TB/s. The contract (2e-5 against the float32 plain version) keeps the
// arithmetic in float32: TF32 tensor cores would break it.
//
// Design: a register-blocked SIMT flash tile over pages. One block owns
// TQ query rows of one (slot, head): TQ = 64 (16 x 16 threads, each a 4 x
// 4 micro-tile) or, for T <= 8, TQ = 8 (4 x 16 threads, 2 x 4). It walks
// key blocks of 64 positions, whole pages gathered through its page-table
// row (4 pages of 16, 2 of 32), and never a page past the last one its
// last row can see. Each key block is staged by 16-byte cp.async into a
// two-stage ring (K rows padded so the micro-tile's float4 column reads
// hit distinct banks), so the next block's copy runs under this block's
// arithmetic. Each thread forms its micro-tile of S = Q K^T from float4
// shared reads, the row max and sum reduce over the 16 threads sharing a
// row (the sum once, at the end), exp2 with log2(e) folded into q's
// scale; P goes once through a per-row shared strip and each thread adds
// its micro-tile of P V (4 rows x 4 or 8 head-dim columns) into register
// accumulators. The causal test runs only on key blocks that cross the
// tile's diagonal or the context's end; rows are written once, at the end.
//
// Where the grid would leave SMs idle (the chunk's 96 tiles, verify's 96
// (slot, head) pairs on 132 SMs), the host splits each row's key blocks
// into chunks, one block each, writing (m, l, acc) partials; a second
// kernel merges them in fixed chunk order, as the ragged split kernel
// does. No atomics: reruns are bit-identical, split or not.
#include "paged_walk.cuh"
#include "cp_async.cuh"

#include <math.h>

namespace {

constexpr int kKB = 64;                    // key positions per key block
constexpr int kLP = kKB + 4;               // a row of the P strip
constexpr float kLog2e = 1.4426950408889634f;

struct MixedParams {
  const float* q;            // [B, T, H, D]
  const float* k_pool;       // [P, page, H, D]
  const float* v_pool;
  const int* page_table;     // [B, pages_per_seq]
  const int* seq_lens;       // [B]
  const int* q_lens;         // [B]
  float* out;                // [B, T, H, D]
  float* part_ml;            // [B, T, H, n_split, 2]: (m, l), split only
  float* part_acc;           // [B, T, H, n_split, D], split only
  int T, H, D, page_size, pages_per_seq;
  int kb_pages;              // pages per key block
  int n_split, split_blocks; // chunks per row, key blocks per chunk
  float scale_log2;          // sm_scale * log2(e)
};

// shared rows: K and Q padded to Dp + 4 or Dp + 8 floats (a row stride of
// 4 mod 8 words: eight threads' float4 reads of eight rows hit distinct
// banks), V to the 64 * NC columns the micro-tiles read
__host__ __device__ inline int padded(int D) { return (D + 3) & ~3; }
__host__ __device__ inline int row_k(int D) {
  return padded(D) + 4 + (padded(D) & 4);
}
template <int RPT, int TY, int NC>
__host__ __device__ inline int smem_floats(int D) {
  const int tq = RPT * TY;
  return tq * row_k(D) + 2 * kKB * (row_k(D) + 64 * NC) + tq * kLP;
}

template <int RPT, int TY, int NC, bool kVec>
__global__ void __launch_bounds__(TY * 16)
mixed_kernel(const MixedParams a) {
  constexpr int TQ = RPT * TY, THREADS = TY * 16, LDV = 64 * NC;
  const int D = a.D, Dp = padded(D), LDK = row_k(D);
  const int n_tiles = (a.T + TQ - 1) / TQ;
  const int tile = n_tiles - 1 - blockIdx.x / a.n_split;  // heaviest first
  const int chunk = blockIdx.x % a.n_split;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = tile * TQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int seq = a.seq_lens[b];
  const int pos0 = seq - a.q_lens[b] + t0;                // row t0's position
  const int cap = min(seq, a.pages_per_seq * a.page_size);
  // keys the tile's last row sees, the pages holding them, their blocks
  const int n_keys = min(cap, pos0 + min(a.T, t0 + TQ) - t0);
  const int n_pages = paged::visible_pages(n_keys, a.page_size,
                                           a.pages_per_seq);
  const int kbe = a.kb_pages * a.page_size;   // positions in a key block
  const int n_kb = (n_pages + a.kb_pages - 1) / a.kb_pages;
  const int kb_begin = chunk * a.split_blocks;
  const int kb_end = min(n_kb, kb_begin + a.split_blocks);
  const int* prow = a.page_table + (size_t)b * a.pages_per_seq;

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                                // [TQ][LDK]
  float* ring = Qs + TQ * LDK;                     // [2][K, V]
  const int stage_floats = kKB * (LDK + LDV);
  float* Ps = ring + 2 * stage_floats;             // [TQ][kLP]

  // key block kb's K and V rows of head h into ks / vs; positions past
  // the visible pages (or past the block's whole pages) read as 0
  auto stage = [&](int kb, float* ks, float* vs) {
    const int p0 = kb * a.kb_pages;
    if constexpr (kVec) {
      const int D4 = D >> 2;
      for (int e = threadIdx.x; e < kKB * D4; e += THREADS) {
        const int j = e / D4, c = (e - j * D4) * 4;
        const int pg = p0 + j / a.page_size;
        const bool in = j < kbe && pg < n_pages;
        const size_t g =
            in ? (((size_t)prow[pg] * a.page_size + j % a.page_size) * a.H
                  + h) * D + c
               : 0;
        cpasync::copy16(ks + j * LDK + c, a.k_pool + g, in);
        cpasync::copy16(vs + j * LDV + c, a.v_pool + g, in);
      }
    } else {
      for (int e = threadIdx.x; e < kKB * Dp; e += THREADS) {
        const int j = e / Dp, d = e - j * Dp;
        const int pg = p0 + j / a.page_size;
        float kv = 0.f, vv = 0.f;
        if (j < kbe && pg < n_pages && d < D) {
          const size_t g =
              (((size_t)prow[pg] * a.page_size + j % a.page_size) * a.H + h)
                  * D + d;
          kv = a.k_pool[g];
          vv = a.v_pool[g];
        }
        ks[j * LDK + d] = kv;
        vs[j * LDV + d] = vv;
      }
    }
  };

  if (kb_begin < kb_end) stage(kb_begin, ring, ring + kKB * LDK);
  cpasync::commit();
  // q, pre-scaled by scale * log2(e); rows past T and columns past D 0
  for (int e = threadIdx.x; e < TQ * Dp; e += THREADS) {
    const int i = e / Dp, d = e - i * Dp, t = t0 + i;
    Qs[i * LDK + d] =
        t < a.T && d < D
            ? a.q[(((size_t)b * a.T + t) * a.H + h) * D + d] * a.scale_log2
            : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][NC][4];
  int lim[RPT];                              // row i sees keys < lim[i]
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    lim[i] = min(cap, pos0 + ty * RPT + i + 1);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }
  const int lim_first = min(cap, pos0 + 1);  // the tile's first row
  float* prows = Ps + ty * RPT * kLP;        // this half-warp's P rows

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int it = kb - kb_begin, k0 = kb * kbe;
    cpasync::wait<0>();                      // block kb has landed
    __syncthreads();                         // ... and kb - 1 is done
    if (kb + 1 < kb_end) {                   // overlaps this block's work
      float* next = ring + ((it + 1) & 1) * stage_floats;
      stage(kb + 1, next, next + kKB * LDK);
    }
    cpasync::commit();
    const float* Ks = ring + (it & 1) * stage_floats;
    const float* Vs = Ks + kKB * LDK;

    // S = Q K^T: rows ty * RPT + i, keys tx + 16 j
    float s[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < Dp; d += 4) {
      float4 qv[RPT], kv[4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * RPT + i) * LDK
                                                 + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LDK
                                                 + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[i][j];
          x = fmaf(qv[i].x, kv[j].x, x);
          x = fmaf(qv[i].y, kv[j].y, x);
          x = fmaf(qv[i].z, kv[j].z, x);
          s[i][j] = fmaf(qv[i].w, kv[j].w, x);
        }
    }

    // the mask binds only where the block crosses the diagonal or the end
    const bool masked = kbe < kKB || k0 + kbe > lim_first;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jk = tx + 16 * j;
        if (masked && (jk >= kbe || k0 + jk >= lim[i])) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(paged::kFull, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_use);
        sum += p;
        prows[i * kLP + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + sum;             // this thread's share
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncwarp();                            // the half-warp's P rows

    // O += P V: rows ty * RPT + i, columns 64 c + 4 tx .. + 3
    const int n_j = (kbe + 3) & ~3;
#pragma unroll 2
    for (int j4 = 0; j4 < n_j; j4 += 4) {
      float4 pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        pv[i] = *reinterpret_cast<const float4*>(prows + i * kLP + j4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 v = *reinterpret_cast<const float4*>(
              Vs + (j4 + kk) * LDV + 64 * c + 4 * tx);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float p = kk == 0 ? pv[i].x : kk == 1 ? pv[i].y
                          : kk == 2 ? pv[i].z : pv[i].w;
            acc[i][c][0] = fmaf(p, v.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, v.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, v.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, v.w, acc[i][c][3]);
          }
        }
      }
    }
    __syncwarp();                            // P rows free again
  }
  cpasync::wait<0>();

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float lt = l[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      lt += __shfl_xor_sync(paged::kFull, lt, o);
    const int t = t0 + ty * RPT + i;
    if (t >= a.T) continue;
    const size_t row = ((size_t)b * a.T + t) * a.H + h;
    float* dst = a.out + row * D;
    float div = lt;                          // unsplit: the softmax's sum
    if (a.n_split > 1) {                     // split: the raw partials
      const size_t rec = row * a.n_split + chunk;
      dst = a.part_acc + rec * D;
      div = 1.f;
      if (tx == 0) {
        a.part_ml[2 * rec] = m[i];
        a.part_ml[2 * rec + 1] = lt;
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 64 * c + 4 * tx;
      float v[4] = {0.f, 0.f, 0.f, 0.f};     // a row that sees no key: 0
      if (div != 0.f)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = acc[i][c][e] / div;
      if constexpr (kVec) {
        if (d < D)
          *reinterpret_cast<float4*>(dst + d) =
              make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d + e < D) dst[d + e] = v[e];
      }
    }
  }
}

// out[row][d] from the row's n_split partials, merged in chunk order
__global__ void __launch_bounds__(128) merge_kernel(const MixedParams a) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  if (d >= a.D) return;
  const float* ml = a.part_ml + row * a.n_split * 2;
  float mt = -INFINITY;
  for (int c = 0; c < a.n_split; ++c) mt = fmaxf(mt, ml[2 * c]);
  const float mu = mt == -INFINITY ? 0.f : mt;
  float lt = 0.f, at = 0.f;
  for (int c = 0; c < a.n_split; ++c) {
    const float sc = exp2f(ml[2 * c] - mu);
    lt = fmaf(ml[2 * c + 1], sc, lt);
    at = fmaf(a.part_acc[(row * a.n_split + c) * a.D + d], sc, at);
  }
  a.out[row * a.D + d] = lt == 0.f ? 0.f : at / lt;
}

template <int RPT, int TY, int NC>
cudaError_t launch_tile(const MixedParams& a, int B, bool vec,
                        cudaStream_t s) {
  constexpr int TQ = RPT * TY;
  const dim3 grid(((a.T + TQ - 1) / TQ) * a.n_split, a.H, B);
  const size_t smem = sizeof(float) * smem_floats<RPT, TY, NC>(a.D);
  return vec ? paged::launch(mixed_kernel<RPT, TY, NC, true>, grid, TY * 16,
                             smem, s, a)
             : paged::launch(mixed_kernel<RPT, TY, NC, false>, grid,
                             TY * 16, smem, s, a);
}

template <int NC>
cudaError_t launch_rows(const MixedParams& a, int B, int tile_rows,
                        bool vec, cudaStream_t s) {
  return tile_rows == 8 ? launch_tile<2, 4, NC>(a, B, vec, s)
                        : launch_tile<4, 16, NC>(a, B, vec, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() after the last
// launch (0 = cudaSuccess). Takes D <= 128, page_size <= 32 and tile_rows
// 8 or 64 (query rows per block). split_blocks > 0 splits each row's key
// blocks (64 positions, whole pages) into chunks of that many: n_split
// chunks, which must be ceil(ceil(pages_per_seq / (64 / page_size)) /
// split_blocks), whose partials go to part_ml [B, T, H, n_split, 2] and
// part_acc [B, T, H, n_split, D] before the merge writes out; 0 runs
// unsplit (n_split 1, part_* unused). Every output element is written.
extern "C" int mixed_attention_f32(const float* q, const float* k_pool,
                                   const float* v_pool,
                                   const int* page_table,
                                   const int* seq_lens, const int* q_lens,
                                   float* out, float* part_ml,
                                   float* part_acc, int B, int T, int H,
                                   int D, int page_size, int pages_per_seq,
                                   int tile_rows, int split_blocks,
                                   int n_split, float sm_scale,
                                   void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  if (D < 1 || D > 128 || page_size < 1 || page_size > 32
      || pages_per_seq < 1 || H < 1 || H > 65535 || B > 65535
      || (tile_rows != 8 && tile_rows != 64) || split_blocks < 0)
    return (int)cudaErrorInvalidValue;
  const int kb_pages = kKB / page_size;
  const int n_kb = (pages_per_seq + kb_pages - 1) / kb_pages;
  const bool split = split_blocks > 0 && split_blocks < n_kb;
  if (n_split != (split ? (n_kb + split_blocks - 1) / split_blocks : 1)
      || (split && (part_ml == nullptr || part_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  const MixedParams a{q, k_pool, v_pool, page_table, seq_lens, q_lens, out,
                      part_ml, part_acc, T, H, D, page_size, pages_per_seq,
                      kb_pages, n_split, split ? split_blocks : n_kb,
                      sm_scale * kLog2e};
  const bool vec = D % 4 == 0 && aligned16(k_pool) && aligned16(v_pool)
                   && aligned16(out) && (!split || aligned16(part_acc));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = D <= 64 ? launch_rows<1>(a, B, tile_rows, vec, s)
                                : launch_rows<2>(a, B, tile_rows, vec, s);
  if (e != cudaSuccess || !split) return (int)e;
  merge_kernel<<<(unsigned)((size_t)B * T * H), 128, 0, s>>>(a);
  return (int)cudaGetLastError();
}
