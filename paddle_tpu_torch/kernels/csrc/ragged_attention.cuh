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
// Pools are [P, page, H, D]: one key's row of head h is D contiguous
// elements at stride H * D. Code pools hold 1-byte int8 or e4m3 codes
// beside scale pools [P, page, H] (K/V = code * scale) of float32, or of
// float16 or bfloat16 for the page types paged::Scaled<code, scale>; the
// staging widens a narrow scale in registers (paged_walk.cuh), as JAX's
// _ragged_kernel widens ks_ref[0].astype(jnp.float32).
//
// Bound. At the serving mix of GPT-3 XL geometry (H 32, D 64: a 512-token
// chunk row, a prefix hit, five decode rows near 2000 positions) the
// kernel must read every visible K/V row once and do 4 * D operations per
// visible (query, key) pair and head (~23 M pair-heads, 5.9 GFLOP). Code
// pages (~53 MB of codes and scales, 0.016 ms at 3.35 TB/s) are bound by
// operations: 0.026 ms at two TF32 products an operation (495 TFLOP/s);
// float32 pages by bytes (~210 MB, 0.063 ms; three products take 0.036).
// At the decode shape (eight one-query rows) both are bound by bytes:
// 0.0207 ms for codes, 0.0777 for float32 pages.
//
// Two kinds of rows, two kernels; each block reads its row's q_len on the
// device and leaves at once if the row is not its kind (the host knows
// only max_q_len, which sizes the grids). The tile kernel goes first and
// the decode walk may start beside it (ragged_decode_kernel):
//
// 1. Rows of more than kDecodeMaxQ queries (chunks, prefix hits): a
//    tensor-core flash tile. A block owns WARPS warps of 16 * MT query
//    rows of one (row, head), scales q by sm_scale * log2(e) and splits
//    it once into tf32 big and small planes, and walks key tiles of BK
//    positions gathered through the page-table row (whole or partial
//    pages: any page size), staged by 16-byte cp.async into an NS-stage
//    ring. S and P stay in registers (mma.sync.m16n8k8 tf32, the float32
//    flash forward's layout); the softmax runs in the log2 domain, masks
//    only on tiles that cross a row's diagonal or the context's end, and
//    a warp skips tiles none of its rows sees. Each tile's P V is summed
//    from zero and added to O in float32 (a whole walk in one tensor-core
//    accumulator drifts). The grid runs each row's last (heaviest) tiles
//    first.
//    - float32 pages: 3xTF32 (tf32x3.cuh), three products a k-step.
//    - code pages: an int8 code (|c| <= 127) and an e4m3 value (4
//      significant bits) are exact in tf32, and the per-(position, head)
//      scale factors out: s_j = kscale_j (q . code_j) and O = sum_j (p_j
//      vscale_j) code_j. Only q and p * vscale are split: two products a
//      k-step, codes turned into floats in registers as fragments are
//      read. K's columns are read four codes a lane per 16 columns, so
//      q's planes hold each 16 columns permuted to match; V's columns go
//      to the output tiles transposed (column d = (D / 8) * n + tile),
//      so a lane's codes of a V row come in one load.
// 2. Rows of kDecodeMaxQ (one) query (decode): a bandwidth walk, the one
//    the decode kernel runs too (paged_walk.cuh's walk_pages). A block owns
//    one (row, head) (and, split, one chunk of its pages); each warp walks
//    every W-th page through its own ring (16-byte cp.async, one page in
//    flight while one is read), its pool pages read once from the table
//    into a register, a page's rows at a fixed stride (no division on the
//    way to a copy). D / 8 lanes share a key (eight columns a lane) and
//    256 / D keys go at once, so no 16-key page idles half a warp. Scores
//    reduce over a key's lanes by shuffles, the online softmax (log2
//    domain) updates once a page, and the warps' states merge at the end
//    in fixed warp order. A block has a warp for every kDecodePagesPerWarp
//    pages it walks, at most kDecodeWarps.
//
// The KV split (split_pages = sp > 0) splits decode rows only: the
// decode kernel's block (h, c, b) walks pages [c sp, (c + 1) sp) of the
// row's visible pages and writes its merged (m, l, acc) partial to the
// float32 workspace [n_chunks, N, H, D + 2]; a chunk past the visible
// pages writes nothing, and the combine kernel merges the chunks that
// were written, in chunk order, with ragged_attention_lax_split's merge.
// Tile rows walk unsplit in both modes: a 512-token chunk row is already
// 4 tiles of 128 rows per head, and its partials would cost more bytes
// than the kernel moves. No atomics anywhere: two runs give the same
// bits.
//
// Shapes (the launch lines below, picked by timing variants at the
// smoke's shapes on the card: chip_tools/ragged_tune.py). D 64: float32
// pages four warps of 32 rows and 64-key tiles, code pages eight warps of
// 16 rows and 64-key tiles, both two-stage rings; the decode walk two
// pages a warp's ring (more stages measured slower on code pages).
#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_walk.cuh"
#include "flash_f32_tiles.cuh"

namespace ragged {

using namespace f32tiles;

// rows of at most this many queries take the decode walk, longer ones the
// tensor-core tile
constexpr int kDecodeMaxQ = 1;
// the decode walk: at most this many warps a block, one for every
// kDecodePagesPerWarp pages a block walks (fewer where the ring would not
// fit)
constexpr int kDecodeWarps = 8;
constexpr int kDecodePagesPerWarp = 4;
// and its ring: pages a warp holds (one in flight while one is read)
constexpr int kDecodeStages = 2;
constexpr int kCombineThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// the page traits and code loads of the shared one-query walk
using paged::load_codes;
using paged::Page;

template <typename T>
struct Params {
  const float* q;            // [N, H, D]
  const void* k_pool;        // [P, page, H, D]
  const void* v_pool;
  const void* k_scale;       // [P, page, H] of Page<T>::Scale, codes only
  const void* v_scale;
  const int* page_table;     // [B, pages_per_seq]
  const int* kv_lens;        // [B]
  const int* q_starts;
  const int* q_lens;
  float* out;                // [N, H, D], zeroed by the caller
  float* ws;                 // split: [n_chunks, N, H, D + 2]
  int N, H, D, page_size, pages_per_seq, split_pages, n_chunks;
  int vec;                   // rows and pools take 16-byte copies
  float scale_log2;          // sm_scale * log2(e)
};

// pages of a row's table holding its first n_keys key positions
__device__ inline int visible_pages(int n_keys, int page_size) {
  return (max(n_keys, 0) + page_size - 1) / page_size;
}

// The tile kernel's key tile: K and V rows r in [0, ROWS) of head h for
// positions pos0 + r, through page_row, into shared rows of LD elements;
// columns [D, DP) and rows at or past n_keys read as 0 (their scales
// too). Code pools also stage each row's two scales. With a.vec the rows
// go by 16-byte cp.async (the caller commits and waits), else by plain
// loads and stores. The block's THREADS threads share the work.
template <typename T, int DP, int ROWS, int LD, int THREADS>
__device__ inline void stage_keys(const Params<T>& a, const int* page_row,
                                  int h, int pos0, int n_keys,
                                  typename Page<T>::Elem* ks,
                                  typename Page<T>::Elem* vs, float* kss,
                                  float* vss) {
  const int tid = threadIdx.x;
  using E = typename Page<T>::Elem;
  const int D = a.D, ps = a.page_size, H = a.H;
  const E* kp = static_cast<const E*>(a.k_pool);
  const E* vp = static_cast<const E*>(a.v_pool);
  if (a.vec) {
    constexpr int kEpc = 16 / sizeof(E);       // elements a 16-byte copy
    constexpr int kCh = DP / kEpc;
    for (int e = tid; e < ROWS * kCh; e += THREADS) {
      const int r = e / kCh, c = (e - r * kCh) * kEpc, pos = pos0 + r;
      const bool in = pos < n_keys && c < D;
      const size_t g =
          in ? (((size_t)page_row[pos / ps] * ps + pos % ps) * H + h) * D + c
             : 0;
      cpasync::copy16(ks + r * LD + c, kp + g, in);
      cpasync::copy16(vs + r * LD + c, vp + g, in);
    }
  } else {
    for (int e = tid; e < ROWS * DP; e += THREADS) {
      const int r = e / DP, c = e - r * DP, pos = pos0 + r;
      E kv = 0, vv = 0;
      if (pos < n_keys && c < D) {
        const size_t g =
            (((size_t)page_row[pos / ps] * ps + pos % ps) * H + h) * D + c;
        kv = kp[g];
        vv = vp[g];
      }
      ks[r * LD + c] = kv;
      vs[r * LD + c] = vv;
    }
  }
  if constexpr (Page<T>::kQuant) {
    for (int r = tid; r < ROWS; r += THREADS) {
      const int pos = pos0 + r;
      const bool in = pos < n_keys;
      const size_t g =
          in ? ((size_t)page_row[pos / ps] * ps + pos % ps) * H + h : 0;
      paged::stage_scales<T>(kss + r, vss + r, a.k_scale, a.v_scale, g, in);
    }
  }
}

// ------------------------------------------------ rows of many queries

// A block of WARPS warps of 16 * MT query rows, key tiles of BK positions
// in an NS-stage ring. Shared memory: q's big and small planes [BQ][DP +
// 4] floats, then the ring: float32 K and V [BK][DP + 4] floats, or code
// K and V [BK][DP + 16] bytes and their scales [BK] floats each.
template <typename T, int DP, int WARPS, int MT, int BK, int NS>
struct Tile {
  static constexpr bool kQuant = Page<T>::kQuant;
  static constexpr int kThreads = WARPS * 32;
  static constexpr int BQ = 16 * MT * WARPS;
  static constexpr int LDQ = DP + 4;
  static constexpr int LDK = kQuant ? DP + 16 : DP + 4;   // elements
  static constexpr size_t kRows =
      kQuant ? (size_t)BK * LDK : sizeof(float) * BK * LDK;
  static constexpr size_t kStage =
      2 * kRows + (kQuant ? 2 * sizeof(float) * BK : 0);
  static constexpr size_t kQ = sizeof(float) * 2 * BQ * LDQ;
  static constexpr size_t kSmem = kQ + NS * kStage;
  static_assert(BK % 16 == 0 && DP % 16 == 0 && NS >= 2, "tile shape");
  static_assert(kStage % 16 == 0, "16-byte aligned stages");
};

// q's rows in place: scaled by scale_log2 and split into the big plane
// (where the rows are) and the small plane (BQ * (DP + 4) floats after);
// with kPerm each 16 columns are permuted so that the A fragment of
// k-step 2 kp + s reads at column t the product partner of code 4 t + 2 s
// of the block and at t + 4 that of code 4 t + 2 s + 1 (scores_codes)
template <int DP, int BQ, int THREADS, bool kPerm>
__device__ inline void prep_q(float* rows, float scale) {
  constexpr int LD = DP + 4, NB = DP / 16;
  for (int i = threadIdx.x; i < BQ * NB; i += THREADS) {
    float* at = rows + (i / NB) * LD + (i % NB) * 16;
    float x[16];
#pragma unroll
    for (int c = 0; c < 16; c += 4)
      *reinterpret_cast<float4*>(x + c) =
          *reinterpret_cast<const float4*>(at + c);
    uint32_t big[16], small[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int col = kPerm ? 8 * ((c & 3) >> 1) + 4 * (c & 1) + (c >> 2) : c;
      split(x[c] * scale, big[col], small[col]);
    }
#pragma unroll
    for (int c = 0; c < 16; c += 4) {
      *reinterpret_cast<uint4*>(at + c) =
          make_uint4(big[c], big[c + 1], big[c + 2], big[c + 3]);
      *reinterpret_cast<uint4*>(at + BQ * LD + c) =
          make_uint4(small[c], small[c + 1], small[c + 2], small[c + 3]);
    }
  }
}

// c[m][n] = q rows 16 m .. of the warp . code rows 8 n + g over DP columns:
// A from the permuted split planes (load_a), B four codes a lane per 16
// columns, exact in tf32: two products a k-step (q small, then q big)
template <typename T, int MT, int N, int DP, int LDQ, int PQ, int LDK>
__device__ inline void scores_codes(float (&c)[MT][N][4], const float* qw,
                                    const uint8_t* kb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  zero(c);
#pragma unroll
  for (int kp = 0; kp < DP / 16; ++kp) {
    uint32_t ab[2][MT][4], as[2][MT][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        load_a<LDQ, PQ>(ab[s][m], as[s][m], qw + m * 16 * LDQ, 2 * kp + s,
                        lane);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float f[4];
      load_codes<T, 4>(kb + (n * 8 + g) * LDK + kp * 16 + 4 * t, f);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint32_t b0 = __float_as_uint(f[2 * s]);
        const uint32_t b1 = __float_as_uint(f[2 * s + 1]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          tf32x3::mma(c[m][n], as[s][m], b0, b1);
          tf32x3::mma(c[m][n], ab[s][m], b0, b1);
        }
      }
    }
  }
}

// o[m][nd] += p'[m] . V codes over the NK key-steps of a walked tile, the
// tile summed from zero and added in float32. The A fragment of key-step
// jj is p's score n-tile jj (c_to_a's key order), B reads V rows 8 jj + 2t
// and + 1; output tile nd, column g is head-dim column NDT g + nd, so a
// lane reads its codes of a row in one load (NP columns a pass)
template <typename T, int MT, int NK, int NDT, int LDK>
__device__ inline void pv_codes(float (&o)[MT][NDT][4],
                                const float (&p)[MT][NK][4],
                                const uint8_t* vb, int lane) {
  constexpr int NP = NDT <= 8 ? NDT : 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n0 = 0; n0 < NDT; n0 += NP) {
    float acc[MT][NP][4];
    zero(acc);
#pragma unroll
    for (int jj = 0; jj < NK; ++jj) {
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) c_to_a(ab[m], as[m], p[m][jj]);
      const uint8_t* row = vb + (jj * 8 + 2 * t) * LDK + NDT * g + n0;
      float f0[NP], f1[NP];
      load_codes<T, NP>(row, f0);
      load_codes<T, NP>(row + LDK, f1);
#pragma unroll
      for (int nd = 0; nd < NP; ++nd) {
        const uint32_t b0 = __float_as_uint(f0[nd]);
        const uint32_t b1 = __float_as_uint(f1[nd]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          tf32x3::mma(acc[m][nd], as[m], b0, b1);
          tf32x3::mma(acc[m][nd], ab[m], b0, b1);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nd = 0; nd < NP; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[m][n0 + nd][e] += acc[m][nd][e];
  }
}

template <typename T, int DP, int WARPS, int MT, int BK, int NS>
__global__ void __launch_bounds__(WARPS * 32)
ragged_tile_kernel(const Params<T> a) {
  using C = Tile<T, DP, WARPS, MT, BK, NS>;
  using E = typename Page<T>::Elem;
  constexpr bool kQuant = C::kQuant;
  constexpr int BQ = C::BQ, LDQ = C::LDQ, LDK = C::LDK;
  constexpr int THREADS = C::kThreads, WQ = 16 * MT;
  constexpr int NSC = BK / 8;                // score n-tiles (keys)
  constexpr int NDT = DP / 8;                // output n-tiles
  constexpr int PQ = BQ * LDQ;               // q: big to small plane
  const int H = a.H, D = a.D, ps = a.page_size;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tile = gridDim.z - 1 - blockIdx.z;   // last tiles first
  // the decode grid launched after this one may start now
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int q_len = a.q_lens[b];
  const int t0 = tile * BQ;
  if (q_len <= kDecodeMaxQ || t0 >= q_len) return;
  const int nq = min(BQ, q_len - t0);
  const int kv_len = a.kv_lens[b];
  const int tok0 = a.q_starts[b] + t0;       // flat index of tile row 0
  const int pos0 = kv_len - q_len + t0;      // its global position
  const int cap = min(kv_len, a.pages_per_seq * ps);   // keys in the table
  const int n_keys = min(cap, pos0 + nq);    // the last row's view
  const int n_tiles = n_keys > 0 ? (n_keys + BK - 1) / BK : 0;
  const int* prow = a.page_table + (size_t)b * a.pages_per_seq;

  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + C::kQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wrow = warp * WQ;                // the warp's first tile row

  auto slot = [&](int j) { return ring + (j % NS) * C::kStage; };
  auto stage = [&](int j) {
    unsigned char* st = slot(j);
    E* ks = reinterpret_cast<E*>(st);
    E* vs = reinterpret_cast<E*>(st + C::kRows);
    float* sc = reinterpret_cast<float*>(st + 2 * C::kRows);
    stage_keys<T, DP, BK, LDK, THREADS>(a, prow, h, j * BK, n_keys, ks, vs,
                                        sc, sc + BK);
  };

  // q rows of the tile (rows past nq and columns past D read as 0)
  const float* qg = a.q + ((size_t)tok0 * H + h) * D;
  if (a.vec) {
    constexpr int kCh = DP / 4;
    for (int e = threadIdx.x; e < BQ * kCh; e += THREADS) {
      const int r = e / kCh, c = (e - r * kCh) * 4;
      const bool in = r < nq && c < D;
      cpasync::copy16(Qs + r * LDQ + c, in ? qg + (size_t)r * H * D + c : qg,
                      in);
    }
  } else {
    for (int e = threadIdx.x; e < BQ * DP; e += THREADS) {
      const int r = e / DP, c = e - r * DP;
      Qs[r * LDQ + c] = r < nq && c < D ? qg[(size_t)r * H * D + c] : 0.f;
    }
  }
  cpasync::commit();
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (j < n_tiles) stage(j);
    cpasync::commit();
  }
  cpasync::wait<NS - 1>();                   // q has landed
  __syncthreads();
  prep_q<DP, BQ, THREADS, kQuant>(Qs, a.scale_log2);
  const float* Qw = Qs + wrow * LDQ;

  // rows wrow + 16 m + g (hf 0) and + 8 (hf 1): the running max (log2
  // domain) and this thread's share of the row sum
  float o[MT][NDT][4], m[MT][2], l[MT][2];
  zero(o);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[mt][hf] = -INFINITY;
      l[mt][hf] = 0.f;
    }
  const bool active = wrow < nq;             // the warp has a real row
  const int lim_first = min(cap, pos0 + wrow + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    cpasync::wait<NS - 2>();                 // tile j has landed
    __syncthreads();                         // ... and tile j - 1 is done
    if (j + NS - 1 < n_tiles) stage(j + NS - 1);   // overlaps this tile
    cpasync::commit();
    // no row of this warp sees a key of the tile
    if (!active || k0 > pos0 + wrow + WQ - 1) continue;
    const unsigned char* st = slot(j);
    const float* kss = reinterpret_cast<const float*>(st + 2 * C::kRows);

    float s[MT][NSC][4];
    if constexpr (kQuant)
      scores_codes<T, MT, NSC, DP, LDQ, PQ, LDK>(s, Qw, st, lane);
    else
      scores<MT, NSC, DP, LDK, PQ>(s, Qw, reinterpret_cast<const float*>(st),
                                   lane);
    // this thread's key columns 8 n + 2 tq + e: their scales
    float ksc[NSC][2], vsc[NSC][2];
    if constexpr (kQuant) {
#pragma unroll
      for (int n = 0; n < NSC; ++n) {
        const float2 kk = *reinterpret_cast<const float2*>(kss + n * 8 + 2 * tq);
        const float2 vv =
            *reinterpret_cast<const float2*>(kss + BK + n * 8 + 2 * tq);
        ksc[n][0] = kk.x;
        ksc[n][1] = kk.y;
        vsc[n][0] = vv.x;
        vsc[n][1] = vv.y;
      }
    }
    // the mask binds only where the tile crosses a row's diagonal or the
    // end of the keys
    const bool masked = k0 + BK > lim_first;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = wrow + mt * 16 + g + hf * 8;
        const int lim = min(cap, pos0 + row + 1);
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NSC; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[mt][n][2 * hf + e];
            if constexpr (kQuant) x *= ksc[n][e];
            if (masked && k0 + n * 8 + 2 * tq + e >= lim) x = -INFINITY;
            s[mt][n][2 * hf + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[mt][hf], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = ex2(m[mt][hf] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NSC; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = ex2(s[mt][n][2 * hf + e] - m_use);
            sum += pe;
            s[mt][n][2 * hf + e] = kQuant ? pe * vsc[n][e] : pe;
          }
        l[mt][hf] = l[mt][hf] * alpha + sum;   // this thread's share
        m[mt][hf] = m_new;
#pragma unroll
        for (int nd = 0; nd < NDT; ++nd) {
          o[mt][nd][2 * hf] *= alpha;
          o[mt][nd][2 * hf + 1] *= alpha;
        }
      }
    }
    // O += P V (P scaled by V's scales for codes), the tile summed from
    // zero and added in float32
    if constexpr (kQuant)
      pv_codes<T, MT, NSC, NDT, LDK>(o, s, st + C::kRows, lane);
    else
      mma_tile<MT, NSC, NDT, LDK>(o, s,
                                  reinterpret_cast<const float*>(st + C::kRows),
                                  lane);
  }
  cpasync::wait<0>();
  if (!active) return;

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lt = l[mt][hf];
      lt += __shfl_xor_sync(kFull, lt, 1);
      lt += __shfl_xor_sync(kFull, lt, 2);
      const int row = wrow + mt * 16 + g + hf * 8;
      if (row >= nq) continue;
      float* dst = a.out + ((size_t)(tok0 + row) * H + h) * D;
#pragma unroll
      for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = kQuant ? NDT * (2 * tq + e) + nd : nd * 8 + 2 * tq + e;
          if (d < D) dst[d] = lt == 0.f ? 0.f : o[mt][nd][2 * hf + e] / lt;
        }
    }
  }
}

// ---------------------------------------------------------- decode rows

// One (row, head) of a one-query row, or one chunk of its pages under
// the KV split: the block's warps walk the pages (paged_walk.cuh's
// walk_pages; warp w takes pages p_begin + w, p_begin + w + W, ...), then
// merge in fixed warp order into the output row or the chunk's partial.
template <typename T, bool kSplit, int DP, int NS>
__device__ inline void decode_walk(const Params<T>& a) {
  static_assert(kDecodeMaxQ == 1, "the shared walk takes one query a row");
  using Wk = paged::Walk<T, DP>;
  const int H = a.H, D = a.D, ps = a.page_size;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  if (a.q_lens[b] != 1) return;
  const int kv_len = a.kv_lens[b];
  const int tok0 = a.q_starts[b];
  const int cap = min(kv_len, a.pages_per_seq * ps);
  const int n_pages = visible_pages(cap, ps);
  const int p_begin = kSplit ? c * a.split_pages : 0;
  const int p_end = kSplit ? min(p_begin + a.split_pages, n_pages) : n_pages;
  if (kSplit && p_begin >= p_end) return;    // nothing to merge: no write

  extern __shared__ __align__(128) unsigned char smem[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const size_t row = (size_t)tok0 * H + h;
  const paged::Pools pools{a.k_pool, a.v_pool, a.k_scale, a.v_scale,
                           H, D, ps, a.vec};
  const paged::State st = paged::walk_pages<T, DP, NS>(
      pools, a.page_table + (size_t)b * a.pages_per_seq, a.pages_per_seq, h,
      a.q + row * D, a.scale_log2, cap, p_begin + warp, W, p_end,
      smem + (size_t)warp * NS * Wk::stage_bytes(ps));

  // merge the warps in fixed order
  __syncthreads();                           // the rings are free
  float* parts = reinterpret_cast<float*>(smem);   // [W][R]
  paged::store_state<T, DP>(st, parts + warp * Wk::R);
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float mt, lt, at;
    paged::merge_states(d, W, [&](int w) { return parts + w * Wk::R; }, mt,
                        lt, at);
    if (kSplit) {
      float* rec = a.ws + ((size_t)c * a.N * H + row) * (D + 2);
      if (d == 0) {
        rec[0] = mt;
        rec[1] = lt;
      }
      rec[2 + d] = at;
    } else {
      a.out[row * D + d] = lt == 0.f ? 0.f : at / lt;
    }
  }
}

// The decode walk's grid. Launched after the tile kernel, it may start
// while that kernel runs (programmatic dependent launch: the two write
// disjoint rows and read nothing of each other), so the latency-bound
// decode blocks fill the SMs the tile's blocks leave idle; its first block
// waits for the tile kernel's end before it exits, so that this grid's end
// (which the combine and every later kernel of the stream wait for)
// implies both.
template <typename T, bool kSplit, int DP, int NS>
__global__ void __launch_bounds__(kDecodeWarps * 32)
ragged_decode_kernel(const Params<T> a) {
  decode_walk<T, kSplit, DP, NS>(a);
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Merge the decode rows' chunk partials in chunk order (the merge of
// ragged_attention_lax_split, in the log2 domain) and normalize. Only the
// chunks the decode kernel wrote are read: those with visible pages.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
ragged_split_combine_kernel(const Params<T> a) {
  const int H = a.H, D = a.D, W = D + 2, ps = a.page_size;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q_len = a.q_lens[b];
  if (q_len < 1 || q_len > kDecodeMaxQ) return;
  const int cap = min(a.kv_lens[b], a.pages_per_seq * ps);
  const int n_pages = visible_pages(cap, ps);
  const int n_written = (n_pages + a.split_pages - 1) / a.split_pages;
  const int tok0 = a.q_starts[b];
  for (int e = threadIdx.x; e < q_len * D; e += blockDim.x) {
    const int i = e / D, d = e - i * D;
    const size_t row = (size_t)(tok0 + i) * H + h;
    float m = -INFINITY, l = 0.f, acc = 0.f;
    for (int c = 0; c < n_written; ++c) {
      const float* rec = a.ws + ((size_t)c * a.N * H + row) * W;
      const float mc = rec[0];
      const float m_new = fmaxf(m, mc);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = ex2(m - mu), beta = ex2(mc - mu);
      l = l * alpha + rec[1] * beta;
      acc = acc * alpha + rec[2 + d] * beta;
      m = m_new;
    }
    a.out[row * D + d] = acc / (l == 0.f ? 1.f : l);
  }
}

template <typename T, int DP, int WARPS, int MT, int BK, int NS>
cudaError_t launch_tile(const Params<T>& a, int B, int max_q_len,
                        cudaStream_t s) {
  using C = Tile<T, DP, WARPS, MT, BK, NS>;
  const int tiles = (max_q_len + C::BQ - 1) / C::BQ;
  if (tiles > 65535) return cudaErrorInvalidValue;
  return start(ragged_tile_kernel<T, DP, WARPS, MT, BK, NS>,
               dim3(a.H, B, tiles), C::kThreads, C::kSmem, a, s);
}

template <typename T, bool kSplit, int DP, int NS>
cudaError_t launch_decode(const Params<T>& a, int B, bool after_tile,
                          cudaStream_t s) {
  using Wk = paged::Walk<T, DP>;
  const size_t per_warp = NS * Wk::stage_bytes(a.page_size);
  const int pages = kSplit ? a.split_pages : a.pages_per_seq;
  int warps = (pages + kDecodePagesPerWarp - 1) / kDecodePagesPerWarp;
  warps = warps < kDecodeWarps ? warps : kDecodeWarps;
  const size_t fit = (size_t)(227 * 1024) / per_warp;
  warps = fit < (size_t)warps ? (int)fit : warps;
  if (warps < 1) return cudaErrorInvalidValue;
  const size_t ring = warps * per_warp;
  const size_t merge = sizeof(float) * warps * kDecodeMaxQ * (DP + 2);
  const size_t smem = ring > merge ? ring : merge;
  const auto kernel = ragged_decode_kernel<T, kSplit, DP, NS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = after_tile ? 1 : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.H, kSplit ? a.n_chunks : 1, B);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, bool kSplit>
cudaError_t launch_decode_dp(const Params<T>& a, int B, bool after_tile,
                             cudaStream_t s) {
  constexpr int NS = kDecodeStages;
  if (a.D <= 32) return launch_decode<T, kSplit, 32, NS>(a, B, after_tile, s);
  if (a.D <= 64) return launch_decode<T, kSplit, 64, NS>(a, B, after_tile, s);
  return launch_decode<T, kSplit, 128, NS>(a, B, after_tile, s);
}

// the tile shapes: head dim padded to DP, WARPS warps of 16 * MT rows,
// BK-key tiles in an NS-stage ring
template <typename T>
cudaError_t launch_tile_dp(const Params<T>& a, int B, int max_q_len,
                           cudaStream_t s) {
  if constexpr (Page<T>::kQuant) {
    if (a.D <= 32) return launch_tile<T, 32, 4, 1, 64, 2>(a, B, max_q_len, s);
    if (a.D <= 64)
      return launch_tile<T, 64, 8, 1, 64, 2>(a, B, max_q_len, s);  // codes
    return launch_tile<T, 128, 4, 1, 32, 2>(a, B, max_q_len, s);
  } else {
    if (a.D <= 32) return launch_tile<T, 32, 4, 1, 32, 2>(a, B, max_q_len, s);
    if (a.D <= 64)
      return launch_tile<T, 64, 4, 2, 64, 2>(a, B, max_q_len, s);  // float32
    return launch_tile<T, 128, 2, 1, 32, 2>(a, B, max_q_len, s);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// The body of every C entry point. Launches on `stream`; returns
// cudaGetLastError() after the launches (0 = cudaSuccess). Takes
// D <= 128 and page_size <= 32; split_pages > 0 selects the KV split
// (the caller decides when it pays: split_active in paged_attention.py),
// which needs `workspace` [n_chunks, N, H, D + 2] with
// n_chunks = ceil(pages_per_seq / split_pages).
template <typename T>
int launch(const float* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale,
           const int* page_table, const int* kv_lens, const int* q_starts,
           const int* q_lens, float* out, float* workspace, int N, int B,
           int H, int D, int page_size, int pages_per_seq, int max_q_len,
           int split_pages, float sm_scale, void* stream) {
  if (B <= 0 || N <= 0 || max_q_len <= 0) return (int)cudaSuccess;
  if (D < 1 || D > 128 || page_size < 1 || page_size > 32
      || pages_per_seq < 1 || H < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (Page<T>::kQuant && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool split = split_pages > 0;
  const int n_chunks = split ? (pages_per_seq + split_pages - 1) / split_pages
                             : 1;
  if (split && workspace == nullptr) return (int)cudaErrorInvalidValue;
  if (n_chunks > 65535) return (int)cudaErrorInvalidValue;
  const int width = Page<T>::kQuant ? 16 : 4;   // elements a 16-byte copy
  const bool vec = D % width == 0 && aligned16(k_pool) && aligned16(v_pool)
                   && aligned16(q);
  const Params<T> a{q, k_pool, v_pool, k_scale, v_scale, page_table,
                    kv_lens, q_starts, q_lens, out, workspace, N, H, D,
                    page_size, pages_per_seq, split_pages, n_chunks,
                    vec ? 1 : 0, sm_scale * kLog2e};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the tile kernel first (the longer), then the decode walk, which may
  // start beside it
  const bool tiles = max_q_len > kDecodeMaxQ;
  cudaError_t e = tiles ? launch_tile_dp<T>(a, B, max_q_len, s)
                        : cudaSuccess;
  if (e == cudaSuccess)
    e = split ? launch_decode_dp<T, true>(a, B, tiles, s)
              : launch_decode_dp<T, false>(a, B, tiles, s);
  if (e != cudaSuccess || !split) return (int)e;
  ragged_split_combine_kernel<T><<<dim3(H, B), kCombineThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace ragged

// One C entry point per page type, all with this signature.
#define RAGGED_ATTENTION_ENTRY(NAME, T)                                     \
  extern "C" int NAME(const float* q, const void* k_pool,                   \
                      const void* v_pool, const void* k_scale,              \
                      const void* v_scale, const int* page_table,           \
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
