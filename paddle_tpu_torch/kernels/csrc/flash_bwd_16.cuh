// The 16-bit flash backward, included by flash_bwd_bf16.cu and
// flash_bwd_f16.cu with FLASH_ELEM / FLASH_SUFFIX set (flash_elem16.cuh).
//
// Flash attention backward for sm_90a, 16-bit inputs T (bf16 or float16),
// head_dim 64 or 128, behind the plain C entries flash_bwd_dkdv_<T> and
// flash_bwd_dq_<T> (suffix bf16 or f16). "bf16" below reads T.
//
// Replaces paddle_tpu/kernels/flash_attention.py::_bwd_dkdv_kernel (:167)
// and ::_bwd_dq_kernel (:227), both reached through _flash_bwd, for bf16.
// Semantics, as there: tensors are [B, H, S, D] with any (b, h, s) strides
// and a contiguous head dim; query i attends key j when not causal, or
// when j <= i + (Sk - Sq) (bottom-right causal). The kernels take lse and
// delta = rowsum(dO * O) (float32 [B, H, Sq], delta formed outside as the
// JAX package leaves it to XLA), recompute p = exp(s * scale - lse), zeroed
// where masked (a fully masked row has lse = NEG_INF, so s - lse alone
// would give p = 1), and form dS = p * (dP - delta) * scale. p is rounded
// to bf16 before P^T dO, dS to bf16 before dS^T Q and dS K, and every
// product sums in float32. Keys and rows past S contribute nothing; a row
// that sees no key gets dq = 0. dq, dk and dv are written in bf16.
//
// Bound. At the training shape [16, 12, 1024, 64] causal, dK/dV must read
// q, k, v, dO, lse and delta and write dk and dv once: 152.6 MB, 0.0455 ms
// at 3.35 TB/s; its four products are 8 * D operations per visible (query,
// key) pair, 51.6 GFLOP, 0.0522 ms at the tensor cores' 989 TFLOP/s. dQ
// moves 127.4 MB (0.0380 ms) for three products, 38.7 GFLOP (0.0391 ms).
// Both are bound by operations and bytes nearly alike, so the design keeps
// every intermediate in registers and hides every copy behind the mma.
//
// Design (FlashAttention-2's backward layout on mma.sync.m16n8k16). The
// Pallas kernels carry the dK/dV or dQ sum in VMEM across the sequential
// innermost grid axis; here a block owns one output tile and walks the
// other axis itself, so every output tile has one writer and there are no
// atomics (reruns give identical bits). The two-kernel split, with S and
// dP recomputed in dQ, is that deterministic form.
// - dK/dV: a block owns the keys of WARPS warps of one (b, h), 16 * MT to
//   a warp, and walks the query tiles of 32 rows from the first one that
//   sees the block's keys. Per tile, in registers: S^T = K Q^T and dP^T =
//   V dO^T (A fragments from the warp's K and V rows, B fragments from the
//   Q and dO rows, both by ldmatrix), P^T = 2^(S^T scale log2(e) - lse
//   log2(e)), dS^T = P^T (dP^T - delta) scale, both rounded to bf16: the
//   m16n8 accumulator layout of two adjacent score tiles is the A fragment
//   of the next mma as it stands. Then dV += P^T dO and dK += dS^T Q with
//   B fragments from ldmatrix.trans of the staged dO and Q, each B
//   fragment feeding the warp's MT row tiles. dK and dV stay float32 in
//   registers for the whole walk. At D 64: two warps of 32 keys (255
//   registers, four blocks an SM).
// - dQ: a block owns four warps of 16 query rows and walks the key tiles
//   of 64 up to the causal limit: S = Q K^T and dP = dO V^T, P and dS in
//   registers, dQ += dS K (K by ldmatrix.trans); each thread holds its
//   rows' lse and delta. At D 64: 168 registers, three blocks an SM.
// Nothing of S, P, dP or dS touches shared memory. The A fragments of the
// warp's own rows are re-read by ldmatrix at each k-step: holding them
// in registers (32 more) cost a block an SM and was no faster on the card.
// The walked tiles (Q, dO, lse, delta or K, V) are staged by cp.async
// into a two-stage ring, so the next tile's copy runs under this tile's
// mma. The causal and length masks are applied only on tiles that cross
// the diagonal or the end of a sequence; a warp whose keys (rows) see
// nothing of a tile skips it. Shared rows are padded by 16 bytes
// (ldmatrix's eight row reads fall on distinct bank groups); rows that
// are not 16-byte aligned take a scalar staging path (same bits). The
// output goes through the warp's own rows of shared memory and out in
// 16-byte stores. Grids put the heaviest causal tiles first: key tile 0
// for dK/dV, the last query tile for dQ.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "flash_elem16.cuh"

namespace {

using T = FLASH_ELEM;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 32;                      // queries per dK/dV tile
constexpr int kBK = 64;                      // keys per dQ tile
constexpr int kDqWarps = 4;                  // a dQ block: 4 warps of 16 rows

struct Strides {                             // in elements
  long long b, h, s;
};

struct Params {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;                          // [B, H, Sq]
  const float* delta;                        // [B, H, Sq]
  T* out0;                                   // dk, or dq
  T* out1;                                   // dv
  Strides sq, sk, sv, sdo, s0, s1;
  int H, Sq, Sk;
  float scale;                               // sm_scale
  float scale_log2;                          // sm_scale * log2(e)
  int causal;
};

using cpasync::smem_addr;

__device__ inline void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ inline void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 2^x on the special-function unit (results below 2^-126 flush to 0)
__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A fragment of k-step kk from the m16n8 accumulators of n-tiles 2kk and
// 2kk + 1, rounded to bf16
template <int N>
__device__ inline void to_a(uint32_t (&a)[4], const float (&c)[N][4],
                            int kk) {
  a[0] = elem16::pack<T>(c[2 * kk][0], c[2 * kk][1]);
  a[1] = elem16::pack<T>(c[2 * kk][2], c[2 * kk][3]);
  a[2] = elem16::pack<T>(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = elem16::pack<T>(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// a warp's A fragment of k-step kk from 16 shared rows of LD elements
template <int LD>
__device__ inline void load_a(uint32_t (&a)[4], const T* rows, int kk,
                              int lane) {
  ldsm_x4(a, rows + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
}

// c[m][n] += a[m] . rows^T over the 8 * N rows of `rows` (row n the column
// n of B): the B fragments of k-step kk by ldmatrix, two n-tiles a load,
// each feeding the MT row tiles
template <int MT, int N, int LD>
__device__ inline void mma_rows(float (&c)[MT][N][4],
                                const uint32_t (&a)[MT][4], const T* rows,
                                int kk, int lane) {
#pragma unroll
  for (int n2 = 0; n2 < N / 2; ++n2) {
    uint32_t b[4];
    ldsm_x4(b, rows + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD
                   + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      elem16::mma<T>(c[m][2 * n2], a[m], b[0], b[1]);
      elem16::mma<T>(c[m][2 * n2 + 1], a[m], b[2], b[3]);
    }
  }
}

// c[m][n] += a[m] . rows[16 kk, 16 kk + 16) over the 8 * N columns of
// `rows` (row r the row r of B): the B fragments by ldmatrix.trans
template <int MT, int N, int LD>
__device__ inline void mma_cols(float (&c)[MT][N][4],
                                const uint32_t (&a)[MT][4], const T* rows,
                                int kk, int lane) {
#pragma unroll
  for (int n2 = 0; n2 < N / 2; ++n2) {
    uint32_t b[4];
    ldsm_x4_trans(b, rows + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                             * LD + n2 * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      elem16::mma<T>(c[m][2 * n2], a[m], b[0], b[1]);
      elem16::mma<T>(c[m][2 * n2 + 1], a[m], b[2], b[3]);
    }
  }
}

template <int MT, int N>
__device__ inline void zero(float (&c)[MT][N][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[m][n][e] = 0.f;
}

// c = arows . rows^T over the D / 16 k-steps of the head dim (S = Q K^T,
// S^T = K Q^T, dP = dO V^T, dP^T = V dO^T), the A fragments read from the
// warp's 16 * MT shared rows `arows` by ldmatrix at each k-step
template <int MT, int N, int KD, int LD>
__device__ inline void scores(float (&c)[MT][N][4], const T* arows,
                              const T* rows, int lane) {
  zero(c);
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) load_a<LD>(a[m], arows + m * 16 * LD, kk,
                                            lane);
    mma_rows<MT, N, LD>(c, a, rows, kk, lane);
  }
}

// rows [r0, r0 + ROWS) of one (b, h) slice into shared rows of D + 8
// elements; rows at or past S read as 0. Aligned rows go by cp.async (the
// caller commits and waits); others by plain loads and stores.
template <int D, int ROWS, int THREADS, bool kAligned>
__device__ inline void stage_rows(T* dst, const T* base, long long stride,
                                  int r0, int S) {
  constexpr int LD = D + 8;
  if constexpr (kAligned) {
    constexpr int kChunks = D / 8;           // 16-byte chunks per row
    static_assert(ROWS * kChunks % THREADS == 0, "whole chunks per thread");
#pragma unroll
    for (int it = 0; it < ROWS * kChunks / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int r = i / kChunks, c = (i % kChunks) * 8, row = r0 + r;
      const bool in = row < S;
      cpasync::copy16(dst + r * LD + c, in ? base + row * stride + c : base,
                      in);
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
      const int r = i / D, c = i % D, row = r0 + r;
      dst[r * LD + c] =
          row < S ? base[row * stride + c] : elem16::from_float<T>(0.f);
    }
  }
}

// a warp's 16 x D float32 sums (m16n8 layout) as bf16 rows [row0, row0 +
// 16) of one (b, h) slice: through the warp's own 16 shared rows `tile`
// (no other warp reads them), then 16-byte stores a row's threads side by
// side; rows at or past S are not written
template <int D, bool kAligned>
__device__ inline void store_rows(T* tile, const float (&c)[D / 8][4],
                                  T* base, long long stride, int row0, int S,
                                  int lane) {
  constexpr int LD = D + 8, kChunks = D / 8;
  const int g = lane >> 2, tq = lane & 3;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<uint32_t*>(tile + (g + hf * 8) * LD + n * 8
                                         + 2 * tq) =
          elem16::pack<T>(c[n][2 * hf], c[n][2 * hf + 1]);
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / kChunks, col = (i % kChunks) * 8, row = row0 + r;
    if (row >= S) continue;
    if constexpr (kAligned) {
      *reinterpret_cast<uint4*>(base + row * stride + col) =
          *reinterpret_cast<const uint4*>(tile + r * LD + col);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        base[row * stride + col + e] = tile[r * LD + col + e];
    }
  }
}

// ---------------------------------------------------------------- dK / dV

// A block of WARPS warps owning 16 * MT keys each; query tiles of kBQ
// rows. Shared memory: K and V rows, then a two-stage ring of (Q, dO, lse,
// delta) tiles.
template <int D, int WARPS, int MT>
struct DkdvCfg {
  static constexpr int kThreads = WARPS * 32;
  static constexpr int BK = 16 * MT * WARPS;
  static constexpr int LD = D + 8;
  static constexpr size_t kKV = sizeof(T) * 2 * BK * LD;
  static constexpr size_t kStage = sizeof(T) * 2 * kBQ * LD
                                   + sizeof(float) * 2 * kBQ;
  static constexpr size_t kSmem = kKV + 2 * kStage;
  static_assert(kStage % 16 == 0, "16-byte aligned stages");
};

template <int D, int WARPS, int MT, bool kAligned>
__global__ void __launch_bounds__(WARPS * 32)
bwd_dkdv_kernel(const Params p) {
  using C = DkdvCfg<D, WARPS, MT>;
  constexpr int BK = C::BK, BQ = kBQ, LD = C::LD, THREADS = C::kThreads;
  constexpr int KD = D / 16;                 // k-steps over the head dim
  constexpr int NQ = BQ / 8;                 // score n-tiles (queries)
  constexpr int ND = D / 8;                  // output n-tiles
  constexpr int WK = 16 * MT;                // keys per warp
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BK * LD;
  unsigned char* ring = smem + C::kKV;       // [stage][Q, dO, lse, delta]

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int k0 = blockIdx.y * BK;            // key tile 0 (heaviest) first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;    // row group, thread in group
  const int wkey = k0 + warp * WK;           // the warp's first key
  const int offset = p.Sk - p.Sq;
  // the first query tile holding a row that sees key k0 (row + offset >= k0)
  const int q_begin = p.causal ? max(0, k0 - offset) / BQ * BQ : 0;
  const int n_tiles = q_begin < p.Sq ? (p.Sq - q_begin + BQ - 1) / BQ : 0;
  const T* qb = p.q + b * p.sq.b + h * p.sq.h;
  const T* ob = p.dout + b * p.sdo.b + h * p.sdo.h;
  const long long bh = (long long)b * p.H + h;
  const float* lse_bh = p.lse + bh * p.Sq;
  const float* delta_bh = p.delta + bh * p.Sq;

  // tile j of the walk into ring stage j & 1
  auto stage = [&](int j) {
    const int r0 = q_begin + j * BQ;
    T* Qs = reinterpret_cast<T*>(ring + (j & 1) * C::kStage);
    stage_rows<D, BQ, THREADS, kAligned>(Qs, qb, p.sq.s, r0, p.Sq);
    stage_rows<D, BQ, THREADS, kAligned>(Qs + BQ * LD, ob, p.sdo.s, r0,
                                         p.Sq);
    float* stats = reinterpret_cast<float*>(Qs + 2 * BQ * LD);
    for (int i = threadIdx.x; i < 2 * BQ; i += THREADS) {
      const int row = r0 + i % BQ;
      const float* src = i < BQ ? lse_bh : delta_bh;
      cpasync::copy4(stats + i, src + (row < p.Sq ? row : 0), row < p.Sq);
    }
  };

  stage_rows<D, BK, THREADS, kAligned>(Ks, p.k + b * p.sk.b + h * p.sk.h,
                                       p.sk.s, k0, p.Sk);
  stage_rows<D, BK, THREADS, kAligned>(Vs, p.v + b * p.sv.b + h * p.sv.h,
                                       p.sv.s, k0, p.Sk);
  cpasync::commit();
  if (n_tiles > 0) stage(0);
  cpasync::commit();
  cpasync::wait<1>();                        // K and V have landed
  __syncthreads();

  const T* Kw = Ks + warp * WK * LD;         // this warp's rows
  const T* Vw = Vs + warp * WK * LD;

  float dk[MT][ND][4], dv[MT][ND][4];
  zero(dk);
  zero(dv);
  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = q_begin + j * BQ;
    cpasync::wait<0>();                      // tile j has landed
    __syncthreads();                         // ... and tile j - 1 is done
    if (j + 1 < n_tiles) stage(j + 1);       // overlaps this tile's mma
    cpasync::commit();
    // no query of this tile sees a key of this warp
    if (p.causal && q0 + BQ - 1 + offset < wkey) continue;
    const T* Qs = reinterpret_cast<const T*>(ring + (j & 1) * C::kStage);
    const T* dOs = Qs + BQ * LD;
    const float* Ls = reinterpret_cast<const float*>(dOs + BQ * LD);
    const float* Ds = Ls + BQ;

    // S^T = K Q^T (keys x queries), then P^T = 2^(S^T scale log2(e) - lse
    // log2(e)); the mask binds only where the tile crosses the diagonal or
    // the end of either sequence
    float s[MT][NQ][4];
    scores<MT, NQ, KD, LD>(s, Kw, Qs, lane);
    const bool masked = wkey + WK > p.Sk || q0 + BQ > p.Sq
                        || (p.causal && wkey + WK - 1 > q0 + offset);
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(Ls + n * 8 + 2 * tq);
      const float nl[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = ex2(fmaf(s[m][n][e], p.scale_log2, nl[e & 1]));
          if (masked) {
            const int key = wkey + m * 16 + g + (e >> 1) * 8;
            const int row = q0 + n * 8 + 2 * tq + (e & 1);
            if (!(row < p.Sq && key < p.Sk
                  && (!p.causal || key <= row + offset)))
              x = 0.f;
          }
          s[m][n][e] = x;
        }
    }
    // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) scale in its registers
    float dp[MT][NQ][4];
    scores<MT, NQ, KD, LD>(dp, Vw, dOs, lane);
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float2 d2 = *reinterpret_cast<const float2*>(Ds + n * 8 + 2 * tq);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[m][n][e] = s[m][n][e] * (dp[m][n][e] - ((e & 1) ? d2.y : d2.x))
                        * p.scale;
    }
    // dV += P^T dO and dK += dS^T Q over the tile's BQ queries
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[MT][4], da[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        to_a(pa[m], s[m], kk);               // p.astype(do.dtype)
        to_a(da[m], dp[m], kk);              // ds.astype(q.dtype)
      }
      mma_cols<MT, ND, LD>(dv, pa, dOs, kk, lane);
      mma_cols<MT, ND, LD>(dk, da, Qs, kk, lane);
    }
  }
  cpasync::wait<0>();

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r = warp * WK + m * 16;
    store_rows<D, kAligned>(Ks + r * LD, dk[m],
                            p.out0 + b * p.s0.b + h * p.s0.h, p.s0.s,
                            k0 + r, p.Sk, lane);
    store_rows<D, kAligned>(Vs + r * LD, dv[m],
                            p.out1 + b * p.s1.b + h * p.s1.h, p.s1.s,
                            k0 + r, p.Sk, lane);
  }
}

// --------------------------------------------------------------------- dQ

// A block of kDqWarps warps owning 16 query rows each (one row tile: MT
// = 1). Shared memory: Q and dO rows, then a two-stage ring of (K, V)
// tiles of kBK keys.
template <int D>
struct DqCfg {
  static constexpr int kThreads = kDqWarps * 32;
  static constexpr int BQ = 16 * kDqWarps;
  static constexpr int LD = D + 8;
  static constexpr size_t kQO = sizeof(T) * 2 * BQ * LD;
  static constexpr size_t kStage = sizeof(T) * 2 * kBK * LD;
  static constexpr size_t kSmem = kQO + 2 * kStage;
};

template <int D, bool kAligned>
__global__ void __launch_bounds__(kDqWarps * 32)
bwd_dq_kernel(const Params p) {
  using C = DqCfg<D>;
  constexpr int BQ = C::BQ, MT = 1, LD = C::LD, THREADS = C::kThreads;
  constexpr int KD = D / 16;                 // k-steps over the head dim
  constexpr int NS = kBK / 8;                // score n-tiles (keys)
  constexpr int ND = D / 8;                  // output n-tiles
  constexpr int WQ = 16 * MT;                // rows per warp
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + BQ * LD;
  T* ring = dOs + BQ * LD;                   // [stage][K, V][kBK][LD]

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wrow = q0 + warp * WQ;           // the warp's first row
  const int offset = p.Sk - p.Sq;
  // the key tiles the block's rows can see end before this key
  const int k_end = p.causal ? min(p.Sk, max(0, q0 + BQ + offset)) : p.Sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  const T* kb = p.k + b * p.sk.b + h * p.sk.h;
  const T* vb = p.v + b * p.sv.b + h * p.sv.h;

  // tile j of the walk into ring stage j & 1
  auto stage = [&](int j) {
    T* Ks = ring + (j & 1) * 2 * kBK * LD;
    stage_rows<D, kBK, THREADS, kAligned>(Ks, kb, p.sk.s, j * kBK, p.Sk);
    stage_rows<D, kBK, THREADS, kAligned>(Ks + kBK * LD, vb, p.sv.s,
                                          j * kBK, p.Sk);
  };

  stage_rows<D, BQ, THREADS, kAligned>(Qs, p.q + b * p.sq.b + h * p.sq.h,
                                       p.sq.s, q0, p.Sq);
  stage_rows<D, BQ, THREADS, kAligned>(
      dOs, p.dout + b * p.sdo.b + h * p.sdo.h, p.sdo.s, q0, p.Sq);
  cpasync::commit();
  if (n_tiles > 0) stage(0);
  cpasync::commit();

  // this thread's rows wrow + 16 m + g (+ 8): -lse log2(e) and delta
  const long long bh = (long long)b * p.H + h;
  float nl[MT][2], dl[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = wrow + m * 16 + g + hf * 8;
      nl[m][hf] = row < p.Sq ? -p.lse[bh * p.Sq + row] * kLog2e : 0.f;
      dl[m][hf] = row < p.Sq ? p.delta[bh * p.Sq + row] : 0.f;
    }
  cpasync::wait<1>();                        // Q and dO have landed
  __syncthreads();

  const T* Qw = Qs + warp * WQ * LD;         // this warp's rows
  const T* dOw = dOs + warp * WQ * LD;

  float dq[MT][ND][4];
  zero(dq);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    cpasync::wait<0>();                      // tile j has landed
    __syncthreads();                         // ... and tile j - 1 is done
    if (j + 1 < n_tiles) stage(j + 1);       // overlaps this tile's mma
    cpasync::commit();
    // no row of this warp sees a key of the tile
    if (p.causal && k0 > wrow + WQ - 1 + offset) continue;
    const T* Ks = ring + (j & 1) * 2 * kBK * LD;
    const T* Vs = Ks + kBK * LD;

    // S = Q K^T, then P = 2^(S scale log2(e) - lse log2(e)); the mask
    // binds only where the tile crosses the diagonal or the end of the keys
    float s[MT][NS][4];
    scores<MT, NS, KD, LD>(s, Qw, Ks, lane);
    const bool masked =
        k0 + kBK > p.Sk || (p.causal && k0 + kBK - 1 > wrow + offset);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = ex2(fmaf(s[m][n][e], p.scale_log2, nl[m][e >> 1]));
          if (masked) {
            const int row = wrow + m * 16 + g + (e >> 1) * 8;
            const int key = k0 + n * 8 + 2 * tq + (e & 1);
            if (!(row < p.Sq && key < p.Sk
                  && (!p.causal || key <= row + offset)))
              x = 0.f;
          }
          s[m][n][e] = x;
        }
    // dP = dO V^T, then dS = P (dP - delta) scale in its registers, rounded
    // to bf16 (ds.astype(k.dtype)) as the A fragments of dQ += dS K
    float dp[MT][NS][4];
    scores<MT, NS, KD, LD>(dp, dOw, Vs, lane);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[m][n][e] = s[m][n][e] * (dp[m][n][e] - dl[m][e >> 1]) * p.scale;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t da[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) to_a(da[m], dp[m], kk);
      mma_cols<MT, ND, LD>(dq, da, Ks, kk, lane);
    }
  }
  cpasync::wait<0>();

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r = warp * WQ + m * 16;
    store_rows<D, kAligned>(Qs + r * LD, dq[m],
                            p.out0 + b * p.s0.b + h * p.s0.h, p.s0.s,
                            q0 + r, p.Sq, lane);
  }
}

// ----------------------------------------------------------------- launch

// whether a tensor's rows of one (b, h) slice take 16-byte copies
bool aligned16(const void* base, const long long* st) {
  unsigned long long bits = reinterpret_cast<unsigned long long>(base);
  for (int i = 0; i < 3; ++i) bits |= (unsigned long long)(st[i] * 2);
  return (bits & 15) == 0;
}

template <typename Kernel>
cudaError_t start(Kernel kernel, dim3 grid, int threads, size_t smem,
                  const Params& p, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int WARPS, int MT>
cudaError_t launch_dkdv(const Params& p, int B, bool fast,
                        cudaStream_t stream) {
  using C = DkdvCfg<D, WARPS, MT>;
  const int tiles = (p.Sk + C::BK - 1) / C::BK;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * p.H, tiles);
  return fast ? start(bwd_dkdv_kernel<D, WARPS, MT, true>, grid,
                      C::kThreads, C::kSmem, p, stream)
              : start(bwd_dkdv_kernel<D, WARPS, MT, false>, grid,
                      C::kThreads, C::kSmem, p, stream);
}

template <int D>
cudaError_t launch_dq(const Params& p, int B, bool fast,
                      cudaStream_t stream) {
  using C = DqCfg<D>;
  const int tiles = (p.Sq + C::BQ - 1) / C::BQ;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * p.H, tiles);
  return fast ? start(bwd_dq_kernel<D, true>, grid,
                      C::kThreads, C::kSmem, p, stream)
              : start(bwd_dq_kernel<D, false>, grid,
                      C::kThreads, C::kSmem, p, stream);
}

bool shape_ok(int B, int H, int Sq, int Sk) {
  return B > 0 && H > 0 && Sq > 0 && Sk > 0 && B <= 65535 && H <= 65535
         && (long long)B * H <= 0x7fffffffLL;
}

Strides at(const long long* st, int t) {
  return Strides{st[3 * t], st[3 * t + 1], st[3 * t + 2]};
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after the
// launch (0 = cudaSuccess); a shape the kernels do not take returns
// cudaErrorInvalidValue without launching. `strides` holds (b, h, s) of
// each tensor in argument order, in elements. The D-64 tile shapes were
// picked by timing candidates at [16, 12, 1024, 64] on the card; D 128
// takes shapes whose sums fit in 255 registers without spilling.
extern "C" int FLASH_ENTRY(flash_bwd_dkdv_)(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const float* lse,
                                            const float* delta, void* dk,
                                            void* dv, const long long* strides,
                                            int B, int H, int Sq, int Sk,
                                            int D, float scale, int causal,
                                            void* stream) {
  if (!shape_ok(B, H, Sq, Sk)) return (int)cudaErrorInvalidValue;
  const long long* st = strides;
  const Params p{static_cast<const T*>(q), static_cast<const T*>(k),
                 static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                 delta, static_cast<T*>(dk), static_cast<T*>(dv), at(st, 0),
                 at(st, 1), at(st, 2), at(st, 3), at(st, 4), at(st, 5), H, Sq,
                 Sk, scale, scale * kLog2e, causal};
  bool fast = true;
  const void* ptrs[6] = {q, k, v, dout, dk, dv};
  for (int t = 0; t < 6; ++t) fast = fast && aligned16(ptrs[t], st + 3 * t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch_dkdv<64, 2, 2>(p, B, fast, s);
  if (D == 128) return (int)launch_dkdv<128, 4, 1>(p, B, fast, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int FLASH_ENTRY(flash_bwd_dq_)(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const float* lse, const float* delta,
                                          void* dq, const long long* strides,
                                          int B, int H, int Sq, int Sk, int D,
                                          float scale, int causal,
                                          void* stream) {
  if (!shape_ok(B, H, Sq, Sk)) return (int)cudaErrorInvalidValue;
  const long long* st = strides;
  const Params p{static_cast<const T*>(q), static_cast<const T*>(k),
                 static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                 delta, static_cast<T*>(dq), nullptr, at(st, 0), at(st, 1),
                 at(st, 2), at(st, 3), at(st, 4), Strides{0, 0, 0}, H, Sq, Sk,
                 scale, scale * kLog2e, causal};
  bool fast = true;
  const void* ptrs[5] = {q, k, v, dout, dq};
  for (int t = 0; t < 5; ++t) fast = fast && aligned16(ptrs[t], st + 3 * t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch_dq<64>(p, B, fast, s);
  if (D == 128) return (int)launch_dq<128>(p, B, fast, s);
  return (int)cudaErrorInvalidValue;
}
