// Flash attention backward for sm_90a, float32 inputs, head_dim 64 or 128,
// on the TF32 tensor cores in 3xTF32 (tf32x3.cuh), behind the plain C
// entries flash_bwd_dkdv_f32 and flash_bwd_dq_f32.
//
// Replaces paddle_tpu/kernels/flash_attention.py::_bwd_dkdv_kernel (:167)
// and ::_bwd_dq_kernel (:227), both reached through _flash_bwd, for
// float32. Semantics, as there: tensors are [B, H, S, D] with any (b, h, s)
// strides and a contiguous head dim; query i attends key j when not causal,
// or when j <= i + (Sk - Sq) (bottom-right causal). The kernels take lse and
// delta = rowsum(dO * O) (float32 [B, H, Sq], delta formed outside as the
// JAX package leaves it to XLA), recompute p = exp(s * scale - lse), zeroed
// where masked (a fully masked row has lse = NEG_INF, so s - lse alone would
// give p = 1), and form dS = p * (dP - delta) * scale, all in float32. Keys
// and rows past S contribute nothing; a row that sees no key gets dq = 0.
//
// Accuracy. Every product runs as three TF32 mma.sync (a_small b_big +
// a_big b_small + a_big b_big, tf32x3.cuh), about 2^-20 relative per
// product against 2^-11 for one TF32 product, whatever
// torch.backends.cuda.matmul.allow_tf32 says. The tensor cores' float32
// sums truncate, so the second products sum each walked tile from zero and
// add it to dK, dV or dQ with a rounded float32 add (mma_tile). p is
// 2^(s * scale log2(e) - lse log2(e)) on the special-function unit
// (ex2.approx, ~2^-22 relative; the rounding of the two float32 factors
// adds ~1e-6 at |s * scale| ~ 10). At the training shape the gradients'
// error against float64 is the plain float32 version's (9.4e-6 and 9.5e-6
// on the card), far inside the 1e-4 they are held to.
//
// Bound. At the training shape [16, 12, 1024, 64] causal, dK/dV must read
// q, k, v, dO, lse and delta and write dk and dv once: 303.6 MB, 0.0906 ms
// at 3.35 TB/s; its four products are 8 * D operations per visible (query,
// key) pair, 51.6 GFLOP, which 3xTF32 runs as 154.8 GFLOP of TF32: 0.3127
// ms at the tensor cores' 495 TFLOP/s (0.770 ms at the 67 TFLOP/s of
// float32 FMAs outside them). dQ moves 253.2 MB (0.0756 ms) for three
// products, 38.7 GFLOP, 0.2345 ms in 3xTF32. Both are bound by operations.
// What the tensor cores leave to the other units is the split of every
// operand (an add, a mask and a subtraction: tf32x3::split) and the
// softmax's elementwise steps, so the design keeps that work small: the
// block's own rows are split once, every intermediate stays in registers,
// and every copy runs behind the mma.
//
// Design (FlashAttention-2's backward layout, as flash_bwd_bf16.cu, on
// mma.sync.m16n8k8 tf32). A block owns one output tile and walks the other
// axis itself, so every output tile has one writer and there are no atomics
// (reruns give identical bits); S and dP are recomputed in dQ.
// - dK/dV: a block owns the keys of WARPS warps of one (b, h), 16 * MT to a
//   warp, and walks the query tiles of BQ rows from the first one that sees
//   the block's keys. Per tile, in registers: S^T = K Q^T and dP^T = V dO^T,
//   P^T = 2^(S^T scale log2(e) - lse log2(e)), dS^T = P^T (dP^T - delta)
//   scale; then dV += P^T dO and dK += dS^T Q. dK and dV stay float32 in
//   registers for the whole walk. At D 64: four warps of 16 keys, 32-query
//   tiles (216 registers, two blocks an SM).
// - dQ: a block owns WARPS warps of 16 * MT query rows and walks the key
//   tiles of BK up to the causal limit: S = Q K^T, dP = dO V^T, dS in
//   registers, dQ += dS K. At D 64: eight warps of 16 rows, 32-key tiles
//   (125 registers, one block an SM).
// P and dS are A operands of the next products as they stand: the m16n8k8
// accumulator holds score columns (2t, 2t + 1), the A fragment columns (t,
// t + 4), so the registers {c0, c2, c1, c3} of one score n-tile are the A
// fragment of one k-step with the step's 8 keys (queries) in the order (0,
// 2, 4, 6, 1, 3, 5, 7), and the B fragment of that step reads rows 2t and
// 2t + 1 of the dO, Q or K tile: the same terms, so the sum is exact.
// Fragments of shared rows in the [n][k] form (K, V, Q, dO as the operands
// of the scores) come by ldmatrix, moving 32-bit words; the [k][n] form (dO,
// Q, K as B of the second products) by 32-bit loads (ldmatrix.trans moves
// 16-bit elements only). A row stride of D + 4 words makes both
// conflict-free: g * (D + 4) + t and 2t * (D + 4) + g cover the 32 banks,
// and ldmatrix's eight 16-byte rows fall on distinct bank groups. The
// block's own rows (K and V, or Q and dO) are split once into big and small
// planes when the block starts; the walked tiles are staged by cp.async into
// a two-stage ring (lse and delta ride with the Q and dO tile) and split as
// each fragment is read (every warp splits what it reads: splitting a tile
// once into planes for the whole block took twice its shared memory and a
// barrier more, and was slower on the card). The causal
// and length masks apply only on tiles that cross the diagonal or the end of
// a sequence; a warp whose keys (rows) see nothing of a tile skips it. Rows
// that are not 16-byte aligned take a scalar staging path (same bits).
// Grids put the heaviest causal tiles first: key tile 0 for dK/dV, the last
// query tile for dQ.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "tf32x3.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Strides {                             // in elements
  long long b, h, s;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;                          // [B, H, Sq]
  const float* delta;                        // [B, H, Sq]
  float* out0;                               // dk, or dq
  float* out1;                               // dv
  Strides sq, sk, sv, sdo, s0, s1;
  int H, Sq, Sk;
  float scale;                               // sm_scale
  float scale_log2;                          // sm_scale * log2(e)
  int causal;
};

using cpasync::smem_addr;
using tf32x3::mma_tf32x3;
using tf32x3::split;

// four 8 x 8 matrices of 16-bit elements, here moving 32-bit words: lane l
// gets word l % 4 of row l / 4 of matrix i in register i; lanes 8i..8i+7
// give the row addresses of matrix i
__device__ inline void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 2^x on the special-function unit (results below 2^-126 flush to 0)
__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// The fragment loads read tiles of float32 rows (row stride LD words) in
// shared memory: the block's own rows split already (the small plane PLANE
// words after the big one), the walked tiles raw, split as they are read.

// A fragment of k-step kk from 16 split rows [row][k]: the matrices (rows
// 0-7, words 0-3), (8-15, 0-3), (0-7, 4-7), (8-15, 4-7) are a0..a3
template <int LD, int PLANE>
__device__ inline void load_a(uint32_t (&big)[4], uint32_t (&small)[4],
                              const float* rows, int kk, int lane) {
  const float* at = rows + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD
                    + kk * 8 + (lane >> 4) * 4;
  ldsm_x4(big, at);
  ldsm_x4(small, at + PLANE);
}

// B fragments of k-step kk for n-tiles 2 n2 and 2 n2 + 1 from raw rows
// [n][k]: the matrices (n-tile 2 n2, words 0-3), (2 n2, 4-7), (2 n2 + 1,
// 0-3), (2 n2 + 1, 4-7) are b0, b1 of the first n-tile and b0, b1 of the
// second
template <int LD>
__device__ inline void load_b2(uint32_t (&big)[4], uint32_t (&small)[4],
                               const float* rows, int n2, int kk, int lane) {
  uint32_t raw[4];
  ldsm_x4(raw, rows + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 8
                   + ((lane >> 3) & 1) * 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(raw[i]), big[i], small[i]);
}

// B fragment of k-step jj for n-tile nd from raw rows [k][n], in the key
// (query) order of c_to_a: b0 = rows[8 jj + 2t][8 nd + g], b1 = rows[8 jj
// + 2t + 1][8 nd + g]
template <int LD>
__device__ inline void load_b_perm(uint32_t (&big)[2], uint32_t (&small)[2],
                                   const float* rows, int jj, int nd,
                                   int lane) {
  const float* at = rows + (jj * 8 + 2 * (lane & 3)) * LD + nd * 8
                    + (lane >> 2);
  split(at[0], big[0], small[0]);
  split(at[LD], big[1], small[1]);
}

// the A fragment of one k-step from the accumulators of one score n-tile:
// registers {c0, c2, c1, c3} put score column 2t at A column t and 2t + 1
// at t + 4 (the rows g, g + 8 agree), which load_b_perm's rows match
__device__ inline void c_to_a(uint32_t (&big)[4], uint32_t (&small)[4],
                              const float (&c)[4]) {
  split(c[0], big[0], small[0]);
  split(c[2], big[1], small[1]);
  split(c[1], big[2], small[2]);
  split(c[3], big[3], small[3]);
}

// c[m][n] = arows[16 m + i] . brows[8 n + j] over the D / 8 k-steps of the
// head dim (S^T = K Q^T, dP^T = V dO^T, S = Q K^T, dP = dO V^T): the warp's
// 16 * MT split rows `arows` as A, each B fragment feeding the MT row tiles
template <int MT, int N, int D, int LD, int PA>
__device__ inline void scores(float (&c)[MT][N][4], const float* arows,
                              const float* brows, int lane) {
  zero(c);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ab[MT][4], as[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      load_a<LD, PA>(ab[m], as[m], arows + m * 16 * LD, kk, lane);
#pragma unroll
    for (int n2 = 0; n2 < N / 2; ++n2) {
      uint32_t bb[4], bs[4];
      load_b2<LD>(bb, bs, brows, n2, kk, lane);
      const uint32_t b0b[2] = {bb[0], bb[1]}, b0s[2] = {bs[0], bs[1]};
      const uint32_t b1b[2] = {bb[2], bb[3]}, b1s[2] = {bs[2], bs[3]};
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_tf32x3(c[m][2 * n2], ab[m], as[m], b0b, b0s);
        mma_tf32x3(c[m][2 * n2 + 1], ab[m], as[m], b1b, b1s);
      }
    }
  }
}

// c[m][nd] += a[m] . rows over the NK k-steps of a walked tile and the D / 8
// column n-tiles of `rows` (dV += P^T dO, dK += dS^T Q, dQ += dS K), the A
// fragment of k-step jj from the score accumulators sc[m][jj] (c_to_a).
// The tile is summed from zero in t, 64 columns a pass at D 64 and 32 at D
// 128 (where dK and dV alone take 128 registers a thread), and then added to
// c by rounded float32 adds: the tensor cores' float32 sum truncates, and a
// whole walk's chain of mma into one accumulator drifts (7e-5 on dV at Sq =
// Sk = 1000 on the card, 12x the plain version's error against float64).
template <int MT, int NK, int ND, int LD>
__device__ inline void mma_tile(float (&c)[MT][ND][4],
                                const float (&sc)[MT][NK][4],
                                const float* rows, int lane) {
  constexpr int NP = ND <= 8 ? ND : 4;       // output n-tiles a pass
#pragma unroll
  for (int n0 = 0; n0 < ND; n0 += NP) {
    float t[MT][NP][4];
    zero(t);
#pragma unroll
    for (int jj = 0; jj < NK; ++jj) {
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) c_to_a(ab[m], as[m], sc[m][jj]);
#pragma unroll
      for (int nd = 0; nd < NP; ++nd) {
        uint32_t bb[2], bs[2];
        load_b_perm<LD>(bb, bs, rows, jj, n0 + nd, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          mma_tf32x3(t[m][nd], ab[m], as[m], bb, bs);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nd = 0; nd < NP; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[m][n0 + nd][e] += t[m][nd][e];
  }
}

// rows [r0, r0 + ROWS) of one (b, h) slice into shared rows of D + 4 words;
// rows at or past S read as 0. Aligned rows go by cp.async (the caller
// commits and waits); others by plain loads and stores.
template <int D, int ROWS, int THREADS, bool kAligned>
__device__ inline void stage_rows(float* dst, const float* base,
                                  long long stride, int r0, int S) {
  constexpr int LD = D + 4;
  if constexpr (kAligned) {
    constexpr int kChunks = D / 4;           // 16-byte chunks per row
    static_assert(ROWS * kChunks % THREADS == 0, "whole chunks per thread");
#pragma unroll
    for (int it = 0; it < ROWS * kChunks / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int r = i / kChunks, c = (i % kChunks) * 4, row = r0 + r;
      const bool in = row < S;
      cpasync::copy16(dst + r * LD + c, in ? base + row * stride + c : base,
                      in);
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
      const int r = i / D, c = i % D, row = r0 + r;
      dst[r * LD + c] = row < S ? base[row * stride + c] : 0.f;
    }
  }
}

// split ROWS raw rows in place: the big halves stay where the rows are,
// the small halves go to the plane ROWS * (D + 4) words after them
template <int D, int ROWS, int THREADS>
__device__ inline void split_rows(float* rows) {
  constexpr int LD = D + 4, kChunks = D / 4;
#pragma unroll 2
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    float* at = rows + (i / kChunks) * LD + (i % kChunks) * 4;
    const uint4 x = *reinterpret_cast<const uint4*>(at);
    uint4 big, small;
    split(__uint_as_float(x.x), big.x, small.x);
    split(__uint_as_float(x.y), big.y, small.y);
    split(__uint_as_float(x.z), big.z, small.z);
    split(__uint_as_float(x.w), big.w, small.w);
    *reinterpret_cast<uint4*>(at) = big;
    *reinterpret_cast<uint4*>(at + ROWS * LD) = small;
  }
}

// a warp's 16 x D float32 sums (m16n8 layout) into rows [row0, row0 + 16)
// of one (b, h) slice, two adjacent columns a store; rows at or past S are
// not written
template <int D, bool kAligned>
__device__ inline void store_rows(const float (&c)[D / 8][4], float* base,
                                  long long stride, int row0, int S,
                                  int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + g + hf * 8;
    if (row >= S) continue;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      float* at = base + row * stride + nd * 8 + 2 * t;
      if constexpr (kAligned) {
        *reinterpret_cast<float2*>(at) =
            make_float2(c[nd][2 * hf], c[nd][2 * hf + 1]);
      } else {
        at[0] = c[nd][2 * hf];
        at[1] = c[nd][2 * hf + 1];
      }
    }
  }
}

// ---------------------------------------------------------------- dK / dV

// A block of WARPS warps owning 16 * MT keys each; query tiles of BQ rows.
// Shared memory: K and V rows as big and small planes, then a two-stage ring
// of raw (Q, dO, lse, delta) tiles.
template <int D, int WARPS, int MT, int BQ>
struct DkdvCfg {
  static constexpr int kThreads = WARPS * 32;
  static constexpr int BK = 16 * MT * WARPS;
  static constexpr int LD = D + 4;
  static constexpr size_t kKV = sizeof(float) * 4 * BK * LD;
  static constexpr size_t kStage = sizeof(float) * (2 * BQ * LD + 2 * BQ);
  static constexpr size_t kSmem = kKV + 2 * kStage;
  static_assert(kStage % 16 == 0, "16-byte aligned stages");
  static_assert(BQ % 16 == 0, "whole pairs of score n-tiles");
};

template <int D, int WARPS, int MT, int BQ, bool kAligned>
__global__ void __launch_bounds__(WARPS * 32)
bwd_dkdv_kernel(const Params p) {
  using C = DkdvCfg<D, WARPS, MT, BQ>;
  constexpr int BK = C::BK, LD = C::LD, THREADS = C::kThreads;
  constexpr int NQ = BQ / 8;                 // score n-tiles (queries)
  constexpr int ND = D / 8;                  // output n-tiles
  constexpr int WK = 16 * MT;                // keys per warp
  constexpr int PKV = BK * LD;               // K and V: big to small plane
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + 2 * PKV;
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
  const float* qb = p.q + b * p.sq.b + h * p.sq.h;
  const float* ob = p.dout + b * p.sdo.b + h * p.sdo.h;
  const long long bh = (long long)b * p.H + h;
  const float* lse_bh = p.lse + bh * p.Sq;
  const float* delta_bh = p.delta + bh * p.Sq;

  // tile j of the walk into ring stage j & 1
  auto stage = [&](int j) {
    const int r0 = q_begin + j * BQ;
    float* Qs = reinterpret_cast<float*>(ring + (j & 1) * C::kStage);
    stage_rows<D, BQ, THREADS, kAligned>(Qs, qb, p.sq.s, r0, p.Sq);
    stage_rows<D, BQ, THREADS, kAligned>(Qs + BQ * LD, ob, p.sdo.s, r0,
                                         p.Sq);
    float* stats = Qs + 2 * BQ * LD;
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
  split_rows<D, BK, THREADS>(Ks);            // read by the walk after its
  split_rows<D, BK, THREADS>(Vs);            // first __syncthreads

  const float* Kw = Ks + warp * WK * LD;     // this warp's rows
  const float* Vw = Vs + warp * WK * LD;

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
    const float* Qs = reinterpret_cast<const float*>(ring
                                                     + (j & 1) * C::kStage);
    const float* dOs = Qs + BQ * LD;
    const float* Ls = dOs + BQ * LD;
    const float* Ds = Ls + BQ;

    // S^T = K Q^T (keys x queries), then P^T = 2^(S^T scale log2(e) - lse
    // log2(e)); the mask binds only where the tile crosses the diagonal or
    // the end of either sequence
    float s[MT][NQ][4];
    scores<MT, NQ, D, LD, PKV>(s, Kw, Qs, lane);
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
    scores<MT, NQ, D, LD, PKV>(dp, Vw, dOs, lane);
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
    mma_tile<MT, NQ, ND, LD>(dv, s, dOs, lane);
    mma_tile<MT, NQ, ND, LD>(dk, dp, Qs, lane);
  }
  cpasync::wait<0>();

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int key = wkey + m * 16;
    store_rows<D, kAligned>(dk[m], p.out0 + b * p.s0.b + h * p.s0.h, p.s0.s,
                            key, p.Sk, lane);
    store_rows<D, kAligned>(dv[m], p.out1 + b * p.s1.b + h * p.s1.h, p.s1.s,
                            key, p.Sk, lane);
  }
}

// --------------------------------------------------------------------- dQ

// A block of WARPS warps owning 16 * MT query rows each; key tiles of BK.
// Shared memory: Q and dO rows as big and small planes, then a two-stage
// ring of raw (K, V) tiles.
template <int D, int WARPS, int MT, int BK>
struct DqCfg {
  static constexpr int kThreads = WARPS * 32;
  static constexpr int BQ = 16 * MT * WARPS;
  static constexpr int LD = D + 4;
  static constexpr size_t kQO = sizeof(float) * 4 * BQ * LD;
  static constexpr size_t kStage = sizeof(float) * 2 * BK * LD;
  static constexpr size_t kSmem = kQO + 2 * kStage;
  static_assert(BK % 16 == 0, "whole pairs of score n-tiles");
};

template <int D, int WARPS, int MT, int BK, bool kAligned>
__global__ void __launch_bounds__(WARPS * 32)
bwd_dq_kernel(const Params p) {
  using C = DqCfg<D, WARPS, MT, BK>;
  constexpr int BQ = C::BQ, LD = C::LD, THREADS = C::kThreads;
  constexpr int NS = BK / 8;                 // score n-tiles (keys)
  constexpr int ND = D / 8;                  // output n-tiles
  constexpr int WQ = 16 * MT;                // rows per warp
  constexpr int PQO = BQ * LD;               // Q and dO: big to small plane
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + 2 * PQO;
  float* ring = dOs + 2 * PQO;               // [stage][K, V][BK][LD]

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wrow = q0 + warp * WQ;           // the warp's first row
  const int offset = p.Sk - p.Sq;
  // the key tiles the block's rows can see end before this key
  const int k_end = p.causal ? min(p.Sk, max(0, q0 + BQ + offset)) : p.Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const float* kb = p.k + b * p.sk.b + h * p.sk.h;
  const float* vb = p.v + b * p.sv.b + h * p.sv.h;

  // tile j of the walk into ring stage j & 1
  auto stage = [&](int j) {
    float* Ks = ring + (j & 1) * 2 * BK * LD;
    stage_rows<D, BK, THREADS, kAligned>(Ks, kb, p.sk.s, j * BK, p.Sk);
    stage_rows<D, BK, THREADS, kAligned>(Ks + BK * LD, vb, p.sv.s, j * BK,
                                         p.Sk);
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
  split_rows<D, BQ, THREADS>(Qs);            // read by the walk after its
  split_rows<D, BQ, THREADS>(dOs);           // first __syncthreads

  const float* Qw = Qs + warp * WQ * LD;     // this warp's rows
  const float* dOw = dOs + warp * WQ * LD;

  float dq[MT][ND][4];
  zero(dq);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    cpasync::wait<0>();                      // tile j has landed
    __syncthreads();                         // ... and tile j - 1 is done
    if (j + 1 < n_tiles) stage(j + 1);       // overlaps this tile's mma
    cpasync::commit();
    // no row of this warp sees a key of the tile
    if (p.causal && k0 > wrow + WQ - 1 + offset) continue;
    const float* Ks = ring + (j & 1) * 2 * BK * LD;
    const float* Vs = Ks + BK * LD;

    // S = Q K^T, then P = 2^(S scale log2(e) - lse log2(e)); the mask
    // binds only where the tile crosses the diagonal or the end of the keys
    float s[MT][NS][4];
    scores<MT, NS, D, LD, PQO>(s, Qw, Ks, lane);
    const bool masked =
        k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > wrow + offset);
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
    // dP = dO V^T, then dS = P (dP - delta) scale in its registers, the A
    // operand of dQ += dS K
    float dp[MT][NS][4];
    scores<MT, NS, D, LD, PQO>(dp, dOw, Vs, lane);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[m][n][e] = s[m][n][e] * (dp[m][n][e] - dl[m][e >> 1]) * p.scale;
    mma_tile<MT, NS, ND, LD>(dq, dp, Ks, lane);
  }
  cpasync::wait<0>();

#pragma unroll
  for (int m = 0; m < MT; ++m)
    store_rows<D, kAligned>(dq[m], p.out0 + b * p.s0.b + h * p.s0.h, p.s0.s,
                            wrow + m * 16, p.Sq, lane);
}

// ----------------------------------------------------------------- launch

// whether a tensor's rows of one (b, h) slice take 16-byte copies
bool aligned16(const void* base, const long long* st) {
  unsigned long long bits = reinterpret_cast<unsigned long long>(base);
  for (int i = 0; i < 3; ++i) bits |= (unsigned long long)(st[i] * 4);
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

template <int D, int WARPS, int MT, int BQ>
cudaError_t launch_dkdv(const Params& p, int B, bool fast,
                        cudaStream_t stream) {
  using C = DkdvCfg<D, WARPS, MT, BQ>;
  const int tiles = (p.Sk + C::BK - 1) / C::BK;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * p.H, tiles);
  return fast ? start(bwd_dkdv_kernel<D, WARPS, MT, BQ, true>, grid,
                      C::kThreads, C::kSmem, p, stream)
              : start(bwd_dkdv_kernel<D, WARPS, MT, BQ, false>, grid,
                      C::kThreads, C::kSmem, p, stream);
}

template <int D, int WARPS, int MT, int BK>
cudaError_t launch_dq(const Params& p, int B, bool fast,
                      cudaStream_t stream) {
  using C = DqCfg<D, WARPS, MT, BK>;
  const int tiles = (p.Sq + C::BQ - 1) / C::BQ;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * p.H, tiles);
  return fast ? start(bwd_dq_kernel<D, WARPS, MT, BK, true>, grid,
                      C::kThreads, C::kSmem, p, stream)
              : start(bwd_dq_kernel<D, WARPS, MT, BK, false>, grid,
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
// each tensor in argument order, in elements. The launch lines name each
// kernel's warps, 16-row tiles a warp and walked tile; the D-64 shapes were
// picked by timing candidates at [16, 12, 1024, 64] on the card
// (chip_tools/flash_bwd_f32_tune.py); D 128 takes shapes that fit the
// shared memory, dQ in 254 registers, dK/dV in 255 with 4-20 bytes of
// spills.
extern "C" int flash_bwd_dkdv_f32(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  void* dk, void* dv,
                                  const long long* strides, int B, int H,
                                  int Sq, int Sk, int D, float scale,
                                  int causal, void* stream) {
  if (!shape_ok(B, H, Sq, Sk)) return (int)cudaErrorInvalidValue;
  const long long* st = strides;
  const Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v),
                 static_cast<const float*>(dout), lse, delta,
                 static_cast<float*>(dk), static_cast<float*>(dv), at(st, 0),
                 at(st, 1), at(st, 2), at(st, 3), at(st, 4), at(st, 5), H, Sq,
                 Sk, scale, scale * kLog2e, causal};
  bool fast = true;
  const void* ptrs[6] = {q, k, v, dout, dk, dv};
  for (int t = 0; t < 6; ++t) fast = fast && aligned16(ptrs[t], st + 3 * t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch_dkdv<64, 4, 1, 32>(p, B, fast, s);
  if (D == 128) return (int)launch_dkdv<128, 2, 1, 16>(p, B, fast, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dq,
                                const long long* strides, int B, int H,
                                int Sq, int Sk, int D, float scale,
                                int causal, void* stream) {
  if (!shape_ok(B, H, Sq, Sk)) return (int)cudaErrorInvalidValue;
  const long long* st = strides;
  const Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v),
                 static_cast<const float*>(dout), lse, delta,
                 static_cast<float*>(dq), nullptr, at(st, 0), at(st, 1),
                 at(st, 2), at(st, 3), at(st, 4), Strides{0, 0, 0}, H, Sq, Sk,
                 scale, scale * kLog2e, causal};
  bool fast = true;
  const void* ptrs[5] = {q, k, v, dout, dq};
  for (int t = 0; t < 5; ++t) fast = fast && aligned16(ptrs[t], st + 3 * t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch_dq<64, 8, 1, 32>(p, B, fast, s);
  if (D == 128) return (int)launch_dq<128, 2, 1, 32>(p, B, fast, s);
  return (int)cudaErrorInvalidValue;
}
