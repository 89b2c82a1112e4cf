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
// P and dS are A operands of the next products as they stand (c_to_a, with
// load_b_perm reading the dO, Q or K rows in the same key order), and the
// fragment loads, the products and the staging are the helpers of
// flash_f32_tiles.cuh, shared with the float32 forward (flash_fwd_f32.cu). The
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

#include "flash_f32_tiles.cuh"

namespace {

using namespace f32tiles;

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
