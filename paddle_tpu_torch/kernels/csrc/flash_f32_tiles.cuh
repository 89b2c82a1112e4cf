// The tile helpers of the float32 flash kernels on the TF32 tensor cores in
// 3xTF32 (tf32x3.cuh): the forward (flash_fwd_f32.cu) and the dK/dV and dQ
// kernels (flash_bwd_f32.cu) include them from here, so both run the same
// fragment loads, score products, walked-tile sums and staging.
//
// Tiles are float32 rows in shared memory with a row stride of LD = D + 4
// words: g * (D + 4) + t and 2t * (D + 4) + g cover the 32 banks, and
// ldmatrix's eight 16-byte rows fall on distinct bank groups. A block's own
// rows are split once into a big and a small plane (split_rows; the small
// plane PLANE words after the big one); the walked tiles stay raw and are
// split as each fragment is read. Fragments of rows in the [n][k] form come
// by ldmatrix, moving 32-bit words; the [k][n] form by 32-bit loads
// (ldmatrix.trans moves 16-bit elements only).
//
// A product's first operand may be the accumulators of an earlier one as they
// stand: the m16n8k8 accumulator holds score columns (2t, 2t + 1), the A
// fragment columns (t, t + 4), so the registers {c0, c2, c1, c3} of one score
// n-tile are the A fragment of one k-step with the step's 8 keys (queries) in
// the order (0, 2, 4, 6, 1, 3, 5, 7) (c_to_a), and the B fragment of that
// step reads rows 2t and 2t + 1 of the tile (load_b_perm): the same terms, so
// the sum is exact.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "tf32x3.cuh"

namespace f32tiles {

constexpr float kLog2e = 1.4426950408889634f;

struct Strides {                             // in elements
  long long b, h, s;
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
// head dim (S = Q K^T; S^T = K Q^T, dP^T = V dO^T, dP = dO V^T): the warp's
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
// column n-tiles of `rows` (O += P V; dV += P^T dO, dK += dS^T Q, dQ += dS K),
// the A fragment of k-step jj from the score accumulators sc[m][jj]
// (c_to_a).
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

// whether a tensor's rows of one (b, h) slice take 16-byte copies
bool aligned16(const void* base, const long long* st) {
  unsigned long long bits = reinterpret_cast<unsigned long long>(base);
  for (int i = 0; i < 3; ++i) bits |= (unsigned long long)(st[i] * 4);
  return (bits & 15) == 0;
}

// launch `kernel` with `smem` bytes of dynamic shared memory on `stream`
template <typename Kernel, typename Params>
cudaError_t start(Kernel kernel, dim3 grid, int threads, size_t smem,
                  const Params& p, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32tiles
