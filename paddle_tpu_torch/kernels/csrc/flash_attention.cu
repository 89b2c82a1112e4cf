// Flash attention for sm_90a: the float32 forward and both backward
// kernels, for float32 or bf16 inputs and head_dim 64 or 128, behind a
// plain C interface. The bf16 forward is flash_fwd_bf16.cu's (its own
// library, built beside this one).
//
// Replaces paddle_tpu/kernels/flash_attention.py::_fwd_kernel (reached
// through _flash_fwd), ::_bwd_dkdv_kernel and ::_bwd_dq_kernel (both
// reached through _flash_bwd). Semantics, as there: tensors are [B, H, S,
// D] (any strides, the head dim contiguous); query i attends key j when
// not causal, or when j <= i + (Sk - Sq) (bottom-right causal). The
// forward writes o in the input dtype and lse = m + log(l_safe) in float32
// [B, H, Sq]; a row that sees no key gets o = 0 and lse = NEG_INF through
// the l == 0 guard. The backward takes lse and delta = rowsum(dO * O)
// (float32, formed outside the kernels as the JAX package leaves it to
// XLA) and recomputes p = exp(s * scale - lse), zeroed where masked (a
// fully masked row has lse = NEG_INF, so s - lse alone would give p = 1).
// The JAX casts are kept: p is rounded to the dtype of v (forward) and dO
// (dV) before its product, dS to the dtype of q and k before the dK and dQ
// products, and every product sums in float32.
//
// Bound. At the training shapes (S 1024, D 64) a key-query pair costs
// 4 * D operations in the forward and 8 * D and 6 * D in the two backward
// kernels, against 2 * D bytes of q, k and v per row: about S / 2 ops per
// byte under the causal mask, far above the H100's ~20 float32 operations
// per byte of HBM bandwidth, and level with its ~295 bf16 tensor-core
// operations per byte. The float32 kernels are bound by operations; the
// bf16 ones by operations and bytes alike.
//
// Design. The Pallas kernels carry (m, l, acc) or a dK/dV/dQ sum in VMEM
// across the sequential innermost grid axis. Here one block owns one
// output tile and loops over the other axis itself: the forward and dQ
// blocks own 64 query rows of one (b, h) and walk the key tiles up to the
// causal limit (the same skip rule as _causal_skip); a dK/dV block owns 64
// key rows and walks the query tiles that can see them. Every output tile
// has one writer, so there are no atomics and two runs give the same bits.
//
// - float32: 256 threads form a 16 x 16 grid; each computes a 4 x 4 patch
//   of the 64 x 64 score tile and 4 rows x D/16 columns of the output
//   tile with scalar float32 FMAs from float32 tiles in shared memory
//   (rows padded by one word: conflict-free column reads). Row max and
//   row sum reduce across the 16 threads of a row by shuffles.
// - bf16 backward: four warps, each owning 16 rows of the tile, run every
//   product on the tensor cores (WMMA 16 x 16 x 16, bf16 in, float32
//   sums) from bf16 tiles in shared memory. Score and gradient tiles go
//   through shared memory as float32, where each row's two threads apply
//   the mask and the dS formula and write the bf16 operand of the next
//   product; dK/dV/dQ accumulate in fragments.
// cp.async or TMA staging, wgmma and warp specialization are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace flash {

constexpr int kB = 64;              // query rows and key rows per tile
constexpr float kNegInf = -1e30f;   // NEG_INF of the JAX kernels (finite)
constexpr unsigned kFull = 0xffffffffu;

struct Strides {                    // in elements; the head dim is stride 1
  long long b, h, s;
};

__device__ inline bool visible(int row, int col, int Sq, int Sk, int causal,
                               int offset) {
  return row < Sq && col < Sk && (!causal || col <= row + offset);
}

// the key tiles a query tile [q0, q0 + 64) can see end before this key
__device__ inline int key_end(int q0, int Sk, int causal, int offset) {
  return causal ? min(Sk, max(0, q0 + kB + offset)) : Sk;
}

// the first query tile holding a row that sees key k0 (row + offset >= k0)
__device__ inline int query_begin(int k0, int causal, int offset) {
  return causal ? max(0, k0 - offset) / kB * kB : 0;
}

// whether a tile's rows can be read in 16-byte loads: the slice's base
// and its row stride (in bytes) are multiples of 16
__device__ inline bool aligned16(const void* base, long long row_bytes) {
  return ((reinterpret_cast<unsigned long long>(base) | row_bytes) & 15) == 0;
}

namespace f32 {

constexpr int kThreads = 256;       // 16 x 16 threads
constexpr int kLP = kB + 1;         // padded row of a 64 x 64 score tile

// rows [r0, r0 + 64) of one (b, h) slice into shared memory as rows of
// D + 1 words; rows at or past S read as 0. Where the rows allow 16-byte
// loads, every load of a thread is issued before its first store, so a
// tile costs one memory round trip (other layouts take a plain loop)
template <int D>
__device__ void load_tile(float* dst, const float* src, Strides st, int b,
                          int h, int r0, int S) {
  const float* base = src + b * st.b + h * st.h;
  if (aligned16(base, st.s * sizeof(float))) {     // four floats a load
    constexpr int kPer = kB * D / 4 / kThreads;
    float4 buf[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = (threadIdx.x + i * kThreads) * 4, row = r0 + e / D;
      buf[i] = row < S ? *reinterpret_cast<const float4*>(
                             base + row * st.s + e % D)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = (threadIdx.x + i * kThreads) * 4;
      float* out = dst + (e / D) * (D + 1) + e % D;
      out[0] = buf[i].x;
      out[1] = buf[i].y;
      out[2] = buf[i].z;
      out[3] = buf[i].w;
    }
    return;
  }
#pragma unroll 1
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int row = r0 + e / D;
    dst[(e / D) * (D + 1) + e % D] = row < S ? base[row * st.s + e % D] : 0.f;
  }
}

// reductions over the 16 threads (tx) that share a row of the score tile
__device__ inline float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ inline float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// s[i][j] += a[r_i] . b[c_j] over D for rows r_i = ty * 4 + i of `a` and
// rows c_j = tx + 16 * j of `b` (both [64][D + 1] tiles)
template <int D>
__device__ inline void tile_dot(const float* a, const float* b, int ty,
                                int tx, float (&s)[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// ------------------------------------------------------------- forward

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
           Strides so, int H, int Sq, int Sk, float scale, int causal) {
  constexpr int LD = D + 1, C = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kB * LD;
  float* Vs = Ks + kB * LD;
  float* Ps = Vs + kB * LD;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kB;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int offset = Sk - Sq;
  const int k_end = key_end(q0, Sk, causal, offset);

  load_tile<D>(Qs, q, sq, b, h, q0, Sq);
  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }
  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();                       // the last tile's readers are done
    load_tile<D>(Ks, k, sk, b, h, k0, Sk);
    load_tile<D>(Vs, v, sv, b, h, k0, Sk);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<D>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool vis[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vis[j] = visible(row, k0 + tx + 16 * j, Sq, Sk, causal, offset);
        s[i][j] = vis[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        Ps[(ty * 4 + i) * kLP + tx + 16 * j] = p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kB; ++kk) {
      float pv[4], vv[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * kLP + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = Vs[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + b * so.b + h * so.h + row * so.s;
#pragma unroll
    for (int c = 0; c < C; ++c)
      orow[tx + 16 * c] = acc[i][c] / l_safe;
    if (tx == 0) lse[((long long)b * H + h) * Sq + row] = m[i] + logf(l_safe);
  }
}

// ------------------------------------------------------------- dK / dV

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, Strides sq,
                Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                int H, int Sq, int Sk, float scale, int causal) {
  constexpr int LD = D + 1, C = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * LD;
  float* Qs = Vs + kB * LD;
  float* dOs = Qs + kB * LD;
  float* Ps = dOs + kB * LD;
  float* dSs = Ps + kB * kLP;
  float* Ls = dSs + kB * kLP;
  float* Ds = Ls + kB;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kB;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int offset = Sk - Sq;
  const int q_begin = query_begin(k0, causal, offset);
  const float* lse_bh = lse + ((long long)b * H + h) * Sq;
  const float* delta_bh = delta + ((long long)b * H + h) * Sq;

  load_tile<D>(Ks, k, sk, b, h, k0, Sk);
  load_tile<D>(Vs, v, sv, b, h, k0, Sk);
  float dka[4][C], dva[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dka[i][c] = dva[i][c] = 0.f;
  for (int q0 = q_begin; q0 < Sq; q0 += kB) {
    __syncthreads();
    load_tile<D>(Qs, q, sq, b, h, q0, Sq);
    load_tile<D>(dOs, dout, sdo, b, h, q0, Sq);
    for (int r = threadIdx.x; r < kB; r += kThreads) {
      const bool in = q0 + r < Sq;
      Ls[r] = in ? lse_bh[q0 + r] : 0.f;
      Ds[r] = in ? delta_bh[q0 + r] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(Qs, Ks, ty, tx, s);       // S  = Q K^T
    tile_dot<D>(dOs, Vs, ty, tx, dp);     // dP = dO V^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float lse_r = Ls[r], delta_r = Ds[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool vis = visible(q0 + r, k0 + tx + 16 * j, Sq, Sk, causal,
                                 offset);
        const float p = vis ? expf(s[i][j] * scale - lse_r) : 0.f;
        const float ds = p * (dp[i][j] - delta_r) * scale;
        Ps[r * kLP + tx + 16 * j] = p;
        dSs[r * kLP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q over this tile's 64 query rows
#pragma unroll 2
    for (int qq = 0; qq < kB; ++qq) {
      float pv[4], sv4[4], ov[C], qv[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[qq * kLP + ty * 4 + i];
        sv4[i] = dSs[qq * kLP + ty * 4 + i];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        ov[c] = dOs[qq * LD + tx + 16 * c];
        qv[c] = Qs[qq * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dva[i][c] = fmaf(pv[i], ov[c], dva[i][c]);
          dka[i][c] = fmaf(sv4[i], qv[c], dka[i][c]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= Sk) continue;
    float* dkrow = dk + b * sdk.b + h * sdk.h + key * sdk.s;
    float* dvrow = dv + b * sdv.b + h * sdv.h + key * sdv.s;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dkrow[tx + 16 * c] = dka[i][c];
      dvrow[tx + 16 * c] = dva[i][c];
    }
  }
}

// ------------------------------------------------------------------ dQ

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, Strides sq, Strides sk, Strides sv,
              Strides sdo, Strides sdq, int H, int Sq, int Sk, float scale,
              int causal) {
  constexpr int LD = D + 1, C = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * LD;
  float* Ks = dOs + kB * LD;
  float* Vs = Ks + kB * LD;
  float* dSs = Vs + kB * LD;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kB;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int offset = Sk - Sq;
  const int k_end = key_end(q0, Sk, causal, offset);
  const float* lse_bh = lse + ((long long)b * H + h) * Sq;
  const float* delta_bh = delta + ((long long)b * H + h) * Sq;

  load_tile<D>(Qs, q, sq, b, h, q0, Sq);
  load_tile<D>(dOs, dout, sdo, b, h, q0, Sq);
  float lse_r[4], delta_r[4], dqa[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < Sq ? lse_bh[row] : 0.f;
    delta_r[i] = row < Sq ? delta_bh[row] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) dqa[i][c] = 0.f;
  }
  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();
    load_tile<D>(Ks, k, sk, b, h, k0, Sk);
    load_tile<D>(Vs, v, sv, b, h, k0, Sk);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(Qs, Ks, ty, tx, s);
    tile_dot<D>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool vis = visible(row, k0 + tx + 16 * j, Sq, Sk, causal,
                                 offset);
        const float p = vis ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        const float ds = p * (dp[i][j] - delta_r[i]) * scale;
        dSs[(ty * 4 + i) * kLP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    // dQ += dS K over this tile's 64 keys
#pragma unroll 4
    for (int kk = 0; kk < kB; ++kk) {
      float sv4[4], kv[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv4[i] = dSs[(ty * 4 + i) * kLP + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = Ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) dqa[i][c] = fmaf(sv4[i], kv[c], dqa[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    float* dqrow = dq + b * sdq.b + h * sdq.h + row * sdq.s;
#pragma unroll
    for (int c = 0; c < C; ++c) dqrow[tx + 16 * c] = dqa[i][c];
  }
}

}  // namespace f32

namespace bf16 {

namespace wmma = nvcuda::wmma;
using T = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kThreads = 128;       // four warps, 16 tile rows each
constexpr int kLB = kB + 8;         // bf16 row of a 64-wide tile (x 8)
constexpr int kLS = kB + 4;         // float row of a 64-wide tile (x 4)

// rows [r0, r0 + 64) of one (b, h) slice into shared memory as bf16 rows
// of D + 8 elements (a multiple of 8 for WMMA, 16-byte aligned, and rows
// 4 banks apart); rows at or past S read as 0. Where the rows allow
// 16-byte loads, every load of a thread is issued before its first store,
// so a tile costs one memory round trip (other layouts take a plain loop)
template <int D>
__device__ void load_tile(T* dst, const T* src, Strides st, int b, int h,
                          int r0, int S) {
  const T* base = src + b * st.b + h * st.h;
  if (aligned16(base, st.s * sizeof(T))) {         // eight bf16 a load
    constexpr int kPer = kB * D / 8 / kThreads;
    uint4 buf[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = (threadIdx.x + i * kThreads) * 8, row = r0 + e / D;
      buf[i] = row < S ? *reinterpret_cast<const uint4*>(
                             base + row * st.s + e % D)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = (threadIdx.x + i * kThreads) * 8;
      *reinterpret_cast<uint4*>(dst + (e / D) * (D + 8) + e % D) = buf[i];
    }
    return;
  }
#pragma unroll 1
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int row = r0 + e / D;
    dst[(e / D) * (D + 8) + e % D] = row < S ? base[row * st.s + e % D]
                                             : __float2bfloat16_rn(0.f);
  }
}

// out[16 x 64] (float, row stride kLS) = a[16 x D] . b[64 x D]^T: a is
// this warp's D/16 fragments, b a [64][D + 8] tile read as its transpose
template <int D>
__device__ inline void scores(float* out, const FragA (&a)[D / 16],
                              const T* b) {
#pragma unroll
  for (int n = 0; n < kB / 16; ++n) {
    FragC c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBt bt;
      wmma::load_matrix_sync(bt, b + n * 16 * (D + 8) + kk * 16, D + 8);
      wmma::mma_sync(c, a[kk], bt, c);
    }
    wmma::store_matrix_sync(out + n * 16, c, kLS, wmma::mem_row_major);
  }
}

// acc[n] += a[16 x 64] . b[64 x D] for the D/16 column tiles n of b: a is
// a bf16 tile of this warp's 16 rows (row stride kLB), b a [64][D + 8] tile
template <int D>
__device__ inline void accumulate(FragC (&acc)[D / 16], const T* a,
                                  const T* b) {
#pragma unroll
  for (int kk = 0; kk < kB / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, kLB);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragB fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * (D + 8) + n * 16, D + 8);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// this warp's rows of `acc` (16 x D) to global rows [row0 + 16 w, ...) of
// `dst` as bf16, through `stage` (float, row stride D + 4); rows at or
// past S are not written
template <int D>
__device__ inline void store_rows(T* dst, Strides st, int b, int h, int row0,
                                  int S, const FragC (&acc)[D / 16],
                                  float* stage, int warp, int lane) {
  float* ws = stage + warp * 16 * (D + 4);
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(ws + n * 16, acc[n], D + 4, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, d = i % D, row = row0 + warp * 16 + r;
    if (row < S)
      dst[b * st.b + h * st.h + row * st.s + d] =
          __float2bfloat16_rn(ws[r * (D + 4) + d]);
  }
  __syncwarp();
}

// ------------------------------------------------------------- dK / dV

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, Strides sq,
                Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                int H, int Sq, int Sk, float scale, int causal) {
  constexpr int LD = D + 8, KD = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kB * LD;
  T* Qs = Vs + kB * LD;
  T* dOs = Qs + kB * LD;
  T* Pt = dOs + kB * LD;                                  // [64][kLB]
  T* dSt = Pt + kB * kLB;                                 // [64][kLB]
  float* St = reinterpret_cast<float*>(dSt + kB * kLB);   // [64][kLS]
  float* dPt = St + kB * kLS;                             // [64][kLS]
  float* Ls = dPt + kB * kLS;
  float* Ds = Ls + kB;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this thread's key row of the tile, and the parity of its query columns
  const int r = warp * 16 + lane / 2, par = lane % 2, key = k0 + r;
  const int offset = Sk - Sq;
  const float* lse_bh = lse + ((long long)b * H + h) * Sq;
  const float* delta_bh = delta + ((long long)b * H + h) * Sq;

  load_tile<D>(Ks, k, sk, b, h, k0, Sk);
  load_tile<D>(Vs, v, sv, b, h, k0, Sk);
  FragC dkc[KD], dvc[KD];
#pragma unroll
  for (int n = 0; n < KD; ++n) {
    wmma::fill_fragment(dkc[n], 0.f);
    wmma::fill_fragment(dvc[n], 0.f);
  }
  for (int q0 = query_begin(k0, causal, offset); q0 < Sq; q0 += kB) {
    __syncthreads();
    load_tile<D>(Qs, q, sq, b, h, q0, Sq);
    load_tile<D>(dOs, dout, sdo, b, h, q0, Sq);
    for (int i = threadIdx.x; i < kB; i += kThreads) {
      const bool in = q0 + i < Sq;
      Ls[i] = in ? lse_bh[q0 + i] : 0.f;
      Ds[i] = in ? delta_bh[q0 + i] : 0.f;
    }
    __syncthreads();
    {   // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
      FragA ka[KD], va[KD];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        wmma::load_matrix_sync(ka[kk], Ks + warp * 16 * LD + kk * 16, LD);
        wmma::load_matrix_sync(va[kk], Vs + warp * 16 * LD + kk * 16, LD);
      }
      scores<D>(St + warp * 16 * kLS, ka, Qs);
      scores<D>(dPt + warp * 16 * kLS, va, dOs);
    }
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * j + par;
      const float p = visible(q0 + c, key, Sq, Sk, causal, offset)
                          ? expf(St[r * kLS + c] * scale - Ls[c]) : 0.f;
      const float ds = p * (dPt[r * kLS + c] - Ds[c]) * scale;
      Pt[r * kLB + c] = __float2bfloat16_rn(p);     // p.astype(do.dtype)
      dSt[r * kLB + c] = __float2bfloat16_rn(ds);   // ds.astype(q.dtype)
    }
    __syncwarp();
    accumulate<D>(dvc, Pt + warp * 16 * kLB, dOs);   // dV += P^T dO
    accumulate<D>(dkc, dSt + warp * 16 * kLB, Qs);   // dK += dS^T Q
  }
  __syncthreads();            // St and dPt become the output stage
  store_rows<D>(dk, sdk, b, h, k0, Sk, dkc, St, warp, lane);
  store_rows<D>(dv, sdv, b, h, k0, Sk, dvc, St, warp, lane);
}

// ------------------------------------------------------------------ dQ

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, Strides sq, Strides sk, Strides sv,
              Strides sdo, Strides sdq, int H, int Sq, int Sk, float scale,
              int causal) {
  constexpr int LD = D + 8, KD = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kB * LD;
  T* Ks = dOs + kB * LD;
  T* Vs = Ks + kB * LD;
  T* dSb = Vs + kB * LD;                                  // [64][kLB]
  float* Sf = reinterpret_cast<float*>(dSb + kB * kLB);   // [64][kLS]
  float* dPf = Sf + kB * kLS;                             // [64][kLS]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp * 16 + lane / 2, par = lane % 2, row = q0 + r;
  const int offset = Sk - Sq;
  const int k_end = key_end(q0, Sk, causal, offset);
  const long long bh = (long long)b * H + h;
  const float lse_r = row < Sq ? lse[bh * Sq + row] : 0.f;
  const float delta_r = row < Sq ? delta[bh * Sq + row] : 0.f;

  load_tile<D>(Qs, q, sq, b, h, q0, Sq);
  load_tile<D>(dOs, dout, sdo, b, h, q0, Sq);
  __syncthreads();
  FragA qa[KD], oa[KD];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    wmma::load_matrix_sync(qa[kk], Qs + warp * 16 * LD + kk * 16, LD);
    wmma::load_matrix_sync(oa[kk], dOs + warp * 16 * LD + kk * 16, LD);
  }
  FragC dqc[KD];
#pragma unroll
  for (int n = 0; n < KD; ++n) wmma::fill_fragment(dqc[n], 0.f);
  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();
    load_tile<D>(Ks, k, sk, b, h, k0, Sk);
    load_tile<D>(Vs, v, sv, b, h, k0, Sk);
    __syncthreads();
    scores<D>(Sf + warp * 16 * kLS, qa, Ks);      // S  = Q K^T
    scores<D>(dPf + warp * 16 * kLS, oa, Vs);     // dP = dO V^T
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * j + par;
      const float p = visible(row, k0 + c, Sq, Sk, causal, offset)
                          ? expf(Sf[r * kLS + c] * scale - lse_r) : 0.f;
      const float ds = p * (dPf[r * kLS + c] - delta_r) * scale;
      dSb[r * kLB + c] = __float2bfloat16_rn(ds);   // ds.astype(k.dtype)
    }
    __syncwarp();
    accumulate<D>(dqc, dSb + warp * 16 * kLB, Ks);  // dQ += dS K
  }
  __syncthreads();            // Sf and dPf become the output stage
  store_rows<D>(dq, sdq, b, h, q0, Sq, dqc, Sf, warp, lane);
}

}  // namespace bf16

// --------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

inline Strides at(const long long* strides, int t) {
  return Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
}

inline bool shape_ok(int B, int H, int Sq, int Sk) {
  return B > 0 && H > 0 && Sq > 0 && Sk > 0 && B <= 65535 && H <= 65535;
}

// each kernel's threads and shared memory, by dtype and head dim
template <typename T, int D> struct Plan;
template <int D> struct Plan<float, D> {
  static constexpr int threads = f32::kThreads;
  static constexpr size_t tile = sizeof(float) * kB * (D + 1);
  static constexpr size_t stile = sizeof(float) * kB * f32::kLP;
  static constexpr size_t fwd = 3 * tile + stile;
  static constexpr size_t dkdv = 4 * tile + 2 * stile + 2 * kB * sizeof(float);
  static constexpr size_t dq = 4 * tile + stile;
};
template <int D> struct Plan<__nv_bfloat16, D> {
  static constexpr int threads = bf16::kThreads;
  static constexpr size_t tile = sizeof(__nv_bfloat16) * kB * (D + 8);
  static constexpr size_t btile = sizeof(__nv_bfloat16) * kB * bf16::kLB;
  static constexpr size_t stile = sizeof(float) * kB * bf16::kLS;
  static constexpr size_t dkdv = 4 * tile + 2 * btile + 2 * stile
                                 + 2 * kB * sizeof(float);
  static constexpr size_t dq = 4 * tile + btile + 2 * stile;
};

enum class Kind { kFwd, kDkdv, kDq };

template <typename T, int D>
cudaError_t launch(Kind kind, dim3 grid, cudaStream_t stream,
                   const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* out0, void* out1, float* lse_out,
                   const long long* st, int H, int Sq, int Sk, float scale,
                   int causal) {
  using P = Plan<T, D>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  cudaError_t e;
  if (kind == Kind::kFwd) {         // strides: q, k, v, o
    if constexpr (kF32) {             // bf16's is flash_fwd_bf16.cu's
      auto kernel = f32::fwd_kernel<D>;
      if ((e = prepare(kernel, P::fwd)) != cudaSuccess) return e;
      kernel<<<grid, P::threads, P::fwd, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (T*)out0, lse_out,
          at(st, 0), at(st, 1), at(st, 2), at(st, 3), H, Sq, Sk, scale,
          causal);
    } else {
      return cudaErrorInvalidValue;
    }
  } else if (kind == Kind::kDkdv) { // strides: q, k, v, dout, dk, dv
    auto kernel = [] {
      if constexpr (kF32) return f32::bwd_dkdv_kernel<D>;
      else return bf16::bwd_dkdv_kernel<D>;
    }();
    if ((e = prepare(kernel, P::dkdv)) != cudaSuccess) return e;
    kernel<<<grid, P::threads, P::dkdv, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)out0, (T*)out1, at(st, 0), at(st, 1), at(st, 2), at(st, 3),
        at(st, 4), at(st, 5), H, Sq, Sk, scale, causal);
  } else {                          // strides: q, k, v, dout, dq
    auto kernel = [] {
      if constexpr (kF32) return f32::bwd_dq_kernel<D>;
      else return bf16::bwd_dq_kernel<D>;
    }();
    if ((e = prepare(kernel, P::dq)) != cudaSuccess) return e;
    kernel<<<grid, P::threads, P::dq, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)out0, at(st, 0), at(st, 1), at(st, 2), at(st, 3), at(st, 4), H,
        Sq, Sk, scale, causal);
  }
  return cudaGetLastError();
}

template <typename T>
int run(Kind kind, int B, int H, int Sq, int Sk, int D, void* stream,
        const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* out0, void* out1,
        float* lse_out, const long long* st, float scale, int causal) {
  if (!shape_ok(B, H, Sq, Sk)) return (int)cudaErrorInvalidValue;
  // one block per 64-row tile of the output: query rows, or key rows for dK/dV
  const int rows = kind == Kind::kDkdv ? Sk : Sq;
  const dim3 grid((rows + kB - 1) / kB, H, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return (int)launch<T, 64>(kind, grid, s, q, k, v, dout, lse, delta, out0,
                              out1, lse_out, st, H, Sq, Sk, scale, causal);
  if (D == 128)
    return (int)launch<T, 128>(kind, grid, s, q, k, v, dout, lse, delta,
                               out0, out1, lse_out, st, H, Sq, Sk, scale,
                               causal);
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash

// C entry points, one per kernel and dtype; D selects the instantiation.
// Each launches on `stream` and returns cudaGetLastError() after the
// launch (0 = cudaSuccess); a shape the kernels do not take returns
// cudaErrorInvalidValue without launching. `strides` holds (b, h, s) of
// each tensor in argument order. The bf16 forward, flash_fwd_bf16, is
// flash_fwd_bf16.cu's.
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, float* lse, const long long* strides,
                             int B, int H, int Sq, int Sk, int D, float scale,
                             int causal, void* stream) {
  return flash::run<float>(flash::Kind::kFwd, B, H, Sq, Sk, D, stream, q, k,
                           v, nullptr, nullptr, nullptr, o, nullptr, lse,
                           strides, scale, causal);
}

#define FLASH_BWD_ENTRIES(SUFFIX, T)                                          \
  extern "C" int flash_bwd_dkdv_##SUFFIX(                                     \
      const void* q, const void* k, const void* v, const void* dout,         \
      const float* lse, const float* delta, void* dk, void* dv,               \
      const long long* strides, int B, int H, int Sq, int Sk, int D,          \
      float scale, int causal, void* stream) {                                \
    return flash::run<T>(flash::Kind::kDkdv, B, H, Sq, Sk, D, stream, q, k,  \
                         v, dout, lse, delta, dk, dv, nullptr, strides,       \
                         scale, causal);                                      \
  }                                                                           \
  extern "C" int flash_bwd_dq_##SUFFIX(                                       \
      const void* q, const void* k, const void* v, const void* dout,         \
      const float* lse, const float* delta, void* dq,                         \
      const long long* strides, int B, int H, int Sq, int Sk, int D,          \
      float scale, int causal, void* stream) {                                \
    return flash::run<T>(flash::Kind::kDq, B, H, Sq, Sk, D, stream, q, k, v, \
                         dout, lse, delta, dq, nullptr, nullptr, strides,     \
                         scale, causal);                                      \
  }

FLASH_BWD_ENTRIES(f32, float)
FLASH_BWD_ENTRIES(bf16, __nv_bfloat16)
