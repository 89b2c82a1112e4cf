// Flash attention for sm_90a in float32: the forward and both backward
// kernels, head_dim 64 or 128, behind a plain C interface. The bf16
// kernels are libraries of their own, built beside this one:
// flash_fwd_bf16.cu (forward) and flash_bwd_bf16.cu (dK/dV and dQ).
//
// Replaces paddle_tpu/kernels/flash_attention.py::_fwd_kernel (reached
// through _flash_fwd), ::_bwd_dkdv_kernel and ::_bwd_dq_kernel (both
// reached through _flash_bwd) for float32. Semantics, as there: tensors
// are [B, H, S, D] (any strides, the head dim contiguous); query i attends
// key j when not causal, or when j <= i + (Sk - Sq) (bottom-right causal).
// The forward writes o and lse = m + log(l_safe) in float32 [B, H, Sq]; a
// row that sees no key gets o = 0 and lse = NEG_INF through the l == 0
// guard. The backward takes lse and delta = rowsum(dO * O) (float32,
// formed outside the kernels as the JAX package leaves it to XLA) and
// recomputes p = exp(s * scale - lse), zeroed where masked (a fully masked
// row has lse = NEG_INF, so s - lse alone would give p = 1). Every product
// sums in float32.
//
// Bound. At the training shapes (S 1024, D 64) a key-query pair costs
// 4 * D operations in the forward and 8 * D and 6 * D in the two backward
// kernels, against 2 * D bytes of q, k and v per row: about S / 2 ops per
// byte under the causal mask, far above the H100's ~20 float32 operations
// per byte of HBM bandwidth: the kernels are bound by operations.
//
// Design. The Pallas kernels carry (m, l, acc) or a dK/dV/dQ sum in VMEM
// across the sequential innermost grid axis. Here one block owns one
// output tile and loops over the other axis itself: the forward and dQ
// blocks own 64 query rows of one (b, h) and walk the key tiles up to the
// causal limit (the same skip rule as _causal_skip); a dK/dV block owns 64
// key rows and walks the query tiles that can see them. Every output tile
// has one writer, so there are no atomics and two runs give the same bits.
// 256 threads form a 16 x 16 grid; each computes a 4 x 4 patch of the
// 64 x 64 score tile and 4 rows x D/16 columns of the output tile with
// scalar float32 FMAs from float32 tiles in shared memory (rows padded by
// one word: conflict-free column reads). Row max and row sum reduce
// across the 16 threads of a row by shuffles.
#include <cuda_runtime.h>

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

// --------------------------------------------------------------- launch

inline Strides at(const long long* strides, int t) {
  return Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
}

// each kernel's shared memory by head dim
template <int D>
struct Plan {
  static constexpr size_t tile = sizeof(float) * kB * (D + 1);
  static constexpr size_t stile = sizeof(float) * kB * f32::kLP;
  static constexpr size_t fwd = 3 * tile + stile;
  static constexpr size_t dkdv = 4 * tile + 2 * stile + 2 * kB * sizeof(float);
  static constexpr size_t dq = 4 * tile + stile;
};

enum class Kind { kFwd, kDkdv, kDq };

template <typename Kernel, typename... Args>
cudaError_t start(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                  Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, f32::kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(Kind kind, dim3 grid, cudaStream_t stream, const float* q,
                   const float* k, const float* v, const float* dout,
                   const float* lse, const float* delta, float* out0,
                   float* out1, float* lse_out, const long long* st, int H,
                   int Sq, int Sk, float scale, int causal) {
  using P = Plan<D>;
  if (kind == Kind::kFwd)           // strides: q, k, v, o
    return start(f32::fwd_kernel<D>, grid, P::fwd, stream, q, k, v, out0,
                 lse_out, at(st, 0), at(st, 1), at(st, 2), at(st, 3), H, Sq,
                 Sk, scale, causal);
  if (kind == Kind::kDkdv)          // strides: q, k, v, dout, dk, dv
    return start(f32::bwd_dkdv_kernel<D>, grid, P::dkdv, stream, q, k, v,
                 dout, lse, delta, out0, out1, at(st, 0), at(st, 1),
                 at(st, 2), at(st, 3), at(st, 4), at(st, 5), H, Sq, Sk, scale,
                 causal);
  return start(f32::bwd_dq_kernel<D>, grid, P::dq, stream, q, k, v, dout,
               lse, delta, out0, at(st, 0), at(st, 1), at(st, 2), at(st, 3),
               at(st, 4), H, Sq, Sk, scale, causal);   // q, k, v, dout, dq
}

int run(Kind kind, int B, int H, int Sq, int Sk, int D, void* stream,
        const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* out0, void* out1,
        float* lse_out, const long long* st, float scale, int causal) {
  if (!(B > 0 && H > 0 && Sq > 0 && Sk > 0 && B <= 65535 && H <= 65535))
    return (int)cudaErrorInvalidValue;
  // one block per 64-row tile of the output: query rows, or key rows for dK/dV
  const int rows = kind == Kind::kDkdv ? Sk : Sq;
  const dim3 grid((rows + kB - 1) / kB, H, B);
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  const auto launch_d = D == 64 ? launch<64> : launch<128>;
  const auto f = [](const void* x) { return static_cast<const float*>(x); };
  return (int)launch_d(kind, grid, (cudaStream_t)stream, f(q), f(k), f(v),
                       f(dout), lse, delta, static_cast<float*>(out0),
                       static_cast<float*>(out1), lse_out, st, H, Sq, Sk,
                       scale, causal);
}

}  // namespace flash

// C entry points, one per kernel; D selects the instantiation. Each
// launches on `stream` and returns cudaGetLastError() after the launch (0
// = cudaSuccess); a shape the kernels do not take returns
// cudaErrorInvalidValue without launching. `strides` holds (b, h, s) of
// each tensor in argument order.
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, float* lse, const long long* strides,
                             int B, int H, int Sq, int Sk, int D, float scale,
                             int causal, void* stream) {
  return flash::run(flash::Kind::kFwd, B, H, Sq, Sk, D, stream, q, k, v,
                    nullptr, nullptr, nullptr, o, nullptr, lse, strides,
                    scale, causal);
}

extern "C" int flash_bwd_dkdv_f32(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv,
                                  const long long* strides, int B, int H,
                                  int Sq, int Sk, int D, float scale,
                                  int causal, void* stream) {
  return flash::run(flash::Kind::kDkdv, B, H, Sq, Sk, D, stream, q, k, v,
                    dout, lse, delta, dk, dv, nullptr, strides, scale,
                    causal);
}

extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dq,
                                const long long* strides, int B, int H,
                                int Sq, int Sk, int D, float scale,
                                int causal, void* stream) {
  return flash::run(flash::Kind::kDq, B, H, Sq, Sk, D, stream, q, k, v, dout,
                    lse, delta, dq, nullptr, nullptr, strides, scale, causal);
}
