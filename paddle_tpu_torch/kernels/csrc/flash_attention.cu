// Flash attention forward for sm_90a in float32, head_dim 64 or 128, behind
// a plain C interface. The other flash kernels are libraries of their own,
// built beside this one: flash_fwd_bf16.cu (the bf16 forward),
// flash_bwd_bf16.cu and flash_bwd_f32.cu (dK/dV and dQ, bf16 and float32).
//
// Replaces paddle_tpu/kernels/flash_attention.py::_fwd_kernel (reached
// through _flash_fwd) for float32. Semantics, as there: tensors are [B, H,
// S, D] (any strides, the head dim contiguous); query i attends key j when
// not causal, or when j <= i + (Sk - Sq) (bottom-right causal). The kernel
// writes o and lse = m + log(l_safe) in float32 [B, H, Sq]; a row that sees
// no key gets o = 0 and lse = NEG_INF through the l == 0 guard. Every
// product sums in float32.
//
// Bound. At the training shapes (S 1024, D 64) a key-query pair costs
// 4 * D operations against 2 * D bytes of q, k and v per row: about S / 2
// ops per byte under the causal mask, far above the H100's ~20 float32
// operations per byte of HBM bandwidth: the kernel is bound by operations.
//
// Design. The Pallas kernel carries (m, l, acc) in VMEM across the
// sequential innermost grid axis. Here one block owns 64 query rows of one
// (b, h) and walks the key tiles up to the causal limit itself (the same
// skip rule as _causal_skip). 256 threads form a 16 x 16 grid; each computes
// a 4 x 4 patch of the 64 x 64 score tile and 4 rows x D/16 columns of the
// output tile with scalar float32 FMAs from float32 tiles in shared memory
// (rows padded by one word: conflict-free column reads). Row max and row
// sum reduce across the 16 threads of a row by shuffles.
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

}  // namespace f32

// --------------------------------------------------------------- launch

inline Strides at(const long long* strides, int t) {
  return Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
}

// the forward's shared memory by head dim: Q, K and V tiles and the P tile
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kB * (D + 1) + kB * f32::kLP);
}

template <int D>
cudaError_t launch_fwd(dim3 grid, cudaStream_t stream, const float* q,
                       const float* k, const float* v, float* o, float* lse,
                       const long long* st, int H, int Sq, int Sk,
                       float scale, int causal) {
  const auto kernel = f32::fwd_kernel<D>;
  const size_t smem = fwd_smem<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  // strides: q, k, v, o
  kernel<<<grid, f32::kThreads, smem, stream>>>(
      q, k, v, o, lse, at(st, 0), at(st, 1), at(st, 2), at(st, 3), H, Sq, Sk,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace flash

// The C entry point; D selects the instantiation. It launches on `stream`
// and returns cudaGetLastError() after the launch (0 = cudaSuccess); a
// shape the kernel does not take returns cudaErrorInvalidValue without
// launching. `strides` holds (b, h, s) of q, k, v and o.
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, float* lse, const long long* strides,
                             int B, int H, int Sq, int Sk, int D, float scale,
                             int causal, void* stream) {
  if (!(B > 0 && H > 0 && Sq > 0 && Sk > 0 && B <= 65535 && H <= 65535))
    return (int)cudaErrorInvalidValue;
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  // one block per 64-row tile of query rows
  const dim3 grid((Sq + flash::kB - 1) / flash::kB, H, B);
  const auto f = [](const void* x) { return static_cast<const float*>(x); };
  const auto launch = D == 64 ? flash::launch_fwd<64> : flash::launch_fwd<128>;
  return (int)launch(grid, static_cast<cudaStream_t>(stream), f(q), f(k),
                     f(v), static_cast<float*>(o), lse, strides, H, Sq, Sk,
                     scale, causal);
}
