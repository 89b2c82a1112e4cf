// The int8 x int8 weight matmul of quantized serving, for sm_90a, and its
// per-row activation quantizer.
//
// Replaces no TPU kernel: the JAX package computes this product outside
// any Pallas kernel (paddle_tpu/inference/llm/model.py::_int8_dot, a
// jax.lax.dot_general with int32 accumulation, rescaled after). It is
// written by hand because PyTorch's integer matmul (torch._int_mm) refuses
// the decode buckets (it wants M > 16, and K and N multiples of 8), and so
// that the rescale is fused into the product's epilogue instead of a
// float32 [M, N] pass after it.
//
// quantize_rows_kernel: x [M, K] float32 -> codes [M, K] int8 and scales
// [M] float32, per row, as kernels/int8.py::quantize_absmax: the scale is
// max(absmax / 127, 1e-8), each code round-half-even(x / scale) (a
// division, as JAX divides) clipped to +-127. A NaN in a row makes its
// scale NaN, so the row's products are NaN, as in JAX. One block a row.
//
// int8_matmul_kernel: out [M, N] = float(xq [M, K] . wqt [N, K]^T) * xs[m]
// * ws[n], in that order, each product rounded (bit for bit the plain
// version). Sums are int32 (|sum| <= K * 127^2 < 2^31 for K < 133,000), so
// any order of summation gives the same bits. The weight codes are stored
// transposed, [N, K] with K contiguous (the model keeps that layout beside
// the [K, N] codes), so the B operand of mma.sync.m16n8k32.row.col.s8 loads
// as words: every operand is a 16-byte load from global memory into
// registers. A thread with lane-in-group t holds, for each of its rows
// (A) and columns (B), the 16 bytes at k0 + 16 t: the two mma k-steps of a
// 64-byte chunk take bytes 0-7 and 8-15 of them, a permutation of k that is
// the same for A and B, so the products are unchanged.
//
// Bound. Decode M (1 to 16 rows) is bound by the weight bytes: GPT-3 XL
// reads 12 d^2 = 50.3 MB of codes a layer, 0.015 ms at 3.35 TB/s. Large M
// is bound by operations (int8 dense 1979 TOPS). This first version keeps
// it simple: a block owns 16 MT rows and 8 NT columns and its warps split
// K into 64-byte chunks (no shared-memory staging: at decode M each weight
// byte is used once), then sum their int32 partials in shared memory and
// apply the epilogue. Nothing syncs with the host: both kernels run inside
// the serving step's CUDA graph. wgmma and a TMA producer are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace i8mm {

constexpr int kQuantThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// max that propagates NaN from either side
__device__ inline float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, int K) {
  __shared__ float part[kQuantThreads / 32];
  __shared__ float row_scale;
  const size_t base = (size_t)blockIdx.x * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kQuantThreads)
    amax = nan_max(amax, fabsf(x[base + k]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(kFull, amax, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = part[0];
    for (int w = 1; w < kQuantThreads / 32; ++w) a = nan_max(a, part[w]);
    const float s = __fdiv_rn(a, 127.f);
    row_scale = s != s ? s : fmaxf(s, 1e-8f);
    xs[blockIdx.x] = row_scale;
  }
  __syncthreads();
  const float scale = row_scale;
  for (int k = threadIdx.x; k < K; k += kQuantThreads) {
    int q = __float2int_rn(__fdiv_rn(x[base + k], scale));
    q = q < -127 ? -127 : (q > 127 ? 127 : q);
    xq[base + k] = (int8_t)q;
  }
}

__device__ inline void mma_s8(int (&c)[4], unsigned a0, unsigned a1,
                              unsigned a2, unsigned a3, unsigned b0,
                              unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ inline uint4 load16(const int8_t* p, bool in) {
  return in ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
}

// A block of WARPS warps owns rows [16 MT by, ...) and columns [8 NT bx,
// ...); warp w takes the 64-byte K chunks w, w + WARPS, ...
template <int MT, int NT, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
int8_matmul_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                   const int8_t* __restrict__ wqt,
                   const float* __restrict__ ws, float* __restrict__ out,
                   int M, int N, int K) {
  constexpr int kAcc = MT * NT * 4;
  __shared__ int part[WARPS][kAcc * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * 16 * MT, n0 = blockIdx.x * 8 * NT;
  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
  const int chunks = (K + 63) / 64;
  for (int c = warp; c < chunks; c += WARPS) {
    const int k = c * 64 + t * 16;
    const bool kin = k < K;
    uint4 a[MT][2], b[NT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 16 * i + g + 8 * h;
        a[i][h] = load16(xq + (size_t)row * K + k, kin && row < M);
      }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + 8 * j + g;
      b[j] = load16(wqt + (size_t)col * K + k, kin && col < N);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mma_s8(acc[i][j], a[i][0].x, a[i][1].x, a[i][0].y, a[i][1].y,
               b[j].x, b[j].y);
        mma_s8(acc[i][j], a[i][0].z, a[i][1].z, a[i][0].w, a[i][1].w,
               b[j].z, b[j].w);
      }
  }
  // the warps' partial sums, exact in int32, then the epilogue
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        part[warp][((i * NT + j) * 4 + r) * 32 + lane] = acc[i][j][r];
  __syncthreads();
  for (int e = threadIdx.x; e < kAcc * 32; e += WARPS * 32) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += part[w][e];
    const int ln = e & 31, r = (e >> 5) & 3, ij = e >> 7;
    const int i = ij / NT, j = ij - i * NT;
    const int row = m0 + 16 * i + (ln >> 2) + (r >= 2 ? 8 : 0);
    const int col = n0 + 8 * j + 2 * (ln & 3) + (r & 1);
    if (row < M && col < N)
      out[(size_t)row * N + col] =
          __fmul_rn(__fmul_rn(__int2float_rn(sum), xs[row]), ws[col]);
  }
}

template <int MT, int NT, int WARPS>
cudaError_t launch(const int8_t* xq, const float* xs, const int8_t* wqt,
                   const float* ws, float* out, int M, int N, int K,
                   cudaStream_t s) {
  const dim3 grid((N + 8 * NT - 1) / (8 * NT), (M + 16 * MT - 1) / (16 * MT));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  int8_matmul_kernel<MT, NT, WARPS><<<grid, WARPS * 32, 0, s>>>(
      xq, xs, wqt, ws, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace i8mm

// x [M, K] float32 -> xq [M, K] int8, xs [M] float32. Returns the CUDA
// error of the launch (0 = cudaSuccess).
extern "C" int quantize_rows_f32(const float* x, void* xq, float* xs, int M,
                                 int K, void* stream) {
  if (M <= 0 || K <= 0) return (int)cudaSuccess;
  i8mm::quantize_rows_kernel<<<M, i8mm::kQuantThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<int8_t*>(xq), xs, K);
  return (int)cudaGetLastError();
}

// out [M, N] float32 = (xq [M, K] . wqt [N, K]^T) * xs [M] * ws [N]. Takes
// K a multiple of 16 and 16-byte aligned xq and wqt.
extern "C" int int8_matmul_s8(const void* xq, const float* xs,
                              const void* wqt, const float* ws, float* out,
                              int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K <= 0 || K % 16 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(wqt);
  if (M <= 16) return (int)i8mm::launch<1, 2, 8>(a, xs, b, ws, out, M, N, K, s);
  return (int)i8mm::launch<4, 4, 4>(a, xs, b, ws, out, M, N, K, s);
}
