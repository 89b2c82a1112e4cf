// Dropout for sm_90a behind the plain C entries dropout_f32, dropout_bf16
// and dropout_f16.
//
// Replaces no Pallas kernel: the JAX package's dropout
// (paddle_tpu/ops/nn_ops.py:273 dropout, and the attention-probability
// dropout of paddle_tpu/kernels/attention.py:54-56) is
// jax.random.bernoulli(key, 1 - p, mask_shape) and a jnp.where that XLA
// fuses. Written by hand because PyTorch's dropout draws Philox bits, and
// the port's masks must be the JAX package's bit for bit: the plain
// version (kernels/dropout.py dropout_ref, on core/threefry.py) runs the
// hash as some hundred elementwise int64 passes over the whole tensor.
//
// Semantics, as there: element e of x (row-major flat index) reads the
// mask at index j, e itself or, with a broadcast mask (dropout2d/3d), the
// flat index of e's coordinates in the mask's shape. keep(j) is
// Threefry-2x32 (20 rounds, jax.random's partitionable form) of counter
// (j >> 32, j mod 2^32) under the call's key, the two output words XORed,
// the top 23 bits made a float u in [0, 1), and u < float32(1 - p).
// upscale_in_train writes keep ? x / (1 - p) : 0 with 1 - p rounded to x's
// type and the quotient formed in float32 and rounded once (XLA's rounding
// for bf16/f16); downscale_in_infer writes keep ? x : 0. The backward is
// the same function of dy under the same key, so nothing but the key is
// kept between the two.
//
// Bound. A call reads x once and writes y once (2 * n * sizeof(T) bytes)
// and hashes each element: the 20 rounds are 20 adds, 20 funnel-shift
// rotations and 20 xors, the five key injections 10 adds and the first
// two adds, the counter split, the xor of the words, the shift, or,
// float subtract and compare, and the select and divide: about 84 integer
// operations an element. At the attention-probability shape [16, 12,
// 1024, 1024] float32 that is 201M elements, 1.61 GB (0.48 ms at
// 3.35 TB/s) and ~16.9 G integer operations: at the H100's issue rate
// (a warp instruction a clock on each of an SM's four schedulers, 132
// SMs, 1.98 GHz: 33.4 T/s) ~0.51 ms, so operations and bytes bound it
// nearly alike. The design spends nothing else: one pass, 16-byte loads
// and stores, a grid-stride loop with every element's hash independent.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr int kThreads = 256;
constexpr int kMaxDims = 8;

struct Mask {                   // the broadcast mask's geometry
  int ndim;
  long long dims[kMaxDims];     // x's shape
  long long strides[kMaxDims];  // the mask's row-major strides, 0 where
                                // the mask broadcasts
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// the XOR of the two words of Threefry-2x32(key, (c0, c1))
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t c0, uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef TF_ROUND
  return x0 ^ x1;
}

__device__ __forceinline__ bool keep_at(unsigned long long j, uint32_t k0,
                                        uint32_t k1, float thr) {
  const uint32_t bits = threefry_bits(k0, k1, (uint32_t)(j >> 32),
                                      (uint32_t)j);
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f < thr;
}

template <typename T> struct Elem;
template <> struct Elem<float> {
  static __device__ float to_float(float x) { return x; }
  static __device__ float from_float(float x) { return x; }
};
template <> struct Elem<__nv_bfloat16> {
  static __device__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
};
template <> struct Elem<__half> {
  static __device__ float to_float(__half x) { return __half2float(x); }
  static __device__ __half from_float(float x) { return __float2half_rn(x); }
};

// the mask index of element e under a broadcast mask
__device__ __forceinline__ unsigned long long mask_index(long long e,
                                                         const Mask& m) {
  unsigned long long j = 0;
  for (int d = m.ndim - 1; d >= 0; --d) {
    const long long c = e % m.dims[d];
    e /= m.dims[d];
    j += (unsigned long long)(c * m.strides[d]);
  }
  return j;
}

template <typename T>
__device__ __forceinline__ T drop(T x, bool keep, bool upscale, float div) {
  if (!keep) return Elem<T>::from_float(0.f);
  return upscale ? Elem<T>::from_float(Elem<T>::to_float(x) / div) : x;
}

// VEC elements a thread a pass (16 bytes when kVector), grid-stride
template <typename T, int VEC, bool kVector, bool kBcast>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
               uint32_t k0, uint32_t k1, float thr, float div, int upscale,
               const Mask m) {
  const long long step = (long long)gridDim.x * kThreads * VEC;
  for (long long base = ((long long)blockIdx.x * kThreads + threadIdx.x) * VEC;
       base < n; base += step) {
    alignas(16) T v[VEC];
    if constexpr (kVector) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(x + base);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (base + i < n) v[i] = x[base + i];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const long long e = base + i;
      const unsigned long long j =
          kBcast ? mask_index(e, m) : (unsigned long long)e;
      v[i] = drop(v[i], keep_at(j, k0, k1, thr), upscale != 0, div);
    }
    if constexpr (kVector) {
      *reinterpret_cast<uint4*>(y + base) = *reinterpret_cast<uint4*>(v);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (base + i < n) y[base + i] = v[i];
    }
  }
}

template <typename T, int VEC, bool kVector, bool kBcast>
cudaError_t launch_as(const T* x, T* y, long long n, uint32_t k0, uint32_t k1,
                      float thr, float div, int upscale, const Mask& m,
                      cudaStream_t stream) {
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long per_block = (long long)kThreads * VEC;
  long long blocks = (n + per_block - 1) / per_block;
  const long long cap = (long long)(sms > 0 ? sms : 132) * 16;
  if (blocks > cap) blocks = cap;
  dropout_kernel<T, VEC, kVector, kBcast>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(x, y, n, k0, k1, thr, div,
                                                  upscale, m);
  return cudaGetLastError();
}

template <typename T>
int run(const void* xv, void* yv, long long n, unsigned k0, unsigned k1,
        float thr, float div, int upscale, int ndim, const long long* dims,
        const long long* strides, void* stream) {
  if (n <= 0 || ndim < 0 || ndim > kMaxDims) return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  Mask m{};
  m.ndim = ndim;
  for (int d = 0; d < ndim; ++d) {
    if (dims[d] <= 0) return (int)cudaErrorInvalidValue;
    m.dims[d] = dims[d];
    m.strides[d] = strides[d];
  }
  constexpr int VEC = 16 / sizeof(T);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y)) % 16 == 0) &&
                   n % VEC == 0;
  if (ndim > 0)
    return vec ? (int)launch_as<T, VEC, true, true>(x, y, n, k0, k1, thr,
                                                    div, upscale, m, s)
               : (int)launch_as<T, VEC, false, true>(x, y, n, k0, k1, thr,
                                                     div, upscale, m, s);
  return vec ? (int)launch_as<T, VEC, true, false>(x, y, n, k0, k1, thr, div,
                                                   upscale, m, s)
             : (int)launch_as<T, VEC, false, false>(x, y, n, k0, k1, thr,
                                                    div, upscale, m, s);
}

}  // namespace

// y = dropout(x) over n contiguous elements on `stream`; returns
// cudaGetLastError() after the launch (0 = cudaSuccess). (k0, k1) is the
// key, thr = float32(1 - p), div = 1 - p rounded to x's type (as a float),
// upscale 1 for upscale_in_train. ndim = 0 takes the mask index as the
// element's; else dims / strides (ndim each, host memory) give x's shape
// and the broadcast mask's strides.
#define DROPOUT_ENTRY(name, T)                                               \
  extern "C" int name(const void* x, void* y, long long n, unsigned k0,      \
                      unsigned k1, float thr, float div, int upscale,        \
                      int ndim, const long long* dims,                       \
                      const long long* strides, void* stream) {              \
    return run<T>(x, y, n, k0, k1, thr, div, upscale, ndim, dims, strides,   \
                  stream);                                                   \
  }

DROPOUT_ENTRY(dropout_f32, float)
DROPOUT_ENTRY(dropout_bf16, __nv_bfloat16)
DROPOUT_ENTRY(dropout_f16, __half)
