// my_triple: o = x * 3 over float32, the port's counterpart of the user
// Pallas kernel the JAX package registers with pallas_op
// (tests/test_extensions.py, ``o_ref[...] = x_ref[...] * 3.0``), written
// for cuda_op's contract: the inputs' pointers, the outputs' pointers,
// then the first input's element count.
//
// Bound on the card: bytes. It reads n and writes n floats (8 n bytes)
// and does n multiplies, so at 3.35 TB/s it can take no less than
// 8 n / 3.35e12 s. A block takes tiles of kUnroll * blockDim float4s, the
// next one gridDim tiles on: each thread issues kUnroll independent 16-byte
// loads, a block's apart, before its first store, and a tile is one
// contiguous stretch of memory. Any grid works: float4s after the last
// whole tile go one float4 a thread, the tail of n % 4 elements one float at
// a time. Where x or o is not 16-byte aligned (a view at an offset), every
// element goes one float at a time.
#include <cstdint>

constexpr int kUnroll = 2;

// plain 16-byte loads and stores: the streaming hints (__ldcs/__stcs, or
// ld.global.nc.L1::no_allocate) measured 0.5-3 % slower on the card
// (chip_tools/my_triple_tune.py rewrites these two bodies)
__device__ inline float4 load4(const float4* p) {
  return *p;
}

__device__ inline void store4(float4* p, float4 v) {
  *p = v;
}

__device__ inline float4 triple4(float4 v) {
  return make_float4(v.x * 3.0f, v.y * 3.0f, v.z * 3.0f, v.w * 3.0f);
}

__global__ void my_triple(const float* __restrict__ x, float* __restrict__ o,
                          int64_t n) {
  const int64_t tile = (int64_t)kUnroll * blockDim.x;   // float4s a block
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) &
       15) == 0;
  const int64_t n4 = aligned ? n / 4 : 0;
  const int64_t whole = n4 / tile * tile;     // float4s in whole tiles
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(o);
  for (int64_t t0 = blockIdx.x * tile + threadIdx.x; t0 < whole;
       t0 += gridDim.x * tile) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load4(x4 + t0 + u * blockDim.x);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      store4(o4 + t0 + u * blockDim.x, triple4(v[u]));
  }
  for (int64_t i = whole + first; i < n4; i += stride)
    store4(o4 + i, triple4(load4(x4 + i)));
  for (int64_t j = 4 * n4 + first; j < n; j += stride) o[j] = x[j] * 3.0f;
}
