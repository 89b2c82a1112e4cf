// my_triple: o = x * 3 over float32, the port's counterpart of the user
// Pallas kernel the JAX package registers with pallas_op
// (tests/test_extensions.py, ``o_ref[...] = x_ref[...] * 3.0``), written
// for cuda_op's contract: the inputs' pointers, the outputs' pointers,
// then the first input's element count.
//
// Bound on the card: bytes. It reads n and writes n floats (8 n bytes)
// and does n multiplies, so at 3.35 TB/s it can take no less than
// 8 n / 3.35e12 s. A grid-stride loop over 16-byte float4 loads and
// stores keeps every thread's accesses wide and coalesced; the tail of
// n % 4 elements goes one float at a time. Where x or o is not 16-byte
// aligned (a view at an offset), every element goes one float at a time.
#include <cstdint>

__global__ void my_triple(const float* __restrict__ x, float* __restrict__ o,
                          int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) &
       15) == 0;
  const int64_t n4 = aligned ? n / 4 : 0;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(o);
  for (int64_t i = first; i < n4; i += stride) {
    float4 v = x4[i];
    v.x *= 3.0f;
    v.y *= 3.0f;
    v.z *= 3.0f;
    v.w *= 3.0f;
    o4[i] = v;
  }
  for (int64_t i = 4 * n4 + first; i < n; i += stride) {
    o[i] = x[i] * 3.0f;
  }
}
