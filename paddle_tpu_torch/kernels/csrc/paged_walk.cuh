// The page walk every paged-attention kernel of the port shares, for
// sm_90a: one block attends a tile of up to TQ query rows of one head
// against one sequence's K/V pages, through its page-table row.
//
// Used by the decode kernel (paged_attention.cu), whose __global__ owns its
// grid, its query and output layout and its masks' inputs, and calls
// attend_tile. The mixed chunk/verify kernel (mixed_attention.cu) walks
// its pages itself and takes only launch and visible_pages from here; the
// ragged kernels (ragged_attention.cuh) have walks of their own.
//
// Semantics. Query row i of the tile sits at global position pos0 + i
// and sees every key position kv_pos < kv_len with kv_pos <= pos0 + i
// (the finite NEG_INF of the JAX kernels marks the rest). A row whose
// softmax is empty gets l == 0; the callers write 0 for it.
//
// Design. The walk over the visible pages is split across WARPS warps
// (warp w takes pages p_begin + w, p_begin + w + WARPS, ...). Each warp
// stages its page's K and V for head h into its own shared-memory slice
// (dequantizing code pages while staging) and keeps a float32
// online-softmax state (m, l, acc) per query row in registers: lane j
// scores key j of the page, the row max and sum go through warp
// shuffles, and each lane accumulates ceil(D / 32) head-dim elements of
// P V. At the end the warps' states merge in fixed warp order, so two
// runs give the same bits. No atomics.
#pragma once

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr float kNegInf = -1e30f;   // NEG_INF of the JAX kernels (finite)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmemBytes = 227 * 1024;   // a block's opt-in limit

// page element -> float32: plain for float pools, code * scale for
// 1-byte code pools (from the code's raw byte)
template <typename T> struct Code;
template <> struct Code<float> {
  static constexpr bool kQuant = false;
};
template <> struct Code<int8_t> {
  static constexpr bool kQuant = true;
  __device__ static float to_float(uint32_t bits) {
    return (float)(int8_t)(uint8_t)(bits & 0xffu);
  }
};
template <> struct Code<__nv_fp8_e4m3> {
  static constexpr bool kQuant = true;
  __device__ static float to_float(uint32_t bits) {
    __nv_fp8_e4m3 v;
    v.__x = (__nv_fp8_storage_t)(bits & 0xffu);
    return static_cast<float>(v);
  }
};

// The K/V pools [P, page, H, D] (and, for code pools, their float32
// scale pools [P, page, H]).
template <typename T>
struct Pools {
  const T* k_pool;
  const T* v_pool;
  const float* k_scale;
  const float* v_scale;
  int H, D, page_size;
};

// Shared memory in floats: the pre-scaled query tile, then a region
// that holds each warp's staged K/V page during the walk and the
// warps' partial states during the merge.
__host__ __device__ inline int walk_floats(int warps, int D, int page_size) {
  return warps * page_size * (2 * D + 1);
}
__host__ __device__ inline int merge_floats(int warps, int tq, int D) {
  return warps * tq * (D + 2);
}
__host__ __device__ inline int smem_floats(int warps, int tq, int D,
                                           int page_size) {
  const int w = walk_floats(warps, D, page_size);
  const int m = merge_floats(warps, tq, D);
  return tq * D + (w > m ? w : m);
}

// One warp stages page `page` of head h: K rows padded to D + 1 floats
// (lane-per-key reads hit distinct banks), V rows of D floats.
template <typename T>
__device__ inline void stage_page(const Pools<T>& a, int page, int h,
                                  int lane, float* ks, float* vs) {
  const int D = a.D, H = a.H, ps = a.page_size, Dk = D + 1;
  if constexpr (!Code<T>::kQuant) {
    for (int e = lane; e < ps * D; e += 32) {
      const int j = e / D, d = e - j * D;
      const size_t g = ((size_t)(page * ps + j) * H + h) * D + d;
      ks[j * Dk + d] = a.k_pool[g];
      vs[j * D + d] = a.v_pool[g];
    }
  } else {
    const uint8_t* kb = reinterpret_cast<const uint8_t*>(a.k_pool);
    const uint8_t* vb = reinterpret_cast<const uint8_t*>(a.v_pool);
    if ((D & 3) == 0) {                      // four codes per load
      const int D4 = D >> 2;
      for (int e = lane; e < ps * D4; e += 32) {
        const int j = e / D4, d = (e - j * D4) * 4;
        const size_t row = (size_t)(page * ps + j) * H + h;
        const uint32_t kw =
            *reinterpret_cast<const uint32_t*>(kb + row * D + d);
        const uint32_t vw =
            *reinterpret_cast<const uint32_t*>(vb + row * D + d);
        const float ksc = a.k_scale[row], vsc = a.v_scale[row];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ks[j * Dk + d + i] = Code<T>::to_float(kw >> (8 * i)) * ksc;
          vs[j * D + d + i] = Code<T>::to_float(vw >> (8 * i)) * vsc;
        }
      }
    } else {
      for (int e = lane; e < ps * D; e += 32) {
        const int j = e / D, d = e - j * D;
        const size_t row = (size_t)(page * ps + j) * H + h;
        ks[j * Dk + d] = Code<T>::to_float(kb[row * D + d]) * a.k_scale[row];
        vs[j * D + d] = Code<T>::to_float(vb[row * D + d]) * a.v_scale[row];
      }
    }
  }
}

// The block attends query rows 0 .. nq - 1 (nq <= TQ) of head h, row i
// read from q + i * q_stride (D floats), against pages [p_begin, p_end)
// of page_row. Every thread of the block calls it (it synchronizes the
// block). For each row i and element d, exactly one thread calls
// emit(i, d, m, l, acc) with the row's merged state: the caller writes
// acc / l, or (l == 0) 0, or the partial state itself.
template <typename T, int TQ, int WARPS, int DPL, typename Emit>
__device__ inline void attend_tile(const Pools<T>& a, const int* page_row,
                                   int h, const float* q, size_t q_stride,
                                   float sm_scale, int nq, int pos0,
                                   int kv_len, int p_begin, int p_end,
                                   float* smem, Emit emit) {
  const int D = a.D, page_size = a.page_size;
  const int W = D + 2;                     // one (m, l, acc[D]) record
  float* qs = smem;                        // [TQ][D], pre-scaled
  float* region = smem + TQ * D;
  for (int e = threadIdx.x; e < nq * D; e += blockDim.x) {
    const int i = e / D, d = e - i * D;
    qs[e] = q[(size_t)i * q_stride + d] * sm_scale;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int Dk = D + 1;
  float* ks = region + warp * page_size * (2 * D + 1);  // [page][D + 1]
  float* vs = ks + page_size * Dk;                      // [page][D]

  float m[TQ], l[TQ], acc[TQ][DPL];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < DPL; ++cc) acc[i][cc] = 0.f;
  }

  for (int p = p_begin + warp; p < p_end; p += WARPS) {
    stage_page<T>(a, page_row[p], h, lane, ks, vs);
    __syncwarp();
    const int kv_pos = p * page_size + lane;   // lane j scores key j
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      if (i < nq) {                            // uniform across the warp
        const bool valid = lane < page_size && kv_pos < kv_len
                           && kv_pos <= pos0 + i;
        float s = kNegInf;
        if (valid) {
          const float* qi = qs + i * D;
          const float* kj = ks + lane * Dk;
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot = fmaf(qi[d], kj[d], dot);
          s = dot;
        }
        float mx = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_new = fmaxf(m[i], mx);
        const float pj = valid ? expf(s - m_new) : 0.f;
        float psum = pj;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          psum += __shfl_xor_sync(kFull, psum, o);
        const float alpha = expf(m[i] - m_new);
        l[i] = l[i] * alpha + psum;
#pragma unroll
        for (int cc = 0; cc < DPL; ++cc) acc[i][cc] *= alpha;
        for (int j = 0; j < page_size; ++j) {
          const float pb = __shfl_sync(kFull, pj, j);
#pragma unroll
          for (int cc = 0; cc < DPL; ++cc) {
            const int d = lane + 32 * cc;
            if (d < D) acc[i][cc] = fmaf(pb, vs[j * D + d], acc[i][cc]);
          }
        }
        m[i] = m_new;
      }
    }
    __syncwarp();                              // page slice free again
  }

  // merge the warps' partial states in fixed warp order
  __syncthreads();                             // walk slices now reused
  float* parts = region;                       // [WARPS][TQ][D + 2]
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    if (i < nq) {
      float* rec = parts + (warp * TQ + i) * W;
      if (lane == 0) {
        rec[0] = m[i];
        rec[1] = l[i];
      }
#pragma unroll
      for (int cc = 0; cc < DPL; ++cc) {
        const int d = lane + 32 * cc;
        if (d < D) rec[2 + d] = acc[i][cc];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nq * D; e += blockDim.x) {
    const int i = e / D, d = e - i * D;
    float mt = kNegInf;
    for (int w = 0; w < WARPS; ++w)
      mt = fmaxf(mt, parts[(w * TQ + i) * W]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float* rec = parts + (w * TQ + i) * W;
      const float sc = expf(rec[0] - mt);
      lt = fmaf(rec[1], sc, lt);
      at = fmaf(rec[2 + d], sc, at);
    }
    emit(i, d, mt, lt, at);
  }
}

// Pages of a row's table a tile must walk: those holding its first
// n_keys key positions (never past the table).
__device__ inline int visible_pages(int n_keys, int page_size,
                                    int pages_per_seq) {
  return min((max(n_keys, 0) + page_size - 1) / page_size, pages_per_seq);
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, opting in
// above the 48 KB default; returns cudaGetLastError() after the launch.
template <typename Args>
cudaError_t launch(void (*kernel)(const Args), dim3 grid, int threads,
                   size_t smem, cudaStream_t stream, const Args& a) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace paged
