// The page walk the port's one-query paged-attention kernels share, for
// sm_90a: one warp walks its share of a row's K/V pages for one query of
// one head, through the row's page-table row, and keeps a float32
// online-softmax state (m, l, acc) for it.
//
// Used by the decode kernel (paged_attention.cu: one query per slot,
// float32 pages, a thread-block cluster per (slot, head)) and by the
// ragged kernels' one-query rows (ragged_attention.cuh: float32, int8 or
// e4m3 code pages, a block per (row, head), or per (row, head, chunk)
// under the KV split). Each caller owns its grid, its query and output
// layout and where the warps' states merge. The mixed chunk/verify kernel
// (mixed_attention.cu) walks its pages itself and takes only kFull, launch
// and visible_pages from here.
//
// Scale pools. Code pages carry one scale per (position, head) in a pool
// [P, page, H] of float32, float16 or bfloat16 (the page type
// Scaled<code, scale> names the narrow ones; a bare int8_t or e4m3 page
// has float32 scales). A ring stage always holds the page's scales as
// float32: 4-byte scales go by cp.async, 2-byte ones by a plain load
// widened in registers (cp.async moves 4 bytes at least, and a page's
// scales of one head lie H apart), so the walk and the tile read float32
// whatever the pool stores, and no pass widens the pool.
//
// Semantics. The query sees every key position below `cap` (its slot's
// visible context, never past the table); a query that sees no key ends
// with l == 0 and its caller writes exact 0.
//
// Design (walk_pages). A warp walks pages first, first + stride, ... of
// the row (below p_end) through its own ring of NS page slots in shared
// memory: 16-byte cp.async (one page in flight while one is read), its
// pool pages read once from the table into a register, a page's rows at
// a fixed stride (no division on the way to a copy). D / 8 lanes share a
// key (eight columns a lane) and 256 / D keys go at once, so no 16-key
// page idles half a warp. Scores reduce over a key's lanes by shuffles,
// the online softmax (log2 domain, q pre-scaled by sm_scale * log2(e))
// updates once a page, and the key groups' shares are summed at the end.
// merge_states then merges any number of warps' states in a fixed order,
// so two runs give the same bits. No atomics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace paged {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmemBytes = 227 * 1024;   // a block's opt-in limit

// 2^x on the special-function unit (results below 2^-126 flush to 0); the
// same instruction as flash_f32_tiles.cuh's ex2
__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// page element traits: float pools as they are; 1-byte codes four at a
// time from a 32-bit word, exactly; Scale is the scale pool's stored type
template <typename T> struct Page;
template <> struct Page<float> {
  static constexpr bool kQuant = false;
  using Elem = float;
  using Scale = float;
};
template <> struct Page<int8_t> {
  static constexpr bool kQuant = true;
  using Elem = uint8_t;
  using Scale = float;
  // 0x4b0000xx is 2^23 + xx: with the byte biased by 128, subtracting
  // 2^23 + 128 leaves the code
  __device__ static void to_float4(uint32_t w, float (&f)[4]) {
    const uint32_t u = w ^ 0x80808080u;
    f[0] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440)) - 8388736.f;
    f[1] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7441)) - 8388736.f;
    f[2] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7442)) - 8388736.f;
    f[3] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7443)) - 8388736.f;
  }
};
template <> struct Page<__nv_fp8_e4m3> {
  static constexpr bool kQuant = true;
  using Elem = uint8_t;
  using Scale = float;
  __device__ static void to_float4(uint32_t w, float (&f)[4]) {
    const __half2 lo(__nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(w & 0xffffu), __NV_E4M3));
    const __half2 hi(__nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(w >> 16), __NV_E4M3));
    const float2 a = __half22float2(lo), b = __half22float2(hi);
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
};

// code pages of type C whose scale pools store S (__half or
// __nv_bfloat16): the codes' traits, another scale type
template <typename C, typename S> struct Scaled {};
template <typename C, typename S> struct Page<Scaled<C, S>> : Page<C> {
  static_assert(Page<C>::kQuant, "scale pools go with code pages");
  using Scale = S;
};

// a stored scale, widened to float32 exactly
__device__ inline float widen(float s) { return s; }
__device__ inline float widen(__half s) { return __half2float(s); }
__device__ inline float widen(__nv_bfloat16 s) { return __bfloat162float(s); }

// The scales of one (position, head) of a page into a ring stage's
// float32 slots: 4-byte scales by cp.async (the caller commits and
// waits), 2-byte ones by plain loads widened in registers; !in writes 0.
template <typename T>
__device__ inline void stage_scales(float* kdst, float* vdst,
                                    const void* k_scale, const void* v_scale,
                                    size_t g, bool in) {
  using S = typename Page<T>::Scale;
  const S* ks = static_cast<const S*>(k_scale);
  const S* vs = static_cast<const S*>(v_scale);
  if constexpr (sizeof(S) == 4) {
    cpasync::copy4(kdst, ks + g, in);
    cpasync::copy4(vdst, vs + g, in);
  } else {
    *kdst = in ? widen(ks[g]) : 0.f;
    *vdst = in ? widen(vs[g]) : 0.f;
  }
}

// N (4 or 8) codes from shared memory (N-byte aligned) as floats
template <typename T, int N>
__device__ inline void load_codes(const uint8_t* p, float (&f)[N]) {
  static_assert(N == 4 || N == 8, "one 4- or 8-byte load");
  uint32_t w[N / 4];
  if constexpr (N == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x;
    w[1] = x.y;
  }
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    float g[4];
    Page<T>::to_float4(w[i], g);
#pragma unroll
    for (int e = 0; e < 4; ++e) f[4 * i + e] = g[e];
  }
}

// The K/V pools [P, page, H, D] (one key's row of head h is D contiguous
// elements at stride H * D) and, for code pools, their scale pools [P,
// page, H] (Page<T>::Scale); vec: rows and pools take 16-byte copies.
struct Pools {
  const void* k_pool;
  const void* v_pool;
  const void* k_scale;
  const void* v_scale;
  int H, D, page_size, vec;
};

// Pages of a row's table holding its first n_keys key positions (never
// past the table).
__device__ inline int visible_pages(int n_keys, int page_size,
                                    int pages_per_seq) {
  return min((max(n_keys, 0) + page_size - 1) / page_size, pages_per_seq);
}

// The walk's shapes: DP / 8 lanes share a key (eight columns a lane),
// 256 / DP keys a pass; a ring stage is one page: K and V rows of DP
// elements, then (codes) the page's scales, padded to 16 bytes.
template <typename T, int DP>
struct Walk {
  static constexpr int LPK = DP / 8;
  static constexpr int KPP = 32 / LPK;
  static constexpr int MP = 32 / KPP;        // passes of a 32-key page
  static constexpr int R = DP + 2;           // a state record, in floats
  __host__ __device__ static size_t rows_bytes(int page_size) {
    return (size_t)page_size * DP * sizeof(typename Page<T>::Elem);
  }
  __host__ __device__ static size_t stage_bytes(int page_size) {
    const size_t b = 2 * rows_bytes(page_size)
                     + (Page<T>::kQuant ? 8 * (size_t)page_size : 0);
    return (b + 15) & ~(size_t)15;
  }
};

// One page of the walk, by the warp's lanes: rows j < page_size of pool
// page `page` (positions base + j; rows at or past n_keys read as 0), K
// and V of head h into rows of DP elements (columns past D 0), then
// (codes) the rows' scales. No division: the page's rows lie at a fixed
// stride H * D.
template <typename T, int DP>
__device__ inline void stage_page(const Pools& a, int page, int h, int base,
                                  int n_keys, typename Page<T>::Elem* ks,
                                  typename Page<T>::Elem* vs, float* kss,
                                  float* vss, int lane) {
  using E = typename Page<T>::Elem;
  const int D = a.D, ps = a.page_size;
  const E* kp = static_cast<const E*>(a.k_pool);
  const E* vp = static_cast<const E*>(a.v_pool);
  const size_t hd = (size_t)a.H * D;
  const size_t row0 = (size_t)page * ps * a.H + h;   // key 0's (row, head)
  const int n_in = min(ps, n_keys - base);           // rows with keys
  if (a.vec) {
    constexpr int kEpc = 16 / sizeof(E);
    constexpr int kCh = DP / kEpc;
    for (int e = lane; e < ps * kCh; e += 32) {
      const int j = e / kCh, c = (e % kCh) * kEpc;
      const bool in = j < n_in && c < D;
      const size_t g = in ? row0 * D + j * hd + c : 0;
      cpasync::copy16(ks + j * DP + c, kp + g, in);
      cpasync::copy16(vs + j * DP + c, vp + g, in);
    }
  } else {
    for (int e = lane; e < ps * DP; e += 32) {
      const int j = e / DP, c = e - j * DP;
      E kv = 0, vv = 0;
      if (j < n_in && c < D) {
        const size_t g = row0 * D + j * hd + c;
        kv = kp[g];
        vv = vp[g];
      }
      ks[j * DP + c] = kv;
      vs[j * DP + c] = vv;
    }
  }
  if constexpr (Page<T>::kQuant) {
    for (int j = lane; j < ps; j += 32) {
      const bool in = j < n_in;
      const size_t g = in ? row0 + (size_t)j * a.H : 0;
      stage_scales<T>(kss + j, vss + j, a.k_scale, a.v_scale, g, in);
    }
  }
}

// column of element i (0..7) of lane s of a key's lanes: float32 rows as
// two float4 (s and s + LPK, so eight lanes read 128 contiguous bytes),
// code rows as eight contiguous bytes
template <typename T, int DP>
__device__ inline int lane_col(int s, int i) {
  if constexpr (Page<T>::kQuant) return 8 * s + i;
  return 4 * s + (i & 3) + (i >> 2) * (DP / 2);
}

template <typename T, int DP>
__device__ inline void load_row8(const typename Page<T>::Elem* row, int s,
                                 float (&f)[8]) {
  if constexpr (Page<T>::kQuant) {
    load_codes<T, 8>(row + 8 * s, f);
  } else {
    const float4 x = *reinterpret_cast<const float4*>(row + 4 * s);
    const float4 y = *reinterpret_cast<const float4*>(row + 4 * s + DP / 2);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
    f[4] = y.x; f[5] = y.y; f[6] = y.z; f[7] = y.w;
  }
}

// A warp's walk state after walk_pages: every lane holds l and the
// columns lane_col(s, 0..7) of acc (the key groups' shares summed), m is
// the running max (log2 domain).
struct State {
  float m, l, acc[8];
};

// The warp walks pages first, first + stride, ... below p_end of
// page_row (n_table pages wide) for query q (D floats; pre-scaled here by
// scale_log2) of head h, which sees key positions below cap, through
// `ring` (NS page slots of Walk<T, DP>::stage_bytes). Every lane of the
// warp calls it; synchronizes the warp only, and leaves no copy in flight.
template <typename T, int DP, int NS>
__device__ inline State walk_pages(const Pools& a, const int* page_row,
                                   int n_table, int h, const float* q,
                                   float scale_log2, int cap, int first,
                                   int stride, int p_end,
                                   unsigned char* ring) {
  using Wk = Walk<T, DP>;
  using E = typename Page<T>::Elem;
  constexpr bool kQuant = Page<T>::kQuant;
  constexpr int LPK = Wk::LPK, KPP = Wk::KPP, MP = Wk::MP;
  const int D = a.D, ps = a.page_size;
  const int lane = threadIdx.x & 31;
  const int s = lane % LPK, kg = lane / LPK;
  const size_t sb = Wk::stage_bytes(ps), rb = Wk::rows_bytes(ps);

  // the query, scaled into the log2 domain
  State st;
  float qr[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int d = lane_col<T, DP>(s, e);
    qr[e] = d < D ? q[d] * scale_log2 : 0.f;
    st.acc[e] = 0.f;
  }
  st.m = -INFINITY;
  st.l = 0.f;

  // this warp's pages: first + stride u, u = 0 .. n_my - 1; lane i holds
  // the pool page of u = i, read once, whether or not the row reaches it
  // (the read need not wait for the row's length)
  const int n_my = first < p_end ? (p_end - first + stride - 1) / stride : 0;
  const int pid = first + lane * stride < n_table
                      ? page_row[first + lane * stride] : 0;
  auto stage = [&](int u) {                  // warp-uniform u
    unsigned char* slot = ring + (u % NS) * sb;
    const int page = u < 32 ? __shfl_sync(kFull, pid, u)
                            : page_row[first + u * stride];
    stage_page<T, DP>(a, page, h, (first + u * stride) * ps, cap,
                      reinterpret_cast<E*>(slot),
                      reinterpret_cast<E*>(slot + rb),
                      reinterpret_cast<float*>(slot + 2 * rb),
                      reinterpret_cast<float*>(slot + 2 * rb) + ps, lane);
  };
#pragma unroll
  for (int u = 0; u < NS - 1; ++u) {
    if (u < n_my) stage(u);
    cpasync::commit();
  }
  for (int u = 0; u < n_my; ++u) {
    // page u + NS - 1 goes to the slot page u - 1 left (freed by the
    // __syncwarp that ended its turn) before page u is waited for
    if (u + NS - 1 < n_my) stage(u + NS - 1);
    cpasync::commit();
    cpasync::wait<NS - 1>();                 // page u has landed
    __syncwarp();
    const unsigned char* slot = ring + (u % NS) * sb;
    const E* ks = reinterpret_cast<const E*>(slot);
    const E* vs = reinterpret_cast<const E*>(slot + rb);
    const float* kss = reinterpret_cast<const float*>(slot + 2 * rb);
    const int base = (first + u * stride) * ps;   // the page's key 0

    // scores of the page: key pp * KPP + kg on this lane's group
    float sc[MP], mx = -INFINITY;
#pragma unroll
    for (int pp = 0; pp < MP; ++pp) {
      if (pp * KPP >= ps) break;             // uniform across the warp
      const int j = pp * KPP + kg;
      const bool key = j < ps;
      float kf[8];
      load_row8<T, DP>(ks + (key ? j : 0) * DP, s, kf);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) dot = fmaf(qr[e], kf[e], dot);
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(kFull, dot, o);
      if constexpr (kQuant) dot *= kss[key ? j : 0];
      const bool valid = key && base + j < cap;
      sc[pp] = valid ? dot : -INFINITY;
      mx = fmaxf(mx, sc[pp]);
    }
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float m_new = fmaxf(st.m, mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = ex2(st.m - m_use);
    st.l *= alpha;
#pragma unroll
    for (int e = 0; e < 8; ++e) st.acc[e] *= alpha;
    st.m = m_new;
#pragma unroll
    for (int pp = 0; pp < MP; ++pp) {
      if (pp * KPP >= ps) break;
      const int j = pp * KPP + kg;
      const bool key = j < ps;
      float vf[8];
      load_row8<T, DP>(vs + (key ? j : 0) * DP, s, vf);
      const float vsc = kQuant ? kss[ps + (key ? j : 0)] : 1.f;
      const float p = ex2(sc[pp] - m_use);   // masked: 0
      st.l += p;
      const float pv = kQuant ? p * vsc : p;
#pragma unroll
      for (int e = 0; e < 8; ++e) st.acc[e] = fmaf(pv, vf[e], st.acc[e]);
    }
    __syncwarp();                            // the slot is free again
  }
  cpasync::wait<0>();

  // sum the key groups' shares
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
    st.l += __shfl_xor_sync(kFull, st.l, o);
#pragma unroll
    for (int e = 0; e < 8; ++e) st.acc[e] += __shfl_xor_sync(kFull, st.acc[e], o);
  }
  return st;
}

// The warp's state as one record of Walk<T, DP>::R floats (m, l,
// acc[DP]), written by the lanes of key group 0.
template <typename T, int DP>
__device__ inline void store_state(const State& st, float* rec) {
  constexpr int LPK = Walk<T, DP>::LPK;
  const int lane = threadIdx.x & 31;
  const int s = lane % LPK;
  if (lane / LPK == 0) {
    if (s == 0) {
      rec[0] = st.m;
      rec[1] = st.l;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) rec[2 + lane_col<T, DP>(s, e)] = st.acc[e];
  }
}

// Column d of n records (record(w) -> its floats) merged in order w = 0 ..
// n - 1 (log2 domain): the merged max mt, sum lt and acc at.
template <typename Record>
__device__ inline void merge_states(int d, int n, Record record, float& mt,
                                    float& lt, float& at) {
  mt = -INFINITY;
  for (int w = 0; w < n; ++w) mt = fmaxf(mt, record(w)[0]);
  const float mu = mt == -INFINITY ? 0.f : mt;
  lt = 0.f;
  at = 0.f;
  for (int w = 0; w < n; ++w) {
    const float* rec = record(w);
    const float f = ex2(rec[0] - mu);
    lt = fmaf(rec[1], f, lt);
    at = fmaf(rec[2 + d], f, at);
  }
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
