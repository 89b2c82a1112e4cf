// The 16-bit flash forward, included by flash_fwd_bf16.cu and
// flash_fwd_f16.cu with FLASH_ELEM / FLASH_SUFFIX set (flash_elem16.cuh).
//
// Flash attention forward for sm_90a, 16-bit inputs T (bf16 or float16),
// head_dim 64 or 128, behind the plain C entry flash_fwd_bf16 or
// flash_fwd_f16.
//
// Replaces paddle_tpu/kernels/flash_attention.py::_fwd_kernel (:61,
// reached through _flash_fwd) for bf16 and float16. Semantics, as there:
// tensors are [B, H, S, D] with any (b, h, s) strides and a contiguous head
// dim; query i attends key j when not causal, or when j <= i + (Sk - Sq)
// (bottom-right causal). o is written in T and lse = m + log(l) in
// float32 [B, H, Sq]; a row that sees no key gets o = 0 and lse = NEG_INF.
// p is rounded to T before its product with v (JAX's p.astype(v.dtype))
// and every product sums in float32.
//
// Bound. At the training shape [16, 12, 1024, 64] causal the kernel must
// read q, k, v and write o and lse once: 25.2 MB, 0.0303 ms at 3.35 TB/s.
// Its products are 4 * D operations per visible (query, key) pair, about
// 25.8 GFLOP, 0.026 ms at the tensor cores' 989 TFLOP/s: bound by bytes
// and operations nearly alike, so the design keeps the tensor cores fed
// from registers and hides every copy behind them.
//
// Design (the FlashAttention-2 layout on mma.sync). A block owns BQ query
// rows of one (b, h) and walks the key tiles of 64 up to the causal limit
// (the key_end rule of _causal_skip); each warp owns 16 * MT of those
// rows: at D 64 four warps of 32 rows (128-row tiles: each K/V fragment
// read from shared memory feeds two mma), at D 128 eight warps of 16 rows.
// Either way two blocks fit an SM (registers at D 64, shared memory at
// D 128). The warp's Q fragments are loaded once by ldmatrix. Per key tile:
// - S = Q K^T by mma.sync.m16n8k16 (bf16 in, float32 sums) stays in the
//   accumulator registers; K's B fragments come from ldmatrix;
// - the scores are scaled by scale * log2(e), the causal and length masks
//   are applied only on tiles that cross the diagonal or the sequence's
//   end, the row max reduces over the four threads sharing a row (two
//   __shfl_xor_sync), p = 2^(s - m) on the special-function unit, and each
//   thread keeps its share of the row sum (reduced once, at the end);
// - p is rounded to bf16 in registers: the m16n8 accumulator layout of two
//   adjacent score tiles is the A fragment of the P V mma as it stands;
//   V's B fragments come from ldmatrix.trans; the output accumulator stays
//   in registers for the whole walk, rescaled by the running max.
// Nothing of S or P touches shared memory. K/V tiles are staged by 16-byte
// cp.async into a two-stage ring, so the next tile's copy runs under this
// tile's mma; shared rows are padded by 16 bytes (ldmatrix's eight row
// reads fall on distinct bank groups). Rows that are not 16-byte aligned
// take a scalar staging path (same bits). Warps whose rows see no key of a
// tile skip it. The grid puts the query tile on its slow axis, reversed,
// so the heaviest causal tiles of every head start first. Every output
// tile has one writer and there are no atomics: reruns give the same bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "flash_elem16.cuh"

namespace {

using T = FLASH_ELEM;

constexpr float kNegInf = -1e30f;            // NEG_INF of the JAX kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {                             // in elements
  long long b, h, s;
};

struct Params {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  float* lse;                                // [B, H, Sq]
  Strides sq, sk, sv, so;
  int H, Sq, Sk;
  float scale_log2;                          // sm_scale * log2(e)
  int causal;
};

constexpr int kBK = 64;                      // keys per tile

// A block of WARPS warps, each owning 16 * MT query rows, over D-wide heads.
template <int D, int MT, int WARPS>
struct Cfg {
  static constexpr int kThreads = WARPS * 32;
  static constexpr int BQ = 16 * MT * WARPS;
  static constexpr int LD = D + 8;           // padded shared row, elements
  static constexpr size_t kQ = sizeof(T) * BQ * LD;
  static constexpr size_t kTile = sizeof(T) * kBK * LD;
  static constexpr size_t kSmem = kQ + 2 * 2 * kTile;   // Q, 2 x (K, V)
};

using cpasync::smem_addr;

__device__ inline void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ inline void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 2^x on the special-function unit (results below 2^-126 flush to 0,
// far under a row sum of at least 1)
__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [r0, r0 + ROWS) of one (b, h) slice into shared rows of D + 8
// elements; rows at or past S read as 0. Aligned rows go by cp.async (the
// caller commits and waits); others by plain loads and stores.
template <int D, int ROWS, int THREADS, bool kAligned>
__device__ inline void stage_rows(T* dst, const T* base, long long stride,
                                  int r0, int S) {
  constexpr int LD = D + 8;
  if constexpr (kAligned) {
    constexpr int kChunks = D / 8;           // 16-byte chunks per row
    static_assert(ROWS * kChunks % THREADS == 0, "whole chunks per thread");
#pragma unroll
    for (int it = 0; it < ROWS * kChunks / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int r = i / kChunks, c = (i % kChunks) * 8, row = r0 + r;
      const bool in = row < S;
      cpasync::copy16(dst + r * LD + c, in ? base + row * stride + c : base,
                      in);
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
      const int r = i / D, c = i % D, row = r0 + r;
      dst[r * LD + c] =
          row < S ? base[row * stride + c] : elem16::from_float<T>(0.f);
    }
  }
}

template <int D, int MT, int WARPS, bool kAligned>
__global__ void __launch_bounds__(WARPS * 32)
fwd_kernel(const Params p) {
  using C = Cfg<D, MT, WARPS>;
  constexpr int BQ = C::BQ, LD = C::LD, THREADS = C::kThreads;
  constexpr int KD = D / 16;                 // k-steps of Q K^T
  constexpr int NS = kBK / 8;                // score n-tiles per key tile
  constexpr int NO = D / 8;                  // output n-tiles
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* ring = Qs + BQ * LD;                    // [stage][K, V][kBK][LD]

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;    // row group, thread in group
  const int wrow = q0 + warp * 16 * MT;      // the warp's first row
  const int offset = p.Sk - p.Sq;
  const int k_end =
      p.causal ? min(p.Sk, max(0, q0 + BQ + offset)) : p.Sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  const T* qb = p.q + b * p.sq.b + h * p.sq.h;
  const T* kb = p.k + b * p.sk.b + h * p.sk.h;
  const T* vb = p.v + b * p.sv.b + h * p.sv.h;

  stage_rows<D, BQ, THREADS, kAligned>(Qs, qb, p.sq.s, q0, p.Sq);
  cpasync::commit();
  if (n_tiles > 0) {
    stage_rows<D, kBK, THREADS, kAligned>(ring, kb, p.sk.s, 0, p.Sk);
    stage_rows<D, kBK, THREADS, kAligned>(ring + kBK * LD, vb, p.sv.s, 0,
                                          p.Sk);
  }
  cpasync::commit();
  cpasync::wait<1>();                        // Q has landed
  __syncthreads();

  uint32_t qf[MT][KD][4];                    // this warp's Q, A fragments
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldsm_x4(qf[mt][kk], Qs + (warp * 16 * MT + mt * 16 + (lane & 15)) * LD
                              + kk * 16 + (lane >> 4) * 8);

  float acc[MT][NO][4];
  float m[MT][2], l[MT][2];                  // rows g and g + 8 of each mt
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[mt][hf] = -INFINITY;
      l[mt][hf] = 0.f;
    }
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    cpasync::wait<0>();                      // tile j has landed
    __syncthreads();                         // ... and tile j - 1 is done
    if (j + 1 < n_tiles) {                   // overlaps this tile's mma
      T* next = ring + ((j + 1) & 1) * 2 * kBK * LD;
      stage_rows<D, kBK, THREADS, kAligned>(next, kb, p.sk.s, k0 + kBK,
                                            p.Sk);
      stage_rows<D, kBK, THREADS, kAligned>(next + kBK * LD, vb, p.sv.s,
                                            k0 + kBK, p.Sk);
    }
    cpasync::commit();
    // no row of this warp sees a key of the tile
    if (p.causal && k0 > wrow + 16 * MT - 1 + offset) continue;
    const T* Ks = ring + (j & 1) * 2 * kBK * LD;
    const T* Vs = Ks + kBK * LD;

    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {  // two key n-tiles per ldmatrix
        uint32_t kf[4];
        ldsm_x4(kf, Ks + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD
                        + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          elem16::mma<T>(s[mt][2 * n2], qf[mt][kk], kf[0], kf[1]);
          elem16::mma<T>(s[mt][2 * n2 + 1], qf[mt][kk], kf[2], kf[3]);
        }
      }
    }

    // the mask binds only where the tile crosses the diagonal or the end
    const bool masked =
        k0 + kBK > p.Sk || (p.causal && k0 + kBK - 1 > wrow + offset);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = wrow + mt * 16 + g + hf * 8;
        const int lim = p.causal ? min(p.Sk, row + offset + 1) : p.Sk;
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[mt][n][2 * hf + e] * p.scale_log2;
            if (masked && k0 + n * 8 + 2 * tq + e >= lim) x = -INFINITY;
            s[mt][n][2 * hf + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[mt][hf], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = ex2(m[mt][hf] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = ex2(s[mt][n][2 * hf + e] - m_use);
            s[mt][n][2 * hf + e] = pe;
            sum += pe;
          }
        l[mt][hf] = l[mt][hf] * alpha + sum;   // this thread's share
        m[mt][hf] = m_new;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[mt][n][2 * hf] *= alpha;
          acc[mt][n][2 * hf + 1] *= alpha;
        }
      }
    }

    // O += P V: score tiles 2kk and 2kk + 1 are the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = elem16::pack<T>(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = elem16::pack<T>(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = elem16::pack<T>(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = elem16::pack<T>(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; ++n2) {  // two output n-tiles each
        uint32_t vf[4];
        ldsm_x4_trans(vf, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                   * LD + n2 * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          elem16::mma<T>(acc[mt][2 * n2], pa[mt], vf[0], vf[1]);
          elem16::mma<T>(acc[mt][2 * n2 + 1], pa[mt], vf[2], vf[3]);
        }
      }
    }
  }
  cpasync::wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lt = l[mt][hf];
      lt += __shfl_xor_sync(kFull, lt, 1);
      lt += __shfl_xor_sync(kFull, lt, 2);
      const int row = wrow + mt * 16 + g + hf * 8;
      if (row >= p.Sq) continue;
      const float inv = lt == 0.f ? 1.f : 1.f / lt;
      T* out = p.o + b * p.so.b + h * p.so.h + row * p.so.s;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int c = n * 8 + 2 * tq;
        const float x0 = acc[mt][n][2 * hf] * inv;
        const float x1 = acc[mt][n][2 * hf + 1] * inv;
        if constexpr (kAligned) {
          *reinterpret_cast<uint32_t*>(out + c) = elem16::pack<T>(x0, x1);
        } else {
          out[c] = elem16::from_float<T>(x0);
          out[c + 1] = elem16::from_float<T>(x1);
        }
      }
      if (tq == 0)
        p.lse[((long long)b * p.H + h) * p.Sq + row] =
            lt == 0.f ? kNegInf : m[mt][hf] * kLn2 + logf(lt);
    }
  }
}

// whether a tensor's rows of one (b, h) slice take 16-byte copies
bool aligned(const void* base, const long long* st, int bytes) {
  unsigned long long bits = reinterpret_cast<unsigned long long>(base);
  for (int i = 0; i < 3; ++i) bits |= (unsigned long long)(st[i] * 2);
  return (bits & (bytes - 1)) == 0;
}

template <int D, int MT, int WARPS>
cudaError_t launch(const Params& p, int B, bool fast, cudaStream_t stream) {
  using C = Cfg<D, MT, WARPS>;
  const int tiles = (p.Sq + C::BQ - 1) / C::BQ;
  if (tiles > 65535 || (long long)B * p.H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const dim3 grid(B * p.H, tiles);
  auto kernel = fast ? fwd_kernel<D, MT, WARPS, true>
                     : fwd_kernel<D, MT, WARPS, false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() after the launch (0 =
// cudaSuccess); a shape the kernel does not take returns
// cudaErrorInvalidValue without launching. `strides` holds (b, h, s) of q,
// k, v and o, in elements. The tile shapes were picked by timing the
// candidates at [16, 12, 1024, D] on the card.
extern "C" int FLASH_ENTRY(flash_fwd_)(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       const long long* strides, int B, int H,
                                       int Sq, int Sk, int D, float scale,
                                       int causal, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long* st = strides;
  const Params p{static_cast<const T*>(q), static_cast<const T*>(k),
                 static_cast<const T*>(v), static_cast<T*>(o), lse,
                 {st[0], st[1], st[2]}, {st[3], st[4], st[5]},
                 {st[6], st[7], st[8]}, {st[9], st[10], st[11]},
                 H, Sq, Sk, scale * kLog2e, causal};
  const bool fast = aligned(q, st, 16) && aligned(k, st + 3, 16)
                    && aligned(v, st + 6, 16) && aligned(o, st + 9, 4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch<64, 2, 4>(p, B, fast, s);
  if (D == 128) return (int)launch<128, 1, 8>(p, B, fast, s);
  return (int)cudaErrorInvalidValue;
}
