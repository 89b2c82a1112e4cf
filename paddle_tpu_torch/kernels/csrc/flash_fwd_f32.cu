// Flash attention forward for sm_90a, float32 inputs, head_dim 64 or 128, on
// the TF32 tensor cores in 3xTF32 (tf32x3.cuh), behind the plain C entry
// flash_fwd_f32.
//
// Replaces paddle_tpu/kernels/flash_attention.py::_fwd_kernel (:61, reached
// through _flash_fwd) for float32. Semantics, as there: tensors are [B, H,
// S, D] with any (b, h, s) strides and a contiguous head dim; query i
// attends key j when not causal, or when j <= i + (Sk - Sq) (bottom-right
// causal). The kernel writes o in float32 and lse = m + log(l) as float32
// [B, H, Sq]; a row that sees no key gets o = 0 and lse = NEG_INF.
//
// Accuracy. Both products (S = Q K^T and O = P V) run as three TF32
// mma.sync (a_small b_big + a_big b_small + a_big b_big, tf32x3.cuh), about
// 2^-20 relative per product against 2^-11 for one TF32 product, whatever
// torch.backends.cuda.matmul.allow_tf32 says. The softmax runs in the log2
// domain: x = s * (scale log2(e)) in float32, p = 2^(x - m) on the
// special-function unit (ex2.approx, ~2^-22 relative), lse = m ln(2) +
// log(l). The tensor cores' float32 sums truncate, so each key tile's P V is
// summed from zero and O = O alpha + tile is formed in rounded float32
// (mma_tile), as the float32 backward sums each walked tile.
//
// Bound. At the training shape [16, 12, 1024, 64] causal the kernel must
// read q, k, v and write o and lse once: 202.1 MB, 0.0603 ms at 3.35 TB/s.
// Its two products are 4 * D operations per visible (query, key) pair, 25.8
// GFLOP, which 3xTF32 runs as 77.4 GFLOP of TF32: 0.1563 ms at the tensor
// cores' 495 TFLOP/s (0.385 ms at the 67 TFLOP/s of float32 FMAs outside
// them). Bound by operations. What the tensor cores leave to the other units
// is the split of every operand and the softmax's elementwise steps, so the
// block's own Q rows are split once and S, P and O stay in registers.
//
// Design (the float32 dQ kernel's layout, flash_bwd_f32.cu, with the online
// softmax of the bf16 forward, flash_fwd_bf16.cu). A block owns WARPS warps
// of 16 * MT query rows of one (b, h), splits them once into big and small
// planes in shared memory, and walks the key tiles of BK up to the causal
// limit, K and V staged by cp.async into a two-stage ring, so the next
// tile's copy runs under this tile's mma. Per key tile, in registers:
// - S = Q K^T (scores), K's B fragments read by ldmatrix and split as read;
// - the causal and length masks apply only on tiles that cross the diagonal
//   or the end of the keys; a warp whose rows see nothing of a tile skips it;
// - the row max reduces over the four lanes that share a row (two
//   __shfl_xor_sync); p = 2^(x - m), and each thread keeps its share of the
//   row sum l, reduced once at the end; O is rescaled by alpha = 2^(m_old -
//   m_new);
// - P is the A operand of P V as it stands: c_to_a turns each score n-tile
//   into the A fragment of one k-step, split in registers, and load_b_perm
//   reads V's rows 2t and 2t + 1 in the same key order (flash_f32_tiles.cuh).
// Every output tile has one writer and there are no atomics: reruns give the
// same bits. Rows that are not 16-byte aligned take a scalar staging path
// (same bits). The grid puts the query tile on its slow axis, reversed, so
// the heaviest causal tiles of every head start first.
//
// Tile shapes (the launch lines below). D 64: four warps of 32 rows (two
// row tiles a warp, so each K and V fragment split feeds two mma) and 32-key
// tiles, 252 registers and no spills, picked by timing candidates at [16,
// 12, 1024, 64] on the card (chip_tools/flash_fwd_f32_tune.py: 0.456 ms
// against 0.499 for eight warps of 16 rows, 0.487-0.648 for the others).
// D 128: two warps of 16 rows and 32-key tiles, 255 registers and no spills.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_f32_tiles.cuh"

namespace {

using namespace f32tiles;

constexpr float kNegInf = -1e30f;            // NEG_INF of the JAX kernels
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;                                // [B, H, Sq]
  Strides sq, sk, sv, so;
  int H, Sq, Sk;
  float scale_log2;                          // sm_scale * log2(e)
  int causal;
};

// A block of WARPS warps owning 16 * MT query rows each; key tiles of BK.
// Shared memory: Q rows as big and small planes, then a two-stage ring of
// raw (K, V) tiles.
template <int D, int WARPS, int MT, int BK>
struct Cfg {
  static constexpr int kThreads = WARPS * 32;
  static constexpr int BQ = 16 * MT * WARPS;
  static constexpr int LD = D + 4;
  static constexpr size_t kQ = sizeof(float) * 2 * BQ * LD;
  static constexpr size_t kStage = sizeof(float) * 2 * BK * LD;
  static constexpr size_t kSmem = kQ + 2 * kStage;
  static_assert(BK % 16 == 0, "whole pairs of score n-tiles");
};

template <int D, int WARPS, int MT, int BK, bool kAligned>
__global__ void __launch_bounds__(WARPS * 32)
fwd_kernel(const Params p) {
  using C = Cfg<D, WARPS, MT, BK>;
  constexpr int BQ = C::BQ, LD = C::LD, THREADS = C::kThreads;
  constexpr int NS = BK / 8;                 // score n-tiles (keys)
  constexpr int ND = D / 8;                  // output n-tiles
  constexpr int WQ = 16 * MT;                // rows per warp
  constexpr int PQ = BQ * LD;                // Q: big to small plane
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* ring = Qs + 2 * PQ;                 // [stage][K, V][BK][LD]

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;    // row group, thread in group
  const int wrow = q0 + warp * WQ;           // the warp's first row
  const int offset = p.Sk - p.Sq;
  // the key tiles the block's rows can see end before this key
  const int k_end = p.causal ? min(p.Sk, max(0, q0 + BQ + offset)) : p.Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const float* kb = p.k + b * p.sk.b + h * p.sk.h;
  const float* vb = p.v + b * p.sv.b + h * p.sv.h;

  // tile j of the walk into ring stage j & 1
  auto stage = [&](int j) {
    float* Ks = ring + (j & 1) * 2 * BK * LD;
    stage_rows<D, BK, THREADS, kAligned>(Ks, kb, p.sk.s, j * BK, p.Sk);
    stage_rows<D, BK, THREADS, kAligned>(Ks + BK * LD, vb, p.sv.s, j * BK,
                                         p.Sk);
  };

  stage_rows<D, BQ, THREADS, kAligned>(Qs, p.q + b * p.sq.b + h * p.sq.h,
                                       p.sq.s, q0, p.Sq);
  cpasync::commit();
  if (n_tiles > 0) stage(0);
  cpasync::commit();
  cpasync::wait<1>();                        // Q has landed
  __syncthreads();
  split_rows<D, BQ, THREADS>(Qs);            // read by the walk after its
                                             // first __syncthreads
  const float* Qw = Qs + warp * WQ * LD;     // this warp's rows

  // rows wrow + 16 m + g (hf 0) and + 8 (hf 1): the running max (log2
  // domain) and this thread's share of the row sum
  float o[MT][ND][4], m[MT][2], l[MT][2];
  zero(o);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[mt][hf] = -INFINITY;
      l[mt][hf] = 0.f;
    }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    cpasync::wait<0>();                      // tile j has landed
    __syncthreads();                         // ... and tile j - 1 is done
    if (j + 1 < n_tiles) stage(j + 1);       // overlaps this tile's mma
    cpasync::commit();
    // no row of this warp sees a key of the tile
    if (p.causal && k0 > wrow + WQ - 1 + offset) continue;
    const float* Ks = ring + (j & 1) * 2 * BK * LD;
    const float* Vs = Ks + BK * LD;

    // S = Q K^T, scaled into the log2 domain; the mask binds only where the
    // tile crosses the diagonal or the end of the keys
    float s[MT][NS][4];
    scores<MT, NS, D, LD, PQ>(s, Qw, Ks, lane);
    const bool masked =
        k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > wrow + offset);
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
        for (int nd = 0; nd < ND; ++nd) {
          o[mt][nd][2 * hf] *= alpha;
          o[mt][nd][2 * hf + 1] *= alpha;
        }
      }
    }
    // O += P V, the tile summed from zero and added in float32
    mma_tile<MT, NS, ND, LD>(o, s, Vs, lane);
  }
  cpasync::wait<0>();

  const long long bh = (long long)b * p.H + h;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lt = l[mt][hf];
      lt += __shfl_xor_sync(kFull, lt, 1);
      lt += __shfl_xor_sync(kFull, lt, 2);
      const float l_safe = lt == 0.f ? 1.f : lt;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        o[mt][nd][2 * hf] /= l_safe;
        o[mt][nd][2 * hf + 1] /= l_safe;
      }
      const int row = wrow + mt * 16 + g + hf * 8;
      if (tq == 0 && row < p.Sq)
        p.lse[bh * p.Sq + row] =
            lt == 0.f ? kNegInf : m[mt][hf] * kLn2 + logf(lt);
    }
    store_rows<D, kAligned>(o[mt], p.o + b * p.so.b + h * p.so.h, p.so.s,
                            wrow + mt * 16, p.Sq, lane);
  }
}

template <int D, int WARPS, int MT, int BK>
cudaError_t launch(const Params& p, int B, bool fast, cudaStream_t stream) {
  using C = Cfg<D, WARPS, MT, BK>;
  const int tiles = (p.Sq + C::BQ - 1) / C::BQ;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * p.H, tiles);
  return fast ? start(fwd_kernel<D, WARPS, MT, BK, true>, grid, C::kThreads,
                      C::kSmem, p, stream)
              : start(fwd_kernel<D, WARPS, MT, BK, false>, grid, C::kThreads,
                      C::kSmem, p, stream);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() after the launch (0 =
// cudaSuccess); a shape the kernel does not take returns
// cudaErrorInvalidValue without launching. `strides` holds (b, h, s) of q,
// k, v and o, in elements. The launch lines name the warps, 16-row tiles a
// warp and keys a walked tile.
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, float* lse, const long long* strides,
                             int B, int H, int Sq, int Sk, int D, float scale,
                             int causal, void* stream) {
  if (!(B > 0 && H > 0 && Sq > 0 && Sk > 0 && B <= 65535 && H <= 65535
        && (long long)B * H <= 0x7fffffffLL))
    return (int)cudaErrorInvalidValue;
  const long long* st = strides;
  const Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<float*>(o), lse,
                 {st[0], st[1], st[2]}, {st[3], st[4], st[5]},
                 {st[6], st[7], st[8]}, {st[9], st[10], st[11]},
                 H, Sq, Sk, scale * kLog2e, causal};
  bool fast = true;
  const void* ptrs[4] = {q, k, v, o};
  for (int t = 0; t < 4; ++t) fast = fast && aligned16(ptrs[t], st + 3 * t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch<64, 4, 2, 32>(p, B, fast, s);
  if (D == 128) return (int)launch<128, 2, 1, 32>(p, B, fast, s);
  return (int)cudaErrorInvalidValue;
}
