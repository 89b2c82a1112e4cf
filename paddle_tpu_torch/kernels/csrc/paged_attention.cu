// Paged decode attention for sm_90a: one query token per slot attends
// that slot's float32 K/V pages through its page-table row.
//
// Replaces paddle_tpu/kernels/paged_attention.py::_decode_kernel,
// reached through paged_attention_pallas, the attention of the per-tier
// decode graph (lm_decode). Semantics, as there: q [B, H, D], pools
// [P, page, H, D], page_table [B, pages_per_seq], seq_lens [B] the
// post-append lengths; slot b's query sits at position seq_lens[b] - 1
// and sees every key position < seq_lens[b] (never past the table). A
// slot with seq_len 0 outputs exactly 0 (the Pallas kernel's l == 0
// guard).
//
// Bound. Every K and V position a slot can see is read once (4 B per
// element), plus q and out; the arithmetic is 4 * D float32 operations
// per (slot, key, head), well under one per byte: the kernel is bound by
// the bytes of the pages it streams (48 MB at eight GPT-2-small slots of
// ~1000 tokens, 0.0144 ms at 3.35 TB/s).
//
// Design. The Pallas kernel walks a slot's pages as a sequential grid
// axis and carries the online-softmax state across it. Here a thread-block
// cluster of CS blocks owns one (slot, head): its CS * W warps stride the
// slot's visible pages (worker r * W + w of block rank r takes pages
// r * W + w, + CS * W, ...) on paged_walk.cuh's asynchronous-copy walk,
// the one the ragged kernels' one-query rows run. At the end each block
// merges its warps' (m, l, acc) states in fixed warp order into one record
// in its shared memory; after a cluster barrier the blocks read the
// cluster's records through distributed shared memory and merge them in
// rank order, each block a share of the head-dim columns, and a second
// barrier keeps every record alive until all have read them. No
// workspace, no second launch, no atomics: reruns are bit-identical.
//
// The cluster fills the card where one block per (slot, head) would not
// (eight slots of twelve heads are 96 pairs for 132 SMs; the per-tier
// path's one slot is 12): a warp for every kPagesPerWarp pages of the
// table, kWarps a block, and as many blocks a pair, at most kMaxCluster,
// as stay resident at once (launch_dp). The constants were picked by
// timing variants on the card (chip_tools/decode_tune.py).
#include <cooperative_groups.h>

#include "paged_walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;          // most warps a block
constexpr int kPagesPerWarp = 2;   // a warp for every this many pages
constexpr int kMaxCluster = 8;     // most blocks a (slot, head)
constexpr int kStages = 2;         // a warp's ring: pages it holds
constexpr float kLog2e = 1.4426950408889634f;

struct DecodeParams {
  const float* q;            // [B, H, D]
  paged::Pools pools;        // float32 [P, page, H, D]
  const int* page_table;     // [B, pages_per_seq]
  const int* seq_lens;       // [B]
  float* out;                // [B, H, D]
  int pages_per_seq;
  float scale_log2;          // sm_scale * log2(e)
};

// Every block reaches both cluster barriers, whatever its share of the
// pages (none for a short or empty slot): no early return.
template <int DP, int NS>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const DecodeParams a) {
  using Wk = paged::Walk<float, DP>;
  const cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int H = a.pools.H, D = a.pools.D, ps = a.pools.page_size;
  const int h = blockIdx.y, b = blockIdx.z;
  const int cap = min(a.seq_lens[b], a.pages_per_seq * ps);
  const int n_pages = paged::visible_pages(cap, ps, a.pages_per_seq);
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const size_t row = ((size_t)b * H + h) * D;

  extern __shared__ __align__(128) unsigned char smem[];
  const paged::State st = paged::walk_pages<float, DP, NS>(
      a.pools, a.page_table + (size_t)b * a.pages_per_seq, a.pages_per_seq,
      h, a.q + row, a.scale_log2, cap, rank * W + warp, CS * W, n_pages,
      smem + (size_t)warp * NS * Wk::stage_bytes(ps));

  // merge the block's warps in fixed order into its record, then the
  // cluster's block records in rank order
  __syncthreads();                           // the rings are free
  float* parts = reinterpret_cast<float*>(smem);   // [W][R]
  float* mine = parts + W * Wk::R;                 // the block's record
  paged::store_state<float, DP>(st, parts + warp * Wk::R);
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float mt, lt, at;
    paged::merge_states(d, W, [&](int w) { return parts + w * Wk::R; }, mt,
                        lt, at);
    if (d == 0) {
      mine[0] = mt;
      mine[1] = lt;
    }
    mine[2 + d] = at;
  }
  cluster.sync();                            // every block's record is in
  for (int d = rank * blockDim.x + threadIdx.x; d < D;
       d += CS * blockDim.x) {
    float mt, lt, at;
    paged::merge_states(
        d, CS, [&](int r) { return cluster.map_shared_rank(mine, r); }, mt,
        lt, at);
    a.out[row + d] = lt == 0.f ? 0.f : at / lt;
  }
  cluster.sync();                            // ... and read by all
}

// Blocks of `kernel` (threads, smem bytes) one SM holds at once, asked of
// the runtime once per shape.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  static int known[kWarps + 1][2] = {};      // threads / 32 -> {smem, n}
  int* k = known[threads / 32];
  if (k[0] != (int)smem || k[1] == 0) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                      smem) != cudaSuccess)
      return 1;
    k[0] = (int)smem;
    k[1] = n > 0 ? n : 1;
  }
  return k[1];
}

// W warps a block: one for every kPagesPerWarp pages of the table, at most
// kWarps and as many rings as fit. Blocks a cluster: as many as those warps
// need to take every kPagesPerWarp pages, at most kMaxCluster, and no more
// than keep every (slot, head)'s blocks resident at once on this card: a
// small batch gets large clusters, a large batch one block a pair.
template <int DP>
cudaError_t launch_dp(const DecodeParams& a, int B, cudaStream_t s) {
  using Wk = paged::Walk<float, DP>;
  const int ps = a.pools.page_size;
  const size_t per_warp = kStages * Wk::stage_bytes(ps);
  const int workers = (a.pages_per_seq + kPagesPerWarp - 1) / kPagesPerWarp;
  int warps = workers < kWarps ? workers : kWarps;
  const size_t fit = (size_t)paged::kMaxSmemBytes / per_warp;
  warps = fit < (size_t)warps ? (int)fit : warps;
  if (warps < 1) return cudaErrorInvalidValue;
  const size_t ring = warps * per_warp;
  const size_t merge = sizeof(float) * (warps + 1) * Wk::R;
  const size_t smem = ring > merge ? ring : merge;
  const auto kernel = paged_decode_kernel<DP, kStages>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int device = 0, sms = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const long long resident =
      (long long)sms * blocks_per_sm(kernel, warps * 32, smem);
  const long long pairs = (long long)B * a.pools.H;
  int cluster = (workers + warps - 1) / warps;
  cluster = cluster < kMaxCluster ? cluster : kMaxCluster;
  if ((long long)cluster * pairs > resident)
    cluster = resident > pairs ? (int)(resident / pairs) : 1;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, a.pools.H, B);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() after the launch
// (0 = cudaSuccess). Takes D <= 128 and page_size <= 32; every output
// element is written.
extern "C" int paged_attention_f32(const float* q, const float* k_pool,
                                   const float* v_pool,
                                   const int* page_table,
                                   const int* seq_lens, float* out, int B,
                                   int H, int D, int page_size,
                                   int pages_per_seq, float sm_scale,
                                   void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (D < 1 || D > 128 || page_size < 1 || page_size > 32
      || pages_per_seq < 1 || H < 1 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  // rows and pools take 16-byte copies where D and the pointers allow
  const bool vec = D % 4 == 0 && aligned16(k_pool) && aligned16(v_pool)
                   && aligned16(q);
  const DecodeParams a{q, {k_pool, v_pool, nullptr, nullptr, H, D, page_size,
                           vec ? 1 : 0},
                       page_table, seq_lens, out, pages_per_seq,
                       sm_scale * kLog2e};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return (int)launch_dp<32>(a, B, s);
  if (D <= 64) return (int)launch_dp<64>(a, B, s);
  return (int)launch_dp<128>(a, B, s);
}
