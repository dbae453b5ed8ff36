// Paged decode/append attention for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernels of
// flexflow_tpu/ops/kernels/decode_attention.py:
//   * _append_kernel        (launched by paged_append_attention, kv_splits=1,
//                            :368) -> ff_paged_append_f32
//   * _append_kernel_split  (launched by paged_append_attention, kv_splits>1,
//                            :338) together with the plain-XLA
//                            _combine_splits (:248-267, :351) that finishes
//                            its partials -> ff_paged_append_split_f32, one
//                            launch that combines the splits on-chip
//
// What it computes, per sequence b: a window of W queries q[b] [W,H,D]
// attends over the cache blocks named by block_tables[b] in
// k/v_cache [num_blocks, block_size, H, D]. Query w keeps key positions
// <= q_positions[b,w] (causal within the window, full history before it);
// q_positions[b,w] < 0 marks a padding query, which emits zeros. Softmax
// is online, in fp32.
//
// Design. A thread block (CTA) of 4 warps takes one head of one sequence
// over one contiguous range of key positions. The TPU kernel walks cache
// blocks as a sequential grid axis and carries its online-softmax state in
// VMEM scratch from one grid step to the next; here a CTA loops over its
// own range and the ranges combine at the end.
//   * ff_paged_append_f32 splits each (head, sequence) across a
//     thread-block cluster: grid (C, H, B), cluster (C, 1, 1), with
//     C = ceil(MB * bs / 128) CTAs, at most 8 (the portable cluster
//     size). The CTAs share the sequence's live positions (up to
//     max(q_positions[b]) + 1) evenly, in whole tiles of 32, so the
//     longest sequence of a batch is spread over all C SMs; a short one
//     leaves some CTAs empty. At the serving shape (B = 4, H = 12, 64
//     columns of 16) that is 384 CTAs on the 132 SMs; shared memory is
//     kept to a quarter of an SM's so they run in one wave (at a third,
//     the card holds 45 of the 48 clusters at once).
//   * ff_paged_append_split_f32 launches the same cluster, but CTA r
//     takes a fixed range of table columns: a run of whole splits of the
//     JAX kernel (S splits of ceil(MB / S) columns; those holding a
//     column are grouped into at most 8 runs of consecutive splits, so
//     any S up to MB takes one launch). Its ranges are unions of the JAX
//     splits, so the combine below is the same exact rescaled sum as
//     _combine_splits, done on-chip: no partials reach device memory and
//     no second pass or PyTorch op follows.
// Either form holds at most kTableWindow table columns in shared memory
// (the split form its range's first ones, the single-pass form the row's
// first ones) and reads any further column from device memory as its
// round reaches it, so no table is too wide for either.
// A CTA first reads its query positions, its scaled queries and the table
// columns it holds, all at once. Then it
// works in rounds of up to 4 tiles of 32 positions (as many as shared
// memory holds at that occupancy: 3 at D = 64, so a round covers a
// serving CTA's whole share):
//   * staging: the cache row of each position of the round is computed
//     once, then the threads gather the K and V rows (one cache row of D
//     floats per head) of every tile of the round into shared memory with
//     16-byte cp.async (4-byte where D % 4 != 0 or the cache is not
//     16-byte aligned), all in flight together: a round costs one memory
//     latency, not one per tile and per K and V. Rows are padded to
//     D + 4 floats;
//   * scores: quad t of the CTA (4 lanes) owns position t of each tile
//     and dots its K row with every query, the lanes taking interleaved
//     16-byte chunks of the head dim;
//   * softmax: warp j takes queries j, j + 4, ...; lane t holds position
//     t of each tile; one warp max and one warp sum per round update the
//     CTA's state (m, l);
//   * values: each thread owns fixed (query, column) pairs of the [W, D]
//     accumulator, in registers, and folds in the round's V rows.
// A CTA ends holding (m, l, acc). In the cluster the CTAs then combine
// exactly through distributed shared memory: after cluster.sync() each
// CTA writes its slice of the W * D normalised outputs, each element
// reading every CTA's m, l and accumulator element at once and weighting
// CTA r by exp(m_r - m_max) - zero where l_r = 0, a CTA with no live
// position, whose m of -1e30 would otherwise give exp(0) = 1 - and a
// padding query gets exact zeros. A second cluster.sync() keeps every
// CTA's shared memory alive until the others have read it. One launch,
// no scratch in device memory, and capturable in a CUDA graph; both forms
// end this way.
//
// Bound on this card. The kernel is bound by bytes: it must read the live
// K and V rows once, 2 * sum(ctx) * H * D * 4 bytes per layer, at the
// H100's 3.35 TB/s (2.1 us at the serving shape); its 4 * sum(ctx) * H * D
// fp32 operations per window query are far below the 67 TFLOP/s fp32
// rate. At decode sizes the time is latency, not bytes: the cluster's
// launch (about 2.3 us with nothing to do), two dependent reads
// (positions, queries and table, then K and V), four barriers a round and
// the combine's remote reads between the cluster's two barriers
// (tools/paged_probe.py times each part, and the split form's design
// variants: this cluster, a 16-CTA cluster, and per-CTA partials in a
// global scratch that the last CTA of a head combines).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;            // key positions per staged tile: a quad each, 8 per warp
constexpr int kMaxStages = 4;        // tiles a round can stage
constexpr int kRound = kMaxStages * kTile;
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kCtaPositions = 128;   // table positions per CTA the cluster size aims at
constexpr int kMaxHeadDim = 256;
constexpr int kTableWindow = 2048;   // table columns a CTA holds in shared memory at most

__host__ __device__ inline int round4(int d) { return (d + 3) & ~3; }

// row stride (floats) of a staged K or V tile: D rounded up to 4, plus 4,
// so the score reads of neighbouring positions are offset by 4 banks
__host__ __device__ inline int tile_ld(int d) { return round4(d) + 4; }

// kMaxW: a compile-time bound on W (1, 8 or 32), so the per-thread scores
// and accumulators stay in registers. kSplit: the split-KV form, whose CTA
// r takes table columns [r * cta_cols, (r + 1) * cta_cols) instead of a
// share of the live positions.
template <int kMaxW, bool kSplit>
__global__ void __launch_bounds__(kThreads) paged_append_kernel(
    const float* __restrict__ q,           // [B, W, H, D]
    const float* __restrict__ k_cache,     // [num_blocks, bs, H, D]
    const float* __restrict__ v_cache,     // [num_blocks, bs, H, D]
    const int* __restrict__ block_tables,  // [B, MB]
    const int* __restrict__ q_positions,   // [B, W]
    float* __restrict__ out,               // [B, W, H, D]
    int W, int H, int D, int bs, int MB,
    int cta_cols,  // split form: table columns a CTA takes
    int bt_held,   // table columns a CTA holds in shared memory, from its first
    int stages, int vec, float scale) {
  constexpr int kPairs = kMaxW * kMaxHeadDim / kThreads;  // (query, column) pairs a thread owns
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int S = gridDim.x;  // the cluster's CTAs
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d4 = round4(D), ld = tile_ld(D);
  const long long HD = static_cast<long long>(H) * D;

  extern __shared__ __align__(16) float smem[];
  float* tiles = smem;  // [stages][K, V][kTile][ld]: the tiles of a round
  long long* row_s = reinterpret_cast<long long*>(tiles + stages * 2 * kTile * ld);  // [kRound]
  float* q_s = reinterpret_cast<float*>(row_s + kRound);  // [W][d4] scaled queries, zero past D
  float* sp_s = q_s + W * d4;                   // [W][kRound + 1] scores, then probabilities
  float* m_s = sp_s + W * (kRound + 1);         // [W] running max
  float* l_s = m_s + W;                         // [W] running denominator
  float* c_s = l_s + W;                         // [W] this round's rescale factor
  int* qp_s = reinterpret_cast<int*>(c_s + W);  // [W] query positions
  int* bt_s = qp_s + W;                         // [bt_held] table columns from col0

  // the table columns this CTA holds: from its range's first, or from the row's first
  const int col0 = kSplit ? s * cta_cols : 0;
  const int* bt = block_tables + static_cast<long long>(b) * MB;
  for (int i = tid; i < min(bt_held, MB - col0); i += kThreads) bt_s[i] = bt[col0 + i];
  for (int w = tid; w < W; w += kThreads) {
    qp_s[w] = q_positions[static_cast<long long>(b) * W + w];
    m_s[w] = kNegInf;
    l_s[w] = 0.f;
  }
  for (int i = tid; i < W * d4; i += kThreads) {
    const int w = i / d4, d = i - w * d4;
    q_s[i] = d < D ? q[(static_cast<long long>(b) * W + w) * HD + static_cast<long long>(h) * D + d] *
                         scale
                   : 0.f;
  }
  __syncthreads();
  int max_qp = -1;
  for (int w = 0; w < W; ++w) max_qp = max(max_qp, qp_s[w]);
  // the key positions this CTA takes, none past the last any query sees
  int pos0, pos1;
  if (kSplit) {  // the range's table columns
    const int col1 = static_cast<int>(
        min(static_cast<long long>(col0) + cta_cols, static_cast<long long>(MB)));
    pos0 = col0 * bs;
    pos1 = min(col1 * bs, max_qp + 1);
  } else {  // an even share of the live positions, in whole tiles
    const int live = min(MB * bs, max_qp + 1);
    const int share = ((live + S - 1) / S + kTile - 1) / kTile * kTile;
    pos0 = s * share;
    pos1 = min(live, pos0 + share);
  }

  // the copies: each thread takes one column chunk of every rows_per_pass-th row
  const int chunk = vec ? 4 : 1;
  const int per_row = d4 / chunk, tpr = min(per_row, kThreads), rows_per_pass = kThreads / tpr;
  const int my_row = tid / tpr, my_c = (tid - my_row * tpr) * chunk;
  float acc[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) acc[k] = 0.f;
  const int quad_t = warp * 8 + (lane >> 2);  // the tile position this thread's quad scores
  const int quad_c = (lane & 3) * 4;          // its first head-dim chunk

  // rounds of up to `stages` tiles, every tile of a round in flight at once
  for (int r0 = pos0; r0 < pos1; r0 += stages * kTile) {
    const int rlen = min(stages * kTile, pos1 - r0);  // live positions of the round
    const int nt = (rlen + kTile - 1) / kTile;        // its tiles
    for (int t = tid; t < nt * kTile; t += kThreads) {  // the cache row of each position
      long long off = -1;
      if (t < rlen) {
        const int p = r0 + t, col = p / bs, c = col - col0;
        // a column past the held window (a table or range wider than
        // kTableWindow) comes from device memory
        const int blk = c < bt_held ? bt_s[c] : __ldg(bt + col);
        off = (static_cast<long long>(blk) * bs + (p - col * bs)) * HD +
              static_cast<long long>(h) * D;
      }
      row_s[t] = off;
    }
    __syncthreads();  // and the previous round is consumed
    // K and V rows into the tiles; zeros past the live positions and past D
    if (my_row < rows_per_pass) {
      for (int t = my_row; t < nt * kTile; t += rows_per_pass) {
        const long long off = row_s[t];
        float* kd = tiles + (t / kTile) * 2 * kTile * ld + (t % kTile) * ld;
        float* vd = kd + kTile * ld;
        for (int c = my_c; c < d4; c += tpr * chunk) {
          const bool ok = off >= 0 && c < D;
          const long long src = ok ? off + c : 0;
          if (vec) {
            cp_async16(kd + c, k_cache + src, ok);
            cp_async16(vd + c, v_cache + src, ok);
          } else {
            cp_async4(kd + c, k_cache + src, ok);
            cp_async4(vd + c, v_cache + src, ok);
          }
        }
      }
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // scores of position quad_t of every tile with every query
    for (int j = 0; j < nt; ++j) {
      const float* kr = tiles + j * 2 * kTile * ld + quad_t * ld;
      float dots[kMaxW];
#pragma unroll
      for (int w = 0; w < kMaxW; ++w) dots[w] = 0.f;
      for (int c = quad_c; c < d4; c += 16) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
        for (int w = 0; w < kMaxW; ++w) {
          if (w < W) {
            const float4 qq = *reinterpret_cast<const float4*>(q_s + w * d4 + c);
            dots[w] = fmaf(qq.x, kk.x, dots[w]);
            dots[w] = fmaf(qq.y, kk.y, dots[w]);
            dots[w] = fmaf(qq.z, kk.z, dots[w]);
            dots[w] = fmaf(qq.w, kk.w, dots[w]);
          }
        }
      }
#pragma unroll
      for (int w = 0; w < kMaxW; ++w) {
        if (w < W) {
          float x = dots[w];
          x += __shfl_xor_sync(kFull, x, 1);
          x += __shfl_xor_sync(kFull, x, 2);
          if ((lane & 3) == 0) sp_s[w * (kRound + 1) + j * kTile + quad_t] = x;
        }
      }
    }
    __syncthreads();

    // online softmax over the round, per query: lane t holds position t
    // of each tile; every lane reads the old state before the shuffles,
    // lane 0 writes the new state after them
    for (int w = warp; w < W; w += kWarps) {
      float* row = sp_s + w * (kRound + 1);
      float sc[kMaxStages];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kMaxStages; ++j) {
        const int t = j * kTile + lane;
        sc[j] = j < nt && t < rlen && r0 + t <= qp_s[w] ? row[t] : kNegInf;
        mx = fmaxf(mx, sc[j]);
      }
      const float m_prev = m_s[w];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxStages; ++j) {
        const int t = j * kTile + lane;
        if (j < nt) {
          // explicit zero for masked positions: with every position so
          // far masked m_new is kNegInf and exp(sc - m_new) would be 1
          const float pv = t < rlen && r0 + t <= qp_s[w] ? expf(sc[j] - m_new) : 0.f;
          row[t] = pv;
          sum += pv;
        }
      }
      const float psum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[w] = corr;
        m_s[w] = m_new;
        l_s[w] = l_s[w] * corr + psum;
      }
    }
    __syncthreads();

    // values: this thread's (query, column) pairs
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < W * D) {
        const int w = idx / D, d = idx - w * D;
        float a = acc[k] * c_s[w];
        for (int j = 0; j < nt; ++j) {
          const float* pr = sp_s + w * (kRound + 1) + j * kTile;
          const float* vt = tiles + (2 * j + 1) * kTile * ld + d;
#pragma unroll 8
          for (int t = 0; t < kTile; ++t) a = fmaf(pr[t], vt[t * ld], a);
        }
        acc[k] = a;
      }
    }
  }
  __syncthreads();  // every tile is consumed: the tiles' memory is free

  // combine the cluster's CTAs exactly, through distributed shared memory
  cg::cluster_group cluster = cg::this_cluster();
  float* acc_s = tiles;  // [W][D]
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < W * D) acc_s[idx] = acc[k];
  }
  cluster.sync();  // every CTA's m, l and acc are written and visible
  // this CTA's slice of the W * D outputs; each reads every CTA's m, l
  // and accumulator element, all remote reads in flight together
  const int per = (W * D + S - 1) / S;
  const int end = min(W * D, (s + 1) * per);
  for (int idx = s * per + tid; idx < end; idx += kThreads) {
    const int w = idx / D, d = idx - w * D;
    float mr[kMaxCluster], lr[kMaxCluster], ar[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      mr[r] = r < S ? *cluster.map_shared_rank(m_s + w, r) : kNegInf;
      lr[r] = r < S ? *cluster.map_shared_rank(l_s + w, r) : 0.f;
      ar[r] = r < S ? cluster.map_shared_rank(acc_s, r)[idx] : 0.f;
    }
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (lr[r] > 0.f) mx = fmaxf(mx, mr[r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      const float a = lr[r] > 0.f ? expf(mr[r] - mx) : 0.f;
      num = fmaf(ar[r], a, num);
      den = fmaf(lr[r], a, den);
    }
    out[(static_cast<long long>(b) * W + w) * HD + static_cast<long long>(h) * D + d] =
        qp_s[w] >= 0 ? num / fmaxf(den, 1e-30f) : 0.f;
  }
  cluster.sync();  // no CTA exits while another still reads its shared memory
}

// CTAs a sequence's table is split over: one per kCtaPositions positions
// of its width, at most the portable cluster size, and none without
// table columns
int cluster_size(int MB, int bs) {
  const long long want = (static_cast<long long>(MB) * bs + kCtaPositions - 1) / kCtaPositions;
  const int c = static_cast<int>(std::max(1LL, std::min<long long>({want, kMaxCluster, MB})));
  const int cols = (MB + c - 1) / c;
  return (MB + cols - 1) / cols;
}

size_t smem_bytes(int W, int D, int bt_held, int stages) {
  const size_t w = static_cast<size_t>(W);
  return sizeof(float) * (static_cast<size_t>(stages) * 2 * kTile * tile_ld(D) + 2 * kRound +
                          w * round4(D) + w * (kRound + 1) + 4 * w + static_cast<size_t>(bt_held));
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// C: the cluster's CTAs per (head, sequence); cta_cols and bt_held as in
// the kernel
template <int kMaxW, bool kSplit>
int launch(const float* q, const float* k_cache, const float* v_cache, const int* block_tables,
           const int* q_positions, float* out, int B, int W, int H, int D, int bs, int MB, int C,
           int cta_cols, int bt_held, float scale, cudaStream_t stream) {
  // the most stages (tiles a round holds) that leave room for 4 CTAs an
  // SM in a single-pass launch (so the 384 CTAs of the serving shape run
  // in one wave) or 2 in a split launch (its CTAs are few, and 4 stages
  // take a 128-column range of 16 positions in one round); at least one
  int stages = kMaxStages;
  while (stages > 1 && smem_bytes(W, D, bt_held, stages) > kSmemLimit / (kSplit ? 2 : 4)) --stages;
  const size_t smem = smem_bytes(W, D, bt_held, stages);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  // raise the dynamic shared-memory limit once (the first launch of each
  // instance); later launches, such as those captured into a CUDA graph,
  // set nothing
  static bool ready = false;
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(paged_append_kernel<kMaxW, kSplit>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemLimit));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  const int vec = D % 4 == 0 && aligned16(k_cache) && aligned16(v_cache) ? 1 : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;  // one cluster per (head, sequence)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, paged_append_kernel<kMaxW, kSplit>, q, k_cache, v_cache,
                         block_tables, q_positions, out, W, H, D, bs, MB, cta_cols, bt_held,
                         stages, vec, scale);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so that the next launch does not report it
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kSplit>
int dispatch(const float* q, const float* k_cache, const float* v_cache, const int* block_tables,
             const int* q_positions, float* out, int B, int W, int H, int D, int bs, int MB, int C,
             int cta_cols, int bt_held, float scale, cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || W < 1 || W > 32 || D < 1 || D > kMaxHeadDim ||
      bs < 1 || MB < 1 || C < 1 || C > kMaxCluster || cta_cols < 1 || bt_held < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (W == 1)
    return launch<1, kSplit>(q, k_cache, v_cache, block_tables, q_positions, out, B, W, H, D, bs,
                             MB, C, cta_cols, bt_held, scale, stream);
  if (W <= 8)
    return launch<8, kSplit>(q, k_cache, v_cache, block_tables, q_positions, out, B, W, H, D, bs,
                             MB, C, cta_cols, bt_held, scale, stream);
  return launch<32, kSplit>(q, k_cache, v_cache, block_tables, q_positions, out, B, W, H, D, bs,
                            MB, C, cta_cols, bt_held, scale, stream);
}

}  // namespace

// Plain C interface, bound with ctypes (flexflow_tpu_torch/ops/kernels/_build.py).
// Every pointer is a device pointer; stream is a cudaStream_t. The
// launches return the cudaError_t of the launch (0 on success), also
// where the card refuses the cluster.

extern "C" int ff_paged_append_f32(const float* q, const float* k_cache, const float* v_cache,
                                   const int* block_tables, const int* q_positions, float* out,
                                   int B, int W, int H, int D, int bs, int MB, float scale,
                                   void* stream) {
  if (MB < 1 || bs < 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<false>(q, k_cache, v_cache, block_tables, q_positions, out, B, W, H, D, bs, MB,
                         cluster_size(MB, bs), MB, std::min(MB, kTableWindow), scale,
                         static_cast<cudaStream_t>(stream));
}

// the cluster size ff_paged_append_f32 launches for a table of MB columns
// of bs positions (0 for an empty table)
extern "C" int ff_paged_append_cluster_size(int MB, int bs) {
  return MB < 1 || bs < 1 ? 0 : cluster_size(MB, bs);
}

// The split-KV form: a cluster of `ctas` CTAs per (head, sequence), CTA r
// over table columns [r * cta_cols, (r + 1) * cta_cols), writing the
// normalised [B, W, H, D] output. The plan (decode_attention.split_plan)
// must cover the table with every CTA holding a column.
extern "C" int ff_paged_append_split_f32(const float* q, const float* k_cache,
                                         const float* v_cache, const int* block_tables,
                                         const int* q_positions, float* out, int B, int W, int H,
                                         int D, int bs, int MB, int ctas, int cta_cols,
                                         float scale, void* stream) {
  if (MB < 1 || ctas < 1 || cta_cols < 1 || static_cast<long long>(ctas) * cta_cols < MB ||
      static_cast<long long>(ctas - 1) * cta_cols >= MB)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(q, k_cache, v_cache, block_tables, q_positions, out, B, W, H, D, bs, MB,
                        ctas, cta_cols, std::min(cta_cols, kTableWindow), scale,
                        static_cast<cudaStream_t>(stream));
}
