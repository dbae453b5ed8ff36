// Paged decode/append attention for Hopper (sm_90a): fp32 queries and
// outputs over an fp32, bf16 or fp16 KV cache, fp32 arithmetic.
//
// Replaces the Pallas TPU kernels of
// flexflow_tpu/ops/kernels/decode_attention.py:
//   * _append_kernel        (launched by paged_append_attention, kv_splits=1,
//                            :368) -> ff_paged_append_{f32,bf16,f16}
//   * _append_kernel_split  (launched by paged_append_attention, kv_splits>1,
//                            :338) together with the plain-XLA
//                            _combine_splits (:248-267, :351) that finishes
//                            its partials -> ff_paged_append_split_{f32,bf16,
//                            f16}, one launch that combines the splits
//                            on-chip
// The suffix names the cache's element type. The Pallas kernels load K and
// V in the cache's dtype and upcast them to fp32 before both products
// (:145-147, :219-221); so do these: one body, templated on the cache
// element, stages K and V rows in that type (a 2-byte cache moves half
// the bytes of an fp32 one) and widens each element exactly where the
// score and value loops read it (bf16: a 16-bit shift; fp16:
// __half2float). Queries, scores, softmax state, accumulators, the
// combine and the output are fp32 in every form.
//
// What it computes, per sequence b: a window of W queries q[b] [W,H,D]
// attends over the cache blocks named by block_tables[b] in
// k/v_cache [num_blocks, block_size, H, D]. Query w keeps key positions
// <= q_positions[b,w] (causal within the window, full history before it);
// q_positions[b,w] < 0 marks a padding query, which emits zeros. Softmax
// is online, in fp32.
//
// Two bodies serve each exported form. A window of kTcMinWindow (9)
// queries or more with a head dim up to 128 (a suffix prefill's, up to its
// bucket of 1024, or a wide verify window) takes the tensor-core body,
// paged_append_tc_kernel, described where it is defined below. Decode and
// verify windows (W <= 8), and head dims past 128, take the CUDA-core body
// described here.
//
// Design. A thread block (CTA) of 4 warps takes one head of one sequence
// over one contiguous range of key positions, for up to 32 queries of the
// window (a wider window with D > 128 is cut into tiles of 32 queries,
// each its own cluster of the same launch: grid (C, H, B * tiles)). The
// TPU kernel walks cache blocks as a sequential grid axis and carries its
// online-softmax state in VMEM scratch from one grid step to the next;
// here a CTA loops over its own range and the ranges combine at the end. Head dims up to 512: past
// 256 an instance holds twice the accumulators a thread and stages one
// tile a round (a 32-query tile then fills most of the shared memory).
//   * ff_paged_append_* splits each (head, sequence, query tile)
//     across a thread-block cluster: grid (C, H, B * tiles), cluster
//     (C, 1, 1), with C = ceil(MB * bs / 128) CTAs, at most 8 (the
//     portable cluster size). The CTAs share the live positions of the
//     tile's queries (up to the largest of their q_positions, plus one)
//     evenly, in whole tiles of 32 positions, so the early query tiles of
//     a causal window skip the keys they cannot see, and the
//     longest sequence of a batch is spread over all C SMs; a short one
//     leaves some CTAs empty. At the serving shape (B = 4, H = 12, 64
//     columns of 16) that is 384 CTAs on the 132 SMs; shared memory is
//     kept to a quarter of an SM's so they run in one wave (at a third,
//     the card holds 45 of the 48 clusters at once).
//   * ff_paged_append_split_* launches the same cluster, but CTA r
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
//     elements per head) of every tile of the round into shared memory
//     with 16-byte cp.async (4 floats or 8 2-byte elements; 4-byte copies
//     where D does not divide into 16-byte chunks or the cache is not
//     16-byte aligned, and plain 2-byte loads for a 2-byte cache of odd
//     D, which cp.async cannot copy), all in flight together: a round
//     costs one memory latency, not one per tile and per K and V. fp32
//     rows are padded to D + 4 floats, 2-byte rows to D (rounded up to
//     8) + 16 elements: the score loop's 8-byte reads are served a
//     half-warp (four positions) at a time, and rows 32 bytes apart put
//     those four on distinct banks at D a multiple of 64;
//   * scores: quad t of the CTA (4 lanes) owns position t of each tile
//     and dots its K row with every query, the lanes taking interleaved
//     chunks of 4 elements of the head dim (16 bytes of an fp32 row, 8 of
//     a 2-byte one), widened to fp32;
//   * softmax: warp j takes queries j, j + 4, ...; lane t holds position
//     t of each tile; one warp max and one warp sum per round update the
//     CTA's state (m, l);
//   * values: each thread owns fixed (query, column) pairs of the tile's
//     [32, D] accumulator, in registers, and folds in the round's V rows.
// A CTA ends holding (m, l, acc). In the cluster the CTAs then combine
// exactly through distributed shared memory: after cluster.sync() each
// CTA writes its slice of the tile's normalised outputs, each element
// reading every CTA's m, l and accumulator element at once and weighting
// CTA r by exp(m_r - m_max) - zero where l_r = 0, a CTA with no live
// position, whose m of -1e30 would otherwise give exp(0) = 1 - and a
// padding query gets exact zeros. A second cluster.sync() keeps every
// CTA's shared memory alive until the others have read it. One launch,
// no scratch in device memory, and capturable in a CUDA graph; both forms
// end this way.
//
// Bound on this card. At decode and verify windows the kernel is bound by
// bytes: it must read the live K and V rows once, 2 * sum(ctx) * H * D *
// 4 bytes per layer (2 for a bf16 or fp16 cache), at the H100's 3.35 TB/s
// (2.1 us at the serving shape in fp32); its 4 * sum(ctx) * H * D fp32 operations per window query are
// far below the 67 TFLOP/s fp32 rate. A wide causal window is bound by
// operations instead (about 1.1 GFLOP causal per layer at W = 1024 over
// 1024 positions, H = 12, D = 64): the tensor-core body takes them. At
// decode sizes the time is latency, not bytes:
// the cluster's launch (about 2.3 us with nothing to do), two dependent
// reads (positions, queries and table, then K and V), four barriers a
// round and the combine's remote reads between the cluster's two barriers
// (tools/paged_probe.py times each part, and the split form's design
// variants: this cluster, a 16-CTA cluster, and per-CTA partials in a
// global scratch that the last CTA of a head combines).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

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
// the widest head dim: instances hold accumulators for up to 256 or 512
// columns (kMaxD), so the 256-wide ones keep today's registers
constexpr int kMaxHeadDim = 512;
constexpr int kTableWindow = 2048;   // table columns a CTA holds in shared memory at most

__host__ __device__ inline int round4(int d) { return (d + 3) & ~3; }

// row stride (elements) of a staged K or V tile of cache element T. fp32:
// D rounded up to 4, plus 4, so the score reads of neighbouring positions
// are offset by 4 banks; 2 bytes: D rounded up to 8, plus 16 (32 bytes),
// so the four rows of a half-warp's 8-byte reads are 8 banks apart
template <typename T>
__host__ __device__ inline int tile_ld(int d) {
  return sizeof(T) == 4 ? round4(d) + 4 : ((d + 7) & ~7) + 16;
}

// four consecutive staged elements as fp32 (exact widening); p is 16-byte
// aligned for fp32, 8-byte aligned for a 2-byte cache
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);  // element 0 in the low half of u.x
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const f16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__half2float(__ushort_as_half(static_cast<unsigned short>(u.x))),
                     __half2float(__ushort_as_half(static_cast<unsigned short>(u.x >> 16))),
                     __half2float(__ushort_as_half(static_cast<unsigned short>(u.y))),
                     __half2float(__ushort_as_half(static_cast<unsigned short>(u.y >> 16))));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) {
  return __uint_as_float(static_cast<uint32_t>(__bfloat16_as_ushort(x)) << 16);
}
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }

// one element, by its bits, from device memory (or zero when !ok): the
// copy of a 2-byte cache whose rows cp.async cannot take
template <typename T>
__device__ __forceinline__ void copy1(T* dst, const T* src, bool ok) {
  using U = typename std::conditional<sizeof(T) == 4, unsigned int, unsigned short>::type;
  *reinterpret_cast<U*>(dst) = ok ? __ldg(reinterpret_cast<const U*>(src)) : U(0);
}

// one chunk of a K row and of a V row into shared memory: 16 or 4 bytes
// by cp.async (vec 2 or 1), or one element (vec 0); zeros where !ok
template <typename T>
__device__ __forceinline__ void copy_chunk(T* kd, T* vd, const T* k, const T* v, bool ok,
                                           int vec) {
  if (vec == 2) {
    cp_async16(kd, k, ok);
    cp_async16(vd, v, ok);
  } else if (vec == 1) {
    cp_async4(kd, k, ok);
    cp_async4(vd, v, ok);
  } else {
    copy1(kd, k, ok);
    copy1(vd, v, ok);
  }
}

// output (w, d) of a query tile, combined exactly (as described at the top
// of this file) over the cluster's S CTAs from each CTA's m_s[w], l_s[w]
// and accumulator element acc_s[a]; 0 for a padding query (!real)
__device__ __forceinline__ float combined(cg::cluster_group& cluster, int S, float* m_s,
                                          float* l_s, float* acc_s, int w, int a, bool real) {
  float mr[kMaxCluster], lr[kMaxCluster], ar[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    mr[r] = r < S ? *cluster.map_shared_rank(m_s + w, r) : kNegInf;
    lr[r] = r < S ? *cluster.map_shared_rank(l_s + w, r) : 0.f;
    ar[r] = r < S ? cluster.map_shared_rank(acc_s, r)[a] : 0.f;
  }
  float mx = kNegInf;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (lr[r] > 0.f) mx = fmaxf(mx, mr[r]);
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    const float e = lr[r] > 0.f ? expf(mr[r] - mx) : 0.f;
    num = fmaf(ar[r], e, num);
    den = fmaf(lr[r], e, den);
  }
  return real ? num / fmaxf(den, 1e-30f) : 0.f;
}

// T: the cache's element type (float, bf16, f16). kMaxW: the queries a CTA
// takes (1, 8 or 32), and kMaxD the widest head
// dim of the instance (256 or 512), compile-time bounds so the per-thread
// scores and accumulators stay in registers (kMaxW * kMaxD / 128 of them:
// 128 for a 32-query tile past D = 256). A window wider than
// kMaxW is cut into tiles of kMaxW queries, each its own cluster along
// grid z (z = sequence * tiles + tile). kSplit: the split-KV form, whose
// CTA r takes table columns [r * cta_cols, (r + 1) * cta_cols) instead of
// a share of the live positions.
template <typename T, int kMaxW, bool kSplit, int kMaxD>
__global__ void __launch_bounds__(kThreads) paged_append_kernel(
    const float* __restrict__ q,           // [B, W, H, D]
    const T* __restrict__ k_cache,         // [num_blocks, bs, H, D]
    const T* __restrict__ v_cache,         // [num_blocks, bs, H, D]
    const int* __restrict__ block_tables,  // [B, MB]
    const int* __restrict__ q_positions,   // [B, W]
    float* __restrict__ out,               // [B, W, H, D]
    int W, int H, int D, int bs, int MB,
    int cta_cols,  // split form: table columns a CTA takes
    int bt_held,   // table columns a CTA holds in shared memory, from its first
    int stages,
    int vec,  // 2: 16-byte cp.async, 1: 4-byte cp.async, 0: plain 2-byte loads
    float scale) {
  constexpr int kPairs = kMaxW * kMaxD / kThreads;  // (query, column) pairs a thread owns
  const int q_tiles = (W + kMaxW - 1) / kMaxW;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z / q_tiles;
  const int w0 = (blockIdx.z - b * q_tiles) * kMaxW;  // the tile's first query
  const int Wt = min(kMaxW, W - w0);                // its queries
  const int Wl = min(kMaxW, W);  // queries the shared-memory layout holds, the same in every CTA
  const int S = gridDim.x;  // the cluster's CTAs
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d4 = round4(D), ld = tile_ld<T>(D);
  const long long HD = static_cast<long long>(H) * D;

  extern __shared__ __align__(16) float smem[];
  T* tiles = reinterpret_cast<T*>(smem);  // [stages][K, V][kTile][ld]: the tiles of a round
  long long* row_s = reinterpret_cast<long long*>(tiles + stages * 2 * kTile * ld);  // [kRound]
  float* q_s = reinterpret_cast<float*>(row_s + kRound);  // [Wl][d4] scaled queries, zero past D
  float* sp_s = q_s + Wl * d4;                   // [Wl][kRound + 1] scores, then probabilities
  float* m_s = sp_s + Wl * (kRound + 1);         // [Wl] running max
  float* l_s = m_s + Wl;                         // [Wl] running denominator
  float* c_s = l_s + Wl;                         // [Wl] this round's rescale factor
  int* qp_s = reinterpret_cast<int*>(c_s + Wl);  // [Wl] query positions
  int* bt_s = qp_s + Wl;                         // [bt_held] table columns from col0

  // the table columns this CTA holds: from its range's first, or from the row's first
  const int col0 = kSplit ? s * cta_cols : 0;
  const int* bt = block_tables + static_cast<long long>(b) * MB;
  for (int i = tid; i < min(bt_held, MB - col0); i += kThreads) bt_s[i] = bt[col0 + i];
  for (int w = tid; w < Wt; w += kThreads) {
    qp_s[w] = q_positions[static_cast<long long>(b) * W + w0 + w];
    m_s[w] = kNegInf;
    l_s[w] = 0.f;
  }
  for (int i = tid; i < Wt * d4; i += kThreads) {
    const int w = i / d4, d = i - w * d4;
    q_s[i] = d < D ? q[(static_cast<long long>(b) * W + w0 + w) * HD +
                       static_cast<long long>(h) * D + d] *
                         scale
                   : 0.f;
  }
  __syncthreads();
  int max_qp = -1;
  for (int w = 0; w < Wt; ++w) max_qp = max(max_qp, qp_s[w]);
  // the key positions this CTA takes, none past the last its tile's
  // queries see (so the early tiles of a causal window skip the keys they
  // cannot see; a tile of padding queries takes none)
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

  // the copies: each thread takes one column chunk of every
  // rows_per_pass-th row, of 16 or 4 bytes (or one element)
  const int chunk = vec == 2 ? 16 / static_cast<int>(sizeof(T))
                             : vec == 1 ? 4 / static_cast<int>(sizeof(T)) : 1;
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
        T* kd = tiles + (t / kTile) * 2 * kTile * ld + (t % kTile) * ld;
        T* vd = kd + kTile * ld;
        for (int c = my_c; c < d4; c += tpr * chunk) {
          const bool ok = off >= 0 && c < D;
          const long long src = ok ? off + c : 0;
          copy_chunk(kd + c, vd + c, k_cache + src, v_cache + src, ok, vec);
        }
      }
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // scores of position quad_t of every tile with every query
    for (int j = 0; j < nt; ++j) {
      const T* kr = tiles + j * 2 * kTile * ld + quad_t * ld;
      float dots[kMaxW];
#pragma unroll
      for (int w = 0; w < kMaxW; ++w) dots[w] = 0.f;
      for (int c = quad_c; c < d4; c += 16) {
        const float4 kk = load4(kr + c);
#pragma unroll
        for (int w = 0; w < kMaxW; ++w) {
          if (w < Wt) {
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
        if (w < Wt) {
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
    for (int w = warp; w < Wt; w += kWarps) {
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
      if (idx < Wt * D) {
        const int w = idx / D, d = idx - w * D;
        float a = acc[k] * c_s[w];
        for (int j = 0; j < nt; ++j) {
          const float* pr = sp_s + w * (kRound + 1) + j * kTile;
          const T* vt = tiles + (2 * j + 1) * kTile * ld + d;
#pragma unroll 8
          for (int t = 0; t < kTile; ++t) a = fmaf(pr[t], to_f32(vt[t * ld]), a);
        }
        acc[k] = a;
      }
    }
  }
  __syncthreads();  // every tile is consumed: the tiles' memory is free

  // combine the cluster's CTAs exactly, through distributed shared memory
  cg::cluster_group cluster = cg::this_cluster();
  float* acc_s = smem;  // [Wt][D], over the tiles (at least kTile * D floats of any T)
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < Wt * D) acc_s[idx] = acc[k];
  }
  cluster.sync();  // every CTA's m, l and acc are written and visible
  // this CTA's slice of the tile's Wt * D outputs; each reads every CTA's
  // m, l and accumulator element, all remote reads in flight together
  const int per = (Wt * D + S - 1) / S;
  const int end = min(Wt * D, (s + 1) * per);
  for (int idx = s * per + tid; idx < end; idx += kThreads) {
    const int w = idx / D, d = idx - w * D;
    out[(static_cast<long long>(b) * W + w0 + w) * HD + static_cast<long long>(h) * D + d] =
        combined(cluster, S, m_s, l_s, acc_s, w, idx, qp_s[w] >= 0);
  }
  cluster.sync();  // no CTA exits while another still reads its shared memory
}

// ================================ wide windows: the tensor-core body
//
// A window of kTcMinWindow queries or more with D <= 128 (a suffix
// prefill's, or a wide verify window) takes this body: a flash-style tile
// over the gathered table whose products run on the tensor cores.
//   * A CTA of 4 warps takes 64 queries of one head of one sequence (16
//     rows a warp, the M of mma.m16n8k8), grid (C, H, B * ceil(W / 64)),
//     and the C CTAs of a cluster share its key range as the CUDA-core
//     body's do (the single-pass form: the live positions, in whole tiles;
//     the split form: runs of whole JAX splits), combined by the same
//     exact DSMEM combine. The single-pass form sizes C from the launch:
//     enough CTAs for kTcCtasPerSm a streaming multiprocessor, at most the
//     portable 8 and one per tile of the table (C = 1 stores straight from
//     the registers, with no combine).
//   * Each thread splits its own A fragments of the scaled queries into
//     TF32 big and small parts once, while its first K/V tile lands, and
//     parks them in shared memory in fragment order (one 16-byte load per
//     part per 8-column step, no bank conflict; held in registers they
//     would take 64 of a thread's registers at D = 64; held as fp32 and
//     split at every tile, 1% slower at W = 1024).
//   * It walks its key range in tiles of kTcKeys positions, gathered row by
//     row through the block table (position p is cache row
//     bt[p / bs] * bs + p % bs) into shared memory by cp.async as the
//     CUDA-core body copies (16 bytes, 4 bytes, or plain 2-byte loads), two
//     stages deep: tile i + 1's copies are in flight while tile i is
//     computed. Rows are padded by 16 bytes, so every fragment load of a
//     warp hits distinct banks. The causal skip: a query tile's range ends
//     at its largest q_position + 1, and a warp skips a tile that starts
//     past its own largest q_position. The last query tiles of a window,
//     which see the most positions, launch first (in launch order, a
//     W = 1024 window took 0.094 ms against 0.071 in fp32).
//   * S = (scale Q) K^T and O += P V on mma.sync m16n8k8 TF32 with fp32
//     accumulation, the online softmax on the accumulator fragments (a row
//     lives in one quad), P reused as the A operand through the permuted
//     reduction order of common.cuh (acc_to_a, load_b_kn_permuted). The
//     mask keeps key positions p <= q_positions[row] inside the range.
//   * Precision: an fp32 cache takes 3xTF32 (big small + small big + big
//     big) for both products; a bf16 or fp16 K or V element is a TF32
//     value exactly, so Q K^T takes two products (q big and small against
//     K) and P V two (P big and small against V). Every sum is fp32, as in
//     the CUDA-core body, and the gate stays atol 1e-4 + rtol 1e-4 (one
//     plain TF32 product would not hold it:
//     tests/test_torch_port_paged_tc_numerics.py).
//   * A padding query (q_position < 0) and a row with no live position
//     give exact zeros, never NaN.
// Bound: at W = 1024 over 1024 positions (H = 12, D = 64) the causal
// products are about 1.1 GFLOP, 3 x that on the TF32 tensor cores (495
// TFLOP/s): 0.0068 ms; 2 x for a 2-byte cache. The body takes about 10 x
// that (0.072 ms in fp32, 0.051 over a 2-byte cache, on one H100 at
// 700 W): with 2 CTAs an SM the mma.sync chains run at about a third of
// the instruction's rate, as the flash kernels' do, and the probes of
// tools/paged_probe.py --windows find the products without the copies
// at 0.060 ms and the copies alone at 0.043 (K and V staged once per
// query tile, from L2).

constexpr int kTcQueries = 16 * kWarps;  // queries a CTA takes: 16 rows a warp
constexpr int kTcKeys = 64;              // key positions per staged tile
constexpr int kTcMaxHeadDim = 128;       // wider heads keep the CUDA-core body
constexpr int kTcCtasPerSm = 2;          // CTAs a single-pass launch aims at per SM
// The smallest window that takes the tensor-core body; decode and verify
// windows up to 8 queries keep the CUDA-core body, tuned for them. Measured
// by tools/paged_probe.py --windows (one H100 80GB HBM3 at 700 W; one
// sequence's window from position 512, H = 12, D = 64, 64 columns of 16),
// ms of the tensor-core body against the CUDA-core body, single-pass:
//   W      9              16             32             33             40             64
//   fp32   0.0194/0.0339  0.0195/0.0416  0.0202/0.0692  0.0207/0.0669  0.0209/0.0676  0.0218/0.0739
//   bf16   0.0138/0.0235  0.0136/0.0300  0.0143/0.0472  0.0148/0.0474  0.0150/0.0479  0.0155/0.0531
//   fp16   0.0138/0.0238  0.0137/0.0299  0.0142/0.0470  0.0148/0.0473  0.0149/0.0478  0.0155/0.0525
// and split over 8 runs, 0.0185-0.0213 against 0.0275-0.0653 in every form:
// the tensor-core body wins from W = 9 on.
constexpr int kTcMinWindow = 9;

// row stride (elements) of a staged K or V tile: kDP plus 16 bytes
template <typename T, int kDP>
constexpr int kTcLd = kDP + 16 / static_cast<int>(sizeof(T));

// kDP: the head dim padded to 32, 64 or 128
template <typename T, bool kSplit, int kDP>
__global__ void __launch_bounds__(kThreads) paged_append_tc_kernel(
    const float* __restrict__ q,           // [B, W, H, D]
    const T* __restrict__ k_cache,         // [num_blocks, bs, H, D]
    const T* __restrict__ v_cache,         // [num_blocks, bs, H, D]
    const int* __restrict__ block_tables,  // [B, MB]
    const int* __restrict__ q_positions,   // [B, W]
    float* __restrict__ out,               // [B, W, H, D]
    int W, int H, int D, int bs, int MB, int cta_cols, int bt_held, int vec, float scale) {
  constexpr int kNT = kDP / 8;       // 8-column steps of the head dim
  constexpr int kKT = kTcKeys / 8;   // 8-position steps of a tile
  constexpr int kLD = kTcLd<T, kDP>;
  constexpr bool kE = kExact<T>;
  static_assert(kKT * 4 <= 32, "one mask bit per accumulator element");
  const int q_tiles = (W + kTcQueries - 1) / kTcQueries;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z / q_tiles;
  // the tile's first query: the last tiles of a causal window, which see
  // the most positions, launch first
  const int w0 = (q_tiles - 1 - (blockIdx.z - b * q_tiles)) * kTcQueries;
  const int Wt = min(kTcQueries, W - w0);                  // its queries
  const int S = gridDim.x;                                 // the cluster's CTAs
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const long long HD = static_cast<long long>(H) * D;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);  // [2 stages][K, V][kTcKeys][kLD]
  uint4* qf = reinterpret_cast<uint4*>(tiles + 4 * kTcKeys * kLD);  // [warp][kNT][big, small][lane]
  float* m_s = reinterpret_cast<float*>(qf + kWarps * kNT * 2 * 32);  // [kTcQueries]
  float* l_s = m_s + kTcQueries;                                     // [kTcQueries]
  int* qp_s = reinterpret_cast<int*>(l_s + kTcQueries);              // [kTcQueries]
  int* bt_s = qp_s + kTcQueries;                                     // [bt_held]

  const int col0 = kSplit ? s * cta_cols : 0;
  const int* bt = block_tables + static_cast<long long>(b) * MB;
  for (int i = tid; i < min(bt_held, MB - col0); i += kThreads) bt_s[i] = bt[col0 + i];
  for (int w = tid; w < kTcQueries; w += kThreads)
    qp_s[w] = w < Wt ? q_positions[static_cast<long long>(b) * W + w0 + w] : -1;
  __syncthreads();
  const int row0 = warp * 16 + g;  // this thread's query rows: row0, row0 + 8
  int max_qp = -1;
  for (int w = 0; w < Wt; ++w) max_qp = max(max_qp, qp_s[w]);
  const int qr[2] = {qp_s[row0], qp_s[row0 + 8]};
  const int warp_qp = __reduce_max_sync(kFull, max(qr[0], qr[1]));
  int pos0, pos1;  // the key positions this CTA takes
  if (kSplit) {
    const int col1 = static_cast<int>(
        min(static_cast<long long>(col0) + cta_cols, static_cast<long long>(MB)));
    pos0 = col0 * bs;
    pos1 = min(col1 * bs, max_qp + 1);
  } else {
    const int live = min(MB * bs, max_qp + 1);
    const int share = ((live + S - 1) / S + kTcKeys - 1) / kTcKeys * kTcKeys;
    pos0 = s * share;
    pos1 = min(live, pos0 + share);
  }
  const int ntiles = pos1 > pos0 ? (pos1 - pos0 + kTcKeys - 1) / kTcKeys : 0;

  // the copies: each thread takes one column chunk of every
  // rows_per_pass-th row, of 16 or 4 bytes (or one element)
  const int chunk = vec == 2 ? 16 / static_cast<int>(sizeof(T))
                             : vec == 1 ? 4 / static_cast<int>(sizeof(T)) : 1;
  const int per_row = kDP / chunk, tpr = min(per_row, kThreads), rows_per_pass = kThreads / tpr;
  const int my_row = tid / tpr, my_c = (tid - my_row * tpr) * chunk;
  // K and V rows of positions [k0, k0 + kTcKeys) into stage buf; zeros
  // past the range and past D
  auto stage = [&](int k0, int buf) {
    T* kd0 = tiles + buf * 2 * kTcKeys * kLD;
    T* vd0 = kd0 + kTcKeys * kLD;
    for (int r = my_row; r < kTcKeys; r += rows_per_pass) {
      const int p = k0 + r;
      long long off = -1;
      if (p < pos1) {
        const int col = p / bs, c = col - col0;
        const int blk = c < bt_held ? bt_s[c] : __ldg(bt + col);
        off = (static_cast<long long>(blk) * bs + (p - col * bs)) * HD +
              static_cast<long long>(h) * D;
      }
      T* kd = kd0 + r * kLD;
      T* vd = vd0 + r * kLD;
      for (int c = my_c; c < kDP; c += tpr * chunk) {
        const bool ok = off >= 0 && c < D;
        const long long src = ok ? off + c : 0;
        copy_chunk(kd + c, vd + c, k_cache + src, v_cache + src, ok, vec);
      }
    }
  };
  if (ntiles > 0) {
    stage(pos0, 0);
    cp_async_commit();
  }
  // while the first tile lands: this thread's A fragments of (scale Q),
  // split, zero past D and past the tile (only this thread reads them)
#pragma unroll
  for (int d8 = 0; d8 < kNT; ++d8) {
    uint32_t big[4], small[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + 8 * (e & 1), c = 8 * d8 + t + 4 * (e >> 1);
      const float x = r < Wt && c < D ? q[(static_cast<long long>(b) * W + w0 + r) * HD +
                                          static_cast<long long>(h) * D + c]
                                      : 0.f;
      split_tf32(x * scale, big[e], small[e]);
    }
    qf[(warp * kNT + d8) * 64 + lane] = make_uint4(big[0], big[1], big[2], big[3]);
    qf[(warp * kNT + d8) * 64 + 32 + lane] = make_uint4(small[0], small[1], small[2], small[3]);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = pos0 + it * kTcKeys;
    if (it + 1 < ntiles) {  // the next tile loads while this one is computed
      stage(k0 + kTcKeys, (it + 1) & 1);
      cp_async_commit();
    }
    const T* kt = tiles + (it & 1) * 2 * kTcKeys * kLD;
    const T* vt = kt + kTcKeys * kLD;
    if (k0 <= warp_qp) {  // else no row of this warp sees the tile
      // S = (scale Q) K^T, 16 x kTcKeys per warp
      float sc[kKT][4];
#pragma unroll
      for (int n = 0; n < kKT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int d8 = 0; d8 < kNT; ++d8) {
        FragA a;
        const uint4 ab = qf[(warp * kNT + d8) * 64 + lane];
        const uint4 as = qf[(warp * kNT + d8) * 64 + 32 + lane];
        a.big[0] = ab.x, a.big[1] = ab.y, a.big[2] = ab.z, a.big[3] = ab.w;
        a.small[0] = as.x, a.small[1] = as.y, a.small[2] = as.z, a.small[3] = as.w;
#pragma unroll
        for (int n = 0; n < kKT; ++n) {
          FragB bf;
          load_b_nk(bf, kt + n * 8 * kLD + 8 * d8, kLD);
          mma_acc<false, kE>(sc[n], a, bf);
        }
      }
      // online softmax on the fragments; element e of sc[n] is row
      // row0 + 8 * (e / 2), key position k0 + 8n + 2t + e % 2
      uint32_t valid = 0;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = k0 + 8 * n + 2 * t + (e & 1);
          if (p < pos1 && p <= qr[e >> 1]) {
            valid |= 1u << (4 * n + e);
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
          }
        }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        corr[i] = expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int n = 0; n < kKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // explicit zero for masked positions: with every position so far
          // masked m is kNegInf and exp(sc - m) would be 1
          const float pv = (valid >> (4 * n + e)) & 1u ? expf(sc[n][e] - m[e >> 1]) : 0.f;
          sc[n][e] = pv;
          l[e >> 1] += pv;
        }
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
      // O += P V, the positions of each 8-step in the permuted order
#pragma unroll
      for (int j = 0; j < kKT; ++j) {
        FragA a;
        acc_to_a(a, sc[j]);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          FragB bf;
          load_b_kn_permuted(bf, vt + 8 * j * kLD + 8 * n, kLD);
          mma_acc<false, kE>(acc[n], a, bf);
        }
      }
    }
    cp_async_wait_all();  // the next tile has landed
    __syncthreads();      // and every warp is done with this one
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);

  if (S == 1) {  // the whole range in this CTA: normalise and store
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      if (r >= Wt) continue;
      const float inv = qr[i] >= 0 ? 1.f / fmaxf(l[i], 1e-30f) : 0.f;
      float* dst = out + (static_cast<long long>(b) * W + w0 + r) * HD + static_cast<long long>(h) * D;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int d = 8 * n + 2 * t;
        if ((D & 1) == 0 && d + 1 < D) {
          *reinterpret_cast<float2*>(dst + d) = make_float2(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
        } else {
          if (d < D) dst[d] = acc[n][2 * i] * inv;
          if (d + 1 < D) dst[d + 1] = acc[n][2 * i + 1] * inv;
        }
      }
    }
    return;
  }

  // the cluster's CTAs combine exactly through distributed shared memory,
  // as in the CUDA-core body; the accumulators go over the tiles
  cg::cluster_group cluster = cg::this_cluster();
  float* acc_s = reinterpret_cast<float*>(smem_raw);  // [kTcQueries][kDP]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (t == 0) {
      m_s[r] = m[i];
      l_s[r] = l[i];
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      *reinterpret_cast<float2*>(acc_s + r * kDP + 8 * n + 2 * t) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
  cluster.sync();  // every CTA's state is written and visible
  const int per = (Wt * D + S - 1) / S;
  const int end = min(Wt * D, (s + 1) * per);
  for (int idx = s * per + tid; idx < end; idx += kThreads) {
    const int w = idx / D, d = idx - w * D;
    out[(static_cast<long long>(b) * W + w0 + w) * HD + static_cast<long long>(h) * D + d] =
        combined(cluster, S, m_s, l_s, acc_s, w, w * kDP + d, qp_s[w] >= 0);
  }
  cluster.sync();  // this CTA's shared memory stays until the others have read it
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

// the tiles in T, the round's cache rows (long long), then fp32 queries,
// scores and state and int positions and table columns
template <typename T>
size_t smem_bytes(int W, int D, int bt_held, int stages) {
  const size_t w = static_cast<size_t>(W);
  return sizeof(T) * static_cast<size_t>(stages) * 2 * kTile * tile_ld<T>(D) +
         sizeof(long long) * kRound +
         sizeof(float) * (w * round4(D) + w * (kRound + 1) + 4 * w + static_cast<size_t>(bt_held));
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// the widest copy every row takes: 2 (16 bytes), 1 (4 bytes), or 0 (one
// element: a 2-byte cache of odd D, or one not 4-byte aligned)
template <typename T>
int copy_vec(const T* k_cache, const T* v_cache, int D) {
  constexpr int kVec16 = 16 / sizeof(T), kVec4 = 4 / sizeof(T);
  const bool a16 = aligned(k_cache, 16) && aligned(v_cache, 16);
  const bool a4 = aligned(k_cache, 4) && aligned(v_cache, 4);
  return D % kVec16 == 0 && a16 ? 2 : D % kVec4 == 0 && a4 ? 1 : 0;
}

// a launch of `kernel` as clusters of C CTAs along x
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), dim3 grid, int C, size_t smem,
                    cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so that the next launch does not report it
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// C: the cluster's CTAs per (head, sequence); cta_cols and bt_held as in
// the kernel
template <typename T, int kMaxW, bool kSplit, int kMaxD>
int launch(const float* q, const T* k_cache, const T* v_cache, const int* block_tables,
           const int* q_positions, float* out, int B, int W, int H, int D, int bs, int MB, int C,
           int cta_cols, int bt_held, float scale, cudaStream_t stream) {
  // the most stages (tiles a round holds) that leave room for 4 CTAs an
  // SM in a single-pass launch (so the 384 CTAs of the serving shape run
  // in one wave) or 2 in a split launch (its CTAs are few, and 4 stages
  // take a 128-column range of 16 positions in one round); at least one. At D = 64 and W <= 8 that is 3 stages for
  // an fp32 cache and 4 for a 2-byte one
  const int wl = std::min(W, kMaxW);  // queries a CTA holds
  int stages = kMaxStages;
  while (stages > 1 && smem_bytes<T>(wl, D, bt_held, stages) > kSmemLimit / (kSplit ? 2 : 4))
    --stages;
  const size_t smem = smem_bytes<T>(wl, D, bt_held, stages);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  // raise the dynamic shared-memory limit once a device (the first launch
  // of each instance on it); later launches, such as those captured into a
  // CUDA graph, set nothing
  static bool raised[kMaxDevices] = {};
  const int rc = raise_smem_once(paged_append_kernel<T, kMaxW, kSplit, kMaxD>,
                                 static_cast<int>(kSmemLimit), raised);
  if (rc) return rc;
  // a cluster per (query tile, head, sequence)
  return launch_clusters(paged_append_kernel<T, kMaxW, kSplit, kMaxD>,
                         dim3(C, H, B * ((W + kMaxW - 1) / kMaxW)), C, smem, stream, q, k_cache,
                         v_cache, block_tables, q_positions, out, W, H, D, bs, MB, cta_cols,
                         bt_held, stages, copy_vec(k_cache, v_cache, D), scale);
}

// the tensor-core body's shared memory: two stages of K and V tiles, the
// split query fragments, m, l and positions of its queries, table columns
template <typename T, int kDP>
size_t tc_smem_bytes(int bt_held) {
  return sizeof(T) * 4 * kTcKeys * kTcLd<T, kDP> + sizeof(uint4) * kWarps * (kDP / 8) * 2 * 32 +
         sizeof(float) * 3 * kTcQueries + static_cast<size_t>(bt_held) * sizeof(int);
}

// The single-pass tensor-core launch's CTAs per (head, sequence, query
// tile): enough for kTcCtasPerSm CTAs on each SM of the card, at most the
// portable cluster size and one per tile of table positions
int tc_cluster_size(int B, int H, int W, int MB, int bs) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1)
    sms = 132;  // an H100 SXM
  const long long tiles = static_cast<long long>(B) * H * ((W + kTcQueries - 1) / kTcQueries);
  const long long want = (static_cast<long long>(kTcCtasPerSm) * sms + tiles - 1) / tiles;
  const long long table_tiles = (static_cast<long long>(MB) * bs + kTcKeys - 1) / kTcKeys;
  return static_cast<int>(std::max(1LL, std::min<long long>({want, table_tiles, kMaxCluster})));
}

template <typename T, bool kSplit, int kDP>
int launch_tc(const float* q, const T* k_cache, const T* v_cache, const int* block_tables,
              const int* q_positions, float* out, int B, int W, int H, int D, int bs, int MB,
              int C, int cta_cols, int bt_held, float scale, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<T, kDP>(bt_held);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  static bool raised[kMaxDevices] = {};  // the limit is raised once a device, as in launch()
  const int rc = raise_smem_once(paged_append_tc_kernel<T, kSplit, kDP>,
                                 static_cast<int>(kSmemLimit), raised);
  if (rc) return rc;
  return launch_clusters(paged_append_tc_kernel<T, kSplit, kDP>,
                         dim3(C, H, B * ((W + kTcQueries - 1) / kTcQueries)), C, smem, stream, q,
                         k_cache, v_cache, block_tables, q_positions, out, W, H, D, bs, MB,
                         cta_cols, bt_held, copy_vec(k_cache, v_cache, D), scale);
}

template <typename T, bool kSplit, int kMaxD>
int by_window(const float* q, const T* k_cache, const T* v_cache, const int* block_tables,
              const int* q_positions, float* out, int B, int W, int H, int D, int bs, int MB,
              int C, int cta_cols, int bt_held, float scale, cudaStream_t stream) {
  if (W == 1)
    return launch<T, 1, kSplit, kMaxD>(q, k_cache, v_cache, block_tables, q_positions, out, B, W,
                                       H, D, bs, MB, C, cta_cols, bt_held, scale, stream);
  if (W <= 8)
    return launch<T, 8, kSplit, kMaxD>(q, k_cache, v_cache, block_tables, q_positions, out, B, W,
                                       H, D, bs, MB, C, cta_cols, bt_held, scale, stream);
  return launch<T, 32, kSplit, kMaxD>(q, k_cache, v_cache, block_tables, q_positions, out, B, W,
                                      H, D, bs, MB, C, cta_cols, bt_held, scale, stream);
}

template <typename T, bool kSplit>
int dispatch(const float* q, const T* k_cache, const T* v_cache, const int* block_tables,
             const int* q_positions, float* out, int B, int W, int H, int D, int bs, int MB, int C,
             int cta_cols, int bt_held, float scale, cudaStream_t stream) {
  // grid z holds (sequence, query tile) pairs: at most 65535 of them
  if (B < 1 || H < 1 || H > 65535 || W < 1 || D < 1 || D > kMaxHeadDim || bs < 1 || MB < 1 ||
      C < 1 || C > kMaxCluster || cta_cols < 1 || bt_held < 1 ||
      static_cast<long long>(B) * ((W + kTile - 1) / kTile) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (W >= kTcMinWindow && D <= kTcMaxHeadDim) {  // the tensor-core body
    const int c = kSplit ? C : tc_cluster_size(B, H, W, MB, bs);
    if (D <= 32)
      return launch_tc<T, kSplit, 32>(q, k_cache, v_cache, block_tables, q_positions, out, B, W,
                                      H, D, bs, MB, c, cta_cols, bt_held, scale, stream);
    if (D <= 64)
      return launch_tc<T, kSplit, 64>(q, k_cache, v_cache, block_tables, q_positions, out, B, W,
                                      H, D, bs, MB, c, cta_cols, bt_held, scale, stream);
    return launch_tc<T, kSplit, 128>(q, k_cache, v_cache, block_tables, q_positions, out, B, W, H,
                                     D, bs, MB, c, cta_cols, bt_held, scale, stream);
  }
  if (D > 256) return by_window<T, kSplit, 512>(q, k_cache, v_cache, block_tables, q_positions,
                                                out, B, W, H, D, bs, MB, C, cta_cols, bt_held,
                                                scale, stream);
  return by_window<T, kSplit, 256>(q, k_cache, v_cache, block_tables, q_positions, out, B, W, H,
                                   D, bs, MB, C, cta_cols, bt_held, scale, stream);
}

}  // namespace

// Plain C interface, bound with ctypes (flexflow_tpu_torch/ops/kernels/_build.py).
// Every pointer is a device pointer; stream is a cudaStream_t. The
// launches return the cudaError_t of the launch (0 on success), also
// where the card refuses the cluster. q and out are fp32 in every form;
// the suffix names the caches' element type (f32, bf16, f16).

// The single-pass form over a table of MB columns of bs positions.
#define FF_PAGED_APPEND(NAME, T)                                                                 \
  extern "C" int ff_paged_append_##NAME(const float* q, const T* k_cache, const T* v_cache,      \
                                        const int* block_tables, const int* q_positions,         \
                                        float* out, int B, int W, int H, int D, int bs, int MB,  \
                                        float scale, void* stream) {                             \
    if (MB < 1 || bs < 1) return static_cast<int>(cudaErrorInvalidValue);                        \
    return dispatch<T, false>(q, k_cache, v_cache, block_tables, q_positions, out, B, W, H, D,   \
                              bs, MB, cluster_size(MB, bs), MB, std::min(MB, kTableWindow),      \
                              scale, static_cast<cudaStream_t>(stream));                         \
  }

// The split-KV form: a cluster of `ctas` CTAs per (head, sequence), CTA r
// over table columns [r * cta_cols, (r + 1) * cta_cols), writing the
// normalised [B, W, H, D] output. The plan (decode_attention.split_plan)
// must cover the table with every CTA holding a column.
#define FF_PAGED_APPEND_SPLIT(NAME, T)                                                           \
  extern "C" int ff_paged_append_split_##NAME(                                                   \
      const float* q, const T* k_cache, const T* v_cache, const int* block_tables,               \
      const int* q_positions, float* out, int B, int W, int H, int D, int bs, int MB, int ctas,  \
      int cta_cols, float scale, void* stream) {                                                 \
    if (MB < 1 || ctas < 1 || cta_cols < 1 || static_cast<long long>(ctas) * cta_cols < MB ||    \
        static_cast<long long>(ctas - 1) * cta_cols >= MB)                                       \
      return static_cast<int>(cudaErrorInvalidValue);                                            \
    return dispatch<T, true>(q, k_cache, v_cache, block_tables, q_positions, out, B, W, H, D,    \
                             bs, MB, ctas, cta_cols, std::min(cta_cols, kTableWindow), scale,    \
                             static_cast<cudaStream_t>(stream));                                 \
  }

FF_PAGED_APPEND(f32, float)
FF_PAGED_APPEND(bf16, bf16)
FF_PAGED_APPEND(f16, f16)
FF_PAGED_APPEND_SPLIT(f32, float)
FF_PAGED_APPEND_SPLIT(bf16, bf16)
FF_PAGED_APPEND_SPLIT(f16, f16)

// the cluster size ff_paged_append_* launches for a table of MB columns
// of bs positions (0 for an empty table)
extern "C" int ff_paged_append_cluster_size(int MB, int bs) {
  return MB < 1 || bs < 1 ? 0 : cluster_size(MB, bs);
}
