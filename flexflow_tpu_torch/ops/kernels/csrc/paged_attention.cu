// Paged decode/append attention for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernels of
// flexflow_tpu/ops/kernels/decode_attention.py:
//   * _append_kernel        (launched by paged_append_attention, kv_splits=1)
//   * _append_kernel_split  (launched by paged_append_attention, kv_splits>1;
//                            the partials are finished by the plain-PyTorch
//                            _combine_splits in decode_attention.py)
//
// What it computes, per sequence b: a window of W queries q[b] [W,H,D]
// attends over the cache blocks named by block_tables[b] in
// k/v_cache [num_blocks, block_size, H, D]. Query w keeps key positions
// <= q_positions[b,w] (causal within the window, full history before it);
// q_positions[b,w] < 0 marks a padding query, which emits zeros. Softmax
// is online, in fp32.
//
// Design. One thread block per (head, split, sequence), of 16 warps (8 or 4
// where the window's per-warp state would overflow shared memory). The TPU
// kernel walks cache blocks as a sequential grid axis and carries its
// online-softmax state in VMEM scratch from one grid step to the next;
// here nothing carries between thread blocks. The block reads its own
// block_tables row and q_positions (this replaces scalar prefetch), keeps
// the W <= 32 scaled queries in shared memory, and cuts its range of key
// positions into tiles of 32. The warps take the tiles in turn and run
// independently, without block-wide barriers, each with its own
// online-softmax state (m, l and an fp32 accumulator [W, D] in shared
// memory):
//   * scores: lane t owns key position t of the tile, reads its K row
//     (16-byte loads, eight in flight) and dots it with every query;
//   * softmax: per query, a warp max and a warp sum rescale the state;
//   * values: lane d owns head-dim columns d, d+32, ...; it loads the
//     tile's 32 V values of its column (coalesced across lanes, all in
//     flight at once) and folds them into the accumulator.
// Positions past max(q_positions[b]) are never read, nor are table columns
// past the split's range (the ragged last split of the split-KV form). At
// the end the warp states combine exactly (rescaled by
// exp(m_warp - m_max)). With one split the block writes the normalised
// output; with S splits it writes the unnormalised partials
// (acc [B,S,W,H,D], m and l [B,S,H,W]) in the JAX layout.
//
// Bound on this card. The kernel is bound by bytes: it must read the live
// K and V rows once, 2 * sum(ctx) * H * D * 4 bytes per layer, at the
// H100's 3.35 TB/s; its 4 * sum(ctx) * H * D fp32 operations per window
// query are far below the 67 TFLOP/s fp32 rate. This version hides load
// latency only by the loads each lane keeps in flight and by the warps of
// a block running apart. Staging tiles through shared memory with cp.async
// or TMA in a multi-stage pipeline, more thread blocks per sequence at
// small batch, and wgmma for wide windows are left for a later change.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxWarps = 16;  // warps per block: 16, 8 or 4, as shared memory allows
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr size_t kSmemLimit = 232448;  // bytes of shared memory a block can use on sm_90
constexpr int kTile = 32;  // key positions per warp tile; one per lane
constexpr int kChunk = 8;  // float4 loads a lane keeps in flight on its K row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kMaxW: a compile-time bound on W (1, 8 or 32), so the per-lane scores
// stay in registers. kSplit: write partials instead of the output.
template <int kMaxW, bool kSplit>
__global__ void __launch_bounds__(kMaxThreads) paged_append_kernel(
    const float* __restrict__ q,             // [B, W, H, D]
    const float* __restrict__ k_cache,       // [num_blocks, bs, H, D]
    const float* __restrict__ v_cache,       // [num_blocks, bs, H, D]
    const int* __restrict__ block_tables,    // [B, MB]
    const int* __restrict__ q_positions,     // [B, W]
    float* __restrict__ out,                 // [B, W, H, D] or acc [B, S, W, H, D]
    float* __restrict__ m_out,               // split only: [B, S, H, W]
    float* __restrict__ l_out,               // split only: [B, S, H, W]
    int W, int H, int D, int bs, int MB, int S, int bps, float scale) {
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_s = smem;                          // [W, D] scaled queries (16-byte aligned)
  float* acc_s = q_s + W * D;                 // [nwarps, W, D] per-warp numerators
  float* p_s = acc_s + nwarps * W * D;        // [nwarps, W, kTile] probabilities
  float* m_s = p_s + nwarps * W * kTile;      // [nwarps, W] running max
  float* l_s = m_s + nwarps * W;              // [nwarps, W] running denominator
  float* c_s = l_s + nwarps * W;              // [nwarps, W] rescale factors
  int* qp_s = reinterpret_cast<int*>(c_s + nwarps * W);  // [W] query positions
  int* row_s = qp_s + W;                      // [nwarps, kTile] cache rows of a tile

  const long long HD = static_cast<long long>(H) * D;
  for (int w = tid; w < W; w += nthreads) qp_s[w] = q_positions[static_cast<long long>(b) * W + w];
  for (int i = tid; i < nwarps * W; i += nthreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  for (int i = tid; i < W * D; i += nthreads) {
    const int w = i / D;
    const int d = i - w * D;
    q_s[i] = q[(static_cast<long long>(b) * W + w) * HD + static_cast<long long>(h) * D + d] * scale;
  }
  for (int i = tid; i < nwarps * W * D; i += nthreads) acc_s[i] = 0.f;
  __syncthreads();

  int max_qp = -1;
  for (int w = 0; w < W; ++w) max_qp = max(max_qp, qp_s[w]);

  // this split's key positions: its table columns, clipped to the table
  // and to the last position any query of the window can see
  const int* bt = block_tables + static_cast<long long>(b) * MB;
  const int col0 = s * bps;
  const int col1 = min(col0 + bps, MB);
  const int pos0 = col0 * bs;
  const int pos1 = min(col1 * bs, max_qp + 1);
  const int ntiles = pos1 > pos0 ? (pos1 - pos0 + kTile - 1) / kTile : 0;

  float* acc_w = acc_s + warp * W * D;
  float* p_w = p_s + warp * W * kTile;
  float* m_w = m_s + warp * W;
  float* l_w = l_s + warp * W;
  float* c_w = c_s + warp * W;
  int* row_w = row_s + warp * kTile;
  // 16-byte K loads where every row starts on a 16-byte boundary
  const bool vec4 = (D & 3) == 0 && (reinterpret_cast<uintptr_t>(k_cache) & 15) == 0;

  for (int tile = warp; tile < ntiles; tile += nwarps) {
    const int t0 = pos0 + tile * kTile;
    const int nt = min(kTile, pos1 - t0);
    const int p = t0 + lane;
    const bool live = lane < nt;

    // scores: lane `lane` owns key position p
    float dots[kMaxW];
#pragma unroll
    for (int w = 0; w < kMaxW; ++w) dots[w] = 0.f;
    if (live) {
      const int col = p / bs;
      const int row = bt[col] * bs + (p - col * bs);
      row_w[lane] = row;
      const float* kr = k_cache + static_cast<long long>(row) * HD + static_cast<long long>(h) * D;
      if (vec4) {
        for (int d0 = 0; d0 < D; d0 += 4 * kChunk) {
          float4 kk[kChunk];
#pragma unroll
          for (int u = 0; u < kChunk; ++u)
            kk[u] = d0 + 4 * u < D ? __ldg(reinterpret_cast<const float4*>(kr + d0 + 4 * u))
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
#pragma unroll
            for (int w = 0; w < kMaxW; ++w) {
              if (w < W && d0 + 4 * u < D) {
                const float4 qq = *reinterpret_cast<const float4*>(q_s + w * D + d0 + 4 * u);
                dots[w] = fmaf(qq.x, kk[u].x, dots[w]);
                dots[w] = fmaf(qq.y, kk[u].y, dots[w]);
                dots[w] = fmaf(qq.z, kk[u].z, dots[w]);
                dots[w] = fmaf(qq.w, kk[u].w, dots[w]);
              }
            }
          }
        }
      } else {
        for (int d = 0; d < D; ++d) {
          const float kv = __ldg(kr + d);
#pragma unroll
          for (int w = 0; w < kMaxW; ++w)
            if (w < W) dots[w] = fmaf(q_s[w * D + d], kv, dots[w]);
        }
      }
    }

    // online softmax, per query: every lane reads the old state before
    // the shuffles, lane 0 writes the new state after them
#pragma unroll
    for (int w = 0; w < kMaxW; ++w) {
      if (w < W) {
        const bool valid = live && p <= qp_s[w];
        const float sc = valid ? dots[w] : kNegInf;
        const float m_prev = m_w[w];
        const float m_new = fmaxf(m_prev, warp_max(sc));
        // explicit zero for masked lanes: with every position so far
        // masked m_new is kNegInf and exp(sc - m_new) would be 1
        const float pv = valid ? expf(sc - m_new) : 0.f;
        p_w[w * kTile + lane] = pv;
        const float psum = warp_sum(pv);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          c_w[w] = corr;
          m_w[w] = m_new;
          l_w[w] = l_w[w] * corr + psum;
        }
      }
    }
    __syncwarp();

    // values: lane owns head-dim columns d = lane, lane + 32, ...
    for (int d = lane; d < D; d += 32) {
      float vcol[kTile];
#pragma unroll
      for (int t = 0; t < kTile; ++t)
        vcol[t] = t < nt ? __ldg(v_cache + static_cast<long long>(row_w[t]) * HD +
                                 static_cast<long long>(h) * D + d)
                         : 0.f;
      for (int w = 0; w < W; ++w) {
        const float* pr = p_w + w * kTile;
        float a = acc_w[w * D + d] * c_w[w];
#pragma unroll
        for (int t = 0; t < kTile; ++t) a = fmaf(pr[t], vcol[t], a);
        acc_w[w * D + d] = a;
      }
    }
    __syncwarp();  // row_w / p_w are rewritten by the warp's next tile
  }
  __syncthreads();

  // combine the warps' states exactly: alpha_j = exp(m_j - m_max)
  float* mx_s = p_s;      // [W] (p_s is free now)
  float* den_s = p_s + W; // [W]
  for (int w = tid; w < W; w += nthreads) {
    float mx = kNegInf;
    for (int j = 0; j < nwarps; ++j) mx = fmaxf(mx, m_s[j * W + w]);
    float den = 0.f;
    for (int j = 0; j < nwarps; ++j) {
      const float a = expf(m_s[j * W + w] - mx);  // an empty warp has l = acc = 0
      c_s[j * W + w] = a;
      den = fmaf(l_s[j * W + w], a, den);
    }
    mx_s[w] = mx;
    den_s[w] = den;
  }
  __syncthreads();

  const long long bsi = static_cast<long long>(b) * S + s;
  for (int i = tid; i < W * D; i += nthreads) {
    const int w = i / D;
    const int d = i - w * D;
    float a = 0.f;
    for (int j = 0; j < nwarps; ++j) a = fmaf(acc_s[(j * W + w) * D + d], c_s[j * W + w], a);
    if (kSplit) {
      out[(bsi * W + w) * HD + static_cast<long long>(h) * D + d] = a;
    } else {
      out[(static_cast<long long>(b) * W + w) * HD + static_cast<long long>(h) * D + d] =
          qp_s[w] >= 0 ? a / fmaxf(den_s[w], 1e-30f) : 0.f;
    }
  }
  if (kSplit) {
    for (int w = tid; w < W; w += nthreads) {
      m_out[(bsi * H + h) * W + w] = mx_s[w];
      l_out[(bsi * H + h) * W + w] = den_s[w];
    }
  }
}

size_t smem_bytes(int W, int D, int nwarps) {
  const size_t w = static_cast<size_t>(W);
  const size_t d = static_cast<size_t>(D);
  const size_t nw = static_cast<size_t>(nwarps);
  return sizeof(float) * (w * d + nw * w * d + nw * w * kTile + 3 * nw * w) +
         sizeof(int) * (w + nw * kTile);
}

template <int kMaxW, bool kSplit>
int launch(const float* q, const float* k_cache, const float* v_cache, const int* block_tables,
           const int* q_positions, float* out, float* m_out, float* l_out, int B, int W, int H,
           int D, int bs, int MB, int S, int bps, float scale, cudaStream_t stream) {
  // the most warps whose per-warp state fits: more warps, more key
  // positions in flight for a sequence
  int nwarps = kMaxWarps;
  while (nwarps > 4 && smem_bytes(W, D, nwarps) > kSmemLimit) nwarps /= 2;
  const size_t smem = smem_bytes(W, D, nwarps);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_append_kernel<kMaxW, kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(H, S, B);
  paged_append_kernel<kMaxW, kSplit><<<grid, 32 * nwarps, smem, stream>>>(
      q, k_cache, v_cache, block_tables, q_positions, out, m_out, l_out, W, H, D, bs, MB, S, bps,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSplit>
int dispatch(const float* q, const float* k_cache, const float* v_cache, const int* block_tables,
             const int* q_positions, float* out, float* m_out, float* l_out, int B, int W, int H,
             int D, int bs, int MB, int S, int bps, float scale, cudaStream_t stream) {
  if (W < 1 || W > 32 || D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (W == 1)
    return launch<1, kSplit>(q, k_cache, v_cache, block_tables, q_positions, out, m_out, l_out, B,
                             W, H, D, bs, MB, S, bps, scale, stream);
  if (W <= 8)
    return launch<8, kSplit>(q, k_cache, v_cache, block_tables, q_positions, out, m_out, l_out, B,
                             W, H, D, bs, MB, S, bps, scale, stream);
  return launch<32, kSplit>(q, k_cache, v_cache, block_tables, q_positions, out, m_out, l_out, B,
                            W, H, D, bs, MB, S, bps, scale, stream);
}

}  // namespace

// Plain C interface, bound with ctypes (flexflow_tpu_torch/ops/kernels/_build.py).
// Every pointer is a device pointer; stream is a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success).

extern "C" int ff_paged_append_f32(const float* q, const float* k_cache, const float* v_cache,
                                   const int* block_tables, const int* q_positions, float* out,
                                   int B, int W, int H, int D, int bs, int MB, float scale,
                                   void* stream) {
  return dispatch<false>(q, k_cache, v_cache, block_tables, q_positions, out, nullptr, nullptr, B,
                         W, H, D, bs, MB, 1, MB, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int ff_paged_append_split_f32(const float* q, const float* k_cache,
                                         const float* v_cache, const int* block_tables,
                                         const int* q_positions, float* acc, float* m, float* l,
                                         int B, int W, int H, int D, int bs, int MB, int S,
                                         int bps, float scale, void* stream) {
  return dispatch<true>(q, k_cache, v_cache, block_tables, q_positions, acc, m, l, B, W, H, D,
                        bs, MB, S, bps, scale, static_cast<cudaStream_t>(stream));
}
