// Flash attention forward and backward for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernels of
// flexflow_tpu/ops/kernels/flash_attention.py:
//   * _fwd_kernel      (launched by _flash_fwd)  -> ff_flash_fwd_f32
//   * _bwd_dq_kernel   (launched by _flash_bwd)  -> ff_flash_bwd_dq_f32
//   * _bwd_dkv_kernel  (launched by _flash_bwd)  -> ff_flash_bwd_dkv_f32
//
// What they compute, per (batch b, head h), over q [B,Sq,H,D] and
// k, v [B,Sk,H,D] (indexed in place: a row of one head is D floats at a
// stride of H*D, so the wrapper makes no transposed copies):
//   forward   O = softmax(Q K^T * scale, mask) V and lse = m + log(l) per
//             query row, lse [B,Sq,H];
//   dQ        dQ = scale * sum_k P o (dP - delta) K, with P = exp(S - lse)
//             recomputed and delta = rowsum(dO o O) given;
//   dK, dV    dV = sum_q P^T dO, dK = sum_q dS^T (scale * Q).
// The causal mask keeps q_pos >= k_pos (top-left, as the TPU kernel masks;
// the wrapper refuses causal attention with Sq != Sk). Query rows past Sq
// and key rows past Sk (a ragged tail) are masked here, so any S >= 1 and
// D <= 256 run.
//
// Design. The TPU kernels hold a head's whole K/V sequence in VMEM and walk
// a sequential grid axis; a Hopper block cannot hold it. Every kernel here
// is one block of 8 warps per (tile of 32 rows, head, batch) that loops over
// the other axis in tiles staged through shared memory (dynamic, above
// 48 KB for wide heads), with 64-row tiles for D <= 64 and 32-row tiles
// above. Each warp owns 4 rows of its block's tile:
//   * dot products: lane t owns row t of the current 32-row sub-tile of the
//     other axis and dots it (16-byte shared loads, rows padded by 4 floats
//     so eight lanes hit distinct banks) with each of the warp's 4 rows,
//     which every lane reads as a broadcast;
//   * softmax: a warp max and a warp sum per row (forward only; the
//     backward recomputes P from lse);
//   * accumulation: lane t owns head-dim columns t, t+32, ...; the sub-tile's
//     32 probabilities (or dS values) reach it by warp shuffles.
// Head dims are padded with zeros to a multiple of 32 in shared memory. The
// backward keeps the FlashAttention-2 split of the TPU kernels: dQ gridded
// over query tiles, dK/dV over key tiles, each looping over the other axis,
// so no atomics are needed and gradients are the same from run to run.
// Causal blocks skip key tiles above the diagonal (forward, dQ) and query
// tiles below it (dK/dV).
//
// Bound on this card. At BERT's shapes (S = 128, D = 64) the work is
// operations: 4*S*S*D fp32 multiply-adds per head forward, 10*S*S*D
// backward, against the 67 TFLOP/s fp32 rate (TF32 stays off), and the
// bytes (each of q, k, v, o, dO read or written once) take less time at
// 3.35 TB/s. This version runs on CUDA cores and is bound by shared-memory
// traffic (about one shared load per two multiply-adds) and by the
// shuffles; wgmma on TF32/bf16 operands, register tiling and TMA staging
// are left for a later change.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;                 // rows per warp
constexpr int kBlockRows = kWarps * kRows;  // 32 rows per block tile
constexpr size_t kSmemLimit = 232448;    // bytes of shared memory a block can use on sm_90

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ int64_t row_offset(int b, int s, int S, int h, int H, int D) {
  return ((static_cast<int64_t>(b) * S + s) * H + h) * D;
}

// rows [r0, r0 + nrows) of head (b, h) of a [B,S,H,D] tensor into shared
// memory at leading dimension ld, times mul; zeros past S and past D
template <int kDP>
__device__ void load_tile(float* dst, int ld, const float* __restrict__ src, int b, int h, int r0,
                          int nrows, int S, int H, int D, float mul) {
  for (int i = threadIdx.x; i < nrows * kDP; i += kThreads) {
    const int r = i / kDP;
    const int d = i - r * kDP;
    const int s = r0 + r;
    float x = 0.f;
    if (s < S && d < D) x = src[row_offset(b, s, S, h, H, D) + d] * mul;
    dst[r * ld + d] = x;
  }
}

// per-row scalars (lse or delta, [B,S,H]) of rows [r0, r0 + nrows)
__device__ void load_rows(float* dst, const float* __restrict__ src, int b, int h, int r0,
                          int nrows, int S, int H) {
  for (int i = threadIdx.x; i < nrows; i += kThreads) {
    const int s = r0 + i;
    dst[i] = s < S ? src[(static_cast<int64_t>(b) * S + s) * H + h] : 0.f;
  }
}

// out[r] += dot(lane_row, rows[r]) for the warp's kRows broadcast rows
template <int kDP>
__device__ __forceinline__ void dot4(float (&out)[kRows], const float* lane_row,
                                     const float* rows, int ld) {
#pragma unroll 4
  for (int d = 0; d < kDP; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(lane_row + d);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 y = *reinterpret_cast<const float4*>(rows + r * ld + d);
      out[r] = fmaf(x.x, y.x, out[r]);
      out[r] = fmaf(x.y, y.y, out[r]);
      out[r] = fmaf(x.z, y.z, out[r]);
      out[r] = fmaf(x.w, y.w, out[r]);
    }
  }
}

template <int kNDC>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float (&acc)[kRows][kNDC],
                                           const float (&div)[kRows], int b, int h, int r0,
                                           int S, int H, int D) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = r0 + r;
    if (s >= S) continue;
    float* row = dst + row_offset(b, s, S, h, H, D);
#pragma unroll
    for (int c = 0; c < kNDC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) row[d] = acc[r][c] / div[r];
    }
  }
}

__host__ __device__ constexpr int other_tile(int ndc) { return ndc <= 2 ? 64 : 32; }

// ----------------------------------------------------------------- forward

template <int kNDC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int D, float scale,
                     int causal) {
  constexpr int kDP = 32 * kNDC;
  constexpr int kLD = kDP + 4;
  constexpr int kBK = other_tile(kNDC);
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                     // [32][kDP], pre-scaled
  float* ks = qs + kBlockRows * kDP;    // [kBK][kLD]
  float* vs = ks + kBK * kLD;           // [kBK][kDP]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = q0 + warp * kRows;  // first query row of this warp
  const float* my_q = qs + warp * kRows * kDP;
  load_tile<kDP>(qs, kDP, q, b, h, q0, kBlockRows, Sq, H, D, scale);

  float m[kRows], l[kRows], acc[kRows][kNDC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kNDC; ++c) acc[r][c] = 0.f;
  }
  const int kv_end = causal ? min(Sk, q0 + kBlockRows) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    load_tile<kDP>(ks, kLD, k, b, h, k0, kBK, Sk, H, D, 1.f);
    load_tile<kDP>(vs, kDP, v, b, h, k0, kBK, Sk, H, D, 1.f);
    __syncthreads();
    for (int sub = 0; sub < kBK && k0 + sub < kv_end; sub += 32) {
      const int j = k0 + sub + lane;
      float s[kRows] = {};
      dot4<kDP>(s, ks + (sub + lane) * kLD, my_q, kDP);
      float p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool valid = j < Sk && (!causal || j <= row0 + r);
        const float sv = valid ? s[r] : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(sv));
        p[r] = valid ? expf(sv - m_new) : 0.f;
        const float corr = expf(m[r] - m_new);
        l[r] = l[r] * corr + warp_sum(p[r]);
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < kNDC; ++c) acc[r][c] *= corr;
      }
#pragma unroll 4
      for (int jj = 0; jj < 32; ++jj) {
        const float* vrow = vs + (sub + jj) * kDP + lane;
        float vv[kNDC];
#pragma unroll
        for (int c = 0; c < kNDC; ++c) vv[c] = vrow[32 * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pj = __shfl_sync(kFull, p[r], jj);
#pragma unroll
          for (int c = 0; c < kNDC; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
        }
      }
    }
  }
  float div[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    div[r] = fmaxf(l[r], 1e-30f);
    if (lane == 0 && row0 + r < Sq)
      lse[(static_cast<int64_t>(b) * Sq + row0 + r) * H + h] = m[r] + logf(div[r]);
  }
  store_rows<kNDC>(o, acc, div, b, h, row0, Sq, H, D);
}

// ---------------------------------------------------------------- backward

template <int kNDC>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int Sq, int Sk, int H, int D, float scale,
                        int causal) {
  constexpr int kDP = 32 * kNDC;
  constexpr int kLD = kDP + 4;
  constexpr int kBK = other_tile(kNDC);
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                     // [32][kDP], pre-scaled
  float* dos = qs + kBlockRows * kDP;   // [32][kDP]
  float* ks = dos + kBlockRows * kDP;   // [kBK][kLD]
  float* vs = ks + kBK * kLD;           // [kBK][kLD]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = q0 + warp * kRows;
  load_tile<kDP>(qs, kDP, q, b, h, q0, kBlockRows, Sq, H, D, scale);
  load_tile<kDP>(dos, kDP, dout, b, h, q0, kBlockRows, Sq, H, D, 1.f);
  float lse_r[kRows], delta_r[kRows], acc[kRows][kNDC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = min(row0 + r, Sq - 1);  // rows past Sq are never stored
    lse_r[r] = lse[(static_cast<int64_t>(b) * Sq + s) * H + h];
    delta_r[r] = delta[(static_cast<int64_t>(b) * Sq + s) * H + h];
#pragma unroll
    for (int c = 0; c < kNDC; ++c) acc[r][c] = 0.f;
  }
  const float* my_q = qs + warp * kRows * kDP;
  const float* my_do = dos + warp * kRows * kDP;
  const int kv_end = causal ? min(Sk, q0 + kBlockRows) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();
    load_tile<kDP>(ks, kLD, k, b, h, k0, kBK, Sk, H, D, 1.f);
    load_tile<kDP>(vs, kLD, v, b, h, k0, kBK, Sk, H, D, 1.f);
    __syncthreads();
    for (int sub = 0; sub < kBK && k0 + sub < kv_end; sub += 32) {
      const int j = k0 + sub + lane;
      float s[kRows] = {}, dp[kRows] = {};
      dot4<kDP>(s, ks + (sub + lane) * kLD, my_q, kDP);
      dot4<kDP>(dp, vs + (sub + lane) * kLD, my_do, kDP);
      float ds[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool valid = j < Sk && (!causal || j <= row0 + r);
        ds[r] = valid ? expf(s[r] - lse_r[r]) * (dp[r] - delta_r[r]) : 0.f;
      }
#pragma unroll 4
      for (int jj = 0; jj < 32; ++jj) {
        const float* krow = ks + (sub + jj) * kLD + lane;
        float kv[kNDC];
#pragma unroll
        for (int c = 0; c < kNDC; ++c) kv[c] = krow[32 * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float dsj = __shfl_sync(kFull, ds[r], jj);
#pragma unroll
          for (int c = 0; c < kNDC; ++c) acc[r][c] = fmaf(dsj, kv[c], acc[r][c]);
        }
      }
    }
  }
  // dq = scale * dS K (the TPU kernel scales at the end too)
  float one[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    one[r] = 1.f;
#pragma unroll
    for (int c = 0; c < kNDC; ++c) acc[r][c] *= scale;
  }
  store_rows<kNDC>(dq, acc, one, b, h, row0, Sq, H, D);
}

template <int kNDC>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
                         int D, float scale, int causal) {
  constexpr int kDP = 32 * kNDC;
  constexpr int kLD = kDP + 4;
  constexpr int kBQ = other_tile(kNDC);
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                     // [32][kDP], this block's key rows
  float* vs = ks + kBlockRows * kDP;    // [32][kDP]
  float* qs = vs + kBlockRows * kDP;    // [kBQ][kLD], pre-scaled
  float* dos = qs + kBQ * kLD;          // [kBQ][kLD]
  float* lses = dos + kBQ * kLD;        // [kBQ]
  float* deltas = lses + kBQ;           // [kBQ]
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBlockRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key0 = k0 + warp * kRows;  // first key row of this warp
  load_tile<kDP>(ks, kDP, k, b, h, k0, kBlockRows, Sk, H, D, 1.f);
  load_tile<kDP>(vs, kDP, v, b, h, k0, kBlockRows, Sk, H, D, 1.f);
  float dk_acc[kRows][kNDC], dv_acc[kRows][kNDC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kNDC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  const float* my_k = ks + warp * kRows * kDP;
  const float* my_v = vs + warp * kRows * kDP;
  // query rows before this block's first key see none of its keys
  const int q_start = causal ? (k0 / kBQ) * kBQ : 0;
  for (int q0 = q_start; q0 < Sq; q0 += kBQ) {
    __syncthreads();
    load_tile<kDP>(qs, kLD, q, b, h, q0, kBQ, Sq, H, D, scale);
    load_tile<kDP>(dos, kLD, dout, b, h, q0, kBQ, Sq, H, D, 1.f);
    load_rows(lses, lse, b, h, q0, kBQ, Sq, H);
    load_rows(deltas, delta, b, h, q0, kBQ, Sq, H);
    __syncthreads();
    for (int sub = 0; sub < kBQ && q0 + sub < Sq; sub += 32) {
      const int i = q0 + sub + lane;
      float s[kRows] = {}, dp[kRows] = {};
      dot4<kDP>(s, qs + (sub + lane) * kLD, my_k, kDP);
      dot4<kDP>(dp, dos + (sub + lane) * kLD, my_v, kDP);
      const float lse_i = lses[sub + lane], delta_i = deltas[sub + lane];
      float p[kRows], ds[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool valid = i < Sq && key0 + r < Sk && (!causal || i >= key0 + r);
        p[r] = valid ? expf(s[r] - lse_i) : 0.f;
        ds[r] = p[r] * (dp[r] - delta_i);
      }
#pragma unroll 2
      for (int ii = 0; ii < 32; ++ii) {
        const float* qrow = qs + (sub + ii) * kLD + lane;
        const float* dorow = dos + (sub + ii) * kLD + lane;
        float qv[kNDC], dov[kNDC];
#pragma unroll
        for (int c = 0; c < kNDC; ++c) {
          qv[c] = qrow[32 * c];
          dov[c] = dorow[32 * c];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pi = __shfl_sync(kFull, p[r], ii);
          const float dsi = __shfl_sync(kFull, ds[r], ii);
#pragma unroll
          for (int c = 0; c < kNDC; ++c) {
            dv_acc[r][c] = fmaf(pi, dov[c], dv_acc[r][c]);
            // q entered pre-scaled, so this is already scale * dS^T Q
            dk_acc[r][c] = fmaf(dsi, qv[c], dk_acc[r][c]);
          }
        }
      }
    }
  }
  float one[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) one[r] = 1.f;
  store_rows<kNDC>(dk, dk_acc, one, b, h, key0, Sk, H, D);
  store_rows<kNDC>(dv, dv_acc, one, b, h, key0, Sk, H, D);
}

// ------------------------------------------------------------------ launch

enum class Kind { kFwd, kDq, kDkv };

template <int kNDC>
size_t smem_bytes(Kind kind) {
  constexpr size_t dp = 32 * kNDC, ld = dp + 4, t = other_tile(kNDC), rows = kBlockRows;
  switch (kind) {
    case Kind::kFwd: return sizeof(float) * (rows * dp + t * ld + t * dp);
    case Kind::kDq: return sizeof(float) * (2 * rows * dp + 2 * t * ld);
    default: return sizeof(float) * (2 * rows * dp + 2 * t * ld + 2 * t);
  }
}

// raise the kernel's dynamic shared-memory limit once (the first launch
// of each instance); later launches, such as those captured into a CUDA
// graph, set nothing here
template <typename Kernel>
int prepare(Kernel kernel, size_t smem, bool* ready) {
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024 && !*ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  *ready = true;
  return 0;
}

struct Args {
  const float *q, *k, *v, *dout, *lse_in, *delta;
  float *o, *lse, *dq, *dk, *dv;
  int B, Sq, Sk, H, D, causal;
  float scale;
  cudaStream_t stream;
};

template <int kNDC>
int launch(Kind kind, const Args& a) {
  const size_t smem = smem_bytes<kNDC>(kind);
  static bool ready[3] = {false, false, false};
  bool* r = &ready[static_cast<int>(kind)];
  int rc = 0;
  if (kind == Kind::kFwd) {
    rc = prepare(flash_fwd_kernel<kNDC>, smem, r);
    if (rc) return rc;
    const dim3 grid((a.Sq + kBlockRows - 1) / kBlockRows, a.H, a.B);
    flash_fwd_kernel<kNDC><<<grid, kThreads, smem, a.stream>>>(
        a.q, a.k, a.v, a.o, a.lse, a.Sq, a.Sk, a.H, a.D, a.scale, a.causal);
  } else if (kind == Kind::kDq) {
    rc = prepare(flash_bwd_dq_kernel<kNDC>, smem, r);
    if (rc) return rc;
    const dim3 grid((a.Sq + kBlockRows - 1) / kBlockRows, a.H, a.B);
    flash_bwd_dq_kernel<kNDC><<<grid, kThreads, smem, a.stream>>>(
        a.q, a.k, a.v, a.dout, a.lse_in, a.delta, a.dq, a.Sq, a.Sk, a.H, a.D, a.scale,
        a.causal);
  } else {
    rc = prepare(flash_bwd_dkv_kernel<kNDC>, smem, r);
    if (rc) return rc;
    const dim3 grid((a.Sk + kBlockRows - 1) / kBlockRows, a.H, a.B);
    flash_bwd_dkv_kernel<kNDC><<<grid, kThreads, smem, a.stream>>>(
        a.q, a.k, a.v, a.dout, a.lse_in, a.delta, a.dk, a.dv, a.Sq, a.Sk, a.H, a.D, a.scale,
        a.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(Kind kind, const Args& a) {
  if (a.B < 1 || a.Sq < 1 || a.Sk < 1 || a.H < 1 || a.D < 1 || a.D > 256 || a.B > 65535 ||
      a.H > 65535 || (a.causal && a.Sq != a.Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((a.D + 31) / 32) {
    case 1: return launch<1>(kind, a);
    case 2: return launch<2>(kind, a);
    case 3: return launch<3>(kind, a);
    case 4: return launch<4>(kind, a);
    case 5: return launch<5>(kind, a);
    case 6: return launch<6>(kind, a);
    case 7: return launch<7>(kind, a);
    default: return launch<8>(kind, a);
  }
}

}  // namespace

// Plain C interface, bound with ctypes (flexflow_tpu_torch/ops/kernels/_build.py).
// Every pointer is a device pointer to contiguous fp32 data: q, dout, o, dq
// [B,Sq,H,D]; k, v, dk, dv [B,Sk,H,D]; lse, delta [B,Sq,H]. stream is a
// cudaStream_t. Each returns the cudaError_t of its launch (0 on success).

extern "C" int ff_flash_fwd_f32(const float* q, const float* k, const float* v, float* o,
                                float* lse, int B, int Sq, int Sk, int H, int D, float scale,
                                int causal, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, lse, nullptr, nullptr, nullptr,
         B, Sq, Sk, H, D, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(Kind::kFwd, a);
}

extern "C" int ff_flash_bwd_dq_f32(const float* q, const float* k, const float* v,
                                   const float* dout, const float* lse, const float* delta,
                                   float* dq, int B, int Sq, int Sk, int H, int D, float scale,
                                   int causal, void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, nullptr, dq, nullptr, nullptr,
         B, Sq, Sk, H, D, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(Kind::kDq, a);
}

extern "C" int ff_flash_bwd_dkv_f32(const float* q, const float* k, const float* v,
                                    const float* dout, const float* lse, const float* delta,
                                    float* dk, float* dv, int B, int Sq, int Sk, int H, int D,
                                    float scale, int causal, void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, nullptr, nullptr, dk, dv,
         B, Sq, Sk, H, D, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(Kind::kDkv, a);
}
