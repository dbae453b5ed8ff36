// Flash attention forward and backward for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernels of
// flexflow_tpu/ops/kernels/flash_attention.py:
//   * _fwd_kernel      (launched by _flash_fwd, :158)  -> ff_flash_fwd_f32
//   * _bwd_dq_kernel   (launched by _flash_bwd, :262)  -> ff_flash_bwd_dq_f32
//   * _bwd_dkv_kernel  (launched by _flash_bwd, :278)  -> ff_flash_bwd_dkv_f32
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
// D <= 256 run. The backward keeps the FlashAttention-2 split of the TPU
// kernels: dQ gridded over query tiles, dK/dV over key tiles, each looping
// over the other axis, so no atomics are needed and gradients are the same
// from run to run. Causal blocks skip key tiles above the diagonal
// (forward, dQ) and query tiles below it (dK/dV).
//
// Bound on this card. At BERT's shapes (S = 128, D = 64) one call moves
// q, k, v, o (and dO, dq, dk, dv) once: 0.015 ms forward, 0.019 ms dQ
// and 0.023 ms dK/dV at 3.35 TB/s. fp32-accurate products on the tensor
// cores cost three TF32 products each (below), 3 * 4*S*S*D flops a head
// forward, 3 * 6*S*S*D for dQ and 3 * 8*S*S*D for dK/dV, 0.010, 0.015 and
// 0.020 ms at 495 TFLOP/s dense TF32; on the CUDA cores (67 TFLOP/s fp32)
// the same work takes 0.024, 0.036 and 0.048 ms.
//
// All three kernels, D <= 128: tensor cores (mma.sync m16n8k8 TF32).
//   * 3xTF32: every fp32 operand x is split into big = rna(x) and small =
//     rna(x - big), TF32 values rounded as cvt.rna.tf32.f32 rounds, and
//     each product is accumulated in fp32 as big*small + small*big +
//     big*big. One TF32 product keeps about 3 decimal digits; three keep
//     fp32's accuracy, so the kernels hold the same 1e-4 gate as before.
//   * A block of 4 warps owns 64 rows of its own axis (16 per warp) and
//     streams tiles of the other axis (32 keys for the forward and dQ, 16
//     queries for dK/dV) through shared memory with cp.async, two stages deep:
//     tile i+1 loads while tile i is computed, one barrier per tile. Rows
//     are padded to D + 4 floats, so every fragment load below hits 32
//     distinct banks. The tiles are small so that registers and shared
//     memory leave room for 4 blocks an SM (forward, D <= 64) or 3
//     (dK/dV): the kernels are held back by latency, not by the tensor
//     cores, and more warps hide more of it.
//   * Forward, Q-stationary: the block's Q rows stay in shared memory and
//     each warp re-reads and splits its A fragments per key tile (holding
//     them in registers took 64 more a thread and halved the blocks an SM
//     runs). S = (scale Q) K^T on the tensor cores, the online softmax on
//     the accumulator fragments (a row lives in one quad: two shfl_xor for
//     its max, the sum reduced once at the end), then O += P V as a second
//     mma chain.
//   * P goes from the accumulator layout to the A-operand layout with
//     neither shuffles nor a scratch tile: inside each 8-key step the
//     reduction order is permuted (A column t <-> key 2t, column t+4 <->
//     key 2t+1), which makes each thread's accumulator values exactly its
//     A fragment; the B fragment reads V rows 2t and 2t+1 to match.
//   * dK/dV, KV-stationary: the warp's 16 K and V rows stay in shared
//     memory and are split as they are read (the two 16 x D gradient
//     accumulators already take 64 registers a thread at D = 64); per
//     query tile (q, dO, lse, delta staged by cp.async) it forms
//     S^T = K Q^T, P^T = exp(scale S^T - lse), dP^T = V dO^T and
//     dS^T = P^T o (dP^T - delta), and accumulates dV += P^T dO and
//     dK += dS^T Q with the same permutation, all in fp32 registers.
//   * dQ, Q-stationary like the forward: the block's Q and dO rows, lse
//     and delta stay in shared memory while K and V tiles stream through.
//     Per key tile each warp forms S = (scale Q) K^T and dP = dO V^T as
//     two mma chains, dS = P o (dP - delta) with P = exp(S - lse) on the
//     accumulator fragments, and dQ += dS K with dS reused as the A
//     operand through the same permutation; dQ is scaled once, at the
//     store. It does 6 products of 16 x 8 x 8 per key and head-dim step
//     against the forward's 4 (its softmax is a subtraction, not a
//     running max), and holds 16 x D accumulators plus S and dP (32 + 16
//     + 16 registers a thread at D = 64): like the others it is bound by
//     latency, and registers and shared memory (about 69 KB a block:
//     Q, dO and two stages of K and V) allow 3 blocks an SM.
//   * Head dims are zero-padded to 32, 64, 96 or 128 in shared memory.
//     Rows are copied 16 bytes at a time where D % 4 == 0 and the tensors
//     are 16-byte aligned, else 4 bytes at a time.
//   * What bounds them now: each warp splits every operand it reads (four
//     integer or float instructions an element) and the mma.sync chain
//     runs at about a third of the card's mma.sync TF32 rate, latency
//     bound; wgmma with pre-split operands in shared memory is the next
//     step.
//
// D > 128: CUDA cores (16 x D accumulators would not fit beside the
// tiles). One block of 8 warps owns 32 rows and loops over tiles of the
// other axis staged through shared memory; lane t dots row t of a 32-row sub-tile
// with each of the warp's 4 rows and the probabilities (or dS) reach the
// accumulating lanes by shuffles. It is bound by shared-memory traffic
// (one shared load per two multiply-adds) and by the shuffles.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

__device__ __forceinline__ int64_t row_offset(int b, int s, int S, int h, int H, int D) {
  return ((static_cast<int64_t>(b) * S + s) * H + h) * D;
}

// ============================================================ tensor cores

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;  // rows of the block's own axis

// rows of the other axis per staged tile: keys of the forward and dQ,
// queries of dK/dV
constexpr int kFwdKeyTile = 32;
constexpr int kDqKeyTile = 32;
constexpr int kDkvQueryTile = 16;

// rows [r0, r0 + kR) of head (b, h) of a [B,S,H,D] tensor into shared
// memory at leading dimension kLD; zeros past S and past D
template <int kR, int kDP, int kLD>
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ src, int b, int h,
                                           int r0, int S, int H, int D, bool vec) {
  const float* head = src + row_offset(b, 0, S, h, H, D);
  const int64_t stride = static_cast<int64_t>(H) * D;  // between rows of one head
  if (vec) {
    constexpr int kChunks = kDP / 4;
    static_assert(kR * kChunks % kTcThreads == 0, "whole rounds of 16-byte copies");
#pragma unroll
    for (int j = 0; j < kR * kChunks / kTcThreads; ++j) {
      const int i = threadIdx.x + j * kTcThreads;
      const int r = i / kChunks, c = (i % kChunks) * 4, s = r0 + r;
      const bool ok = s < S && c < D;
      cp_async16(dst + r * kLD + c, ok ? head + s * stride + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kR * kDP; i += kTcThreads) {
      const int r = i / kDP, c = i % kDP, s = r0 + r;
      const bool ok = s < S && c < D;
      cp_async4(dst + r * kLD + c, ok ? head + s * stride + c : src, ok);
    }
  }
}

// per-row scalars (lse or delta, [B,S,H]) of rows [r0, r0 + kR)
template <int kR>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int b, int h,
                                           int r0, int S, int H) {
  for (int i = threadIdx.x; i < kR; i += kTcThreads) {
    const int s = r0 + i;
    const bool ok = s < S;
    cp_async4(dst + i, ok ? src + (static_cast<int64_t>(b) * S + s) * H + h : src, ok);
  }
}

// x = big + small + O(2^-22 |x|), both TF32 values. Both round as
// cvt.rna.tf32.f32 does (to nearest, ties away from zero: add half a TF32
// unit, drop the low 13 bits), written as integer operations, which give
// the same bits for every finite x in half the instructions of ptxas's
// guarded expansion of cvt. small keeps its low 13 bits: the mma drops
// them as it reads a TF32 operand.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// operand fragments of mma.m16n8k8 (g = lane / 4, t = lane % 4), split
struct FragA {  // 16 x 8: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
  uint32_t big[4], small[4];
};
struct FragB {  // 8 x 8: b0 (k t, n g), b1 (k t+4, n g)
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b to fp32 accuracy: big*small + small*big + big*big, in that order
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.big);
}

// A fragment of the 16 x 8 tile at p (row major, leading dimension ld), times mul
__device__ __forceinline__ void load_a(FragA& f, const float* p, int ld, float mul) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  split_tf32(p[g * ld + t] * mul, f.big[0], f.small[0]);
  split_tf32(p[(g + 8) * ld + t] * mul, f.big[1], f.small[1]);
  split_tf32(p[g * ld + t + 4] * mul, f.big[2], f.small[2]);
  split_tf32(p[(g + 8) * ld + t + 4] * mul, f.big[3], f.small[3]);
}

// B fragment whose element (k, n) is p[n * ld + k] (a K^T tile: rows of p
// are the product's columns)
__device__ __forceinline__ void load_b_nk(FragB& f, const float* p, int ld) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  split_tf32(p[g * ld + t], f.big[0], f.small[0]);
  split_tf32(p[g * ld + t + 4], f.big[1], f.small[1]);
}

// The permuted reduction order of an accumulator reused as an A operand:
// A column t is accumulator column 2t, A column t+4 is column 2t+1. These
// two read the matching operands: the A fragment from an accumulator
// fragment, and the B fragment whose element (k, n) is p[k * ld + n] with
// rows 2t and 2t+1 in place of t and t+4.
__device__ __forceinline__ void acc_to_a(FragA& f, const float (&c)[4]) {
  split_tf32(c[0], f.big[0], f.small[0]);
  split_tf32(c[2], f.big[1], f.small[1]);
  split_tf32(c[1], f.big[2], f.small[2]);
  split_tf32(c[3], f.big[3], f.small[3]);
}

__device__ __forceinline__ void load_b_kn_permuted(FragB& f, const float* p, int ld) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  split_tf32(p[2 * t * ld + g], f.big[0], f.small[0]);
  split_tf32(p[(2 * t + 1) * ld + g], f.big[1], f.small[1]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// rows r and r + 8 of a [16, kDP] accumulator (each thread's columns
// 8n + 2t and 8n + 2t + 1) to rows row0 (+ 8) of head (b, h), times mul
template <int kNT>
__device__ __forceinline__ void store_acc(float* __restrict__ dst, const float (&acc)[kNT][4],
                                          const float (&mul)[2], int b, int h, int row0, int S,
                                          int H, int D, bool vec) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = row0 + 8 * half;
    if (s >= S) continue;
    float* row = dst + row_offset(b, s, S, h, H, D);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int d = 8 * n + 2 * t;
      const float x0 = acc[n][2 * half] * mul[half], x1 = acc[n][2 * half + 1] * mul[half];
      if (vec) {
        if (d < D) *reinterpret_cast<float2*>(row + d) = make_float2(x0, x1);
      } else {
        if (d < D) row[d] = x0;
        if (d + 1 < D) row[d + 1] = x1;
      }
    }
  }
}

// ------------------------------------------------- forward, tensor cores

template <int kDP>
size_t fwd_tc_smem() {
  // two stages of K and V, then Q
  return sizeof(float) * (kDP + 4) * (4 * kFwdKeyTile + kTcRows);
}

// D <= 64: at most 128 registers a thread, so four blocks share an SM
template <int kDP>
__global__ void __launch_bounds__(kTcThreads, kDP <= 64 ? 4 : 1)
    flash_fwd_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int Sq, int Sk, int H, int D, float scale,
                        int causal, int vec) {
  constexpr int kLD = kDP + 4;
  constexpr int kNT = kDP / 8;  // 8-wide steps of the head dim
  constexpr int kBK = kFwdKeyTile;
  constexpr int kKT = kBK / 8;  // 8-key steps of a tile
  static_assert(kKT * 4 <= 32, "one mask bit per accumulator element");
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = 2 * kBK * kLD;  // a stage: kBK rows of K, then kBK rows of V
  float* qs = smem + 2 * kStage;         // [kTcRows][kLD]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's query rows: row0, row0 + 8
  const int kv_end = causal ? min(Sk, q0 + kTcRows) : Sk;
  const int ntiles = (kv_end + kBK - 1) / kBK;

  stage_tile<kTcRows, kDP, kLD>(qs, q, b, h, q0, Sq, H, D, vec);
  stage_tile<kBK, kDP, kLD>(smem, k, b, h, 0, Sk, H, D, vec);
  stage_tile<kBK, kDP, kLD>(smem + kBK * kLD, v, b, h, 0, Sk, H, D, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const float* my_q = qs + warp * 16 * kLD;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBK;
    if (it + 1 < ntiles) {  // the next tile loads while this one is computed
      float* next = smem + ((it + 1) & 1) * kStage;
      stage_tile<kBK, kDP, kLD>(next, k, b, h, k0 + kBK, Sk, H, D, vec);
      stage_tile<kBK, kDP, kLD>(next + kBK * kLD, v, b, h, k0 + kBK, Sk, H, D, vec);
      cp_async_commit();
    }
    const float* kt = smem + (it & 1) * kStage;
    const float* vt = kt + kBK * kLD;

    // S = (scale Q) K^T, 16 x kBK per warp
    float s[kKT][4];
#pragma unroll
    for (int n = 0; n < kKT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int d8 = 0; d8 < kNT; ++d8) {
      FragA a;
      load_a(a, my_q + 8 * d8, kLD, scale);
#pragma unroll
      for (int n = 0; n < kKT; ++n) {
        FragB bf;
        load_b_nk(bf, kt + n * 8 * kLD + 8 * d8, kLD);
        mma_3xtf32(s[n], a, bf);
      }
    }

    // online softmax on the fragments; element e of s[n] is row
    // row0 + 8 * (e / 2), key k0 + 8n + 2t + e % 2
    uint32_t valid = 0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * t + (e & 1);
        if (key < Sk && (!causal || key <= row0 + 8 * (e >> 1))) {
          valid |= 1u << (4 * n + e);
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
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
        const float p = (valid >> (4 * n + e)) & 1u ? expf(s[n][e] - m[e >> 1]) : 0.f;
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // O += P V, the keys of each 8-key step in the permuted order
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      FragA a;
      acc_to_a(a, s[j]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        FragB bf;
        load_b_kn_permuted(bf, vt + 8 * j * kLD + 8 * n, kLD);
        mma_3xtf32(acc[n], a, bf);
      }
    }
    cp_async_wait_all();  // the next tile has landed
    __syncthreads();      // and every warp is done with this one
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float div = fmaxf(quad_sum(l[i]), 1e-30f);
    inv[i] = 1.f / div;
    const int s = row0 + 8 * i;
    if (t == 0 && s < Sq) lse[(static_cast<int64_t>(b) * Sq + s) * H + h] = m[i] + logf(div);
  }
  store_acc<kNT>(o, acc, inv, b, h, row0, Sq, H, D, vec);
}

// --------------------------------------------------- dK/dV, tensor cores

template <int kDP>
size_t dkv_tc_smem() {
  constexpr size_t ld = kDP + 4, bq = kDkvQueryTile;
  // K and V of the block; q and dO, two stages each; lse and delta, two stages each
  return sizeof(float) * (ld * (2 * kTcRows + 4 * bq) + 4 * bq);
}

template <int kDP>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dkv_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
                            int D, float scale, int causal, int vec) {
  constexpr int kLD = kDP + 4;
  constexpr int kNT = kDP / 8;
  constexpr int kBQ = kDkvQueryTile;
  constexpr int kQT = kBQ / 8;  // 8-query steps of a tile
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // [kTcRows][kLD]
  float* vs = ks + kTcRows * kLD;      // [kTcRows][kLD]
  float* qs = vs + kTcRows * kLD;      // [2][kBQ][kLD]
  float* dos = qs + 2 * kBQ * kLD;     // [2][kBQ][kLD]
  float* lses = dos + 2 * kBQ * kLD;   // [2][kBQ]
  float* deltas = lses + 2 * kBQ;      // [2][kBQ]
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this thread's key rows: key0, key0 + 8
  // query rows before this block's first key see none of its keys
  const int q_start = causal ? (k0 / kBQ) * kBQ : 0;
  const int ntiles = (Sq - q_start + kBQ - 1) / kBQ;

  auto stage_queries = [&](int q0, int buf) {
    stage_tile<kBQ, kDP, kLD>(qs + buf * kBQ * kLD, q, b, h, q0, Sq, H, D, vec);
    stage_tile<kBQ, kDP, kLD>(dos + buf * kBQ * kLD, dout, b, h, q0, Sq, H, D, vec);
    stage_rows<kBQ>(lses + buf * kBQ, lse, b, h, q0, Sq, H);
    stage_rows<kBQ>(deltas + buf * kBQ, delta, b, h, q0, Sq, H);
  };
  stage_tile<kTcRows, kDP, kLD>(ks, k, b, h, k0, Sk, H, D, vec);
  stage_tile<kTcRows, kDP, kLD>(vs, v, b, h, k0, Sk, H, D, vec);
  stage_queries(q_start, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const float* my_k = ks + warp * 16 * kLD;
  const float* my_v = vs + warp * 16 * kLD;
  float dk_acc[kNT][4], dv_acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int q0 = q_start + it * kBQ;
    if (it + 1 < ntiles) {
      stage_queries(q0 + kBQ, (it + 1) & 1);
      cp_async_commit();
    }
    const int buf = it & 1;
    const float* qt = qs + buf * kBQ * kLD;
    const float* dot = dos + buf * kBQ * kLD;
    const float* lt = lses + buf * kBQ;
    const float* det = deltas + buf * kBQ;

    // S^T = K Q^T and dP^T = V dO^T, 16 x kBQ per warp
    float st[kQT][4], dpt[kQT][4];
#pragma unroll
    for (int n = 0; n < kQT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int d8 = 0; d8 < kNT; ++d8) {
      FragA ka, va;
      load_a(ka, my_k + 8 * d8, kLD, 1.f);
      load_a(va, my_v + 8 * d8, kLD, 1.f);
#pragma unroll
      for (int n = 0; n < kQT; ++n) {
        FragB bq, bd;
        load_b_nk(bq, qt + n * 8 * kLD + 8 * d8, kLD);
        load_b_nk(bd, dot + n * 8 * kLD + 8 * d8, kLD);
        mma_3xtf32(st[n], ka, bq);
        mma_3xtf32(dpt[n], va, bd);
      }
    }

    // P^T = exp(scale S^T - lse) and dS^T = P^T o (dP^T - delta); element
    // e of st[n] is key key0 + 8 * (e / 2), query q0 + 8n + 2t + e % 2
#pragma unroll
    for (int n = 0; n < kQT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * n + 2 * t + (e & 1), qi = q0 + ql, key = key0 + 8 * (e >> 1);
        const bool ok = qi < Sq && key < Sk && (!causal || qi >= key);
        const float p = ok ? expf(st[n][e] * scale - lt[ql]) : 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - det[ql]);
      }

    // dV += P^T dO and dK += dS^T Q (scaled at the end), the queries of
    // each 8-query step in the permuted order
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
      FragA pa, da;
      acc_to_a(pa, st[j]);
      acc_to_a(da, dpt[j]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        FragB bd, bq;
        load_b_kn_permuted(bd, dot + 8 * j * kLD + 8 * n, kLD);
        load_b_kn_permuted(bq, qt + 8 * j * kLD + 8 * n, kLD);
        mma_3xtf32(dv_acc[n], pa, bd);
        mma_3xtf32(dk_acc[n], da, bq);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
  const float dk_mul[2] = {scale, scale}, dv_mul[2] = {1.f, 1.f};
  store_acc<kNT>(dk, dk_acc, dk_mul, b, h, key0, Sk, H, D, vec);
  store_acc<kNT>(dv, dv_acc, dv_mul, b, h, key0, Sk, H, D, vec);
}

// ------------------------------------------------------ dQ, tensor cores

template <int kDP>
size_t dq_tc_smem() {
  // two stages of K and V; Q and dO of the block; lse and delta
  return sizeof(float) * ((kDP + 4) * (4 * kDqKeyTile + 2 * kTcRows) + 2 * kTcRows);
}

// blocks an SM the register budget is set for: shared memory allows 3
// with 32-key tiles at D <= 64, 4 with 16-key tiles
__host__ __device__ constexpr int dq_min_blocks(int dp) {
  return dp > 64 ? 1 : kDqKeyTile == 16 ? 4 : 3;
}

template <int kDP>
__global__ void __launch_bounds__(kTcThreads, dq_min_blocks(kDP))
    flash_bwd_dq_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dq, int Sq, int Sk, int H, int D, float scale,
                           int causal, int vec) {
  constexpr int kLD = kDP + 4;
  constexpr int kNT = kDP / 8;
  constexpr int kBK = kDqKeyTile;
  constexpr int kKT = kBK / 8;
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = 2 * kBK * kLD;  // a stage: kBK rows of K, then kBK rows of V
  float* qs = smem + 2 * kStage;         // [kTcRows][kLD]
  float* dos = qs + kTcRows * kLD;       // [kTcRows][kLD]
  float* lses = dos + kTcRows * kLD;     // [kTcRows]
  float* deltas = lses + kTcRows;        // [kTcRows]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's query rows: row0, row0 + 8
  const int kv_end = causal ? min(Sk, q0 + kTcRows) : Sk;
  const int ntiles = (kv_end + kBK - 1) / kBK;

  // rows past Sq stage as zeros (lse and delta too), so their dS is 0
  stage_tile<kTcRows, kDP, kLD>(qs, q, b, h, q0, Sq, H, D, vec);
  stage_tile<kTcRows, kDP, kLD>(dos, dout, b, h, q0, Sq, H, D, vec);
  stage_rows<kTcRows>(lses, lse, b, h, q0, Sq, H);
  stage_rows<kTcRows>(deltas, delta, b, h, q0, Sq, H);
  stage_tile<kBK, kDP, kLD>(smem, k, b, h, 0, Sk, H, D, vec);
  stage_tile<kBK, kDP, kLD>(smem + kBK * kLD, v, b, h, 0, Sk, H, D, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const float* my_q = qs + warp * 16 * kLD;
  const float* my_do = dos + warp * 16 * kLD;
  const float lse_r[2] = {lses[warp * 16 + g], lses[warp * 16 + g + 8]};
  const float delta_r[2] = {deltas[warp * 16 + g], deltas[warp * 16 + g + 8]};
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBK;
    if (it + 1 < ntiles) {  // the next tile loads while this one is computed
      float* next = smem + ((it + 1) & 1) * kStage;
      stage_tile<kBK, kDP, kLD>(next, k, b, h, k0 + kBK, Sk, H, D, vec);
      stage_tile<kBK, kDP, kLD>(next + kBK * kLD, v, b, h, k0 + kBK, Sk, H, D, vec);
      cp_async_commit();
    }
    const float* kt = smem + (it & 1) * kStage;
    const float* vt = kt + kBK * kLD;

    // S = (scale Q) K^T and dP = dO V^T, 16 x kBK per warp
    float s[kKT][4], dp[kKT][4];
#pragma unroll
    for (int n = 0; n < kKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int d8 = 0; d8 < kNT; ++d8) {
      FragA qa, da;
      load_a(qa, my_q + 8 * d8, kLD, scale);
      load_a(da, my_do + 8 * d8, kLD, 1.f);
#pragma unroll
      for (int n = 0; n < kKT; ++n) {
        FragB bk, bv;
        load_b_nk(bk, kt + n * 8 * kLD + 8 * d8, kLD);
        load_b_nk(bv, vt + n * 8 * kLD + 8 * d8, kLD);
        mma_3xtf32(s[n], qa, bk);
        mma_3xtf32(dp[n], da, bv);
      }
    }

    // dS = P o (dP - delta), P = exp(S - lse), masked as the forward
    // masks; element e of s[n] is row row0 + 8 * (e / 2), key
    // k0 + 8n + 2t + e % 2
#pragma unroll
    for (int n = 0; n < kKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * t + (e & 1);
        const bool ok = key < Sk && (!causal || key <= row0 + 8 * (e >> 1));
        s[n][e] = ok ? expf(s[n][e] - lse_r[e >> 1]) * (dp[n][e] - delta_r[e >> 1]) : 0.f;
      }

    // dQ += dS K, the keys of each 8-key step in the permuted order
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      FragA a;
      acc_to_a(a, s[j]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        FragB bf;
        load_b_kn_permuted(bf, kt + 8 * j * kLD + 8 * n, kLD);
        mma_3xtf32(acc[n], a, bf);
      }
    }
    cp_async_wait_all();  // the next tile has landed
    __syncthreads();      // and every warp is done with this one
  }
  // dQ = scale * dS K (the TPU kernel scales at the end too)
  const float mul[2] = {scale, scale};
  store_acc<kNT>(dq, acc, mul, b, h, row0, Sq, H, D, vec);
}

// ============================================================== CUDA cores

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;                    // rows per warp
constexpr int kBlockRows = kWarps * kRows;  // 32 rows per block tile

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

constexpr int kOtherTile = 32;  // rows of the other axis per staged tile

template <int kNDC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int D, float scale,
                     int causal) {
  constexpr int kDP = 32 * kNDC;
  constexpr int kLD = kDP + 4;
  constexpr int kBK = kOtherTile;
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

template <int kNDC>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int Sq, int Sk, int H, int D, float scale,
                        int causal) {
  constexpr int kDP = 32 * kNDC;
  constexpr int kLD = kDP + 4;
  constexpr int kBK = kOtherTile;
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
  constexpr int kBQ = kOtherTile;
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

// ================================================================== launch

enum class Kind { kFwd, kDq, kDkv };

template <int kNDC>
size_t smem_bytes(Kind kind) {
  constexpr size_t dp = 32 * kNDC, ld = dp + 4, t = kOtherTile, rows = kBlockRows;
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// 16-byte copies and paired stores need D % 4 == 0 and 16-byte aligned
// rows in every tensor the kernel copies or stores
bool vector_rows(const Args& a, Kind kind) {
  if (a.D % 4 != 0 || !aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v)) return false;
  switch (kind) {
    case Kind::kFwd: return aligned16(a.o);
    case Kind::kDq: return aligned16(a.dout) && aligned16(a.dq);
    default: return aligned16(a.dout) && aligned16(a.dk) && aligned16(a.dv);
  }
}

template <int kDP>
int launch_tc(Kind kind, const Args& a) {
  static bool ready[3] = {false, false, false};
  const int vec = vector_rows(a, kind) ? 1 : 0;
  int rc = 0;
  if (kind == Kind::kFwd) {
    const size_t smem = fwd_tc_smem<kDP>();
    rc = prepare(flash_fwd_tc_kernel<kDP>, smem, &ready[0]);
    if (rc) return rc;
    const dim3 grid((a.Sq + kTcRows - 1) / kTcRows, a.H, a.B);
    flash_fwd_tc_kernel<kDP><<<grid, kTcThreads, smem, a.stream>>>(
        a.q, a.k, a.v, a.o, a.lse, a.Sq, a.Sk, a.H, a.D, a.scale, a.causal, vec);
  } else if (kind == Kind::kDq) {
    const size_t smem = dq_tc_smem<kDP>();
    rc = prepare(flash_bwd_dq_tc_kernel<kDP>, smem, &ready[1]);
    if (rc) return rc;
    const dim3 grid((a.Sq + kTcRows - 1) / kTcRows, a.H, a.B);
    flash_bwd_dq_tc_kernel<kDP><<<grid, kTcThreads, smem, a.stream>>>(
        a.q, a.k, a.v, a.dout, a.lse_in, a.delta, a.dq, a.Sq, a.Sk, a.H, a.D, a.scale,
        a.causal, vec);
  } else {
    const size_t smem = dkv_tc_smem<kDP>();
    rc = prepare(flash_bwd_dkv_tc_kernel<kDP>, smem, &ready[2]);
    if (rc) return rc;
    const dim3 grid((a.Sk + kTcRows - 1) / kTcRows, a.H, a.B);
    flash_bwd_dkv_tc_kernel<kDP><<<grid, kTcThreads, smem, a.stream>>>(
        a.q, a.k, a.v, a.dout, a.lse_in, a.delta, a.dk, a.dv, a.Sq, a.Sk, a.H, a.D, a.scale,
        a.causal, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// the CUDA-core kernels, D > 128 (kNDC = 5..8 columns of 32)
template <int kNDC>
int launch_simt(Kind kind, const Args& a) {
  static_assert(kNDC > 4, "D <= 128 takes the tensor cores");
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
  if (a.D <= 32) return launch_tc<32>(kind, a);
  if (a.D <= 64) return launch_tc<64>(kind, a);
  if (a.D <= 96) return launch_tc<96>(kind, a);
  if (a.D <= 128) return launch_tc<128>(kind, a);
  switch ((a.D + 31) / 32) {
    case 5: return launch_simt<5>(kind, a);
    case 6: return launch_simt<6>(kind, a);
    case 7: return launch_simt<7>(kind, a);
    default: return launch_simt<8>(kind, a);
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
