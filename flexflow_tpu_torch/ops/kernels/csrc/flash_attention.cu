// Flash attention forward and backward for Hopper (sm_90a), fp32, bf16 and
// fp16.
//
// Replaces the Pallas TPU kernels of
// flexflow_tpu/ops/kernels/flash_attention.py:
//   * _fwd_kernel      (launched by _flash_fwd, :158)  -> ff_flash_fwd_{f32,bf16,f16}
//   * _bwd_dq_kernel   (launched by _flash_bwd, :262)  -> ff_flash_bwd_dq_{f32,bf16,f16}
//   * _bwd_dkv_kernel  (launched by _flash_bwd, :278)  -> ff_flash_bwd_dkv_{f32,bf16,f16}
// Like the Pallas kernels, each reads its inputs in any of the three
// types, computes in fp32 and writes o, dq, dk, dv in the inputs' type;
// lse and delta are fp32 in every form. The bf16 and fp16 forms are one
// templated body each (the element's traits: common.cuh's Elem).
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
// D <= 512 run. The backward keeps the FlashAttention-2 split of the TPU
// kernels: dQ gridded over query tiles, dK/dV over key tiles, each looping
// over the other axis, so no atomics are needed and gradients are the same
// from run to run. Causal blocks skip key tiles above the diagonal
// (forward, dQ) and query tiles below it (dK/dV).
//
// Bound on this card. At BERT's shapes (S = 128, D = 64) one call moves
// q, k, v, o (and dO, dq, dk, dv) once: 0.015 ms forward, 0.019 ms dQ
// and 0.023 ms dK/dV at 3.35 TB/s in fp32, half that in bf16. fp32-accurate
// products on the tensor cores cost three TF32 products each (below),
// 3 * 4*S*S*D flops a head forward, 3 * 6*S*S*D for dQ and 3 * 8*S*S*D for
// dK/dV, 0.010, 0.015 and 0.020 ms at 495 TFLOP/s dense TF32; on the CUDA
// cores (67 TFLOP/s fp32) the same work takes 0.024, 0.036 and 0.048 ms.
// The bf16 and fp16 forms' flops at 989 TFLOP/s dense take a third of a
// TF32 product's time: every 2-byte call is bound by its bytes.
//
// Each kernel has up to three bodies; body_of() picks one per call and
// ff_flash_body() reports it, so a caller can count launches by body:
//   * wgmma (bf16 and fp16 forward, dQ and dK/dV, 32 < D <= 128,
//     D % 8 == 0, every tensor 16-byte aligned): warpgroup products fed by
//     TMA, below;
//   * mma.sync (every other call at D <= 128): TF32 m16n8k8 products, 3 a
//     product in fp32, 1 or 2 in bf16 and fp16, staged by cp.async;
//   * CUDA cores (D > 128).
//
// ---- The wgmma bodies (flash_fwd_wg_kernel, flash_bwd_dq_wg_kernel,
//      flash_bwd_dkv_wg_kernel), bf16 and fp16: the same body, T the
//      element; described in bf16, with fp16's one difference at the end
//   * A block is one warpgroup (4 warps) owning 64 rows of its own axis
//     (queries for the forward and dQ, keys for dK/dV), the M of every
//     wgmma m64n64k16. Its own rows' tiles (Q; Q and dO; K and V) land
//     once, by TMA on one barrier. The other axis streams through a ring
//     of kWgStages shared-memory stages (K and V tiles of 64 keys for the
//     forward and dQ; Q and dO tiles of 64 queries with their lse and
//     delta rows for dK/dV), filled by TMA. Thread 0 (warp 0 for dK/dV)
//     is the producer: before each tile it refills the stage the previous
//     tile freed, announcing the bytes on the stage's full mbarrier and
//     issuing the copies; each warp arrives on the stage's empty mbarrier
//     once its products are done, and the producer waits on that before
//     refilling (phase parity from the stage's use count). lse and delta
//     are columns of [B,S,H] tensors, no TMA box: for dK/dV the producer
//     warp's lanes copy them by 4-byte cp.async and arrive on the full
//     barrier once they land (cp.async.mbarrier.arrive), so no thread
//     waits on those loads; dQ needs only its own 64 rows', which land
//     once, by one cp.async a consumer thread, on the barrier of Q and dO.
//   * TMA reads q, k, v, dO in place through 4-D tensor maps (D, H, S, B,
//     innermost first) encoded on the host per call, passed as
//     __grid_constant__ parameters; cuTensorMapEncodeTiled comes from
//     libcuda through cudaGetDriverEntryPoint (the library does not link
//     libcuda). A box is 64 columns (128 bytes) by the tile's rows of one
//     head, written with the 128-byte swizzle; rows past S and columns past
//     D land as zeros, so a ragged S and D padded to 64 or 128 need no
//     masking of the copies.
//   * Products. bf16 x bf16 products are exact in the fp32 accumulator, so
//     a product of two inputs is one wgmma with both operands K-major in
//     shared memory: the forward's S = Q K^T, dQ's S = Q K^T and dP =
//     dO V^T, dK/dV's S^T = K Q^T and dP^T = V dO^T. A product with a
//     computed fp32 operand (P, dS, P^T, dS^T) splits it into hi =
//     bf16(x) and lo = bf16(x - hi) (x = hi + lo + e, |e| <= 2^-16 |x|)
//     and takes two wgmmas, lo then hi, with the operand in registers: the
//     forward's O += P V, dQ's dQ += dS K, dK/dV's dV += P^T dO and dK +=
//     dS^T Q. The accumulator of S (or S^T) is, 16 columns at a time,
//     exactly the register A fragment of the next product, so P and dS
//     reach it without shuffles. V, K, dO and Q are read MN-major (the
//     reduction down their rows) by a second descriptor of the tile that
//     the K-major products read: one copy, no transposes. A single bf16
//     product of P or dS would err by up to 2^-8 a term: SDPA's function,
//     not the JAX kernels' (tests/test_torch_port_flash_split_numerics.py).
//   * The scale multiplies the fp32 scores (q * scale is not a bf16
//     value), and dQ and dK at their stores. The softmax runs in base 2
//     on the scores times scale log2(e), by ex2.approx (about 2 ulp: the
//     fp32 gates do not see it; the accurate exp2f costs the forward 5%).
//     Tiles inside every bound skip the mask. The causal skips are the
//     mma.sync bodies': the forward and dQ stop at the diagonal key tile,
//     dK/dV starts at the first query tile that sees its keys. No atomics:
//     dQ and dK/dV keep the split of the TPU kernels.
//   * The 64 x 64 accumulator blocks are stored as bf16 pairs straight
//     from registers; the forward writes lse from the quad's first lane.
//   * Occupancy: registers are shared out by an SM's four quarters, whole
//     warps each, so a fifth (producer) warp cost dK/dV half its blocks an
//     SM; with thread 0 producing, the forward holds 4 blocks an SM, dQ 4
//     (S, dP and dQ accumulators and dS's halves in 128 registers; 3
//     blocks were 6-8% slower) and dK/dV 3 (capped at 168 registers) at
//     D <= 64. Two warpgroups a block (kWgGroups, copying each tile once
//     for 128 rows) were slower at BERT's S = 128, and so were 3-stage
//     rings and 128-key dQ tiles (which spill).
//   * What bounds them (H100 at BERT's training shape, tools/flash_probe.py
//     parts): the forward's copies alone take 85% of its time and its
//     products alone 80% (the two overlap); dK/dV's copies 80% and its
//     products 82%; dQ's copies 85% and its products 71% (at causal
//     S = 512, where a block walks up to 8 key tiles, its products take
//     88%). TMA over [B,S,H,D] in place reads 128-byte rows 1.5 KB apart,
//     and each block waits out its first tiles' latency: the kernels sit
//     at about 2x their byte bound at S = 128.
//   * fp16. A 64-element fp16 row is 128 bytes as a bf16 row is, so the
//     tiles, swizzle and descriptors are the same; the tensor maps say
//     FLOAT16 and the wgmma .f16. fp16's exact range is narrower: the
//     split of a computed operand into fp16 halves keeps x to 2^-22 |x|
//     only for 2^-14 <= |x| <= 65504 (common.cuh's split_x2). P in [0, 1]
//     is split as it is (below 2^-14 its halves are subnormal, an
//     absolute 2^-25 a term, inside the gate: most P of a row with one
//     dominant key). dS can leave the range at both ends (|dS| past 65504;
//     training's gradients, of order 1e-6), so dQ and dK/dV scale each
//     row of dS (dS^T) by a power of two before the split, the running
//     least exponent that puts the row's largest |dS| in [2^14, 2^15],
//     rescale the accumulator row when it falls and undo it at the store
//     (scale_rows, unscale_rows): exact in fp32.
//
// ---- The mma.sync bodies, D <= 128 (all three kernels)
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
//     store. It holds 16 x D accumulators plus S and dP (32 + 16 + 16
//     registers a thread at D = 64) and about 69 KB of shared memory a
//     block (Q, dO and two stages of K and V): 3 blocks an SM.
//   * Head dims are zero-padded to 32, 64, 96 or 128 in shared memory.
//     Rows are copied 16 bytes at a time where D % 4 == 0 and the tensors
//     are 16-byte aligned, else 4 bytes at a time.
//   * The bf16 and fp16 forms of these bodies (the 2-byte calls the wgmma
//     bodies do not take) run over tiles of their type: a bf16 or fp16
//     value is a TF32 value exactly, so a product of two inputs is one TF32
//     mma and one with P or dS two (small*big + big*big).
//   * What bounds them: each warp splits every fp32 operand it reads and
//     the mma.sync chain runs at about a third of the card's mma.sync TF32
//     rate, latency bound.
//
// ---- D > 128: CUDA cores (16 x D accumulators would not fit beside the
// tiles). One block of 8 warps owns 32 rows (16 past D = 256, where 32
// would not fit in shared memory) and loops over tiles of the other axis
// staged through shared memory, in fp32 for both types; lane t dots row t
// of a 32-row sub-tile with each of the warp's 4 (2) rows and the
// probabilities (or dS) reach the accumulating lanes by shuffles. It is
// bound by shared-memory traffic (one shared load per two multiply-adds)
// and by the shuffles. Head dims are zero-padded to 160, 192, 224, 256,
// 384 or 512; 512 is the kernels' limit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxHeadDim = 512;

// elements of T a 16-byte copy moves (and the row padding of a tile)
template <typename T>
constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ float to_f32(T x) { return Elem<T>::widen(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x) { return Elem<T>::narrow(x); }
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// two neighbouring outputs (d, d + 1) of one row, in one store
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
template <typename T>
__device__ __forceinline__ void store2(T* p, float x0, float x1) {
  *reinterpret_cast<typename Elem<T>::Pair*>(p) = Elem<T>::pair(x0, x1);
}

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
template <int kR, int kDP, int kLD, typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src, int b, int h,
                                           int r0, int S, int H, int D, bool vec) {
  const T* head = src + row_offset(b, 0, S, h, H, D);
  const int64_t stride = static_cast<int64_t>(H) * D;  // between rows of one head
  if (vec) {
    constexpr int kChunks = kDP / kPer16<T>;
    constexpr int kCopies = kR * kChunks;
#pragma unroll
    for (int j = 0; j < (kCopies + kTcThreads - 1) / kTcThreads; ++j) {
      const int i = threadIdx.x + j * kTcThreads;
      if (kCopies % kTcThreads == 0 || i < kCopies) {
        const int r = i / kChunks, c = (i % kChunks) * kPer16<T>, s = r0 + r;
        const bool ok = s < S && c < D;
        cp_async16(dst + r * kLD + c, ok ? head + s * stride + c : src, ok);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kR * kDP; i += kTcThreads) {
      const int r = i / kDP, c = i % kDP, s = r0 + r;
      const bool ok = s < S && c < D;
      if constexpr (std::is_same<T, float>::value) {
        cp_async4(dst + r * kLD + c, ok ? head + s * stride + c : src, ok);
      } else {  // cp.async moves 4 bytes at least: a plain load and store
        dst[r * kLD + c] = ok ? head[s * stride + c] : from_f32<T>(0.f);
      }
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

// rows r and r + 8 of a [16, kDP] accumulator (each thread's columns
// 8n + 2t and 8n + 2t + 1) to rows row0 (+ 8) of head (b, h), times mul
template <int kNT, typename T>
__device__ __forceinline__ void store_acc(T* __restrict__ dst, const float (&acc)[kNT][4],
                                          const float (&mul)[2], int b, int h, int row0, int S,
                                          int H, int D, bool vec) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = row0 + 8 * half;
    if (s >= S) continue;
    T* row = dst + row_offset(b, s, S, h, H, D);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int d = 8 * n + 2 * t;
      const float x0 = acc[n][2 * half] * mul[half], x1 = acc[n][2 * half + 1] * mul[half];
      if (vec) {
        if (d < D) store2(row + d, x0, x1);
      } else {
        if (d < D) row[d] = from_f32<T>(x0);
        if (d + 1 < D) row[d + 1] = from_f32<T>(x1);
      }
    }
  }
}

// ------------------------------------------------- forward, tensor cores

// tiles are rows of kDP elements of T padded by 16 bytes
template <int kDP, typename T>
constexpr int kLdOf = kDP + kPer16<T>;

template <int kDP, typename T>
size_t fwd_tc_smem() {
  // two stages of K and V, then Q
  return sizeof(T) * kLdOf<kDP, T> * (4 * kFwdKeyTile + kTcRows);
}

// D <= 64: at most 128 registers a thread, so four blocks share an SM
template <int kDP, typename T>
__global__ void __launch_bounds__(kTcThreads, kDP <= 64 ? 4 : 1)
    flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse, int Sq, int Sk, int H, int D, float scale,
                        int causal, int vec) {
  constexpr int kLD = kLdOf<kDP, T>;
  constexpr int kNT = kDP / 8;  // 8-wide steps of the head dim
  constexpr int kBK = kFwdKeyTile;
  constexpr int kKT = kBK / 8;  // 8-key steps of a tile
  constexpr bool kE = kExact<T>;
  static_assert(kKT * 4 <= 32, "one mask bit per accumulator element");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int kStage = 2 * kBK * kLD;  // a stage: kBK rows of K, then kBK rows of V
  T* qs = smem + 2 * kStage;             // [kTcRows][kLD]
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

  const T* my_q = qs + warp * 16 * kLD;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBK;
    if (it + 1 < ntiles) {  // the next tile loads while this one is computed
      T* next = smem + ((it + 1) & 1) * kStage;
      stage_tile<kBK, kDP, kLD>(next, k, b, h, k0 + kBK, Sk, H, D, vec);
      stage_tile<kBK, kDP, kLD>(next + kBK * kLD, v, b, h, k0 + kBK, Sk, H, D, vec);
      cp_async_commit();
    }
    const T* kt = smem + (it & 1) * kStage;
    const T* vt = kt + kBK * kLD;

    // S = (scale Q) K^T, 16 x kBK per warp (bf16: Q K^T, then scaled)
    float s[kKT][4];
#pragma unroll
    for (int n = 0; n < kKT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int d8 = 0; d8 < kNT; ++d8) {
      FragA a;
      load_a(a, my_q + 8 * d8, kLD, kE ? 1.f : scale);
#pragma unroll
      for (int n = 0; n < kKT; ++n) {
        FragB bf;
        load_b_nk(bf, kt + n * 8 * kLD + 8 * d8, kLD);
        mma_acc<kE, kE>(s[n], a, bf);
      }
    }
    if constexpr (kE) {
#pragma unroll
      for (int n = 0; n < kKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale;
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
        mma_acc<false, kE>(acc[n], a, bf);
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
  store_acc<kNT, T>(o, acc, inv, b, h, row0, Sq, H, D, vec);
}

// --------------------------------------------------- dK/dV, tensor cores

template <int kDP, typename T>
size_t dkv_tc_smem() {
  constexpr size_t ld = kLdOf<kDP, T>, bq = kDkvQueryTile;
  // K and V of the block; q and dO, two stages each; lse and delta, two stages each
  return sizeof(T) * ld * (2 * kTcRows + 4 * bq) + sizeof(float) * 4 * bq;
}

template <int kDP, typename T>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
                            int D, float scale, int causal, int vec) {
  constexpr int kLD = kLdOf<kDP, T>;
  constexpr int kNT = kDP / 8;
  constexpr int kBQ = kDkvQueryTile;
  constexpr int kQT = kBQ / 8;  // 8-query steps of a tile
  constexpr bool kE = kExact<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [kTcRows][kLD]
  T* vs = ks + kTcRows * kLD;              // [kTcRows][kLD]
  T* qs = vs + kTcRows * kLD;              // [2][kBQ][kLD]
  T* dos = qs + 2 * kBQ * kLD;             // [2][kBQ][kLD]
  float* lses = reinterpret_cast<float*>(dos + 2 * kBQ * kLD);  // [2][kBQ]
  float* deltas = lses + 2 * kBQ;                                // [2][kBQ]
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

  const T* my_k = ks + warp * 16 * kLD;
  const T* my_v = vs + warp * 16 * kLD;
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
    const T* qt = qs + buf * kBQ * kLD;
    const T* dot = dos + buf * kBQ * kLD;
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
        mma_acc<kE, kE>(st[n], ka, bq);
        mma_acc<kE, kE>(dpt[n], va, bd);
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
        mma_acc<false, kE>(dv_acc[n], pa, bd);
        mma_acc<false, kE>(dk_acc[n], da, bq);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
  const float dk_mul[2] = {scale, scale}, dv_mul[2] = {1.f, 1.f};
  store_acc<kNT, T>(dk, dk_acc, dk_mul, b, h, key0, Sk, H, D, vec);
  store_acc<kNT, T>(dv, dv_acc, dv_mul, b, h, key0, Sk, H, D, vec);
}

// ------------------------------------------------------ dQ, tensor cores

template <int kDP, typename T>
size_t dq_tc_smem() {
  // two stages of K and V; Q and dO of the block; lse and delta
  return sizeof(T) * kLdOf<kDP, T> * (4 * kDqKeyTile + 2 * kTcRows) +
         sizeof(float) * 2 * kTcRows;
}

// blocks an SM the register budget is set for: shared memory allows 3
// with 32-key tiles at D <= 64, 4 with 16-key tiles
__host__ __device__ constexpr int dq_min_blocks(int dp) {
  return dp > 64 ? 1 : kDqKeyTile == 16 ? 4 : 3;
}

template <int kDP, typename T>
__global__ void __launch_bounds__(kTcThreads, dq_min_blocks(kDP))
    flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           T* __restrict__ dq, int Sq, int Sk, int H, int D, float scale,
                           int causal, int vec) {
  constexpr int kLD = kLdOf<kDP, T>;
  constexpr int kNT = kDP / 8;
  constexpr int kBK = kDqKeyTile;
  constexpr int kKT = kBK / 8;
  constexpr bool kE = kExact<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int kStage = 2 * kBK * kLD;  // a stage: kBK rows of K, then kBK rows of V
  T* qs = smem + 2 * kStage;             // [kTcRows][kLD]
  T* dos = qs + kTcRows * kLD;           // [kTcRows][kLD]
  float* lses = reinterpret_cast<float*>(dos + kTcRows * kLD);  // [kTcRows]
  float* deltas = lses + kTcRows;                               // [kTcRows]
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

  const T* my_q = qs + warp * 16 * kLD;
  const T* my_do = dos + warp * 16 * kLD;
  const float lse_r[2] = {lses[warp * 16 + g], lses[warp * 16 + g + 8]};
  const float delta_r[2] = {deltas[warp * 16 + g], deltas[warp * 16 + g + 8]};
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBK;
    if (it + 1 < ntiles) {  // the next tile loads while this one is computed
      T* next = smem + ((it + 1) & 1) * kStage;
      stage_tile<kBK, kDP, kLD>(next, k, b, h, k0 + kBK, Sk, H, D, vec);
      stage_tile<kBK, kDP, kLD>(next + kBK * kLD, v, b, h, k0 + kBK, Sk, H, D, vec);
      cp_async_commit();
    }
    const T* kt = smem + (it & 1) * kStage;
    const T* vt = kt + kBK * kLD;

    // S = (scale Q) K^T (bf16: Q K^T, then scaled) and dP = dO V^T, 16 x kBK per warp
    float s[kKT][4], dp[kKT][4];
#pragma unroll
    for (int n = 0; n < kKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int d8 = 0; d8 < kNT; ++d8) {
      FragA qa, da;
      load_a(qa, my_q + 8 * d8, kLD, kE ? 1.f : scale);
      load_a(da, my_do + 8 * d8, kLD, 1.f);
#pragma unroll
      for (int n = 0; n < kKT; ++n) {
        FragB bk, bv;
        load_b_nk(bk, kt + n * 8 * kLD + 8 * d8, kLD);
        load_b_nk(bv, vt + n * 8 * kLD + 8 * d8, kLD);
        mma_acc<kE, kE>(s[n], qa, bk);
        mma_acc<kE, kE>(dp[n], da, bv);
      }
    }
    if constexpr (kE) {
#pragma unroll
      for (int n = 0; n < kKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale;
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
        mma_acc<false, kE>(acc[n], a, bf);
      }
    }
    cp_async_wait_all();  // the next tile has landed
    __syncthreads();      // and every warp is done with this one
  }
  // dQ = scale * dS K (the TPU kernel scales at the end too)
  const float mul[2] = {scale, scale};
  store_acc<kNT, T>(dq, acc, mul, b, h, row0, Sq, H, D, vec);
}

// ============================ bf16 and fp16 forward, dQ and dK/dV, wgmma + TMA

constexpr int kWgRows = 64;  // rows of the block's own axis a warpgroup owns: its wgmma M
// consumer warpgroups a block: the block owns kWgGroups * 64 rows, and each
// tile of the other axis is copied once for all of them (2 halves the
// copies and was slower at BERT's S = 128: half the blocks, each longer)
constexpr int kWgGroups = 1;
constexpr int kWgBlockRows = kWgGroups * kWgRows;
constexpr int kWgCols = 64;  // 2-byte columns of a TMA box: one 128-byte swizzled row
constexpr int kWgStages = 2;       // tiles of the other axis in the ring
constexpr int kWgFwdKeys = 64;     // keys a forward tile
constexpr int kWgDkvQueries = 64;  // queries a dK/dV tile
constexpr int kWgDqKeys = 64;      // keys a dQ tile
// who starts the copies: thread 0 (warp 0 for dK/dV) between its tiles, or
// a warp of its own (true), which costs the dK/dV body half its blocks an
// SM (registers are shared out by the SM's four quarters, whole warps each)
constexpr bool kWgProducerWarp = false;
constexpr int kWgConsumers = 128 * kWgGroups;
constexpr int kWgThreads = kWgConsumers + (kWgProducerWarp ? 32 : 0);
constexpr float kLog2e = 1.4426950408889634f;
// blocks an SM each body's register budget is set for at D <= 64 (shared
// memory allows 5 forward, 4 dK/dV and 4 dQ blocks there): dK/dV's 3 cap
// it at 168 registers, where it would take 195 and fit 2; at D = 128
// shared memory allows 2 and the budget is left free
constexpr int kWgFwdMinBlocks = 4;
constexpr int kWgDkvMinBlocks = 3;
constexpr int kWgDqMinBlocks = 4;

// A tile of kR rows of kDP 2-byte columns as TMA writes it: kDP / 64 blocks
// of kR x 64, each row 128 bytes, swizzled (kR * 128 is a multiple of the
// swizzle's 1024-byte period, so every block starts its period)
template <int kR, int kDP>
constexpr int kWgTile = kR * kDP;  // elements

// rows [r0, r0 + kR) of head (b, h) into a tile, completing on bar
template <int kR, int kDP, typename T>
__device__ __forceinline__ void wg_load_tile(T* dst, const CUtensorMap* map, uint64_t* bar,
                                             int b, int h, int r0) {
#pragma unroll
  for (int c = 0; c < kDP / kWgCols; ++c)
    tma_load_4d(dst + c * kR * kWgCols, map, bar, c * kWgCols, h, r0, b);
}

// descriptor of rows [row0, row0 + 64) of a kR-row tile read K-major (the
// head dim reduced), at its 16-column step k16
template <int kR, typename T>
__device__ __forceinline__ uint64_t wg_desc_k(const T* tile, int row0, int k16) {
  return gmma_desc(tile + (k16 / 4) * kR * kWgCols + row0 * kWgCols + (k16 % 4) * 16, 16, 1024);
}

// descriptor of rows [k0, k0 + 16) of a kR-row tile read MN-major (its
// rows reduced), at its 64-column block c
template <int kR, typename T>
__device__ __forceinline__ uint64_t wg_desc_mn(const T* tile, int k0, int c) {
  return gmma_desc(tile + c * kR * kWgCols + k0 * kWgCols, kR * kWgCols * 2, 1024);
}

// the block's dynamic shared memory from its first 1024-byte boundary
__device__ __forceinline__ unsigned char* wg_smem(unsigned char* raw) {
  return raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u);
}

// row r and r + 8 of a 64 x 64 accumulator block (columns c0 + 8j + 2t,
// + 1), times mul, as pairs of T into rows row0 (+ 8) of head (b, h)
template <typename T>
__device__ __forceinline__ void wg_store(T* __restrict__ dst, const float (&acc)[32], int c0,
                                         float mul, int b, int h, int row0, int S, int H, int D) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = row0 + 8 * half;
    if (s >= S) continue;
    T* row = dst + row_offset(b, s, S, h, H, D);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = c0 + 8 * j + 2 * t;
      if (d < D) store2(row + d, acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
    }
  }
}

// the 16-wide k step ks of a 64-column block of an fp32 accumulator (its
// columns 16 (ks % 4) .. + 15) as hi and lo A fragments of T
template <typename T>
__device__ __forceinline__ void wg_split_a(const float (&acc)[32], int ks, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  const int j = 2 * (ks % 4);
  split_x2<T>(acc[4 * j], acc[4 * j + 1], hi[0], lo[0]);
  split_x2<T>(acc[4 * j + 2], acc[4 * j + 3], hi[1], lo[1]);
  split_x2<T>(acc[4 * j + 4], acc[4 * j + 5], hi[2], lo[2]);
  split_x2<T>(acc[4 * j + 6], acc[4 * j + 7], hi[3], lo[3]);
}

// fp16's range for dS (dQ) and dS^T (dK/dV), the computed operands that
// can leave it (P is in [0, 1]): before the split, each of this thread's
// two rows r = (i >> 1) & 1 of the warpgroup's 64 x 64 block x (a row
// spread over a quad) is multiplied by 2^e[r], with e[r] the least over
// the tiles so far of 14 - floor(log2 of the row's largest |x|), clamped
// to kMaxScaleExp: the row's largest scaled value lies in [2^14, 2^15]
// at the tile that set e, and below it at every other, so no half
// overflows and the largest keep fp16's full precision. The products
// accumulate in units of 2^-e: a row's accumulators are rescaled by
// 2^(e_new - e_old) when e falls (as the online softmax rescales by its
// running max), and the store multiplies by 2^-e. Powers of two, so every
// scaling is exact in fp32 (short of fp32's own underflow).
constexpr int kMaxScaleExp = 60;

// 2^k for -126 <= k <= 127, from its bits (ldexpf's range checks cost the
// fp16 dK/dV 9% and dQ 5% at the training shape: tools/flash_probe.py)
__device__ __forceinline__ float pow2(int k) {
  return __uint_as_float(static_cast<uint32_t>(k + 127) << 23);
}

template <int kN, int kC>
__device__ __forceinline__ void scale_rows(float (&x)[kN][32], float (&acc)[kC][32],
                                           int (&e)[2]) {
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], fabsf(x[n][i]));
  float mul[2], corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // floor(log2 m) from m's exponent bits (-127 for 0 and subnormals),
    // so -113 <= en <= 60; a fall past 2^-126 (a row whose earlier tiles
    // were below 2^-126 of this one's) rescales by 2^-126 alone
    const int lg = static_cast<int>((__float_as_uint(quad_max(mx[r])) >> 23) & 0xffu) - 127;
    const int en = min(e[r], min(kMaxScaleExp, 14 - lg));
    mul[r] = pow2(en);
    corr[r] = pow2(max(en - e[r], -126));
    e[r] = en;
  }
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) x[n][i] *= mul[(i >> 1) & 1];
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] *= corr[(i >> 1) & 1];
}

// undo scale_rows at the store: the rows of acc times 2^-e
template <int kC>
__device__ __forceinline__ void unscale_rows(float (&acc)[kC][32], const int (&e)[2]) {
  const float mul[2] = {pow2(-e[0]), pow2(-e[1])};
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] *= mul[(i >> 1) & 1];
}

template <int kDP, typename T>
size_t fwd_wg_smem() {
  // Q, the ring of K and V tiles, barriers (q, full and empty a stage),
  // and room to reach a 1024-byte boundary
  return sizeof(T) * (kWgTile<kWgBlockRows, kDP> + 2 * kWgStages * kWgTile<kWgFwdKeys, kDP>) +
         sizeof(uint64_t) * (1 + 2 * kWgStages) + 1024;
}

template <int kDP, typename T>
__global__ void __launch_bounds__(kWgThreads, kDP <= 64 ? kWgFwdMinBlocks : 1)
    flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
                        float* __restrict__ lse, int Sq, int Sk, int H, int D, float scale,
                        int causal) {
  constexpr int kBK = kWgFwdKeys;
  constexpr int kNC = kDP / kWgCols;  // 64-column blocks of the head dim
  constexpr int kKC = kBK / 64;       // 64-key blocks of a tile (the wgmma N of S)
  constexpr int kStage = 2 * kWgTile<kBK, kDP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(wg_smem(smem_raw));
  T* ring = qs + kWgTile<kWgBlockRows, kDP>;  // a stage: the K tile, then the V tile
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + kWgStages * kStage);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kWgStages;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kWgBlockRows;
  const int kv_end = causal ? min(Sk, q0 + kWgBlockRows) : Sk;
  const int ntiles = (kv_end + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWgGroups);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the copies of key tile it, once its stage is free
  auto produce = [&](int it) {
    const int s = it % kWgStages;
    if (it >= kWgStages) mbar_wait(&empty[s], (it / kWgStages - 1) & 1);
    T* kt = ring + s * kStage;
    mbar_arrive_expect_tx(&full[s], sizeof(T) * kStage);
    wg_load_tile<kBK, kDP>(kt, &tk, &full[s], b, h, it * kBK);
    wg_load_tile<kBK, kDP>(kt + kWgTile<kBK, kDP>, &tv, &full[s], b, h, it * kBK);
  };
  if (threadIdx.x == (kWgProducerWarp ? kWgConsumers : 0)) {
    mbar_arrive_expect_tx(qbar, sizeof(T) * kWgTile<kWgBlockRows, kDP>);
    wg_load_tile<kWgBlockRows, kDP>(qs, &tq, qbar, b, h, q0);
    for (int it = 0; it < (kWgProducerWarp ? ntiles : min(ntiles, kWgStages - 1)); ++it)
      produce(it);
  }
  if (threadIdx.x >= kWgConsumers) return;  // the producer warp is done

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wg = warp / 4, qw = q0 + wg * kWgRows;  // this warpgroup's first query row
  const int row0 = qw + (warp % 4) * 16 + g;       // this thread's query rows: row0, row0 + 8
  const float scale2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // m in base 2
  float acc[kNC][32];
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  mbar_wait(qbar, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kWgStages;
    if (!kWgProducerWarp) {
      if (threadIdx.x == 0 && it + kWgStages - 1 < ntiles) produce(it + kWgStages - 1);
      __syncwarp();
    }
    mbar_wait(&full[s], (it / kWgStages) & 1);
    const T* kt = ring + s * kStage;
    const T* vt = kt + kWgTile<kBK, kDP>;
    const int k0 = it * kBK;
    // a causal tile past this warpgroup's last row is all masked for it
    if (!causal || k0 < qw + kWgRows) {
      // S = Q K^T, one exact product (T x T into fp32)
      float sc[kKC][32];
#pragma unroll
      for (int n = 0; n < kKC; ++n) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[n][i] = 0.f;
        fence_acc(sc[n]);
      }
      wgmma_fence();
#pragma unroll
      for (int n = 0; n < kKC; ++n)
#pragma unroll
        for (int ks = 0; ks < kDP / 16; ++ks)
          wgmma_ss<T>(sc[n], wg_desc_k<kWgBlockRows>(qs, wg * kWgRows, ks),
                   wg_desc_k<kBK>(kt, 64 * n, ks));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int n = 0; n < kKC; ++n) fence_acc(sc[n]);

      // online softmax in base 2 on the scores times scale log2(e), masked
      // only in a tile that reaches past Sk or the diagonal; element i of
      // sc[n] is row row0 + 8 ((i >> 1) & 1), key k0 + 64n + 8 (i >> 2) + 2t
      // + (i & 1)
      float mx[2] = {kNegInf, kNegInf};
      auto scores = [&](auto masked) {
#pragma unroll
        for (int n = 0; n < kKC; ++n)
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1, key = k0 + 64 * n + 8 * (i >> 2) + 2 * t + (i & 1);
            const bool ok = !decltype(masked)::value ||
                            (key < Sk && (!causal || key <= row0 + 8 * r));
            sc[n][i] = ok ? sc[n][i] * scale2 : kNegInf;
            mx[r] = fmaxf(mx[r], sc[n][i]);
          }
      };
      if (k0 + kBK <= Sk && (!causal || k0 + kBK - 1 <= qw))
        scores(std::false_type{});
      else
        scores(std::true_type{});
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        corr[r] = exp2_approx(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < kKC; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const float p = sc[n][i] == kNegInf ? 0.f : exp2_approx(sc[n][i] - m[r]);
          sc[n][i] = p;
          l[r] += p;
        }

      // O = corr O + P V, P in two halves of T (lo, then hi), V read MN-major
      uint32_t ph[kBK / 16][4], pl[kBK / 16][4];
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) wg_split_a<T>(sc[ks / 4], ks, ph[ks], pl[ks]);
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] *= corr[(i >> 1) & 1];
        fence_acc(acc[c]);
      }
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kNC; ++c)
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
          wgmma_rs<T>(acc[c], pl[ks], wg_desc_mn<kBK>(vt, 16 * ks, c));
          wgmma_rs<T>(acc[c], ph[ks], wg_desc_mn<kBK>(vt, 16 * ks, c));
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < kNC; ++c) fence_acc(acc[c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float div = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.f / div;
    const int sr = row0 + 8 * r;
    if (t == 0 && sr < Sq)
      lse[(static_cast<int64_t>(b) * Sq + sr) * H + h] = m[r] / kLog2e + logf(div);
  }
#pragma unroll
  for (int c = 0; c < kNC; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] *= inv[(i >> 1) & 1];
    wg_store(o, acc[c], c * kWgCols, 1.f, b, h, row0, Sq, H, D);
  }
}

template <int kDP, typename T>
size_t dkv_wg_smem() {
  // K and V of the block; the ring of Q and dO tiles with their lse and
  // delta rows; barriers (K/V, full and empty a stage); 1024-byte room
  return sizeof(T) *
             (2 * kWgTile<kWgBlockRows, kDP> + 2 * kWgStages * kWgTile<kWgDkvQueries, kDP>) +
         sizeof(float) * 2 * kWgStages * kWgDkvQueries + sizeof(uint64_t) * (1 + 2 * kWgStages) +
         1024;
}

template <int kDP, typename T>
__global__ void __launch_bounds__(kWgThreads, kDP <= 64 ? kWgDkvMinBlocks : 1)
    flash_bwd_dkv_wg_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
                            int D, float scale, int causal) {
  constexpr int kBQ = kWgDkvQueries;
  constexpr int kNC = kDP / kWgCols;
  constexpr int kQC = kBQ / 64;  // 64-query blocks of a tile (the wgmma N of S^T)
  constexpr int kStage = 2 * kWgTile<kBQ, kDP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(wg_smem(smem_raw));
  T* vs = ks + kWgTile<kWgBlockRows, kDP>;
  T* ring = vs + kWgTile<kWgBlockRows, kDP>;  // a stage: the Q tile, then the dO tile
  float* lses = reinterpret_cast<float*>(ring + kWgStages * kStage);  // [kWgStages][kBQ]
  float* deltas = lses + kWgStages * kBQ;                             // [kWgStages][kBQ]
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(deltas + kWgStages * kBQ);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + kWgStages;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kWgBlockRows;
  // query rows before this block's first key see none of its keys
  const int q_start = causal ? (k0 / kBQ) * kBQ : 0;
  const int ntiles = (Sq - q_start + kBQ - 1) / kBQ;
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < kWgStages; ++s) {
      // lane 0's announcement of the tiles' bytes, then the producing
      // warp's 32 lanes, each after its lse/delta rows
      mbar_init(&full[s], 33);
      mbar_init(&empty[s], 4 * kWgGroups);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the copies of query tile it by the 32 lanes of the producing warp,
  // once its stage is free: the Q and dO tiles by lane 0's TMA, the lse
  // and delta rows (a column of a [B,S,H] tensor is no TMA box) by 4-byte
  // cp.async, zeros past Sq, each lane arriving once its copies land
  const int lane = threadIdx.x & 31;
  auto produce = [&](int it) {
    const int s = it % kWgStages, q0 = q_start + it * kBQ;
    if (it >= kWgStages) mbar_wait(&empty[s], (it / kWgStages - 1) & 1);
    if (lane == 0) {
      T* qt = ring + s * kStage;
      mbar_arrive_expect_tx(&full[s], sizeof(T) * kStage);
      wg_load_tile<kBQ, kDP>(qt, &tq, &full[s], b, h, q0);
      wg_load_tile<kBQ, kDP>(qt + kWgTile<kBQ, kDP>, &tdo, &full[s], b, h, q0);
    }
    for (int i = lane; i < kBQ; i += 32) {
      const bool ok = q0 + i < Sq;
      const int64_t at = ok ? (static_cast<int64_t>(b) * Sq + q0 + i) * H + h : 0;
      cp_async4(&lses[s * kBQ + i], lse + at, ok);
      cp_async4(&deltas[s * kBQ + i], delta + at, ok);
    }
    cp_async_mbar_arrive(&full[s]);
  };
  const int warp = threadIdx.x >> 5;
  if (warp == (kWgProducerWarp ? kWgConsumers / 32 : 0)) {
    if (lane == 0) {
      mbar_arrive_expect_tx(kvbar, sizeof(T) * 2 * kWgTile<kWgBlockRows, kDP>);
      wg_load_tile<kWgBlockRows, kDP>(ks, &tk, kvbar, b, h, k0);
      wg_load_tile<kWgBlockRows, kDP>(vs, &tv, kvbar, b, h, k0);
    }
    for (int it = 0; it < (kWgProducerWarp ? ntiles : min(ntiles, kWgStages - 1)); ++it)
      produce(it);
  }
  if (threadIdx.x >= kWgConsumers) return;  // the producer warp is done

  const int g = lane >> 2, t = lane & 3;
  const int wg = warp / 4, kw = k0 + wg * kWgRows;  // this warpgroup's first key row
  const int key0 = kw + (warp % 4) * 16 + g;       // this thread's key rows: key0, key0 + 8
  const float scale2 = scale * kLog2e;
  float dk_acc[kNC][32], dv_acc[kNC][32];
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;
  int ex[2] = {kMaxScaleExp, kMaxScaleExp};  // fp16: dS^T's row exponents (scale_rows)
  mbar_wait(kvbar, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kWgStages, q0 = q_start + it * kBQ;
    if (!kWgProducerWarp && warp == 0 && it + kWgStages - 1 < ntiles) produce(it + kWgStages - 1);
    mbar_wait(&full[s], (it / kWgStages) & 1);
    const T* qt = ring + s * kStage;
    const T* dot = qt + kWgTile<kBQ, kDP>;
    const float* lt = lses + s * kBQ;
    const float* det = deltas + s * kBQ;
    // a causal tile of queries before this warpgroup's first key is all
    // masked for it
    if (!causal || q0 + kBQ > kw) {
      // S^T = K Q^T and dP^T = V dO^T, one exact product each
      float st[kQC][32], dpt[kQC][32];
#pragma unroll
      for (int n = 0; n < kQC; ++n) {
#pragma unroll
        for (int i = 0; i < 32; ++i) st[n][i] = dpt[n][i] = 0.f;
        fence_acc(st[n]);
        fence_acc(dpt[n]);
      }
      wgmma_fence();
#pragma unroll
      for (int n = 0; n < kQC; ++n)
#pragma unroll
        for (int kk = 0; kk < kDP / 16; ++kk) {
          wgmma_ss<T>(st[n], wg_desc_k<kWgBlockRows>(ks, wg * kWgRows, kk),
                   wg_desc_k<kBQ>(qt, 64 * n, kk));
          wgmma_ss<T>(dpt[n], wg_desc_k<kWgBlockRows>(vs, wg * kWgRows, kk),
                   wg_desc_k<kBQ>(dot, 64 * n, kk));
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int n = 0; n < kQC; ++n) {
        fence_acc(st[n]);
        fence_acc(dpt[n]);
      }

      // P^T = exp(scale S^T - lse) = 2^(log2(e) (scale S^T - lse)) and
      // dS^T = P^T o (dP^T - delta), masked only in a tile that reaches past
      // Sq or Sk or below the diagonal; element i of st[n] is key key0 +
      // 8 ((i >> 1) & 1), query q0 + 64n + 8 (i >> 2) + 2t + (i & 1)
      auto probs = [&](auto masked) {
#pragma unroll
        for (int n = 0; n < kQC; ++n)
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int ql = 64 * n + 8 * (i >> 2) + 2 * t + (i & 1), qi = q0 + ql;
            const int key = key0 + 8 * ((i >> 1) & 1);
            const bool ok = !decltype(masked)::value ||
                            (qi < Sq && key < Sk && (!causal || qi >= key));
            const float p = ok ? exp2_approx(fmaf(st[n][i], scale2, -lt[ql] * kLog2e)) : 0.f;
            st[n][i] = p;
            dpt[n][i] = p * (dpt[n][i] - det[ql]);
          }
      };
      if (q0 + kBQ <= Sq && kw + kWgRows <= Sk && (!causal || q0 >= kw + kWgRows - 1))
        probs(std::false_type{});
      else
        probs(std::true_type{});

      // fp16: each key row of dS^T times 2^e first, dK's sum in units of
      // 2^-e (scale_rows)
      if constexpr (Elem<T>::kF16) scale_rows(dpt, dk_acc, ex);

      // dV += P^T dO and dK += dS^T Q (scaled at the store), P^T and dS^T in
      // two halves of T (lo, then hi), dO and Q read MN-major from the tiles
      // the products above read K-major
      uint32_t ph[kBQ / 16][4], pl[kBQ / 16][4], dh[kBQ / 16][4], dl[kBQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        wg_split_a<T>(st[kk / 4], kk, ph[kk], pl[kk]);
        wg_split_a<T>(dpt[kk / 4], kk, dh[kk], dl[kk]);
      }
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        fence_acc(dv_acc[c]);
        fence_acc(dk_acc[c]);
      }
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kNC; ++c)
#pragma unroll
        for (int kk = 0; kk < kBQ / 16; ++kk) {
          wgmma_rs<T>(dv_acc[c], pl[kk], wg_desc_mn<kBQ>(dot, 16 * kk, c));
          wgmma_rs<T>(dv_acc[c], ph[kk], wg_desc_mn<kBQ>(dot, 16 * kk, c));
          wgmma_rs<T>(dk_acc[c], dl[kk], wg_desc_mn<kBQ>(qt, 16 * kk, c));
          wgmma_rs<T>(dk_acc[c], dh[kk], wg_desc_mn<kBQ>(qt, 16 * kk, c));
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        fence_acc(dv_acc[c]);
        fence_acc(dk_acc[c]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if constexpr (Elem<T>::kF16) unscale_rows(dk_acc, ex);
#pragma unroll
  for (int c = 0; c < kNC; ++c) {
    wg_store(dk, dk_acc[c], c * kWgCols, scale, b, h, key0, Sk, H, D);
    wg_store(dv, dv_acc[c], c * kWgCols, 1.f, b, h, key0, Sk, H, D);
  }
}

template <int kDP, typename T>
size_t dq_wg_smem() {
  // Q and dO of the block; the ring of K and V tiles; barriers (Q/dO,
  // full and empty a stage); the block's lse and delta rows; 1024-byte room
  return sizeof(T) *
             (2 * kWgTile<kWgBlockRows, kDP> + 2 * kWgStages * kWgTile<kWgDqKeys, kDP>) +
         sizeof(uint64_t) * (1 + 2 * kWgStages) + sizeof(float) * 2 * kWgBlockRows + 1024;
}

template <int kDP, typename T>
__global__ void __launch_bounds__(kWgThreads, kDP <= 64 ? kWgDqMinBlocks : 1)
    flash_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           T* __restrict__ dq, int Sq, int Sk, int H, int D, float scale,
                           int causal) {
  constexpr int kBK = kWgDqKeys;
  constexpr int kNC = kDP / kWgCols;
  constexpr int kKC = kBK / 64;  // 64-key blocks of a tile (the wgmma N of S and dP)
  constexpr int kStage = 2 * kWgTile<kBK, kDP>;
  static_assert(kWgConsumers == 2 * kWgBlockRows, "one lse or delta row a consumer thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(wg_smem(smem_raw));
  T* dos = qs + kWgTile<kWgBlockRows, kDP>;
  T* ring = dos + kWgTile<kWgBlockRows, kDP>;  // a stage: the K tile, then the V tile
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + kWgStages * kStage);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kWgStages;
  float* lses = reinterpret_cast<float*>(empty + kWgStages);  // [kWgBlockRows]
  float* deltas = lses + kWgBlockRows;                        // [kWgBlockRows]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kWgBlockRows;
  const int kv_end = causal ? min(Sk, q0 + kWgBlockRows) : Sk;
  const int ntiles = (kv_end + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    // the producer's announcement of the Q and dO bytes, then one arrival
    // a consumer thread once its lse or delta row lands
    mbar_init(qbar, 1 + kWgConsumers);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWgGroups);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the copies of key tile it, once its stage is free
  auto produce = [&](int it) {
    const int s = it % kWgStages;
    if (it >= kWgStages) mbar_wait(&empty[s], (it / kWgStages - 1) & 1);
    T* kvt = ring + s * kStage;
    mbar_arrive_expect_tx(&full[s], sizeof(T) * kStage);
    wg_load_tile<kBK, kDP>(kvt, &tk, &full[s], b, h, it * kBK);
    wg_load_tile<kBK, kDP>(kvt + kWgTile<kBK, kDP>, &tv, &full[s], b, h, it * kBK);
  };
  if (threadIdx.x == (kWgProducerWarp ? kWgConsumers : 0)) {
    mbar_arrive_expect_tx(qbar, sizeof(T) * 2 * kWgTile<kWgBlockRows, kDP>);
    wg_load_tile<kWgBlockRows, kDP>(qs, &tq, qbar, b, h, q0);
    wg_load_tile<kWgBlockRows, kDP>(dos, &tdo, qbar, b, h, q0);
    for (int it = 0; it < (kWgProducerWarp ? ntiles : min(ntiles, kWgStages - 1)); ++it)
      produce(it);
  }
  if (threadIdx.x >= kWgConsumers) return;  // the producer warp is done

  // the block's lse and delta rows (a column of a [B,S,H] tensor is no TMA
  // box), one 4-byte cp.async a consumer thread, tracked by the Q/dO
  // barrier; rows past Sq land as 0, and their Q and dO rows as zeros, so
  // their dS is 0 (they are never stored)
  {
    const int i = threadIdx.x % kWgBlockRows;
    const bool ok = q0 + i < Sq;
    const int64_t at = ok ? (static_cast<int64_t>(b) * Sq + q0 + i) * H + h : 0;
    if (threadIdx.x < kWgBlockRows)
      cp_async4(&lses[i], lse + at, ok);
    else
      cp_async4(&deltas[i], delta + at, ok);
    cp_async_mbar_arrive(qbar);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wg = warp / 4, qw = q0 + wg * kWgRows;  // this warpgroup's first query row
  const int row0 = qw + (warp % 4) * 16 + g;       // this thread's query rows: row0, row0 + 8
  const float scale2 = scale * kLog2e;
  float acc[kNC][32];
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  int ex[2] = {kMaxScaleExp, kMaxScaleExp};  // fp16: dS's row exponents (scale_rows)
  mbar_wait(qbar, 0);
  // lse (times log2(e)) and delta of this thread's two rows
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = lses[row0 + 8 * r - q0] * kLog2e;
    dlt[r] = deltas[row0 + 8 * r - q0];
  }

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kWgStages;
    if (!kWgProducerWarp) {
      if (threadIdx.x == 0 && it + kWgStages - 1 < ntiles) produce(it + kWgStages - 1);
      __syncwarp();
    }
    mbar_wait(&full[s], (it / kWgStages) & 1);
    const T* kt = ring + s * kStage;
    const T* vt = kt + kWgTile<kBK, kDP>;
    const int k0 = it * kBK;
    // a causal tile past this warpgroup's last row is all masked for it
    if (!causal || k0 < qw + kWgRows) {
      // S = Q K^T and dP = dO V^T, one exact product each
      float sc[kKC][32], dp[kKC][32];
#pragma unroll
      for (int n = 0; n < kKC; ++n) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[n][i] = dp[n][i] = 0.f;
        fence_acc(sc[n]);
        fence_acc(dp[n]);
      }
      wgmma_fence();
#pragma unroll
      for (int n = 0; n < kKC; ++n)
#pragma unroll
        for (int ks = 0; ks < kDP / 16; ++ks) {
          wgmma_ss<T>(sc[n], wg_desc_k<kWgBlockRows>(qs, wg * kWgRows, ks),
                   wg_desc_k<kBK>(kt, 64 * n, ks));
          wgmma_ss<T>(dp[n], wg_desc_k<kWgBlockRows>(dos, wg * kWgRows, ks),
                   wg_desc_k<kBK>(vt, 64 * n, ks));
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int n = 0; n < kKC; ++n) {
        fence_acc(sc[n]);
        fence_acc(dp[n]);
      }

      // dS = P o (dP - delta), P = exp(scale S - lse) = 2^(log2(e) (scale S
      // - lse)), into sc; masked only in a tile that reaches past Sk or the
      // diagonal; element i of sc[n] is row row0 + 8 ((i >> 1) & 1), key
      // k0 + 64n + 8 (i >> 2) + 2t + (i & 1)
      auto dscores = [&](auto masked) {
#pragma unroll
        for (int n = 0; n < kKC; ++n)
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1, key = k0 + 64 * n + 8 * (i >> 2) + 2 * t + (i & 1);
            const bool ok = !decltype(masked)::value ||
                            (key < Sk && (!causal || key <= row0 + 8 * r));
            const float p = ok ? exp2_approx(fmaf(sc[n][i], scale2, -lse2[r])) : 0.f;
            sc[n][i] = p * (dp[n][i] - dlt[r]);
          }
      };
      if (k0 + kBK <= Sk && (!causal || k0 + kBK - 1 <= qw))
        dscores(std::false_type{});
      else
        dscores(std::true_type{});

      // fp16: each row of dS times 2^e first, dQ's sum in units of 2^-e
      // (scale_rows)
      if constexpr (Elem<T>::kF16) scale_rows(sc, acc, ex);

      // dQ += dS K (scaled at the store), dS in two halves of T (lo, then
      // hi), K read MN-major from the tile S = Q K^T read K-major
      uint32_t dh[kBK / 16][4], dl[kBK / 16][4];
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) wg_split_a<T>(sc[ks / 4], ks, dh[ks], dl[ks]);
#pragma unroll
      for (int c = 0; c < kNC; ++c) fence_acc(acc[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kNC; ++c)
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
          wgmma_rs<T>(acc[c], dl[ks], wg_desc_mn<kBK>(kt, 16 * ks, c));
          wgmma_rs<T>(acc[c], dh[ks], wg_desc_mn<kBK>(kt, 16 * ks, c));
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < kNC; ++c) fence_acc(acc[c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
  }
  // dQ = scale * dS K (the TPU kernel scales at the end too)
  if constexpr (Elem<T>::kF16) unscale_rows(acc, ex);
#pragma unroll
  for (int c = 0; c < kNC; ++c) wg_store(dq, acc[c], c * kWgCols, scale, b, h, row0, Sq, H, D);
}

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// rows per warp: 4 (32 a block), or 2 (16) past D = 256, where 32 rows of
// tiles 16 columns of 32 wide would not fit in shared memory
__host__ __device__ constexpr int simt_rows(int ndc) { return ndc > 8 ? 2 : 4; }

// rows [r0, r0 + nrows) of head (b, h) of a [B,S,H,D] tensor into shared
// memory at leading dimension ld, in fp32, times mul; zeros past S and past D
template <int kDP, typename T>
__device__ void load_tile(float* dst, int ld, const T* __restrict__ src, int b, int h, int r0,
                          int nrows, int S, int H, int D, float mul) {
  for (int i = threadIdx.x; i < nrows * kDP; i += kThreads) {
    const int r = i / kDP;
    const int d = i - r * kDP;
    const int s = r0 + r;
    float x = 0.f;
    if (s < S && d < D) x = to_f32(src[row_offset(b, s, S, h, H, D) + d]) * mul;
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
template <int kDP, int kRows>
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

template <int kNDC, int kRows, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float (&acc)[kRows][kNDC],
                                           const float (&div)[kRows], int b, int h, int r0,
                                           int S, int H, int D) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = r0 + r;
    if (s >= S) continue;
    T* row = dst + row_offset(b, s, S, h, H, D);
#pragma unroll
    for (int c = 0; c < kNDC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) row[d] = from_f32<T>(acc[r][c] / div[r]);
    }
  }
}

constexpr int kOtherTile = 32;  // rows of the other axis per staged tile

template <int kNDC, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int D, float scale,
                     int causal) {
  constexpr int kRows = simt_rows(kNDC), kBlockRows = kWarps * kRows;
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
      dot4<kDP, kRows>(s, ks + (sub + lane) * kLD, my_q, kDP);
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
  store_rows<kNDC, kRows, T>(o, acc, div, b, h, row0, Sq, H, D);
}

template <int kNDC, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int Sq, int Sk, int H, int D, float scale,
                        int causal) {
  constexpr int kRows = simt_rows(kNDC), kBlockRows = kWarps * kRows;
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
      dot4<kDP, kRows>(s, ks + (sub + lane) * kLD, my_q, kDP);
      dot4<kDP, kRows>(dp, vs + (sub + lane) * kLD, my_do, kDP);
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
  store_rows<kNDC, kRows, T>(dq, acc, one, b, h, row0, Sq, H, D);
}

template <int kNDC, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
                         int D, float scale, int causal) {
  constexpr int kRows = simt_rows(kNDC), kBlockRows = kWarps * kRows;
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
      dot4<kDP, kRows>(s, qs + (sub + lane) * kLD, my_k, kDP);
      dot4<kDP, kRows>(dp, dos + (sub + lane) * kLD, my_v, kDP);
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
  store_rows<kNDC, kRows, T>(dk, dk_acc, one, b, h, key0, Sk, H, D);
  store_rows<kNDC, kRows, T>(dv, dv_acc, one, b, h, key0, Sk, H, D);
}

// ================================================================== launch

enum class Kind { kFwd, kDq, kDkv };

template <int kNDC>
size_t smem_bytes(Kind kind) {
  constexpr size_t dp = 32 * kNDC, ld = dp + 4, t = kOtherTile, rows = kWarps * simt_rows(kNDC);
  switch (kind) {
    case Kind::kFwd: return sizeof(float) * (rows * dp + t * ld + t * dp);
    case Kind::kDq: return sizeof(float) * (2 * rows * dp + 2 * t * ld);
    default: return sizeof(float) * (2 * rows * dp + 2 * t * ld + 2 * t);
  }
}

// raise the kernel's dynamic shared-memory limit once a device (the first
// launch of each instance on it, raise_smem_once); later launches, such as
// those captured into a CUDA graph, set nothing here
template <typename Kernel>
int prepare(Kernel kernel, size_t smem, bool (&raised)[kMaxDevices]) {
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem <= 48 * 1024) return 0;
  return raise_smem_once(kernel, static_cast<int>(smem), raised);
}

// device pointers of any form (float, bf16 or fp16 for q, k, v, dO, o,
// dq, dk, dv; float for lse and delta)
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *o, *dq, *dk, *dv;
  float* lse;
  int B, Sq, Sk, H, D, causal;
  float scale;
  cudaStream_t stream;
};

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// 16-byte copies and paired stores need whole 16-byte chunks a row (D a
// multiple of 4 floats or 8 2-byte elements) and 16-byte aligned rows in every
// tensor the kernel copies or stores
template <typename T>
bool vector_rows(const Args& a, Kind kind) {
  if (a.D % kPer16<T> != 0 || !aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v)) return false;
  switch (kind) {
    case Kind::kFwd: return aligned16(a.o);
    case Kind::kDq: return aligned16(a.dout) && aligned16(a.dq);
    default: return aligned16(a.dout) && aligned16(a.dk) && aligned16(a.dv);
  }
}

template <typename T>
const T* in(const void* p) { return static_cast<const T*>(p); }
template <typename T>
T* out(void* p) { return static_cast<T*>(p); }

// the limit-raised flags of a launcher's three kernels, by device
using Raised = bool[3][kMaxDevices];

template <int kDP, typename T>
int launch_tc(Kind kind, const Args& a) {
  static Raised ready = {};
  const int vec = vector_rows<T>(a, kind) ? 1 : 0;
  int rc = 0;
  if (kind == Kind::kFwd) {
    const size_t smem = fwd_tc_smem<kDP, T>();
    rc = prepare(flash_fwd_tc_kernel<kDP, T>, smem, ready[0]);
    if (rc) return rc;
    const dim3 grid((a.Sq + kTcRows - 1) / kTcRows, a.H, a.B);
    flash_fwd_tc_kernel<kDP, T><<<grid, kTcThreads, smem, a.stream>>>(
        in<T>(a.q), in<T>(a.k), in<T>(a.v), out<T>(a.o), a.lse, a.Sq, a.Sk, a.H, a.D, a.scale,
        a.causal, vec);
  } else if (kind == Kind::kDq) {
    const size_t smem = dq_tc_smem<kDP, T>();
    rc = prepare(flash_bwd_dq_tc_kernel<kDP, T>, smem, ready[1]);
    if (rc) return rc;
    const dim3 grid((a.Sq + kTcRows - 1) / kTcRows, a.H, a.B);
    flash_bwd_dq_tc_kernel<kDP, T><<<grid, kTcThreads, smem, a.stream>>>(
        in<T>(a.q), in<T>(a.k), in<T>(a.v), in<T>(a.dout), a.lse_in, a.delta, out<T>(a.dq),
        a.Sq, a.Sk, a.H, a.D, a.scale, a.causal, vec);
  } else {
    const size_t smem = dkv_tc_smem<kDP, T>();
    rc = prepare(flash_bwd_dkv_tc_kernel<kDP, T>, smem, ready[2]);
    if (rc) return rc;
    const dim3 grid((a.Sk + kTcRows - 1) / kTcRows, a.H, a.B);
    flash_bwd_dkv_tc_kernel<kDP, T><<<grid, kTcThreads, smem, a.stream>>>(
        in<T>(a.q), in<T>(a.k), in<T>(a.v), in<T>(a.dout), a.lse_in, a.delta, out<T>(a.dk),
        out<T>(a.dv), a.Sq, a.Sk, a.H, a.D, a.scale, a.causal, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// Which body a call takes. The bf16 and fp16 forward, dQ and dK/dV take
// the wgmma bodies where their tensors suit TMA: 32 < D <= 128 with
// D % 8 == 0 (a head's row is whole 16-byte chunks, and so is every
// stride of the tensor map) and the base of every tensor the kind reads
// or writes 16-byte aligned (vector_rows). Other calls at D <= 128 keep
// the mma.sync bodies: the fp32 forms, and 2-byte calls with D <= 32 (a
// 64-column tile would be mostly padding), D % 8 != 0 or a misaligned
// view. D > 128 runs on the CUDA cores.
enum class Body { kMmaSync = 0, kWgmma = 1, kCudaCores = 2 };
// the forms, as ff_flash_body numbers them
enum class Form { kF32 = 0, kBf16 = 1, kF16 = 2 };

Body body_of(Form form, Kind kind, const Args& a) {
  if (a.D > 128) return Body::kCudaCores;
  if (form == Form::kF32 || a.D <= 32) return Body::kMmaSync;
  return vector_rows<bf16>(a, kind) ? Body::kWgmma : Body::kMmaSync;  // any 2-byte type
}

template <typename T>
constexpr Form form_of() {
  return std::is_same<T, float>::value ? Form::kF32
         : std::is_same<T, bf16>::value ? Form::kBf16
                                        : Form::kF16;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once a process through
// the runtime (the library does not link libcuda); null where it has none
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 4-D tensor map (D, H, S, B innermost first) of a [B,S,H,D] tensor of
// a 2-byte type in place, whose box is `rows` rows of 64 columns of one
// head, written with the 128-byte swizzle; reads past S or D fill zeros
int tile_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int B, int S, int H,
             int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * static_cast<cuuint64_t>(H) * D;  // bytes between rows of a head
  const cuuint64_t strides[3] = {2ull * D, row, row * S};
  const cuuint32_t box[4] = {kWgCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, 4, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// the wgmma bodies of T (bf16 or fp16), head dims padded to 64 or 128
template <int kDP, typename T>
int launch_wg(Kind kind, const Args& a) {
  static Raised ready = {};
  constexpr CUtensorMapDataType kType = Elem<T>::kTma;
  // the rows of each tensor map's box: the block's own 64 rows, or a tile
  // of the axis that streams through the ring
  const int q_rows = kind == Kind::kDkv ? kWgDkvQueries : kWgBlockRows;
  const int kv_rows = kind == Kind::kFwd  ? kWgFwdKeys
                      : kind == Kind::kDq ? kWgDqKeys
                                          : kWgBlockRows;
  CUtensorMap tq, tk, tv, tdo;
  int rc = tile_map(&tq, kType, a.q, a.B, a.Sq, a.H, a.D, q_rows);
  if (!rc) rc = tile_map(&tk, kType, a.k, a.B, a.Sk, a.H, a.D, kv_rows);
  if (!rc) rc = tile_map(&tv, kType, a.v, a.B, a.Sk, a.H, a.D, kv_rows);
  if (!rc && kind != Kind::kFwd) rc = tile_map(&tdo, kType, a.dout, a.B, a.Sq, a.H, a.D, q_rows);
  if (rc) return rc;
  if (kind == Kind::kFwd) {
    const size_t smem = fwd_wg_smem<kDP, T>();
    rc = prepare(flash_fwd_wg_kernel<kDP, T>, smem, ready[0]);
    if (rc) return rc;
    const dim3 grid((a.Sq + kWgBlockRows - 1) / kWgBlockRows, a.H, a.B);
    flash_fwd_wg_kernel<kDP, T><<<grid, kWgThreads, smem, a.stream>>>(
        tq, tk, tv, out<T>(a.o), a.lse, a.Sq, a.Sk, a.H, a.D, a.scale, a.causal);
  } else if (kind == Kind::kDq) {
    const size_t smem = dq_wg_smem<kDP, T>();
    rc = prepare(flash_bwd_dq_wg_kernel<kDP, T>, smem, ready[1]);
    if (rc) return rc;
    const dim3 grid((a.Sq + kWgBlockRows - 1) / kWgBlockRows, a.H, a.B);
    flash_bwd_dq_wg_kernel<kDP, T><<<grid, kWgThreads, smem, a.stream>>>(
        tq, tk, tv, tdo, a.lse_in, a.delta, out<T>(a.dq), a.Sq, a.Sk, a.H, a.D, a.scale,
        a.causal);
  } else {
    const size_t smem = dkv_wg_smem<kDP, T>();
    rc = prepare(flash_bwd_dkv_wg_kernel<kDP, T>, smem, ready[2]);
    if (rc) return rc;
    const dim3 grid((a.Sk + kWgBlockRows - 1) / kWgBlockRows, a.H, a.B);
    flash_bwd_dkv_wg_kernel<kDP, T><<<grid, kWgThreads, smem, a.stream>>>(
        tq, tk, tv, tdo, a.lse_in, a.delta, out<T>(a.dk), out<T>(a.dv), a.Sq, a.Sk, a.H,
        a.D, a.scale, a.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

// blocks of a wgmma kernel an SM holds at its shared memory, by the
// occupancy calculator; -1 if it cannot say
template <typename Kernel>
int blocks_per_sm(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kWgThreads, smem) ==
                 cudaSuccess
             ? n
             : -1;
}

// the CUDA-core kernels, D > 128 (kNDC = 5..8, 12 or 16 columns of 32)
template <int kNDC, typename T>
int launch_simt(Kind kind, const Args& a) {
  static_assert(kNDC > 4, "D <= 128 takes the tensor cores");
  const size_t smem = smem_bytes<kNDC>(kind);
  const int rows = kWarps * simt_rows(kNDC);  // of the block's own axis
  static Raised ready = {};
  bool(&r)[kMaxDevices] = ready[static_cast<int>(kind)];
  int rc = 0;
  if (kind == Kind::kFwd) {
    rc = prepare(flash_fwd_kernel<kNDC, T>, smem, r);
    if (rc) return rc;
    const dim3 grid((a.Sq + rows - 1) / rows, a.H, a.B);
    flash_fwd_kernel<kNDC, T><<<grid, kThreads, smem, a.stream>>>(
        in<T>(a.q), in<T>(a.k), in<T>(a.v), out<T>(a.o), a.lse, a.Sq, a.Sk, a.H, a.D, a.scale,
        a.causal);
  } else if (kind == Kind::kDq) {
    rc = prepare(flash_bwd_dq_kernel<kNDC, T>, smem, r);
    if (rc) return rc;
    const dim3 grid((a.Sq + rows - 1) / rows, a.H, a.B);
    flash_bwd_dq_kernel<kNDC, T><<<grid, kThreads, smem, a.stream>>>(
        in<T>(a.q), in<T>(a.k), in<T>(a.v), in<T>(a.dout), a.lse_in, a.delta, out<T>(a.dq),
        a.Sq, a.Sk, a.H, a.D, a.scale, a.causal);
  } else {
    rc = prepare(flash_bwd_dkv_kernel<kNDC, T>, smem, r);
    if (rc) return rc;
    const dim3 grid((a.Sk + rows - 1) / rows, a.H, a.B);
    flash_bwd_dkv_kernel<kNDC, T><<<grid, kThreads, smem, a.stream>>>(
        in<T>(a.q), in<T>(a.k), in<T>(a.v), in<T>(a.dout), a.lse_in, a.delta, out<T>(a.dk),
        out<T>(a.dv), a.Sq, a.Sk, a.H, a.D, a.scale, a.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(Kind kind, const Args& a) {
  if (a.B < 1 || a.Sq < 1 || a.Sk < 1 || a.H < 1 || a.D < 1 || a.D > kMaxHeadDim ||
      a.B > 65535 || a.H > 65535 || (a.causal && a.Sq != a.Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (!std::is_same<T, float>::value) {
    if (body_of(form_of<T>(), kind, a) == Body::kWgmma)
      return a.D <= 64 ? launch_wg<64, T>(kind, a) : launch_wg<128, T>(kind, a);
  }
  if (a.D <= 32) return launch_tc<32, T>(kind, a);
  if (a.D <= 64) return launch_tc<64, T>(kind, a);
  if (a.D <= 96) return launch_tc<96, T>(kind, a);
  if (a.D <= 128) return launch_tc<128, T>(kind, a);
  switch ((a.D + 31) / 32) {
    case 5: return launch_simt<5, T>(kind, a);
    case 6: return launch_simt<6, T>(kind, a);
    case 7: return launch_simt<7, T>(kind, a);
    case 8: return launch_simt<8, T>(kind, a);
    case 9: case 10: case 11: case 12: return launch_simt<12, T>(kind, a);
    default: return launch_simt<16, T>(kind, a);
  }
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq, int Sk,
        int H, int D, float scale, int causal, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr, nullptr, nullptr, lse,
         B, Sq, Sk, H, D, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<T>(Kind::kFwd, a);
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, int B, int Sq, int Sk, int H, int D, float scale,
           int causal, void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, dq, nullptr, nullptr, nullptr,
         B, Sq, Sk, H, D, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<T>(Kind::kDq, a);
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, int D,
            float scale, int causal, void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, nullptr, dk, dv, nullptr,
         B, Sq, Sk, H, D, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<T>(Kind::kDkv, a);
}

}  // namespace

// Plain C interface, bound with ctypes (flexflow_tpu_torch/ops/kernels/_build.py).
// The build compiles this file once per form, in parallel, with
// FF_FLASH_FORM set to 0 (fp32), 1 (bf16, with the two queries) or 2
// (fp16), and links the three objects into one library; each object then
// instantiates only its form's kernels. Without FF_FLASH_FORM the file
// holds every function.
// Every pointer is a device pointer to contiguous data: q, dout, o, dq
// [B,Sq,H,D]; k, v, dk, dv [B,Sk,H,D], fp32 in the _f32 form, bf16 in the
// _bf16 form and fp16 in the _f16 form; lse, delta [B,Sq,H] fp32 in all
// three. stream is a cudaStream_t. Each launch runs on the current device
// and returns the cudaError_t of its launch (0 on success).

// The body a launch with these arguments takes (body_of): 0 the mma.sync
// tensor-core body, 1 the wgmma body, 2 the CUDA cores. form 0 is fp32, 1
// bf16, 2 fp16; kind 0 is the forward (out0 = o), 1 dQ (out0 = dq), 2
// dK/dV (out0 = dk, out1 = dv).
#if !defined(FF_FLASH_FORM) || FF_FLASH_FORM == 1
extern "C" int ff_flash_body(int form, int kind, const void* q, const void* k, const void* v,
                             const void* dout, const void* out0, const void* out1, int D) {
  Args a{q, k, v, dout, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         1, 1, 1, 1, D, 0, 1.f, nullptr};
  const Kind kinds[3] = {Kind::kFwd, Kind::kDq, Kind::kDkv};
  if (kind < 0 || kind > 2 || form < 0 || form > 2) return -1;
  if (kind == 0) a.o = const_cast<void*>(out0);
  if (kind == 1) a.dq = const_cast<void*>(out0);
  if (kind == 2) {
    a.dk = const_cast<void*>(out0);
    a.dv = const_cast<void*>(out1);
  }
  return static_cast<int>(body_of(static_cast<Form>(form), kinds[kind], a));
}

// Blocks an SM holds of the bf16 wgmma forward (kind 0), dQ (kind 1) or
// dK/dV (kind 2) instance for head dim D (32 < D <= 128), the fp16 ones'
// too (the same shared memory and register budget); -1 otherwise or on an
// error.
extern "C" int ff_flash_wg_blocks_per_sm(int kind, int D) {
  if (D <= 32 || D > 128 || kind < 0 || kind > 2) return -1;
  if (kind == 0)
    return D <= 64 ? blocks_per_sm(flash_fwd_wg_kernel<64, bf16>, fwd_wg_smem<64, bf16>())
                   : blocks_per_sm(flash_fwd_wg_kernel<128, bf16>, fwd_wg_smem<128, bf16>());
  if (kind == 1)
    return D <= 64 ? blocks_per_sm(flash_bwd_dq_wg_kernel<64, bf16>, dq_wg_smem<64, bf16>())
                   : blocks_per_sm(flash_bwd_dq_wg_kernel<128, bf16>, dq_wg_smem<128, bf16>());
  return D <= 64 ? blocks_per_sm(flash_bwd_dkv_wg_kernel<64, bf16>, dkv_wg_smem<64, bf16>())
                 : blocks_per_sm(flash_bwd_dkv_wg_kernel<128, bf16>, dkv_wg_smem<128, bf16>());
}

#endif

#if !defined(FF_FLASH_FORM) || FF_FLASH_FORM == 0
extern "C" int ff_flash_fwd_f32(const float* q, const float* k, const float* v, float* o,
                                float* lse, int B, int Sq, int Sk, int H, int D, float scale,
                                int causal, void* stream) {
  return fwd<float>(q, k, v, o, lse, B, Sq, Sk, H, D, scale, causal, stream);
}

extern "C" int ff_flash_bwd_dq_f32(const float* q, const float* k, const float* v,
                                   const float* dout, const float* lse, const float* delta,
                                   float* dq, int B, int Sq, int Sk, int H, int D, float scale,
                                   int causal, void* stream) {
  return bwd_dq<float>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, D, scale, causal, stream);
}

extern "C" int ff_flash_bwd_dkv_f32(const float* q, const float* k, const float* v,
                                    const float* dout, const float* lse, const float* delta,
                                    float* dk, float* dv, int B, int Sq, int Sk, int H, int D,
                                    float scale, int causal, void* stream) {
  return bwd_dkv<float>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, D, scale, causal,
                        stream);
}

#endif

#if !defined(FF_FLASH_FORM) || FF_FLASH_FORM == 1
extern "C" int ff_flash_fwd_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                                 float* lse, int B, int Sq, int Sk, int H, int D, float scale,
                                 int causal, void* stream) {
  return fwd<bf16>(q, k, v, o, lse, B, Sq, Sk, H, D, scale, causal, stream);
}

extern "C" int ff_flash_bwd_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                                    const bf16* dout, const float* lse, const float* delta,
                                    bf16* dq, int B, int Sq, int Sk, int H, int D, float scale,
                                    int causal, void* stream) {
  return bwd_dq<bf16>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, D, scale, causal, stream);
}

extern "C" int ff_flash_bwd_dkv_bf16(const bf16* q, const bf16* k, const bf16* v,
                                     const bf16* dout, const float* lse, const float* delta,
                                     bf16* dk, bf16* dv, int B, int Sq, int Sk, int H, int D,
                                     float scale, int causal, void* stream) {
  return bwd_dkv<bf16>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, D, scale, causal,
                       stream);
}

#endif

#if !defined(FF_FLASH_FORM) || FF_FLASH_FORM == 2
extern "C" int ff_flash_fwd_f16(const f16* q, const f16* k, const f16* v, f16* o, float* lse,
                                int B, int Sq, int Sk, int H, int D, float scale, int causal,
                                void* stream) {
  return fwd<f16>(q, k, v, o, lse, B, Sq, Sk, H, D, scale, causal, stream);
}

extern "C" int ff_flash_bwd_dq_f16(const f16* q, const f16* k, const f16* v, const f16* dout,
                                   const float* lse, const float* delta, f16* dq, int B, int Sq,
                                   int Sk, int H, int D, float scale, int causal, void* stream) {
  return bwd_dq<f16>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, D, scale, causal, stream);
}

extern "C" int ff_flash_bwd_dkv_f16(const f16* q, const f16* k, const f16* v, const f16* dout,
                                    const float* lse, const float* delta, f16* dk, f16* dv,
                                    int B, int Sq, int Sk, int H, int D, float scale, int causal,
                                    void* stream) {
  return bwd_dkv<f16>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, D, scale, causal,
                      stream);
}
#endif
