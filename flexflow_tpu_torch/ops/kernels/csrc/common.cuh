// Helpers shared by the port's CUDA kernels for Hopper (sm_90a): the
// shared-memory limit, warp reductions, cp.async copies from device to
// shared memory, the TF32 tensor-core products (mma.sync m16n8k8) that
// the flash kernels and the paged kernel's wide-window body take to fp32
// accuracy, and the pieces of the bf16 flash bodies: mbarriers, TMA tile
// copies, warpgroup bf16 products (wgmma m64n64k16) and the split of an
// fp32 operand into two bf16 halves. Each .cu file includes this once and
// builds into its own library (ops/kernels/_build.py), so everything here
// is internal to the including file.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemLimit = 232448;  // bytes of shared memory a block can use on sm_90

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every committed group of this thread's copies has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ============================================ TF32 tensor-core products

// a bf16 or fp16 input is a TF32 value exactly: its products need no split
template <typename T>
constexpr bool kExact = !std::is_same<T, float>::value;

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

// an input element as a TF32 operand: a float times mul, split; a bf16 is
// its own TF32 value (its bits in the high half), an fp16 its value widened
// to fp32 (10 mantissa bits, as TF32 keeps), and small is never read (mul
// is 1 for a 2-byte input: those kernels scale the scores or the queries)
__device__ __forceinline__ void split_in(float x, float mul, uint32_t& big, uint32_t& small) {
  split_tf32(x * mul, big, small);
}
__device__ __forceinline__ void split_in(bf16 x, float, uint32_t& big, uint32_t& small) {
  big = static_cast<uint32_t>(__bfloat16_as_ushort(x)) << 16;
  small = 0u;
}
__device__ __forceinline__ void split_in(f16 x, float, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(__half2float(x));
  small = 0u;
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

// c += a b to fp32 accuracy: big*small + small*big + big*big, in that
// order, leaving out the small part of an exact operand (kExactA, kExactB:
// a 2-byte input), so the product of two exact operands is one mma
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma_acc(float (&c)[4], const FragA& a, const FragB& b) {
  if constexpr (!kExactB) mma_tf32(c, a.big, b.small);
  if constexpr (!kExactA) mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.big);
}

// A fragment of the 16 x 8 tile at p (row major, leading dimension ld), times mul
template <typename T>
__device__ __forceinline__ void load_a(FragA& f, const T* p, int ld, float mul) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  split_in(p[g * ld + t], mul, f.big[0], f.small[0]);
  split_in(p[(g + 8) * ld + t], mul, f.big[1], f.small[1]);
  split_in(p[g * ld + t + 4], mul, f.big[2], f.small[2]);
  split_in(p[(g + 8) * ld + t + 4], mul, f.big[3], f.small[3]);
}

// B fragment whose element (k, n) is p[n * ld + k] (a K^T tile: rows of p
// are the product's columns)
template <typename T>
__device__ __forceinline__ void load_b_nk(FragB& f, const T* p, int ld) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  split_in(p[g * ld + t], 1.f, f.big[0], f.small[0]);
  split_in(p[g * ld + t + 4], 1.f, f.big[1], f.small[1]);
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

template <typename T>
__device__ __forceinline__ void load_b_kn_permuted(FragB& f, const T* p, int ld) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  split_in(p[2 * t * ld + g], 1.f, f.big[0], f.small[0]);
  split_in(p[(2 * t + 1) * ld + g], 1.f, f.big[1], f.small[1]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// ================================= Hopper: mbarrier, TMA, bf16 wgmma

// Shared-memory barriers that count arrivals and the bytes of TMA copies
// (mbarrier). A phase completes when every expected thread has arrived
// and every byte announced by expect_tx has landed; waiting on parity p
// returns once the phase of that parity has completed (p = 1 passes at
// once on a fresh barrier).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// the inits visible to the other threads and to the TMA unit
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// announce `bytes` of copies to come, and arrive
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// an arrival on bar once every cp.async this thread started before has
// landed (counted among the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// 2^x by the SFU (ex2.approx, about 2 ulp; results below 2^-126 flush to
// zero): the softmax of the bf16 bodies in base 2, on log2(e)-scaled scores
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// TMA: the box at coordinates (c0, c1, c2, c3) of a 4-D tensor map into
// shared memory at dst (1024-byte aligned for the 128-byte swizzle),
// completing its bytes on bar; elements past the tensor's bounds land as
// zeros
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory matrix descriptor of a tile written by TMA with
// the 128-byte swizzle: rows of 64 bf16 (128 bytes), 8-row groups of
// 1024 bytes, the 16-byte chunks of row r XORed with r % 8. Fields (in
// 16-byte units): start address, leading byte offset (lbo), stride byte
// offset (sbo), layout 1 = 128-byte swizzle.
//   K-major operand (the reduction index along a row): sbo = 1024 between
//     8-row groups; lbo unused (1); the 16-wide k step at +32 bytes.
//   MN-major operand (the reduction index down the rows): sbo = 1024
//     between groups of 8 reduction rows, lbo between 64-column blocks.
__device__ __forceinline__ uint64_t gmma_desc(const void* tile, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// wgmma's operands in flight: fence before a batch (after registers it
// reads were written), commit the batch, wait for all of it
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving the accumulators' reads or writes across
// a wgmma batch
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FF_ACC8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define FF_ACC_REGS                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d += A B for the warpgroup's 64 x 64 x 16 tile, bf16 operands, fp32
// accumulator d (element i of warp w's thread (g, t) = lane (4g + t) is
// row 16w + g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2t + (i & 1)).
// A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FF_ACC_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FF_ACC8(0), FF_ACC8(8), FF_ACC8(16), FF_ACC8(24)
      : "l"(a), "l"(b), "r"(1));
}

// The same with A from registers (per warp the 16 x 16 fragment of
// mma.m16n8k16: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3
// (g+8, 2t+8..), two bf16 a register, the lower column in the low half;
// an accumulator's columns 16s..16s+15 are exactly this layout) and B
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FF_ACC_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FF_ACC8(0), FF_ACC8(8), FF_ACC8(16), FF_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef FF_ACC8
#undef FF_ACC_REGS

// Two fp32 values as two bf16 halves each: hi = bf16(x), lo = bf16(x - hi)
// (x - hi is exact in fp32), so x = hi + lo + e with |e| <= 2^-16 |x|
// (each rounding to nearest errs by at most 2^-8 of its input): a product
// taken as lo*b + hi*b with bf16 b keeps x to 2^-16, where bf16(x) alone
// keeps it to 2^-8. Packed as an A-fragment register: x0 in the low half.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

}  // namespace
