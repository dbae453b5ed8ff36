// Helpers shared by the port's CUDA kernels for Hopper (sm_90a): the
// shared-memory limit, warp reductions, cp.async copies from device to
// shared memory, and the TF32 tensor-core products (mma.sync m16n8k8)
// that the flash kernels and the paged kernel's wide-window body take to
// fp32 accuracy. Each .cu file includes this once and builds into its own
// library (ops/kernels/_build.py), so everything here is internal to the
// including file.
#pragma once

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

}  // namespace
