// CPU stand-in for the bf16 types: their bits, rounded to nearest even
// (see cuda_runtime.h).
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.x; }
inline unsigned short emu_float2bf16(float f) {
  const unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;  // NaN
  return static_cast<unsigned short>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return {emu_float2bf16(f)}; }
inline float __bfloat162float(__nv_bfloat16 b) { return __uint_as_float(static_cast<unsigned>(b.x) << 16); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {{emu_float2bf16(a)}, {emu_float2bf16(b)}};
}
inline float __low2float(__nv_bfloat162 v) { return __bfloat162float(v.x); }
inline float __high2float(__nv_bfloat162 v) { return __bfloat162float(v.y); }
