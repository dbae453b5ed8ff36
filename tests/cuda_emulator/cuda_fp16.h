// CPU stand-in for the fp16 types: their bits, widened exactly and
// rounded to nearest even, subnormals and overflow to infinity included
// (see cuda_runtime.h).
#pragma once
#include "cuda_runtime.h"
struct __half { unsigned short x; };
struct __half2 { __half x, y; };
inline __half __ushort_as_half(unsigned short u) { return {u}; }
inline unsigned short __half_as_ushort(__half h) { return h.x; }
inline float __half2float(__half h) { return emu_half_bits(h.x); }
inline unsigned short emu_float2half(float f) {
  const unsigned u = __float_as_uint(f), a = u & 0x7fffffffu;
  const unsigned short sign = static_cast<unsigned short>((u >> 16) & 0x8000u);
  if (a > 0x7f800000u) return sign | 0x7e00u;  // NaN
  if (a >= 0x477ff000u) return sign | 0x7c00u;  // from 65520 up: infinity
  if (a >= 0x38800000u) {  // normal: rebias the exponent, round off 13 bits
    const unsigned r = a - 0x38000000u;
    return sign | static_cast<unsigned short>((r + 0xfffu + ((r >> 13) & 1u)) >> 13);
  }
  // below 2^-14: a multiple of 2^-24 (the round may reach 2^-14, a normal)
  return sign | static_cast<unsigned short>(std::nearbyint(__uint_as_float(a) * 16777216.f));
}
inline __half __float2half_rn(float f) { return {emu_float2half(f)}; }
inline __half2 __floats2half2_rn(float a, float b) { return {{emu_float2half(a)}, {emu_float2half(b)}}; }
inline float __low2float(__half2 v) { return __half2float(v.x); }
inline float __high2float(__half2 v) { return __half2float(v.y); }
