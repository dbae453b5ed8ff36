// CPU stand-in for the fp16 type: its bits, widened exactly (see cuda_runtime.h).
#pragma once
#include "cuda_runtime.h"
struct __half { unsigned short x; };
inline __half __ushort_as_half(unsigned short u) { return {u}; }
inline float __half2float(__half h) {
  const unsigned s = (h.x >> 15) & 1, e = (h.x >> 10) & 31, m = h.x & 1023;
  float v;
  if (e == 0) v = std::ldexp(static_cast<float>(m), -24);
  else if (e == 31) v = m ? NAN : INFINITY;
  else v = std::ldexp(static_cast<float>(m | 1024), static_cast<int>(e) - 25);
  return s ? -v : v;
}
