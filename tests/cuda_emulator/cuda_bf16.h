// CPU stand-in for the bf16 type: its bits (see cuda_runtime.h).
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { unsigned short x; };
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.x; }
