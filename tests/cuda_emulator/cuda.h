// CPU stand-in for cuda.h's tensor maps (see cuda_runtime.h):
// CUtensorMap holds what TMA needs to copy a box (base, dims, strides,
// box, element size, swizzle), packed by the stand-in
// cuTensorMapEncodeTiled, which refuses what libcuda's refuses for the
// modes the kernels use.
#pragma once
#include <cstdint>
#include <cstring>

typedef int CUresult;
constexpr CUresult CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1;
typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
struct alignas(64) CUtensorMap { unsigned long long opaque[16]; };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_FLOAT32 = 7, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle {
  CU_TENSOR_MAP_SWIZZLE_NONE = 0, CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_SWIZZLE_64B,
  CU_TENSOR_MAP_SWIZZLE_128B
};
enum CUtensorMapL2promotion {
  CU_TENSOR_MAP_L2_PROMOTION_NONE = 0, CU_TENSOR_MAP_L2_PROMOTION_L2_64B,
  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B
};
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };

struct EmuTensorMap {
  const unsigned char* base;
  uint32_t rank, esize, swizzle_bytes;
  uint64_t dims[5], strides[5];  // strides in bytes, strides[0] = esize
  uint32_t box[5];
};
static_assert(sizeof(EmuTensorMap) <= sizeof(CUtensorMap), "the packed map fits a CUtensorMap");

inline CUresult emu_encode_tiled(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank,
                                 void* base, const cuuint64_t* dims, const cuuint64_t* strides,
                                 const cuuint32_t* box, const cuuint32_t* elem_strides,
                                 CUtensorMapInterleave interleave, CUtensorMapSwizzle swizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill fill) {
  EmuTensorMap m{};
  m.esize = type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2 : type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 0;
  const uint32_t sw[4] = {0, 32, 64, 128};
  m.swizzle_bytes = sw[swizzle];
  if (m.esize == 0 || rank < 1 || rank > 5 || interleave != CU_TENSOR_MAP_INTERLEAVE_NONE ||
      fill != CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE || (reinterpret_cast<uintptr_t>(base) & 15) ||
      (box[0] * m.esize) % 16 || (m.swizzle_bytes && box[0] * m.esize > m.swizzle_bytes))
    return CUDA_ERROR_INVALID_VALUE;
  m.base = static_cast<const unsigned char*>(base);
  m.rank = rank;
  for (uint32_t i = 0; i < rank; ++i) {
    if (box[i] < 1 || box[i] > 256 || elem_strides[i] != 1 || dims[i] < 1) return CUDA_ERROR_INVALID_VALUE;
    if (i > 0 && strides[i - 1] % 16) return CUDA_ERROR_INVALID_VALUE;
    m.dims[i] = dims[i];
    m.strides[i] = i == 0 ? m.esize : strides[i - 1];
    m.box[i] = box[i];
  }
  std::memset(map, 0, sizeof(*map));
  std::memcpy(map, &m, sizeof(m));
  return CUDA_SUCCESS;
}
