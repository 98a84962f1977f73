// Host emulation of the part of the CUDA driver API's <cuda.h> that the
// port's warp-specialised kernels use: the tensor-map types, found ahead
// of the toolkit's header by putting this directory on the include path,
// and emu_tensor_map_encode_tiled, which takes cuTensorMapEncodeTiled's
// arguments, refuses what the CUDA driver documents it refuses (an address
// not 16-byte aligned, a stride not a multiple of 16 bytes or past 2^40,
// a box dimension past 256, an inner box row wider than the swizzle, an
// element stride other than 1) and keeps the map for hopper.cuh's
// emulated tma_load_4d.
#pragma once
#include <cstdint>

typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
typedef int CUresult;
enum { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle {
  CU_TENSOR_MAP_SWIZZLE_NONE = 0,
  CU_TENSOR_MAP_SWIZZLE_128B = 3
};
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_L2_256B = 3 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };

struct alignas(64) CUtensorMap {
  const unsigned char* base;
  int rank, elem, swizzle;
  uint64_t dims[5];
  uint64_t strides[4];  // bytes, of dims 1..rank-1
  uint32_t box[5];
};

inline CUresult emu_tensor_map_encode_tiled(
    CUtensorMap* m, CUtensorMapDataType type, cuuint32_t rank, void* addr,
    const cuuint64_t* dims, const cuuint64_t* strides,
    const cuuint32_t* box, const cuuint32_t* estr, CUtensorMapInterleave,
    CUtensorMapSwizzle swizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill) {
  if (type != CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 || rank < 1 || rank > 5 ||
      reinterpret_cast<uintptr_t>(addr) % 16)
    return CUDA_ERROR_INVALID_VALUE;
  *m = CUtensorMap{};
  m->base = static_cast<const unsigned char*>(addr);
  m->rank = static_cast<int>(rank);
  m->elem = 2;
  m->swizzle = swizzle == CU_TENSOR_MAP_SWIZZLE_128B;
  for (cuuint32_t i = 0; i < rank; ++i) {
    if (dims[i] < 1 || dims[i] > (1ull << 32) || box[i] < 1 ||
        box[i] > 256 || estr[i] != 1)
      return CUDA_ERROR_INVALID_VALUE;
    m->dims[i] = dims[i];
    m->box[i] = box[i];
    if (i + 1 < rank) {
      if (strides[i] % 16 || strides[i] >= (1ull << 40))
        return CUDA_ERROR_INVALID_VALUE;
      m->strides[i] = strides[i];
    }
  }
  if (m->swizzle && box[0] * m->elem > 128) return CUDA_ERROR_INVALID_VALUE;
  return CUDA_SUCCESS;
}
