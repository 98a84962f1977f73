// The 128-byte-swizzled shared-memory tiles that the tensor-core kernels
// hand to wgmma, and the descriptors that name them.  A tile of `rows`
// rows of bf16 is stored as column blocks of 64 columns (128 bytes a
// row), each block rows x 128 B and 1024-byte aligned, with the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8).  Plain arithmetic, no
// PTX: the CPU emulation uses this header as it is.
#pragma once
#include <stdint.h>

namespace wg {

// Byte offset of 16-byte chunk cc (columns 8cc..8cc+7) of row r.
__host__ __device__ __forceinline__ uint32_t sw128(int r, int cc,
                                                   int rows = 64) {
  return static_cast<uint32_t>((cc >> 3) * rows * 128 + r * 128 +
                               (((cc & 7) ^ (r & 7)) << 4));
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (each >> 4), layout type 1 in bits
// 62-63.
__host__ __device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                                        uint32_t lbo,
                                                        uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

}  // namespace wg
