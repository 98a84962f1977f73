// The 128-byte-swizzled shared-memory tiles that the tensor-core kernels
// hand to wgmma, the descriptors that name them, and the bf16 parts in
// which an f32 operand enters a product.  A tile of `rows` rows of bf16
// is stored as column blocks of 64 columns (128 bytes a row), each block
// rows x 128 B and 1024-byte aligned, with the 16-byte chunk c of row r
// stored at chunk c ^ (r % 8).  Plain arithmetic, no PTX (include
// hopper.cuh first, for pack_bf16x2): the CPU emulation uses this header
// as it is.
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

// (u, v) as N packed bf16 pairs, hi first: part s = bf16(a - the parts
// before it), rounded to nearest even.  Three parts give back a normal
// f32 exactly (8 + 8 + 8 significant bits; below 2^-110 the bits under
// bf16's smallest subnormal, 2^-133, are lost); two give it to 2^-17
// relative, one to 2^-9.
template <int N>
__device__ __forceinline__ void split_parts(float u, float v,
                                           uint32_t (&p)[N]) {
#pragma unroll
  for (int s = 0; s < N; ++s) {
    p[s] = pack_bf16x2(u, v);
    u -= __uint_as_float(p[s] << 16);
    v -= __uint_as_float(p[s] & 0xffff0000u);
  }
}

// The cross products a_i·b_j kept of an operand in PA parts times one in
// PB parts: those with i + j < K = max(PA, PB).  A part i is below
// 2^-9i of its value, so each dropped term is below 2^-9K |a b|.
// f(i, j, first) runs smallest first (i + j descending; LOW_FIRST =
// false reverses the order, for the probe that measures it), so that the
// tensor cores' f32 accumulator, which loses low-order bits as it grows,
// sums the low parts while it is still small; `first` marks the product
// that starts an accumulator.
template <int PA, int PB, bool LOW_FIRST = true, class F>
__device__ __forceinline__ void for_parts(F&& f) {
  constexpr int K = PA > PB ? PA : PB;
  bool first = true;
#pragma unroll
  for (int e = 0; e < K; ++e)
#pragma unroll
    for (int i = 0; i < PA; ++i) {
      const int d = LOW_FIRST ? K - 1 - e : e;
      const int j = d - i;
      if (j < 0 || j >= PB) continue;
      f(i, j, first);
      first = false;
    }
}

}  // namespace wg
