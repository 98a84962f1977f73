// Host emulation of the part of <cuda_bf16.h> the port's kernels use:
// the bf16 storage type and its conversions to and from float (round to
// nearest even, NaN kept quiet), found ahead of the toolkit's header by
// putting this directory on the include path.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t x;
};

inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = static_cast<uint32_t>(h.x) << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}

inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u)
    return {static_cast<uint16_t>((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<uint16_t>(u >> 16)};
}
