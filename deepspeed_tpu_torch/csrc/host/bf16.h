// Shared fp32 -> bf16 conversion for host-side optimizer copy-back.
// Round-to-nearest-even, with NaN preserved as a quiet NaN (the rounding
// bias would otherwise carry a NaN mantissa into the exponent -> +/-Inf,
// masking divergence from overflow detection).
#pragma once

#include <cstdint>
#include <cstring>

inline uint16_t f32_to_bf16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, sizeof(bits));
  if ((bits & 0x7FFFFFFF) > 0x7F800000) return static_cast<uint16_t>((bits >> 16) | 0x0040);
  uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
  return static_cast<uint16_t>((bits + rounding) >> 16);
}
