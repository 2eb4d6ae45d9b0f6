// Shared device helpers for the XA decode kernels: gain tables, the 4/6/8-bit
// payload unpack, int16 sign extension and one step of the two-tap ADPCM
// prediction filter.
//
// Integer semantics are the reference's (src/libbjxa.c:533-578) and those
// of the plain PyTorch versions in bjxa_tpu_torch/ops/filter.py, bit for bit:
//   s = clamp_i16(ranged + trunc((p0*k0 + p1*k1) / 256)); p1 = p0; p0 = s.
// |p0*k0 + p1*k1| <= 32768*728, so the int32 products never overflow.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bjxa {

constexpr int kBlockSamples = 32;
constexpr int kThreads = 128;

// Fixed-point (x256) predictor gains by profile factor (ops/tables.py:
// k0 = {0, 240, 460, 392, 488}, k1 = {0, 0, -208, -220, -240}) as select
// chains, once per block.  Factors >= 5 are invalid and select the last
// entry: the same defined garbage as profile_gains' clamped lookup.
__device__ __forceinline__ int32_t gain_k0(int factor) {
  return factor == 0 ? 0
       : factor == 1 ? 240
       : factor == 2 ? 460
       : factor == 3 ? 392
                     : 488;
}

__device__ __forceinline__ int32_t gain_k1(int factor) {
  return factor <= 1 ? 0
       : factor == 2 ? -208
       : factor == 3 ? -220
                     : -240;
}

// The low 16 bits of v as a signed int16, widened to int32.
__device__ __forceinline__ int32_t sign16(uint32_t v) {
  return static_cast<int32_t>(static_cast<int16_t>(static_cast<uint16_t>(v)));
}

// Sample n of a block in the top bits of a 16-bit word, from the block's
// 4*BITS payload bytes (the reference's inflate, src/libbjxa.c:286-345).
// n is a constant once the caller's sample loop is unrolled; `bytes` is
// any pointer to byte values (registers as uint32_t, or shared uint8_t).
// Shifts stay unsigned: a left shift of a negative int is undefined in
// C++17.
template <int BITS, class Bytes>
__device__ __forceinline__ uint32_t unpack_sample(const Bytes* bytes,
                                                  int n) {
  auto at = [&](int i) { return static_cast<uint32_t>(bytes[i]); };
  if constexpr (BITS == 8) {
    return at(n) << 8;
  } else if constexpr (BITS == 4) {
    const uint32_t bb = at(n / 2);
    return (n % 2 == 0) ? (bb & 0xF0u) << 8 : (bb & 0x0Fu) << 12;
  } else {  // 6: three bytes -> four samples through a 24-bit window
    const int base = 3 * (n / 4);
    const uint32_t w = (at(base) << 16) | (at(base + 1) << 8) | at(base + 2);
    switch (n % 4) {
      case 0: return (w & 0x00FC0000u) >> 8;
      case 1: return (w & 0x0003F000u) >> 2;
      case 2: return (w & 0x00000FC0u) << 4;
      default: return (w & 0x0000003Fu) << 10;
    }
  }
}

// C's truncating g / 256 (right shift of a negative int is arithmetic
// under nvcc, as C++20 requires).
__device__ __forceinline__ int32_t trunc_div_256(int32_t g) {
  return (g + ((g >> 31) & 255)) >> 8;
}

__device__ __forceinline__ int32_t filter_step(int32_t ranged, int32_t k0,
                                               int32_t k1, int32_t& p0,
                                               int32_t& p1) {
  int32_t s = ranged + trunc_div_256(p0 * k0 + p1 * k1);
  s = s < -32768 ? -32768 : (s > 32767 ? 32767 : s);
  p1 = p0;
  p0 = s;
  return s;
}

inline int grid_for(int lanes) { return (lanes + kThreads - 1) / kThreads; }

}  // namespace bjxa
