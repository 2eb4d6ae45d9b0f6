// Shared device helpers for the XA decode kernels: gain tables, int16 sign
// extension and one step of the two-tap ADPCM prediction filter.
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
