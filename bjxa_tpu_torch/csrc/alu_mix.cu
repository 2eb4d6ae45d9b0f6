// ALU probe: the per-element rate of the search encoder's candidate operation
// mix in 32-bit against 16-bit integers.
//
// Replaces the TPU kernel tools/encode_pack_falsify.py:bench_int16_vs_int32's
// `kernel`.  Each element runs kSteps = 256 dependent steps from y = x, in the
// element type T (int32_t or int16_t), every operation wrapping in T's width:
//   full   : y = clip(((y*3 + x) >> 2) + 1, -16384, 16383)
//   clip   : y = clip(  y*3 + x        + 1, -16384, 16383)
//   muladd : y =        y*3 + x + 1
// Bit-exact with bjxa_tpu_torch.tools.encode_pack_falsify's plain version.
//
// Design: one thread per element, grid-strided; one load and one store per
// element against 256 x up to 6 operations, so the kernel is bound by integer
// throughput, which is the point of the probe.  int32_t sums and products wrap
// through uint32_t (signed overflow is undefined in C++).  The int16_t
// instantiation narrows back to 16 bits after every operation, as a 16-bit
// lane would: C promotes short to int, so without the casts the intermediate
// would keep 32 bits.  Hopper has no packed 16-bit integer multiply or shift
// (the SIMD-in-a-word intrinsics cover add, sub, min, max and compares:
// __vadd2, __vmaxs2, __vmins2), so a 16-bit element occupies a 32-bit
// register and a 32-bit ALU lane here; the tool reports that beside the
// measured ratio.
//
// Bound: integer operations (elements x 256 steps x the mix's operations).
#include <cstdint>
#include <cuda_runtime.h>

namespace bjxa {
namespace {

constexpr int kSteps = 256;
constexpr int kAluThreads = 256;

enum Mix { kMixFull = 0, kMixClip = 1, kMixMulAdd = 2 };

// a*3 + b in T, wrapping in T's width.
__device__ __forceinline__ int32_t mul3_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * 3u +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int16_t mul3_add(int16_t a, int16_t b) {
  const int16_t m = static_cast<int16_t>(static_cast<uint16_t>(a * 3));
  return static_cast<int16_t>(static_cast<uint16_t>(m + b));
}

__device__ __forceinline__ int32_t add1(int32_t a) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + 1u);
}
__device__ __forceinline__ int16_t add1(int16_t a) {
  return static_cast<int16_t>(static_cast<uint16_t>(a + 1));
}

template <typename T>
__device__ __forceinline__ T clip14(T v) {
  return v < T(-16384) ? T(-16384) : (v > T(16383) ? T(16383) : v);
}

template <typename T, int MIX>
__global__ void __launch_bounds__(kAluThreads)
alu_mix_kernel(const T* __restrict__ x, T* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const T xv = x[i];
    T y = xv;
#pragma unroll 8
    for (int s = 0; s < kSteps; ++s) {
      if constexpr (MIX == kMixFull) {
        y = static_cast<T>(mul3_add(y, xv) >> 2);
        y = clip14<T>(add1(y));
      } else if constexpr (MIX == kMixClip) {
        y = clip14<T>(add1(mul3_add(y, xv)));
      } else {
        y = add1(mul3_add(y, xv));
      }
    }
    out[i] = y;
  }
}

template <typename T>
int launch(const void* x, void* out, long long n, int mix, cudaStream_t s) {
  const int grid = static_cast<int>(
      n < 65535LL * kAluThreads ? (n + kAluThreads - 1) / kAluThreads
                                : 65535);
  const T* in = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  switch (mix) {
    case kMixFull:
      alu_mix_kernel<T, kMixFull><<<grid, kAluThreads, 0, s>>>(in, o, n);
      break;
    case kMixClip:
      alu_mix_kernel<T, kMixClip><<<grid, kAluThreads, 0, s>>>(in, o, n);
      break;
    case kMixMulAdd:
      alu_mix_kernel<T, kMixMulAdd><<<grid, kAluThreads, 0, s>>>(in, o, n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace bjxa

// x, out: n elements of int32 (elem_bytes 4) or int16 (elem_bytes 2).
// mix: 0 full, 1 clip, 2 muladd.  Launches on `stream` without
// synchronising; returns cudaGetLastError().
extern "C" int bjxa_alu_mix(const void* x, void* out, long long n,
                            int elem_bytes, int mix, int device,
                            void* stream) {
  if (n <= 0 || x == nullptr || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) return bjxa::launch<int32_t>(x, out, n, mix, s);
  if (elem_bytes == 2) return bjxa::launch<int16_t>(x, out, n, mix, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
