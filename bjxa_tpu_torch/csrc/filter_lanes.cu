// ADPCM prediction filter over already-unpacked lanes.
//
// Replaces the TPU kernels bjxa_tpu/ops/pallas_filter.py:_filter_kernel
// (WITH_OUTPUT=true) and :_states_kernel (WITH_OUTPUT=false, end state
// only).  Per block the range shift happens here, then the same recurrence
// as decode_lanes.cu -- bit-exact with bjxa_tpu_torch.ops.cuda_filter's
// plain version.
//
// Layout: samples int16[B, 32, L] (top-bits domain, not yet range-shifted),
// k0/k1/shift int32[B, L], state int32[L, 2], pcm int16[B, 32, L],
// end int32[L, 2]; lanes are minor.
//
// Design: one thread per lane, the blocks looped in-thread with (p0, p1) in
// registers (the TPU kernel's sequential grid axis and VMEM scratch); the
// lane bound check replaces padding to tiles; all accesses are coalesced
// across neighbouring lanes.
//
// Bound: memory bytes -- 2 B read and 2 B written per sample plus 12 B per
// block -- wherever lanes are many.  On the short-stream path (L = channels,
// 1 or 2 lanes) it is one partial warp, bound by the latency of the serial
// recurrence; that path decodes at most 64 blocks, so it is a few
// microseconds of device time either way.
#include "adpcm.cuh"

namespace bjxa {
namespace {

template <bool WITH_OUTPUT>
__global__ void __launch_bounds__(kThreads)
filter_lanes_kernel(const int16_t* __restrict__ samples,
                    const int32_t* __restrict__ k0,
                    const int32_t* __restrict__ k1,
                    const int32_t* __restrict__ shift,
                    const int32_t* __restrict__ state,
                    int16_t* __restrict__ pcm, int32_t* __restrict__ end,
                    int B, int L) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const size_t lanes = static_cast<size_t>(L);
  int32_t p0 = state[2 * l];
  int32_t p1 = state[2 * l + 1];
  for (int b = 0; b < B; ++b) {
    const size_t bl = static_cast<size_t>(b) * lanes + l;
    const int32_t g0 = k0[bl];
    const int32_t g1 = k1[bl];
    // a shift past the word width fills with the sign, as XLA's does
    const uint32_t sh = static_cast<uint32_t>(shift[bl]);
    const int range = sh > 31u ? 31 : static_cast<int>(sh);
    const size_t row = static_cast<size_t>(b) * kBlockSamples * lanes + l;
#pragma unroll
    for (int n = 0; n < kBlockSamples; ++n) {
      const int32_t ranged =
          static_cast<int32_t>(samples[row + n * lanes]) >> range;
      const int32_t s = filter_step(ranged, g0, g1, p0, p1);
      if constexpr (WITH_OUTPUT) pcm[row + n * lanes] = static_cast<int16_t>(s);
    }
  }
  end[2 * l] = p0;
  end[2 * l + 1] = p1;
}

}  // namespace
}  // namespace bjxa

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int bjxa_filter_lanes(const void* samples, const void* k0,
                                 const void* k1, const void* shift,
                                 const void* state, void* pcm, void* end,
                                 int B, int L, int with_output, int device,
                                 void* stream) {
  if (B < 0 || L <= 0 || (with_output && pcm == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const auto* x = static_cast<const int16_t*>(samples);
  const auto* g0 = static_cast<const int32_t*>(k0);
  const auto* g1 = static_cast<const int32_t*>(k1);
  const auto* sh = static_cast<const int32_t*>(shift);
  const auto* st = static_cast<const int32_t*>(state);
  auto* out = static_cast<int16_t*>(pcm);
  auto* e = static_cast<int32_t*>(end);
  auto s = static_cast<cudaStream_t>(stream);
  const int grid = bjxa::grid_for(L);
  if (with_output) {
    bjxa::filter_lanes_kernel<true>
        <<<grid, bjxa::kThreads, 0, s>>>(x, g0, g1, sh, st, out, e, B, L);
  } else {
    bjxa::filter_lanes_kernel<false>
        <<<grid, bjxa::kThreads, 0, s>>>(x, g0, g1, sh, st, out, e, B, L);
  }
  return static_cast<int>(cudaGetLastError());
}
