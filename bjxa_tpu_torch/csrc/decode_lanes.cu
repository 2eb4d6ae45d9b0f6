// Fused XA decode over lanes: raw block bytes -> filtered int16 PCM.
//
// Replaces the TPU kernels bjxa_tpu/ops/pallas_decode.py:_decode_kernel
// (WITH_OUTPUT=true) and :_states_kernel (WITH_OUTPUT=false, end state
// only: the fixed-point rounds of ops/decode.py).  Per block: profile ->
// factor/range, gains, 4/6/8-bit unpack into the top bits of an int16,
// arithmetic shift by the range, then the prediction filter with int16
// saturation -- bit-exact with bjxa_tpu_torch.ops.cuda_decode's plain
// version and the reference (src/libbjxa.c:286-345, 533-578).
//
// Layout: blocks_t uint8[B, S, L] (S = 4*BITS + 1, profile byte first),
// state int32[L, 2], pcm int16[B, 32, L], end int32[L, 2]; lanes are minor.
//
// Design: one thread per lane.  The TPU kernel's sequential block grid axis
// and its VMEM state scratch become an in-thread loop over the B blocks with
// (p0, p1) in registers; the lane bound check replaces padding to tiles.
// Neighbouring threads read neighbouring bytes of each (block, byte) row and
// write neighbouring int16 samples, so every access is coalesced.
//
// Bound: memory bytes.  Per sample the kernel reads bits/8 + 1/32 bytes and
// writes 2 bytes (none in the states-only instantiation); the arithmetic is
// ~10 integer ops per sample.  At the main path's L = 8192 lanes it runs
// only 64 blocks of 128 threads on 132 SMs, so it cannot reach the memory
// roofline there: more lanes (a larger chunk count) is the lever, left to
// later work because the fixed point is exact for any chunk count.
#include "adpcm.cuh"

namespace bjxa {
namespace {

template <int BITS, bool WITH_OUTPUT>
__global__ void __launch_bounds__(kThreads)
decode_lanes_kernel(const uint8_t* __restrict__ blocks_t,
                    const int32_t* __restrict__ state,
                    int16_t* __restrict__ pcm, int32_t* __restrict__ end,
                    int B, int L) {
  constexpr int S = 4 * BITS + 1;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const size_t lanes = static_cast<size_t>(L);
  int32_t p0 = state[2 * l];
  int32_t p1 = state[2 * l + 1];
  for (int b = 0; b < B; ++b) {
    const uint8_t* blk = blocks_t + static_cast<size_t>(b) * S * lanes + l;
    const int prof = blk[0];
    const int factor = prof >> 4;
    const int range = prof & 0x0F;
    const int32_t k0 = gain_k0(factor);
    const int32_t k1 = gain_k1(factor);
    uint32_t bytes[S - 1];
#pragma unroll
    for (int i = 0; i < S - 1; ++i) bytes[i] = blk[(1 + i) * lanes];
    int16_t* out =
        WITH_OUTPUT ? pcm + static_cast<size_t>(b) * kBlockSamples * lanes + l
                    : nullptr;
#pragma unroll
    for (int n = 0; n < kBlockSamples; ++n) {
      const uint32_t v = unpack_sample<BITS>(bytes, n);
      const int32_t s = filter_step(sign16(v) >> range, k0, k1, p0, p1);
      if constexpr (WITH_OUTPUT) out[n * lanes] = static_cast<int16_t>(s);
    }
  }
  end[2 * l] = p0;
  end[2 * l + 1] = p1;
}

template <int BITS>
void launch(const uint8_t* blocks_t, const int32_t* state, int16_t* pcm,
            int32_t* end, int B, int L, bool with_output, cudaStream_t s) {
  if (with_output) {
    decode_lanes_kernel<BITS, true>
        <<<grid_for(L), kThreads, 0, s>>>(blocks_t, state, pcm, end, B, L);
  } else {
    decode_lanes_kernel<BITS, false>
        <<<grid_for(L), kThreads, 0, s>>>(blocks_t, state, pcm, end, B, L);
  }
}

}  // namespace
}  // namespace bjxa

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int bjxa_decode_lanes(const void* blocks_t, const void* state,
                                 void* pcm, void* end, int B, int L, int bits,
                                 int with_output, int device, void* stream) {
  if (B < 0 || L <= 0 || (with_output && pcm == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const auto* in = static_cast<const uint8_t*>(blocks_t);
  const auto* st = static_cast<const int32_t*>(state);
  auto* out = static_cast<int16_t*>(pcm);
  auto* e = static_cast<int32_t*>(end);
  auto s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 4: bjxa::launch<4>(in, st, out, e, B, L, with_output, s); break;
    case 6: bjxa::launch<6>(in, st, out, e, B, L, with_output, s); break;
    case 8: bjxa::launch<8>(in, st, out, e, B, L, with_output, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
