// Fused XA decode over lanes from the packed-words layout -> int16 PCM.
//
// Replaces the TPU kernels bjxa_tpu/ops/pallas_decode.py:_decode_words_kernel
// (WITH_OUTPUT=true) and :_words_states_kernel (WITH_OUTPUT=false, end state
// only).  The same decode as decode_lanes.cu -- profile -> factor/range,
// gains, 4/6/8-bit unpack into the top bits of an int16, arithmetic shift by
// the range, the prediction filter with int16 saturation -- bit-exact with
// bjxa_tpu_torch.ops.cuda_decode_words' plain version and the reference
// (src/libbjxa.c:286-345, 533-578).
//
// Layout: prof uint8[B, L], words int32[B, BITS, L] (word w = payload bytes
// 4w..4w+3 of one stream, little-endian), state int32[L, 2],
// pcm int16[B, 32, L], end int32[L, 2]; lanes are minor.
//
// Design: one thread per lane, as in decode_lanes.cu.  The TPU kernel's
// sequential block grid axis and its VMEM state scratch become an in-thread
// loop over the B blocks with (p0, p1) in registers (CUDA blocks run in no
// order, so blocks cannot be a grid axis); the lane bound check replaces
// padding to tiles, so no end-state recovery is needed.  Per block a thread
// loads one profile byte and BITS 4-byte words -- neighbouring threads on
// neighbouring addresses, so each warp load is coalesced -- where the lanes
// layout costs 4*BITS one-byte loads.  Byte i of the payload is
// (word[i >> 2] >> 8*(i & 3)) & 0xFF, shifted as uint32_t.
//
// Bound: memory bytes where lanes are many (bits/8 + 1/32 bytes read and
// 2 bytes written per sample, ~203 MB a launch at B = 64, L = 32768,
// 8-bit); the latency of the serial block loop where lanes are few (a
// corpus batch of 16 stereo files is L = 32 lanes, one warp, over ~20,000
// blocks).  Speed is later work: more lanes per batch (chunking each file's
// block range into fixed-point lanes) is the lever there.
#include "adpcm.cuh"

namespace bjxa {
namespace {

template <int BITS, bool WITH_OUTPUT>
__global__ void __launch_bounds__(kThreads)
decode_words_kernel(const uint8_t* __restrict__ prof,
                    const int32_t* __restrict__ words,
                    const int32_t* __restrict__ state,
                    int16_t* __restrict__ pcm, int32_t* __restrict__ end,
                    int B, int L) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const size_t lanes = static_cast<size_t>(L);
  int32_t p0 = state[2 * l];
  int32_t p1 = state[2 * l + 1];
  for (int b = 0; b < B; ++b) {
    const int pr = prof[static_cast<size_t>(b) * lanes + l];
    const int factor = pr >> 4;
    const int range = pr & 0x0F;
    const int32_t k0 = gain_k0(factor);
    const int32_t k1 = gain_k1(factor);
    const int32_t* wb = words + static_cast<size_t>(b) * BITS * lanes + l;
    uint32_t bytes[4 * BITS];
#pragma unroll
    for (int i = 0; i < BITS; ++i) {
      const uint32_t w = static_cast<uint32_t>(wb[i * lanes]);
#pragma unroll
      for (int q = 0; q < 4; ++q) bytes[4 * i + q] = (w >> (8 * q)) & 0xFFu;
    }
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
void launch(const uint8_t* prof, const int32_t* words, const int32_t* state,
            int16_t* pcm, int32_t* end, int B, int L, bool with_output,
            cudaStream_t s) {
  if (with_output) {
    decode_words_kernel<BITS, true><<<grid_for(L), kThreads, 0, s>>>(
        prof, words, state, pcm, end, B, L);
  } else {
    decode_words_kernel<BITS, false><<<grid_for(L), kThreads, 0, s>>>(
        prof, words, state, pcm, end, B, L);
  }
}

}  // namespace
}  // namespace bjxa

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int bjxa_decode_words(const void* prof, const void* words,
                                 const void* state, void* pcm, void* end,
                                 int B, int L, int bits, int with_output,
                                 int device, void* stream) {
  if (B < 0 || L <= 0 || (with_output && pcm == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const auto* p = static_cast<const uint8_t*>(prof);
  const auto* w = static_cast<const int32_t*>(words);
  const auto* st = static_cast<const int32_t*>(state);
  auto* out = static_cast<int16_t*>(pcm);
  auto* e = static_cast<int32_t*>(end);
  auto s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 4: bjxa::launch<4>(p, w, st, out, e, B, L, with_output, s); break;
    case 6: bjxa::launch<6>(p, w, st, out, e, B, L, with_output, s); break;
    case 8: bjxa::launch<8>(p, w, st, out, e, B, L, with_output, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
