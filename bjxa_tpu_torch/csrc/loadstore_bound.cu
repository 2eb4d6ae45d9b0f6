// Measured load/store bound of the packed-words decode: the loads and stores
// of decode_words.cu with the decode taken out.
//
// Replaces the TPU kernel benchmarks/bench_roofline_bound.py:_null_kernel.
// It reads every input byte and writes every output element of the words
// decode at the same shape, through the same thread-to-lane mapping and the
// same access pattern, and does next to no arithmetic (one add per store), so
// its time is what the memory system alone costs this layout on this card:
// the denominator the words decode is stated against.  If decode_words.cu
// changes how it loads or stores, this kernel follows it.
//
// Per lane l and block b:
//   base       = prof[b, l] + sum_w words[b, w, l]        (int32, wrapping)
//   out[b,n,l] = int16(base + n), n = 0..31               (truncating)
//   acc       += base                                     (int32, wrapping)
// end[l, 0] = state[l, 0] + acc; end[l, 1] = state[l, 1].
// Bit-exact with bjxa_tpu_torch.benchmarks.roofline_bound's plain version.
//
// Layout: prof uint8[B, L], words int32[B, BITS, L], state int32[L, 2],
// out int16[B, 32, L], end int32[L, 2]; lanes are minor.
//
// Design: one thread per lane, blocks an in-thread loop, a lane bound check
// in place of padding, as in decode_words.cu.  The sums wrap, so they are
// taken as uint32_t (signed overflow is undefined in C++).
//
// Bound: memory bytes, by construction (4*BITS + 1 bytes read and 64 written
// per block and lane).
#include "adpcm.cuh"

namespace bjxa {
namespace {

template <int BITS>
__global__ void __launch_bounds__(kThreads)
loadstore_bound_kernel(const uint8_t* __restrict__ prof,
                       const int32_t* __restrict__ words,
                       const int32_t* __restrict__ state,
                       int16_t* __restrict__ out, int32_t* __restrict__ end,
                       int B, int L) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const size_t lanes = static_cast<size_t>(L);
  uint32_t acc = static_cast<uint32_t>(state[2 * l]);
  for (int b = 0; b < B; ++b) {
    uint32_t base = prof[static_cast<size_t>(b) * lanes + l];
    const int32_t* wb = words + static_cast<size_t>(b) * BITS * lanes + l;
#pragma unroll
    for (int i = 0; i < BITS; ++i) {
      base += static_cast<uint32_t>(wb[i * lanes]);
    }
    int16_t* o = out + static_cast<size_t>(b) * kBlockSamples * lanes + l;
#pragma unroll
    for (int n = 0; n < kBlockSamples; ++n) {
      o[n * lanes] = static_cast<int16_t>(static_cast<uint16_t>(base + n));
    }
    acc += base;
  }
  end[2 * l] = static_cast<int32_t>(acc);
  end[2 * l + 1] = state[2 * l + 1];
}

template <int BITS>
void launch(const uint8_t* prof, const int32_t* words, const int32_t* state,
            int16_t* out, int32_t* end, int B, int L, cudaStream_t s) {
  loadstore_bound_kernel<BITS><<<grid_for(L), kThreads, 0, s>>>(
      prof, words, state, out, end, B, L);
}

}  // namespace
}  // namespace bjxa

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int bjxa_loadstore_bound(const void* prof, const void* words,
                                    const void* state, void* out, void* end,
                                    int B, int L, int bits, int device,
                                    void* stream) {
  if (B < 0 || L <= 0 || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const auto* p = static_cast<const uint8_t*>(prof);
  const auto* w = static_cast<const int32_t*>(words);
  const auto* st = static_cast<const int32_t*>(state);
  auto* o = static_cast<int16_t*>(out);
  auto* e = static_cast<int32_t*>(end);
  auto s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 4: bjxa::launch<4>(p, w, st, o, e, B, L, s); break;
    case 6: bjxa::launch<6>(p, w, st, o, e, B, L, s); break;
    case 8: bjxa::launch<8>(p, w, st, o, e, B, L, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
