// Load-side and store-side variants of the fused 8-bit XA decode, for
// measurement: the same decode as decode_lanes.cu / decode_words.cu with the
// payload loaded and the PCM stored in other forms, so their cost can be
// read against the production kernels on the same bytes.
//
// Replaces the TPU kernels benchmarks/bench_load_variants.py:_kernel (LOAD =
// w32: the payload as little-endian int32 words, bytes taken by shift and
// mask) and benchmarks/bench_store_variants.py:_kernel (LOAD = u8: one byte
// load per sample).  8-bit only, as both are.  Bit-exact with the plain
// versions in bjxa_tpu_torch.benchmarks.load_variants / store_variants, and
// in the i16 store with decode_words.cu / decode_lanes.cu.
//
// Layout (lanes minor): LOAD u8 reads blocks_t uint8[B, 33, L] (profile byte
// first); LOAD w32 reads prof uint8[B, L] and words int32[B, 8, L] (word w =
// payload bytes 4w..4w+3 of one stream).  state int32[L, 2], end int32[L, 2].
// STORE i16 writes int16[B, 32, L]; i32 writes int32[B, 32, L] (no narrowing,
// twice the bytes); pair writes int32[B, 16, L], two consecutive samples in
// one word, (s0 & 0xFFFF) | (s1 << 16): half the stores, the
// bytes of i16, and its little-endian int16 view [B, 16, L, 2] is the
// natural sample order of each lane.
//
// Design: one thread per lane, the block axis an in-thread loop with (p0, p1)
// in registers, a lane bound check in place of padding -- the mapping of the
// production kernels, so a variant differs from them in its loads and stores
// alone.  Every access is coalesced (neighbouring threads, neighbouring
// addresses).  s1 << 16 goes through uint32_t: a left shift of a negative
// int is undefined in C++17.
//
// Bound: memory bytes (33 B read and 64, 128 or 64 B written per block and
// lane).  These kernels exist to be timed; none is on a conversion path.
#include "adpcm.cuh"

namespace bjxa {
namespace {

enum Load { kLoadU8 = 0, kLoadW32 = 1 };
enum Store { kStoreI16 = 0, kStoreI32 = 1, kStorePair = 2 };

template <int LOAD, int STORE>
__global__ void __launch_bounds__(kThreads)
decode_variants_kernel(const uint8_t* __restrict__ first,
                       const int32_t* __restrict__ words,
                       const int32_t* __restrict__ state,
                       void* __restrict__ out_v, int32_t* __restrict__ end,
                       int B, int L) {
  constexpr int BITS = 8;
  constexpr int S = 4 * BITS + 1;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const size_t lanes = static_cast<size_t>(L);
  int32_t p0 = state[2 * l];
  int32_t p1 = state[2 * l + 1];
  for (int b = 0; b < B; ++b) {
    int pr;
    uint32_t bytes[4 * BITS];
    if constexpr (LOAD == kLoadU8) {
      const uint8_t* blk = first + static_cast<size_t>(b) * S * lanes + l;
      pr = blk[0];
#pragma unroll
      for (int i = 0; i < S - 1; ++i) bytes[i] = blk[(1 + i) * lanes];
    } else {
      pr = first[static_cast<size_t>(b) * lanes + l];
      const int32_t* wb = words + static_cast<size_t>(b) * BITS * lanes + l;
#pragma unroll
      for (int i = 0; i < BITS; ++i) {
        const uint32_t w = static_cast<uint32_t>(wb[i * lanes]);
#pragma unroll
        for (int q = 0; q < 4; ++q) bytes[4 * i + q] = (w >> (8 * q)) & 0xFFu;
      }
    }
    const int factor = pr >> 4;
    const int range = pr & 0x0F;
    const int32_t k0 = gain_k0(factor);
    const int32_t k1 = gain_k1(factor);
    constexpr int ROWS = STORE == kStorePair ? kBlockSamples / 2
                                             : kBlockSamples;
    const size_t base = static_cast<size_t>(b) * ROWS * lanes + l;
    int32_t prev = 0;
#pragma unroll
    for (int n = 0; n < kBlockSamples; ++n) {
      const uint32_t v = unpack_sample<BITS>(bytes, n);
      const int32_t s = filter_step(sign16(v) >> range, k0, k1, p0, p1);
      if constexpr (STORE == kStoreI16) {
        static_cast<int16_t*>(out_v)[base + n * lanes] =
            static_cast<int16_t>(s);
      } else if constexpr (STORE == kStoreI32) {
        static_cast<int32_t*>(out_v)[base + n * lanes] = s;
      } else {
        if (n % 2 == 1) {
          const uint32_t w = (static_cast<uint32_t>(prev) & 0xFFFFu) |
                             (static_cast<uint32_t>(s) << 16);
          static_cast<int32_t*>(out_v)[base + (n / 2) * lanes] =
              static_cast<int32_t>(w);
        }
        prev = s;
      }
    }
  }
  end[2 * l] = p0;
  end[2 * l + 1] = p1;
}

template <int LOAD, int STORE>
void launch(const void* first, const void* words, const void* state,
            void* out, void* end, int B, int L, cudaStream_t s) {
  decode_variants_kernel<LOAD, STORE><<<grid_for(L), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(first), static_cast<const int32_t*>(words),
      static_cast<const int32_t*>(state), out, static_cast<int32_t*>(end), B,
      L);
}

}  // namespace
}  // namespace bjxa

// first: blocks_t (load 0, u8; words unused) or prof (load 1, w32).
// store: 0 i16, 1 i32, 2 pair.  The instantiations are u8 x {i16, i32, pair}
// and w32 x {i16, pair}; any other pair of codes is refused.  Launches on
// `stream` without synchronising; returns cudaGetLastError().
extern "C" int bjxa_decode_variant(const void* first, const void* words,
                                   const void* state, void* out, void* end,
                                   int B, int L, int load, int store,
                                   int device, void* stream) {
  using namespace bjxa;
  if (B < 0 || L <= 0 || first == nullptr || out == nullptr ||
      load < kLoadU8 || load > kLoadW32 || store < kStoreI16 ||
      store > kStorePair || (load == kLoadW32 && words == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  auto s = static_cast<cudaStream_t>(stream);
  const int code = load * 3 + store;
  switch (code) {
    case kLoadU8 * 3 + kStoreI16:
      launch<kLoadU8, kStoreI16>(first, words, state, out, end, B, L, s);
      break;
    case kLoadU8 * 3 + kStoreI32:
      launch<kLoadU8, kStoreI32>(first, words, state, out, end, B, L, s);
      break;
    case kLoadU8 * 3 + kStorePair:
      launch<kLoadU8, kStorePair>(first, words, state, out, end, B, L, s);
      break;
    case kLoadW32 * 3 + kStoreI16:
      launch<kLoadW32, kStoreI16>(first, words, state, out, end, B, L, s);
      break;
    case kLoadW32 * 3 + kStorePair:
      launch<kLoadW32, kStorePair>(first, words, state, out, end, B, L, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
