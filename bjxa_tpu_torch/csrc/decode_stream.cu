// Fused XA decode of one whole stream, read in place from the file's own
// payload bytes -> interleaved int16 PCM.
//
// Replaces the TPU kernels bjxa_tpu/ops/pallas_decode.py:_decode_kernel
// (WITH_OUTPUT=true) and :_states_kernel (WITH_OUTPUT=false) on the
// whole-file decode, with the host staging and the host-driven fixed point
// around them (ops/decode.py:chunk_lanes_from_bytes, fixpoint_lanes_core).
// The same decode as decode_lanes.cu -- profile -> factor/range, gains,
// 4/6/8-bit unpack into the top bits of an int16, arithmetic shift by the
// range, the prediction filter with int16 saturation -- bit-exact with
// bjxa_tpu_torch.ops.cuda_decode's plain versions and the reference
// (src/libbjxa.c:286-345, 533-578, 602-661).
//
// Layout: payload uint8[B*C*S] exactly as the file holds it (block b,
// channel c at byte (b*C + c)*S, profile byte first, S = 4*BITS + 1),
// state int32[C, 2], frames int16[B*32, C] (sample n of block b, channel c
// at frames[(b*32 + n)*C + c]: the WAV's own order), end int32[C, 2].
//
// Design: the schedule of decode_words.cu (chunk_fixpoint.cuh) with the
// channels as lanes.  Each channel's B blocks are cut into K chunks of Bc
// blocks (the last one may be short, none is empty); a work item is
// (chunk k, channel c) at flat index i = k*C + c.  The chunks' entry
// states are solved exactly inside ONE cooperative launch: rounds of the
// states-only decode until no chunk's start changes (at most K), then one
// pass with output from the solved starts.  K = 1 runs no round.
//
// Reads.  Neighbouring items (k, c) and (k+1, c) read S-byte blocks
// Bc*C*S bytes apart, at any byte alignment.  Each thread stages its next
// kStages - 1 blocks through a ring in shared memory with cp.async: a block
// at byte offset off spans the BITS + 1 aligned words from off >> 2
// (bytes a .. a + 4*BITS of them, a = off & 3), and a funnel shift by 8*a
// realigns them in registers.  The last word of the payload is zero-filled
// past its end, so nothing past B*C*S bytes is read.  No thread reads
// another's slots, so the ring needs no CTA barrier.
//
// Writes.  Each thread packs its block's 32 samples into 16 words.
// Mono: its 64 bytes of frames are contiguous, four 16-byte stores.
// Stereo: items (k, 0) and (k, 1) are neighbouring lanes of one warp in
// step (same chunk, same block count); they swap halves with
// __shfl_xor_sync over the pair, so that channel 0's lane writes frames
// 0..15 of the block as (L, R) pairs and channel 1's lane frames 16..31:
// 64 contiguous bytes each.  One int16 store a sample at stride C measured
// 2.9x slower (benchmarks/stream_store.py builds that variant).
//
// Bound: memory bytes, the payload read once (bits/8 + 1/32 bytes a
// sample) and the frames written once (2 bytes a sample); the rounds
// re-read the payload.
#include <cuda_pipeline_primitives.h>

#include "adpcm.cuh"
#include "chunk_fixpoint.cuh"

namespace bjxa {
namespace {

constexpr int kStages = 4;  // blocks a thread has in flight

// Aligned words that hold one block at any byte alignment.
template <int BITS>
constexpr int kWords = BITS + 1;

// Block b's 32 samples of channel c, packed two to a word, to frames.
template <int C>
__device__ __forceinline__ void store_block(int16_t* __restrict__ frames,
                                            long long b, int c,
                                            const uint32_t (&pk)[16]) {
  uint32_t out[16];
  if constexpr (C == 1) {
#pragma unroll
    for (int q = 0; q < 16; ++q) out[q] = pk[q];
  } else {
    // channel 0's lane keeps frames 0..15, channel 1's frames 16..31
    const unsigned lane = threadIdx.x & 31u;
    const unsigned pair = 3u << (lane & ~1u);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint32_t mine = c == 0 ? pk[q] : pk[8 + q];
      const uint32_t theirs =
          __shfl_xor_sync(pair, c == 0 ? pk[8 + q] : pk[q], 1);
      const uint32_t l = c == 0 ? mine : theirs;
      const uint32_t r = c == 0 ? theirs : mine;
      out[2 * q] = __byte_perm(l, r, 0x5410);      // (l lo, r lo)
      out[2 * q + 1] = __byte_perm(l, r, 0x7632);  // (l hi, r hi)
    }
  }
  auto* dst = reinterpret_cast<uint4*>(
      frames + (static_cast<size_t>(b) * kBlockSamples + 16 * c) * C);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dst[q] = make_uint4(out[4 * q], out[4 * q + 1], out[4 * q + 2],
                        out[4 * q + 3]);
  }
}

// Decode blocks [b0, b0 + n) of channel c from (p0, p1) in place.
template <int BITS, int C, bool WITH_OUTPUT>
__device__ __forceinline__ void run_chunk(
    const uint32_t* __restrict__ words, size_t total,
    int16_t* __restrict__ frames, long long b0, int n, int c,
    uint32_t (*ring)[kWords<BITS>][kThreads], int32_t& p0, int32_t& p1) {
  constexpr int S = 4 * BITS + 1;
  constexpr int NW = kWords<BITS>;
  const int t = threadIdx.x;
  const size_t first = (static_cast<size_t>(b0) * C + c) * S;
  auto issue = [&](int j) {
    const size_t w0 = (first + static_cast<size_t>(j) * C * S) >> 2;
    uint32_t(*slot)[kThreads] = ring[j & (kStages - 1)];
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      // every word starts before the payload's end (its last starts at
      // byte off + 4*BITS at most); only the payload's last may run past it
      const size_t left = total - 4 * (w0 + q);
      __pipeline_memcpy_async(&slot[q][t], words + w0 + q, 4,
                              left < 4 ? 4 - left : 0);
    }
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n) issue(j);
    __pipeline_commit();
  }
  for (int j = 0; j < n; ++j) {
    if (j + kStages - 1 < n) issue(j + kStages - 1);
    __pipeline_commit();  // empty groups at the tail keep the count
    __pipeline_wait_prior(kStages - 1);  // block j's words have landed
    const uint32_t(*slot)[kThreads] = ring[j & (kStages - 1)];
    const int shift =
        8 * static_cast<int>((first + static_cast<size_t>(j) * C * S) & 3);
    uint32_t w[NW];
#pragma unroll
    for (int q = 0; q < NW; ++q) w[q] = slot[q][t];
    uint32_t u[NW];  // u[q] = bytes 4q .. 4q+3 of the block
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      u[q] = __funnelshift_r(w[q], q + 1 < NW ? w[q + 1] : 0u, shift);
    }
    uint32_t bytes[4 * BITS];  // the payload bytes after the profile
#pragma unroll
    for (int i = 0; i < 4 * BITS; ++i) {
      bytes[i] = (u[(i + 1) >> 2] >> (8 * ((i + 1) & 3))) & 0xFFu;
    }
    const int pr = static_cast<int>(u[0] & 0xFFu);
    const int factor = pr >> 4;
    const int range = pr & 0x0F;
    const int32_t k0 = gain_k0(factor);
    const int32_t k1 = gain_k1(factor);
    const long long b = b0 + j;
    uint32_t pk[kBlockSamples / 2];
#pragma unroll
    for (int s = 0; s < kBlockSamples; ++s) {
      const uint32_t v = unpack_sample<BITS>(bytes, s);
      const int32_t x = filter_step(sign16(v) >> range, k0, k1, p0, p1);
      if constexpr (WITH_OUTPUT) {
        const uint32_t h = static_cast<uint32_t>(x) & 0xFFFFu;
        pk[s / 2] = (s & 1) ? pk[s / 2] | (h << 16) : h;
      }
    }
    if constexpr (WITH_OUTPUT) store_block<C>(frames, b, c, pk);
  }
}

template <int BITS, int C, bool WITH_OUTPUT>
__global__ void __launch_bounds__(kThreads)
decode_stream_kernel(const uint32_t* __restrict__ words,
                     const int32_t* __restrict__ state,
                     int16_t* __restrict__ frames, int32_t* __restrict__ end,
                     int32_t* scratch, int B, int K, int Bc) {
  __shared__ uint32_t ring[kStages][kWords<BITS>][kThreads];
  uint32_t(*slots)[kWords<BITS>][kThreads] = ring;
  const size_t total = static_cast<size_t>(B) * C * (4 * BITS + 1);
  chunk_fixpoint<WITH_OUTPUT>(
      state, end, scratch, B, C, K, Bc,
      [=](auto out, long long c, long long b0, int n, int32_t& p0,
          int32_t& p1) {
        run_chunk<BITS, C, decltype(out)::value>(
            words, total, frames, b0, n, static_cast<int>(c), slots, p0, p1);
      });
}

template <int BITS, int C, bool WITH_OUTPUT>
const void* kernel_for() {
  return reinterpret_cast<const void*>(
      &decode_stream_kernel<BITS, C, WITH_OUTPUT>);
}

template <int BITS>
const void* pick_channels(int channels, bool with_output) {
  switch (channels) {
    case 1: return with_output ? kernel_for<BITS, 1, true>()
                               : kernel_for<BITS, 1, false>();
    case 2: return with_output ? kernel_for<BITS, 2, true>()
                               : kernel_for<BITS, 2, false>();
    default: return nullptr;
  }
}

const void* pick_kernel(int bits, int channels, bool with_output) {
  switch (bits) {
    case 4: return pick_channels<4>(channels, with_output);
    case 6: return pick_channels<6>(channels, with_output);
    case 8: return pick_channels<8>(channels, with_output);
    default: return nullptr;
  }
}

}  // namespace
}  // namespace bjxa

// CTAs of the stream kernel that fit on one SM at once (the persistent
// grid is this times the SM count at most), or minus a CUDA error code.
extern "C" int bjxa_decode_stream_occupancy(int bits, int channels,
                                            int with_output, int device) {
  return bjxa::coop_occupancy(
      bjxa::pick_kernel(bits, channels, with_output != 0), device);
}

// One cooperative launch of `ctas` CTAs on `stream`, without synchronising:
// K chunks of Bc blocks (K*Bc >= B > (K-1)*Bc, or B = 0 and K = 1);
// payload 4-byte aligned (null when B = 0), frames 16-byte aligned;
// scratch int32[4 + 4*K*C] (4 elements are enough when K = 1), ctrl[2]
// receives the round count.  A refused launch returns its error.
extern "C" int bjxa_decode_stream(const void* payload, const void* state,
                                  void* frames, void* end, void* scratch,
                                  int B, int C, int K, int Bc, int bits,
                                  int with_output, int ctas, int device,
                                  void* stream) {
  const bool writes = with_output && B > 0;
  if (!bjxa::chunks_ok(B, K, Bc) || ctas <= 0 || scratch == nullptr ||
      (B > 0 && payload == nullptr) ||
      (reinterpret_cast<uintptr_t>(payload) & 3) != 0 ||
      (writes && frames == nullptr) ||
      (writes && (reinterpret_cast<uintptr_t>(frames) & 15) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* w = static_cast<const uint32_t*>(payload);
  auto* out = static_cast<int16_t*>(frames);
  auto* e = static_cast<int32_t*>(end);
  auto* sc = static_cast<int32_t*>(scratch);
  void* args[] = {&w, const_cast<void**>(&state), &out, &e, &sc, &B, &K,
                  &Bc};
  return bjxa::coop_launch(
      bjxa::pick_kernel(bits, C, with_output != 0), args, ctas, device,
      stream);
}
