// bjxa-tpu native host runtime.
//
// The device owns bulk/corpus work; this library owns the *streaming* hot path
// on the host CPU: block-at-a-time decode/encode where a device round trip
// per 32-sample block would be pure launch latency.  The codec primitives
// live in xa_core.h (shared with the drop-in C ABI in bjxa_abi.cc); this
// file is the flat whole-buffer surface consumed over ctypes.
//
// All functions return 0 on success or a negative errno-style code:
//   -EPROTO (-71)  invalid profile factor / bad bit depth
//   -EINVAL (-22)  bad argument combination

#include <cerrno>
#include <cstdint>

#include "xa_core.h"

namespace {

using bjxa_core::kBlockSamples;
using bjxa_core::kNumFactors;

}  // namespace

extern "C" {

// Decode `nblocks` effective blocks.
//   blocks: [nblocks][channels][block_size] raw XA bytes
//   state:  [channels][2] predictor taps, updated in place
//   pcm:    [nblocks*32][channels] interleaved output
// On an invalid profile, decoding stops and -EPROTO is returned;
// *blocks_done reports how many whole effective blocks were produced.
int bjxa_host_decode_blocks(const uint8_t* blocks, uint32_t nblocks,
                            uint32_t channels, uint32_t bits, int32_t* state,
                            int16_t* pcm, uint32_t* blocks_done) {
  if (blocks == nullptr || state == nullptr || pcm == nullptr) return -EINVAL;
  if ((bits != 4 && bits != 6 && bits != 8) || channels < 1 || channels > 2)
    return -EINVAL;
  const int bsz = bjxa_core::block_size_for(static_cast<int>(bits));
  int32_t ranged[kBlockSamples];
  uint32_t done = 0;
  for (uint32_t i = 0; i < nblocks; i++) {
    for (uint32_t c = 0; c < channels; c++) {
      const uint8_t* src = blocks + (i * channels + c) * bsz;
      bjxa_core::unpack(src + 1, static_cast<int>(bits), ranged);
      if (!bjxa_core::filter_block(ranged, src[0], &state[2 * c],
                                   &state[2 * c + 1],
                                   pcm + (i * kBlockSamples * channels) + c,
                                   static_cast<int>(channels))) {
        if (blocks_done != nullptr) *blocks_done = done;
        return -EPROTO;
      }
    }
    done++;
  }
  if (blocks_done != nullptr) *blocks_done = done;
  return 0;
}

// Reference-compatible truncation encode: profile 0, keep top bits.
//   pcm: [nblocks*32][channels] interleaved (caller zero-pads the tail)
//   out: [nblocks][channels][block_size]
int bjxa_host_encode_truncate(const int16_t* pcm, uint32_t nblocks,
                              uint32_t channels, uint32_t bits, uint8_t* out) {
  if (pcm == nullptr || out == nullptr) return -EINVAL;
  if ((bits != 4 && bits != 6 && bits != 8) || channels < 1 || channels > 2)
    return -EINVAL;
  const int bsz = bjxa_core::block_size_for(static_cast<int>(bits));
  int32_t vals[kBlockSamples];
  for (uint32_t i = 0; i < nblocks; i++) {
    for (uint32_t c = 0; c < channels; c++) {
      for (int n = 0; n < kBlockSamples; n++)
        vals[n] = pcm[(i * kBlockSamples + n) * channels + c];
      uint8_t* dst = out + (i * channels + c) * bsz;
      dst[0] = 0;
      bjxa_core::pack(vals, static_cast<int>(bits), dst + 1);
    }
  }
  return 0;
}

// Exhaustive per-block profile search encode (greedy across blocks), the
// host twin of the device search in bjxa_tpu_torch/ops/encode.py.
//   pcm:   [nblocks*32][channels] interleaved target samples
//   state: [channels][2] predictor taps, updated in place
//   out:   [nblocks][channels][block_size]
int bjxa_host_encode_search(const int16_t* pcm, uint32_t nblocks,
                            uint32_t channels, uint32_t bits, int32_t* state,
                            uint8_t* out) {
  if (pcm == nullptr || state == nullptr || out == nullptr) return -EINVAL;
  if ((bits != 4 && bits != 6 && bits != 8) || channels < 1 || channels > 2)
    return -EINVAL;
  const int bsz = bjxa_core::block_size_for(static_cast<int>(bits));
  int32_t x[kBlockSamples];
  int32_t coded[kBlockSamples];
  for (uint32_t i = 0; i < nblocks; i++) {
    for (uint32_t c = 0; c < channels; c++) {
      for (int n = 0; n < kBlockSamples; n++)
        x[n] = pcm[(i * kBlockSamples + n) * channels + c];
      uint8_t* dst = out + (i * channels + c) * bsz;
      bjxa_core::search_block(x, static_cast<int>(bits), &state[2 * c],
                              &state[2 * c + 1], dst, coded);
      bjxa_core::pack(coded, static_cast<int>(bits), dst + 1);
    }
  }
  return 0;
}

uint32_t bjxa_host_abi_version(void) { return 1; }

}  // extern "C"
