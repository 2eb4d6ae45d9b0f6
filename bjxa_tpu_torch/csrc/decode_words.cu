// Fused XA decode over lanes from the packed-words layout -> int16 PCM.
//
// Replaces the TPU kernels bjxa_tpu/ops/pallas_decode.py:_decode_words_kernel
// (WITH_OUTPUT=true) and :_words_states_kernel (WITH_OUTPUT=false, end state
// only).  The same decode as decode_lanes.cu -- profile -> factor/range,
// gains, 4/6/8-bit unpack into the top bits of an int16, arithmetic shift by
// the range, the prediction filter with int16 saturation -- bit-exact with
// bjxa_tpu_torch.ops.cuda_decode_words' plain versions and the reference
// (src/libbjxa.c:286-345, 533-578).
//
// Layout: prof uint8[B, L], words int32[B, BITS, L] (word w = payload bytes
// 4w..4w+3 of one stream, little-endian), state int32[L, 2],
// pcm int16[B, 32, L], end int32[L, 2]; lanes are minor.  Byte i of the
// payload is (word[i >> 2] >> 8*(i & 3)) & 0xFF, shifted as uint32_t.
//
// Design.  The recurrence is serial over a lane's blocks, and a corpus batch
// has few lanes (16 stereo files are 32 lanes over ~20,000 blocks: one warp
// on one SM of 132).  So each lane's B blocks are cut into K chunks of
// Bc = ceil(B / K) blocks (the last one may be short, none is empty), and a
// work item is (chunk k, lane l) at flat index i = k*L + l: a warp covers 32
// neighbouring lanes of one chunk, so its loads and stores stay coalesced,
// the inputs are read in place and the PCM lands in its final [B, 32, L]
// place.  The chunks' entry states are solved exactly inside ONE
// cooperative launch by the schedule of chunk_fixpoint.cuh: rounds of the
// states-only decode (the TPU's _words_states_kernel) until no chunk's
// start changes, then one pass with output (_decode_words_kernel) from the
// solved starts.  K = 1 runs no round at all (the wrapper picks it where
// the lanes alone fill the card).
//
// Loads in flight: each thread stages its own BITS words of the next
// kStages - 1 blocks through a ring in shared memory with cp.async (4-byte
// copies: a warp's are 128 contiguous bytes), and its next profile byte in
// a register, while the current block is filtered; state stays in
// registers.  No thread reads another's slots, so the ring needs no CTA
// barrier.  The chunk body is decode_chunk.cuh's run_chunk under its
// LoadW32 and StoreI16 policies, the body the load and store ablations of
// decode_variants.cu swap one policy of.
//
// Bound: memory bytes at the headline (bits/8 + 1/32 bytes read and 2
// written per sample, ~203 MB a launch at B = 64, L = 32768, 8-bit); on a
// corpus batch the rounds re-read the input, (rounds + 1) reads in all.
#include "adpcm.cuh"
#include "chunk_fixpoint.cuh"
#include "decode_chunk.cuh"

namespace bjxa {
namespace {

template <int BITS, bool WITH_OUTPUT>
__global__ void __launch_bounds__(kThreads)
decode_words_kernel(const uint8_t* __restrict__ prof,
                    const int32_t* __restrict__ words,
                    const int32_t* __restrict__ state,
                    int16_t* __restrict__ pcm, int32_t* __restrict__ end,
                    int32_t* scratch, int B, int L, int K, int Bc) {
  using Load = LoadW32<BITS>;
  __shared__ uint32_t ring[Load::kStages * Load::kWords * kThreads];
  uint32_t* slots = ring;
  const size_t lanes = static_cast<size_t>(L);
  const Load ld{prof, words, lanes};
  const StoreI16 st{pcm};
  chunk_fixpoint<WITH_OUTPUT>(
      state, end, scratch, B, L, K, Bc,
      [=](auto out, long long l, long long b0, int n, int32_t& p0,
          int32_t& p1) {
        run_chunk<decltype(out)::value>(ld, st, slots, lanes, l, b0, n, p0,
                                        p1);
      });
}

template <int BITS, bool WITH_OUTPUT>
const void* kernel_for() {
  return reinterpret_cast<const void*>(
      &decode_words_kernel<BITS, WITH_OUTPUT>);
}

const void* pick_kernel(int bits, bool with_output) {
  switch (bits) {
    case 4: return with_output ? kernel_for<4, true>() : kernel_for<4, false>();
    case 6: return with_output ? kernel_for<6, true>() : kernel_for<6, false>();
    case 8: return with_output ? kernel_for<8, true>() : kernel_for<8, false>();
    default: return nullptr;
  }
}

}  // namespace
}  // namespace bjxa

// CTAs of the words kernel that fit on one SM at once (the persistent
// grid is this times the SM count at most), or minus a CUDA error code.
extern "C" int bjxa_decode_words_occupancy(int bits, int with_output,
                                           int device) {
  return bjxa::coop_occupancy(bjxa::pick_kernel(bits, with_output != 0),
                              device);
}

// One cooperative launch of `ctas` CTAs on `stream`, without synchronising:
// K chunks of Bc blocks (K*Bc >= B > (K-1)*Bc, or B = 0 and K = 1);
// scratch int32[4 + 4*K*L] (ctrl[0..3], then the starts of both parities;
// 4 elements are enough when K = 1), ctrl[2] receives the round count.
// A refused launch (too many CTAs to be co-resident, no cooperative launch
// on the device) returns its error.
extern "C" int bjxa_decode_words(const void* prof, const void* words,
                                 const void* state, void* pcm, void* end,
                                 void* scratch, int B, int L, int K, int Bc,
                                 int bits, int with_output, int ctas,
                                 int device, void* stream) {
  if (L <= 0 || !bjxa::chunks_ok(B, K, Bc) || ctas <= 0 ||
      scratch == nullptr || (with_output && B > 0 && pcm == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* out = static_cast<int16_t*>(pcm);
  auto* e = static_cast<int32_t*>(end);
  auto* sc = static_cast<int32_t*>(scratch);
  void* args[] = {const_cast<void**>(&prof), const_cast<void**>(&words),
                  const_cast<void**>(&state), &out, &e, &sc, &B, &L, &K, &Bc};
  return bjxa::coop_launch(bjxa::pick_kernel(bits, with_output != 0), args,
                           ctas, device, stream);
}
