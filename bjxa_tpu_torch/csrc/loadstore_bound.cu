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
// Design: decode_words.cu's, with the decode taken out.  The same launch
// as the words kernel at K = 1 (one cooperative launch over a persistent
// grid sized from its own occupancy, chunk_fixpoint.cuh's item loop: lane l
// at item l, threads strided over the lanes) and the same chunk loads
// (decode_chunk.cuh's ring_blocks under LoadW32: each thread's BITS words of
// the next three blocks in flight through a cp.async ring, the next
// profile byte in a register) and stores (StoreI16); the body between them
// is the sum and base + n above.  The sums wrap, so they are taken as
// uint32_t (signed overflow is undefined in C++).  It is not tuned beyond
// that: it is the yardstick, and must not beat the words kernel only for
// being tuned differently.
//
// Bound: memory bytes, by construction (4*BITS + 1 bytes read and 64 written
// per block and lane).
#include "adpcm.cuh"
#include "chunk_fixpoint.cuh"
#include "decode_chunk.cuh"

namespace bjxa {
namespace {

template <int BITS>
__global__ void __launch_bounds__(kThreads)
loadstore_bound_kernel(const uint8_t* __restrict__ prof,
                       const int32_t* __restrict__ words,
                       const int32_t* __restrict__ state,
                       int16_t* __restrict__ out, int32_t* __restrict__ end,
                       int32_t* scratch, int B, int L) {
  using Load = LoadW32<BITS>;
  __shared__ uint32_t ring[Load::kStages * Load::kWords * kThreads];
  uint32_t* slots = ring;
  const size_t lanes = static_cast<size_t>(L);
  const Load ld{prof, words, lanes};
  const StoreI16 st{out};
  chunk_fixpoint<true>(
      state, end, scratch, B, L, 1, B,
      [=](auto, long long l, long long b0, int n, int32_t& p0, int32_t&) {
        uint32_t acc = static_cast<uint32_t>(p0);
        ring_blocks(ld, slots, l, b0, n,
                    [&](long long b, int pr, const typename Load::Item&,
                        int j) {
          uint32_t base = static_cast<uint32_t>(pr);
#pragma unroll
          for (int i = 0; i < BITS; ++i) base += ld.word(slots, j, i);
          int16_t* o = st.block(lanes, l, b);
          int32_t prev = 0;
#pragma unroll
          for (int s = 0; s < kBlockSamples; ++s) {
            st.put(o, s, lanes, static_cast<int32_t>(base + s), prev);
          }
          acc += base;
        });
        p0 = static_cast<int32_t>(acc);
      });
}

template <int BITS>
const void* kernel_for() {
  return reinterpret_cast<const void*>(&loadstore_bound_kernel<BITS>);
}

const void* pick_kernel(int bits) {
  switch (bits) {
    case 4: return kernel_for<4>();
    case 6: return kernel_for<6>();
    case 8: return kernel_for<8>();
    default: return nullptr;
  }
}

}  // namespace
}  // namespace bjxa

// CTAs of the kernel that fit on one SM at once (the persistent grid is
// this times the SM count at most), or minus a CUDA error code.
extern "C" int bjxa_loadstore_bound_occupancy(int bits, int device) {
  return bjxa::coop_occupancy(bjxa::pick_kernel(bits), device);
}

// One cooperative launch of `ctas` CTAs on `stream`, without
// synchronising; scratch int32[4] (scratch[2] receives the round count, 0).
// A refused launch returns its error.
extern "C" int bjxa_loadstore_bound(const void* prof, const void* words,
                                    const void* state, void* out, void* end,
                                    void* scratch, int B, int L, int bits,
                                    int ctas, int device, void* stream) {
  if (B < 0 || L <= 0 || ctas <= 0 || scratch == nullptr ||
      (B > 0 && out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* e = static_cast<int32_t*>(end);
  auto* sc = static_cast<int32_t*>(scratch);
  void* args[] = {const_cast<void**>(&prof), const_cast<void**>(&words),
                  const_cast<void**>(&state), &out, &e, &sc, &B, &L};
  return bjxa::coop_launch(bjxa::pick_kernel(bits), args, ctas, device,
                           stream);
}
