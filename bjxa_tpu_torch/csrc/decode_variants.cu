// Load-side and store-side variants of the fused 8-bit XA decode, for
// measurement: the production words decode (decode_words.cu) with one
// policy of its chunk body swapped, so each variant's gap to it is the cost
// of that policy and nothing else.
//
// Replaces the TPU kernels benchmarks/bench_load_variants.py:_kernel (LOAD =
// w32: the payload as little-endian int32 words, bytes taken by shift and
// mask) and benchmarks/bench_store_variants.py:_kernel (LOAD = u8: one byte
// load per sample).  8-bit only, as both are.  Bit-exact with the plain
// versions in bjxa_tpu_torch.benchmarks.load_variants / store_variants, and
// in the i16 store with decode_words.cu / decode_lanes.cu.
//
// Layout (lanes minor): LOAD u8 reads blocks_t uint8[B, 33, L] (profile byte
// first, at any address); LOAD w32 reads prof uint8[B, L] and words
// int32[B, 8, L] (word w = payload bytes 4w..4w+3 of one stream).  state
// int32[L, 2], end int32[L, 2].  STORE i16 writes int16[B, 32, L]; i32
// writes int32[B, 32, L]; pair writes int32[B, 16, L], two consecutive
// samples in one word, (s0 & 0xFFFF) | (s1 << 16).
//
// Design: decode_words.cu's, policy for policy.  Each lane's B blocks are
// cut into K chunks of Bc blocks, a work item (chunk k, lane l) at i = k*L
// + l, the chunks' starts solved exactly inside ONE cooperative launch over
// a persistent grid (chunk_fixpoint.cuh's grid scope: rounds of the
// states-only body, then one pass with output; K = 1 runs no round), and
// the chunk body is decode_chunk.cuh's run_chunk: LoadW32<8> or the u8 load
// crossed with StoreI16, StoreI32 or StorePair.  w32 x i16 is the words
// kernel itself.  A u8 block is 33 rows L bytes apart, so a warp's bytes of
// a block are 33 separate 32-byte pieces against the 9 of w32's: the u8
// load copies them warp by warp with 16-byte cp.async (LoadU8Warp, 6 KB a
// stage for a CTA); a thread-by-thread form (an aligned 4-byte copy a row
// and thread, 16 KB a stage) measured slower, and benchmarks/u8_ring.py
// builds it for the ablation.  The ring takes dynamic shared memory, opted
// in above 48 KB and counted by the occupancy query.
//
// Bound: memory bytes (33 B read and 64, 128 or 64 B written per block and
// lane; on a chunked launch the rounds re-read the input).  These kernels
// exist to be timed; none is on a conversion path.
#include <type_traits>

#include "adpcm.cuh"
#include "chunk_fixpoint.cuh"
#include "decode_chunk.cuh"

namespace bjxa {
namespace {

// The u8 load: the warp-cooperative form, a ring of kU8Stages blocks (three
// in flight while one is filtered, as in the words kernel).
template <int STAGES>
using LoadU8 = LoadU8Warp<STAGES>;
constexpr int kU8Stages = 4;

enum Load { kLoadU8 = 0, kLoadW32 = 1 };
enum Store { kStoreI16 = 0, kStoreI32 = 1, kStorePair = 2 };

template <int LOAD>
using LoadOf =
    std::conditional_t<LOAD == kLoadU8, LoadU8<kU8Stages>, LoadW32<8>>;
template <int STORE>
using StoreOf = std::conditional_t<
    STORE == kStoreI16, StoreI16,
    std::conditional_t<STORE == kStoreI32, StoreI32, StorePair>>;

// LOAD u8 reads `first` as blocks_t; LOAD w32 reads it as prof, beside
// `words`.
template <int LOAD>
__device__ __forceinline__ LoadOf<LOAD> make_load(
    const uint8_t* first, const int32_t* words, int B, size_t lanes) {
  if constexpr (LOAD == kLoadU8) {
    return {first, lanes,
            static_cast<size_t>(B) * LoadOf<LOAD>::kRows * lanes};
  } else {
    return {first, words, lanes};
  }
}

// The u8 instantiations are compiled for 4 CTAs an SM (up to 128
// registers): left to itself ptxas spills them.  The w32 ones take no
// minimum, as decode_words.cu's kernel (0 adds none).
template <int LOAD, int STORE>
__global__ void __launch_bounds__(kThreads, LOAD == kLoadU8 ? 4 : 0)
decode_variants_kernel(const uint8_t* __restrict__ first,
                       const int32_t* __restrict__ words,
                       const int32_t* __restrict__ state,
                       void* __restrict__ out, int32_t* __restrict__ end,
                       int32_t* scratch, int B, int L, int K, int Bc) {
  extern __shared__ __align__(16) uint32_t ring[];
  uint32_t* slots = ring;
  const size_t lanes = static_cast<size_t>(L);
  const LoadOf<LOAD> ld = make_load<LOAD>(first, words, B, lanes);
  const StoreOf<STORE> st{
      static_cast<typename StoreOf<STORE>::Elem*>(out)};
  chunk_fixpoint<true>(
      state, end, scratch, B, L, K, Bc,
      [=](auto with, long long l, long long b0, int n, int32_t& p0,
          int32_t& p1) {
        run_item<decltype(with)::value>(ld, st, slots, lanes, l, b0, n, p0,
                                        p1);
      });
}

// The kernel of a pair of codes and its ring's dynamic shared memory, or
// {nullptr, 0} for a pair that has no instantiation.
struct Variant {
  const void* fn;
  size_t smem;
};

template <int LOAD, int STORE>
Variant variant() {
  return {reinterpret_cast<const void*>(
              &decode_variants_kernel<LOAD, STORE>),
          ring_bytes<LoadOf<LOAD>>()};
}

Variant pick_variant(int load, int store) {
  switch (load * 3 + store) {
    case kLoadU8 * 3 + kStoreI16: return variant<kLoadU8, kStoreI16>();
    case kLoadU8 * 3 + kStoreI32: return variant<kLoadU8, kStoreI32>();
    case kLoadU8 * 3 + kStorePair: return variant<kLoadU8, kStorePair>();
    case kLoadW32 * 3 + kStoreI16: return variant<kLoadW32, kStoreI16>();
    case kLoadW32 * 3 + kStorePair: return variant<kLoadW32, kStorePair>();
    default: return {nullptr, 0};
  }
}

}  // namespace
}  // namespace bjxa

// CTAs of an instantiation (load 0 u8, 1 w32; store 0 i16, 1 i32, 2 pair)
// that fit on one SM at once, its ring's dynamic shared memory counted, or
// minus a CUDA error code (an instantiation that does not exist is
// cudaErrorInvalidValue).
extern "C" int bjxa_decode_variant_occupancy(int load, int store,
                                             int device) {
  const bjxa::Variant v = bjxa::pick_variant(load, store);
  return bjxa::coop_occupancy(v.fn, device, v.smem);
}

// Dynamic shared memory of an instantiation's CTA in bytes, 0 for none.
extern "C" int bjxa_decode_variant_smem(int load, int store) {
  return static_cast<int>(bjxa::pick_variant(load, store).smem);
}

// first: blocks_t (load 0, u8, at any address; words unused) or prof (load
// 1, w32).  store: 0 i16, 1 i32, 2 pair.  The instantiations are u8 x {i16,
// i32, pair} and w32 x {i16, pair}; any other pair of codes is refused.
// One cooperative launch of `ctas` CTAs on `stream`, without
// synchronising: K chunks of Bc blocks (K*Bc >= B > (K-1)*Bc, or B = 0 and
// K = 1); scratch int32[4 + 4*K*L] (4 elements are enough when K = 1),
// scratch[2] receives the round count.  A refused launch returns its error.
extern "C" int bjxa_decode_variant(const void* first, const void* words,
                                   const void* state, void* out, void* end,
                                   void* scratch, int B, int L, int K, int Bc,
                                   int load, int store, int ctas, int device,
                                   void* stream) {
  using namespace bjxa;
  if (L <= 0 || !chunks_ok(B, K, Bc) || ctas <= 0 || scratch == nullptr ||
      (B > 0 && (first == nullptr || out == nullptr ||
                 (load == kLoadW32 && words == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Variant v = pick_variant(load, store);
  auto* e = static_cast<int32_t*>(end);
  auto* sc = static_cast<int32_t*>(scratch);
  void* args[] = {const_cast<void**>(&first), const_cast<void**>(&words),
                  const_cast<void**>(&state), &out, &e, &sc, &B, &L, &K, &Bc};
  return coop_launch(v.fn, args, ctas, device, stream, v.smem);
}
