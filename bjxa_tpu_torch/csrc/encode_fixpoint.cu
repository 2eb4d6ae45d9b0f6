// Exhaustive profile-search XA encode of few lanes (one stream's channels,
// or a corpus batch's files x channels), cut into chunks whose entry states
// are solved exactly inside ONE cooperative launch.
//
// Replaces the TPU kernel bjxa_tpu/ops/pallas_encode.py:_encode_kernel on
// the paths that search a long stream over few lanes, with the host-driven
// fixed point around it (ops/encode.py:encode_search_fixpoint: a launch, an
// equality test and a sync a round, and the PCM copied into chunk lanes and
// back).  The search of each block is encode_block.cuh's, shared with the
// serial kernel encode_search.cu, so every byte equals it: the fixed point
// is exact.
//
// Layout: pcm int16[B, 32, L] in stream order, read in place; state
// int32[L, 2]; profiles int32[B, L], coded and recon int16[B, 32, L],
// written in place; end int32[L, 2], the state after block B - 1.
//
// Schedule: each lane's B blocks are cut into K chunks of Bc blocks; a work
// item is (chunk k, lane l) at i = k*L + l.  chunk_fixpoint_tiles runs
// states-only rounds until no chunk's start changes (at most K), then one
// pass with output from the solved starts.  Its unit of work is a CTA of 16
// warps a tile of 32 items, since one item's block is the CTA-wide search of
// encode_block.cuh; tiles are strided over a persistent grid (two CTAs an
// SM), so K*L/32 tiles fill the card where the serial kernel gives a stream
// of L <= 32 lanes one SM of 132.  A states-only round is the search without
// the profile and recon stores and without the re-run: the winner's end
// state is what carries, so a round costs nearly a whole search, and the
// gain is in the SMs filled, not in lighter rounds.
//
// The host loop pads the stream to K*Bc blocks with zero blocks, which may
// fill whole chunks (B = 1,601 at K = 100: Bc = 17, five chunks of pad), and
// every chunk's end takes part in its equality test.  So every item runs Bc
// blocks here too, the pad on zeros (searched, never stored), and the round
// count is the host loop's.  The tile runs Bc blocks for all its items, so
// the pad costs no time on the chain.  `end` is read back from the recon
// rows 31 and 30 of block B - 1, which its item wrote itself; B = 0 gives
// the entry state.
//
// Bound: integer issue, as encode_search.cu, times the rounds: the chain of
// a round is Bc blocks of one CTA.
#include "chunk_fixpoint.cuh"
#include "encode_block.cuh"

namespace bjxa {
namespace {

template <int BITS>
__global__ void __launch_bounds__(kEncodeThreads, 2)
encode_fixpoint_kernel(const int16_t* __restrict__ pcm,
                       const int32_t* __restrict__ state,
                       int32_t* __restrict__ profiles,
                       int16_t* __restrict__ coded,
                       int16_t* __restrict__ recon_out,
                       int32_t* __restrict__ end, int32_t* scratch, int B,
                       int L, int K, int Bc) {
  __shared__ SearchShared sh;
  // each item's lane if it holds block B - 1, else -1: kept here, not in a
  // register across the search
  __shared__ int end_lane[kLanes];
  chunk_fixpoint_tiles<true>(
      state, scratch, L, K, [&](auto out, int i, int32_t& p0, int32_t& p1) {
        constexpr bool kOut = decltype(out)::value;
        // a dead slot (i >= K*L) has k >= K, so b0 >= B and no real block
        const int k = i / L;
        const int l = i - k * L;
        const int b0 = k * Bc;
        const int real = max(0, min(Bc, B - b0));
        if (kOut && threadIdx.x < kLanes) {
          if (B == 0 && k == 0) {
            end[2 * l] = state[2 * l];  // K = 1: item l is lane l
            end[2 * l + 1] = state[2 * l + 1];
          }
          end_lane[threadIdx.x] = B > 0 && k == (B - 1) / Bc ? l : -1;
        }
        const size_t first =
            static_cast<size_t>(b0) * kBlockSamples * L + l;
        search_chain<BITS, kOut>(sh, pcm, profiles, recon_out, first,
                                 b0 * L + l, L, Bc, real, p0, p1);
        if constexpr (kOut) {
          __syncthreads();  // every profile and recon rows 30-31 are visible
          emit_chain<BITS>(sh, pcm, profiles, coded, recon_out, first,
                           b0 * L + l, L, real);
          // this thread wrote the recon rows 30-31 of block B - 1
          const int last = threadIdx.x < kLanes ? end_lane[threadIdx.x] : -1;
          if (last >= 0) {
            const size_t row = (static_cast<size_t>(B - 1) * kBlockSamples
                                + kBlockSamples - 1) * L + last;
            end[2 * last] = recon_out[row];
            end[2 * last + 1] = recon_out[row - L];
          }
        }
      });
}

const void* pick_kernel(int bits) {
  switch (bits) {
    case 4: return reinterpret_cast<const void*>(&encode_fixpoint_kernel<4>);
    case 6: return reinterpret_cast<const void*>(&encode_fixpoint_kernel<6>);
    case 8: return reinterpret_cast<const void*>(&encode_fixpoint_kernel<8>);
    default: return nullptr;
  }
}

}  // namespace
}  // namespace bjxa

// CTAs of the search fixed point that fit on one SM at once (the persistent
// grid is this times the SM count at most), or minus a CUDA error code.
extern "C" int bjxa_encode_fixpoint_occupancy(int bits, int device) {
  return bjxa::coop_occupancy(bjxa::pick_kernel(bits), device, 0,
                              bjxa::kEncodeThreads);
}

// One cooperative launch of `ctas` CTAs on `stream`, without synchronising:
// K chunks of Bc blocks that cover B (K*Bc >= B; whole chunks of pad are
// allowed; (K + 32)*Bc < 2^31), or B = 0 and K = 1; 4*K*L + 4 < 2^31; scratch int32[4 + 4*K*L] (4 elements are enough when K = 1),
// scratch[2] receives the round count.  A refused launch returns its
// error.
extern "C" int bjxa_encode_fixpoint(const void* pcm, const void* state,
                                    void* profiles, void* coded, void* recon,
                                    void* end, void* scratch, int B, int L,
                                    int K, int Bc, int bits, int ctas,
                                    int device, void* stream) {
  // a ragged tile's dead slots index chunks up to K + 31
  const long long blocks = static_cast<long long>(K) * Bc;
  const bool covered =
      B == 0 ? K == 1
             : K >= 1 && Bc >= 1 && blocks >= B &&
                   static_cast<long long>(K + bjxa::kTileItems) * Bc <
                       (1LL << 31);
  const bool indexed = static_cast<long long>(K) * L * 4 + 4 < (1LL << 31);
  if (B < 0 || L <= 0 || !covered || !indexed || ctas <= 0 ||
      scratch == nullptr || state == nullptr || end == nullptr ||
      (B > 0 && (pcm == nullptr || profiles == nullptr || coded == nullptr ||
                 recon == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* x = static_cast<const int16_t*>(pcm);
  auto* st = static_cast<const int32_t*>(state);
  auto* prof = static_cast<int32_t*>(profiles);
  auto* cd = static_cast<int16_t*>(coded);
  auto* rc = static_cast<int16_t*>(recon);
  auto* e = static_cast<int32_t*>(end);
  auto* sc = static_cast<int32_t*>(scratch);
  void* args[] = {&x, &st, &prof, &cd, &rc, &e, &sc, &B, &L, &K, &Bc};
  return bjxa::coop_launch(bjxa::pick_kernel(bits), args, ctas, device,
                           stream, 0, bjxa::kEncodeThreads);
}
