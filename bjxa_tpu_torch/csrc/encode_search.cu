// Exhaustive profile-search XA encode over lanes, one serial chain a lane.
//
// Replaces the TPU kernel bjxa_tpu/ops/pallas_encode.py:_encode_kernel (the
// work of encode_search_pallas_core, without the TPU's tiling).  For each
// lane, blocks run in order and the predictor taps (p0, p1) carry from block
// to block; each block is the 80-candidate search of encode_block.cuh, which
// holds the arithmetic, the reduction, the winner's re-run and their
// exactness hazards.  Bit-exact with bjxa_tpu_torch.ops.cuda_encode's plain
// version, the JAX scan encoder and the native encoder.
//
// Layout: pcm int16[B, 32, L], state int32[L, 2], profiles int32[B, L],
// coded and recon int16[B, 32, L], end int32[L, 2]; lanes are minor.
//
// Bound: integer issue.  Per candidate-sample the search runs ~15 integer
// and 2 float operations, 2,560 candidate-samples per block and lane,
// against 2 bytes read and 4 written per sample.  Hopper issues the integer
// ALU operations (shifts, min/max, adds) at 64 lanes a clock per SM, half
// the float rate, so the floor of this design lies between the
// one-instruction-a-lane-a-clock bound and twice it, by how many integer
// operations ptxas moves to the multiply-add pipe.
//
// Design: one CTA of 16 warps (512 threads) owns 32 consecutive lanes and
// walks all B blocks of them (search_chain), then re-runs the winners off
// the chain (emit_chain).  At the main path's 8,192 lanes that is 256 CTAs,
// two resident on each SM.  At few lanes it is one CTA on one SM of 132:
// encode_fixpoint.cu cuts such a stream into chunks instead.  Lanes >= L
// run on zeros and store nothing.
#include "encode_block.cuh"

namespace bjxa {
namespace {

template <int BITS>
__global__ void __launch_bounds__(kEncodeThreads, 2)
encode_search_kernel(const int16_t* __restrict__ pcm,
                     const int32_t* __restrict__ state,
                     int32_t* __restrict__ profiles,
                     int16_t* __restrict__ coded,
                     int16_t* __restrict__ recon_out,
                     int32_t* __restrict__ end, int B, int L) {
  __shared__ SearchShared sh;
  const int t = threadIdx.x % kLanes;
  const int w = threadIdx.x / kLanes;
  const int l = blockIdx.x * kLanes + t;
  const bool live = l < L;

  // warp 0 holds each lane's carried state
  int32_t p0 = 0;
  int32_t p1 = 0;
  if (w == 0 && live) {
    p0 = state[2 * l];
    p1 = state[2 * l + 1];
  }
  const int real = live ? B : 0;
  search_chain<BITS, true>(sh, pcm, profiles, recon_out, l, l, L, B, real,
                           p0, p1);
  if (w == 0 && live) {
    end[2 * l] = p0;
    end[2 * l + 1] = p1;
  }
  __syncthreads();  // every profile and recon rows 30-31 are visible
  emit_chain<BITS>(sh, pcm, profiles, coded, recon_out, l, l, L, real);
}

template <int BITS>
void launch(const int16_t* pcm, const int32_t* state, int32_t* profiles,
            int16_t* coded, int16_t* recon, int32_t* end, int B, int L,
            cudaStream_t s) {
  const int grid = (L + kLanes - 1) / kLanes;
  encode_search_kernel<BITS><<<grid, kEncodeThreads, 0, s>>>(
      pcm, state, profiles, coded, recon, end, B, L);
}

}  // namespace
}  // namespace bjxa

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int bjxa_encode_search(const void* pcm, const void* state,
                                  void* profiles, void* coded, void* recon,
                                  void* end, int B, int L, int bits,
                                  int device, void* stream) {
  if (B < 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const auto* x = static_cast<const int16_t*>(pcm);
  const auto* st = static_cast<const int32_t*>(state);
  auto* prof = static_cast<int32_t*>(profiles);
  auto* cd = static_cast<int16_t*>(coded);
  auto* rc = static_cast<int16_t*>(recon);
  auto* e = static_cast<int32_t*>(end);
  auto s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 4: bjxa::launch<4>(x, st, prof, cd, rc, e, B, L, s); break;
    case 6: bjxa::launch<6>(x, st, prof, cd, rc, e, B, L, s); break;
    case 8: bjxa::launch<8>(x, st, prof, cd, rc, e, B, L, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
