// Exhaustive profile-search XA encode over lanes.
//
// Replaces the TPU kernel bjxa_tpu/ops/pallas_encode.py:_encode_kernel (the
// work of encode_search_pallas_core, without the TPU's tiling).  For each
// lane, blocks run in order and the predictor taps (p0, p1) carry from block
// to block.  Each block evaluates the 80 candidate profiles factor*16 +
// range (factor 0-4, range 0-15); every candidate runs the real decoder
// recurrence over the 32 samples
//   pred  = trunc((a0*k0 + a1*k1) / 256)
//   q     = clip(r <= 16-BITS ? (diff + bias) >> (16-BITS-r)
//                             : diff << (r-16+BITS))
//   recon = clamp_i16(((q << (16-BITS)) >> r) + pred)
// and sums its squared error in float32, in sample order.  The first strict
// minimum wins (the order is factor*16 + range, starting from +inf: the
// ranking contract of docs/bjxa-tpu.3.md).  The winner is re-run to write
// coded = q << (16-BITS) as int16, the exact reconstruction and the profile,
// and its last two reconstructed samples become the carried state.  Bit-exact
// with bjxa_tpu_torch.ops.cuda_encode's plain version, the JAX scan encoder
// and the native encoder (bjxa_tpu/native/xa_core.h).
//
// Layout: pcm int16[B, 32, L], state int32[L, 2], profiles int32[B, L],
// coded and recon int16[B, 32, L], end int32[L, 2]; lanes are minor.
//
// Design: one thread owns one lane.  Its blocks loop in the thread with
// (p0, p1) in registers, which replaces the TPU kernel's sequential block
// grid axis and its VMEM state scratch; the lane bound check replaces the
// lane and block padding of encode_search_pallas (a caller's own pad blocks,
// such as the fixed point's, stay as they are).  The 32 target samples of a
// block are loaded once into registers, lane-minor, so neighbouring threads
// read neighbouring addresses.  The kernel is templated on BITS and the 80
// candidates are unrolled at compile time (as the TPU kernel's
// specialize=True variant unrolls its ranges): every quantisation shift,
// bias, clip bound and factor gain is an immediate.
//
// Bound: integer issue.  Per candidate-sample it runs ~15 integer ops and 2
// float ops, 2,560 candidate-samples per block, against 2 bytes read and 4
// written per sample.  One thread per lane gives only 8,192 threads at the
// main path's shape (4096 chunks x 2 channels): 256 warps, at most one per
// SM sub-partition, so each warp's dependent chain is exposed; 64-thread
// blocks spread those warps over 128 SMs instead of 64.  Splitting the 80
// candidates across threads (keeping the first-minimum tie-break) is the
// lever, left to later work.
//
// Exactness hazards handled here:
// * FMA contraction: nvcc fuses err + e*e into one FFMA by default, which
//   rounds once where every reference rounds twice (and so can rank a
//   near-tie differently); the sum is written __fadd_rn(err, __fmul_rn(e, e)).
//   e = (float)(x - recon) is exact, since |e| < 2^24.
// * A left shift of a negative int is undefined in C++17: every left shift
//   of a signed value goes through uint32_t (shl below).
#include <cmath>

#include "adpcm.cuh"

namespace bjxa {
namespace {

constexpr int kEncodeThreads = 64;
constexpr int kFactors = 5;
constexpr int kRanges = 16;

// Fixed-point (x256) gains as compile-time constants (ops/tables.py).
template <int F>
constexpr int32_t kGainK0 =
    F == 0 ? 0 : F == 1 ? 240 : F == 2 ? 460 : F == 3 ? 392 : 488;
template <int F>
constexpr int32_t kGainK1 = F <= 1 ? 0 : F == 2 ? -208 : F == 3 ? -220 : -240;

// v << s for any sign of v, as two's complement wraps it.
__device__ __forceinline__ int32_t shl(int32_t v, int s) {
  return static_cast<int32_t>(static_cast<uint32_t>(v) << s);
}

__device__ __forceinline__ int32_t clip(int32_t v, int32_t lo, int32_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Squared reconstruction error of candidate (F, R) over one block, from
// state (p0, p1): every shift, bias, bound and gain is an immediate.
template <int BITS, int F, int R>
__device__ __forceinline__ float candidate_error(
    const int32_t (&x)[kBlockSamples], int32_t p0, int32_t p1) {
  constexpr int kShq = 16 - BITS;
  constexpr int32_t kQmin = -(1 << (BITS - 1));
  constexpr int32_t kQmax = (1 << (BITS - 1)) - 1;
  constexpr int kDown = R <= kShq ? kShq - R : 0;
  constexpr int kUp = R > kShq ? R - kShq : 0;
  constexpr int32_t kBias = (1 << kDown) >> 1;
  int32_t a0 = p0;
  int32_t a1 = p1;
  float err = 0.0f;
#pragma unroll
  for (int n = 0; n < kBlockSamples; ++n) {
    const int32_t pred = trunc_div_256(a0 * kGainK0<F> + a1 * kGainK1<F>);
    const int32_t diff = x[n] - pred;
    // ((q << kShq) >> R) folds to one shift: exact in the down case (no bits
    // are lost) and a power-of-two floor either way in the up case.
    int32_t recon;
    if constexpr (R <= kShq) {
      const int32_t q = clip((diff + kBias) >> kDown, kQmin, kQmax);
      recon = shl(q, kDown) + pred;
    } else {
      const int32_t q = clip(shl(diff, kUp), kQmin, kQmax);
      recon = (q >> kUp) + pred;
    }
    recon = clip(recon, -32768, 32767);
    const float e = static_cast<float>(x[n] - recon);
    err = __fadd_rn(err, __fmul_rn(e, e));  // two roundings, never an FFMA
    a1 = a0;
    a0 = recon;
  }
  return err;
}

// Candidates (F, R) .. (4, 15) in order; a strictly smaller error replaces
// the best, so ties keep the earliest candidate.
template <int BITS, int F, int R>
__device__ __forceinline__ void sweep(const int32_t (&x)[kBlockSamples],
                                      int32_t p0, int32_t p1, float& best_err,
                                      int& best_prof) {
  const float err = candidate_error<BITS, F, R>(x, p0, p1);
  if (err < best_err) {
    best_err = err;
    best_prof = (F << 4) | R;
  }
  if constexpr (R + 1 < kRanges) {
    sweep<BITS, F, R + 1>(x, p0, p1, best_err, best_prof);
  } else if constexpr (F + 1 < kFactors) {
    sweep<BITS, F + 1, 0>(x, p0, p1, best_err, best_prof);
  }
}

template <int BITS>
__global__ void __launch_bounds__(kEncodeThreads)
encode_search_kernel(const int16_t* __restrict__ pcm,
                     const int32_t* __restrict__ state,
                     int32_t* __restrict__ profiles,
                     int16_t* __restrict__ coded,
                     int16_t* __restrict__ recon_out,
                     int32_t* __restrict__ end, int B, int L) {
  constexpr int kShq = 16 - BITS;
  constexpr int32_t kQmin = -(1 << (BITS - 1));
  constexpr int32_t kQmax = (1 << (BITS - 1)) - 1;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const size_t lanes = static_cast<size_t>(L);
  int32_t p0 = state[2 * l];
  int32_t p1 = state[2 * l + 1];
  for (int b = 0; b < B; ++b) {
    const size_t row = static_cast<size_t>(b) * kBlockSamples * lanes + l;
    int32_t x[kBlockSamples];
#pragma unroll
    for (int n = 0; n < kBlockSamples; ++n) x[n] = pcm[row + n * lanes];

    float best_err = INFINITY;
    int best_prof = 0;
    sweep<BITS, 0, 0>(x, p0, p1, best_err, best_prof);

    // re-run the winner with run-time shifts to emit its output and state
    const int factor = best_prof >> 4;
    const int r = best_prof & 0x0F;
    const int32_t k0 = gain_k0(factor);
    const int32_t k1 = gain_k1(factor);
    const int sh_down = r <= kShq ? kShq - r : 0;
    const int sh_up = r > kShq ? r - kShq : 0;
    const int32_t bias = (1 << sh_down) >> 1;
#pragma unroll
    for (int n = 0; n < kBlockSamples; ++n) {
      const int32_t pred = trunc_div_256(p0 * k0 + p1 * k1);
      const int32_t diff = x[n] - pred;
      const int32_t q = clip(
          r <= kShq ? (diff + bias) >> sh_down : shl(diff, sh_up), kQmin,
          kQmax);
      const int32_t d = shl(q, kShq);
      const int32_t s = clip((d >> r) + pred, -32768, 32767);
      coded[row + n * lanes] = static_cast<int16_t>(d);
      recon_out[row + n * lanes] = static_cast<int16_t>(s);
      p1 = p0;
      p0 = s;
    }
    profiles[static_cast<size_t>(b) * lanes + l] = best_prof;
  }
  end[2 * l] = p0;
  end[2 * l + 1] = p1;
}

template <int BITS>
void launch(const int16_t* pcm, const int32_t* state, int32_t* profiles,
            int16_t* coded, int16_t* recon, int32_t* end, int B, int L,
            cudaStream_t s) {
  const int grid = (L + kEncodeThreads - 1) / kEncodeThreads;
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
