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
// ranking contract of docs/bjxa-tpu.3.md).  The winner emits coded =
// q << (16-BITS) as int16, the exact reconstruction and the profile, and its
// last two reconstructed samples become the carried state.  Bit-exact with
// bjxa_tpu_torch.ops.cuda_encode's plain version, the JAX scan encoder and
// the native encoder (bjxa_tpu/native/xa_core.h).
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
// Design: one CTA of 16 warps (512 threads) owns 32 consecutive lanes.
// * Warp w searches range R = w for all 32 lanes; thread t owns lane
//   32*blockIdx.x + t.  Each thread runs its range's 5 factors as 5
//   interleaved, independent chains (5-way ILP).  The warp index selects a
//   template instantiated per R, so the range is warp-uniform, every shift,
//   bias, clip bound and gain is an immediate, and no branch on range or
//   factor diverges inside a warp.  At the main path's 8,192 lanes that is
//   256 CTAs, two resident on each SM (__launch_bounds__(512, 2): at most 64
//   registers), 32 warps and 160 independent chains an SM, where one thread
//   per lane gave the SM one or two warps and exposed every dependent chain.
//   The sample loop is not unrolled: the 16 warps of a CTA run 16 different
//   instruction streams, and instruction fetch, not the ALU, limits a CTA
//   whose streams outgrow the instruction cache.  On an H100 each unrolled
//   form was slower than the rolled loop, the more so the larger it was and
//   the more SMs were busy, though the rolled loop pays two moves a chain a
//   sample for the (a0, a1) rotation; benchmarks/search_unroll.py measures
//   it (PERF.md, section 6).
// * The block's target tile, int16[32 samples][32 lanes], is staged once in
//   shared memory (widened to int32) and read there by all 16 warps; the
//   next block's tile is loaded into registers while this one is searched.
// * Reduction: each thread keeps the first strict minimum over its factors
//   (factor order is candidate order within a range).  The 16 per-range
//   winners of a lane meet in shared memory and warp 0 takes the
//   lexicographic minimum of (err, profile), profile = factor*16 + range,
//   which is the first minimum in candidate order.  A tie-break by range
//   index would not be: candidate 0x0F precedes 0x10, and exact ties are
//   common (the ranking contract's multiples of 1024).  Errors are finite
//   (at most 32 * 65535^2 < 2^37), so no NaN can reach the comparison.
// * Each winner carries its chain's end state (the last two reconstructed
//   samples), so the next block starts right after the reduction: warp 0
//   writes the profile, those two samples (recon rows 30 and 31) and the
//   state for the next block, which goes through shared memory and the next
//   __syncthreads().  The winner's full re-run, which emits coded and recon,
//   needs only its entry state, which is the previous block's recon rows 31
//   and 30; so it runs after the block loop, off the serial chain, with all
//   16 warps re-running blocks w, w + 16, ... in parallel with run-time
//   shifts (selects, not branches).  It writes recon rows 0-29 only: rows
//   30 and 31 are already there (the same values) and are another warp's
//   entry state, so no location is written twice.  The alternative, warp 0
//   re-running every lane inside the block loop, would put a 32-sample
//   dependent chain on every block's critical path while 15 warps wait.
// * Lanes >= L run on zeros and store nothing.  No thread returns early:
//   every thread reaches every barrier.
//
// Exactness hazards handled here:
// * FMA contraction: nvcc fuses err + e*e into one FFMA by default, which
//   rounds once where every reference rounds twice (and so can rank a
//   near-tie differently); the sum is written __fadd_rn(err, __fmul_rn(e, e)).
//   e = (float)(x - recon) is exact, since |e| < 2^24.  No --use_fast_math.
// * A left shift of a negative int is undefined in C++17: every left shift
//   of a signed value goes through uint32_t (shl below).
#include "adpcm.cuh"

namespace bjxa {
namespace {

constexpr int kLanes = 32;  // lanes of a CTA: one per thread of a warp
constexpr int kFactors = 5;
constexpr int kRanges = 16;  // one warp per range
constexpr int kEncodeThreads = kLanes * kRanges;

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

// One sample of candidate (F, R) from taps (a0, a1): every shift, bias,
// bound and gain is an immediate.
template <int BITS, int F, int R>
__device__ __forceinline__ void step(int32_t x, int32_t& a0, int32_t& a1,
                                     float& err) {
  constexpr int kShq = 16 - BITS;
  constexpr int32_t kQmin = -(1 << (BITS - 1));
  constexpr int32_t kQmax = (1 << (BITS - 1)) - 1;
  constexpr int kDown = R <= kShq ? kShq - R : 0;
  constexpr int kUp = R > kShq ? R - kShq : 0;
  constexpr int32_t kBias = (1 << kDown) >> 1;
  const int32_t pred = trunc_div_256(a0 * kGainK0<F> + a1 * kGainK1<F>);
  const int32_t diff = x - pred;
  // ((q << kShq) >> R) folds to one shift: exact in the down case (no bits
  // are lost) and a power-of-two floor in the up case.  There the floor is
  // monotone, so it commutes with the clip: clip(diff << kUp, lo, hi) >> kUp
  // = clip(diff, lo >> kUp, hi >> kUp), as |diff| << kUp never overflows.
  int32_t delta;
  if constexpr (R <= kShq) {
    delta = shl(clip((diff + kBias) >> kDown, kQmin, kQmax), kDown);
  } else {
    delta = clip(diff, kQmin >> kUp, kQmax >> kUp);
  }
  const int32_t recon = clip(delta + pred, -32768, 32767);
  const float e = static_cast<float>(x - recon);
  err = __fadd_rn(err, __fmul_rn(e, e));  // two roundings, never an FFMA
  a1 = a0;
  a0 = recon;
}

// A thread's best candidate of its range: error, profile and end state.
struct Winner {
  float err;
  int32_t prof;
  int32_t p0;
  int32_t p1;
};

// The 5 factors of range R for lane t of the tile, from state (p0, p1), as
// 5 interleaved chains; ties keep the lower factor.
template <int BITS, int R>
__device__ __forceinline__ Winner search_range(
    const int32_t (&tile)[kBlockSamples][kLanes], int t, int32_t p0,
    int32_t p1) {
  int32_t a0[kFactors], a1[kFactors];
  float err[kFactors];
#pragma unroll
  for (int f = 0; f < kFactors; ++f) {
    a0[f] = p0;
    a1[f] = p1;
    err[f] = 0.0f;
  }
#pragma unroll 1
  for (int n = 0; n < kBlockSamples; ++n) {
    const int32_t x = tile[n][t];
    step<BITS, 0, R>(x, a0[0], a1[0], err[0]);
    step<BITS, 1, R>(x, a0[1], a1[1], err[1]);
    step<BITS, 2, R>(x, a0[2], a1[2], err[2]);
    step<BITS, 3, R>(x, a0[3], a1[3], err[3]);
    step<BITS, 4, R>(x, a0[4], a1[4], err[4]);
  }
  Winner best{err[0], R, a0[0], a1[0]};
#pragma unroll
  for (int f = 1; f < kFactors; ++f) {
    if (err[f] < best.err) best = Winner{err[f], (f << 4) | R, a0[f], a1[f]};
  }
  return best;
}

// search_range<BITS, warp> for a warp-uniform warp index.
template <int BITS, int R = 0>
__device__ __forceinline__ Winner search_warp(
    int warp, const int32_t (&tile)[kBlockSamples][kLanes], int t,
    int32_t p0, int32_t p1) {
  if constexpr (R + 1 < kRanges) {
    if (warp != R) return search_warp<BITS, R + 1>(warp, tile, t, p0, p1);
  }
  return search_range<BITS, R>(tile, t, p0, p1);
}

// Re-run the winning profile of block b, lane l, from its entry state, and
// write coded rows 0-31 and recon rows 0-29 (run-time shifts and gains).
template <int BITS>
__device__ __forceinline__ void emit_block(
    const int16_t* __restrict__ pcm, const int32_t* __restrict__ state,
    const int32_t* profiles, int16_t* coded, int16_t* recon_out, int b,
    int l, size_t lanes) {
  constexpr int kShq = 16 - BITS;
  constexpr int32_t kQmin = -(1 << (BITS - 1));
  constexpr int32_t kQmax = (1 << (BITS - 1)) - 1;
  const size_t row = static_cast<size_t>(b) * kBlockSamples * lanes + l;
  int32_t p0, p1;
  if (b == 0) {
    p0 = state[2 * l];
    p1 = state[2 * l + 1];
  } else {  // the previous block's recon rows 31 and 30
    p0 = recon_out[row - lanes];
    p1 = recon_out[row - 2 * lanes];
  }
  const int prof = profiles[static_cast<size_t>(b) * lanes + l];
  const int factor = prof >> 4;
  const int r = prof & 0x0F;
  const int32_t k0 = gain_k0(factor);
  const int32_t k1 = gain_k1(factor);
  const bool down = r <= kShq;
  const int sh_down = down ? kShq - r : 0;
  const int sh_up = down ? 0 : r - kShq;
  const int32_t bias = (1 << sh_down) >> 1;
#pragma unroll
  for (int n = 0; n < kBlockSamples; ++n) {
    const int32_t x = pcm[row + n * lanes];
    const int32_t pred = trunc_div_256(p0 * k0 + p1 * k1);
    const int32_t diff = x - pred;
    const int32_t q_down = clip((diff + bias) >> sh_down, kQmin, kQmax);
    const int32_t q_up = clip(shl(diff, sh_up), kQmin, kQmax);
    const int32_t d = shl(down ? q_down : q_up, kShq);
    const int32_t s = clip((d >> r) + pred, -32768, 32767);
    coded[row + n * lanes] = static_cast<int16_t>(d);
    if (n < kBlockSamples - 2) {
      recon_out[row + n * lanes] = static_cast<int16_t>(s);
    }
    p1 = p0;
    p0 = s;
  }
}

template <int BITS>
__global__ void __launch_bounds__(kEncodeThreads, 2)
encode_search_kernel(const int16_t* __restrict__ pcm,
                     const int32_t* __restrict__ state,
                     int32_t* __restrict__ profiles,
                     int16_t* __restrict__ coded,
                     int16_t* __restrict__ recon_out,
                     int32_t* __restrict__ end, int B, int L) {
  __shared__ int32_t tile[kBlockSamples][kLanes];
  __shared__ float win_err[kRanges][kLanes];
  __shared__ int32_t win_prof[kRanges][kLanes];
  __shared__ int32_t win_p0[kRanges][kLanes];
  __shared__ int32_t win_p1[kRanges][kLanes];
  __shared__ int32_t carry[2][kLanes];

  const int t = threadIdx.x % kLanes;
  const int w = threadIdx.x / kLanes;
  const int l = blockIdx.x * kLanes + t;
  const bool live = l < L;
  const size_t lanes = static_cast<size_t>(L);

  // warp 0 holds each lane's carried state and shares it through `carry`
  int32_t p0 = 0;
  int32_t p1 = 0;
  if (w == 0) {
    if (live) {
      p0 = state[2 * l];
      p1 = state[2 * l + 1];
    }
    carry[0][t] = p0;
    carry[1][t] = p1;
  }
  // warp w stages samples w and w + 16 of each block's tile
  int32_t x_lo = 0;
  int32_t x_hi = 0;
  if (B > 0 && live) {
    x_lo = pcm[w * lanes + l];
    x_hi = pcm[(w + kRanges) * lanes + l];
  }
  for (int b = 0; b < B; ++b) {
    // every read of the previous tile, carry and winners came before the
    // last barrier
    tile[w][t] = x_lo;
    tile[w + kRanges][t] = x_hi;
    __syncthreads();
    if (b + 1 < B && live) {
      const size_t next = static_cast<size_t>(b + 1) * kBlockSamples * lanes;
      x_lo = pcm[next + w * lanes + l];
      x_hi = pcm[next + (w + kRanges) * lanes + l];
    }
    const Winner mine = search_warp<BITS>(w, tile, t, carry[0][t], carry[1][t]);
    win_err[w][t] = mine.err;
    win_prof[w][t] = mine.prof;
    win_p0[w][t] = mine.p0;
    win_p1[w][t] = mine.p1;
    __syncthreads();
    if (w == 0) {
      // lexicographic (err, profile) minimum over the 16 ranges
      float best_err = win_err[0][t];
      int32_t best_prof = win_prof[0][t];
      p0 = win_p0[0][t];
      p1 = win_p1[0][t];
#pragma unroll
      for (int r = 1; r < kRanges; ++r) {
        const float e = win_err[r][t];
        const int32_t prof = win_prof[r][t];
        if (e < best_err || (e == best_err && prof < best_prof)) {
          best_err = e;
          best_prof = prof;
          p0 = win_p0[r][t];
          p1 = win_p1[r][t];
        }
      }
      carry[0][t] = p0;
      carry[1][t] = p1;
      if (live) {
        const size_t row = static_cast<size_t>(b) * kBlockSamples * lanes + l;
        profiles[static_cast<size_t>(b) * lanes + l] = best_prof;
        recon_out[row + (kBlockSamples - 2) * lanes] = static_cast<int16_t>(p1);
        recon_out[row + (kBlockSamples - 1) * lanes] = static_cast<int16_t>(p0);
      }
    }
  }
  if (w == 0 && live) {
    end[2 * l] = p0;
    end[2 * l + 1] = p1;
  }
  __syncthreads();  // every profile and recon rows 30-31 are visible
  if (live) {
    for (int b = w; b < B; b += kRanges) {
      emit_block<BITS>(pcm, state, profiles, coded, recon_out, b, l, lanes);
    }
  }
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
