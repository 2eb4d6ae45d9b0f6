// The per-block body of the profile-search encode, shared by the serial
// search (encode_search.cu) and its chunk fixed point (encode_fixpoint.cu):
// one CTA of 16 warps searches 32 chains of blocks, one a thread of a warp.
//
// Per block, each of the 80 candidate profiles factor*16 + range (factor
// 0-4, range 0-15) runs the real decoder recurrence over the 32 samples
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
// Layout: pcm int16[B, 32, L], profiles int32[B, L], coded and recon
// int16[B, 32, L]; lanes are minor.  Thread t of every warp serves chain t
// of the CTA: a lane l and a first block b0 that the kernel chooses, given
// to the body as the chain's first sample, first = b0*32*L + l, and first
// profile, prow = b0*L + l (B*L < 2^31: a card holds no 128 GB of PCM).
//
// Design:
// * Warp w searches range R = w for all 32 chains; each thread runs its
//   range's 5 factors as 5 interleaved, independent chains (5-way ILP).  The
//   warp index selects a template instantiated per R, so the range is
//   warp-uniform, every shift, bias, clip bound and gain is an immediate,
//   and no branch on range or factor diverges inside a warp.  With
//   __launch_bounds__(512, 2) (at most 64 registers) two CTAs fit an SM: 32
//   warps and 160 independent chains.  The sample loop is not unrolled: the
//   16 warps of a CTA run 16 different instruction streams, and instruction
//   fetch, not the ALU, limits a CTA whose streams outgrow the instruction
//   cache.  On an H100 each unrolled form was slower than the rolled loop,
//   the more so the larger it was and the more SMs were busy, though the
//   rolled loop pays two moves a chain a sample for the (a0, a1) rotation;
//   benchmarks/search_unroll.py measures it (PERF.md, section 6).
// * The block's target tile, int16[32 samples][32 chains], is staged once in
//   shared memory (widened to int32) and read there by all 16 warps; the
//   next block's tile is loaded into registers while this one is searched.
// * Reduction: each thread keeps the first strict minimum over its factors
//   (factor order is candidate order within a range).  The 16 per-range
//   winners of a chain meet in shared memory and warp 0 takes the
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
//   and 30 (the first block's is kept in shared memory); so it runs after
//   the block loop, off the serial chain, with all 16 warps re-running
//   blocks w, w + 16, ... in parallel with run-time shifts (selects, not
//   branches).  It writes recon rows 0-29 only: rows 30 and 31 are already
//   there (the same values) and are another warp's entry state, so no
//   location is written twice.
// * A chain's blocks past its real count (dead threads: all of them) run on
//   zeros and store nothing.  No thread returns early: every thread reaches
//   every barrier.
//
// Narrow tiles (the fixed point's, encode_fixpoint.cu, search_chain_narrow):
// the same search over W < 32 chains, with two threads for each (chain,
// range), one running factors 0-2 and one factors 3-4, so a CTA is 32*W
// threads, W warps.  A warp then holds 32/W ranges, so the range cannot be
// an immediate: its shift, bias and bounds are run-time values, one formula
// for both cases (step_q), while the factors' gains stay immediates.  The
// factor halves are warp-uniform, and at W = 8 each of an SM's four
// schedulers gets a warp of each (5 steps a sample between them, as one
// warp of a 32-wide tile), so a tile alone keeps two warps a scheduler in
// flight.  A warp takes the best of its (half, range) pairs by shuffles,
// and thread t < W the best of the W warps' winners, lexicographically on
// (err, profile) as everywhere.  The serial kernel's body, search_chain and
// the W = 32 instantiations below, is the one it always was.
//
// Exactness hazards handled here:
// * FMA contraction: nvcc fuses err + e*e into one FFMA by default, which
//   rounds once where every reference rounds twice (and so can rank a
//   near-tie differently); the sum is written __fadd_rn(err, __fmul_rn(e, e)).
//   e = (float)(x - recon) is exact, since |e| < 2^24.  No --use_fast_math.
// * A left shift of a negative int is undefined in C++17: every left shift
//   of a signed value goes through uint32_t (shl below).
#pragma once

#include <type_traits>

#include "adpcm.cuh"

namespace bjxa {

constexpr int kLanes = 32;  // chains of a CTA: one per thread of a warp
constexpr int kFactors = 5;
constexpr int kRanges = 16;  // one warp per range
constexpr int kEncodeThreads = kLanes * kRanges;

// Threads of a search CTA over W chains: a warp a range at 32 chains, two
// threads a (chain, range) below.
template <int W>
constexpr int kTileThreads = W == kLanes ? kEncodeThreads : 2 * kRanges * W;
// Winners a chain's reduction takes from shared memory: a range's at 32
// chains, a warp's below.
template <int W>
constexpr int kWinners = W == kLanes ? kRanges : kTileThreads<W> / kLanes;

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

// What a search CTA of W chains keeps in shared memory.  A narrow tile keeps
// its targets as int16 (its global load feeds the store as it is).
template <int W>
struct TileShared {
  std::conditional_t<W == kLanes, int32_t, int16_t>
      tile[kBlockSamples][W];  // the block's targets
  float win_err[kWinners<W>][W];   // the per-range (per-warp) winners
  int32_t win_prof[kWinners<W>][W];
  int32_t win_p0[kWinners<W>][W];
  int32_t win_p1[kWinners<W>][W];
  int32_t carry[2][W];  // each chain's state for the next block
  int32_t entry[2][W];  // each chain's state before its first block
};

// What a CTA of 32 chains, a warp a range, keeps.
using SearchShared = TileShared<kLanes>;

// The 5 factors of range R for chain t of the tile, from state (p0, p1), as
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

// One sample of candidate (F, r) for a range r known at run time: step's
// arithmetic with the quantizer's shift `down`, bias and bounds [lo, hi] in
// registers.  Range r <= 16-BITS gives down = 16-BITS-r, bias = half its
// step and the full bounds, which is step's down case; a higher range gives
// down = 0, bias = 0 and the bounds shifted down by r-16+BITS, where the
// formula is step's clip(diff, lo, hi) of the up case.  The same values in
// fewer instructions, each on the recurrence's chain but the last: the
// truncating /256 adds 255 to a negative sum as the top byte of its sign
// (one LEA.HI), the clips are min(max()) (two VIMNMX where lo <= hi, not a
// compare and a select), and the error is converted without I2F, which
// issues at a quarter of the rate: 0x4B400000 is 1.5 * 2^23 as a float, so
// its bits plus an integer |d| < 2^22 are 1.5 * 2^23 + d exactly, and
// subtracting 1.5 * 2^23 leaves d as a float (|x - recon| < 2^17).
template <int F>
__device__ __forceinline__ void step_q(int32_t x, int down, int32_t bias,
                                       int32_t lo, int32_t hi, int32_t& a0,
                                       int32_t& a1, float& err) {
  const int32_t g = a0 * kGainK0<F> + a1 * kGainK1<F>;
  const int32_t pred =
      (g + static_cast<int32_t>(static_cast<uint32_t>(g >> 31) >> 24)) >> 8;
  const int32_t diff = x - pred;
  const int32_t delta = shl(min(max((diff + bias) >> down, lo), hi), down);
  const int32_t recon = min(max(delta + pred, -32768), 32767);
  const float e =
      __fsub_rn(__int_as_float(0x4B400000 + (x - recon)), 12582912.0f);
  err = __fadd_rn(err, __fmul_rn(e, e));  // two roundings, never an FFMA
  a1 = a0;
  a0 = recon;
}

// search_range<BITS, R> for a range r known at run time, over factors F0
// .. F0 + NF - 1 (a narrow tile's half): NF interleaved chains for chain t
// of the tile from state (p0, p1); ties keep the lower factor.  All of a
// narrow tile's warps run this one stream, so its sample loop is unrolled
// four times (the 32-wide body's 16 streams are not: there the instruction
// cache decides); the loop's own instructions and the (a0, a1) moves are
// what that saves.
template <int BITS, int F0, int NF, int W, class T>
__device__ __forceinline__ Winner search_range_q(
    const T (&tile)[kBlockSamples][W], int t, int r, int32_t p0,
    int32_t p1) {
  constexpr int kShq = 16 - BITS;
  const int down = r <= kShq ? kShq - r : 0;
  const int up = r <= kShq ? 0 : r - kShq;
  const int32_t bias = (1 << down) >> 1;
  const int32_t lo = -(1 << (BITS - 1)) >> up;
  const int32_t hi = ((1 << (BITS - 1)) - 1) >> up;
  int32_t a0[NF], a1[NF];
  float err[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    a0[f] = p0;
    a1[f] = p1;
    err[f] = 0.0f;
  }
#pragma unroll 4
  for (int n = 0; n < kBlockSamples; ++n) {
    const int32_t target = tile[n][t];
    step_q<F0>(target, down, bias, lo, hi, a0[0], a1[0], err[0]);
    step_q<F0 + 1>(target, down, bias, lo, hi, a0[1], a1[1], err[1]);
    if constexpr (NF > 2) {
      step_q<F0 + 2>(target, down, bias, lo, hi, a0[2], a1[2], err[2]);
    }
  }
  Winner best{err[0], (F0 << 4) | r, a0[0], a1[0]};
#pragma unroll
  for (int f = 1; f < NF; ++f) {
    if (err[f] < best.err) {
      best = Winner{err[f], ((F0 + f) << 4) | r, a0[f], a1[f]};
    }
  }
  return best;
}

// Threads 0..W-1's lexicographic (err, profile) minimum over the winners
// of chain t in shared memory (the 16 ranges', or the W warps' of a narrow
// tile): the profile, and the winner's end state in (p0, p1).
template <int W>
__device__ __forceinline__ int32_t best_of_ranges(const TileShared<W>& sh,
                                                  int t, int32_t& p0,
                                                  int32_t& p1) {
  float best_err = sh.win_err[0][t];
  int32_t best_prof = sh.win_prof[0][t];
  p0 = sh.win_p0[0][t];
  p1 = sh.win_p1[0][t];
#pragma unroll
  for (int r = 1; r < kWinners<W>; ++r) {
    const float e = sh.win_err[r][t];
    const int32_t prof = sh.win_prof[r][t];
    if (e < best_err || (e == best_err && prof < best_prof)) {
      best_err = e;
      best_prof = prof;
      p0 = sh.win_p0[r][t];
      p1 = sh.win_p1[r][t];
    }
  }
  return best_prof;
}

// Search n blocks of each thread's chain (first, prow) in order, the whole
// CTA together (n is CTA-uniform), from the state (p0, p1) of warp 0's
// thread t; on return warp 0 holds the state after the last block.  Blocks
// from `real` on (a thread's own count, 0 for a dead thread) read zeros and
// store nothing.  With WRITE, warp 0 writes each real block's profile and
// recon rows 30-31, and the entry state goes to sh.entry for emit_chain.
template <int BITS, bool WRITE>
__device__ __forceinline__ void search_chain(
    SearchShared& sh, const int16_t* __restrict__ pcm,
    int32_t* __restrict__ profiles, int16_t* __restrict__ recon_out,
    size_t first, int prow, int L, int n, int real, int32_t& p0,
    int32_t& p1) {
  const int t = threadIdx.x % kLanes;
  const int w = threadIdx.x / kLanes;
  const size_t lanes = static_cast<size_t>(L);
  if (w == 0) {
    sh.carry[0][t] = p0;
    sh.carry[1][t] = p1;
    if constexpr (WRITE) {
      sh.entry[0][t] = p0;
      sh.entry[1][t] = p1;
    }
  }
  // warp w stages samples w and w + 16 of each block's tile
  int32_t x_lo = 0;
  int32_t x_hi = 0;
  if (real > 0) {
    x_lo = pcm[first + w * lanes];
    x_hi = pcm[first + (w + kRanges) * lanes];
  }
  for (int j = 0; j < n; ++j) {
    // every read of the previous tile, carry and winners came before the
    // last barrier
    sh.tile[w][t] = x_lo;
    sh.tile[w + kRanges][t] = x_hi;
    __syncthreads();
    x_lo = 0;
    x_hi = 0;
    if (j + 1 < real) {
      const size_t next =
          first + static_cast<size_t>(j + 1) * kBlockSamples * lanes;
      x_lo = pcm[next + w * lanes];
      x_hi = pcm[next + (w + kRanges) * lanes];
    }
    const Winner mine =
        search_warp<BITS>(w, sh.tile, t, sh.carry[0][t], sh.carry[1][t]);
    sh.win_err[w][t] = mine.err;
    sh.win_prof[w][t] = mine.prof;
    sh.win_p0[w][t] = mine.p0;
    sh.win_p1[w][t] = mine.p1;
    __syncthreads();
    if (w == 0) {
      const int32_t prof = best_of_ranges(sh, t, p0, p1);
      sh.carry[0][t] = p0;
      sh.carry[1][t] = p1;
      if (WRITE && j < real) {
        const size_t row =
            first + static_cast<size_t>(j) * kBlockSamples * lanes;
        profiles[prow + j * L] = prof;
        recon_out[row + (kBlockSamples - 2) * lanes] =
            static_cast<int16_t>(p1);
        recon_out[row + (kBlockSamples - 1) * lanes] =
            static_cast<int16_t>(p0);
      }
    }
  }
}

// search_chain for a narrow tile of W < 32 chains (a CTA of 32*W threads):
// thread (t, s) = (tid % W, tid / W) stages sample s of chain t's block and
// searches range s % 16 of it, factors 0-2 where s < 16, 3-4 otherwise;
// the same contract, threads t < W in warp 0's place.
template <int BITS, bool WRITE, int W>
__device__ __forceinline__ void search_chain_narrow(
    TileShared<W>& sh, const int16_t* __restrict__ pcm,
    int32_t* __restrict__ profiles, int16_t* __restrict__ recon_out,
    size_t first, int prow, int L, int n, int real, int32_t& p0,
    int32_t& p1) {
  static_assert(W < kLanes && kLanes % W == 0, "a warp holds whole chains");
  const int t = threadIdx.x % W;
  const int s = threadIdx.x / W;
  const size_t lanes = static_cast<size_t>(L);
  if (threadIdx.x < W) {
    sh.carry[0][t] = p0;
    sh.carry[1][t] = p1;
    if constexpr (WRITE) {
      sh.entry[0][t] = p0;
      sh.entry[1][t] = p1;
    }
  }
  int16_t x = real > 0 ? pcm[first + s * lanes] : 0;
  for (int j = 0; j < n; ++j) {
    // every read of the previous tile, carry and winners came before the
    // last barrier
    sh.tile[s][t] = x;
    __syncthreads();
    x = 0;
    if (j + 1 < real) {
      x = pcm[first + (static_cast<size_t>(j + 1) * kBlockSamples + s) *
                          lanes];
    }
    const int r = s % kRanges;
    Winner mine =
        s < kRanges
            ? search_range_q<BITS, 0, 3>(sh.tile, t, r, sh.carry[0][t],
                                         sh.carry[1][t])
            : search_range_q<BITS, 3, 2>(sh.tile, t, r, sh.carry[0][t],
                                         sh.carry[1][t]);
    // the warp's best of its (half, range) pairs of chain t
#pragma unroll
    for (int m = W; m < kLanes; m *= 2) {
      const float e = __shfl_xor_sync(0xffffffffu, mine.err, m);
      const int32_t prof = __shfl_xor_sync(0xffffffffu, mine.prof, m);
      const int32_t q0 = __shfl_xor_sync(0xffffffffu, mine.p0, m);
      const int32_t q1 = __shfl_xor_sync(0xffffffffu, mine.p1, m);
      if (e < mine.err || (e == mine.err && prof < mine.prof)) {
        mine = Winner{e, prof, q0, q1};
      }
    }
    const int warp = threadIdx.x / kLanes;
    if (threadIdx.x % kLanes < W) {
      sh.win_err[warp][t] = mine.err;
      sh.win_prof[warp][t] = mine.prof;
      sh.win_p0[warp][t] = mine.p0;
      sh.win_p1[warp][t] = mine.p1;
    }
    __syncthreads();
    if (threadIdx.x < W) {
      const int32_t prof = best_of_ranges(sh, t, p0, p1);
      sh.carry[0][t] = p0;
      sh.carry[1][t] = p1;
      if (WRITE && j < real) {
        const size_t row =
            first + static_cast<size_t>(j) * kBlockSamples * lanes;
        profiles[prow + j * L] = prof;
        recon_out[row + (kBlockSamples - 2) * lanes] =
            static_cast<int16_t>(p1);
        recon_out[row + (kBlockSamples - 1) * lanes] =
            static_cast<int16_t>(p0);
      }
    }
  }
}

// Re-run the winning profile `prof` of the block at `row` (its sample 0 of
// its lane) from its entry state (p0, p1), and write coded rows 0-31 and
// recon rows 0-29 (run-time shifts and gains).
template <int BITS>
__device__ __forceinline__ void emit_block(
    const int16_t* __restrict__ pcm, int16_t* coded, int16_t* recon_out,
    size_t row, size_t lanes, int prof,
    int32_t p0, int32_t p1) {
  constexpr int kShq = 16 - BITS;
  constexpr int32_t kQmin = -(1 << (BITS - 1));
  constexpr int32_t kQmax = (1 << (BITS - 1)) - 1;
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

// The winners' re-runs of the real blocks of each thread's chain (first,
// prow) after search_chain<BITS, true> (or its narrow form) and a barrier:
// thread (t, w) = (tid % W, tid / W) takes blocks w, w + S, ... of chain t,
// S the CTA's threads over W; the first enters from sh.entry, every later
// one from the previous block's recon rows 31 and 30.
template <int BITS, int W>
__device__ __forceinline__ void emit_chain(
    const TileShared<W>& sh, const int16_t* __restrict__ pcm,
    const int32_t* profiles, int16_t* coded, int16_t* recon_out,
    size_t first, int prow, int L, int real) {
  const int t = threadIdx.x % W;
  const size_t lanes = static_cast<size_t>(L);
  for (int j = threadIdx.x / W; j < real; j += kTileThreads<W> / W) {
    const size_t row =
        first + static_cast<size_t>(j) * kBlockSamples * lanes;
    int32_t p0, p1;
    if (j == 0) {
      p0 = sh.entry[0][t];
      p1 = sh.entry[1][t];
    } else {  // the previous block's recon rows 31 and 30
      p0 = recon_out[row - lanes];
      p1 = recon_out[row - 2 * lanes];
    }
    emit_block<BITS>(pcm, coded, recon_out, row, lanes, profiles[prow + j * L],
                     p0, p1);
  }
}

}  // namespace bjxa
