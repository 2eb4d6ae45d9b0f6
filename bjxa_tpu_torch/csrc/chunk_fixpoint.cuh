// The exact chunk fixed point of the chunked kernels, solved inside ONE
// launch, and the host side of the cooperative launch.  One schedule, two
// scopes: the grid of a cooperative launch (decode_words.cu and its
// ablations decode_variants.cu and loadstore_bound.cu, decode_stream.cu) or
// one CTA (filter_lanes.cu's short-stream decode); and the same schedule
// with a CTA, not a thread, per work item, whose rounds after the first run
// only the items whose start moved (chunk_fixpoint_tiles, the search
// encode's encode_fixpoint.cu).
//
// Each of `lanes` lanes has B blocks, cut into K chunks of Bc blocks (the
// last one may be short, none is empty); a work item is (chunk k, lane l) at
// flat index i = k*lanes + l.  Chunk 0 starts at state[l], the others at
// zeros; each round runs every item states-only and makes chunk k-1's end
// chunk k's next start, so after r rounds chunks 0..r are exact (the
// iteration of ops/chunking.py:fixpoint_states).  The loop stops when
// nothing changed or after K rounds; then one pass with output from the
// solved starts, and `end` is the last chunk's.  K = 1 runs no round.
// Threads take items strided over the scope, so any K fits; idle threads
// reach every barrier.  Starts live as [2][K][lanes][2], one buffer per
// round parity; the changed flag of round r is ctrl[r & 1] = r + 1, so a
// round needs one barrier and no flag is ever reset.
//
// GridScope: a persistent grid sized from the occupancy, grid.sync() as
// the barrier, ctrl and starts in global scratch (scratch[0..3], then the
// starts from scratch[4]) read with __ldcg since other SMs wrote them;
// scratch[2] receives the round count.  CtaScope: the CTA's threads,
// __syncthreads() as the barrier, ctrl and starts in shared memory; the
// round count goes to a global int32 when one is given.
#pragma once

#include <cooperative_groups.h>

#include "adpcm.cuh"

namespace bjxa {

// The with-output flag of one chunk run, as a type: run(Output<W>{}, ...)
// instantiates the decoder's chunk body with output or states only.
template <bool W>
struct Output {
  static constexpr bool value = W;
};

// The scope of chunk_fixpoint over the grid of a cooperative launch.
struct GridScope {
  using Index = long long;  // items may pass 2^31 over the grid
  int32_t* scratch;  // ctrl[0..3], then the starts
  __device__ __forceinline__ long long first() const {
    return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  }
  __device__ __forceinline__ long long stride() const {
    return static_cast<long long>(gridDim.x) * blockDim.x;
  }
  __device__ __forceinline__ int32_t* ctrl() const { return scratch; }
  __device__ __forceinline__ int32_t* starts() const { return scratch + 4; }
  __device__ __forceinline__ void sync() const {
    cooperative_groups::this_grid().sync();
  }
  __device__ __forceinline__ int32_t load(const int32_t* p) const {
    return __ldcg(p);
  }
  __device__ __forceinline__ void finish(int rounds) const {
    scratch[2] = rounds;
  }
};

// The scope of chunk_fixpoint over one CTA: ctrl int32[4] and starts
// int32[4*K*lanes] in shared memory, the round count to `rounds` (global,
// may be null).
struct CtaScope {
  using Index = int;  // items fit shared memory: 32-bit index arithmetic
  int32_t* shared_ctrl;
  int32_t* shared_starts;
  int32_t* rounds;
  __device__ __forceinline__ int first() const { return threadIdx.x; }
  __device__ __forceinline__ int stride() const { return blockDim.x; }
  __device__ __forceinline__ int32_t* ctrl() const { return shared_ctrl; }
  __device__ __forceinline__ int32_t* starts() const {
    return shared_starts;
  }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ __forceinline__ int32_t load(const int32_t* p) const {
    return *p;
  }
  __device__ __forceinline__ void finish(int r) const {
    if (rounds != nullptr) *rounds = r;
  }
};

// The schedule above over `scope`.  run(Output<W>{}, l, b0, n, p0, p1)
// decodes blocks [b0, b0 + n) of lane l from (p0, p1) in place, writing
// output when W.  State and end are global.
template <bool WITH_OUTPUT, class Scope, class Run>
__device__ __forceinline__ void chunk_fixpoint_in(
    const Scope& scope, const int32_t* __restrict__ state,
    int32_t* __restrict__ end, int B, int lanes, int K, int Bc, Run run) {
  using Index = typename Scope::Index;
  const Index items = static_cast<Index>(K) * lanes;
  const Index stride = scope.stride();
  const Index first = scope.first();
  int32_t* ctrl = scope.ctrl();  // changed flags of the two parities
  int32_t* starts = scope.starts();  // parity p at starts + p * 2 * items
  int cur = 0;
  int rounds = 0;
  if (K > 1) {
    if (first == 0) {
      ctrl[0] = 0;
      ctrl[1] = 0;
    }
    for (Index i = first; i < items; i += stride) {
      const bool anchor = i < lanes;
      starts[2 * i] = anchor ? state[2 * i] : 0;
      starts[2 * i + 1] = anchor ? state[2 * i + 1] : 0;
    }
    scope.sync();
    bool changed = true;
    while (changed && rounds < K) {
      const int32_t* in = starts + cur * 2 * items;
      int32_t* nxt = starts + (cur ^ 1) * 2 * items;
      for (Index i = first; i < items; i += stride) {
        const Index k = i / lanes;
        const Index l = i - k * lanes;
        int32_t p0 = scope.load(in + 2 * i);
        int32_t p1 = scope.load(in + 2 * i + 1);
        if (k == 0) {  // chunk 0 stays anchored
          nxt[2 * i] = p0;
          nxt[2 * i + 1] = p1;
        }
        const Index b0 = k * Bc;
        const int n = static_cast<int>(min(static_cast<Index>(Bc), B - b0));
        run(Output<false>{}, l, b0, n, p0, p1);
        if (k + 1 < K) {
          const Index j = i + lanes;
          if (scope.load(in + 2 * j) != p0 ||
              scope.load(in + 2 * j + 1) != p1) {
            ctrl[rounds & 1] = rounds + 1;
          }
          nxt[2 * j] = p0;
          nxt[2 * j + 1] = p1;
        }
      }
      scope.sync();
      ++rounds;
      changed = scope.load(ctrl + ((rounds - 1) & 1)) == rounds;
      cur ^= 1;
    }
  }
  const int32_t* in = starts + cur * 2 * items;
  for (Index i = first; i < items; i += stride) {
    const Index k = i / lanes;
    const Index l = i - k * lanes;
    int32_t p0 = K > 1 ? scope.load(in + 2 * i) : state[2 * l];
    int32_t p1 = K > 1 ? scope.load(in + 2 * i + 1) : state[2 * l + 1];
    const Index b0 = k * Bc;
    const int n = static_cast<int>(min(static_cast<Index>(Bc), B - b0));
    run(Output<WITH_OUTPUT>{}, l, b0, n, p0, p1);
    if (k == K - 1) {
      end[2 * l] = p0;
      end[2 * l + 1] = p1;
    }
  }
  if (first == 0) scope.finish(rounds);
}

// The schedule over the grid of a cooperative launch, with ctrl and the
// starts in global `scratch` (int32[4 + 4*K*lanes]; 4 when K = 1).
template <bool WITH_OUTPUT, class Run>
__device__ __forceinline__ void chunk_fixpoint(
    const int32_t* __restrict__ state, int32_t* __restrict__ end,
    int32_t* scratch, int B, int lanes, int K, int Bc, Run run) {
  chunk_fixpoint_in<WITH_OUTPUT>(GridScope{scratch}, state, end, B, lanes, K,
                                 Bc, run);
}

// Most SM ids (%nsmid) chunk_fixpoint_tiles deals its tiles by.
constexpr int kMaxSmIds = 256;

// The SM this thread runs on (%smid), and the bound of SM ids (%nsmid).
__device__ __forceinline__ int sm_id() {
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return static_cast<int>(id);
}
__device__ __forceinline__ int sm_ids() {
  unsigned n;
  asm("mov.u32 %0, %%nsmid;" : "=r"(n));
  return static_cast<int>(n);
}

// The schedule of chunk_fixpoint over the grid of a cooperative launch with
// a CTA, not a thread, per work item, W items a tile (W divides 32), and
// each round after the first over the items whose start moved alone.
//
// All threads of a CTA call run(Output<O>{}, i, p0, p1) for their tile
// together, so run may hold CTA barriers: i is the item of the thread's
// slot, threadIdx.x % W (K*lanes for a slot with no item); threads 0..W-1
// hand the item's start in (p0, p1) and take its end state back there, the
// others' (p0, p1) are zeros and ignored.  run writes the output and `end`
// itself: this form solves the starts and counts the rounds.
//
// Round 1 runs every item from the guess (chunk 0 at state, the others at
// zeros), in tiles j*W .. j*W + W-1.  Round r >= 2 runs only the items live
// in it, those whose start changed in round r - 1.  Any other item would
// give the end it gave when it last ran, which is already its successor's
// start, so it has nothing to search and nothing to write; the round count,
// the stop rule and every output are the schedule's without the skip.  The
// live items of round r are a list of (item, p0, p1) at parity r & 1 of
// `lists`, which round r - 1 appended to (one atomicAdd a tile onto
// counts[r], zeroed at the start and never reset), so round r's tiles are
// the list's dense slices of W items, tile t to the CTA of place t, t +
// grid, ... in the dealing order: CTAs sorted by their rank among their SM's
// CTAs, then by SM, so a round of n tiles puts them on n SMs where the grid
// spans as many (the hardware places consecutive CTAs on the same few SMs:
// CTAs 0-23 of 323 on 8 SMs of an H100).  starts[j] is chunk j's start as
// last set; only the holder of item j - lanes reads it (to compare its new
// end) and writes it, and the list carries the start to item j, so no item
// reads what another writes in the same round.  The loop stops when a round
// appends nothing or after K rounds; then one pass with output over every
// item from the solved starts.
//
// Scratch, int32: [2] the round count, [3] the items the states-only rounds
// searched (0 when K = 1), then counts[K + 2], starts[K*lanes][2],
// lists[2][K*lanes][3] and each CTA's SM id (4 elements are enough when K =
// 1, which deals no round).  Every tile of a round runs to the same end, so
// every thread reaches every grid.sync().  A run of a CTA-wide search leaves
// no register to spare, so little of this loop stays in one across run: the
// CTA's tile, place and the round's live count live in shared memory (read
// back after run's barriers), and indices are 32-bit (8*K*lanes + K +
// grid + 6 < 2^31, the caller's check; a 64-bit division is a call).
template <int W, bool WITH_OUTPUT, class Run>
__device__ __forceinline__ void chunk_fixpoint_tiles(
    const int32_t* __restrict__ state, int32_t* scratch, int lanes, int K,
    Run run) {
  static_assert(W <= 32 && 32 % W == 0, "warp 0 holds a tile's items");
  __shared__ int tile;  // the tile this CTA runs
  __shared__ int live;  // the items the round runs
  __shared__ int place;  // this CTA's place in the dealing order
  __shared__ int rank;  // its rank among its SM's CTAs
  __shared__ int sm_ctas[kMaxSmIds];  // the grid's CTAs on each SM
  const GridScope grid{scratch};
  const int items = K * lanes;
  int32_t* counts = scratch + 4;  // counts[r]: round r's live items, r >= 2
  int32_t* starts = counts + K + 2;
  int32_t* lists = starts + 2 * items;  // round r's at (r & 1) * 3 * items
  int32_t* sm_of = lists + 6 * items;  // each CTA's SM
  // every thread has read `tile` before thread 0 moves it on
  auto next_tile = [&](int j) {
    __syncthreads();
    if (threadIdx.x == 0) tile = j;
    __syncthreads();
  };
  // the item of this thread's slot in round r (items for none)
  auto item_of = [&](int r) {
    const int e = tile * W + static_cast<int>(threadIdx.x) % W;
    if (e >= live) return items;
    return r == 1 ? e : grid.load(lists + (r & 1) * 3 * items + 3 * e);
  };
  int done = 0;  // rounds run
  if (K > 1) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < items + K + 2;
         i += gridDim.x * blockDim.x) {
      if (i < items) {
        starts[2 * i] = 0;
        starts[2 * i + 1] = 0;
      } else {
        counts[i - items] = 0;
      }
    }
    if (threadIdx.x == 0) sm_of[blockIdx.x] = sm_id();
    grid.sync();
    // the dealing order: the CTAs of lower rank, then those of this rank on
    // lower SM ids
    const int ids = sm_ids();
    if (ids <= kMaxSmIds) {
      for (int m = threadIdx.x; m < ids; m += blockDim.x) sm_ctas[m] = 0;
      if (threadIdx.x == 0) {
        place = 0;
        rank = 0;
      }
      __syncthreads();
      // this CTA's SM as every CTA read it: %smid may change while a CTA
      // runs (after a preemption), and a second read could then break the
      // places' permutation of 0 .. grid - 1; the SM order is for speed alone
      const int mine = grid.load(sm_of + blockIdx.x);
      int before = 0;
      for (int b = threadIdx.x; b < static_cast<int>(gridDim.x);
           b += blockDim.x) {
        const int m = grid.load(sm_of + b);
        atomicAdd(&sm_ctas[m], 1);
        before += b < static_cast<int>(blockIdx.x) && m == mine;
      }
      atomicAdd(&rank, before);
      __syncthreads();
      int ahead = 0;
      for (int m = threadIdx.x; m < ids; m += blockDim.x) {
        ahead += min(sm_ctas[m], rank) + (m < mine && sm_ctas[m] > rank);
      }
      atomicAdd(&place, ahead);
    } else if (threadIdx.x == 0) {
      place = blockIdx.x;
    }
    __syncthreads();
    for (bool moved = true; moved && done < K;) {
      const int r = done + 1;
      if (threadIdx.x == 0) live = r == 1 ? items : grid.load(counts + r);
      for (next_tile(place); tile * W < live; next_tile(tile + gridDim.x)) {
        const int i = item_of(r);
        int32_t p0 = 0;
        int32_t p1 = 0;
        if (threadIdx.x < W && i < items) {
          if (r == 1) {  // chunk 0 at the entry state, the others at zeros
            p0 = i < lanes ? state[2 * i] : 0;
            p1 = i < lanes ? state[2 * i + 1] : 0;
          } else {
            const int e = tile * W + threadIdx.x;
            p0 = grid.load(lists + (r & 1) * 3 * items + 3 * e + 1);
            p1 = grid.load(lists + (r & 1) * 3 * items + 3 * e + 2);
          }
        }
        run(Output<false>{}, i, p0, p1);
        // warp 0: the next chunk's start, and its place in round r + 1
        if (threadIdx.x < 32) {
          const int from = threadIdx.x < W ? item_of(r) + lanes : items;
          const bool moved_on =
              from < items && (grid.load(starts + 2 * from) != p0 ||
                               grid.load(starts + 2 * from + 1) != p1);
          const unsigned ballot = __ballot_sync(0xffffffffu, moved_on);
          int at = 0;
          if (threadIdx.x == 0 && ballot != 0) {
            at = atomicAdd(counts + r + 1, __popc(ballot));
          }
          at = __shfl_sync(0xffffffffu, at, 0) +
               __popc(ballot & ((1u << threadIdx.x) - 1u));
          if (moved_on) {
            starts[2 * from] = p0;
            starts[2 * from + 1] = p1;
            int32_t* to = lists + ((r + 1) & 1) * 3 * items + 3 * at;
            to[0] = from;
            to[1] = p0;
            to[2] = p1;
          }
        }
      }
      grid.sync();
      done = r;
      moved = grid.load(counts + r + 1) > 0;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int searched = K > 1 ? items : 0;
    for (int r = 2; r <= done; ++r) searched += grid.load(counts + r);
    grid.finish(done);
    scratch[3] = searched;
  }
  if (threadIdx.x == 0) live = items;
  for (next_tile(blockIdx.x); tile * W < items; next_tile(tile + gridDim.x)) {
    const int i = item_of(1);
    int32_t p0 = 0;
    int32_t p1 = 0;
    if (threadIdx.x < W && i < items) {  // K = 1: item i is lane i
      p0 = i < lanes ? state[2 * i] : grid.load(starts + 2 * i);
      p1 = i < lanes ? state[2 * i + 1] : grid.load(starts + 2 * i + 1);
    }
    run(Output<WITH_OUTPUT>{}, i, p0, p1);
  }
}

// K chunks of Bc blocks cover B blocks with none empty (K*Bc >= B >
// (K-1)*Bc), or B = 0 and K = 1 with Bc = 0.
inline bool chunks_ok(int B, int K, int Bc) {
  if (B == 0) return K == 1 && Bc == 0;
  return B > 0 && K >= 1 && Bc >= 1 && static_cast<long long>(K) * Bc >= B &&
         static_cast<long long>(K - 1) * Bc < B;
}

// The device can launch cooperatively: 0, or the CUDA error.
inline cudaError_t coop_device(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  return coop ? cudaSuccess : cudaErrorNotSupported;
}

// Let `fn` take `smem` bytes of dynamic shared memory (an opt-in above the
// 48 KB default); 0 or the CUDA error, with none left behind.
inline cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// CTAs of `threads` threads of the cooperative kernel `fn`, with `smem`
// bytes of dynamic shared memory each, that fit on one SM at once (the
// persistent grid is this times the SM count at most), or minus a CUDA
// error code.
inline int coop_occupancy(const void* fn, int device, size_t smem = 0,
                          int threads = kThreads) {
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = coop_device(device);
  if (err == cudaSuccess) err = allow_smem(fn, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return ctas;
}

// One cooperative launch of `fn` over `ctas` CTAs of `threads` threads,
// with `smem` bytes of dynamic shared memory each, on `stream`, without
// synchronising.  A refused launch (too many CTAs to be co-resident, no
// cooperative launch on the device) returns its error, and leaves no error
// behind for cudaGetLastError().
inline int coop_launch(const void* fn, void** args, int ctas, int device,
                       void* stream, size_t smem = 0,
                       int threads = kThreads) {
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = coop_device(device);
  if (err == cudaSuccess) err = allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchCooperativeKernel(fn, dim3(ctas), dim3(threads), args,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error before returning it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bjxa
