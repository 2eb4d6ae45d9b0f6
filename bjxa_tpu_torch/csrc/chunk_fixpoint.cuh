// The exact chunk fixed point of the chunked kernels, solved inside ONE
// launch, and the host side of the cooperative launch.  One schedule, two
// scopes: the grid of a cooperative launch (decode_words.cu and its
// ablations decode_variants.cu and loadstore_bound.cu, decode_stream.cu) or
// one CTA (filter_lanes.cu's short-stream decode); and the same schedule
// with a CTA, not a thread, per work item (chunk_fixpoint_tiles, the search
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

// Work items a tile of chunk_fixpoint_tiles holds.
constexpr int kTileItems = 32;

// The schedule of chunk_fixpoint over the grid of a cooperative launch with
// a CTA, not a thread, per work item: tile j holds items j*32 .. j*32 + 31
// (the last tile may be ragged), tiles are strided over the persistent
// grid, and all threads of a CTA call run(Output<W>{}, i, p0, p1) for their
// tile together, so run may hold CTA barriers.  i = j*32 + threadIdx.x % 32
// is the thread's item (K*lanes or more in a ragged tile's dead slots);
// threads 0-31 hand the item's start in (p0, p1) and take its end state
// back there, the others' (p0, p1) are zeros and ignored.  run writes the
// output and `end` itself: this form solves the starts and counts the
// rounds (scratch as in GridScope, the count to scratch[2]).  Every tile
// runs to the same end in every round, so every thread reaches every
// grid.sync().  A run of a CTA-wide search leaves no register to spare, so
// nothing of this loop stays in one across run: the CTA's tile index and
// the solved starts' parity live in shared memory (read back after run's
// barriers), and indices are 32-bit (4*K*lanes + 4 < 2^31, the caller's
// check; a 64-bit division is a call).
template <bool WITH_OUTPUT, class Run>
__device__ __forceinline__ void chunk_fixpoint_tiles(
    const int32_t* __restrict__ state, int32_t* scratch, int lanes, int K,
    Run run) {
  __shared__ int tile;  // the tile this CTA runs
  __shared__ int solved;  // the parity of the solved starts
  const GridScope grid{scratch};
  const int items = K * lanes;
  const int tiles = (items + kTileItems - 1) / kTileItems;
  // every thread has read `tile` before thread 0 moves it on
  auto next_tile = [&](int j) {
    __syncthreads();
    if (threadIdx.x == 0) tile = j;
    __syncthreads();
  };
  int done = 0;  // rounds run
  if (K > 1) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      grid.ctrl()[0] = 0;
      grid.ctrl()[1] = 0;
    }
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < items;
         i += gridDim.x * blockDim.x) {
      const bool anchor = i < lanes;
      grid.starts()[2 * i] = anchor ? state[2 * i] : 0;
      grid.starts()[2 * i + 1] = anchor ? state[2 * i + 1] : 0;
    }
    grid.sync();
    for (bool moved = true; moved && done < K;) {
      for (next_tile(blockIdx.x); tile < tiles;
           next_tile(tile + gridDim.x)) {
        const int parity = done & 1;
        const int i = tile * kTileItems + threadIdx.x % kTileItems;
        const bool mine = threadIdx.x < kTileItems && i < items;
        const int32_t* from = grid.starts() + parity * 2 * items;
        int32_t p0 = mine ? grid.load(from + 2 * i) : 0;
        int32_t p1 = mine ? grid.load(from + 2 * i + 1) : 0;
        if (mine && i < lanes) {  // chunk 0 stays anchored
          int32_t* to = grid.starts() + (parity ^ 1) * 2 * items;
          to[2 * i] = p0;
          to[2 * i + 1] = p1;
        }
        run(Output<false>{}, i, p0, p1);
        // the next chunk's item
        const int n = tile * kTileItems + threadIdx.x % kTileItems + lanes;
        if (threadIdx.x < kTileItems && n < items) {
          const int32_t* was = grid.starts() + parity * 2 * items;
          int32_t* to = grid.starts() + (parity ^ 1) * 2 * items;
          if (grid.load(was + 2 * n) != p0 ||
              grid.load(was + 2 * n + 1) != p1) {
            grid.ctrl()[parity] = done + 1;
          }
          to[2 * n] = p0;
          to[2 * n + 1] = p1;
        }
      }
      grid.sync();
      done += 1;
      moved = grid.load(grid.ctrl() + ((done - 1) & 1)) == done;
    }
  }
  if (threadIdx.x == 0) {
    solved = done & 1;
    if (blockIdx.x == 0) grid.finish(done);
  }
  for (next_tile(blockIdx.x); tile < tiles; next_tile(tile + gridDim.x)) {
    const int i = tile * kTileItems + threadIdx.x % kTileItems;
    const int32_t* from = grid.starts() + solved * 2 * items;
    int32_t p0 = 0;
    int32_t p1 = 0;
    if (threadIdx.x < kTileItems && i < items) {  // K = 1: item i is lane i
      p0 = K > 1 ? grid.load(from + 2 * i) : state[2 * i];
      p1 = K > 1 ? grid.load(from + 2 * i + 1) : state[2 * i + 1];
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
