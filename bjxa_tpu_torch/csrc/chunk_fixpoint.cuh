// The exact chunk fixed point of the chunked decoders, solved inside ONE
// launch, and the host side of the cooperative launch.  One schedule, two
// scopes: the grid of a cooperative launch (decode_words.cu,
// decode_stream.cu) or one CTA (filter_lanes.cu's short-stream decode).
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

// CTAs of kThreads of the cooperative kernel `fn` that fit on one SM at
// once (the persistent grid is this times the SM count at most), or minus
// a CUDA error code.
inline int coop_occupancy(const void* fn, int device) {
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = coop_device(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return ctas;
}

// One cooperative launch of `fn` over `ctas` CTAs of kThreads on `stream`,
// without synchronising.  A refused launch (too many CTAs to be
// co-resident, no cooperative launch on the device) returns its error, and
// leaves no error behind for cudaGetLastError().
inline int coop_launch(const void* fn, void** args, int ctas, int device,
                       void* stream) {
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = coop_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchCooperativeKernel(fn, dim3(ctas), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error before returning it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bjxa
