// The exact chunk fixed point of the cooperative decoders (decode_words.cu,
// decode_stream.cu), solved inside ONE launch, and the host side of that
// launch.
//
// Each of `lanes` lanes has B blocks, cut into K chunks of Bc blocks (the
// last one may be short, none is empty); a work item is (chunk k, lane l) at
// flat index i = k*lanes + l.  Chunk 0 starts at state[l], the others at
// zeros; each round runs every item states-only and makes chunk k-1's end
// chunk k's next start, so after r rounds chunks 0..r are exact (the
// iteration of ops/chunking.py:fixpoint_states).  The loop stops when
// nothing changed or after K rounds; then one pass with output from the
// solved starts, and `end` is the last chunk's.  K = 1 runs no round.
// Threads take items grid-stride over a persistent grid sized from the
// occupancy, so any K fits; idle threads reach every grid.sync().  Starts
// live in scratch[4 ..] as [2][K][lanes][2], one buffer per round parity,
// read with __ldcg since other SMs wrote them; the changed flag of round r
// is ctrl[r & 1] = r + 1, so a round needs one grid sync and no flag is
// ever reset; ctrl[2] receives the round count.
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

// The schedule above.  run(Output<W>{}, l, b0, n, p0, p1) decodes blocks
// [b0, b0 + n) of lane l from (p0, p1) in place, writing output when W.
template <bool WITH_OUTPUT, class Run>
__device__ __forceinline__ void chunk_fixpoint(
    const int32_t* __restrict__ state, int32_t* __restrict__ end,
    int32_t* scratch, int B, int lanes, int K, int Bc, Run run) {
  namespace cg = cooperative_groups;
  const long long items = static_cast<long long>(K) * lanes;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int32_t* ctrl = scratch;  // changed flags of the two parities, rounds
  int32_t* starts = scratch + 4;  // parity p at starts + p * 2 * items
  int cur = 0;
  int rounds = 0;
  if (K > 1) {
    cg::grid_group grid = cg::this_grid();
    if (first == 0) {
      ctrl[0] = 0;
      ctrl[1] = 0;
    }
    for (long long i = first; i < items; i += stride) {
      const bool anchor = i < lanes;
      starts[2 * i] = anchor ? state[2 * i] : 0;
      starts[2 * i + 1] = anchor ? state[2 * i + 1] : 0;
    }
    grid.sync();
    bool changed = true;
    while (changed && rounds < K) {
      const int32_t* in = starts + cur * 2 * items;
      int32_t* nxt = starts + (cur ^ 1) * 2 * items;
      for (long long i = first; i < items; i += stride) {
        const long long k = i / lanes;
        const long long l = i - k * lanes;
        int32_t p0 = __ldcg(in + 2 * i);
        int32_t p1 = __ldcg(in + 2 * i + 1);
        if (k == 0) {  // chunk 0 stays anchored
          nxt[2 * i] = p0;
          nxt[2 * i + 1] = p1;
        }
        const long long b0 = k * Bc;
        const int n = static_cast<int>(min(static_cast<long long>(Bc),
                                           B - b0));
        run(Output<false>{}, l, b0, n, p0, p1);
        if (k + 1 < K) {
          const long long j = i + lanes;
          if (__ldcg(in + 2 * j) != p0 || __ldcg(in + 2 * j + 1) != p1) {
            ctrl[rounds & 1] = rounds + 1;
          }
          nxt[2 * j] = p0;
          nxt[2 * j + 1] = p1;
        }
      }
      grid.sync();
      ++rounds;
      changed = __ldcg(ctrl + ((rounds - 1) & 1)) == rounds;
      cur ^= 1;
    }
  }
  const int32_t* in = starts + cur * 2 * items;
  for (long long i = first; i < items; i += stride) {
    const long long k = i / lanes;
    const long long l = i - k * lanes;
    int32_t p0 = K > 1 ? __ldcg(in + 2 * i) : state[2 * l];
    int32_t p1 = K > 1 ? __ldcg(in + 2 * i + 1) : state[2 * l + 1];
    const long long b0 = k * Bc;
    const int n = static_cast<int>(min(static_cast<long long>(Bc), B - b0));
    run(Output<WITH_OUTPUT>{}, l, b0, n, p0, p1);
    if (k == K - 1) {
      end[2 * l] = p0;
      end[2 * l + 1] = p1;
    }
  }
  if (first == 0) ctrl[2] = rounds;
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
