// Fused XA decode over lanes from the packed-words layout -> int16 PCM.
//
// Replaces the TPU kernels bjxa_tpu/ops/pallas_decode.py:_decode_words_kernel
// (WITH_OUTPUT=true) and :_words_states_kernel (WITH_OUTPUT=false, end state
// only).  The same decode as decode_lanes.cu -- profile -> factor/range,
// gains, 4/6/8-bit unpack into the top bits of an int16, arithmetic shift by
// the range, the prediction filter with int16 saturation -- bit-exact with
// bjxa_tpu_torch.ops.cuda_decode_words' plain versions and the reference
// (src/libbjxa.c:286-345, 533-578).
//
// Layout: prof uint8[B, L], words int32[B, BITS, L] (word w = payload bytes
// 4w..4w+3 of one stream, little-endian), state int32[L, 2],
// pcm int16[B, 32, L], end int32[L, 2]; lanes are minor.  Byte i of the
// payload is (word[i >> 2] >> 8*(i & 3)) & 0xFF, shifted as uint32_t.
//
// Design.  The recurrence is serial over a lane's blocks, and a corpus batch
// has few lanes (16 stereo files are 32 lanes over ~20,000 blocks: one warp
// on one SM of 132).  So each lane's B blocks are cut into K chunks of
// Bc = ceil(B / K) blocks (the last one may be short, none is empty), and a
// work item is (chunk k, lane l) at flat index i = k*L + l: a warp covers 32
// neighbouring lanes of one chunk, so its loads and stores stay coalesced,
// the inputs are read in place and the PCM lands in its final [B, 32, L]
// place.  The chunks' entry states are solved exactly inside ONE
// cooperative launch, the iteration of ops/decode.py:_fixpoint_states:
// chunk 0 starts at state[l], the others at zeros; each round runs every
// item states-only (the TPU's _words_states_kernel) and makes chunk k-1's
// end chunk k's next start; a grid-wide flag says whether any start
// changed.  After r rounds chunks 0..r are exact, so the loop stops when
// nothing changed or after K rounds.  Then one pass with output
// (_decode_words_kernel) from the solved starts; `end` is the last chunk's.
// K = 1 runs no round at all (the wrapper picks it where the lanes alone
// fill the card).  Threads take items grid-stride over a persistent grid
// sized from the occupancy, so any K fits; idle threads reach every
// grid.sync().  Starts live in scratch[2][K][L][2] (one buffer per round
// parity, read through L2 with __ldcg since other SMs wrote them); the
// changed flag of round r is ctrl[r & 1] = r + 1, so a round needs one grid
// sync and no flag is ever reset; ctrl[2] receives the round count.
//
// Loads in flight: each thread stages its own BITS words of the next
// kStages - 1 blocks through a ring in shared memory with cp.async (4-byte
// copies: a warp's are 128 contiguous bytes), and its next profile byte in
// a register, while the current block is filtered; state stays in
// registers.  No thread reads another's slots, so the ring needs no CTA
// barrier.
//
// Bound: memory bytes at the headline (bits/8 + 1/32 bytes read and 2
// written per sample, ~203 MB a launch at B = 64, L = 32768, 8-bit); on a
// corpus batch the rounds re-read the input, (rounds + 1) reads in all.
#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>

#include "adpcm.cuh"

namespace bjxa {
namespace {

namespace cg = cooperative_groups;

constexpr int kStages = 4;  // blocks of words a thread has in flight

// Decode blocks [b0, b0 + n) of lane l from (p0, p1) in place.
template <int BITS, bool WITH_OUTPUT>
__device__ __forceinline__ void run_chunk(
    const uint8_t* __restrict__ prof, const int32_t* __restrict__ words,
    int16_t* __restrict__ pcm, size_t lanes, size_t l, long long b0, int n,
    uint32_t (*ring)[BITS][kThreads], int32_t& p0, int32_t& p1) {
  const int t = threadIdx.x;
  auto issue = [&](int j) {
    const int32_t* src =
        words + static_cast<size_t>(b0 + j) * BITS * lanes + l;
    uint32_t(*slot)[kThreads] = ring[j & (kStages - 1)];
#pragma unroll
    for (int i = 0; i < BITS; ++i) {
      __pipeline_memcpy_async(&slot[i][t], src + i * lanes, 4);
    }
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n) issue(j);
    __pipeline_commit();
  }
  int next_pr = n > 0 ? prof[static_cast<size_t>(b0) * lanes + l] : 0;
  for (int j = 0; j < n; ++j) {
    if (j + kStages - 1 < n) issue(j + kStages - 1);
    __pipeline_commit();  // empty groups at the tail keep the count
    const int pr = next_pr;
    if (j + 1 < n) {
      next_pr = prof[static_cast<size_t>(b0 + j + 1) * lanes + l];
    }
    __pipeline_wait_prior(kStages - 1);  // block j's words have landed
    const int factor = pr >> 4;
    const int range = pr & 0x0F;
    const int32_t k0 = gain_k0(factor);
    const int32_t k1 = gain_k1(factor);
    const uint32_t(*slot)[kThreads] = ring[j & (kStages - 1)];
    uint32_t bytes[4 * BITS];
#pragma unroll
    for (int i = 0; i < BITS; ++i) {
      const uint32_t w = slot[i][t];
#pragma unroll
      for (int q = 0; q < 4; ++q) bytes[4 * i + q] = (w >> (8 * q)) & 0xFFu;
    }
    int16_t* out =
        WITH_OUTPUT
            ? pcm + static_cast<size_t>(b0 + j) * kBlockSamples * lanes + l
            : nullptr;
#pragma unroll
    for (int s = 0; s < kBlockSamples; ++s) {
      const uint32_t v = unpack_sample<BITS>(bytes, s);
      const int32_t x = filter_step(sign16(v) >> range, k0, k1, p0, p1);
      if constexpr (WITH_OUTPUT) out[s * lanes] = static_cast<int16_t>(x);
    }
  }
}

template <int BITS, bool WITH_OUTPUT>
__global__ void __launch_bounds__(kThreads)
decode_words_kernel(const uint8_t* __restrict__ prof,
                    const int32_t* __restrict__ words,
                    const int32_t* __restrict__ state,
                    int16_t* __restrict__ pcm, int32_t* __restrict__ end,
                    int32_t* scratch, int B, int L, int K, int Bc) {
  __shared__ uint32_t ring[kStages][BITS][kThreads];
  const long long items = static_cast<long long>(K) * L;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t lanes = static_cast<size_t>(L);
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
      const bool anchor = i < L;
      starts[2 * i] = anchor ? state[2 * i] : 0;
      starts[2 * i + 1] = anchor ? state[2 * i + 1] : 0;
    }
    grid.sync();
    bool changed = true;
    while (changed && rounds < K) {
      const int32_t* in = starts + cur * 2 * items;
      int32_t* nxt = starts + (cur ^ 1) * 2 * items;
      for (long long i = first; i < items; i += stride) {
        const long long k = i / L;
        const long long l = i - k * L;
        int32_t p0 = __ldcg(in + 2 * i);
        int32_t p1 = __ldcg(in + 2 * i + 1);
        if (k == 0) {  // chunk 0 stays anchored
          nxt[2 * i] = p0;
          nxt[2 * i + 1] = p1;
        }
        const long long b0 = k * Bc;
        const int n = static_cast<int>(min(static_cast<long long>(Bc),
                                           B - b0));
        run_chunk<BITS, false>(prof, words, nullptr, lanes, l, b0, n, ring,
                               p0, p1);
        if (k + 1 < K) {
          const long long j = i + L;
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
    const long long k = i / L;
    const long long l = i - k * L;
    int32_t p0 = K > 1 ? __ldcg(in + 2 * i) : state[2 * l];
    int32_t p1 = K > 1 ? __ldcg(in + 2 * i + 1) : state[2 * l + 1];
    const long long b0 = k * Bc;
    const int n = static_cast<int>(min(static_cast<long long>(Bc), B - b0));
    run_chunk<BITS, WITH_OUTPUT>(prof, words, pcm, lanes, l, b0, n, ring,
                                 p0, p1);
    if (k == K - 1) {
      end[2 * l] = p0;
      end[2 * l + 1] = p1;
    }
  }
  if (first == 0) ctrl[2] = rounds;
}

template <int BITS, bool WITH_OUTPUT>
const void* kernel_for() {
  return reinterpret_cast<const void*>(
      &decode_words_kernel<BITS, WITH_OUTPUT>);
}

const void* pick_kernel(int bits, bool with_output) {
  switch (bits) {
    case 4: return with_output ? kernel_for<4, true>() : kernel_for<4, false>();
    case 6: return with_output ? kernel_for<6, true>() : kernel_for<6, false>();
    case 8: return with_output ? kernel_for<8, true>() : kernel_for<8, false>();
    default: return nullptr;
  }
}

}  // namespace
}  // namespace bjxa

// CTAs of the words kernel that fit on one SM at once (the persistent
// grid is this times the SM count at most), or minus a CUDA error code.
extern "C" int bjxa_decode_words_occupancy(int bits, int with_output,
                                           int device) {
  const void* fn = bjxa::pick_kernel(bits, with_output != 0);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (!coop) return -static_cast<int>(cudaErrorNotSupported);
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn,
                                                      bjxa::kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return ctas;
}

// One cooperative launch of `ctas` CTAs on `stream`, without synchronising:
// K chunks of Bc blocks (K*Bc >= B > (K-1)*Bc, or B = 0 and K = 1);
// scratch int32[4 + 4*K*L] (ctrl[0..3], then the starts of both parities;
// 4 elements are enough when K = 1), ctrl[2] receives the round count.
// A refused launch (too many CTAs to be co-resident, no cooperative launch
// on the device) returns its error; so does cudaGetLastError() after it.
extern "C" int bjxa_decode_words(const void* prof, const void* words,
                                 const void* state, void* pcm, void* end,
                                 void* scratch, int B, int L, int K, int Bc,
                                 int bits, int with_output, int ctas,
                                 int device, void* stream) {
  const bool chunks_ok =
      B == 0 ? (K == 1 && Bc == 0)
             : (K >= 1 && Bc >= 1 && static_cast<long long>(K) * Bc >= B &&
                static_cast<long long>(K - 1) * Bc < B);
  if (B < 0 || L <= 0 || !chunks_ok || ctas <= 0 || scratch == nullptr ||
      (with_output && B > 0 && pcm == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn = bjxa::pick_kernel(bits, with_output != 0);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  auto* out = static_cast<int16_t*>(pcm);
  auto* e = static_cast<int32_t*>(end);
  auto* sc = static_cast<int32_t*>(scratch);
  void* args[] = {const_cast<void**>(&prof), const_cast<void**>(&words),
                  const_cast<void**>(&state), &out, &e, &sc, &B, &L, &K, &Bc};
  err = cudaLaunchCooperativeKernel(fn, dim3(ctas), dim3(bjxa::kThreads), args,
                                    0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error before returning it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
