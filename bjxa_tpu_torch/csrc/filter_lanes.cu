// ADPCM prediction filter of a short stream, and over unpacked lanes.
//
// Replaces the TPU kernels bjxa_tpu/ops/pallas_filter.py:_filter_kernel
// (WITH_OUTPUT=true) and :_states_kernel (WITH_OUTPUT=false, end state
// only): the range shift, then the recurrence of adpcm.cuh with int16
// saturation, bit-exact with bjxa_tpu_torch.ops.cuda_filter's plain
// versions and the reference (src/libbjxa.c:533-578).  Three kernels:
//
// * decode_short_kernel (bjxa_decode_short): the whole of decode_arrays for
//   one short stream in ONE launch -- raw blocks uint8[C, B, S] (S = 4*BITS
//   + 1, the profile byte first) and state int32[C, 2] in; interleaved
//   frames int16[B*32, C] (the WAV's order), end int32[C, 2] and valid
//   uint8[B, C] out.  The short-stream path of ops/decode.py sends it
//   streams of at most 64 blocks (at most 64*2*33 = 4,224 bytes).
// * filter_short_kernel and filter_lanes_kernel (bjxa_filter_lanes): the
//   TPU kernels' own contract -- samples int16[B, 32, L] (top-bits domain,
//   not yet range-shifted), k0/k1/shift int32[B, L], state int32[L, 2] in;
//   pcm int16[B, 32, L], end int32[L, 2] out.  Few lanes whose data fits
//   48 KB of shared memory take filter_short_kernel, many lanes
//   filter_lanes_kernel.
//
// What bounds each regime on this card.  Few lanes (a short stream: 1 or 2
// channels): the serial recurrence.  Each sample's step depends on the
// last -- multiply-add, truncating /256, add, two-sided clamp -- so a lane
// costs (its blocks x 32) dependent steps whatever the card's width, and
// the bytes (at most a few KB) do not count.  Many lanes: memory bytes, 2 B
// read and 2 B written per sample plus 12 B per block.
//
// What the design does about it.  A short stream is one CTA (CtaScope of
// chunk_fixpoint.cuh).  Its threads first copy the whole input into shared
// memory in parallel, then each takes a block: its bytes into registers,
// its 32 samples unpacked and range-shifted into shared memory, its gains
// and validity from the profile byte (a thread a sample would wait on 30
// dependent rounds of shared-memory latency a thread at 61 stereo blocks).
// So no step of the chain waits on device memory.  The chain is cut
// into K chunks of Bc blocks a lane, item (k, l) at i = k*L + l, whose
// entry states are solved by the exact fixed point: rounds of the
// states-only filter until no chunk's start changes, then one pass with
// output; K = 1 runs no round.  That trades B*32 dependent steps for
// (rounds + 1) * Bc * 32, plus a barrier and the starts' exchange a pass.
// In each step p1*k1 is formed a step early (p1 is the last step's p0), so
// the chain is the multiply-add, the /256 and the clamp: ~32 SM cycles a
// step on the H100.  Output is staged in shared memory in the frames' own
// order and the CTA writes it with 16-byte stores.  Many lanes keep one thread per
// lane over device memory (K = 1, coalesced across neighbouring lanes), the
// blocks looped in-thread with (p0, p1) in registers.
#include "adpcm.cuh"
#include "chunk_fixpoint.cuh"

namespace bjxa {
namespace {

// Blocks a chunk of the CTA regime of bjxa_filter_lanes keeps: the
// default of ops/chunking.py:SHORT_CHUNK_BLOCKS, from the Bc sweep.
constexpr int kShortChunkBlocks = 3;
// Shared memory the CTA regime of bjxa_filter_lanes may take (no opt-in).
constexpr size_t kShortSmem = 48 * 1024;

// K chunks of Bc = min(kShortChunkBlocks, B) blocks over B > 0 blocks.
inline void short_chunks(int B, int& K, int& Bc) {
  Bc = B < kShortChunkBlocks ? B : kShortChunkBlocks;
  K = (B + Bc - 1) / Bc;
}

// A short stream of L lanes x B blocks staged in shared memory: the frames
// int16[B*32][L] (16-byte aligned; the fused entry first copies the raw
// blocks there), the range-shifted samples int16[L][B][32], the gains
// int32[L*B] each, ctrl int32[4] and the starts int32[4*K*L].
struct Staged {
  int16_t* out;
  int16_t* x;
  int32_t* k0;
  int32_t* k1;
  int32_t* ctrl;
  int32_t* starts;
};

__host__ __device__ inline size_t staged_bytes(int B, int L, int K) {
  const size_t n = static_cast<size_t>(B) * L;
  return 136 * n + 16 + 16 * static_cast<size_t>(K) * L;
}

__device__ __forceinline__ Staged carve(uint4* smem, int B, int L) {
  auto* base = reinterpret_cast<unsigned char*>(smem);
  const size_t n = static_cast<size_t>(B) * L;
  Staged s;
  s.out = reinterpret_cast<int16_t*>(base);
  s.x = reinterpret_cast<int16_t*>(base + 64 * n);
  s.k0 = reinterpret_cast<int32_t*>(base + 128 * n);
  s.k1 = s.k0 + n;
  s.ctrl = s.k1 + n;
  s.starts = s.ctrl + 4;
  return s;
}

// One filter step with p1*k1 (`q`) formed a step early: p1 is the last
// step's p0, so the chain is the multiply-add, the truncating /256 (C's
// division) with the add of `ranged`, and the clamp.  |p0*k0 + q| <=
// 32768*728, no overflow.  (nvcc may regroup the two products; pinning the
// grouping with a PTX mad.lo.s32 measured no faster, nor did a clamp by
// cvt.sat.s16.s32 or by plain min/max.)
__device__ __forceinline__ int32_t short_step(int32_t ranged, int32_t k0,
                                              int32_t k1, int32_t& q,
                                              int32_t& p0, int32_t& p1) {
  const int32_t t = (p0 * k0 + q) / 256;
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  // DPX: max(ranged + t, -32768) in one instruction
  const int32_t s = min(__viaddmax_s32(ranged, t, -32768), 32767);
#else
  const int32_t u = ranged + t;
  const int32_t s = u < -32768 ? -32768 : (u > 32767 ? 32767 : u);
#endif
  q = p0 * k1;  // the next step's p1*k1
  p1 = p0;
  p0 = s;
  return s;
}

// Blocks [b0, b0 + n) of lane l from (p0, p1), from the staged samples;
// with output, each sample to the staged frames.
template <bool WITH_OUTPUT>
__device__ __forceinline__ void filter_chunk(const Staged& s, int B, int L,
                                             int l, int b0, int n,
                                             int32_t& p0, int32_t& p1) {
  for (int j = 0; j < n; ++j) {
    const int lb = l * B + b0 + j;
    const int32_t k0 = s.k0[lb];
    const int32_t k1 = s.k1[lb];
    const uint4* xv = reinterpret_cast<const uint4*>(s.x + lb * 32);
    uint32_t w[16];  // the block's 32 samples, two to a word
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const uint4 u = xv[v];
      w[4 * v] = u.x;
      w[4 * v + 1] = u.y;
      w[4 * v + 2] = u.z;
      w[4 * v + 3] = u.w;
    }
    int16_t* o = s.out + (b0 + j) * 32 * L + l;
    int32_t q = p1 * k1;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int32_t x = sign16((t & 1) ? w[t / 2] >> 16 : w[t / 2]);
      const int32_t v = short_step(x, k0, k1, q, p0, p1);
      if constexpr (WITH_OUTPUT) o[t * L] = static_cast<int16_t>(v);
    }
  }
}

// A block's 32 samples, packed two to a word, to `dst` (16-byte aligned)
// in four 16-byte stores.
__device__ __forceinline__ void store_packed(int16_t* dst,
                                             const uint32_t (&pk)[16]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    d[q] = make_uint4(pk[4 * q], pk[4 * q + 1], pk[4 * q + 2], pk[4 * q + 3]);
  }
}

// The low 16 bits of x into half n % 2 of pk[n / 2].
__device__ __forceinline__ void pack_sample(uint32_t (&pk)[16], int n,
                                            int32_t x) {
  const uint32_t h = static_cast<uint32_t>(x) & 0xFFFFu;
  pk[n / 2] = (n & 1) ? pk[n / 2] | (h << 16) : h;
}

// The staged chain: the fixed point over the CTA, then (with output) the
// frames to `out` in 16-byte stores.  Every thread of the CTA calls it.
template <bool WITH_OUTPUT>
__device__ __forceinline__ void run_staged(const Staged& s,
                                           const int32_t* __restrict__ state,
                                           int16_t* __restrict__ out,
                                           int32_t* __restrict__ end,
                                           int32_t* rounds, int B, int L,
                                           int K, int Bc) {
  chunk_fixpoint_in<WITH_OUTPUT>(
      CtaScope{s.ctrl, s.starts, rounds}, state, end, B, L, K, Bc,
      [&](auto w, int l, int b0, int n, int32_t& p0, int32_t& p1) {
        filter_chunk<decltype(w)::value>(s, B, L, l, b0, n, p0, p1);
      });
  if constexpr (WITH_OUTPUT) {
    __syncthreads();
    const int n16 = B * L * 4;  // B*32*L int16 = B*L*4 uint4
    const uint4* src = reinterpret_cast<const uint4*>(s.out);
    uint4* dst = reinterpret_cast<uint4*>(out);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) dst[i] = src[i];
  }
}

// decode_arrays on the card: one CTA, the raw blocks in, frames out.
template <int BITS, bool WITH_OUTPUT>
__global__ void __launch_bounds__(kThreads)
decode_short_kernel(const uint8_t* __restrict__ blocks,
                    const int32_t* __restrict__ state,
                    int16_t* __restrict__ frames, int32_t* __restrict__ end,
                    uint8_t* __restrict__ valid, int32_t* rounds, int B,
                    int C, int K, int Bc) {
  constexpr int S = 4 * BITS + 1;
  extern __shared__ uint4 smem[];
  const Staged s = carve(smem, B, C);
  // the raw blocks into the frames' region (C*B*S <= 64*B*C bytes), which
  // the output pass overwrites only after the unpack
  auto* raw = reinterpret_cast<uint8_t*>(s.out);
  const int nbytes = B * C * S;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(blocks) & 15) == 0) {
    done = nbytes / 16 * 16;
    const uint4* src = reinterpret_cast<const uint4*>(blocks);
    for (int i = threadIdx.x; i < nbytes / 16; i += blockDim.x) {
      smem[i] = src[i];
    }
  }
  for (int i = done + threadIdx.x; i < nbytes; i += blockDim.x) {
    raw[i] = blocks[i];
  }
  __syncthreads();
  // a thread a block (c, b), cb = c*B + b: its bytes into registers, its
  // 32 samples unpacked and range-shifted, its gains and validity
  for (int cb = threadIdx.x; cb < B * C; cb += blockDim.x) {
    const uint8_t* blk = raw + cb * S;
    uint32_t bytes[4 * BITS];
#pragma unroll
    for (int q = 0; q < 4 * BITS; ++q) bytes[q] = blk[1 + q];
    const int pr = blk[0];
    uint32_t pk[16];
#pragma unroll
    for (int n = 0; n < kBlockSamples; ++n) {
      pack_sample(pk, n, sign16(unpack_sample<BITS>(bytes, n)) >> (pr & 0x0F));
    }
    store_packed(s.x + cb * 32, pk);
    const int factor = pr >> 4;
    s.k0[cb] = gain_k0(factor);
    s.k1[cb] = gain_k1(factor);
    const int c = cb / B;
    valid[(cb - c * B) * C + c] = factor < 5;
  }
  __syncthreads();
  run_staged<WITH_OUTPUT>(s, state, frames, end, rounds, B, C, K, Bc);
}

// bjxa_filter_lanes with few lanes: the samples staged, then the chain.
template <bool WITH_OUTPUT>
__global__ void __launch_bounds__(kThreads)
filter_short_kernel(const int16_t* __restrict__ samples,
                    const int32_t* __restrict__ k0,
                    const int32_t* __restrict__ k1,
                    const int32_t* __restrict__ shift,
                    const int32_t* __restrict__ state,
                    int16_t* __restrict__ pcm, int32_t* __restrict__ end,
                    int B, int L, int K, int Bc) {
  extern __shared__ uint4 smem[];
  const Staged s = carve(smem, B, L);
  // a thread a block (b, l), i = b*L + l: its 32 samples (32 independent
  // loads in flight) range-shifted, its gains
  for (int i = threadIdx.x; i < B * L; i += blockDim.x) {
    const int b = i / L;
    const int l = i - b * L;
    // a shift past the word width fills with the sign, as XLA's does
    const uint32_t sh = static_cast<uint32_t>(shift[i]);
    const int range = sh > 31u ? 31 : static_cast<int>(sh);
    const int16_t* src =
        samples + static_cast<size_t>(b) * kBlockSamples * L + l;
    uint32_t pk[16];
#pragma unroll
    for (int n = 0; n < kBlockSamples; ++n) {
      pack_sample(pk, n, static_cast<int32_t>(src[n * L]) >> range);
    }
    store_packed(s.x + (l * B + b) * 32, pk);
    s.k0[l * B + b] = k0[i];
    s.k1[l * B + b] = k1[i];
  }
  __syncthreads();
  run_staged<WITH_OUTPUT>(s, state, pcm, end, nullptr, B, L, K, Bc);
}

// bjxa_filter_lanes with many lanes: one thread per lane over device
// memory, the blocks looped in-thread.
template <bool WITH_OUTPUT>
__global__ void __launch_bounds__(kThreads)
filter_lanes_kernel(const int16_t* __restrict__ samples,
                    const int32_t* __restrict__ k0,
                    const int32_t* __restrict__ k1,
                    const int32_t* __restrict__ shift,
                    const int32_t* __restrict__ state,
                    int16_t* __restrict__ pcm, int32_t* __restrict__ end,
                    int B, int L) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const size_t lanes = static_cast<size_t>(L);
  int32_t p0 = state[2 * l];
  int32_t p1 = state[2 * l + 1];
  for (int b = 0; b < B; ++b) {
    const size_t bl = static_cast<size_t>(b) * lanes + l;
    const int32_t g0 = k0[bl];
    const int32_t g1 = k1[bl];
    const uint32_t sh = static_cast<uint32_t>(shift[bl]);
    const int range = sh > 31u ? 31 : static_cast<int>(sh);
    const size_t row = static_cast<size_t>(b) * kBlockSamples * lanes + l;
#pragma unroll
    for (int n = 0; n < kBlockSamples; ++n) {
      const int32_t ranged =
          static_cast<int32_t>(samples[row + n * lanes]) >> range;
      const int32_t s = filter_step(ranged, g0, g1, p0, p1);
      if constexpr (WITH_OUTPUT) pcm[row + n * lanes] = static_cast<int16_t>(s);
    }
  }
  end[2 * l] = p0;
  end[2 * l + 1] = p1;
}

// The launch floor: a kernel that does nothing.
__global__ void empty_kernel() {}

template <int BITS, bool WITH_OUTPUT>
const void* short_for() {
  return reinterpret_cast<const void*>(
      &decode_short_kernel<BITS, WITH_OUTPUT>);
}

const void* pick_short(int bits, bool with_output) {
  switch (bits) {
    case 4: return with_output ? short_for<4, true>() : short_for<4, false>();
    case 6: return with_output ? short_for<6, true>() : short_for<6, false>();
    case 8: return with_output ? short_for<8, true>() : short_for<8, false>();
    default: return nullptr;
  }
}

// Launch `fn` as one CTA of kThreads with `smem` bytes of dynamic shared
// memory on `stream` (opting in above 48 KB); returns the CUDA error.
int launch_cta(const void* fn, void** args, size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
  }
  const cudaError_t err =
      cudaLaunchKernel(fn, dim3(1), dim3(kThreads), args, smem,
                       static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace bjxa

// One CTA decodes one short stream on `stream`, without synchronising: K
// chunks of Bc blocks (K*Bc >= B > (K-1)*Bc, or B = 0 and K = 1); blocks
// uint8[C, B, S] (S = 4*bits + 1), frames 16-byte aligned (null when not
// with_output), valid uint8[B, C]; `rounds` (int32, may be null) receives
// the round count.  Shared memory is 136*B*C + 16*K*C + 16 bytes; a stream
// past the card's opt-in limit is refused with its error.
extern "C" int bjxa_decode_short(const void* blocks, const void* state,
                                 void* frames, void* end, void* valid,
                                 void* rounds, int B, int C, int K, int Bc,
                                 int bits, int with_output, int device,
                                 void* stream) {
  const bool writes = with_output && B > 0;
  if (!bjxa::chunks_ok(B, K, Bc) || C <= 0 || state == nullptr ||
      end == nullptr || (B > 0 && (blocks == nullptr || valid == nullptr)) ||
      (writes && frames == nullptr) ||
      (writes && (reinterpret_cast<uintptr_t>(frames) & 15) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn = bjxa::pick_short(bits, with_output != 0);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  void* args[] = {const_cast<void**>(&blocks), const_cast<void**>(&state),
                  &frames, &end, &valid, &rounds, &B, &C, &K, &Bc};
  return bjxa::launch_cta(fn, args, bjxa::staged_bytes(B, C, K), stream);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
// Few lanes whose staged data fits 48 KB of shared memory (K*L <= kThreads
// at K chunks of kShortChunkBlocks) take one CTA, the rest one thread per
// lane.
extern "C" int bjxa_filter_lanes(const void* samples, const void* k0,
                                 const void* k1, const void* shift,
                                 const void* state, void* pcm, void* end,
                                 int B, int L, int with_output, int device,
                                 void* stream) {
  if (B < 0 || L <= 0 || (with_output && pcm == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const auto* x = static_cast<const int16_t*>(samples);
  const auto* g0 = static_cast<const int32_t*>(k0);
  const auto* g1 = static_cast<const int32_t*>(k1);
  const auto* sh = static_cast<const int32_t*>(shift);
  const auto* st = static_cast<const int32_t*>(state);
  auto* out = static_cast<int16_t*>(pcm);
  auto* e = static_cast<int32_t*>(end);
  auto s = static_cast<cudaStream_t>(stream);
  int K = 1, Bc = 0;
  if (B > 0) bjxa::short_chunks(B, K, Bc);
  const size_t smem = bjxa::staged_bytes(B, L, K);
  if (B > 0 && static_cast<long long>(K) * L <= bjxa::kThreads &&
      smem <= bjxa::kShortSmem &&
      (!with_output || (reinterpret_cast<uintptr_t>(pcm) & 15) == 0)) {
    if (with_output) {
      bjxa::filter_short_kernel<true><<<1, bjxa::kThreads, smem, s>>>(
          x, g0, g1, sh, st, out, e, B, L, K, Bc);
    } else {
      bjxa::filter_short_kernel<false><<<1, bjxa::kThreads, smem, s>>>(
          x, g0, g1, sh, st, out, e, B, L, K, Bc);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int grid = bjxa::grid_for(L);
  if (with_output) {
    bjxa::filter_lanes_kernel<true>
        <<<grid, bjxa::kThreads, 0, s>>>(x, g0, g1, sh, st, out, e, B, L);
  } else {
    bjxa::filter_lanes_kernel<false>
        <<<grid, bjxa::kThreads, 0, s>>>(x, g0, g1, sh, st, out, e, B, L);
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch of a kernel that does nothing, on `stream`: the launch floor
// the timings set the short-stream kernels against.
extern "C" int bjxa_empty_launch(int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  bjxa::empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
