// ALU probe: the per-element rate of the search encoder's candidate operation
// mix in 32-bit against 16-bit integers.
//
// Replaces the TPU kernel tools/encode_pack_falsify.py:bench_int16_vs_int32's
// `kernel`.  Each element runs kSteps = 256 dependent steps from y = x, in the
// element type T (int32_t or int16_t), every operation wrapping in T's width:
//   full   : y = clip(((y*3 + x) >> 2) + 1, -16384, 16383)
//   clip   : y = clip(  y*3 + x        + 1, -16384, 16383)
//   muladd : y =        y*3 + x + 1
// Bit-exact with bjxa_tpu_torch.tools.encode_pack_falsify's plain version.
//
// Bound: integer instructions (elements x 256 steps x the fewest
// instructions the step needs, encode_pack_falsify.MIX_OPS and PAIR_OPS);
// one load and one store per element against 256 steps.
//
// Design:
// - The work is 32-bit words.  An int32 word is one element.  An int16 word
//   is TWO elements, as the TPU kernel asked of its lanes
//   (vector<8x128x2xi16>), and each step runs on the pair with Hopper's
//   16x2 instructions (SASS of sm_90a in brackets).  There is no 16x2
//   multiply or shift, so y*3 + x is three wrapping 16x2 adds (y+y, y+x,
//   their sum; x + 1 is taken once for the + 1) [VIADD.16x2], the clip is
//   the 16x2 max (fused with the add before it) and min [VIADDMNMX.S16x2,
//   VIMNMX.S16x2], and `full` composes its shift: it holds y in offset
//   binary (y ^ 0x8000 a half, so the adds give s ^ 0x8000), clears the
//   two bits the shift would move from the high half into the low one
//   [LOP3], shifts the word and adds the + 1 in one instruction [LEA.HI],
//   and clips with the unsigned 16x2 max and min [VIMNMX.U16x2].  Per
//   pair and step: muladd 3, clip 4, full 7 instructions (5 without its
//   clip, which is the identity on int16 but is kept: the probe times the
//   search's operation mix); int32 per element: muladd 1 [IMAD], clip 3,
//   full 4 (benchmarks/alu_pack.py counts them in the SASS).
// - Pipes: the 16x2 adds issue to one 64-lane pipe, the min and max to
//   another (a packed clip runs 1.4x one pipe's rate).  So muladd
//   alternates its steps between VIADD.16x2 and VIADDMNMX.S16x2 (whose max
//   against -32768 changes nothing): 1.5 adds a pair on each pipe.
// - Each thread carries kWords independent words, loaded as one 16-byte
//   vector and interleaved in the step loop, so a dependent instruction's
//   latency is hidden by the thread's own chains as well as by resident
//   warps.
// - A persistent grid (the wrapper's `ctas`: this kernel's occupancy times
//   the SMs) gives each CTA an equal contiguous share of the items, in
//   whole warps; 32-bit indices in the loop (n < 2^31).
// - Any alignment and any n: the body is the 16-byte vectors between the
//   first and the last 16-byte boundary; each element before the body (the
//   head) or after it (the tail) is an item of its own (an int16 element
//   runs the packed step in the low half of a word).  x and out must share
//   their address modulo 16 (the wrapper allocates out so).
// - Signed arithmetic wraps through uint32_t (signed overflow is undefined in
//   C++); the 16x2 adds wrap in each half.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace bjxa {
namespace {

constexpr int kSteps = 256;
constexpr int kAluThreads = 256;
constexpr int kWords = 4;  // words a thread: one 16-byte vector

enum Mix { kMixFull = 0, kMixClip = 1, kMixMulAdd = 2 };

constexpr uint32_t kClipLo2 = 0xC000C000u;  // -16384 in each half
constexpr uint32_t kClipHi2 = 0x3FFF3FFFu;  // 16383 in each half

// One int32 element a word.  A chain is the element's y, x and x + 1.
template <int MIX>
struct Word32 {
  struct Chain {
    uint32_t y, x, x1;
  };
  __device__ __forceinline__ static Chain start(uint32_t w) {
    return {w, w, w + 1u};
  }
  template <int P>
  __device__ __forceinline__ static void step(Chain& c) {
    if constexpr (MIX == kMixMulAdd) {
      c.y = c.y * 3u + c.x1;
    } else if constexpr (MIX == kMixClip) {
      c.y = static_cast<uint32_t>(
          min(max(static_cast<int32_t>(c.y * 3u + c.x1), -16384), 16383));
    } else {
      const int32_t v = static_cast<int32_t>(c.y * 3u + c.x) >> 2;
      c.y = static_cast<uint32_t>(min(__viaddmax_s32(v, 1, -16384), 16383));
    }
  }
  __device__ __forceinline__ static uint32_t word(const Chain& c) {
    return c.y;
  }
};

// 16x2 adds, wrapping in each half, down two pipes: add_a is VIADD.16x2;
// add_b is VIADDMNMX.S16x2 whose max, against -32768, changes nothing.
__device__ __forceinline__ uint32_t add_a(uint32_t a, uint32_t b) {
  return __vadd2(a, b);
}
__device__ __forceinline__ uint32_t add_b(uint32_t a, uint32_t b) {
  return __viaddmax_s16x2(a, b, 0x80008000u);
}

// Two int16 elements a word, each step on the pair (see the head comment).
// `full` holds y in offset binary (y ^ 0x8000 in each half): y' + y' is
// 2y, so the adds give s' = s ^ 0x8000, whose halves shift as unsigned.
template <int MIX>
struct Packed16 {
  struct Chain {
    uint32_t y, x, x1;
  };
  static constexpr uint32_t kBias = MIX == kMixFull ? 0x80008000u : 0u;
  __device__ __forceinline__ static Chain start(uint32_t w) {
    return {w ^ kBias, w, __vadd2(w, 0x00010001u)};
  }
  template <int P>
  __device__ __forceinline__ static void step(Chain& c) {
    if constexpr (MIX == kMixFull) {
      const uint32_t s = add_a(add_a(c.y, c.y), add_a(c.y, c.x));
      // clear the high half's bits 0-1, which the shift would move into
      // the low half; then (m >> 2) + 1 + 0x6000 in each half (the bias
      // 0x2000 the shift leaves, moved to 0x8000): one LEA.HI
      const uint32_t m = s & 0xFFFCFFFFu;
      const uint32_t v = (m >> 2) + 0x60016001u;
      // the clip to [-16384, 16383] is [0x4000, 0xBFFF] in offset binary
      c.y = __vminu2(__vmaxu2(v, 0x40004000u), 0xBFFFBFFFu);
    } else if constexpr (MIX == kMixClip) {
      c.y = __vmins2(__viaddmax_s16x2(add_a(c.y, c.y), add_a(c.y, c.x1),
                                      kClipLo2),
                     kClipHi2);
    } else if constexpr (P == 0) {  // alternate steps: 3 adds per pipe
      c.y = add_a(add_a(c.y, c.y), add_b(c.y, c.x1));
    } else {
      c.y = add_b(add_b(c.y, c.y), add_a(c.y, c.x1));
    }
  }
  __device__ __forceinline__ static uint32_t word(const Chain& c) {
    return c.y ^ kBias;
  }
};

// The int16 form of the probe.
template <int MIX>
using Form16 = Packed16<MIX>;

template <typename T, int MIX>
using FormOf =
    std::conditional_t<sizeof(T) == 4, Word32<MIX>, Form16<MIX>>;

// kSteps steps of E chains, interleaved; steps alternate between two forms
// P = 0, 1 (a form may send them down different pipes).
template <typename Form, int E>
__device__ __forceinline__ void run(typename Form::Chain (&c)[E]) {
#pragma unroll 4
  for (int s = 0; s < kSteps; s += 2) {
#pragma unroll
    for (int e = 0; e < E; ++e) Form::template step<0>(c[e]);
#pragma unroll
    for (int e = 0; e < E; ++e) Form::template step<1>(c[e]);
  }
}

// Item i of the body: words [i * kWords, (i + 1) * kWords) of p.
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ p,
                                           uint32_t i,
                                           uint32_t (&w)[kWords]) {
  if constexpr (kWords % 4 == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(p) + i * (kWords / 4);
#pragma unroll
    for (int k = 0; k < kWords / 4; ++k) {
      const uint4 q = v[k];
      w[4 * k] = q.x;
      w[4 * k + 1] = q.y;
      w[4 * k + 2] = q.z;
      w[4 * k + 3] = q.w;
    }
  } else if constexpr (kWords == 2) {
    const uint2 q = reinterpret_cast<const uint2*>(p)[i];
    w[0] = q.x;
    w[1] = q.y;
  } else {
    w[0] = p[i];
  }
}

__device__ __forceinline__ void store_words(uint32_t* __restrict__ p,
                                            uint32_t i,
                                            const uint32_t (&w)[kWords]) {
  if constexpr (kWords % 4 == 0) {
    uint4* v = reinterpret_cast<uint4*>(p) + i * (kWords / 4);
#pragma unroll
    for (int k = 0; k < kWords / 4; ++k) {
      v[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
    }
  } else if constexpr (kWords == 2) {
    reinterpret_cast<uint2*>(p)[i] = make_uint2(w[0], w[1]);
  } else {
    p[i] = w[0];
  }
}

// Items [0, vecs) are the body's vectors, from x + head; items
// [vecs, vecs + edge) one element each: the head's elements, then the
// tail's, from x + tail.  CTA b takes items [b * share, (b + 1) * share).
template <typename T, typename Form>
__global__ void __launch_bounds__(kAluThreads)
alu_mix_kernel(const T* __restrict__ x, T* __restrict__ out, uint32_t vecs,
               uint32_t head, uint32_t tail, uint32_t edge, uint32_t share) {
  const uint32_t first = blockIdx.x * share;
  const uint32_t last = min(first + share, vecs + edge);
  const auto* xw = reinterpret_cast<const uint32_t*>(x + head);
  auto* ow = reinterpret_cast<uint32_t*>(out + head);
  for (uint32_t i = first + threadIdx.x; i < last; i += kAluThreads) {
    if (i < vecs) {
      uint32_t w[kWords];
      load_words(xw, i, w);
      typename Form::Chain c[kWords];
#pragma unroll
      for (int e = 0; e < kWords; ++e) c[e] = Form::start(w[e]);
      run<Form>(c);
#pragma unroll
      for (int e = 0; e < kWords; ++e) w[e] = Form::word(c[e]);
      store_words(ow, i, w);
    } else {
      const uint32_t j = i - vecs;
      const uint32_t k = j < head ? j : tail + (j - head);
      using U = std::make_unsigned_t<T>;
      typename Form::Chain c[1] = {
          Form::start(static_cast<uint32_t>(static_cast<U>(x[k])))};
      run<Form>(c);
      out[k] = static_cast<T>(static_cast<U>(Form::word(c[0])));
    }
  }
}

template <typename T, typename F>
int with_kernel(int mix, F&& f) {
  switch (mix) {
    case kMixFull:
      return f(alu_mix_kernel<T, FormOf<T, kMixFull>>);
    case kMixClip:
      return f(alu_mix_kernel<T, FormOf<T, kMixClip>>);
    case kMixMulAdd:
      return f(alu_mix_kernel<T, FormOf<T, kMixMulAdd>>);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(const void* x, void* out, long long n, int mix, int ctas,
           cudaStream_t s) {
  const auto a = reinterpret_cast<uintptr_t>(x);
  if (a % sizeof(T) != 0 ||
      ((a ^ reinterpret_cast<uintptr_t>(out)) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr long long per = 4 / sizeof(T);  // elements a word
  const long long lead = static_cast<long long>(((16 - (a & 15)) & 15) /
                                                sizeof(T));
  const long long head = lead < n ? lead : n;
  const long long vecs = (n - head) / (per * kWords);
  const long long tail = head + vecs * per * kWords;
  const long long edge = head + (n - tail);
  // shares in whole warps (a share of a few items would leave most lanes
  // of its warps idle)
  const long long per_cta = ctas > 0 ? (vecs + edge + ctas - 1) / ctas : 0;
  const long long share = (per_cta + 31) / 32 * 32;
  const int err = with_kernel<T>(mix, [&](auto kernel) {
    kernel<<<ctas, kAluThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<uint32_t>(vecs), static_cast<uint32_t>(head),
        static_cast<uint32_t>(tail), static_cast<uint32_t>(edge),
        static_cast<uint32_t>(share));
    return 0;
  });
  // a grid of ctas < 1 is refused by the runtime: its error is returned
  return err < 0 ? -err : static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int mix) {
  return with_kernel<T>(mix, [](auto kernel) {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kAluThreads, 0);
    return err == cudaSuccess ? blocks : -static_cast<int>(err);
  });
}

}  // namespace
}  // namespace bjxa

// CTAs of the kernel for `elem_bytes` (4: int32, 2: int16) and `mix` that
// fit on one SM at once (the persistent grid is this times the SM count), or
// minus a CUDA error code.
extern "C" int bjxa_alu_mix_occupancy(int elem_bytes, int mix, int device) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return -static_cast<int>(dev_err);
  if (elem_bytes == 4) return bjxa::occupancy<int32_t>(mix);
  if (elem_bytes == 2) return bjxa::occupancy<int16_t>(mix);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// x, out: n elements (0 < n < 2^31) of int32 (elem_bytes 4) or int16
// (elem_bytes 2), at the same address modulo 16.  mix: 0 full, 1 clip,
// 2 muladd.  One launch of `ctas` CTAs on `stream`, without synchronising;
// returns cudaGetLastError() (a refused launch returns its error).
extern "C" int bjxa_alu_mix(const void* x, void* out, long long n,
                            int elem_bytes, int mix, int ctas, int device,
                            void* stream) {
  if (n <= 0 || n >= (1LL << 31) || x == nullptr || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) return bjxa::launch<int32_t>(x, out, n, mix, ctas, s);
  if (elem_bytes == 2) return bjxa::launch<int16_t>(x, out, n, mix, ctas, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
