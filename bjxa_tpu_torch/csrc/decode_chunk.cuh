// The chunk body of the packed 8/6/4-bit decoders over lanes, shared by
// decode_words.cu (the production words decode), decode_variants.cu (its
// load and store ablations) and loadstore_bound.cu (the measured bound):
// one thread decodes blocks [b0, b0 + n) of its lane l, state in
// registers, with the next blocks' inputs in flight through a cp.async ring
// in shared memory.  chunk_fixpoint.cuh calls it for each work item.
//
// A decoder is this body with a Load policy and a Store policy:
//   Load  LoadW32<BITS>: prof uint8[B, L] + words int32[B, BITS, L] (word w
//           = payload bytes 4w..4w+3 of one stream), BITS 4-byte copies a
//           block and thread (a warp's are 128 contiguous bytes);
//         LoadU8Warp<STAGES>: blocks_t uint8[B, 33, L] (profile byte first,
//           8-bit only), one byte a sample: a warp copies each payload
//           row's 32 bytes with 16-byte copies, and each thread takes its
//           byte from shared memory (a warp whose lanes are not 32
//           consecutive lanes of one chunk takes LoadU8Lane: a byte load a
//           sample, nothing staged).
//         All load the next block's profile byte into a register while the
//         current block is filtered.
//   Store StoreI16: int16[B, 32, L]; StoreI32: int32[B, 32, L] (no
//           narrowing, twice the bytes); StorePair: int32[B, 16, L], two
//           consecutive samples a word, (s0 & 0xFFFF) | (s1 << 16), shifted
//           as uint32_t (a left shift of a negative int is undefined in
//           C++17): half the stores, the bytes of i16, and its
//           little-endian int16 view is each lane's natural sample order.
// Every access is coalesced: a warp's threads take neighbouring lanes.
//
// The ring holds Load::kStages slots of Load::kWords words a thread; the
// j-th block of a chunk takes slot j % kStages.  Under LoadW32 no thread
// reads another's slots, so the ring needs no barrier; LoadU8Warp orders a
// warp's copies and reads with __syncwarp.
#pragma once

#include <cuda_pipeline_primitives.h>

#include "adpcm.cuh"

namespace bjxa {

// A Load policy gives, for a work item (lane l, its chunk from block b0):
//   item(l, b0)              what its blocks' copies share (Item);
//   issue(it, ring, j, b)    start the copies of block b, the chunk's j-th,
//                            into its ring slot;
//   sync(it)                 order the slot's copies and reads between the
//                            threads that share them (none for a thread's
//                            own);
//   profile(l, b)            block b's profile byte, from global memory;
//   bytes(it, ring, j, b, o) block b's payload bytes, once its copies
//                            landed.
// Each finds its slot from the ring itself, after its global addresses, and
// ring_blocks sums a block's index in the chunk in int before adding it to
// b0: ptxas schedules the words kernel's loop by the order of this
// arithmetic, and its time moves with it by up to 9 % either way at some
// widths (benchmarks/short_stream.py, parent against change).

template <int BITS>
struct LoadW32 {
  static constexpr int kBits = BITS;
  static constexpr int kWords = BITS;  // ring words a thread stages a block
  static constexpr int kStages = 4;  // blocks of words a thread has in flight
  static constexpr bool kWarp = false;
  const uint8_t* __restrict__ prof;
  const int32_t* __restrict__ words;
  size_t lanes;

  struct Item {
    size_t l;
  };
  __device__ __forceinline__ Item item(size_t l, long long) const {
    return {l};
  }
  // Ring slot of the chunk's j-th block: BITS rows of kThreads words.
  template <class Word>
  __device__ __forceinline__ static auto slot(Word* ring, int j)
      -> Word (*)[kThreads] {
    return reinterpret_cast<Word(*)[BITS][kThreads]>(ring)[j & (kStages - 1)];
  }
  __device__ __forceinline__ void issue(const Item& it, uint32_t* ring, int j,
                                        long long b) const {
    const int t = threadIdx.x;
    const int32_t* src = words + static_cast<size_t>(b) * BITS * lanes + it.l;
    uint32_t(*rows)[kThreads] = slot(ring, j);
#pragma unroll
    for (int i = 0; i < BITS; ++i) {
      __pipeline_memcpy_async(&rows[i][t], src + i * lanes, 4);
    }
  }
  __device__ __forceinline__ void sync(const Item&) const {}
  __device__ __forceinline__ int profile(size_t l, long long b) const {
    return prof[static_cast<size_t>(b) * lanes + l];
  }
  // Word i of the thread's staged j-th block.
  __device__ __forceinline__ uint32_t word(const uint32_t* ring, int j,
                                           int i) const {
    const int t = threadIdx.x;
    return slot(ring, j)[i][t];
  }
  __device__ __forceinline__ void bytes(const Item&, const uint32_t* ring,
                                        int j, long long,
                                        uint32_t (&out)[4 * BITS]) const {
#pragma unroll
    for (int i = 0; i < BITS; ++i) {
      const uint32_t w = word(ring, j, i);
#pragma unroll
      for (int q = 0; q < 4; ++q) out[4 * i + q] = (w >> (8 * q)) & 0xFFu;
    }
  }
};

// One 16-byte cp.async that bypasses L1, zero-filled past the `left` bytes
// before the source buffer's end (left >= 1).
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       size_t left) {
  const unsigned to =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const unsigned n = left < 16 ? static_cast<unsigned>(left) : 16u;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to),
               "l"(src), "r"(n)
               : "memory");
}

// The u8 load, warp-cooperative, for a warp whose 32 threads hold 32
// consecutive lanes of one chunk (together(): every warp at L >= 32 unless
// it straddles two chunks or the end of the items; run_item sends any other
// to LoadU8Lane): the warp copies each payload row's 32 bytes as the
// 16-byte aligned pieces that cover them (2 or 3, 48 bytes staged a row)
// with 16-byte cp.async, two threads a row's sector, and each thread takes
// its bytes from shared memory.  A __syncwarp orders the copies of one
// thread before the reads of another, and the reads of a slot before its
// next copies.  The pieces are aligned on the absolute address, so blocks_t
// may start anywhere: every piece holds one of the row's bytes, none starts
// before blocks_t (a payload row starts L >= 32 bytes in), and the copy is
// zero-filled past its end.
template <int STAGES>
struct LoadU8Warp {
  static constexpr int kBits = 8;
  static constexpr int kRows = 4 * kBits + 1;  // profile row, 32 payload rows
  static constexpr int kSpan = 48;  // bytes a warp stages of a payload row
  static constexpr int kWords = kSpan / 4;  // ring words a thread a block
  static constexpr int kStages = STAGES;
  static constexpr bool kWarp = true;
  const uint8_t* __restrict__ blocks;
  size_t lanes;
  size_t total;  // bytes of blocks: B * 33 * L

  struct Item {
    size_t l0;  // lane 0's lane
  };
  // The warp's 32 threads are all here, on consecutive lanes of one chunk.
  __device__ __forceinline__ bool together(size_t l, long long b0) const {
    constexpr unsigned kAll = 0xFFFFFFFFu;
    if (__activemask() != kAll) return false;
    const size_t l0 = __shfl_sync(kAll, l, 0);
    const long long b00 = __shfl_sync(kAll, b0, 0);
    return __all_sync(kAll, l == l0 + (threadIdx.x & 31) && b0 == b00);
  }
  __device__ __forceinline__ Item item(size_t l, long long) const {
    return {l - (threadIdx.x & 31)};
  }
  // Address of the warp's first lane in payload row 0 of block b.
  __device__ __forceinline__ uintptr_t row0(const Item& it,
                                            long long b) const {
    return reinterpret_cast<uintptr_t>(blocks) +
           (static_cast<size_t>(b) * kRows + 1) * lanes + it.l0;
  }
  // Copy piece p (16 bytes) of payload row r of block b into the slot.
  __device__ __forceinline__ void piece(const Item& it, uint8_t* slot,
                                        long long b, int r, int p) const {
    const uintptr_t at =
        (row0(it, b) + r * lanes) & ~static_cast<uintptr_t>(15);
    const uintptr_t from = at + 16 * p;
    copy16(slot + ((threadIdx.x >> 5) * 32 + r) * kSpan + 16 * p,
           reinterpret_cast<const void*>(from),
           reinterpret_cast<uintptr_t>(blocks) + total - from);
  }
  // Thread q copies the first two pieces of rows q/2 and 16 + q/2 (piece
  // q & 1: two threads cover a row's 32-byte sector in one instruction),
  // then the third piece of row q where the row's bytes start off a 16-byte
  // boundary.
  // Ring slot of the chunk's j-th block, as bytes.
  __device__ __forceinline__ static uint8_t* slot(uint32_t* ring, int j) {
    return reinterpret_cast<uint8_t*>(ring +
                                      (j & (kStages - 1)) * kWords * kThreads);
  }
  __device__ __forceinline__ static const uint8_t* slot(const uint32_t* ring,
                                                        int j) {
    return slot(const_cast<uint32_t*>(ring), j);
  }
  __device__ __forceinline__ void issue(const Item& it, uint32_t* ring, int j,
                                        long long b) const {
    const int q = threadIdx.x & 31;
    uint8_t* to = slot(ring, j);
    piece(it, to, b, q >> 1, q & 1);
    piece(it, to, b, 16 + (q >> 1), q & 1);
    if ((row0(it, b) + q * lanes) & 15) piece(it, to, b, q, 2);
  }
  __device__ __forceinline__ void sync(const Item&) const { __syncwarp(); }
  __device__ __forceinline__ int profile(size_t l, long long b) const {
    return blocks[static_cast<size_t>(b) * kRows * lanes + l];
  }
  __device__ __forceinline__ void bytes(const Item& it, const uint32_t* ring,
                                        int j, long long b,
                                        uint32_t (&out)[kRows - 1]) const {
    const uint8_t* src = slot(ring, j) + (threadIdx.x >> 5) * 32 * kSpan +
                         (threadIdx.x & 31);
    const uint32_t first = static_cast<uint32_t>(row0(it, b)) & 15u;
    const uint32_t step = static_cast<uint32_t>(lanes) & 15u;
#pragma unroll
    for (int r = 0; r < kRows - 1; ++r) {
      out[r] = src[r * kSpan + ((first + r * step) & 15u)];
    }
  }
};

// The u8 load of a lane alone (a warp that is not together): its bytes
// loaded from global memory as it filters, one byte load a sample, nothing
// staged.
struct LoadU8Lane {
  static constexpr int kBits = 8;
  static constexpr int kRows = 4 * kBits + 1;
  static constexpr int kWords = 0;
  static constexpr int kStages = 1;
  static constexpr bool kWarp = false;
  const uint8_t* __restrict__ blocks;
  size_t lanes;

  struct Item {
    size_t l;
  };
  __device__ __forceinline__ Item item(size_t l, long long) const {
    return {l};
  }
  __device__ __forceinline__ void issue(const Item&, uint32_t*, int,
                                        long long) const {}
  __device__ __forceinline__ void sync(const Item&) const {}
  __device__ __forceinline__ int profile(size_t l, long long b) const {
    return blocks[static_cast<size_t>(b) * kRows * lanes + l];
  }
  __device__ __forceinline__ void bytes(const Item& it, const uint32_t*, int,
                                        long long b,
                                        uint32_t (&out)[kRows - 1]) const {
    const uint8_t* src =
        blocks + (static_cast<size_t>(b) * kRows + 1) * lanes + it.l;
#pragma unroll
    for (int r = 0; r < kRows - 1; ++r) out[r] = src[r * lanes];
  }
};

struct StoreI16 {
  using Elem = int16_t;
  static constexpr int kRows = kBlockSamples;
  Elem* __restrict__ out;
  __device__ __forceinline__ Elem* block(size_t lanes, size_t l,
                                         long long b) const {
    return out + static_cast<size_t>(b) * kRows * lanes + l;
  }
  // Sample s of the block at dst; s is a constant once the caller's sample
  // loop is unrolled.
  __device__ __forceinline__ void put(Elem* dst, int s, size_t lanes,
                                      int32_t x, int32_t&) const {
    dst[s * lanes] = static_cast<int16_t>(x);
  }
};

struct StoreI32 {
  using Elem = int32_t;
  static constexpr int kRows = kBlockSamples;
  Elem* __restrict__ out;
  __device__ __forceinline__ Elem* block(size_t lanes, size_t l,
                                         long long b) const {
    return out + static_cast<size_t>(b) * kRows * lanes + l;
  }
  __device__ __forceinline__ void put(Elem* dst, int s, size_t lanes,
                                      int32_t x, int32_t&) const {
    dst[s * lanes] = x;
  }
};

struct StorePair {
  using Elem = int32_t;
  static constexpr int kRows = kBlockSamples / 2;
  Elem* __restrict__ out;
  __device__ __forceinline__ Elem* block(size_t lanes, size_t l,
                                         long long b) const {
    return out + static_cast<size_t>(b) * kRows * lanes + l;
  }
  // prev carries the even sample to its odd partner.
  __device__ __forceinline__ void put(Elem* dst, int s, size_t lanes,
                                      int32_t x, int32_t& prev) const {
    if (s % 2 == 1) {
      const uint32_t w = (static_cast<uint32_t>(prev) & 0xFFFFu) |
                         (static_cast<uint32_t>(x) << 16);
      dst[(s / 2) * lanes] = static_cast<int32_t>(w);
    }
    prev = x;
  }
};

// Bytes of shared memory a CTA's ring takes under Load.
template <class Load>
constexpr size_t ring_bytes() {
  return sizeof(uint32_t) * Load::kStages * Load::kWords * kThreads;
}

// Stage the inputs of blocks [b0, b0 + n) of lane l through `ring` and call
// body(b, pr, it, j) for each block in order once its copies have landed:
// pr is its profile byte, it the item's Load::Item, j its index in the
// chunk (its ring slot is the Load's slot(ring, j)).  Empty groups are
// committed at the tail, so the wait count holds to the last block.
template <class Load, class Body>
__device__ __forceinline__ void ring_blocks(const Load& ld, uint32_t* ring,
                                            size_t l, long long b0, int n,
                                            Body body) {
  constexpr int kStages = Load::kStages;
  static_assert((kStages & (kStages - 1)) == 0, "stages: a power of two");
  const typename Load::Item it = ld.item(l, b0);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n) ld.issue(it, ring, j, b0 + j);
    __pipeline_commit();
  }
  int next_pr = n > 0 ? ld.profile(l, b0) : 0;
  for (int j = 0; j < n; ++j) {
    ld.sync(it);  // the slot copied into next was read by block j - 1
    if (j + kStages - 1 < n) {
      ld.issue(it, ring, j + kStages - 1, b0 + (j + kStages - 1));
    }
    __pipeline_commit();  // empty groups at the tail keep the count
    const int pr = next_pr;
    if (j + 1 < n) next_pr = ld.profile(l, b0 + (j + 1));
    __pipeline_wait_prior(kStages - 1);  // block j's copies have landed
    ld.sync(it);
    body(b0 + j, pr, it, j);
  }
}

// Decode blocks [b0, b0 + n) of lane l from (p0, p1) in place, writing
// through `st` when WITH_OUTPUT.
template <bool WITH_OUTPUT, class Load, class Store>
__device__ __forceinline__ void run_chunk(const Load& ld, const Store& st,
                                          uint32_t* ring, size_t lanes,
                                          size_t l, long long b0, int n,
                                          int32_t& p0, int32_t& p1) {
  ring_blocks(ld, ring, l, b0, n,
              [&](long long b, int pr, const typename Load::Item& it, int j) {
    const int factor = pr >> 4;
    const int range = pr & 0x0F;
    const int32_t k0 = gain_k0(factor);
    const int32_t k1 = gain_k1(factor);
    uint32_t bytes[4 * Load::kBits];
    ld.bytes(it, ring, j, b, bytes);
    typename Store::Elem* out =
        WITH_OUTPUT ? st.block(lanes, l, b) : nullptr;
    int32_t prev = 0;
#pragma unroll
    for (int s = 0; s < kBlockSamples; ++s) {
      const uint32_t v = unpack_sample<Load::kBits>(bytes, s);
      const int32_t x = filter_step(sign16(v) >> range, k0, k1, p0, p1);
      if constexpr (WITH_OUTPUT) st.put(out, s, lanes, x, prev);
    }
  });
}

// run_chunk under `ld`; a warp-cooperative load (Load::kWarp) whose warp is
// not together() takes its lane-alone load, a body of its own, instead: a
// branch on it inside one body, on every block, slowed the cooperative
// warps.
template <bool WITH_OUTPUT, class Load, class Store>
__device__ __forceinline__ void run_item(const Load& ld, const Store& st,
                                         uint32_t* ring, size_t lanes,
                                         size_t l, long long b0, int n,
                                         int32_t& p0, int32_t& p1) {
  if constexpr (Load::kWarp) {
    if (!ld.together(l, b0)) {
      run_chunk<WITH_OUTPUT>(LoadU8Lane{ld.blocks, lanes}, st, ring, lanes, l,
                             b0, n, p0, p1);
      return;
    }
  }
  run_chunk<WITH_OUTPUT>(ld, st, ring, lanes, l, b0, n, p0, p1);
}

}  // namespace bjxa
