// A lane's AC stream staged through a ring in shared memory by cp.async,
// in CTAs of kLanes lanes: how ans_decode.cu (K3) moves its stream, shared
// with its stream-copy floor ans_probe.cu (S7), so that the floor moves the
// stream as the decode does.
//
// The ring holds the lane's stream from its first halfword rounded down to
// 16 bytes (a0): chunk c is halfwords a0 + 8c .. a0 + 8c + 7, in ring slot
// c % kRingChunks, so halfword a0 + r sits at ring[r & kRingMask]. A chunk
// that reaches past `total` is filled by plain loads, clamped to the last
// halfword as the JAX driver's window gather is. Every kTopUp steps, at the
// same step in every lane of the warp, one cp.async group brings the ring
// up to the chunks that the next kTopUp steps may read (2 halfwords a step
// at most) and kAhead more, and the wait leaves only that group in flight:
// the group before it, which reached kAhead chunks past these steps'
// reads, has landed. A slot is refilled 16 chunks after its last use, past
// the reader. Only the thread that issues a copy reads its chunk, so no
// barrier is needed.

#pragma once

#include <stdint.h>

#ifndef JXL_ANS_CTA_LANES
#error "JXL_ANS_CTA_LANES: set by ops/build.py from its CTA_LANES"
#endif

namespace jxl_ans {

// lanes a CTA holds at most (the host's CTA table, ops/ans_kernel.cta_first)
constexpr int kLanes = JXL_ANS_CTA_LANES;
static_assert(kLanes >= 1 && kLanes <= 32, "a CTA is one warp");

constexpr int kRingChunks = 16;   // a lane's ring: 16 chunks of 8 halfwords
constexpr int kRingMask = 8 * kRingChunks - 1;
constexpr int kRingStride = 136;  // halfwords between two lanes' rings
constexpr int kRingLaneBytes = 2 * kRingStride;  // 272, a multiple of 16
constexpr int kTopUp = 16;        // steps between two top-ups of the ring
constexpr int kAhead = 4;         // chunks a top-up reaches past its steps

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct StreamRing {
  uint16_t* ring;        // the lane's kRingStride halfwords of shared memory
  const uint16_t* flat;  // every lane's halfwords, 16-byte aligned
  long long total;
  long long a0;
  int rel;     // the reader's position relative to a0
  int issued;  // chunks issued

  // the ring of the stream that starts at halfword `first`, filled up to
  // its first top-up's reach and landed
  __device__ __forceinline__ StreamRing(uint16_t* ring_,
                                        const uint16_t* flat_,
                                        long long total_, long long first)
      : ring(ring_), flat(flat_), total(total_), a0(first & ~7LL),
        rel((int)(first & 7)), issued(0) {
    top_up();
    cp_async_wait<0>();
  }

  __device__ __forceinline__ void top_up() {
    const long long last = total - 1;
    const int target = ((rel + 2 * kTopUp + 1) >> 3) + 1 + kAhead;
    for (; issued < target; ++issued) {
      const long long g = a0 + 8LL * issued;
      uint16_t* dst = ring + ((issued % kRingChunks) << 3);
      if (g + 8 <= total) {
        cp_async16(dst, flat + g);
      } else {
        for (int i = 0; i < 8; ++i) dst[i] = flat[g + i < last ? g + i : last];
      }
    }
    cp_async_commit();
  }

  // before step t reads: the top-up of every kTopUp-th step
  __device__ __forceinline__ void before_step(int t) {
    if (t % kTopUp == kTopUp - 1) {
      top_up();
      cp_async_wait<1>();
    }
  }

  // the two halfwords at the reader, the first in the low 16 bits
  __device__ __forceinline__ uint32_t peek2() const {
    return (uint32_t)ring[rel & kRingMask] |
           ((uint32_t)ring[(rel + 1) & kRingMask] << 16);
  }

  __device__ __forceinline__ void skip(int halfwords) { rel += halfwords; }

  // no copy outlives the CTA
  __device__ __forceinline__ void drain() { cp_async_wait<0>(); }
};

}  // namespace jxl_ans
