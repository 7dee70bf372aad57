// A single-pass decoupled look-back (Merrill and Garland's scan) over
// status words that carry the call's epoch, so no memset runs between
// calls: the table compaction's clusters (shard_select.cu) find the live
// count before them with it, and K3's tiles (merge_apply.cu) the kept
// count and the match weight before them (a 16-byte word: the status
// word and a 64-bit value beside it).
//
// A status word: the state in bits 63-62 (kAggregate: the part's own
// count; kInclusive: the count of every part up to and including it), the
// call's epoch in bits 61-32 and the count in bits 31-0. A word of another
// epoch is not yet written in this call. The caller passes epochs 1 ..
// 2^30 - 1 in turn and zeroes the words when it wraps, so a word of an
// earlier call never carries the current epoch.

#pragma once

#include <cstdint>

namespace {

constexpr unsigned long long kAggregate = 1ULL << 62;
constexpr unsigned long long kInclusive = 2ULL << 62;
constexpr unsigned kEpochMask = (1u << 30) - 1;

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long state,
                                        unsigned epoch, long long count) {
  *reinterpret_cast<volatile unsigned long long*>(word) =
      state | (static_cast<unsigned long long>(epoch) << 32) |
      static_cast<unsigned long long>(count);
}

__device__ __forceinline__ bool written(unsigned long long w,
                                        unsigned epoch) {
  return static_cast<unsigned>(w >> 32 & kEpochMask) == epoch &&
         (w >> 62) != 0;
}

// The count of the parts before part c: their words read back from c - 1
// down, each waited for, up to the first inclusive one. The parts waited
// for took their indices before c did, so they are running or done.
__device__ long long look_back(const unsigned long long* status, int c,
                               unsigned epoch) {
  const volatile unsigned long long* st = status;
  long long sum = 0;
  for (int p = c - 1; p >= 0; --p) {
    unsigned long long w;
    do {
      w = st[p];
    } while (!written(w, epoch));
    sum += static_cast<long long>(w & 0xffffffffULL);
    if ((w >> 62) == (kInclusive >> 62)) break;
  }
  return sum;
}

// A status word and a 64-bit value beside it, 16-byte aligned, each
// written and read by one 16-byte volatile access (as CUB's decoupled
// look-back keeps a tile's state and an 8-byte value in one 16-byte
// word), so a reader that sees the call's epoch sees the value of the
// same write. Volatile, not merely uncached: a weak load (ld.cg) in the
// spin may be taken once and never again, which returned stale words on
// an H100.
__device__ __forceinline__ void publish2(ulonglong2* word,
                                         unsigned long long state,
                                         unsigned epoch, long long count,
                                         long long value) {
  const unsigned long long w =
      state | (static_cast<unsigned long long>(epoch) << 32) |
      static_cast<unsigned long long>(count);
  asm volatile("st.volatile.v2.u64 [%0], {%1, %2};" ::"l"(word), "l"(w),
               "l"(static_cast<unsigned long long>(value))
               : "memory");
}

__device__ __forceinline__ ulonglong2 load2(const ulonglong2* word) {
  ulonglong2 v;
  asm volatile("ld.volatile.v2.u64 {%0, %1}, [%2];"
               : "=l"(v.x), "=l"(v.y)
               : "l"(word)
               : "memory");
  return v;
}

// The counts and the values of the parts before part c, both summed, read
// by a whole warp 32 words at a time: lane l waits for the word of part
// c - 1 - l - 32 j, and the window ends at its nearest inclusive word.
// Every lane of the warp calls it and gets the sums. One round of loads a
// window instead of one a part, so a part far from the first inclusive
// word does not wait on a chain of single loads.
__device__ void look_back_warp2(const ulonglong2* status, int c,
                                unsigned epoch, long long& count,
                                long long& value) {
  const int lane = threadIdx.x & 31;
  count = 0;
  value = 0;
  for (int top = c - 1; top >= 0; top -= 32) {
    const int p = top - lane;
    ulonglong2 w = make_ulonglong2(0, 0);
    if (p >= 0) {
      do {
        w = load2(status + p);
      } while (!written(w.x, epoch));
    }
    const unsigned incl =
        __ballot_sync(~0u, p >= 0 && (w.x >> 62) == (kInclusive >> 62));
    const int last = incl ? __ffs(incl) - 1 : 31;
    const bool in = lane <= last && p >= 0;
    long long n = in ? static_cast<long long>(w.x & 0xffffffffULL) : 0;
    long long v = in ? static_cast<long long>(w.y) : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) {
      n += __shfl_xor_sync(~0u, n, d);
      v += __shfl_xor_sync(~0u, v, d);
    }
    count += n;
    value += v;
    if (incl) break;
  }
}

}  // namespace
