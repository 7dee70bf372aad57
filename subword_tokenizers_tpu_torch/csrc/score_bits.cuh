// The exact WordPiece score: the IEEE-754 bits of the correctly rounded
// double max(c, 1) / (max(fa, 1) * max(fb, 1)), as CPython's int / int
// rounds it (ops/bitmath.py), for every kernel that scores pairs: K2's
// WordPiece mode and swt_score_bits (select_unify.cu) and the shard
// nomination (nominate.cu).
//
// Replaces the JAX package's subword_tokenizers_tpu/ops/bitmath.py:
// div_double_bits, div_double_bits_wide, mul_53x53, bitlen and
// _round_q55, as ops/pairstats.py:211 wp_score_bits uses them. Narrow
// entries (fa * fb < 2^53, checked with __umul64hi) take __ddiv_rn of two
// exact doubles; wide ones a 128-bit restoring division with JAX's
// round-half-even tail.
//
// Each source that includes this header gets its own copy (internal
// linkage), so the kernels' library links no shared device code.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint64_t kNarrow = 1ULL << 53;

__device__ __forceinline__ int bitlen64(uint64_t x) { return 64 - __clzll(x); }

// IEEE-754 bits of the double nearest q * 2^(e0 - 55), ties to even, where
// q = floor(value * 2^(55 - e0)) lies in [2^54, 2^56) and rem_nonzero
// marks an inexact quotient (JAX's _round_q55).
__device__ int64_t round_q55(uint64_t q, int64_t e0, bool rem_nonzero) {
  const int big = q >= (1ULL << 55);
  int64_t e = e0 - 1 + big;
  const uint64_t dropped = big ? (q & 1) : 0;
  const uint64_t q2 = q >> big;
  uint64_t m = q2 >> 2;
  const bool round_bit = (q2 >> 1) & 1;
  const bool sticky = (q2 & 1) || dropped || rem_nonzero;
  if (round_bit && (sticky || (m & 1))) ++m;
  if (m == kNarrow) {
    m = 1ULL << 52;
    ++e;
  }
  return ((e + 1023) << 52) | static_cast<int64_t>(m & ((1ULL << 52) - 1));
}

// One restoring-division step without doubling: R in [0, 2d) -> [0, d).
__device__ __forceinline__ void sub_if_ge(uint64_t& rh, uint64_t& rl,
                                          uint64_t dh, uint64_t dl,
                                          uint64_t& q) {
  const bool ge = rh > dh || (rh == dh && rl >= dl);
  if (ge) {
    const uint64_t borrow = rl < dl;
    rl -= dl;
    rh -= dh + borrow;
  }
  q = (q << 1) | ge;
}

// Bits of max(c,1) / (max(fa,1) * max(fb,1)) as CPython's int / int
// rounds it; c < 2^53 and fa, fb < 2^52.
__device__ int64_t score_bits(int64_t c_in, int64_t fa_in, int64_t fb_in) {
  const uint64_t c = c_in > 1 ? c_in : 1;
  const uint64_t fa = fa_in > 1 ? fa_in : 1;
  const uint64_t fb = fb_in > 1 ? fb_in : 1;
  const uint64_t dl = fa * fb;
  const uint64_t dh = __umul64hi(fa, fb);
  if (dh == 0 && dl < kNarrow) {
    // Both operands are exact doubles; IEEE division rounds correctly.
    return __double_as_longlong(
        __ddiv_rn(static_cast<double>(c), static_cast<double>(dl)));
  }
  // d >= 2^53 > c. Align c to d's bit length (N = c << t < 2d), take the
  // leading quotient bit, then 55 doubling steps: q = floor(c 2^(55-e0)/d).
  const int lc = bitlen64(c);
  const int ld = dh ? 64 + bitlen64(dh) : bitlen64(dl);
  const int t = ld - lc;
  uint64_t rh, rl;
  if (t >= 64) {
    rh = c << (t - 64);
    rl = 0;
  } else {
    rh = t ? c >> (64 - t) : 0;
    rl = c << t;
  }
  uint64_t q = 0;
  sub_if_ge(rh, rl, dh, dl, q);
  for (int k = 0; k < 55; ++k) {
    rh = (rh << 1) | (rl >> 63);
    rl <<= 1;
    sub_if_ge(rh, rl, dh, dl, q);
  }
  return round_q55(q, lc - ld, (rh | rl) != 0);
}

}  // namespace
