// The top-K tier's Σ-threshold certificate, for every kernel that runs it:
// K2's dense host_ids mode (select_unify.cu), in its last block right
// after it writes the record, and the check launcher swt_certificate
// (shard_select.cu).
//
// Replaces the certificates of the JAX package's sharded selection,
//   subword_tokenizers_tpu/parallel/train.py:283-290 (BPE) and :336-365,
//   :383-400 (WordPiece).
// From every shard's K-th best entry (its metric, count and key) a
// threshold t_i bounds any pair the shard did not nominate; from the
// winner over the candidates (its key and summed count), the proven flag.
// BPE: t_i = max(metric, 0), proven = count > Σ t or Σ t == 0. WordPiece:
// t_i = min(q + (q >> 50) + 2, 2^55) with q = (c << 36) // (fa fb) of the
// K-th entry (none without one: metric < 0); a shard whose bound reaches
// 2^55 (or, with wide scores, whose K-th denominator needs more than 62
// bits) vetoes, and proven = (count << 36) // (fa fb) of the winner >
// Σ t + (Σ t >> 50) + 2 with no veto, or Σ t == 0.
//
// One warp computes the sum (cert_terms): lane i takes shard i (and
// i + 32, ... when D > 32), and a warp reduction gives Σ t in 128 bits
// (so no sum of D terms wraps) and the OR of the vetoes. One thread then
// decides (cert_proven). The results equal the plain version's
// (ops/shard_select.certificate_ref, Python integers) for any D, and the
// JAX package's wherever its int64 does not overflow. As in the JAX
// package, fa * fb is an int64 product: the caller's weights keep it
// below 2^63 (with wide scores, a product of more than 62 bits vetoes
// before it is formed).
//
// The division (c << 36) // d, c and d below 2^63, splits the quotient as
// (c // d) << 36 plus ((c % d) << 36) // d. When c << 36 fits in 64 bits
// it is one 64-bit division; else c // d and c % d come first, and a
// K-th term stops there when c // d >= 2^19 (the quotient is then at
// least 2^55 and saturates); the low 36 bits take one 64-bit division
// when (c % d) << 36 fits, else 36 restoring steps. The result is the
// 128-bit restoring loop's, bit for bit (tests/test_torch_certificate_
// fused.py holds a model of it against Python's //).
//
// Each source that includes this header gets its own copy (internal
// linkage), as with score_bits.cuh.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint64_t kCertSat = 1ULL << 55;  // a WordPiece term's saturation
constexpr int kCertScale = 36;             // its scale, as in JAX

// A 128-bit unsigned value.
struct Wide128 {
  uint64_t hi, lo;
};

__device__ __forceinline__ bool u128_gt(Wide128 x, Wide128 y) {
  return x.hi > y.hi || (x.hi == y.hi && x.lo > y.lo);
}

__device__ __forceinline__ Wide128 u128_add(Wide128 x, Wide128 y) {
  const uint64_t lo = x.lo + y.lo;
  return {x.hi + y.hi + (lo < x.lo), lo};
}

__device__ __forceinline__ int cert_bitlen(uint64_t x) {
  return 64 - __clzll(x);
}

// floor((c << 36) / d) for c < 2^63 and 1 <= d < 2^63. With ``saturate``
// a quotient of 2^55 or more is returned as 2^55 once that is known.
__device__ __forceinline__ Wide128 scaled_quotient(uint64_t c, uint64_t d,
                                                   bool saturate) {
  if ((c >> (64 - kCertScale)) == 0) return {0, (c << kCertScale) / d};
  const uint64_t q1 = c / d;
  if (saturate && (q1 >> (55 - kCertScale)) != 0) return {0, kCertSat};
  uint64_t r = c - q1 * d;  // < d < 2^63
  uint64_t f;
  if ((r >> (64 - kCertScale)) == 0) {
    f = (r << kCertScale) / d;
  } else {
    f = 0;
    for (int i = 0; i < kCertScale; ++i) {
      r <<= 1;  // r < d < 2^63 before, so no bit is lost
      const bool ge = r >= d;
      r -= ge ? d : 0;
      f = (f << 1) | ge;
    }
  }
  return {q1 >> (64 - kCertScale), (q1 << kCertScale) | f};
}

// The wide-score veto and the denominator of a pair's score bound.
__device__ __forceinline__ uint64_t cert_denominator(int64_t fa, int64_t fb,
                                                     int wide_score,
                                                     bool* unsafe) {
  *unsafe = wide_score &&
            cert_bitlen(fa > 1 ? fa : 1) + cert_bitlen(fb > 1 ? fb : 1) > 62;
  if (*unsafe) fa = fb = 1;
  const int64_t prod = fa * fb;
  return prod > 1 ? static_cast<uint64_t>(prod) : 1;
}

// Σ t over the shards and their vetoes.
struct CertSum {
  Wide128 sum;
  bool veto;
};

// kth i64[3 * D]: each shard's K-th (metric, count, key). Every lane of
// one warp calls this, with all 32 lanes converged; each lane returns the
// warp's sum. Each lane first loads its rows, then the symbol weights of
// their keys (WordPiece), so a lane's loads are two round trips deep.
__device__ __forceinline__ CertSum cert_terms(
    const int64_t* __restrict__ kth, int D,
    const int64_t* __restrict__ sym_freq, int wordpiece, int wide_score) {
  const int lane = threadIdx.x & 31;
  Wide128 sum{0, 0};
  bool veto = false;
  for (int i = lane; i < D; i += 32) {
    const int64_t metric = kth[3 * i];
    if (!wordpiece) {
      sum = u128_add(sum, {0, metric > 0 ? static_cast<uint64_t>(metric)
                                         : 0});
      continue;
    }
    if (metric < 0) continue;  // no K-th entry: every run was nominated
    const uint64_t key = static_cast<uint64_t>(kth[3 * i + 2]);
    uint64_t c = kth[3 * i + 1] > 0 ? kth[3 * i + 1] : 0;
    bool unsafe;
    const uint64_t d = cert_denominator(sym_freq[key >> 32],
                                        sym_freq[key & 0xffffffffULL],
                                        wide_score, &unsafe);
    if (unsafe) c = 1;
    const Wide128 q = scaled_quotient(c, d, true);
    uint64_t t = kCertSat;
    if (q.lo < kCertSat) {  // q.hi is 0 when saturated
      const uint64_t b = q.lo + (q.lo >> 50) + 2;
      t = b < kCertSat ? b : kCertSat;
    }
    sum = u128_add(sum, {0, t});
    veto = veto || t == kCertSat || unsafe;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const Wide128 o{__shfl_xor_sync(0xffffffffu, sum.hi, off),
                    __shfl_xor_sync(0xffffffffu, sum.lo, off)};
    sum = u128_add(sum, o);
  }
  return {sum, __any_sync(0xffffffffu, veto) != 0};
}

// The proven flag from the sum and the winner: ``best_key`` (a << 32 | b;
// 0 for an inactive step) and its summed count ``best_cnt`` (-1: none).
__device__ __forceinline__ bool cert_proven(
    CertSum s, int64_t best_cnt, uint64_t best_key,
    const int64_t* __restrict__ sym_freq, int wordpiece, int wide_score) {
  const bool zero = s.sum.hi == 0 && s.sum.lo == 0;
  if (!wordpiece)
    return zero || (best_cnt > 0 && s.sum.hi == 0 &&
                    static_cast<uint64_t>(best_cnt) > s.sum.lo);
  bool unsafe;
  const uint64_t d = cert_denominator(sym_freq[best_key >> 32],
                                      sym_freq[best_key & 0xffffffffULL],
                                      wide_score, &unsafe);
  const Wide128 lhs = scaled_quotient(
      best_cnt > 0 ? static_cast<uint64_t>(best_cnt) : 0, d, false);
  // Σ t + (Σ t >> 50) + 2
  const Wide128 shifted{s.sum.hi >> 50,
                        (s.sum.hi << 14) | (s.sum.lo >> 50)};
  const Wide128 rhs = u128_add(u128_add(s.sum, shifted), {0, 2});
  return zero || (u128_gt(lhs, rhs) && !s.veto && !unsafe);
}

}  // namespace
