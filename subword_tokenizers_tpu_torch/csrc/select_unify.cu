// K2: one training step's winner and merged symbol, for BPE and WordPiece.
//
// Replaces the JAX package's jitted XLA programs
//   subword_tokenizers_tpu/ops/pairstats.py: _select (and :147
//     bpe_select's selection), :240 wp_select_core and wp_score_bits (and
//     wp_select's selection, with compact_cands and _prefilter_cap),
//   subword_tokenizers_tpu/ops/bitmath.py: div_double_bits,
//     div_double_bits_wide, mul_53x53, bitlen, bitlen128, _round_q55, and
//   subword_tokenizers_tpu/ops/train_loop.py:68 _select_and_unify, and
//   subword_tokenizers_tpu/ops/wp_tournament.py:93 wp_tournament_select
//     (_cmp128, _sub128, _combine) with its redo at ops/pairstats.py:280-292
//     (the tournament mode below).
// Selection: over the pair table of K1 (pair_stats.cu), the pair with the
// largest metric, then the least first position. The metric is the count
// (BPE) or the score count / (freq_a * freq_b) as the int64 bits of the
// correctly rounded double (WordPiece; freq from the carried sym_freq).
// Positions are unique, so the order is total and the result does not
// depend on where K1 put each pair, nor on which entries are read in what
// order. Metrics reach 2^63, so (metric, ~pos) cannot be packed into one
// u64 for atomicMax: instead a reduction compares (metric, pos) pairs
// exactly, in one launch (select_kernel):
//   - the entries: with a claim list (claims mode), only the entries K1's
//     fill claimed, claims[0 .. n) with n read from the fill's counter on
//     the device (ops/pairstats.PairTable; every claimed entry is live and
//     no other is); without one (dense mode), every entry of the table,
//     empty ones skipped (the sharded step's 2,048 gathered candidates);
//   - a fixed grid strides over them; each block writes its best (metric,
//     pos, key) to part[3 * block] and takes a ticket; the last block to
//     take one (the ticket wraps back to 0 in the same atomicInc, so
//     nothing is cleared between calls) reduces the partials, then decides
//     active = alive && metric > 0 && vocab_size < max_vocab (an inactive
//     step records a = b = 0; every live score is a positive double, so
//     metric > 0 is JAX's count > 0 in both modes), computes the merged
//     symbol's hashes
//       m = (h[a] * B^l + h'[b]) mod (2^31 - 1)
//     in int64 (residues < 2^31, so products < 2^62) for both bases, with
//     l = len(b) and h'[b] = h[b] for BPE; for WordPiece the merged string
//     is a + b[2:], so l = max(len(b) - 2, 0) and the leading "##" is
//     stripped algebraically, h'[b] = (h[b] - h("##") * B^l) mod M, taken
//     non-negative (C's % of a negative is negative; JAX's is not). It
//     searches (h1, h2, len) over ids < n_sym (h1 first, read by all its
//     threads in order): a hit takes the LARGEST matching id, a miss
//     appends at n_sym and counts one more symbol.
//     It writes the record (a, b, new_id, matched, active) and updates
//     ctrl = (n_sym, vocab_size, alive && active).
// The WordPiece score (score_bits.cuh) is exact, so the exact mode needs
// no near-tie redo: narrow entries (fa * fb < 2^53, checked with __umul64hi)
// take __ddiv_rn of two exact doubles; wide ones a 128-bit restoring
// division with JAX's round-half-even tail. The JAX package compacts the
// run starts and prefilters them by exponent only to cut its TPU's long
// divisions per position; K1's table already holds one entry per distinct
// pair, so every live entry is scored.
// Tournament mode (WordPiece, narrow scores only: every fa * fb < 2^52 and
// count < 2^26) compares two entries c1 / d1 and c2 / d2, d = fa * fb, by
// the exact 128-bit products c1 d2 and c2 d1 (__umul64hi), with no
// division; equal rationals go by the least position. Each comparison
// whose relative gap is in (0, 2^-50] (JAX's _combine test) sets a sticky
// near-tie flag. The same reduction carries (c, d, pos, key, flag)
// instead of (metric, pos, key). Its tree is not JAX's halving
// tree, but every tree of exact comparisons picks the same winner. An
// entry whose double could tie the winner's lies within 2^-52 of it, and
// the entry that knocks it out lies between the two, so that comparison
// raises the flag in any tree; the flag may fire on other steps than in
// JAX, which costs time only. When the flag is set, the last block
// redoes the step itself with the exact scores over the same entries (the
// claims, or the whole table; the same launch, no host sync) and counts
// one redo.
// With host_ids set, the step is selection only (active = count > 0,
// new_id = -1 for the host to fill in), and neither the hash tables nor
// ctrl are touched: the exact per-step path of the trainer.
// Given the shards' K-th rows as well (host_ids, dense mode: the sharded
// top-K tier's gathered candidates), the last block also runs that tier's
// certificate (certificate.cuh) and writes its proven flag into rec[5]:
// each partial carries its entry's count beside the metric, so the
// winner's summed count comes out of the reduction, and the last warp
// computes the shards' terms while the first threads read the partials.
// The certificate then costs the step no launch and no wrapper call of
// its own (it replaces the JAX package's certificates at
// subword_tokenizers_tpu/parallel/train.py:283-290, :336-365, :383-400).
//
// Bound on this card: latency. What the function needs to read is the
// live entries (915 of K1's 2^19 at train-85k's initial state, about
// 26,000 later): 24 bytes each through the claim list (a claim, a key, a
// count, a position) and, in WordPiece mode, two gathers of sym_freq; and
// the 8-byte h1 of each id below n_sym for the unify. That is tens of
// kilobytes, far under one launch's latency. The earlier design read all
// T entries (10.5 MB at 20 bytes an entry) in a partial scan and then ran
// a second, one-block launch; this one reads only the claims and ends in
// its last block, one launch a step. The grid and the partials are
// fixed, and the partials and ticket are the caller's scratch, built once.
//
// swt_score_bits launches the scorer alone, elementwise, for the checks;
// the certificate's own check launcher is shard_select.cu's.

#include <cstdint>

#include <cuda_runtime.h>

#include "certificate.cuh"
#include "score_bits.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kEmpty = ~0ULL;
constexpr int64_t kMod = (1LL << 31) - 1;
constexpr int64_t kNoPos = INT64_MAX;
constexpr int kMaxPart = 264;  // blocks of a launch: two an SM of an H100
constexpr int kBatch = 16;     // h1 loads a thread keeps in flight
// ids whose h1 the last block reads into shared memory, in two halves
constexpr int kPrefetch = 2 * kBatch * kThreads;
constexpr int kPow = 64;       // powers it reads into shared memory

__device__ __forceinline__ bool better(int64_t c, int64_t p, int64_t bc,
                                       int64_t bp) {
  return c > bc || (c == bc && p < bp);
}

// Block-wide best (metric, pos, key) and, with kCount, the entry's count;
// the result is valid in thread 0.
template <bool kCount>
__device__ void block_best(int64_t& cnt, int64_t& pos, int64_t& key,
                           int64_t& num) {
  __shared__ int64_t sc[kWarps], sp[kWarps], sk[kWarps], sn[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t oc = __shfl_down_sync(0xffffffffu, cnt, off);
    const int64_t op = __shfl_down_sync(0xffffffffu, pos, off);
    const int64_t ok = __shfl_down_sync(0xffffffffu, key, off);
    const int64_t on = kCount ? __shfl_down_sync(0xffffffffu, num, off) : 0;
    if (better(oc, op, cnt, pos)) {
      cnt = oc;
      pos = op;
      key = ok;
      num = on;
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    sc[warp] = cnt;
    sp[warp] = pos;
    sk[warp] = key;
    if (kCount) sn[warp] = num;
  }
  __syncthreads();
  if (warp == 0) {
    cnt = lane < kWarps ? sc[lane] : -1;
    pos = lane < kWarps ? sp[lane] : kNoPos;
    key = lane < kWarps ? sk[lane] : -1;
    num = kCount && lane < kWarps ? sn[lane] : -1;
    for (int off = 16; off > 0; off >>= 1) {
      const int64_t oc = __shfl_down_sync(0xffffffffu, cnt, off);
      const int64_t op = __shfl_down_sync(0xffffffffu, pos, off);
      const int64_t ok = __shfl_down_sync(0xffffffffu, key, off);
      const int64_t on = kCount ? __shfl_down_sync(0xffffffffu, num, off) : 0;
      if (better(oc, op, cnt, pos)) {
        cnt = oc;
        pos = op;
        key = ok;
        num = on;
      }
    }
  }
}

// 128-bit product of two values < 2^64, as (hi, lo).
__device__ __forceinline__ void mul128(uint64_t a, uint64_t b, uint64_t& hi,
                                       uint64_t& lo) {
  lo = a * b;
  hi = __umul64hi(a, b);
}

// JAX's _combine: x becomes the winner of x and y, and its flag the OR of
// both flags and this comparison's near tie.
__device__ __forceinline__ void combine(int64_t& cx, int64_t& dx,
                                        int64_t& px, int64_t& kx, int& fx,
                                        int64_t cy, int64_t dy, int64_t py,
                                        int64_t ky, int fy) {
  uint64_t uh, ul, vh, vl;
  mul128(cx, dy, uh, ul);  // x's score times dx * dy
  mul128(cy, dx, vh, vl);  // y's
  const bool greater = uh > vh || (uh == vh && ul > vl);
  const bool equal = uh == vh && ul == vl;
  const uint64_t mh = greater ? uh : vh, ml = greater ? ul : vl;
  const uint64_t sh = greater ? vh : uh, sl = greater ? vl : ul;
  const uint64_t dl = ml - sl;
  const uint64_t dh = mh - sh - (ml < sl);
  const uint64_t th = mh >> 50, tl = (mh << 14) | (ml >> 50);
  const bool near = !equal && (dh < th || (dh == th && dl <= tl));
  if (!(greater || (equal && px <= py))) {
    cx = cy;
    dx = dy;
    px = py;
    kx = ky;
  }
  fx = fx | fy | near;
}

// Block-wide combine of (c, d, pos, key, flag); valid in thread 0.
__device__ void block_combine(int64_t& c, int64_t& d, int64_t& p,
                              int64_t& k, int& f) {
  __shared__ int64_t sc[kWarps], sd[kWarps], sp[kWarps], sk[kWarps];
  __shared__ int sf[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t oc = __shfl_down_sync(0xffffffffu, c, off);
    const int64_t od = __shfl_down_sync(0xffffffffu, d, off);
    const int64_t op = __shfl_down_sync(0xffffffffu, p, off);
    const int64_t ok = __shfl_down_sync(0xffffffffu, k, off);
    const int of = __shfl_down_sync(0xffffffffu, f, off);
    combine(c, d, p, k, f, oc, od, op, ok, of);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    sc[warp] = c;
    sd[warp] = d;
    sp[warp] = p;
    sk[warp] = k;
    sf[warp] = f;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < kWarps;
    c = in ? sc[lane] : 0;
    d = in ? sd[lane] : 1;
    p = in ? sp[lane] : kNoPos;
    k = in ? sk[lane] : -1;
    f = in ? sf[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      const int64_t oc = __shfl_down_sync(0xffffffffu, c, off);
      const int64_t od = __shfl_down_sync(0xffffffffu, d, off);
      const int64_t op = __shfl_down_sync(0xffffffffu, p, off);
      const int64_t ok = __shfl_down_sync(0xffffffffu, k, off);
      const int of = __shfl_down_sync(0xffffffffu, f, off);
      combine(c, d, p, k, f, oc, od, op, ok, of);
    }
  }
}

// The entries a call reads: claims[0 .. n) of the table (claims mode) or
// its first n = T entries (dense mode).
struct Entries {
  const unsigned long long* keys;
  const int64_t* counts;
  const uint32_t* pos;
  const uint32_t* claims;  // null in dense mode
  int64_t n;
  __device__ __forceinline__ int64_t at(int64_t e) const {
    return claims != nullptr ? static_cast<int64_t>(claims[e]) : e;
  }
};

// This thread's best (metric, pos, key, count) over entries start, start
// + stride, ... (the exact modes).
__device__ __forceinline__ void scan_best(const Entries& in,
                                          const int64_t* sym_freq,
                                          int wordpiece, int64_t start,
                                          int64_t stride, int64_t& bc,
                                          int64_t& bp, int64_t& bk,
                                          int64_t& bn) {
  for (int64_t e = start; e < in.n; e += stride) {
    const int64_t t = in.at(e);
    const unsigned long long k = in.keys[t];
    if (k == kEmpty) continue;
    const int64_t n = in.counts[t];
    const int64_t c =
        wordpiece ? score_bits(n, sym_freq[k >> 32],
                               sym_freq[k & 0xffffffffULL])
                  : n;
    const int64_t p = in.pos[t];
    if (better(c, p, bc, bp)) {
      bc = c;
      bp = p;
      bk = static_cast<int64_t>(k);
      bn = n;
    }
  }
}

// The unify's arguments (swt_select_unify).
struct Unify {
  int64_t* h1;
  int64_t* h2;
  int64_t* slen;
  int64_t sym_cap;
  int32_t* ctrl;
  const int64_t* pw1;
  const int64_t* pw2;
  int64_t n_pow;
  int64_t max_vocab;
  int32_t* rec;
  int host_ids;
  int64_t sh1;
  int64_t sh2;
  int32_t* redo;
};

// The certificate's arguments (host_ids mode over the gathered candidates
// only; kth null: no certificate).
struct Cert {
  const int64_t* kth;  // each shard's K-th (metric, count, key)
  int D;
  int wide_score;
};

__device__ __forceinline__ int64_t load_cg(const int64_t* p) {
  return static_cast<int64_t>(__ldcg(reinterpret_cast<const long long*>(p)));
}

// part: 5 words a block (3 in the exact modes, 4 with the certificate);
// ticket: 0 between calls; n_claims: the claim count in claims mode, else
// null. kCert: the certificate runs (cert.kth not null), and the partials
// carry the entries' counts for it.
template <bool kCert>
__global__ void __launch_bounds__(kThreads)
    select_kernel(Entries in, const int64_t* sym_freq, int wordpiece,
                  int tournament, int64_t* part, unsigned* ticket, Unify u,
                  const uint32_t* n_claims, Cert cert) {
  __shared__ int64_t s_key, s_cnt, s_num, s_m1, s_m2, s_lm;
  __shared__ CertSum s_cert;
  __shared__ int64_t s_pw1[kPow], s_pw2[kPow];
  __shared__ int32_t s_h1[kPrefetch];
  __shared__ int s_hit, s_near;
  __shared__ bool s_last;
  if (n_claims != nullptr) in.n = *n_claims;
  const int64_t start =
      blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if (tournament) {
    int64_t c = 0, d = 1, p = kNoPos, k = -1;
    int f = 0;
    for (int64_t e = start; e < in.n; e += stride) {
      const int64_t t = in.at(e);
      const unsigned long long key = in.keys[t];
      if (key == kEmpty) continue;
      const int64_t fa = sym_freq[key >> 32];
      const int64_t fb = sym_freq[key & 0xffffffffULL];
      combine(c, d, p, k, f, in.counts[t],
              (fa > 1 ? fa : 1) * (fb > 1 ? fb : 1), in.pos[t],
              static_cast<int64_t>(key), 0);
    }
    block_combine(c, d, p, k, f);
    if (threadIdx.x == 0) {
      int64_t* out = part + 5 * blockIdx.x;
      out[0] = c;
      out[1] = d;
      out[2] = p;
      out[3] = k;
      out[4] = f;
    }
  } else {
    int64_t bc = -1, bp = kNoPos, bk = -1, bn = -1;
    scan_best(in, sym_freq, wordpiece, start, stride, bc, bp, bk, bn);
    block_best<kCert>(bc, bp, bk, bn);
    if (threadIdx.x == 0) {
      int64_t* out = part + (kCert ? 4 : 3) * blockIdx.x;
      out[0] = bc;
      out[1] = bp;
      out[2] = bk;
      if (kCert) out[3] = bn;
    }
  }
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // The last block: every block's partial is written. The unify's tables
  // are brought into shared memory while the partials are reduced and
  // the winner's entries read: the powers, and h1 of the first ids (a
  // residue below 2^31 each, kept as int32; bounded by the table's
  // length, a host argument, so no load waits for n_sym), kBatch ids a
  // thread in flight at once; the search then reads h2 and slen only
  // where h1 matches. Every load below is issued before any is used, so
  // their round trips overlap.
  __threadfence();
  const int n_h = u.host_ids ? 0 : static_cast<int>(
      u.sym_cap < kPrefetch ? u.sym_cap : kPrefetch);
  const int n_pw = u.host_ids ? 0 : static_cast<int>(
      u.n_pow < kPow ? u.n_pow : kPow);
  int32_t v[kBatch];
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    const int id = q * kThreads + threadIdx.x;
    v[q] = id < n_h ? static_cast<int32_t>(u.h1[id]) : 0;
  }
  const bool has_pw = static_cast<int>(threadIdx.x) < n_pw;
  const int64_t pw1_t = has_pw ? u.pw1[threadIdx.x] : 0;
  const int64_t pw2_t = has_pw ? u.pw2[threadIdx.x] : 0;
  const int32_t n_sym = u.ctrl[0];
  const int32_t vocab = u.ctrl[1];
  const int32_t alive = u.ctrl[2];
  const int n_part = gridDim.x;
  // The certificate's terms need no winner: the last warp computes them
  // (its loads in flight beside the partials' reads, which the first
  // threads make) before it joins the reduction.
  if (kCert && threadIdx.x >= kThreads - 32) {
    const CertSum cs = cert_terms(cert.kth, cert.D, sym_freq, wordpiece,
                                  cert.wide_score);
    if (threadIdx.x == kThreads - 32) s_cert = cs;
  }
  int64_t bc = -1, bp = kNoPos, bk = -1, bn = -1;
  if (tournament) {
    int64_t c = 0, d = 1, p = kNoPos, k = -1;
    int f = 0;
    for (int j = threadIdx.x; j < n_part; j += blockDim.x) {
      const int64_t* q = part + 5 * j;
      combine(c, d, p, k, f, load_cg(q), load_cg(q + 1), load_cg(q + 2),
              load_cg(q + 3), static_cast<int>(load_cg(q + 4)));
    }
    block_combine(c, d, p, k, f);
    if (threadIdx.x == 0) s_near = f;
    __syncthreads();
    if (s_near) {
      // A near tie: the exact scores decide, over the same entries.
      scan_best(in, sym_freq, 1, threadIdx.x, blockDim.x, bc, bp, bk, bn);
      block_best<false>(bc, bp, bk, bn);
      if (threadIdx.x == 0) ++*u.redo;
    } else {
      bc = c;  // the count; the step is active while it is positive
      bk = k;
    }
  } else {
    for (int j = threadIdx.x; j < n_part; j += blockDim.x) {
      const int64_t* q = part + (kCert ? 4 : 3) * j;
      const int64_t c = load_cg(q);
      const int64_t p = load_cg(q + 1);
      const int64_t k = load_cg(q + 2);
      const int64_t n = kCert ? load_cg(q + 3) : 0;
      if (better(c, p, bc, bp)) {
        bc = c;
        bp = p;
        bk = k;
        bn = n;
      }
    }
    block_best<kCert>(bc, bp, bk, bn);
  }
  if (threadIdx.x == 0) {
    s_cnt = bc;
    s_key = bk;
    if (kCert) s_num = bn;
    s_hit = -1;
  }
  if (has_pw) {
    s_pw1[threadIdx.x] = pw1_t;
    s_pw2[threadIdx.x] = pw2_t;
  }
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    const int id = q * kThreads + threadIdx.x;
    if (id < n_h) s_h1[id] = v[q];
  }
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {  // the second half, in flight
    const int id = (kBatch + q) * kThreads + threadIdx.x;
    v[q] = id < n_h ? static_cast<int32_t>(u.h1[id]) : 0;
  }
  __syncthreads();
  const int64_t cnt = s_cnt;
  const int64_t key = s_key;
  int32_t* rec = u.rec;
  if (u.host_ids) {
    if (threadIdx.x == 0) {
      const bool active = cnt > 0;
      rec[0] = active ? static_cast<int32_t>(key >> 32) : 0;
      rec[1] = active ? static_cast<int32_t>(key & 0xffffffffLL) : 0;
      rec[2] = -1;
      rec[3] = 0;
      rec[4] = active;
      // The winner's summed count is its entry's (the candidates of one
      // key carry the one sum the lookup gave them); -1: none.
      if (kCert)
        rec[5] = cert_proven(
            s_cert, active && s_num > 0 ? s_num : -1,
            active ? static_cast<uint64_t>(key) : 0, sym_freq, wordpiece,
            cert.wide_score);
    }
    return;
  }
  const bool active = alive != 0 && cnt > 0 && vocab < u.max_vocab;
  const int32_t a = active ? static_cast<int32_t>(key >> 32) : 0;
  const int32_t b = active ? static_cast<int32_t>(key & 0xffffffffLL) : 0;
  const int64_t* h1 = u.h1;
  const int64_t* h2 = u.h2;
  const int64_t* slen = u.slen;
  if (threadIdx.x == 0) {
    const int64_t ha1 = h1[a], ha2 = h2[a], la = slen[a];
    const int64_t hb1 = h1[b], hb2 = h2[b], lb0 = slen[b];
    const int64_t lb = wordpiece ? (lb0 > 2 ? lb0 - 2 : 0) : lb0;
    // B^lb, with the index clamped to the table as XLA's gather does.
    const int64_t k = lb < u.n_pow - 1 ? lb : u.n_pow - 1;
    const int64_t p1 = k < n_pw ? s_pw1[k] : u.pw1[k];
    const int64_t p2 = k < n_pw ? s_pw2[k] : u.pw2[k];
    int64_t rb1 = hb1, rb2 = hb2;
    if (wordpiece) {
      rb1 = (rb1 - u.sh1 * p1 % kMod + kMod) % kMod;
      rb2 = (rb2 - u.sh2 * p2 % kMod + kMod) % kMod;
    }
    s_m1 = (ha1 * p1 % kMod + rb1) % kMod;
    s_m2 = (ha2 * p2 % kMod + rb2) % kMod;
    s_lm = la + lb;
  }
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    const int id = (kBatch + q) * kThreads + threadIdx.x;
    if (id < n_h) s_h1[id] = v[q];
  }
  __syncthreads();
  const int64_t m1 = s_m1, m2 = s_m2, lm = s_lm;
  const int32_t m1_lo = static_cast<int32_t>(m1);
  const int n_pre = n_sym < n_h ? n_sym : n_h;
  int best = -1;
  for (int id = threadIdx.x; id < n_pre; id += blockDim.x) {
    if (s_h1[id] == m1_lo && h2[id] == m2 && slen[id] == lm) best = id;
  }
  for (int id = n_pre + threadIdx.x; id < n_sym; id += blockDim.x) {
    if (h1[id] == m1 && h2[id] == m2 && slen[id] == lm) best = id;
  }
  if (best >= 0) atomicMax(&s_hit, best);
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool matched = s_hit >= 0;
    const int32_t new_id = matched ? s_hit : n_sym;
    const bool grow = active && !matched && n_sym < u.sym_cap;
    if (grow) {
      u.h1[n_sym] = m1;
      u.h2[n_sym] = m2;
      u.slen[n_sym] = lm;
    }
    u.ctrl[0] = n_sym + grow;
    u.ctrl[1] = vocab + grow;
    u.ctrl[2] = alive != 0 && active;
    rec[0] = a;
    rec[1] = b;
    rec[2] = new_id;
    rec[3] = matched;
    rec[4] = active;
  }
}

__global__ void score_bits_kernel(const int64_t* c, const int64_t* fa,
                                  const int64_t* fb, int64_t n,
                                  int64_t* out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += stride)
    out[i] = score_bits(c[i], fa[i], fb[i]);
}

}  // namespace

extern "C" {

// keys/counts i64[T], pos i32[T] (K1's table); claims u32[>= n] and
// n_claims u32[1] (claims mode: the fill's claim list and its counter,
// read on the device), or both null (dense mode, every entry); scratch
// i64[5 * kMaxPart + 1] (the partials, then the ticket, 0 between calls),
// 1 <= n_part <= kMaxPart blocks; h1/h2/slen i64[sym_cap], ctrl i32[3],
// pw1/pw2 i64[n_pow], rec i32[6] (columns 0-4 written); with wordpiece,
// sym_freq i64[>= every symbol id + 1] and (sh1, sh2) the hashes of "##";
// with tournament (wordpiece too), redo i32[1] counts the steps redone
// exactly; kth i64[3 * D] (host_ids, dense mode and not the tournament:
// each shard's K-th metric, count, key) writes the certificate's proven
// flag into rec[5], or null. Returns the cudaError_t.
int swt_select_unify(const void* keys, const void* counts, const void* pos,
                     int64_t T, const void* claims, const void* n_claims,
                     void* scratch, int n_part, void* h1, void* h2,
                     void* slen, int64_t sym_cap, void* ctrl,
                     const void* pw1, const void* pw2, int64_t n_pow,
                     int64_t max_vocab, void* rec, int host_ids,
                     const void* sym_freq, int wordpiece, int64_t sh1,
                     int64_t sh2, int tournament, void* redo,
                     const void* kth, int D, int wide_score, void* stream) {
  if (n_part < 1 || n_part > kMaxPart) return cudaErrorInvalidValue;
  if (kth != nullptr && (!host_ids || tournament || claims != nullptr ||
                         D < 1))
    return cudaErrorInvalidValue;
  Entries in{static_cast<const unsigned long long*>(keys),
             static_cast<const int64_t*>(counts),
             static_cast<const uint32_t*>(pos),
             static_cast<const uint32_t*>(claims), T};
  int64_t* part = static_cast<int64_t*>(scratch);
  Unify u{static_cast<int64_t*>(h1),     static_cast<int64_t*>(h2),
          static_cast<int64_t*>(slen),   sym_cap,
          static_cast<int32_t*>(ctrl),   static_cast<const int64_t*>(pw1),
          static_cast<const int64_t*>(pw2), n_pow,
          max_vocab,                     static_cast<int32_t*>(rec),
          host_ids,                      sh1,
          sh2,                           static_cast<int32_t*>(redo)};
  auto* kernel = kth != nullptr ? select_kernel<true> : select_kernel<false>;
  kernel<<<n_part, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const int64_t*>(sym_freq), wordpiece, tournament,
      part, reinterpret_cast<unsigned*>(part + 5 * kMaxPart), u,
      static_cast<const uint32_t*>(n_claims),
      Cert{static_cast<const int64_t*>(kth), D, wide_score});
  return static_cast<int>(cudaGetLastError());
}

// c/fa/fb/out i64[n], n >= 1: out = score_bits(c, fa, fb) elementwise.
// Returns the cudaError_t.
int swt_score_bits(const void* c, const void* fa, const void* fb, int64_t n,
                   void* out, void* stream) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 4096 ? want : 4096);
  score_bits_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(
                                                stream)>>>(
      static_cast<const int64_t*>(c), static_cast<const int64_t*>(fa),
      static_cast<const int64_t*>(fb), n, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
