// The per-shard pieces of data-parallel selection: candidate lookup,
// table compaction, and the sum-threshold certificate.
//
// Replaces the per-shard parts of the JAX package's sharded selection,
//   subword_tokenizers_tpu/parallel/train.py: _lookup_runs (binary search
//     of the candidates in the shard's sorted runs), compact_cands as used
//     by sharded_{bpe,wp}_select_compact (ops/pairstats.py:162), and the
//     certificates of sharded_bpe_select_topk and sharded_wp_select_topk,
// which run inside shard_map programs over sorted pair runs. Here each
// shard's pairs live in K1's open-addressing table (pair_stats.cu): keys
// a << 32 | b (all ones when empty), counts, and local positions row * L +
// j; a shard adds its base first_row * L to every position it reports, so
// positions order pairs across shards as one device's would.
//
// - lookup_kernel: one thread per gathered candidate key probes the
//   shard's table with K1's hash and linear probe (the table is at most
//   half full, so a probe for an absent key ends at an empty entry) and
//   writes (count, position + base), or (0, POS_MAX) when the key is absent
//   or empty.
// - count_live_kernel and write_runs_kernel, the compaction in two
//   launches over tiles of 1,024 entries, one block each: the first counts
//   each tile's live entries; the second gives each block its first rank
//   (the sum of the counts before its tile), ranks its live entries by a
//   warp ballot and a scan of its warps' counts, and writes those of rank
//   < cap densely as (key, count, position + base), in table order. The
//   rest of the output is (EMPTY, 0, POS_MAX), and the flag says whether
//   more than cap entries were live (the compact tier then cannot be
//   exact).
// - certificate_kernel, one block: from every shard's K-th best entry (its
//   metric, count and key) the threshold t_i that bounds any pair the shard
//   did not nominate, and from the winner K2 chose over the candidates
//   (the record's a, b, active) and its summed count, the proven flag,
//   written into rec[5]. BPE: t_i = max(metric, 0), proven = count > sum t
//   or sum t == 0. WordPiece: t_i = min(q + (q >> 50) + 2, 2^55) with q =
//   (c << 36) // (fa fb) of the K-th entry, a shard whose bound reaches
//   2^55 (or, with wide scores, whose K-th denominator needs more than 62
//   bits) vetoes, and proven = (count << 36) // (fa fb) of the winner >
//   sum t + (sum t >> 50) + 2 with no veto, or sum t == 0. The JAX package
//   computes these in int64; here the shifted numerators (up to 2^89) and
//   their quotients are 128-bit, so the results are the JAX package's
//   wherever its int64 does not overflow.
//
// Bound on this card: the lookup reads K * D candidates and a few probed
// entries each; the compaction reads the whole table (20 bytes an entry)
// over 128 blocks at a shard's table size (2^17 entries on train-85k at
// 8 shards), so two launches' latency bounds it; the certificate is one
// block of integer work over D shards and K * D candidates.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // table entries (and threads) of a block
constexpr unsigned long long kEmpty = ~0ULL;
constexpr int32_t kPosMax = 0x7fffffff;
constexpr uint64_t kSat = 1ULL << 55;
constexpr int kScaleBits = 36;

// The same hash as K1's (pair_stats.cu), so a lookup probes where K1 put
// the key.
__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

__global__ void lookup_kernel(const unsigned long long* __restrict__ cand,
                              int64_t M,
                              const unsigned long long* __restrict__ keys,
                              const int64_t* __restrict__ counts,
                              const uint32_t* __restrict__ pos,
                              unsigned long long mask, int64_t base,
                              int64_t* __restrict__ out_cnt,
                              int32_t* __restrict__ out_pos) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= M) return;
  const unsigned long long key = cand[i];
  int64_t c = 0;
  int32_t p = kPosMax;
  if (key != kEmpty) {
    unsigned long long h = mix64(key) & mask;
    while (true) {
      const unsigned long long k = keys[h];
      if (k == key) {
        c = counts[h];
        p = static_cast<int32_t>(pos[h] + base);
        break;
      }
      if (k == kEmpty) break;
      h = (h + 1) & mask;
    }
  }
  out_cnt[i] = c;
  out_pos[i] = p;
}

// Pass 1 of the compaction: each block counts the live entries of its
// tile of kTile entries.
__global__ void count_live_kernel(const unsigned long long* __restrict__ keys,
                                  int64_t T, int32_t* __restrict__ tile_live) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kTile) + threadIdx.x;
  const int n = __syncthreads_count(i < T && keys[i] != kEmpty);
  if (threadIdx.x == 0) tile_live[blockIdx.x] = n;
}

// Pass 2: each block sums the counts of the tiles before its own (its
// first rank) and of all tiles (the total), ranks its live entries by a
// warp ballot and a scan of the warps' counts, and writes those of rank
// < cap; the blocks together fill ranks total .. cap - 1 with (EMPTY, 0,
// POS_MAX), and block 0 writes the overflow flag.
__global__ void write_runs_kernel(const unsigned long long* __restrict__ keys,
                                  const int64_t* __restrict__ counts,
                                  const uint32_t* __restrict__ pos, int64_t T,
                                  int64_t cap, int64_t base,
                                  const int32_t* __restrict__ tile_live,
                                  int64_t n_tiles,
                                  int64_t* __restrict__ out_keys,
                                  int64_t* __restrict__ out_cnt,
                                  int32_t* __restrict__ out_pos,
                                  int32_t* __restrict__ ovf) {
  __shared__ unsigned long long s_before, s_total;
  __shared__ int warp_live[kTile / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_before = s_total = 0;
  __syncthreads();
  unsigned long long before = 0, total = 0;
  for (int64_t j = threadIdx.x; j < n_tiles; j += blockDim.x) {
    total += tile_live[j];
    if (j < blockIdx.x) before += tile_live[j];
  }
  if (total) atomicAdd(&s_total, total);
  if (before) atomicAdd(&s_before, before);
  const int64_t i = blockIdx.x * static_cast<int64_t>(kTile) + threadIdx.x;
  const bool live = i < T && keys[i] != kEmpty;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) warp_live[warp] = __popc(ballot);
  __syncthreads();
  int64_t rank = static_cast<int64_t>(s_before) +
                 __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) rank += warp_live[w];
  if (live && rank < cap) {
    out_keys[rank] = static_cast<int64_t>(keys[i]);
    out_cnt[rank] = counts[i];
    out_pos[rank] = static_cast<int32_t>(pos[i] + base);
  }
  const int64_t n = static_cast<int64_t>(s_total);
  for (int64_t j = n + blockIdx.x * static_cast<int64_t>(kTile) + threadIdx.x;
       j < cap; j += static_cast<int64_t>(gridDim.x) * kTile) {
    out_keys[j] = -1;
    out_cnt[j] = 0;
    out_pos[j] = kPosMax;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *ovf = n > cap;
}

__device__ __forceinline__ int bitlen64(uint64_t x) {
  return x ? 64 - __clzll(x) : 0;
}

// floor((hi * 2^64 + lo) / d) for 0 < d < 2^63, as (*q_hi, return value):
// a restoring division, the remainder staying below d.
__device__ uint64_t div128(uint64_t hi, uint64_t lo, uint64_t d,
                           uint64_t* q_hi) {
  uint64_t qh = 0, ql = 0, r = 0;
  for (int i = 127; i >= 0; --i) {
    const uint64_t bit = i >= 64 ? (hi >> (i - 64)) & 1 : (lo >> i) & 1;
    r = (r << 1) | bit;
    if (r >= d) {
      r -= d;
      if (i >= 64)
        qh |= 1ULL << (i - 64);
      else
        ql |= 1ULL << i;
    }
  }
  *q_hi = qh;
  return ql;
}

// floor((c << 36) / d), c >= 0, 0 < d < 2^63, as (*q_hi, return value).
__device__ __forceinline__ uint64_t scaled_quotient(uint64_t c, uint64_t d,
                                                    uint64_t* q_hi) {
  return div128(c >> (64 - kScaleBits), c << kScaleBits, d, q_hi);
}

__global__ void certificate_kernel(const int64_t* __restrict__ kth, int D,
                                   const unsigned long long* __restrict__ cand,
                                   const int64_t* __restrict__ g_cnt,
                                   int64_t M, int32_t* rec,
                                   const int64_t* __restrict__ sym_freq,
                                   int wordpiece, int wide_score) {
  __shared__ unsigned long long s_best;
  const bool active = rec[4] != 0;
  const unsigned long long best_key =
      (static_cast<unsigned long long>(static_cast<uint32_t>(rec[0])) << 32) |
      static_cast<uint32_t>(rec[1]);
  if (threadIdx.x == 0) s_best = 0;
  __syncthreads();
  // The winner's summed count: counts are >= 0, so the largest count + 1
  // over the candidates of its key is kept (0: none).
  if (active) {
    unsigned long long best = 0;
    for (int64_t j = threadIdx.x; j < M; j += blockDim.x) {
      if (cand[j] == best_key && cand[j] != kEmpty && g_cnt[j] > 0) {
        const unsigned long long v =
            static_cast<unsigned long long>(g_cnt[j]) + 1;
        if (v > best) best = v;
      }
    }
    if (best) atomicMax(&s_best, best);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int64_t best_cnt = static_cast<int64_t>(s_best) - 1;  // -1: none
  uint64_t sum_t = 0;
  bool any_sat = false;
  for (int i = 0; i < D; ++i) {
    const int64_t metric = kth[3 * i];
    if (!wordpiece) {
      sum_t += metric > 0 ? static_cast<uint64_t>(metric) : 0;
      continue;
    }
    if (metric < 0) continue;  // no K-th entry: every run was nominated
    const unsigned long long key =
        static_cast<unsigned long long>(kth[3 * i + 2]);
    uint64_t c = kth[3 * i + 1] > 0 ? kth[3 * i + 1] : 0;
    int64_t fa = sym_freq[key >> 32];
    int64_t fb = sym_freq[key & 0xffffffffULL];
    bool unsafe = false;
    if (wide_score) {
      unsafe = bitlen64(fa > 1 ? fa : 1) + bitlen64(fb > 1 ? fb : 1) > 62;
      if (unsafe) {
        fa = fb = 1;
        c = 1;
      }
    }
    const int64_t prod = fa * fb;
    const uint64_t d = prod > 1 ? static_cast<uint64_t>(prod) : 1;
    uint64_t qh;
    const uint64_t q = scaled_quotient(c, d, &qh);
    uint64_t t;
    bool sat;
    if (qh != 0 || q >= kSat) {
      t = kSat;
      sat = true;
    } else {
      const uint64_t bound = q + (q >> 50) + 2;
      sat = bound >= kSat;
      t = sat ? kSat : bound;
    }
    sum_t += t;
    any_sat = any_sat || sat || unsafe;
  }
  bool proven;
  if (!wordpiece) {
    proven = best_cnt > static_cast<int64_t>(sum_t) || sum_t == 0;
  } else {
    int64_t fa = sym_freq[best_key >> 32];
    int64_t fb = sym_freq[best_key & 0xffffffffULL];
    bool best_unsafe = false;
    if (wide_score) {
      best_unsafe =
          bitlen64(fa > 1 ? fa : 1) + bitlen64(fb > 1 ? fb : 1) > 62;
      if (best_unsafe) fa = fb = 1;
    }
    const int64_t prod = fa * fb;
    const uint64_t d = prod > 1 ? static_cast<uint64_t>(prod) : 1;
    uint64_t lh;
    const uint64_t l =
        scaled_quotient(best_cnt > 0 ? static_cast<uint64_t>(best_cnt) : 0,
                        d, &lh);
    const uint64_t rhs = sum_t + (sum_t >> 50) + 2;
    const bool above = lh != 0 || l > rhs;
    proven = (above && !any_sat && !best_unsafe) || sum_t == 0;
  }
  rec[5] = proven;
}

}  // namespace

extern "C" {

// cand i64[M] (EMPTY for none); keys/counts i64[T], pos i32[T] (K1's
// table, T a power of two); base >= 0 -> out_cnt i64[M], out_pos i32[M].
// Returns the cudaError_t.
int swt_lookup_runs(const void* cand, int64_t M, const void* keys,
                    const void* counts, const void* pos, int64_t T,
                    int64_t base, void* out_cnt, void* out_pos,
                    void* stream) {
  if (M <= 0) return 0;
  const int64_t blocks = (M + kThreads - 1) / kThreads;
  lookup_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(cand), M,
      static_cast<const unsigned long long*>(keys),
      static_cast<const int64_t*>(counts), static_cast<const uint32_t*>(pos),
      static_cast<unsigned long long>(T - 1), base,
      static_cast<int64_t*>(out_cnt), static_cast<int32_t*>(out_pos));
  return static_cast<int>(cudaGetLastError());
}

// keys/counts i64[T], pos i32[T] (K1's table); cap >= 1; base >= 0 ->
// out_keys/out_cnt i64[cap], out_pos i32[cap], ovf i32[1]; tile_live
// i32[ceil(T / 1024)] scratch. Returns the cudaError_t.
int swt_compact_table(const void* keys, const void* counts, const void* pos,
                      int64_t T, int64_t cap, int64_t base, void* out_keys,
                      void* out_cnt, void* out_pos, void* ovf,
                      void* tile_live, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_tiles = (T + kTile - 1) / kTile;
  count_live_kernel<<<static_cast<unsigned>(n_tiles), kTile, 0, s>>>(
      static_cast<const unsigned long long*>(keys), T,
      static_cast<int32_t*>(tile_live));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  write_runs_kernel<<<static_cast<unsigned>(n_tiles), kTile, 0, s>>>(
      static_cast<const unsigned long long*>(keys),
      static_cast<const int64_t*>(counts), static_cast<const uint32_t*>(pos),
      T, cap, base, static_cast<const int32_t*>(tile_live), n_tiles,
      static_cast<int64_t*>(out_keys), static_cast<int64_t*>(out_cnt),
      static_cast<int32_t*>(out_pos), static_cast<int32_t*>(ovf));
  return static_cast<int>(cudaGetLastError());
}

// kth i64[3 * D] (each shard's K-th metric, count, key); cand/g_cnt
// i64[M]; rec i32[6] (K2's record: a, b, active; rec[5] is written);
// sym_freq i64 over the symbol ids (WordPiece only, else may be null).
// Returns the cudaError_t.
int swt_certificate(const void* kth, int D, const void* cand,
                    const void* g_cnt, int64_t M, void* rec,
                    const void* sym_freq, int wordpiece, int wide_score,
                    void* stream) {
  certificate_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(kth), D,
      static_cast<const unsigned long long*>(cand),
      static_cast<const int64_t*>(g_cnt), M, static_cast<int32_t*>(rec),
      static_cast<const int64_t*>(sym_freq), wordpiece, wide_score);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
