// The nomination of the sharded top-K tier: each shard's k best live pairs
// and its K-th best entry, for every shard of one device in one launch.
//
// Replaces the per-shard phase 1 of the JAX package's two-phase selection,
//   subword_tokenizers_tpu/parallel/train.py:249 sharded_bpe_select_topk
//     (the metric and jax.lax.top_k at :263-275) and
//   subword_tokenizers_tpu/parallel/train.py:298 sharded_wp_select_topk
//     (wp_score_bits and jax.lax.top_k at :326-341),
// which rank a shard's key-sorted runs by metric with top_k, the lower
// index first at equal metrics: the order (metric descending, key
// ascending), which this kernel reproduces exactly. The metric of a live
// entry of K1's table (pair_stats.cu: keys a << 32 | b, all ones when
// empty) is its count (BPE) or the exact score bits of count / (fa * fb)
// over the mesh's symbol weights (WordPiece; score_bits.cuh, sym_freq read
// here). Output, shard i of the D in the descriptor (ops/shard_select.py's
// TableSet, rows of table_set.cuh's Shard):
//   cand[i * k + r], r < k: the key of the entry of rank r, EMPTY past the
//     live entries and where the metric nominates nothing (BPE <= 0,
//     WordPiece < 0);
//   kth[3 i .. 3 i + 2]: (metric, count, key) of the entry of rank k - 1,
//     or (-1, 0, EMPTY) when the shard has fewer than k live entries.
//
// Design. A cluster of 8 blocks of 1,024 threads a shard (grid 8 x D).
// - Read: each block reads its share of the table's keys as 16-byte
//   vectors (4 pairs a thread in flight, 65,536 entries a cluster round),
//   computes the metric of each live entry once and stages (metric, key,
//   index) in shared memory, up to kStage entries a block; a block with
//   more (a table above 131,072 entries, the mesh of 1's 2^20) reads its
//   share from global memory again on later passes, until the entries
//   still in play fit and it stages those. The block's live count, the
//   minimum and maximum metric and the OR of the keys' halves are summed
//   over the cluster through distributed shared memory.
// - Order: every entry maps to one unsigned number V, larger for a better
//   entry: the metric's bits below the common prefix of the minimum and
//   maximum, then the key (a << wb | b, the width of the ORs) inverted.
//   V is at most 126 bits and unique, since keys are unique in a table.
// - Select: an MSB-first radix select, 8 bits a pass, over the entries
//   whose higher bytes equal the prefix chosen so far: each block counts
//   its entries' digits into a histogram in shared memory (two, used in
//   turn, so one cluster barrier a pass suffices), every block sums the 8
//   histograms through distributed shared memory and finds the same digit
//   where the k-th best falls. Passes stop when the entries of that digit
//   are exactly the ones still needed: then exactly min(k, live) entries
//   have V at or above the prefix. A table with at most k live entries
//   takes no pass.
// - Gather: each block lists its qualifying entries (at most k), block
//   rank 0 copies the other lists through distributed shared memory,
//   orders the at most 256 entries by rank (each thread counts the entries
//   better than its own: one barrier, no sorting network) and writes cand
//   and the K-th row.
// Nothing outside shared memory is written but the outputs, and nothing
// needs resetting between calls: no memset, no ticket.
//
// Bound on this card: bytes. Every key is read (8 bytes an entry: 8.4 MB
// over the 8 tables of 131,072 entries of the one-card mesh), and the
// count of each live entry (8), with two gathers of sym_freq a live entry
// in WordPiece mode; the outputs are 8 (k + 3) bytes a shard: about
// 0.0026-0.0028 ms at 3.35 TB/s. The passes over shared memory, their
// cluster barriers and the launch's latency come on top.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "score_bits.cuh"
#include "table_set.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned long long kEmpty = ~0ULL;
constexpr int kCluster = 8;      // blocks of a shard's cluster
constexpr int kThreads = 1024;   // threads of a block
constexpr int kSlices = 4;       // 16-byte key pairs a thread loads at once
constexpr int64_t kBlockSpan = 2LL * kSlices * kThreads;
constexpr int64_t kRoundSpan = kCluster * kBlockSpan;
constexpr unsigned kStage = 8192;  // entries a block stages
constexpr int kBins = 256;         // 8 bits a pass
constexpr int kMaxK = 256;         // the most a shard nominates

struct Smem {
  long long metric[kStage];
  unsigned long long key[kStage];
  uint32_t idx[kStage];
  unsigned hist[2][kBins];
  unsigned tot[kBins];
  long long q_metric[kMaxK];  // the block's qualifying entries; block 0's
  unsigned long long q_key[kMaxK];  // then hold every block's
  long long q_count[kMaxK];
  unsigned long long mx, mn;  // the block's largest and least ordered metric
  unsigned ora, orb;          // the OR of its keys' a and b halves
  unsigned n_stage, live, n_q;
  unsigned d, above, cnt;     // a pass's digit and its counts
  // the cluster's: its live count and V's layout
  unsigned total, hb, wb, w;
};

struct U128 {
  unsigned long long hi, lo;
};

__device__ __forceinline__ U128 shl(U128 v, int n) {  // 0 <= n < 128
  if (n == 0) return v;
  if (n >= 64) return {v.lo << (n - 64), 0};
  return {(v.hi << n) | (v.lo >> (64 - n)), v.lo << n};
}

__device__ __forceinline__ U128 shr(U128 v, int n) {  // 0 <= n <= 128
  if (n == 0) return v;
  if (n >= 128) return {0, 0};
  if (n >= 64) return {0, v.hi >> (n - 64)};
  return {v.hi >> n, (v.lo >> n) | (v.hi << (64 - n))};
}

__device__ __forceinline__ bool eq(U128 a, U128 b) {
  return a.hi == b.hi && a.lo == b.lo;
}

__device__ __forceinline__ bool ge(U128 a, U128 b) {
  return a.hi > b.hi || (a.hi == b.hi && a.lo >= b.lo);
}

__device__ __forceinline__ unsigned byte_of(U128 v, int j) {
  return static_cast<unsigned>(j >= 8 ? v.hi >> (8 * (j - 8))
                                      : v.lo >> (8 * j)) & 0xffu;
}

// The metric as an unsigned number of the same order.
__device__ __forceinline__ unsigned long long ordered(long long m) {
  return static_cast<unsigned long long>(m) ^ (1ULL << 63);
}

// V of an entry, shifted left by pad so that its bytes are whole: the
// metric's low hb bits, then the w bits of the inverted key a << wb | b.
struct Layout {
  int hb, wb, w, pad;

  __device__ __forceinline__ U128 v(long long m,
                                    unsigned long long key) const {
    const unsigned long long u = ordered(m);
    const unsigned long long mlow = hb >= 64 ? u : u & ((1ULL << hb) - 1);
    const unsigned long long ck = ((key >> 32) << wb) | (key & 0xffffffffULL);
    const unsigned long long inv = ((1ULL << w) - 1) - ck;
    const U128 a = shl({0, mlow}, w + pad);
    const U128 b = shl({0, inv}, pad);
    return {a.hi | b.hi, a.lo | b.lo};
  }
};

__device__ __forceinline__ bool better(long long m1, unsigned long long k1,
                                       long long m2, unsigned long long k2) {
  return m1 > m2 || (m1 == m2 && k1 < k2);
}

// A slot of a counter shared by the block, one atomic for the lanes that
// take one together.
__device__ __forceinline__ unsigned take_slot(unsigned* counter) {
  cg::coalesced_group g = cg::coalesced_threads();
  unsigned first = 0;
  if (g.thread_rank() == 0) first = atomicAdd(counter, g.size());
  return g.shfl(first, 0) + g.thread_rank();
}

// Calls f(metric, key, index) for every live entry of the block's share of
// table t, read from global memory.
template <typename F>
__device__ __forceinline__ void for_each_live(
    const Shard& t, int rank, const int64_t* __restrict__ sym_freq, F&& f) {
  const ulonglong2* keys2 = reinterpret_cast<const ulonglong2*>(t.keys);
  for (int64_t r0 = rank * kBlockSpan; r0 < t.T; r0 += kRoundSpan) {
    ulonglong2 k[kSlices];
#pragma unroll
    for (int j = 0; j < kSlices; ++j) {
      const int64_t e = r0 + 2 * (j * kThreads + threadIdx.x);
      k[j] = e < t.T ? __ldg(keys2 + (e >> 1))
                     : make_ulonglong2(kEmpty, kEmpty);
    }
#pragma unroll
    for (int j = 0; j < kSlices; ++j) {
      const int64_t e = r0 + 2 * (j * kThreads + threadIdx.x);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned long long key = h ? k[j].y : k[j].x;
        if (key == kEmpty) continue;
        const int64_t c = t.counts[e + h];
        const long long m =
            sym_freq == nullptr
                ? c
                : score_bits(c, sym_freq[key >> 32],
                             sym_freq[key & 0xffffffffULL]);
        f(m, key, static_cast<uint32_t>(e + h));
      }
    }
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, 1)
    nominate_kernel(const Shard* __restrict__ shards, unsigned k,
                    const int64_t* __restrict__ sym_freq,
                    int64_t* __restrict__ cand, int64_t* __restrict__ kth) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Shard t = shards[blockIdx.y];

  for (int i = tid; i < 2 * kBins; i += kThreads) (&sm.hist[0][0])[i] = 0;
  if (tid == 0) {
    sm.mx = 0;
    sm.mn = ~0ULL;
    sm.ora = sm.orb = 0;
    sm.n_stage = sm.n_q = 0;
    sm.d = sm.above = sm.cnt = 0;
  }
  __syncthreads();

  // Read: metrics once, the live entries staged while they fit.
  {
    unsigned long long mx = 0, mn = ~0ULL;
    unsigned ora = 0, orb = 0;
    for_each_live(t, rank, sym_freq,
                  [&](long long m, unsigned long long key, uint32_t e) {
                    const unsigned long long u = ordered(m);
                    mx = u > mx ? u : mx;
                    mn = u < mn ? u : mn;
                    ora |= static_cast<unsigned>(key >> 32);
                    orb |= static_cast<unsigned>(key);
                    const unsigned s = take_slot(&sm.n_stage);
                    if (s < kStage) {
                      sm.metric[s] = m;
                      sm.key[s] = key;
                      sm.idx[s] = e;
                    }
                  });
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const unsigned long long x = __shfl_xor_sync(~0u, mx, o);
      const unsigned long long n = __shfl_xor_sync(~0u, mn, o);
      mx = x > mx ? x : mx;
      mn = n < mn ? n : mn;
      ora |= __shfl_xor_sync(~0u, ora, o);
      orb |= __shfl_xor_sync(~0u, orb, o);
    }
    if (lane == 0) {
      atomicMax(&sm.mx, mx);
      atomicMin(&sm.mn, mn);
      atomicOr(&sm.ora, ora);
      atomicOr(&sm.orb, orb);
    }
  }
  __syncthreads();
  if (tid == 0) sm.live = sm.n_stage;
  cluster.sync();  // every block's read is done and visible
  if (warp == 0) {
    unsigned long long mx = 0, mn = ~0ULL;
    unsigned ora = 0, orb = 0, live = 0;
    if (lane < kCluster) {
      const Smem* r = cluster.map_shared_rank(&sm, lane);
      mx = r->mx;
      mn = r->mn;
      ora = r->ora;
      orb = r->orb;
      live = r->live;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const unsigned long long x = __shfl_xor_sync(~0u, mx, o);
      const unsigned long long n = __shfl_xor_sync(~0u, mn, o);
      mx = x > mx ? x : mx;
      mn = n < mn ? n : mn;
      ora |= __shfl_xor_sync(~0u, ora, o);
      orb |= __shfl_xor_sync(~0u, orb, o);
      live += __shfl_xor_sync(~0u, live, o);
    }
    if (lane == 0) {
      sm.total = live;
      sm.hb = bitlen64(mx ^ mn);
      sm.wb = bitlen64(orb);
      sm.w = sm.wb + bitlen64(ora);
    }
  }
  __syncthreads();
  const unsigned my_live = sm.live;
  const bool all = sm.total <= k;  // every live entry qualifies
  Layout lay;
  lay.hb = static_cast<int>(sm.hb);
  lay.wb = static_cast<int>(sm.wb);
  lay.w = static_cast<int>(sm.w);
  lay.pad = (8 - (lay.hb + lay.w) % 8) % 8;
  const int n_bytes = (lay.hb + lay.w + lay.pad) / 8;

  // Select: the prefix P of V's bytes above byte j, and the entries still
  // needed among those with that prefix.
  bool staged = my_live <= kStage;
  unsigned n_st = staged ? my_live : 0;
  unsigned my_in_play = my_live;
  unsigned need = k;
  U128 P = {0, 0};
  int j = n_bytes - 1;
  int jf = n_bytes;  // V >> 8 jf >= P qualifies
  bool done = all || n_bytes == 0;
  bool restage = false;
  for (int pass = 0; !done; ++pass) {
    unsigned* h = sm.hist[pass & 1];
    const int sh = 8 * (j + 1);
    auto count = [&](long long m, unsigned long long key, uint32_t e) {
      const U128 v = lay.v(m, key);
      const U128 top = shr(v, sh);
      if (eq(top, P)) atomicAdd(&h[byte_of(v, j)], 1u);
      if (restage && ge(top, P)) {
        const unsigned s = take_slot(&sm.n_stage);
        if (s < kStage) {
          sm.metric[s] = m;
          sm.key[s] = key;
          sm.idx[s] = e;
        }
      }
    };
    if (staged) {
      for (unsigned i = tid; i < n_st; i += kThreads)
        count(sm.metric[i], sm.key[i], sm.idx[i]);
    } else {
      for_each_live(t, rank, sym_freq, count);
    }
    __syncthreads();
    cluster.sync();  // every block's histogram of this pass is complete
    if (tid < kBins) {
      unsigned s = 0;
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        s += cluster.map_shared_rank(h, r)[tid];
      sm.tot[tid] = s;
    }
    __syncthreads();
    if (warp == 0) {
      // Lane l holds digits 255 - 8 l down to 248 - 8 l: the digit where
      // the need-th best in play falls, and the entries above it.
      unsigned v[8];
      unsigned sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = sm.tot[kBins - 1 - 8 * lane - i];
        sum += v[i];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned n = __shfl_up_sync(~0u, incl, o);
        if (lane >= o) incl += n;
      }
      unsigned c = incl - sum;
      if (c < need && need <= incl) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (c + v[i] >= need) {
            sm.d = kBins - 1 - 8 * lane - i;
            sm.above = c;
            sm.cnt = v[i];
            break;
          }
          c += v[i];
        }
      }
    }
    // The other histogram, read by every block in the last pass, before
    // this pass's barrier.
    if (tid < kBins) sm.hist[(pass + 1) & 1][tid] = 0;
    __syncthreads();
    const unsigned d = sm.d;
    need -= sm.above;
    P = shl(P, 8);
    P.lo |= d;
    jf = j;
    my_in_play = h[d];
    if (restage) {
      staged = true;
      n_st = min(sm.n_stage, kStage);
    }
    done = sm.cnt == need || j == 0;
    --j;
    // Stage what stays in play (and the at most k - 1 entries already
    // above it) once it fits.
    restage = !staged && my_in_play + k <= kStage;
    if (restage && tid == 0) sm.n_stage = 0;
    __syncthreads();
  }

  // Gather: each block lists its entries at or above the threshold.
  auto take = [&](long long m, unsigned long long key, uint32_t e) {
    if (!all && !ge(shr(lay.v(m, key), 8 * jf), P)) return;
    const unsigned s = take_slot(&sm.n_q);
    if (s < kMaxK) {
      sm.q_metric[s] = m;
      sm.q_key[s] = key;
      sm.q_count[s] = t.counts[e];
    }
  };
  if (staged) {
    for (unsigned i = tid; i < n_st; i += kThreads)
      take(sm.metric[i], sm.key[i], sm.idx[i]);
  } else {
    for_each_live(t, rank, sym_freq, take);
  }
  __syncthreads();
  cluster.sync();  // every block's list is complete
  unsigned n = 0;
  if (rank == 0) {
    // Block 0's own list stays in place; the others' follow it.
    n = min(sm.n_q, static_cast<unsigned>(kMaxK));
    for (int r = 1; r < kCluster; ++r) {
      const Smem* o = cluster.map_shared_rank(&sm, r);
      const unsigned m = min(o->n_q, static_cast<unsigned>(kMaxK));
      for (unsigned i = tid; i < m && n + i < kMaxK; i += kThreads) {
        sm.q_metric[n + i] = o->q_metric[i];
        sm.q_key[n + i] = o->q_key[i];
        sm.q_count[n + i] = o->q_count[i];
      }
      n = min(n + m, static_cast<unsigned>(kMaxK));
    }
  }
  cluster.sync();  // no block leaves while block 0 may read its list
  if (rank != 0) return;
  __syncthreads();
  n = min(n, k);
  int64_t* out = cand + static_cast<int64_t>(blockIdx.y) * k;
  if (tid < static_cast<int>(n)) {
    const long long m = sm.q_metric[tid];
    const unsigned long long key = sm.q_key[tid];
    unsigned r = 0;
    for (unsigned i = 0; i < n; ++i)
      r += better(sm.q_metric[i], sm.q_key[i], m, key);
    const bool nominated = sym_freq == nullptr ? m > 0 : m >= 0;
    out[r] = nominated ? static_cast<int64_t>(key) : -1;
    if (r == k - 1) {
      kth[3 * blockIdx.y] = m;
      kth[3 * blockIdx.y + 1] = sm.q_count[tid];
      kth[3 * blockIdx.y + 2] = static_cast<int64_t>(key);
    }
  }
  for (unsigned i = n + tid; i < k; i += kThreads) out[i] = -1;
  if (n < k && tid == 0) {
    kth[3 * blockIdx.y] = -1;
    kth[3 * blockIdx.y + 1] = 0;
    kth[3 * blockIdx.y + 2] = -1;
  }
}

}  // namespace

extern "C" {

// shards: the descriptor of D tables (K1's: keys 16-byte aligned, T a
// power of two below 2^31); 1 <= k <= 256; sym_freq i64 over the symbol
// ids (WordPiece) or null (BPE) -> cand i64[D * k], kth i64[3 * D].
// Returns the cudaError_t.
int swt_nominate(const void* shards, int D, int64_t k, const void* sym_freq,
                 void* cand, void* kth, void* stream) {
  // Above 48 KB a block needs the attribute, set once on each device.
  static uint64_t ready = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !(ready >> dev & 1)) {
    cudaError_t err = cudaFuncSetAttribute(
        nominate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(Smem)));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready |= 1ULL << dev;
  }
  nominate_kernel<<<dim3(kCluster, D), kThreads, sizeof(Smem),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Shard*>(shards), static_cast<unsigned>(k),
      static_cast<const int64_t*>(sym_freq), static_cast<int64_t*>(cand),
      static_cast<int64_t*>(kth));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
