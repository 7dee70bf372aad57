// The per-shard pieces of data-parallel selection: candidate lookup,
// table compaction, and the check launcher of the sum-threshold
// certificate.
//
// Replaces the per-shard parts of the JAX package's sharded selection,
//   subword_tokenizers_tpu/parallel/train.py: _lookup_runs (binary search
//     of the candidates in the shard's sorted runs), compact_cands as used
//     by sharded_{bpe,wp}_select_compact (ops/pairstats.py:162), and the
//     certificates of sharded_bpe_select_topk and sharded_wp_select_topk,
// which run inside shard_map programs over sorted pair runs. Here each
// shard's pairs live in K1's open-addressing table (pair_stats.cu): keys
// a << 32 | b (all ones when empty), counts, and local positions row * L +
// j; a shard adds its base first_row * L to every position it reports,
// so positions order pairs across shards as one device's would.
//
// The lookup and the compaction take every shard of one device in one
// launch: a descriptor int64[6 * D + 1 + D + C * D + 1] in device memory
// (ops/shard_select.py's TableSet, built once for a set of tables and
// reused every step) gives per shard its table's keys, counts and pos
// pointers, T and base, and a slot for the compaction's overflow flag;
// then the compaction's ticket, a cluster counter a shard, C status
// words a shard for its look-back, and the epoch word (the last
// compaction's epoch).
//
// - lookup_reduce_kernel: one thread per gathered candidate key (blocks
//   of one warp, so the probes spread over many SMs) hashes it once
//   (K1's hash) and starts the first probe into up to 8 shards' tables
//   before it waits on any, then follows each linear probe to the
//   key or an empty entry (a table is at most half full) and reads the
//   hits' counts and positions together. It writes the sum of the counts
//   and the least position + base over the device's shards: (0, POS_MAX)
//   when the key is absent everywhere or empty. A step costs one probe
//   chain, not one a shard in sequence.
// - compact_tables_kernel: grid (8 C) x D, one cluster of 8 blocks of
//   1,024 threads per 131,072 entries of a shard (C = 1 for a shard of
//   train-85k at 8 shards, 8 for the mesh of 1's 2^20 entries), every
//   block over 16,384. Each thread loads its 8 key pairs as 16-byte
//   vectors, neighbouring threads on neighbouring pairs, all in flight at
//   once; ranks come from two warp ballots a pair, a scan of the block's
//   256 warp counts by one warp, and the other blocks' totals read from
//   their shared memory (distributed shared memory) after a cluster
//   barrier. Across the clusters of one shard, a single-pass decoupled
//   look-back: a cluster takes its index in the order clusters start (a
//   counter that wraps to 0 each call), publishes its count, reads its
//   predecessors' words back to the first inclusive one, and publishes
//   its inclusive count; each word carries the call's epoch, so a stale
//   word is never read and no memset runs between calls. The epoch is
//   one past the descriptor's epoch word, read by every block before its
//   cluster publishes and advanced by the call's last cluster, so no
//   call takes it from the host and a CUDA graph of the launch replays
//   with the epoch the device holds (the host restarts the epochs, the
//   status words and the epoch word zeroed, before 2^30 - 1). The live
//   entries of rank < cap are written densely in table order as (key,
//   count, position + base), their counts and positions read only then,
//   into the gathered layout (shard i at [i * cap, (i + 1) * cap)); the
//   shard's last cluster fills ranks n_live .. cap - 1 with (EMPTY, 0,
//   POS_MAX), stores its flag (n_live > cap) and takes a ticket; the last
//   of the D writes the OR of the flags, advances the epoch word and
//   resets the ticket to 0 (calls on one descriptor run in stream order).
// - certificate_kernel, one block: the check launcher of the top-K tier's
//   certificate (certificate.cuh). The training step runs the same device
//   functions inside K2's last block (select_unify.cu), so no training
//   path launches this one; it scans the candidates for the winner's
//   summed count, as K2 carries it in its reduction.
//
// Bound on this card: the lookup reads K * D candidates and a probed
// entry per candidate and shard (2,048 x 8 on train-85k), one dependent
// chain of L2 reads deep, so one launch's latency bounds it; the
// compaction reads each shard's keys (8 bytes an entry; 2^17 entries a
// shard, 8 MB for 8, which the 50 MB L2 holds after K1 wrote them), the
// counts and positions of its live entries of rank < cap (12 bytes) and
// writes 20 bytes an output slot: about 12 MB, 0.0037 ms at 3.35 TB/s,
// for 8 shards after 1,000 merges, against a floor of one cluster launch
// (swt_launch_floor times both floors); the certificate launcher is one
// block of integer work over D shards and K * D candidates.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "certificate.cuh"
#include "lookback.cuh"
#include "table_set.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kEmpty = ~0ULL;
constexpr int32_t kPosMax = 0x7fffffff;

constexpr int kBatch = 8;  // shards a thread probes at once
// One warp a lookup block: the 2,048 candidates of train-85k at 8 shards
// and their 16,384 probes spread over 64 SMs. On an H100, blocks of 256
// threads (8 SMs) were bound by the loads an SM keeps in flight, not by
// the probe chain.
constexpr int kLookupThreads = 32;

constexpr int kCluster = 8;      // blocks of a shard's cluster
constexpr int kCThreads = 1024;  // threads of a compaction block
constexpr int kWarps = kCThreads / 32;
constexpr int kSlices = 8;  // 16-byte key pairs a thread loads
constexpr int64_t kBlockSpan = 2LL * kSlices * kCThreads;
constexpr int64_t kRoundSpan = kCluster * kBlockSpan;

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

__global__ void __launch_bounds__(kLookupThreads)
    lookup_reduce_kernel(const unsigned long long* __restrict__ cand,
                         int64_t M, const Shard* __restrict__ shards, int D,
                         int64_t* __restrict__ out_cnt,
                         int32_t* __restrict__ out_pos) {
  extern __shared__ Shard s_shards[];
  for (int s = threadIdx.x; s < D; s += blockDim.x) s_shards[s] = shards[s];
  __syncthreads();
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= M) return;
  const unsigned long long key = cand[i];
  int64_t c = 0;
  int32_t p = kPosMax;
  if (key != kEmpty) {
    const unsigned long long h0 = mix64(key);
    for (int s0 = 0; s0 < D; s0 += kBatch) {
      unsigned long long k[kBatch], h[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        k[j] = kEmpty;
        h[j] = 0;
        if (s0 + j < D) {
          const Shard& t = s_shards[s0 + j];
          h[j] = h0 & static_cast<unsigned long long>(t.T - 1);
          k[j] = t.keys[h[j]];
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (s0 + j >= D) continue;
        const Shard& t = s_shards[s0 + j];
        const unsigned long long mask =
            static_cast<unsigned long long>(t.T - 1);
        while (k[j] != key && k[j] != kEmpty) {
          h[j] = (h[j] + 1) & mask;
          k[j] = t.keys[h[j]];
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (s0 + j < D && k[j] == key) {
          const Shard& t = s_shards[s0 + j];
          c += t.counts[h[j]];
          const int32_t q = static_cast<int32_t>(t.pos[h[j]] + t.base);
          p = q < p ? q : p;
        }
      }
    }
  }
  out_cnt[i] = c;
  out_pos[i] = p;
}

// A cluster's status word in its shard's look-back (lookback.cuh): the
// cluster's own live count (kAggregate) or the live count of the
// shard's clusters up to and including it (kInclusive).

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kCThreads, 1)
    compact_tables_kernel(Shard* shards, int D, int64_t cap,
                          int64_t* __restrict__ out_keys,
                          int64_t* __restrict__ out_cnt,
                          int32_t* __restrict__ out_pos,
                          int32_t* __restrict__ ovf) {
  __shared__ int s_warp[kSlices * kWarps];  // per slice and warp: live, then
                                            // the exclusive prefix
  __shared__ long long s_total;             // the block's live entries
  __shared__ long long s_before;            // the shard's before the cluster
  __shared__ int s_c;                       // the cluster's index (rank 0's)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  // After the D rows: the ticket, a counter a shard, a status word a
  // cluster (C a shard), then the epoch word.
  const int C = gridDim.x / kCluster;
  unsigned* ticket = reinterpret_cast<unsigned*>(shards + D);
  unsigned* counter =
      reinterpret_cast<unsigned*>(reinterpret_cast<int64_t*>(ticket) + 1) +
      2 * blockIdx.y;
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(ticket) + 1 + D + blockIdx.y * C;
  unsigned long long* epoch_word =
      reinterpret_cast<unsigned long long*>(ticket) + 1 + D + D * C;
  // This call's epoch, one past the last call's. Only thread 0 publishes
  // and looks back; it reads the word before the cluster barrier below,
  // so before its cluster publishes, and the last cluster of the call,
  // which advances the word, runs after every cluster of every shard has
  // published (its shard's by the look-back, the others' by the ticket).
  unsigned epoch = 0;
  if (threadIdx.x == 0)
    epoch = (static_cast<unsigned>(
                 *reinterpret_cast<volatile unsigned long long*>(epoch_word)) +
             1u) &
            kEpochMask;
  // The cluster's index among its shard's, in the order the clusters
  // start (atomicInc wraps at C, so the counter is 0 again after a call).
  if (rank == 0 && threadIdx.x == 0) s_c = atomicInc(counter, C - 1);
  cluster.sync();
  const int c = *cluster.map_shared_rank(&s_c, 0);
  const Shard t = shards[blockIdx.y];
  const int n_c = static_cast<int>((t.T + kRoundSpan - 1) / kRoundSpan);
  if (c >= n_c) {  // past the shard's table
    cluster.sync();  // no block leaves while another may read its s_c
    return;
  }
  const int64_t out0 = blockIdx.y * cap;
  const ulonglong2* keys2 = reinterpret_cast<const ulonglong2*>(t.keys);
  // Slice j of this block: entries b0 + 2 (j * kCThreads + thread), + 1,
  // so slices, warps, lanes and the pair's halves follow table order.
  const int64_t b0 = c * kRoundSpan + rank * kBlockSpan;
  ulonglong2 k[kSlices];
#pragma unroll
  for (int j = 0; j < kSlices; ++j) {
    const int64_t e = b0 + 2 * (j * kCThreads + threadIdx.x);
    k[j] = e < t.T ? __ldg(keys2 + (e >> 1))
                   : make_ulonglong2(kEmpty, kEmpty);
  }
#pragma unroll
  for (int j = 0; j < kSlices; ++j) {
    const unsigned lo = __ballot_sync(~0u, k[j].x != kEmpty);
    const unsigned hi = __ballot_sync(~0u, k[j].y != kEmpty);
    if (lane == 0) s_warp[j * kWarps + warp] = __popc(lo) + __popc(hi);
  }
  __syncthreads();
  if (warp == 0) {
    // The block's kSlices * kWarps counts in table order (slice-major),
    // kPer to a lane.
    constexpr int kPer = kSlices * kWarps / 32;
    int v[kPer];
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      v[q] = s_warp[lane * kPer + q];
      sum += v[q];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int n = __shfl_up_sync(~0u, incl, d);
      if (lane >= d) incl += n;
    }
    int run = incl - sum;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      s_warp[lane * kPer + q] = run;
      run += v[q];
    }
    if (lane == 31) s_total = incl;
  }
  // Every block's prefixes and total are written and visible.
  cluster.sync();
  const long long mine =
      lane < kCluster ? *cluster.map_shared_rank(&s_total, lane) : 0;
  long long before = lane < rank ? mine : 0;
  long long round = mine;
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    before += __shfl_xor_sync(~0u, before, d);
    round += __shfl_xor_sync(~0u, round, d);
  }
  // The shard's live entries before this cluster: the cluster publishes
  // its count, and each of its blocks reads the words before it.
  if (threadIdx.x == 0) {
    if (rank == 0) publish(status + c, c ? kAggregate : kInclusive, epoch,
                           round);
    const long long pre = c ? look_back(status, c, epoch) : 0;
    if (rank == 0 && c) publish(status + c, kInclusive, epoch, pre + round);
    s_before = pre;
  }
  __syncthreads();
  const int64_t first = s_before + before;
#pragma unroll
  for (int j = 0; j < kSlices; ++j) {
    const bool lo_live = k[j].x != kEmpty;
    const bool hi_live = k[j].y != kEmpty;
    const unsigned lo = __ballot_sync(~0u, lo_live);
    const unsigned hi = __ballot_sync(~0u, hi_live);
    const int64_t r = first + s_warp[j * kWarps + warp] + __popc(lo & lt) +
                      __popc(hi & lt);
    const int64_t e = b0 + 2 * (j * kCThreads + threadIdx.x);
    if (lo_live && r < cap) {
      out_keys[out0 + r] = static_cast<int64_t>(k[j].x);
      out_cnt[out0 + r] = t.counts[e];
      out_pos[out0 + r] = static_cast<int32_t>(t.pos[e] + t.base);
    }
    const int64_t r2 = r + lo_live;
    if (hi_live && r2 < cap) {
      out_keys[out0 + r2] = static_cast<int64_t>(k[j].y);
      out_cnt[out0 + r2] = t.counts[e + 1];
      out_pos[out0 + r2] = static_cast<int32_t>(t.pos[e + 1] + t.base);
    }
  }
  if (c == n_c - 1) {  // the shard's last cluster: its total is the shard's
    const int64_t n_live = s_before + round;
    for (int64_t slot = n_live + rank * kCThreads + threadIdx.x; slot < cap;
         slot += static_cast<int64_t>(kCluster) * kCThreads) {
      out_keys[out0 + slot] = -1;
      out_cnt[out0 + slot] = 0;
      out_pos[out0 + slot] = kPosMax;
    }
    if (rank == 0 && threadIdx.x == 0) {
      *reinterpret_cast<volatile int64_t*>(&shards[blockIdx.y].flag) =
          n_live > cap;
      __threadfence();
      if (atomicAdd(ticket, 1u) == static_cast<unsigned>(D - 1)) {
        __threadfence();
        int any = 0;
        for (int s = 0; s < D; ++s)
          any |= static_cast<int>(
              *reinterpret_cast<volatile int64_t*>(&shards[s].flag));
        *ovf = any;
        *reinterpret_cast<volatile unsigned long long*>(epoch_word) = epoch;
        atomicExch(ticket, 0u);
      }
    }
  }
  cluster.sync();  // no block leaves while another may read its s_total
}

// The launch floors: an empty kernel of one block, and an empty kernel at
// the compaction's grid (clusters of 8 blocks of 1,024 threads, D of
// them).
__global__ void empty_kernel() {}

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kCThreads, 1) empty_cluster_kernel() {}

// The check launcher of the certificate (certificate.cuh): the winner's
// summed count from a scan of the candidates, then the same device
// functions K2 runs in its last block. No training path launches it.
__global__ void __launch_bounds__(kThreads)
    certificate_kernel(const int64_t* __restrict__ kth, int D,
                       const unsigned long long* __restrict__ cand,
                       const int64_t* __restrict__ g_cnt, int64_t M,
                       int32_t* rec, const int64_t* __restrict__ sym_freq,
                       int wordpiece, int wide_score) {
  __shared__ unsigned long long s_best;
  __shared__ CertSum s_sum;
  const bool active = rec[4] != 0;
  const unsigned long long best_key =
      active ? (static_cast<unsigned long long>(static_cast<uint32_t>(rec[0]))
                << 32) |
                   static_cast<uint32_t>(rec[1])
             : 0;
  if (threadIdx.x == 0) s_best = 0;
  __syncthreads();
  if (threadIdx.x < 32) {  // the shards' terms, beside the scan's loads
    const CertSum s = cert_terms(kth, D, sym_freq, wordpiece, wide_score);
    if (threadIdx.x == 0) s_sum = s;
  }
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
  if (threadIdx.x == 0)
    rec[5] = cert_proven(s_sum, static_cast<int64_t>(s_best) - 1, best_key,
                         sym_freq, wordpiece, wide_score);
}

}  // namespace

extern "C" {

// cand i64[M] (EMPTY for none); shards: the descriptor of D tables (K1's,
// T a power of two) -> out_cnt i64[M] (the sum over the shards), out_pos
// i32[M] (the least position + base). Returns the cudaError_t.
int swt_lookup_reduce(const void* cand, int64_t M, const void* shards, int D,
                      void* out_cnt, void* out_pos, void* stream) {
  if (M <= 0) return 0;
  const int64_t blocks = (M + kLookupThreads - 1) / kLookupThreads;
  lookup_reduce_kernel<<<static_cast<unsigned>(blocks), kLookupThreads,
                         D * sizeof(Shard),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(cand), M,
      static_cast<const Shard*>(shards), D, static_cast<int64_t*>(out_cnt),
      static_cast<int32_t*>(out_pos));
  return static_cast<int>(cudaGetLastError());
}

// shards: the descriptor of D tables (keys 16-byte aligned, T < 2^31),
// clusters a shard C = ceil(max T / 131,072), its epoch word below
// 2^30 - 1 (advanced); cap >= 1 -> out_keys/out_cnt i64[D * cap],
// out_pos i32[D * cap], ovf i32[1] (the OR of the shards' flags).
// Returns the cudaError_t.
int swt_compact_tables(void* shards, int D, int C, int64_t cap,
                       void* out_keys, void* out_cnt, void* out_pos,
                       void* ovf, void* stream) {
  compact_tables_kernel<<<dim3(kCluster * C, D), kCThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<Shard*>(shards), D, cap,
      static_cast<int64_t*>(out_keys), static_cast<int64_t*>(out_cnt),
      static_cast<int32_t*>(out_pos), static_cast<int32_t*>(ovf));
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel: clusters = 0, one block of 32 threads; else the
// compaction's grid for that many shards. Returns the cudaError_t.
int swt_launch_floor(int clusters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clusters <= 0)
    empty_kernel<<<1, 32, 0, s>>>();
  else
    empty_cluster_kernel<<<dim3(kCluster, clusters), kCThreads, 0, s>>>();
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
