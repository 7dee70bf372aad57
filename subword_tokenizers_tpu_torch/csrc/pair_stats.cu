// K1: weighted pair counts and first positions of the flat BPE state.
//
// Replaces the pair aggregation of the JAX package's jitted XLA programs
//   subword_tokenizers_tpu/ops/flat.py: flat_pairs, flat_aggregate, and
//   subword_tokenizers_tpu/ops/pairstats.py: pack_pairs, _run_aggregate
//   (inside bpe_select and flat_train_steps),
// which sort (key, position, weight) over all F-1 slots and aggregate
// runs with a cumsum. Here there is no sort: one thread per slot i
// inserts the pair (fs[i], fs[i+1]) -- valid when both are >= 0 and
// wid[i] == wid[i+1] -- into an open-addressing table in device memory:
//   keys   u64[T]  a << 32 | b, all ones when empty,
//   counts u64[T]  sum of wgt[i] (atomicAdd),
//   pos    u32[T]  least i (atomicMin).
// T is a power of two >= 2(F-1), so the table is at most half full and a
// linear probe always ends. Integer atomics give the same table in any
// order, so the result is exact and deterministic; only where a pair
// lands depends on the race for its first free entry, and the caller's
// selection (select_unify.cu) is order-free.
//
// No memset: a call is one kernel launch, and the table it fills must
// arrive empty. The caller keeps two tables (ops/pairstats.PairTable) and
// alternates between them; the launch that fills one empties the other.
// It empties only the entries that table's last fill claimed: every
// thread that wins an empty entry by compare-and-swap appends the entry's
// index to the table's claim list, whose length is one of two counters
// beside it. A fill appends to counter (fills % 2) and zeroes the other,
// which the empty that followed the fill before read; an empty reads the
// counter of the table's last fill. So emptying costs the distinct pairs
// (tens of thousands), not T (2^19 at train-85k), and stream order is the
// only synchronisation: the readers of the table being emptied (K2 of the
// step before) were queued before the launch. Claims hold indices into
// the whole buffer, so a table the caller has since viewed smaller (the
// flat state shrinks between blocks) is still emptied in full.
//
// Contention: lanes of a warp holding the same pair with the same weight
// (a frequent pair in neighbouring words of one weight, or a run in one
// word) are combined by two __match_any_sync before the table: the lowest
// lane, which holds the least position, inserts the group's summed weight
// once.
//
// Skip mode (skip = S > 0), which replaces the deferred-compaction pair
// count of
//   subword_tokenizers_tpu/ops/flat.py: skip_next, flat_skip_aggregate
//   (flat_train_steps with skip > 0):
// merges leave dead slots (-1) in place, so slot i pairs with its nearest
// LIVE successor j within S + 1 slots, when one exists and wid[j] ==
// wid[i]; the pair's position is the raw slot index i. JAX uses the
// compacted index there, but deletion never reorders live slots, so the
// two order the pairs alike and the least one is the same pair. The same
// kernel reads S + 1 slots ahead instead of one; the adjacent mode is
// S = 0.
//
// The padded layout's pair count (ops/pairstats.py pack_pairs and
// _run_aggregate inside train_steps) is this kernel over the [n, L]
// tensor viewed as n * L slots with wid = row index and wgt = the row's
// weight: position row * L + j orders pairs as JAX's row * (L - 1) + j.
//
// Runs mode (swt_pair_stats_runs), which replaces the re-aggregation of the
// gathered compacted runs in the JAX package's compact tier,
//   subword_tokenizers_tpu/parallel/train.py: _run_aggregate(gk, gp, gc)
//   inside sharded_bpe_select_compact and sharded_wp_select_compact:
// each thread takes one (key, count, position) triple of every shard's
// runs (shard_select.cu compacts them) and inserts it into the same table,
// adding its count and taking the least position; EMPTY keys are skipped.
// It fills and empties tables as the adjacent mode does.
//
// Grouped rows mode (swt_pair_rows), which replaces, under the mesh, the
// JAX package's per-shard pair count
//   subword_tokenizers_tpu/parallel/train.py:78 _local_pairs, then
//   subword_tokenizers_tpu/ops/pairstats.py:92 _run_aggregate
//   (inside every step of the sharded selection):
// one launch takes the padded rows [R, L] of one device's D consecutive
// shards, shard s holding rows [s * rows, (s + 1) * rows). A thread per
// slot inserts its pair into its shard's own table (a TableSet's
// descriptor, ops/shard_select.py: 6 int64 a table, keys, counts, pos and
// T first) with the same hash and probe, at the local position (row -
// s * rows) * L + j, and the row's weight: the padded layout's word is the
// row, so there are no per-slot word ids or weights to read. The same
// launch empties a second set of tables, the other half of a double
// buffer (parallel/train.py ShardBlock): its first blocks store EMPTY / 0
// / all ones over every entry as 16-byte vectors, neighbouring threads on
// neighbouring addresses. A step then issues one stream operation a
// device, not a launch a shard; the readers of the tables it empties ran
// before it, in stream order.
//
// A thread reads an entry before it tries a compare-and-swap, so threads
// of an existing pair add without one, and reads the first position
// before it takes the atomic minimum, which it skips when that is
// already smaller (positions only fall, so a stale read never skips
// wrongly).
//
// Bound on this card: at F = 187,885 (train-85k) it is a few MB of
// table traffic and some hundred thousand atomics; frequent pairs make
// many threads add to one entry, which L2 serialises; the warp's
// combining takes up to 32 of those adds into one. The grouped rows
// mode on one device's 8 shards of train-85k (2,872 x 22 rows each, T =
// 131,072) reads 2 MB of rows and 0.2 MB of weights and writes 21 MB to
// empty the other set of tables, which bounds it by bytes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kClearSpan = 2048;  // entries of a table one block empties
constexpr unsigned long long kEmpty = ~0ULL;

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  // splitmix64's finaliser: spreads neighbouring ids over the table.
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

// A K1 table with its claim list (ops/pairstats.PairTable): ``n`` the
// counter the claims are counted in (filling) or were (emptying).
struct Table {
  unsigned long long* keys;
  unsigned long long* counts;
  unsigned int* pos;
  unsigned int* claims;
  unsigned int* n;
};

// Add (weight w, position p) to key's entry of the table, claiming an
// empty entry on the key's linear probe if it has none; a claim is
// appended to ``claims`` when it is given.
__device__ __forceinline__ void insert(unsigned long long key,
                                       unsigned long long w, unsigned int p,
                                       unsigned long long* keys,
                                       unsigned long long* counts,
                                       unsigned int* pos,
                                       unsigned long long mask,
                                       unsigned int* claims = nullptr,
                                       unsigned int* n_claims = nullptr) {
  unsigned long long h = mix64(key) & mask;
  while (true) {
    unsigned long long cur =
        *reinterpret_cast<volatile unsigned long long*>(&keys[h]);
    if (cur == kEmpty) {
      cur = atomicCAS(&keys[h], kEmpty, key);
      if (cur == kEmpty) {
        cur = key;
        if (claims != nullptr)
          claims[atomicAdd(n_claims, 1u)] = static_cast<unsigned int>(h);
      }
    }
    if (cur == key) break;
    h = (h + 1) & mask;
  }
  atomicAdd(&counts[h], w);
  if (*reinterpret_cast<volatile unsigned int*>(&pos[h]) > p)
    atomicMin(&pos[h], p);
}

// Empty the entries of ``c`` its last fill claimed (none when c.keys is
// null), the whole grid striding over its claim list; and zero the
// counter ``next`` that the next fill of the table being filled counts in.
__device__ __forceinline__ void empty_claimed(const Table& c,
                                              unsigned int* next) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t == 0) *next = 0;
  if (c.keys == nullptr) return;
  const uint32_t n = *c.n;
  for (uint32_t e = t; e < n; e += gridDim.x * blockDim.x) {
    const uint32_t h = c.claims[e];
    c.keys[h] = kEmpty;
    c.counts[h] = 0;
    c.pos[h] = ~0u;
  }
}

__global__ void pair_insert_kernel(const int32_t* __restrict__ fs,
                                   const int32_t* __restrict__ wid,
                                   const int64_t* __restrict__ wgt, int64_t F,
                                   Table fill, unsigned int* next,
                                   unsigned long long mask, int skip,
                                   Table clear) {
  empty_claimed(clear, next);
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  bool valid = false;
  unsigned long long key = 0, w = 0;
  if (i + 1 < F) {
    const int32_t a = fs[i];
    if (a >= 0) {
      int64_t j = i + 1;
      const int64_t last = i + 1 + skip < F - 1 ? i + 1 + skip : F - 1;
      while (j < last && fs[j] < 0) ++j;
      const int32_t b = fs[j];
      if (b >= 0 && wid[i] == wid[j]) {
        valid = true;
        key = (static_cast<unsigned long long>(static_cast<uint32_t>(a))
               << 32) |
              static_cast<uint32_t>(b);
        w = static_cast<unsigned long long>(wgt[i]);
      }
    }
  }
  // Every lane of the warp reaches the ballot (blockDim is a multiple of
  // 32); the group's lowest lane holds its least position.
  const unsigned act = __ballot_sync(0xffffffffu, valid);
  if (!valid) return;
  const unsigned peers =
      __match_any_sync(act, key) & __match_any_sync(act, w);
  if ((threadIdx.x & 31) != static_cast<unsigned>(__ffs(peers) - 1)) return;
  insert(key, w * static_cast<unsigned>(__popc(peers)),
         static_cast<unsigned int>(i), fill.keys, fill.counts, fill.pos,
         mask, fill.claims, fill.n);
}

__global__ void runs_insert_kernel(const unsigned long long* __restrict__ rk,
                                   const int64_t* __restrict__ rc,
                                   const uint32_t* __restrict__ rp, int64_t M,
                                   Table fill, unsigned int* next,
                                   unsigned long long mask, Table clear) {
  empty_claimed(clear, next);
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= M) return;
  const unsigned long long key = rk[i];
  if (key == kEmpty) return;
  insert(key, static_cast<unsigned long long>(rc[i]), rp[i], fill.keys,
         fill.counts, fill.pos, mask, fill.claims, fill.n);
}

// Blocks [0, clear_blocks) empty the tables of `clear` (kClearSpan entries
// of one table a block); the rest insert the pairs of the rows, one thread
// a slot, each into its shard's table of `fill`.
__global__ void pair_rows_kernel(const int32_t* __restrict__ sym,
                                 const int64_t* __restrict__ wgt,
                                 uint32_t slots, uint32_t L, uint32_t rows,
                                 const int64_t* __restrict__ fill,
                                 const int64_t* __restrict__ clear,
                                 uint32_t clear_blocks,
                                 uint32_t blocks_per_table) {
  if (blockIdx.x < clear_blocks) {
    const uint32_t t = blockIdx.x / blocks_per_table;
    const int64_t lo =
        static_cast<int64_t>(blockIdx.x - t * blocks_per_table) * kClearSpan;
    const int64_t* d = clear + 6 * t;
    auto* keys = reinterpret_cast<unsigned long long*>(d[0]);
    auto* counts = reinterpret_cast<unsigned long long*>(d[1]);
    auto* pos = reinterpret_cast<unsigned int*>(d[2]);
    const int64_t T = d[3];
    if (lo + kClearSpan <= T) {
      auto* k2 = reinterpret_cast<ulonglong2*>(keys + lo);
      auto* c2 = reinterpret_cast<ulonglong2*>(counts + lo);
      auto* p4 = reinterpret_cast<uint4*>(pos + lo);
      for (int v = threadIdx.x; v < kClearSpan / 2; v += blockDim.x) {
        k2[v] = make_ulonglong2(kEmpty, kEmpty);
        c2[v] = make_ulonglong2(0, 0);
      }
      for (int v = threadIdx.x; v < kClearSpan / 4; v += blockDim.x)
        p4[v] = make_uint4(~0u, ~0u, ~0u, ~0u);
    } else {  // a table smaller than a span (T is a power of two)
      for (int64_t e = lo + threadIdx.x; e < T; e += blockDim.x) {
        keys[e] = kEmpty;
        counts[e] = 0;
        pos[e] = ~0u;
      }
    }
    return;
  }
  const uint32_t i = (blockIdx.x - clear_blocks) * blockDim.x + threadIdx.x;
  if (i >= slots) return;
  const uint32_t r = i / L;
  const uint32_t j = i - r * L;
  if (j + 1 >= L) return;
  const int32_t a = sym[i];
  if (a < 0) return;
  const int32_t b = sym[i + 1];
  if (b < 0) return;
  const uint32_t s = r / rows;
  const int64_t* d = fill + 6 * s;
  const unsigned long long key =
      (static_cast<unsigned long long>(static_cast<uint32_t>(a)) << 32) |
      static_cast<uint32_t>(b);
  insert(key, static_cast<unsigned long long>(wgt[r]), (r - s * rows) * L + j,
         reinterpret_cast<unsigned long long*>(d[0]),
         reinterpret_cast<unsigned long long*>(d[1]),
         reinterpret_cast<unsigned int*>(d[2]),
         static_cast<unsigned long long>(d[3] - 1));
}

// The tables of a call: keys/counts i64[T], pos/claims i32[T / 2 or
// more], n a pointer into the table's two counters.
Table table_of(void* keys, void* counts, void* pos, void* claims, void* n) {
  return Table{static_cast<unsigned long long*>(keys),
               static_cast<unsigned long long*>(counts),
               static_cast<unsigned int*>(pos),
               static_cast<unsigned int*>(claims),
               static_cast<unsigned int*>(n)};
}

}  // namespace

extern "C" {

// fs i32[F], wid i32[F], wgt i64[F] -> the table (keys, counts, pos,
// claims, n_fill: the counter its claims are counted in), empty on entry,
// of T entries: T a power of two >= 2(F-1); n_next: the table's other
// counter, zeroed. The same launch empties the entries that the claims
// (ckeys, ccounts, cpos, cclaims, n_clear: the counter of its last fill)
// of another table list; ckeys NULL for none. 2 <= F < 2^31; skip >= 0
// (0: adjacent slots). Returns the cudaError_t.
int swt_pair_stats(const void* fs, const void* wid, const void* wgt,
                   int64_t F, void* keys, void* counts, void* pos, int64_t T,
                   void* claims, void* n_fill, void* n_next, void* ckeys,
                   void* ccounts, void* cpos, void* cclaims, void* n_clear,
                   int skip, void* stream) {
  const int64_t blocks = (F - 1 + kThreads - 1) / kThreads;
  pair_insert_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fs), static_cast<const int32_t*>(wid),
      static_cast<const int64_t*>(wgt), F,
      table_of(keys, counts, pos, claims, n_fill),
      static_cast<unsigned int*>(n_next),
      static_cast<unsigned long long>(T - 1), skip,
      table_of(ckeys, ccounts, cpos, cclaims, n_clear));
  return static_cast<int>(cudaGetLastError());
}

// rk/rc i64[M], rp i32[M] (runs, EMPTY keys skipped; M >= 0) -> the table
// as for swt_pair_stats, T a power of two >= 2M, emptying the other's
// claims in the same launch. Returns the cudaError_t.
int swt_pair_stats_runs(const void* rk, const void* rc, const void* rp,
                        int64_t M, void* keys, void* counts, void* pos,
                        int64_t T, void* claims, void* n_fill, void* n_next,
                        void* ckeys, void* ccounts, void* cpos,
                        void* cclaims, void* n_clear, void* stream) {
  const int64_t blocks = M > 0 ? (M + kThreads - 1) / kThreads : 1;
  runs_insert_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(rk),
      static_cast<const int64_t*>(rc), static_cast<const uint32_t*>(rp), M,
      table_of(keys, counts, pos, claims, n_fill),
      static_cast<unsigned int*>(n_next),
      static_cast<unsigned long long>(T - 1),
      table_of(ckeys, ccounts, cpos, cclaims, n_clear));
  return static_cast<int>(cudaGetLastError());
}

// sym i32[R, L], R = D * rows, rows * L and R * L < 2^31; wgt i64[R];
// fill: the descriptor (6 int64 a table: keys, counts, pos, T, ...) of the
// D shards' tables, each empty on entry, T a power of two >= 2(rows * L -
// 1); clear: the descriptor of Dc other tables to empty (NULL when Dc is
// 0), each T a power of two <= T_max, its arrays 16-byte aligned. Returns
// the cudaError_t.
int swt_pair_rows(const void* sym, const void* wgt, int64_t R, int64_t L,
                  int64_t rows, const void* fill, const void* clear,
                  int64_t Dc, int64_t T_max, void* stream) {
  const int64_t slots = R * L;
  const int64_t per_table = clear != nullptr && Dc > 0
                                ? (T_max + kClearSpan - 1) / kClearSpan
                                : 0;
  const int64_t clear_blocks = per_table * (clear != nullptr ? Dc : 0);
  const int64_t blocks = clear_blocks + (slots + kThreads - 1) / kThreads;
  pair_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sym), static_cast<const int64_t*>(wgt),
      static_cast<uint32_t>(slots), static_cast<uint32_t>(L),
      static_cast<uint32_t>(rows), static_cast<const int64_t*>(fill),
      static_cast<const int64_t*>(clear), static_cast<uint32_t>(clear_blocks),
      static_cast<uint32_t>(per_table > 0 ? per_table : 1));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
