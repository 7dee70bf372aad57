// Batched BPE encoding: the per-word merge loop, a warp per word.
//
// Replaces the JAX package's jitted XLA program
//   subword_tokenizers_tpu/ops/bpe_encode.py: bpe_encode (with _pack,
//     _lookup and _apply_rows), and the merge half of bpe_encode_stacked.
// The XLA program steps every word in lockstep inside a while_loop: each
// trip packs every adjacent pair of the whole [W, L] tensor, probes the
// rank hash for all of them, and compacts every row with a stable sort,
// until no row found a pair. Here each warp runs its own word's trips and
// stops when its word has no pair left, so a short word costs only its
// own trips.
//
// A trip probes the rank of each adjacent pair of the row's symbols (the
// ids before its first PAD), keeps the first pair of lowest rank (in
// monotone mode only ranks >= the cursor), merges every occurrence left
// to right without overlap and compacts the row; monotone mode then sets
// the cursor to rank + 1. In a run "a a a a" of a self-pair only the
// pairs at even offsets of the run merge (the JAX parity rule). Each
// merge removes a symbol, so a word takes at most L trips. Each row runs
// its trips to the end on its own. That equals the lockstep loop where a
// row's PADs all sit at its right end: a row that finds no pair is left
// as it is, so the trips of the other rows do not change it.
//
// The work of a trip is spread over the warp's lanes:
// - lane l holds columns l, l + 32, ... of the row: in registers for
//   rows of up to 128 columns (kPer = ceil(L / 32) a lane, a template
//   parameter), else in shared memory (a row a warp, the block's warps
//   sized to fit) or, for rows wider than shared memory holds, in the
//   output row itself (L1 and L2 serve it); the wide path reads the row
//   32 columns at a time, so any L works;
// - every lane probes its own pairs at once (the pair's right member by
//   a shuffle), the rank and merged id loaded beside the key, so a pair
//   found in its first slot costs one round trip; the hash (H slots;
//   512 KB of keys, ranks and ids for the 7,922 merges of the 8,000
//   vocab) is read with __ldg from L2: slot ((key * HASH_GOLD) >> 29) &
//   (H - 1) in signed 64-bit arithmetic, then linear probing up to
//   max_probe slots, stopping at an empty slot (no deletions, so a key
//   lies before the first empty slot of its probe run);
// - two warp reductions (__reduce_min_sync) give the lowest rank, then
//   the least position holding it, and a shuffle its pair and merged id;
// - ballots find the matches, decide a == b's parity by the offsets of
//   the run starts (as K3p, merge_rows.cu, decides it) and the dead
//   right members; each kept symbol's place is a population count of
//   the kept lanes below it plus the earlier chunks' count, and the
//   register path compacts through a row of shared memory a warp;
// - the row is written to the output once, and out_n once.
// The layout check is part of the load: a row holding an id below -1 or
// a PAD before an id sets the caller's flag word to the call's epoch (no
// memset: a stale word holds an earlier epoch), and is copied out as it
// is with out_n -1; the wrapper reads the word back once.
//
// What bounds it on the card: the bytes are small (train-85k's 22,971
// words x 24 columns of i32 in and out, about 4.4 MB, 1.3 us at 3.35
// TB/s), and the longest word's dependent chain (20 trips of a probe and
// the warp's reductions) is shorter still. On an H100 the time follows
// the warps' trips in all (158,502 for train-85k's word types, 6.9 a
// word, as chip_smoke.py phase 9 counts them): a word averages 8.2
// symbols, so most of a warp's lanes idle on each trip. Neither a rank
// kept across trips nor words taken in turn from a counter made it
// faster; several short words a warp is the design to try next.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps (words) a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxPer = 4;  // the register path: rows of up to 128 columns
constexpr int kSharedMax = 48 * 1024;  // the wide path's rows, at most
constexpr int kSymBits = 21;
constexpr int32_t kInf = 0x7FFFFFFF;
constexpr uint64_t kHashGold = 0x9E3779B97F4A7C15ull;  // -7046029254386353131
constexpr int kHashShift = 29;
constexpr unsigned kAll = 0xffffffffu;

struct Hash {
  const int64_t* __restrict__ keys;
  const int32_t* __restrict__ rank;
  const int32_t* __restrict__ out;
  int64_t H;
  int max_probe;
};

// The rank (kInf when absent) and merged id of the pair (x, y): the first
// slot's key, rank and id loaded together, then the probe run.
__device__ __forceinline__ int32_t probe(const Hash& h, int32_t x, int32_t y,
                                         int32_t* merged_id) {
  const int64_t key = (static_cast<int64_t>(x) << kSymBits) | y;
  // Signed wrapping multiply (done unsigned), then an arithmetic shift.
  const int64_t prod =
      static_cast<int64_t>(static_cast<uint64_t>(key) * kHashGold);
  int64_t idx = (prod >> kHashShift) & (h.H - 1);
  for (int p = 0; p < h.max_probe; ++p) {
    const int64_t k = __ldg(h.keys + idx);
    const int32_t r = __ldg(h.rank + idx);
    const int32_t o = __ldg(h.out + idx);
    if (k == key) {
      *merged_id = o;
      return r;
    }
    if (k == -1) break;
    idx = (idx + 1) & (h.H - 1);
  }
  return kInf;
}

// The layout check of one chunk of 32 columns: ``bad`` gets a value below
// -1 or an id after a PAD (``pad_seen``: an earlier chunk held one);
// returns the chunk's ids.
__device__ __forceinline__ int check_chunk(int32_t s, bool in_row,
                                           bool& pad_seen, bool& bad) {
  const unsigned ids = __ballot_sync(kAll, in_row && s >= 0);
  const unsigned pads = __ballot_sync(kAll, in_row && s < 0);
  const bool low = __any_sync(kAll, in_row && s < -1) != 0;
  bad = bad || low || (ids && pad_seen) ||
        (pads && (ids >> (__ffs(pads) - 1)) != 0);
  pad_seen = pad_seen || pads;
  return __popc(ids);
}

// The warp's pick among its lanes' best pairs: the lowest rank, then the
// least position; (a, b, merged id) from the lane that holds it. Returns
// the rank (kInf: no pair left).
__device__ __forceinline__ int32_t pick(int32_t rank, int pos, int32_t x,
                                        int32_t y, int32_t o, int32_t* a,
                                        int32_t* b, int32_t* merged_id) {
  const unsigned r_min =
      __reduce_min_sync(kAll, static_cast<unsigned>(rank));
  if (r_min == static_cast<unsigned>(kInf)) return kInf;
  const unsigned j_min = __reduce_min_sync(
      kAll, rank == static_cast<int32_t>(r_min) ? static_cast<unsigned>(pos)
                                                : ~0u);
  const int src = static_cast<int>(j_min & 31);
  *a = __shfl_sync(kAll, x, src);
  *b = __shfl_sync(kAll, y, src);
  *merged_id = __shfl_sync(kAll, o, src);
  return static_cast<int32_t>(r_min);
}

// The merge of one chunk (columns c0 + lane, symbol s, its right
// neighbour nxt, n live columns): returns the symbol kept at this lane
// (valid where *keep), with its place in the merged row in *to; the
// carries link the chunks of a row.
struct Carry {
  int kept = 0;        // symbols kept in earlier chunks
  bool match = false;  // the last chunk's last column matched,
  bool is_a = false;   // held a,
  int par = 0;         // at this parity of its offset in the run
};

__device__ __forceinline__ int32_t merge_chunk(int32_t s, int32_t nxt, int j,
                                               int n, int32_t a, int32_t b,
                                               int32_t merged_id, Carry& c,
                                               bool* keep, int* to) {
  const int lane = threadIdx.x & 31;
  const bool is_a = j < n && s == a;
  bool match = is_a && j + 1 < n && nxt == b;
  if (a == b) {
    const unsigned m_a = __ballot_sync(kAll, is_a);
    const bool prev_a = lane ? (m_a >> (lane - 1)) & 1u : c.is_a;
    const unsigned starts = __ballot_sync(kAll, is_a && !prev_a);
    const unsigned upto = starts & (kAll >> (31 - lane));
    const int par = upto ? (lane - (31 - __clz(upto))) & 1
                         : (c.par + lane + 1) & 1;
    match = match && par == 0;
    c.is_a = m_a >> 31;
    c.par = __shfl_sync(kAll, par, 31);
  }
  const unsigned m_match = __ballot_sync(kAll, match);
  const bool dead = lane ? (m_match >> (lane - 1)) & 1u : c.match;
  c.match = m_match >> 31;
  *keep = j < n && !dead;
  const unsigned m_keep = __ballot_sync(kAll, *keep);
  *to = c.kept + __popc(m_keep & ((1u << lane) - 1));
  c.kept += __popc(m_keep);
  return match ? merged_id : s;
}

// Rows of up to 32 * kPer columns, in registers, a warp a row.
template <int kPer>
__global__ void __launch_bounds__(kThreads)
    encode_regs_kernel(const int32_t* __restrict__ sym, int64_t W, int L,
                       Hash h, int monotone, int32_t* __restrict__ merged,
                       int32_t* __restrict__ out_n, int32_t* bad_word,
                       int32_t epoch) {
  __shared__ int32_t s_row[kWarps][32 * kPer];  // the merged row, a warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = blockIdx.x * static_cast<int64_t>(kWarps) + warp;
  if (r >= W) return;  // the whole warp
  const int32_t* src = sym + r * L;
  int32_t* dst = merged + r * L;
  int32_t v[kPer];
  int n = 0;
  bool pad_seen = false, bad = false;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int j = c * 32 + lane;
    v[c] = j < L ? src[j] : -1;
    n += check_chunk(v[c], j < L, pad_seen, bad);
  }
  if (bad) {
#pragma unroll
    for (int c = 0; c < kPer; ++c)
      if (c * 32 + lane < L) dst[c * 32 + lane] = v[c];
    if (lane == 0) {
      out_n[r] = -1;
      *bad_word = epoch;
    }
    return;
  }
  int32_t* row = s_row[warp];
  int32_t cursor = 0;
  for (;;) {
    // Each lane's first pair of lowest rank among its columns, every
    // probe of the trip in flight at once.
    int32_t y[kPer], rk[kPer], o[kPer];
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      y[c] = __shfl_down_sync(kAll, v[c], 1);
      int32_t head = -1;  // the next chunk's first column
      if (c + 1 < kPer)
        head = __shfl_sync(kAll, v[c + 1 < kPer ? c + 1 : c], 0);
      if (lane == 31) y[c] = head;
      rk[c] = kInf;
      o[c] = 0;
      if (c * 32 + lane + 1 < n) rk[c] = probe(h, v[c], y[c], &o[c]);
      if (monotone && rk[c] < cursor) rk[c] = kInf;
    }
    int32_t best = kInf, bx = 0, by = 0, bo = 0;
    int bj = 0;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      if (rk[c] < best) {
        best = rk[c];
        bj = c * 32 + lane;
        bx = v[c];
        by = y[c];
        bo = o[c];
      }
    }
    int32_t a, b, merged_id;
    const int32_t rank = pick(best, bj, bx, by, bo, &a, &b, &merged_id);
    if (rank == kInf) break;
    Carry carry;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      bool keep;
      int to;
      const int32_t s = merge_chunk(v[c], y[c], c * 32 + lane, n, a, b,
                                    merged_id, carry, &keep, &to);
      if (keep) row[to] = s;
    }
    __syncwarp();
    n = carry.kept;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int j = c * 32 + lane;
      v[c] = j < n ? row[j] : -1;
    }
    __syncwarp();
    if (monotone) cursor = rank + 1;
  }
#pragma unroll
  for (int c = 0; c < kPer; ++c)
    if (c * 32 + lane < L) dst[c * 32 + lane] = v[c];
  if (lane == 0) out_n[r] = n;
}

// Rows of any width: a row a warp in dynamic shared memory (in_shared),
// else worked on in place in the output row.
__global__ void __launch_bounds__(kThreads)
    encode_wide_kernel(const int32_t* __restrict__ sym, int64_t W, int L,
                       Hash h, int monotone, int32_t* __restrict__ merged,
                       int32_t* __restrict__ out_n, int32_t* bad_word,
                       int32_t epoch, int in_shared) {
  extern __shared__ int32_t s_rows[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r =
      blockIdx.x * static_cast<int64_t>(blockDim.x >> 5) + warp;
  if (r >= W) return;  // the whole warp
  const int32_t* src = sym + r * L;
  int32_t* dst = merged + r * L;
  int32_t* row = in_shared ? s_rows + static_cast<int64_t>(warp) * L : dst;
  int n = 0;
  bool pad_seen = false, bad = false;
  for (int c0 = 0; c0 < L; c0 += 32) {
    const int j = c0 + lane;
    const int32_t s = j < L ? src[j] : -1;
    if (j < L) row[j] = s;
    n += check_chunk(s, j < L, pad_seen, bad);
  }
  __syncwarp();
  int32_t cursor = 0;
  while (!bad) {
    int32_t best = kInf, bx = 0, by = 0, bo = 0;
    int bj = 0;
    for (int c0 = 0; c0 + 1 < n; c0 += 32) {
      const int j = c0 + lane;
      if (j + 1 < n) {
        const int32_t x = row[j], y = row[j + 1];
        int32_t o = 0;
        int32_t rk = probe(h, x, y, &o);
        if (monotone && rk < cursor) rk = kInf;
        if (rk < best) {
          best = rk;
          bj = j;
          bx = x;
          by = y;
          bo = o;
        }
      }
    }
    int32_t a, b, merged_id;
    const int32_t rank = pick(best, bj, bx, by, bo, &a, &b, &merged_id);
    if (rank == kInf) break;
    // In place: a kept symbol moves left only, and the next chunk is read
    // before this one is written.
    Carry carry;
    int32_t ahead = lane < n ? row[lane] : -1;
    for (int c0 = 0; c0 < n; c0 += 32) {
      const int j = c0 + lane;
      const int32_t s = ahead;
      ahead = j + 32 < n ? row[j + 32] : -1;
      int32_t nxt = __shfl_down_sync(kAll, s, 1);
      const int32_t head = __shfl_sync(kAll, ahead, 0);
      if (lane == 31) nxt = head;
      bool keep;
      int to;
      const int32_t out = merge_chunk(s, nxt, j, n, a, b, merged_id, carry,
                                      &keep, &to);
      if (keep) row[to] = out;
    }
    __syncwarp();
    n = carry.kept;
    if (monotone) cursor = rank + 1;
  }
  for (int j = lane; j < L; j += 32) dst[j] = j < n || bad ? row[j] : -1;
  if (lane == 0) {
    out_n[r] = bad ? -1 : n;
    if (bad) *bad_word = epoch;
  }
}

}  // namespace

extern "C" {

// sym i32[W, L] (PAD -1, only at the right end of a row), hkeys i64[H],
// hrank/hout i32[H] (H a power of two) -> merged i32[W, L], out_n i32[W];
// a row of another layout (an id below -1, or a PAD before an id) is
// copied as it is with out_n -1 and sets bad i32[1] to epoch. W >= 1,
// L < 2^31. Returns the cudaError_t of the launch.
int swt_bpe_encode(const void* sym, int64_t W, int64_t L, const void* hkeys,
                   const void* hrank, const void* hout, int64_t H,
                   int monotone, int max_probe, void* merged, void* out_n,
                   void* bad, int epoch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hash h{static_cast<const int64_t*>(hkeys),
               static_cast<const int32_t*>(hrank),
               static_cast<const int32_t*>(hout), H, max_probe};
  const auto* in = static_cast<const int32_t*>(sym);
  auto* out = static_cast<int32_t*>(merged);
  auto* n_out = static_cast<int32_t*>(out_n);
  auto* flag = static_cast<int32_t*>(bad);
  const int Li = static_cast<int>(L);
  if (L <= 32 * kMaxPer) {
    const auto blocks = static_cast<unsigned>((W + kWarps - 1) / kWarps);
    if (L <= 32)
      encode_regs_kernel<1><<<blocks, kThreads, 0, s>>>(
          in, W, Li, h, monotone, out, n_out, flag, epoch);
    else if (L <= 64)
      encode_regs_kernel<2><<<blocks, kThreads, 0, s>>>(
          in, W, Li, h, monotone, out, n_out, flag, epoch);
    else
      encode_regs_kernel<kMaxPer><<<blocks, kThreads, 0, s>>>(
          in, W, Li, h, monotone, out, n_out, flag, epoch);
    return static_cast<int>(cudaGetLastError());
  }
  // The wide path: as many warps a block as rows fit in 48 KB of shared
  // memory (at most 8), or the rows in place when one does not fit.
  const int64_t row_bytes = 4 * L;
  int64_t warps = kSharedMax / row_bytes;
  const int in_shared = warps >= 1;
  warps = warps < 1 ? kWarps : (warps > kWarps ? kWarps : warps);
  const auto blocks = static_cast<unsigned>((W + warps - 1) / warps);
  encode_wide_kernel<<<blocks, static_cast<unsigned>(32 * warps),
                       in_shared ? warps * row_bytes : 0, s>>>(
      in, W, Li, h, monotone, out, n_out, flag, epoch, in_shared);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
