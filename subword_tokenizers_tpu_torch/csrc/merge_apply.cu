// K3: apply one merge (BPE or WordPiece) to the flat state and
// left-compact it; in skip mode, merge in place and compact only when the
// skip window overflows.
//
// Replaces the JAX package's jitted XLA programs
//   subword_tokenizers_tpu/ops/flat.py:204 flat_apply (and :84
//     compact_flat), and
//   subword_tokenizers_tpu/ops/train_loop.py:264-267, WordPiece's carried
//     per-symbol weights,
// which mark matches with shifted copies and a cummax for the self-merge
// parity, then compact with a stable sort keyed on liveness. Here the
// compaction is a prefix sum instead of a sort. The step's (a, b, new_id,
// active) are read from K2's record on the device (never host arguments);
// an inactive step merges nothing and only copies. The padded layout's
// merge (ops/merge.py apply_merge) is K3p, csrc/merge_rows.cu.
//
// Semantics: slot i matches when fs[i] == a, fs[i+1] == b and wid[i] ==
// wid[i+1]. When a == b only matches at an even offset from the start of
// their run of equal symbols (within one word) count: the reference scans
// left to right and "aaa" merges at 0-1, not 1-2. The slot right of a
// match dies and the match takes new_id. Live slots are then written in
// order to the front of the second buffer (ping-pong: the caller owns
// both, nothing is allocated per step) and the rest becomes padding
// (-1, WID_PAD, 0).
//
// swt_merge_apply is one launch, merge_tiles_kernel, over tiles of 2,048
// slots (256 threads, 8 slots a thread):
// - block i takes tile i (the grid is at most what the card holds at
//   once; a state with more tiles hands the rest out by a ticket that
//   wraps back to 0), loads the tile's (fs, wid, wgt) into shared memory
//   as 16-byte vectors (neighbouring threads on neighbouring addresses)
//   with the slots before and after it, and decides each slot once, from
//   shared memory: kept, kept as new_id, or dropped. The a == b parity
//   walks back through the run in the tile, and on in global memory only
//   when the run starts before the tile;
// - a slot's rank among the tile's kept slots comes from a warp scan of
//   the threads' counts; the tile's offset, and the match weight before
//   it, from a decoupled look-back over a 16-byte word a tile (its kept
//   count and its weight; lookback.cuh, one warp reading 32 words a
//   round), each word carrying the call's epoch, so no word is cleared
//   between calls. The epoch comes from the device (scratch word [2],
//   the last call's epoch, read by every block before its first tile
//   publishes and advanced by the last tile once every tile has
//   published), so a CUDA graph that replays the launch takes a new
//   epoch each time;
// - the kept slots are compacted in shared memory and written out as one
//   contiguous run; once the last tile's inclusive word gives the live
//   count n_live, every block pads [n_live, F) in a grid stride (no kept
//   slot lands there, so any block may write it, in any order);
// - the last tile's look-back gives the state's totals: it writes n_rep
//   and rec[5] = n_live, advances the epoch word, closes skip mode's gate
//   (the state is compacted) and, with a sym_freq table (WordPiece; null for
//   BPE) and an active step, applies the carried update: sym_freq[a] -=
//   n_rep, sym_freq[b] -= n_rep, sym_freq[new_id] += n_rep, in that
//   order, so a self-merge subtracts twice as JAX's chained .at[].add
//   does. Each replacement consumes one a and one b and makes one new_id,
//   so the table stays equal to a recount (symbol_freqs.cu).
// A tile waits only on tiles before it, and the blocks that wait for
// n_live hold no tile, so the launch ends whatever the state's width.
// The scratch (the weight word, the ticket, the look-back words) is the
// caller's, built once (ops/flat.MergeScratch); nothing is allocated or
// cleared a step.
// Bound on this card: memory traffic, each slot's 16 bytes read once and
// written once (6 MB at train-85k's width, 0.0018 ms at 3.35 TB/s); the
// three launches of the earlier design (mark, a one-block scan of the
// block counts, scatter) cost about three launch latencies and read every
// slot twice, with a flag byte a slot in between; this one costs one.
//
// Skip mode (deferred compaction, window S), which replaces
//   subword_tokenizers_tpu/ops/flat.py:94 skip_overflow, :115 skip_next,
//     :133 skip_prev_select, :168 flat_skip_apply, and the lax.cond
//     compaction of flat_train_steps (ops/train_loop.py:223-236),
// is two launches a step, each over the same tiles, and one a block to
// close it, with no memset and nothing allocated (the scratch is the
// state's ops/flat.MergeScratch, built once, its word [3] the gate):
// - swt_merge_skip, merge_skip_kernel: the merge in place. A match is a
//   live slot holding a whose nearest live successor within S + 1 holds
//   b in the same word; for a == b only at an even offset in its run of
//   equal live symbols (a run breaks where a live slot's nearest live
//   predecessor within S + 1 differs in symbol or word, or there is
//   none: JAX's cpos parity). A match takes new_id; the live slot after
//   it dies where it stands (-1, WID_PAD, 0). A tile stages its slots and
//   68 on each side (S + 1 <= 65) in shared memory by 16-byte loads, and
//   each slot is decided once: the nearest live slot before and after
//   each from block scans (a prefix maximum and a suffix minimum of the
//   threads' live positions), seeded from the staged neighbours.
//   *Writes in place*: a tile's neighbours read its edge slots as their
//   halo, so no tile writes before both neighbours have staged: each
//   tile publishes a 16-byte word with the call's epoch once staged and
//   waits for its neighbours' words before it writes (tiles with nothing
//   to write do not wait). A self-merge's run may cross any number of
//   tiles; rather than walk back through slots a tile before may already
//   have rewritten, each tile carries the run's parity: its word holds
//   (the tile has a run start, parity of the live slots after its last
//   one), a segmented scan whose decoupled look-back (lookback.cuh's
//   words, read back until a run start or an inclusive word) gives the
//   parity at its left edge; only a tile whose first live slot continues
//   a run looks back. That look-back was chosen over a grid-wide barrier
//   between deciding and writing because a barrier needs every tile
//   resident at once, or the decisions of several tiles kept a block,
//   and makes every step wait for the slowest tile; the neighbours'
//   words cost a tile one wait.
//   The same launch computes the overflow test for the state it leaves
//   (JAX's skip_overflow: a live slot with no live successor within S +
//   1 while a later live slot exists, as conservative across words):
//   once done, a tile rewrites its word with its summary beside the run
//   state (its first and last live slot after the merge, whether a gap
//   inside it is wider than S + 1, and its match weight as the value);
//   the block of the last tile reads every word once done, tests the
//   gaps between tiles, and writes the gate word, epoch << 1 | overflow,
//   the epoch word, n_rep and the carried weights (a, then b, then
//   new_id, as above). No fence and no ticket: each word is one 16-byte
//   volatile store.
// - swt_skip_guard, merge_tiles_kernel<true>, before the next step's
//   pair count: each block reads the gate word and returns at once
//   unless its overflow bit is set; then it compacts the state in place
//   as K3 with an inactive record, and its last tile counts the
//   compaction and closes the gate (writes 0). In place is safe: a
//   compaction only moves slots left, a tile writes only after the
//   look-back has seen every tile before it staged, and no slot is read
//   after that. With a record (swt_skip_close, the block's closing
//   compaction, JAX's block close) the same launch compacts whatever the
//   gate, writes the live count to rec[5] and counts nothing, so a block
//   of the skip route ends in the buffers it began in.
//   swt_merge_apply closes the gate too, so a state that it compacted
//   reads as closed. The gate is never a host argument: a CUDA graph of
//   a block replays with the gate the device holds.
// Bound on this card: latency. merge_skip reads 8 bytes a slot (fs and
// wid) and writes only the slots it changes; its time is the launch, the
// staging, two block scans (a third in a tile that changes) and the last
// tile's pass over the words; the guard with its gate closed is one
// launch that reads one word a block.
#include <cstdint>

#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kEpochWord = 2;  // scratch words (ops/flat.py EPOCH, GATE)
constexpr int kGateWord = 3;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kWidPad = 1 << 30;
constexpr int kPer = 8;                 // slots a thread of a tile
constexpr int kTile = kThreads * kPer;  // slots a tile (2,048)
constexpr int kLead = 4;  // shared slots before a tile's; kLead - 1 holds
                          // the slot before the tile

__device__ __forceinline__ long long load_word(const long long* word) {
  return *reinterpret_cast<const volatile long long*>(word);
}

// This call's epoch: one past the last call's, from the epoch word. The
// host restarts the epochs (zeroes the epoch word and the status words)
// before a call would pass 2^30 - 1 (ops/flat.MergeScratch.advance).
__device__ __forceinline__ unsigned call_epoch(const long long* scratch) {
  return (static_cast<unsigned>(load_word(scratch + kEpochWord)) + 1u) &
         kEpochMask;
}

// Whether tile slot k (at shared index kLead + k, the tile starting at
// global slot base) meets a self-merge's parity: an even count of equal
// slots of its word right before it, counted in the tile and on in
// global memory when the run starts before the tile.
__device__ __forceinline__ bool even_run(const int32_t* s_fs,
                                         const int32_t* s_wid,
                                         const int32_t* fs,
                                         const int32_t* wid, int64_t base,
                                         int k, int32_t s, int32_t w) {
  int j = k - 1;
  while (j >= 0 && s_fs[kLead + j] == s && s_wid[kLead + j] == w) --j;
  if (j >= 0) return ((k - 1 - j) & 1) == 0;
  int64_t g = base - 1;
  while (g >= 0 && fs[g] == s && wid[g] == w) --g;
  return ((k + base - 1 - g) & 1) == 0;
}

// scratch (ops/flat.MergeScratch): [0] n_rep, [1] the tile ticket (0
// between calls), [2] the epoch word (the last call's epoch), [3] skip
// mode's gate word, then a 16-byte look-back word a tile (lookback.cuh:
// its kept count, and its match weight beside it).
// kGuard (the skip route's overflow guard): out_* are fs, wid and wgt,
// sym_freq is unused and the state is compacted in place. With rec null,
// every block returns at once unless the gate word's bit 0 is set, and
// the last tile adds one to *count; with a record (the block's closing
// compaction) the state is compacted whatever the gate, the last tile
// writes the live count to rec[5] and count is unused.
template <bool kGuard>
__global__ void __launch_bounds__(kThreads)
    merge_tiles_kernel(const int32_t* fs, const int32_t* wid,
                       const int64_t* wgt, int64_t F, int32_t* rec,
                       int32_t* out_fs, int32_t* out_wid, int64_t* out_wgt,
                       long long* scratch, int n_tiles, long long* sym_freq,
                       int32_t* count) {
  // The gate and the epoch are read before this block's first tile
  // publishes, so before the last tile, which waits for every tile's
  // word, closes the one and advances the other.
  if (kGuard && rec == nullptr && !(load_word(scratch + kGateWord) & 1))
    return;  // closed
  const unsigned epoch = call_epoch(scratch);
  __shared__ __align__(16) int32_t s_fs[kLead + kTile + 4];
  __shared__ __align__(16) int32_t s_wid[kLead + kTile + 4];
  __shared__ __align__(16) int64_t s_wgt[kTile];
  __shared__ unsigned char s_last[kThreads];  // a thread's last slot matched
  __shared__ int s_cnt[kWarps];
  __shared__ long long s_rep[kWarps];
  __shared__ long long s_before;
  __shared__ int s_tile;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch + 1);
  ulonglong2* status = reinterpret_cast<ulonglong2*>(scratch + 4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool active = !kGuard && rec[4] != 0;
  const int32_t a = active ? rec[0] : -3;
  const int32_t b = active ? rec[1] : -3;
  const int32_t new_id = kGuard ? -3 : rec[2];
  // A block's first tile is its own index: the grid is no larger than
  // the card holds at once, so every block runs while any waits. Further
  // tiles, when the state has more tiles than the grid, come from the
  // ticket in the order they are taken, after every first tile. Either
  // way a tile waits only on tiles that are running or done.
  for (int tile = blockIdx.x; tile < n_tiles;) {
    const int64_t base = static_cast<int64_t>(tile) * kTile;
    if (base + kTile <= F) {
      const int4* f4 = reinterpret_cast<const int4*>(fs + base);
      const int4* w4 = reinterpret_cast<const int4*>(wid + base);
      const longlong2* g2 = reinterpret_cast<const longlong2*>(wgt + base);
      for (int v = tid; v < kTile / 4; v += kThreads) {
        reinterpret_cast<int4*>(s_fs + kLead)[v] = f4[v];
        reinterpret_cast<int4*>(s_wid + kLead)[v] = w4[v];
      }
      for (int v = tid; v < kTile / 2; v += kThreads)
        reinterpret_cast<longlong2*>(s_wgt)[v] = g2[v];
    } else {  // the ragged last tile: padding past F
      for (int k = tid; k < kTile; k += kThreads) {
        const bool in = base + k < F;
        s_fs[kLead + k] = in ? fs[base + k] : -1;
        s_wid[kLead + k] = in ? wid[base + k] : kWidPad;
        s_wgt[k] = in ? wgt[base + k] : 0;
      }
    }
    if (kGuard) {  // no match: the neighbours are not read
    } else if (tid == 0) {  // the slot before the tile
      s_fs[kLead - 1] = base > 0 ? fs[base - 1] : -1;
      s_wid[kLead - 1] = base > 0 ? wid[base - 1] : kWidPad;
    } else if (tid == kThreads - 1) {  // the slot after it
      const int64_t e = base + kTile;
      s_fs[kLead + kTile] = e < F ? fs[e] : -1;
      s_wid[kLead + kTile] = e < F ? wid[e] : kWidPad;
    }
    __syncthreads();
    // each slot of this thread decided once: match bits, then keep bits
    const int k0 = tid * kPer;
    int32_t f[kPer], w[kPer];
    int64_t g[kPer];
#pragma unroll
    for (int h = 0; h < kPer; h += 4) {
      const int4 fv = *reinterpret_cast<const int4*>(s_fs + kLead + k0 + h);
      const int4 wv = *reinterpret_cast<const int4*>(s_wid + kLead + k0 + h);
      f[h] = fv.x;
      f[h + 1] = fv.y;
      f[h + 2] = fv.z;
      f[h + 3] = fv.w;
      w[h] = wv.x;
      w[h + 1] = wv.y;
      w[h + 2] = wv.z;
      w[h + 3] = wv.w;
    }
#pragma unroll
    for (int h = 0; h < kPer; h += 2) {
      const longlong2 gv =
          *reinterpret_cast<const longlong2*>(s_wgt + k0 + h);
      g[h] = gv.x;
      g[h + 1] = gv.y;
    }
    unsigned m = 0;
    bool dead0 = false;
    if (!kGuard) {
      const int32_t f_next = s_fs[kLead + k0 + kPer];
      const int32_t w_next = s_wid[kLead + k0 + kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int32_t nf = j + 1 < kPer ? f[j + 1] : f_next;
        const int32_t nw = j + 1 < kPer ? w[j + 1] : w_next;
        if (f[j] == a && nf == b && w[j] == nw &&
            (a != b || even_run(s_fs, s_wid, fs, wid, base, k0 + j, f[j],
                                w[j])))
          m |= 1u << j;
      }
      // thread 0's first slot dies when the slot before the tile matched
      if (tid == 0) {
        const int32_t p = s_fs[kLead - 1];
        const int32_t pw = s_wid[kLead - 1];
        dead0 = p == a && f[0] == b && pw == w[0];
        if (dead0 && a == b) {
          int64_t q = base - 2;
          while (q >= 0 && fs[q] == p && wid[q] == pw) --q;
          dead0 = ((base - 2 - q) & 1) == 0;
        }
      }
    }
    s_last[tid] = static_cast<unsigned char>(m >> (kPer - 1));
    __syncthreads();
    const unsigned dead = m << 1 | (tid ? s_last[tid - 1] : dead0);
    unsigned keep = 0;
    long long rep = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (f[j] >= 0 && !(dead >> j & 1)) keep |= 1u << j;
      if (m >> j & 1) rep += g[j];
    }
    // the slot's rank among the tile's kept slots; the tile's weight
    const int mine = __popc(keep);
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int n = __shfl_up_sync(~0u, incl, d);
      if (lane >= d) incl += n;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) rep += __shfl_xor_sync(~0u, rep, d);
    if (lane == 31) {
      s_cnt[warp] = incl;
      s_rep[warp] = rep;
    }
    __syncthreads();
    int before = 0, total = 0;
    long long weight = 0;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      before += q < warp ? s_cnt[q] : 0;
      total += s_cnt[q];
      weight += s_rep[q];
    }
    // compact the kept slots in shared memory (the tile is in registers)
    int r = before + incl - mine;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (keep >> j & 1) {
        s_fs[r] = m >> j & 1 ? new_id : f[j];
        s_wid[r] = w[j];
        s_wgt[r] = g[j];
        ++r;
      }
    }
    if (warp == 0) {  // the tile's offset and the weight before it
      if (lane == 0)
        publish2(status + tile, tile ? kAggregate : kInclusive, epoch, total,
                 weight);
      long long pre = 0, pre_w = 0;
      if (tile) {
        look_back_warp2(status, tile, epoch, pre, pre_w);
        if (lane == 0)
          publish2(status + tile, kInclusive, epoch, pre + total,
                   pre_w + weight);
      }
      if (lane == 0) {
        s_before = pre;
        if (tile == n_tiles - 1) {  // the state's totals: the step's results
          scratch[kEpochWord] = epoch;
          scratch[kGateWord] = 0;  // compacted: no overflow
          if (kGuard && rec != nullptr) {
            rec[5] = static_cast<int32_t>(pre + total);
          } else if (kGuard) {
            ++*count;
          } else {
            const long long n_rep = pre_w + weight;
            scratch[0] = n_rep;
            rec[5] = static_cast<int32_t>(pre + total);
            if (sym_freq != nullptr && active) {
              sym_freq[a] -= n_rep;
              sym_freq[b] -= n_rep;
              sym_freq[new_id] += n_rep;
            }
          }
        }
      }
    }
    __syncthreads();
    const int64_t o = s_before;
    for (int q = tid; q < total; q += kThreads) {
      out_fs[o + q] = s_fs[q];
      out_wid[o + q] = s_wid[q];
      out_wgt[o + q] = s_wgt[q];
    }
    if (static_cast<int>(gridDim.x) >= n_tiles) break;
    __syncthreads();  // the staged slots are out before the next tile
    if (tid == 0)
      s_tile = static_cast<int>(gridDim.x + atomicInc(ticket, n_tiles - 1));
    __syncthreads();
    tile = s_tile;
  }
  // n_live: the last tile's inclusive word; then every block pads a
  // stride of [n_live, F), where no kept slot lands
  __syncthreads();  // s_before is read before it is rewritten
  if (tid == 0) {
    ulonglong2 word;
    do {
      word = load2(status + n_tiles - 1);
    } while (!written(word.x, epoch) ||
             (word.x >> 62) != (kInclusive >> 62));
    s_before = static_cast<long long>(word.x & 0xffffffffULL);
  }
  __syncthreads();
  const int64_t n_live = s_before;
  for (int64_t p = n_live + blockIdx.x * static_cast<int64_t>(kThreads) + tid;
       p < F; p += static_cast<int64_t>(gridDim.x) * kThreads) {
    out_fs[p] = -1;
    out_wid[p] = kWidPad;
    out_wgt[p] = 0;
  }
}

// ---- skip mode's merge (merge_skip_kernel) ----

constexpr int kHalo = 68;      // staged slots each side: S + 1 <= 65,
                               // rounded up to 16 bytes
constexpr int kFar = 1 << 24;  // a position no window reaches

// The nearest slot of the warp's halo at distance 1 .. win from the tile
// (left: slots before it, right: slots after it) that is live, as a tile
// position, or -kFar / kFar when there is none. Every lane gets it.
__device__ __forceinline__ int halo_live(const int32_t* s_fs, int win,
                                         bool left) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int d = lane + 1 + 32 * q;
    const bool lv =
        d <= win &&
        s_fs[left ? kHalo - d : kHalo + kTile - 1 + d] >= 0;
    const unsigned bal = __ballot_sync(~0u, lv);
    if (bal) {
      const int dn = 32 * q + __ffs(bal);
      return left ? -dn : kTile - 1 + dn;
    }
  }
  return left ? -kFar : kFar;
}

// Over the block's threads in order: the exclusive prefix maximum of p,
// seeded with seed_p before thread 0, and the exclusive suffix minimum of
// n, seeded with seed_n after the last thread; all_p and all_n get the
// whole block's (no seed). s: 2 kWarps ints of shared memory, not
// written again before the block's next barrier. Every thread calls it.
__device__ __forceinline__ void scan_prev_next(int p, int n, int seed_p,
                                               int seed_n, int* s,
                                               int& ex_p, int& ex_n,
                                               int& all_p, int& all_n) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(~0u, p, d);
    const int dn = __shfl_down_sync(~0u, n, d);
    if (lane >= d) p = max(p, up);
    if (lane + d < 32) n = min(n, dn);
  }
  if (lane == 31) s[warp] = p;
  if (lane == 0) s[kWarps + warp] = n;
  __syncthreads();
  int pre = seed_p, post = seed_n;
  all_p = s[0];
  all_n = s[kWarps + kWarps - 1];
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    if (q < warp) pre = max(pre, s[q]);
    if (q > warp) post = min(post, s[kWarps + q]);
    all_p = max(all_p, s[q]);
    all_n = min(all_n, s[kWarps + q]);
  }
  const int up = __shfl_up_sync(~0u, p, 1);
  const int dn = __shfl_down_sync(~0u, n, 1);
  ex_p = lane ? max(up, pre) : pre;
  ex_n = lane < 31 ? min(dn, post) : post;
}

// A self-merge's run state over a stretch of slots: bit 1 whether a run
// starts in it, bit 0 the parity of the live slots after its last run
// start (of all its live slots when none starts). seg(x, y): x, then y.
__device__ __forceinline__ int seg(int x, int y) {
  return (y & 2) ? y : (x & 2) | ((x ^ y) & 1);
}

// The exclusive seg-scan of v over the block's threads in order (0
// before thread 0); total gets the whole block's. s: kWarps ints, as
// scan_prev_next's.
__device__ __forceinline__ int scan_seg(int v, int* s, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(~0u, v, d);
    if (lane >= d) v = seg(up, v);
  }
  if (lane == 31) s[warp] = v;
  __syncthreads();
  int pre = 0;
  total = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    if (q < warp) pre = seg(pre, s[q]);
    total = seg(total, s[q]);
  }
  const int up = __shfl_up_sync(~0u, v, 1);
  return lane ? seg(pre, up) : pre;
}

// The run state at the left edge of tile t: the words of the tiles
// before it, read back until one holds a run start or is inclusive.
__device__ int run_before(const ulonglong2* status, int t,
                          unsigned epoch) {
  int acc = 0;
  for (int p = t - 1; p >= 0; --p) {
    ulonglong2 w;
    do {
      w = load2(status + p);
    } while (!written(w.x, epoch));
    const int v = static_cast<int>(w.x & 3);
    acc = seg(v, acc);
    if ((v & 2) || (w.x >> 62) == (kInclusive >> 62)) break;
  }
  return acc;
}

// Waits until the word of tile t holds this call's epoch: the tile has
// staged its slots.
__device__ __forceinline__ void wait_staged(const ulonglong2* status, int t,
                                            unsigned epoch) {
  while (!written(load2(status + t).x, epoch)) {
  }
}

// A tile's word once it is done (bits of its count, beside the run state
// in bits 0-1): its first live slot after the merge + 1 (0 for none) and
// its last + 1, tile positions; a gap inside it wider than the window;
// done. Its value: the tile's match weight.
constexpr int kFirstShift = 2;
constexpr int kLastShift = 14;
constexpr unsigned kGap = 1u << 26;
constexpr unsigned kDone = 1u << 27;

// The call's results, by the block of the last tile: every tile's word
// read in order once it is done, the gaps between tiles tested, and the
// gate word, n_rep and the carried weights written.
__device__ void close_call(const ulonglong2* status, int n_tiles, int win,
                           long long* scratch, unsigned epoch, bool active,
                           int32_t a, int32_t b, int32_t new_id,
                           long long* sym_freq, int* s_scan,
                           long long* s_rep) {
  const int tid = threadIdx.x;
  const int per = (n_tiles + kThreads - 1) / kThreads;
  const int t0 = tid * per;
  const int t1 = min(t0 + per, n_tiles);
  int first = -1, last = -1;
  bool ovf = false;
  long long rep = 0;
  for (int t = t0; t < t1; ++t) {
    ulonglong2 w;
    do {
      w = load2(status + t);
    } while (!written(w.x, epoch) || !(w.x & kDone));
    rep += static_cast<long long>(w.y);
    const unsigned c = static_cast<unsigned>(w.x);
    ovf |= (c & kGap) != 0;
    const int lo = static_cast<int>(c >> kFirstShift & 0xfff);
    if (lo) {
      const int base = t * kTile;
      if (last >= 0 && base + lo - 1 - last > win) ovf = true;
      if (first < 0) first = base + lo - 1;
      last = base + static_cast<int>(c >> kLastShift & 0xfff) - 1;
    }
  }
  int before, unused[3];
  scan_prev_next(last, 0, -1, 0, s_scan, before, unused[0], unused[1],
                 unused[2]);
  if (first >= 0 && before >= 0 && first - before > win) ovf = true;
  ovf = __syncthreads_or(ovf);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) rep += __shfl_xor_sync(~0u, rep, d);
  if ((tid & 31) == 0) s_rep[tid >> 5] = rep;
  __syncthreads();
  if (tid == 0) {
    long long n_rep = 0;
    for (int q = 0; q < kWarps; ++q) n_rep += s_rep[q];
    scratch[0] = n_rep;
    scratch[kEpochWord] = epoch;
    scratch[kGateWord] = static_cast<long long>(epoch) << 1 | (ovf ? 1 : 0);
    if (sym_freq != nullptr && active) {
      sym_freq[a] -= n_rep;
      sym_freq[b] -= n_rep;
      sym_freq[new_id] += n_rep;
    }
  }
}

// scratch as merge_tiles_kernel's ([1] 0 between calls; [0], [2] and [3]
// written), a status word a tile after it.
__global__ void __launch_bounds__(kThreads)
    merge_skip_kernel(int32_t* fs, int32_t* wid, int64_t* wgt, int64_t F,
                      int skip, const int32_t* rec, long long* scratch,
                      int n_tiles, long long* sym_freq) {
  // read before this block's first tile publishes; the last tile's block
  // advances it once every tile is done (close_call)
  const unsigned epoch = call_epoch(scratch);
  __shared__ __align__(16) int32_t s_fs[kHalo + kTile + kHalo];
  __shared__ __align__(16) int32_t s_wid[kHalo + kTile + kHalo];
  __shared__ unsigned char s_match[kThreads];  // a thread's match bits
  // each scan its own words, so none waits for the others' reads
  __shared__ int s_live[2 * kWarps], s_runs[kWarps], s_post[2 * kWarps];
  __shared__ int s_first[kWarps], s_last[kWarps], s_ovf[kWarps];
  __shared__ long long s_rep[kWarps];
  __shared__ int s_tile, s_cin;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch + 1);
  ulonglong2* status = reinterpret_cast<ulonglong2*>(scratch + 4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool active = rec[4] != 0;
  const int32_t a = active ? rec[0] : -3;
  const int32_t b = active ? rec[1] : -3;
  const int32_t new_id = rec[2];
  const bool self = active && a == b;  // the parity rule applies
  const int win = skip + 1;
  for (int tile = blockIdx.x; tile < n_tiles;) {
    const int64_t base = static_cast<int64_t>(tile) * kTile;
    // stage the tile and kHalo slots each side (dead outside the state)
    if (base + kTile <= F) {
      const int4* f4 = reinterpret_cast<const int4*>(fs + base);
      const int4* w4 = reinterpret_cast<const int4*>(wid + base);
      for (int v = tid; v < kTile / 4; v += kThreads) {
        reinterpret_cast<int4*>(s_fs + kHalo)[v] = f4[v];
        reinterpret_cast<int4*>(s_wid + kHalo)[v] = w4[v];
      }
    } else {
      for (int k = tid; k < kTile; k += kThreads) {
        const bool in = base + k < F;
        s_fs[kHalo + k] = in ? fs[base + k] : -1;
        s_wid[kHalo + k] = in ? wid[base + k] : kWidPad;
      }
    }
    if (tid < kHalo) {
      const int64_t q = base - kHalo + tid;
      s_fs[tid] = q >= 0 ? fs[q] : -1;
      s_wid[tid] = q >= 0 ? wid[q] : kWidPad;
    } else if (tid < 2 * kHalo) {
      const int k = tid - kHalo;
      const int64_t q = base + kTile + k;
      s_fs[kHalo + kTile + k] = q < F ? fs[q] : -1;
      s_wid[kHalo + kTile + k] = q < F ? wid[q] : kWidPad;
    }
    __syncthreads();
    const int k0 = tid * kPer;
    int32_t f[kPer], w[kPer];
#pragma unroll
    for (int h = 0; h < kPer; h += 4) {
      const int4 fv = *reinterpret_cast<const int4*>(s_fs + kHalo + k0 + h);
      const int4 wv = *reinterpret_cast<const int4*>(s_wid + kHalo + k0 + h);
      f[h] = fv.x;
      f[h + 1] = fv.y;
      f[h + 2] = fv.z;
      f[h + 3] = fv.w;
      w[h] = wv.x;
      w[h + 1] = wv.y;
      w[h + 2] = wv.z;
      w[h + 3] = wv.w;
    }
    unsigned live = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (f[j] >= 0) live |= 1u << j;
    // each slot's nearest live slot before and after it (tile positions)
    const int seed_p = halo_live(s_fs, win, true);
    const int seed_n = halo_live(s_fs, win, false);
    int ex_p, ex_n, t_last, t_first;
    scan_prev_next(live ? k0 + 31 - __clz(live) : -kFar,
                   live ? k0 + __ffs(live) - 1 : kFar, seed_p, seed_n,
                   s_live, ex_p, ex_n, t_last, t_first);
    int prv[kPer], nxt[kPer];
    {
      int p = ex_p, n = ex_n;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        prv[j] = p;
        if (live >> j & 1) p = k0 + j;
        const int jr = kPer - 1 - j;
        nxt[jr] = n;
        if (live >> jr & 1) n = k0 + jr;
      }
    }
    // matches before the parity rule
    unsigned m = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int n = nxt[j];
      if ((live >> j & 1) && f[j] == a && n - (k0 + j) <= win &&
          s_fs[kHalo + n] == b && s_wid[kHalo + n] == w[j])
        m |= 1u << j;
    }
    // The tile's word: staged (every tile), with its run state; a tile
    // whose first live slot continues a run reads the state before it.
    // Thread 0 keeps the state it published, which its final word (done,
    // with the summary) repeats for the look-backs that read it.
    int cin = 0;
    unsigned long long st = kInclusive;
    int run = 0;
    if (self) {
      unsigned start = 0;  // the live slots where a run starts
      int v = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (!(live >> j & 1)) continue;
        const int p = prv[j];
        if (!(k0 + j - p <= win && s_fs[kHalo + p] == f[j] &&
              s_wid[kHalo + p] == w[j]))
          start |= 1u << j;
        v = (start >> j & 1) ? 2 : v ^ 1;
      }
      int total;
      const int ex = scan_seg(v, s_runs, total);
      const bool cont = __syncthreads_or(
          live && ex_p < 0 && !(start >> (__ffs(live) - 1) & 1));
      if (tid == 0) {
        st = (total & 2) || tile == 0 ? kInclusive : kAggregate;
        run = total;
        publish2(status + tile, st, epoch, run, 0);
        int before = 0;
        if (cont) {
          before = run_before(status, tile, epoch);
          st = kInclusive;
          run = seg(before, total);
          publish2(status + tile, st, epoch, run, 0);
        }
        s_cin = before & 1;
      }
      __syncthreads();
      cin = s_cin;
      // the offset parity of each live slot in its run: even merges
      int par = seg(2 | cin, ex) & 1;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (!(live >> j & 1)) continue;
        par = (start >> j & 1) ? 0 : par ^ 1;
        if (par) m &= ~(1u << j);
      }
    } else if (tid == 0) {
      publish2(status + tile, st, epoch, run, 0);
    }
    s_match[tid] = static_cast<unsigned char>(m);
    __syncthreads();
    // a live slot dies when its nearest live slot before it, within the
    // window, matched (before the tile: only the tile's first live slot)
    unsigned dead = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (!(live >> j & 1)) continue;
      const int k = k0 + j;
      const int p = prv[j];
      if (k - p > win) continue;
      const bool pm =
          p >= 0 ? (s_match[p >> 3] >> (p & 7) & 1) != 0
                 : s_fs[kHalo + p] == a && f[j] == b &&
                       s_wid[kHalo + p] == w[j] && (!self || cin == 0);
      if (pm) dead |= 1u << j;
    }
    // The tile's summary: its first and last live slot after the merge, a
    // gap wider than the window inside it, its match weight. A tile that
    // changes nothing has them from the scan above.
    int first = t_first, last = t_last, ovf = 0;
    long long rep = 0;
    if (!__syncthreads_or(m | dead)) {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if ((live >> j & 1) && prv[j] >= 0 && k0 + j - prv[j] > win) ovf = 1;
      ovf = __syncthreads_or(ovf);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (m >> j & 1) rep += wgt[base + k0 + j];
      // nothing is written before both neighbours have staged
      if (tid == 0) {
        if (tile > 0) wait_staged(status, tile - 1, epoch);
        if (tile + 1 < n_tiles) wait_staged(status, tile + 1, epoch);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int64_t q = base + k0 + j;
        if (m >> j & 1) {
          fs[q] = new_id;
        } else if (dead >> j & 1) {
          fs[q] = -1;
          wid[q] = kWidPad;
          wgt[q] = 0;
        }
      }
      const unsigned post = live & ~dead;
      int q, unused[3];
      scan_prev_next(post ? k0 + 31 - __clz(post) : -kFar, 0, -kFar, 0,
                     s_post, q, unused[0], unused[1], unused[2]);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (!(post >> j & 1)) continue;
        if (q >= 0 && k0 + j - q > win) ovf = 1;
        q = k0 + j;
      }
      first = __reduce_min_sync(~0u, post ? k0 + __ffs(post) - 1 : kFar);
      last = __reduce_max_sync(~0u, post ? k0 + 31 - __clz(post) : -1);
      ovf = static_cast<int>(
          __reduce_or_sync(~0u, static_cast<unsigned>(ovf)));
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) rep += __shfl_xor_sync(~0u, rep, d);
      if (lane == 0) {
        s_first[warp] = first;
        s_last[warp] = last;
        s_ovf[warp] = ovf;
        s_rep[warp] = rep;
      }
      __syncthreads();
      if (tid == 0) {
        for (int q2 = 0; q2 < kWarps; ++q2) {
          first = min(first, s_first[q2]);
          last = max(last, s_last[q2]);
          ovf |= s_ovf[q2];
          rep += q2 ? s_rep[q2] : 0;
        }
      }
    }
    if (tid == 0) {
      const unsigned sum = static_cast<unsigned>(run) |
                           (first < kTile ? first + 1 : 0) << kFirstShift |
                           (last >= 0 ? last + 1 : 0) << kLastShift |
                           (ovf ? kGap : 0u) | kDone;
      publish2(status + tile, st, epoch, sum, rep);
    }
    if (tile == n_tiles - 1) {  // the last tile: the call's results
      __syncthreads();
      close_call(status, n_tiles, win, scratch, epoch, active, a, b, new_id,
                 sym_freq, s_live, s_rep);
    }
    if (static_cast<int>(gridDim.x) >= n_tiles) break;
    __syncthreads();  // the staged slots are read before the next tile
    if (tid == 0)
      s_tile = static_cast<int>(gridDim.x + atomicInc(ticket, n_tiles - 1));
    __syncthreads();
    tile = s_tile;
  }
}

// The blocks of kernel the card holds at once on the current device,
// found once a device into resident[]; 0 on an error (err set).
template <class Kernel>
int resident_blocks(Kernel kernel, int* resident, cudaError_t& err) {
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return 0;
  if (dev >= 64) {
    err = cudaErrorInvalidDevice;
    return 0;
  }
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return 0;
    if (sms * per_sm < 2) {
      err = cudaErrorInvalidValue;
      return 0;
    }
    resident[dev] = sms * per_sm;
  }
  return resident[dev];
}

// The grid of a tile kernel: one block a tile, at most the resident
// blocks.
unsigned tile_grid(int64_t n_tiles, int resident) {
  return static_cast<unsigned>(n_tiles < resident ? n_tiles : resident);
}

// merge_tiles_kernel<true> over the state in place: the guard (rec null)
// or the closing compaction (a record).
int compact_in_place(void* fs, void* wid, void* wgt, int64_t F,
                     void* scratch, void* rec, void* count, void* stream) {
  static int resident[64];
  cudaError_t err;
  const int res = resident_blocks(merge_tiles_kernel<true>, resident, err);
  if (res == 0) return static_cast<int>(err);
  const int64_t n_tiles = (F + kTile - 1) / kTile;
  merge_tiles_kernel<true><<<tile_grid(n_tiles, res), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fs), static_cast<const int32_t*>(wid),
      static_cast<const int64_t*>(wgt), F, static_cast<int32_t*>(rec),
      static_cast<int32_t*>(fs), static_cast<int32_t*>(wid),
      static_cast<int64_t*>(wgt), static_cast<long long*>(scratch),
      static_cast<int>(n_tiles), nullptr, static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// fs i32[F], wid i32[F], wgt i64[F], rec i32[6] -> out_fs/out_wid/out_wgt
// (same shapes, separate buffers), rec[5] = live slots; scratch i64[4 +
// 2 ceil(F / 2048)], 16-byte aligned (see merge_tiles_kernel:
// scratch[0] gets the merge's weight, scratch[1] is 0 between calls,
// scratch[2] the epoch word, below 2^30 - 1, advanced; scratch[3], the
// gate, closed); sym_freq i64[> every symbol id] updated in place, or
// null. Every array 16-byte aligned, 2 <= F < 2^31. No argument changes
// from call to call but the state's, so a CUDA graph may replay the
// launch. Returns the cudaError_t.
int swt_merge_apply(const void* fs, const void* wid, const void* wgt,
                    int64_t F, void* rec, void* out_fs, void* out_wid,
                    void* out_wgt, void* scratch, void* sym_freq,
                    void* stream) {
  static int resident[64];
  cudaError_t err;
  const int res = resident_blocks(merge_tiles_kernel<false>, resident, err);
  if (res == 0) return static_cast<int>(err);
  const int64_t n_tiles = (F + kTile - 1) / kTile;
  merge_tiles_kernel<false><<<tile_grid(n_tiles, res), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fs), static_cast<const int32_t*>(wid),
      static_cast<const int64_t*>(wgt), F, static_cast<int32_t*>(rec),
      static_cast<int32_t*>(out_fs), static_cast<int32_t*>(out_wid),
      static_cast<int64_t*>(out_wgt), static_cast<long long*>(scratch),
      static_cast<int>(n_tiles), static_cast<long long*>(sym_freq), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Skip mode's merge, in place: fs/wid/wgt as above (fs and wid 16-byte
// aligned), rec i32[6] (columns 0-4 read); scratch as swt_merge_apply's:
// [0] gets the merge's weight, [2] the epoch word, advanced, [3] the gate
// word epoch << 1 | overflow; sym_freq as in swt_merge_apply, or null.
// 0 < skip <= 64, 2 <= F < 2^31. Returns the cudaError_t.
int swt_merge_skip(void* fs, void* wid, void* wgt, int64_t F, int skip,
                   const void* rec, void* scratch, void* sym_freq,
                   void* stream) {
  static int resident[64];
  cudaError_t err;
  const int res = resident_blocks(merge_skip_kernel, resident, err);
  if (res == 0) return static_cast<int>(err);
  if (skip < 1 || skip + 1 > kHalo) return cudaErrorInvalidValue;
  const int64_t n_tiles = (F + kTile - 1) / kTile;
  merge_skip_kernel<<<tile_grid(n_tiles, res), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(fs), static_cast<int32_t*>(wid),
      static_cast<int64_t*>(wgt), F, skip, static_cast<const int32_t*>(rec),
      static_cast<long long*>(scratch), static_cast<int>(n_tiles),
      static_cast<long long*>(sym_freq));
  return static_cast<int>(cudaGetLastError());
}

// Skip mode's overflow guard before a step: fs/wid/wgt as above, compacted
// in place when bit 0 of scratch[3] (swt_merge_skip's gate word) is set,
// then the gate closed, the epoch word advanced and count i32[1]
// incremented; else nothing changes. 2 <= F < 2^31. Returns the
// cudaError_t.
int swt_skip_guard(void* fs, void* wid, void* wgt, int64_t F, void* scratch,
                   void* count, void* stream) {
  return compact_in_place(fs, wid, wgt, F, scratch, nullptr, count, stream);
}

// Skip mode's closing compaction of a block: fs/wid/wgt compacted in place
// whatever the gate, rec[5] (rec i32[6]) = live slots, the gate closed and
// the epoch word advanced. 2 <= F < 2^31. Returns the cudaError_t.
int swt_skip_close(void* fs, void* wid, void* wgt, int64_t F, void* scratch,
                   void* rec, void* stream) {
  return compact_in_place(fs, wid, wgt, F, scratch, rec, nullptr, stream);
}

}  // extern "C"
