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
//   round), each word carrying the call's epoch (a host counter), so no
//   word is cleared between calls;
// - the kept slots are compacted in shared memory and written out as one
//   contiguous run; once the last tile's inclusive word gives the live
//   count n_live, every block pads [n_live, F) in a grid stride (no kept
//   slot lands there, so any block may write it, in any order);
// - the last tile's look-back gives the state's totals: it writes n_rep
//   and rec[5] = n_live and, with a sym_freq table (WordPiece; null for
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
// The skip route's overflow guard keeps that design (below): mark_kernel,
// a thread a slot, writes each slot's kind (0 dropped, 1 kept, 2 kept as
// new_id) to a flag byte and each block's kept count to its own word;
// scan_kernel, one block, scans the block counts; scatter_kernel places
// each kept slot at its block's offset plus its rank (warp ballots) and
// pads from the total.
//
// Skip mode (deferred compaction, window S), which replaces
//   subword_tokenizers_tpu/ops/flat.py: skip_overflow, skip_prev_select,
//     flat_skip_apply, and the lax.cond compaction of flat_train_steps
//     (ops/train_loop.py:223-258):
// - swt_skip_guard, before each step's pair count: skip_check_kernel finds
//   whether a live slot has no live successor within S + 1 slots while a
//   later live slot exists (JAX's skip_overflow, exact and as
//   conservative across words), as max(F - i) over such slots and max(i +
//   1) over live slots, two atomicMax after a warp reduction; mark, scan
//   and scatter then compact into the second buffer, gated on that
//   flag on the device (each block returns at once when it is clear), and
//   copy_kernel, gated the same way, copies the result back and counts
//   the compaction. No host sync: the state stays in the caller's buffer.
// - swt_merge_skip: mark_skip_kernel decides each slot from reads only --
//   a match when it is live, holds a, and its nearest live successor
//   within S + 1 holds b in the same word; for a == b only at an even
//   count of equal live predecessors back through the run (each found
//   within S + 1, as JAX's cpos parity counts them); dead when its
//   nearest live predecessor within S + 1 matched -- and applies the
//   carried weights by three atomicAdd a block (exact in any order);
//   apply_skip_kernel then writes new_id into matches and (-1, WID_PAD,
//   0) into the dead slots, in place: no scan and no scatter.
// Bound on this card: latency; each skip-mode launch reads each slot's
// window of S + 1 neighbours (12 at the default), a few MB.
#include <cstdint>

#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int32_t kWidPad = 1 << 30;

// The skip guard's flag: gate[0] = max(F - i) over live slots with no live
// successor in the window, gate[1] = max(i + 1) over live slots; a null
// gate is always open.
__device__ __forceinline__ bool gate_open(const int32_t* gate, int64_t F) {
  return gate == nullptr ||
         (gate[0] > 0 && F - gate[0] < static_cast<int64_t>(gate[1]) - 1);
}

__device__ __forceinline__ bool is_match(const int32_t* fs,
                                         const int32_t* wid, int64_t F,
                                         int64_t i, int32_t a, int32_t b) {
  if (i < 0 || i + 1 >= F) return false;
  const int32_t s = fs[i];
  if (s != a || fs[i + 1] != b || wid[i] != wid[i + 1]) return false;
  if (a != b) return true;
  const int32_t w = wid[i];
  int64_t j = i - 1;
  while (j >= 0 && fs[j] == s && wid[j] == w) --j;
  return ((i - 1 - j) & 1) == 0;
}

__global__ void mark_kernel(const int32_t* __restrict__ fs,
                            const int32_t* __restrict__ wid,
                            const int64_t* __restrict__ wgt, int64_t F,
                            const int32_t* __restrict__ rec,
                            uint8_t* __restrict__ flags,
                            int32_t* __restrict__ block_cnt,
                            long long* __restrict__ block_rep,
                            const int32_t* gate) {
  if (!gate_open(gate, F)) return;
  __shared__ int s_cnt[kWarps];
  __shared__ long long s_rep[kWarps];
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  const bool active = rec[4] != 0;
  const int32_t a = active ? rec[0] : -3;
  const int32_t b = active ? rec[1] : -3;
  bool keep = false;
  long long rep = 0;
  if (i < F) {
    const bool m = is_match(fs, wid, F, i, a, b);
    const bool dead = is_match(fs, wid, F, i - 1, a, b);
    keep = fs[i] >= 0 && !dead;
    flags[i] = keep ? (m ? 2 : 1) : 0;
    if (m) rep = wgt[i];
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  for (int off = 16; off > 0; off >>= 1)
    rep += __shfl_down_sync(0xffffffffu, rep, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_cnt[warp] = __popc(ballot);
    s_rep[warp] = rep;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int cnt = 0;
    long long r = 0;
    for (int w = 0; w < kWarps; ++w) {
      cnt += s_cnt[w];
      r += s_rep[w];
    }
    block_cnt[blockIdx.x] = cnt;
    block_rep[blockIdx.x] = r;
  }
}

// n_rep[0] gets the sum of the blocks' match weights n_rep[1 .. n].
__global__ void scan_kernel(const int32_t* __restrict__ cnt, int64_t n,
                            int32_t* __restrict__ off, int32_t* rec,
                            long long* n_rep, const int32_t* gate,
                            int64_t F) {
  if (!gate_open(gate, F)) return;
  __shared__ int64_t part[kScanThreads];
  __shared__ long long reps[kScanThreads];
  const int t = threadIdx.x;
  const int64_t per = (n + kScanThreads - 1) / kScanThreads;
  const int64_t b = t * per;
  const int64_t e = b + per < n ? b + per : n;
  int64_t sum = 0;
  long long rep = 0;
  for (int64_t k = b; k < e; ++k) {
    sum += cnt[k];
    rep += n_rep[1 + k];
  }
  part[t] = sum;
  reps[t] = rep;
  __syncthreads();
  for (int d = kScanThreads / 2; d > 0; d >>= 1) {
    if (t < d) reps[t] += reps[t + d];
    __syncthreads();
  }
  if (t == 0) n_rep[0] = reps[0];
  // Hillis-Steele inclusive scan over the stretch sums.
  for (int d = 1; d < kScanThreads; d <<= 1) {
    const int64_t v = t >= d ? part[t - d] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int64_t run = part[t] - sum;
  for (int64_t k = b; k < e; ++k) {
    off[k] = static_cast<int32_t>(run);
    run += cnt[k];
  }
  if (t == kScanThreads - 1) {
    off[n] = static_cast<int32_t>(part[t]);
    rec[5] = static_cast<int32_t>(part[t]);
  }
}

__global__ void scatter_kernel(const int32_t* __restrict__ fs,
                               const int32_t* __restrict__ wid,
                               const int64_t* __restrict__ wgt, int64_t F,
                               const int32_t* __restrict__ rec,
                               const uint8_t* __restrict__ flags,
                               const int32_t* __restrict__ off, int64_t nb,
                               int32_t* __restrict__ out_fs,
                               int32_t* __restrict__ out_wid,
                               int64_t* __restrict__ out_wgt,
                               const int32_t* gate) {
  if (!gate_open(gate, F)) return;
  __shared__ int s_warp[kWarps];
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  const int kind = i < F ? flags[i] : 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, kind != 0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += s_warp[w];
  if (kind != 0) {
    const int64_t d = off[blockIdx.x] + base +
                      __popc(ballot & ((1u << lane) - 1u));
    out_fs[d] = kind == 2 ? rec[2] : fs[i];
    out_wid[d] = wid[i];
    out_wgt[d] = wgt[i];
  }
  if (i < F && i >= off[nb]) {
    out_fs[i] = -1;
    out_wid[i] = kWidPad;
    out_wgt[i] = 0;
  }
}

constexpr int kPer = 8;                 // slots a thread of a tile
constexpr int kTile = kThreads * kPer;  // slots a tile (2,048)
constexpr int kLead = 4;  // shared slots before a tile's; kLead - 1 holds
                          // the slot before the tile

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

// scratch: [0] n_rep, [1] the tile ticket (0 between calls), [2, 3]
// unused, then a 16-byte look-back word a tile (lookback.cuh: its kept
// count, and its match weight beside it).
__global__ void __launch_bounds__(kThreads)
    merge_tiles_kernel(const int32_t* __restrict__ fs,
                       const int32_t* __restrict__ wid,
                       const int64_t* __restrict__ wgt, int64_t F,
                       int32_t* rec, int32_t* __restrict__ out_fs,
                       int32_t* __restrict__ out_wid,
                       int64_t* __restrict__ out_wgt, long long* scratch,
                       int n_tiles, unsigned epoch, long long* sym_freq) {
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
  const bool active = rec[4] != 0;
  const int32_t a = active ? rec[0] : -3;
  const int32_t b = active ? rec[1] : -3;
  const int32_t new_id = rec[2];
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
    if (tid == 0) {  // the slot before the tile
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
    const int32_t f_next = s_fs[kLead + k0 + kPer];
    const int32_t w_next = s_wid[kLead + k0 + kPer];
    unsigned m = 0;
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
    bool dead0 = false;
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

__global__ void skip_check_kernel(const int32_t* __restrict__ fs, int64_t F,
                                  int skip, int32_t* gate) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  int empty = 0, last = 0;
  if (i < F && fs[i] >= 0) {
    last = static_cast<int>(i + 1);
    bool found = false;
    for (int64_t j = i + 1; j <= i + 1 + skip && j < F; ++j) {
      if (fs[j] >= 0) {
        found = true;
        break;
      }
    }
    if (!found) empty = static_cast<int>(F - i);
  }
  empty = __reduce_max_sync(0xffffffffu, empty);
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0) {
    if (empty) atomicMax(&gate[0], empty);
    if (last) atomicMax(&gate[1], last);
  }
}

__global__ void copy_kernel(const int32_t* gate, int64_t F,
                            const int32_t* __restrict__ src_fs,
                            const int32_t* __restrict__ src_wid,
                            const int64_t* __restrict__ src_wgt,
                            int32_t* __restrict__ fs,
                            int32_t* __restrict__ wid,
                            int64_t* __restrict__ wgt, int32_t* count) {
  if (!gate_open(gate, F)) return;
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i == 0) ++*count;
  if (i >= F) return;
  fs[i] = src_fs[i];
  wid[i] = src_wid[i];
  wgt[i] = src_wgt[i];
}

// Nearest live slot in (i, i + S + 1], or -1.
__device__ __forceinline__ int64_t live_next(const int32_t* fs, int64_t F,
                                             int64_t i, int skip) {
  for (int64_t j = i + 1; j <= i + 1 + skip && j < F; ++j)
    if (fs[j] >= 0) return j;
  return -1;
}

// Nearest live slot in [i - S - 1, i), or -1.
__device__ __forceinline__ int64_t live_prev(const int32_t* fs, int64_t i,
                                             int skip) {
  for (int64_t j = i - 1; j >= i - 1 - skip && j >= 0; --j)
    if (fs[j] >= 0) return j;
  return -1;
}

__device__ bool is_match_skip(const int32_t* fs, const int32_t* wid,
                              int64_t F, int64_t i, int skip, int32_t a,
                              int32_t b) {
  if (i < 0) return false;
  const int32_t s = fs[i];
  if (s < 0 || s != a) return false;
  const int64_t j = live_next(fs, F, i, skip);
  if (j < 0 || fs[j] != b || wid[j] != wid[i]) return false;
  if (a != b) return true;
  const int32_t w = wid[i];
  int k = 0;
  for (int64_t p = live_prev(fs, i, skip);
       p >= 0 && fs[p] == s && wid[p] == w; p = live_prev(fs, p, skip))
    ++k;
  return (k & 1) == 0;
}

__global__ void mark_skip_kernel(const int32_t* __restrict__ fs,
                                 const int32_t* __restrict__ wid,
                                 const int64_t* __restrict__ wgt, int64_t F,
                                 int skip, const int32_t* __restrict__ rec,
                                 uint8_t* __restrict__ flags,
                                 unsigned long long* sym_freq) {
  __shared__ long long s_rep[kWarps];
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  const bool active = rec[4] != 0;
  const int32_t a = active ? rec[0] : -3;
  const int32_t b = active ? rec[1] : -3;
  long long rep = 0;
  if (i < F) {
    uint8_t f = 0;
    if (fs[i] >= 0) {
      if (is_match_skip(fs, wid, F, live_prev(fs, i, skip), skip, a, b)) {
        f = 2;
      } else if (is_match_skip(fs, wid, F, i, skip, a, b)) {
        f = 1;
        rep = wgt[i];
      }
    }
    flags[i] = f;
  }
  if (sym_freq == nullptr || !active) return;
  for (int off = 16; off > 0; off >>= 1)
    rep += __shfl_down_sync(0xffffffffu, rep, off);
  if ((threadIdx.x & 31) == 0) s_rep[threadIdx.x >> 5] = rep;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long r = 0;
    for (int w = 0; w < kWarps; ++w) r += s_rep[w];
    if (r) {
      const unsigned long long neg = static_cast<unsigned long long>(-r);
      atomicAdd(&sym_freq[a], neg);
      atomicAdd(&sym_freq[b], neg);
      atomicAdd(&sym_freq[rec[2]], static_cast<unsigned long long>(r));
    }
  }
}

__global__ void apply_skip_kernel(int32_t* __restrict__ fs,
                                  int32_t* __restrict__ wid,
                                  int64_t* __restrict__ wgt, int64_t F,
                                  const int32_t* __restrict__ rec,
                                  const uint8_t* __restrict__ flags) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= F) return;
  const uint8_t f = flags[i];
  if (f == 1) {
    fs[i] = rec[2];
  } else if (f == 2) {
    fs[i] = -1;
    wid[i] = kWidPad;
    wgt[i] = 0;
  }
}

}  // namespace

extern "C" {

// fs i32[F], wid i32[F], wgt i64[F], rec i32[6] -> out_fs/out_wid/out_wgt
// (same shapes, separate buffers), rec[5] = live slots; scratch i64[4 +
// 2 ceil(F / 2048)], 16-byte aligned (see merge_tiles_kernel:
// scratch[0] gets the merge's weight, scratch[1] is 0 between calls);
// epoch in [1, 2^30), new a call; sym_freq i64[> every symbol id] updated
// in place, or null. Every array 16-byte aligned, 2 <= F < 2^31. Returns
// the cudaError_t.
int swt_merge_apply(const void* fs, const void* wid, const void* wgt,
                    int64_t F, void* rec, void* out_fs, void* out_wid,
                    void* out_wgt, void* scratch, int epoch, void* sym_freq,
                    void* stream) {
  // the blocks the card holds at once, for each device (found once)
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, merge_tiles_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (sms * per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
    resident[dev] = sms * per_sm;
  }
  const int64_t n_tiles = (F + kTile - 1) / kTile;
  const unsigned grid = static_cast<unsigned>(
      n_tiles < resident[dev] ? n_tiles : resident[dev]);
  merge_tiles_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(
                                              stream)>>>(
      static_cast<const int32_t*>(fs), static_cast<const int32_t*>(wid),
      static_cast<const int64_t*>(wgt), F, static_cast<int32_t*>(rec),
      static_cast<int32_t*>(out_fs), static_cast<int32_t*>(out_wid),
      static_cast<int64_t*>(out_wgt), static_cast<long long*>(scratch),
      static_cast<int>(n_tiles), static_cast<unsigned>(epoch),
      static_cast<long long*>(sym_freq));
  return static_cast<int>(cudaGetLastError());
}

// Skip mode's overflow guard before a step: fs/wid/wgt as above (the
// state, compacted in place when the window overflows); out_* a second
// buffer of width F; scratch flags u8[F], blocks i32[2 NB + 1] and n_rep
// i64[NB + 1] with NB = ceil(F / 256); crec i32[6] an inactive record
// (its [5] becomes the live count when it compacts); gate i32[2]
// scratch; count i32[1] is incremented per compaction.
// 0 <= skip, 2 <= F < 2^31. Returns the cudaError_t.
int swt_skip_guard(void* fs, void* wid, void* wgt, int64_t F, int skip,
                   void* out_fs, void* out_wid, void* out_wgt, void* flags,
                   void* blocks, void* n_rep, void* crec, void* gate,
                   void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nb = (F + kThreads - 1) / kThreads;
  int32_t* cnt = static_cast<int32_t*>(blocks);
  int32_t* off = cnt + nb;
  int32_t* g = static_cast<int32_t*>(gate);
  cudaError_t err = cudaMemsetAsync(gate, 0, 2 * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(nb);
  skip_check_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(fs), F, skip, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mark_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(fs), static_cast<const int32_t*>(wid),
      static_cast<const int64_t*>(wgt), F, static_cast<const int32_t*>(crec),
      static_cast<uint8_t*>(flags), cnt, static_cast<long long*>(n_rep) + 1,
      g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<1, kScanThreads, 0, s>>>(
      cnt, nb, off, static_cast<int32_t*>(crec),
      static_cast<long long*>(n_rep), g, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(fs), static_cast<const int32_t*>(wid),
      static_cast<const int64_t*>(wgt), F, static_cast<const int32_t*>(crec),
      static_cast<const uint8_t*>(flags), off, nb,
      static_cast<int32_t*>(out_fs), static_cast<int32_t*>(out_wid),
      static_cast<int64_t*>(out_wgt), g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  copy_kernel<<<grid, kThreads, 0, s>>>(
      g, F, static_cast<const int32_t*>(out_fs),
      static_cast<const int32_t*>(out_wid),
      static_cast<const int64_t*>(out_wgt), static_cast<int32_t*>(fs),
      static_cast<int32_t*>(wid), static_cast<int64_t*>(wgt),
      static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}

// Skip mode's merge, in place: fs/wid/wgt as above, rec i32[6] (columns
// 0-4 read), flags u8[F] scratch, sym_freq i64 updated as in
// swt_merge_apply, or null. 0 <= skip, 2 <= F < 2^31. Returns the
// cudaError_t.
int swt_merge_skip(void* fs, void* wid, void* wgt, int64_t F, int skip,
                   const void* rec, void* flags, void* sym_freq,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((F + kThreads - 1) / kThreads);
  mark_skip_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(fs), static_cast<const int32_t*>(wid),
      static_cast<const int64_t*>(wgt), F, skip,
      static_cast<const int32_t*>(rec), static_cast<uint8_t*>(flags),
      static_cast<unsigned long long*>(sym_freq));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  apply_skip_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<int32_t*>(fs), static_cast<int32_t*>(wid),
      static_cast<int64_t*>(wgt), F, static_cast<const int32_t*>(rec),
      static_cast<const uint8_t*>(flags));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
