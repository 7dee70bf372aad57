// K3: apply one merge (BPE or WordPiece) to the flat state and
// left-compact it; in skip mode, merge in place and compact only when the
// skip window overflows.
//
// Replaces the JAX package's jitted XLA programs
//   subword_tokenizers_tpu/ops/flat.py: flat_apply (and compact_flat), and
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
// Three launches on the caller's stream:
// - mark_kernel, one thread per slot: the slot's kind (0 dropped, 1 kept,
//   2 kept as new_id) into flags[i]; each block's kept count and the
//   weight of its matches, each into the block's own word (no atomics,
//   so nothing needs zeroing before the launch: no memset).
//   The parity walk steps back through the run, so it is bounded by the
//   longest word (22 symbols on train-85k) and runs only for matches of a
//   self-merge.
// - scan_kernel, one block: exclusive scan of the block counts (as in
//   compact.cu); writes the total to blocks[2 NB] and to rec[5] (n_live),
//   and the blocks' match weights summed to n_rep (integer, exact).
//   With a sym_freq table (WordPiece; null for BPE) and an active step,
//   its thread 0 also applies the carried update with that n_rep:
//   sym_freq[a] -= n_rep, sym_freq[b] -= n_rep, sym_freq[new_id] += n_rep,
//   in that order, so a self-merge subtracts twice as JAX's chained
//   .at[].add does. Each replacement consumes one a and one b and makes
//   one new_id, so the table stays equal to a recount (symbol_freqs.cu).
// - scatter_kernel, one thread per slot: the slot's place is its block's
//   offset plus its rank among the block's kept slots (warp ballots).
// Bound on this card: memory traffic, about 4 passes over the 16 bytes a
// slot holds (3 MB at train-85k's width), so the launches' latency
// dominates; the one-block scan handles the 736 block counts there.
//
// Skip mode (deferred compaction, window S), which replaces
//   subword_tokenizers_tpu/ops/flat.py: skip_overflow, skip_prev_select,
//     flat_skip_apply, and the lax.cond compaction of flat_train_steps
//     (ops/train_loop.py:223-258):
// - swt_skip_guard, before each step's pair count: skip_check_kernel finds
//   whether a live slot has no live successor within S + 1 slots while a
//   later live slot exists (JAX's skip_overflow, exact and as
//   conservative across words), as max(F - i) over such slots and max(i +
//   1) over live slots, two atomicMax after a warp reduction; the three
//   launches above then compact into the second buffer, gated on that
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
                            long long* n_rep, long long* sym_freq,
                            const int32_t* gate, int64_t F) {
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
  if (t == 0) {
    const long long r = reps[0];
    n_rep[0] = r;
    if (sym_freq != nullptr && rec[4] != 0) {
      sym_freq[rec[0]] -= r;
      sym_freq[rec[1]] -= r;
      sym_freq[rec[2]] += r;
    }
  }
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
// (same shapes, separate buffers), rec[5] = live slots, n_rep i64[NB + 1]
// (n_rep[0] the merge's weight, the rest the blocks' scratch); scratch
// flags u8[F], blocks i32[2 NB + 1] with NB = ceil(F / 256);
// sym_freq i64[> every symbol id] updated in place, or null.
// 2 <= F < 2^31. Returns the cudaError_t.
int swt_merge_apply(const void* fs, const void* wid, const void* wgt,
                    int64_t F, void* rec, void* out_fs, void* out_wid,
                    void* out_wgt, void* flags, void* blocks, void* n_rep,
                    void* sym_freq, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nb = (F + kThreads - 1) / kThreads;
  int32_t* cnt = static_cast<int32_t*>(blocks);
  int32_t* off = cnt + nb;
  long long* reps = static_cast<long long*>(n_rep);
  mark_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      static_cast<const int32_t*>(fs), static_cast<const int32_t*>(wid),
      static_cast<const int64_t*>(wgt), F, static_cast<const int32_t*>(rec),
      static_cast<uint8_t*>(flags), cnt, reps + 1, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<1, kScanThreads, 0, s>>>(
      cnt, nb, off, static_cast<int32_t*>(rec), reps,
      static_cast<long long*>(sym_freq), nullptr, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      static_cast<const int32_t*>(fs), static_cast<const int32_t*>(wid),
      static_cast<const int64_t*>(wgt), F, static_cast<const int32_t*>(rec),
      static_cast<const uint8_t*>(flags), off, nb,
      static_cast<int32_t*>(out_fs), static_cast<int32_t*>(out_wid),
      static_cast<int64_t*>(out_wgt), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Skip mode's overflow guard before a step: fs/wid/wgt as above (the
// state, compacted in place when the window overflows); out_* a second
// buffer of width F and flags/blocks/n_rep K3's scratch; crec i32[6] an
// inactive record (its [5] becomes the live count when it compacts);
// gate i32[2] scratch; count i32[1] is incremented per compaction.
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
      static_cast<long long*>(n_rep), nullptr, g, F);
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
