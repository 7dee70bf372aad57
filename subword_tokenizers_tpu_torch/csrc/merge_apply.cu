// K3: apply one merge (BPE or WordPiece) to the flat state and
// left-compact it.
//
// Replaces the JAX package's jitted XLA programs
//   subword_tokenizers_tpu/ops/flat.py: flat_apply (and compact_flat), and
//   subword_tokenizers_tpu/ops/merge.py: apply_merge (the padded layout;
//     the port keeps one layout, and the JAX package's own tests hold the
//     two equal), and
//   subword_tokenizers_tpu/ops/train_loop.py:264-267, WordPiece's carried
//     per-symbol weights,
// which mark matches with shifted copies and a cummax for the self-merge
// parity, then compact with a stable sort keyed on liveness. Here the
// compaction is a prefix sum instead of a sort. The step's (a, b, new_id,
// active) are read from K2's record on the device (never host arguments);
// an inactive step merges nothing and only copies.
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
//   2 kept as new_id) into flags[i]; each block's kept count; n_rep, the
//   weight of the matches, by one atomicAdd per block (integer, exact).
//   The parity walk steps back through the run, so it is bounded by the
//   longest word (22 symbols on train-85k) and runs only for matches of a
//   self-merge.
// - scan_kernel, one block: exclusive scan of the block counts (as in
//   compact.cu); writes the total to blocks[2 NB] and to rec[5] (n_live).
//   With a sym_freq table (WordPiece; null for BPE) and an active step,
//   its thread 0 also applies the carried update with the final n_rep,
//   which every block of mark_kernel has added by then (stream order):
//   sym_freq[a] -= n_rep, sym_freq[b] -= n_rep, sym_freq[new_id] += n_rep,
//   in that order, so a self-merge subtracts twice as JAX's chained
//   .at[].add does. Each replacement consumes one a and one b and makes
//   one new_id, so the table stays equal to a recount (symbol_freqs.cu).
// - scatter_kernel, one thread per slot: the slot's place is its block's
//   offset plus its rank among the block's kept slots (warp ballots).
// Bound on this card: memory traffic, about 4 passes over the 16 bytes a
// slot holds (3 MB at train-85k's width), so the launches' latency
// dominates; the one-block scan handles the 736 block counts there.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int32_t kWidPad = 1 << 30;

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
                            unsigned long long* n_rep) {
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
    if (r) atomicAdd(n_rep, static_cast<unsigned long long>(r));
  }
}

__global__ void scan_kernel(const int32_t* __restrict__ cnt, int64_t n,
                            int32_t* __restrict__ off, int32_t* rec,
                            const long long* n_rep, long long* sym_freq) {
  __shared__ int64_t part[kScanThreads];
  const int t = threadIdx.x;
  if (t == 0 && sym_freq != nullptr && rec[4] != 0) {
    const long long r = *n_rep;
    sym_freq[rec[0]] -= r;
    sym_freq[rec[1]] -= r;
    sym_freq[rec[2]] += r;
  }
  const int64_t per = (n + kScanThreads - 1) / kScanThreads;
  const int64_t b = t * per;
  const int64_t e = b + per < n ? b + per : n;
  int64_t sum = 0;
  for (int64_t k = b; k < e; ++k) sum += cnt[k];
  part[t] = sum;
  __syncthreads();
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
                               int64_t* __restrict__ out_wgt) {
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

}  // namespace

extern "C" {

// fs i32[F], wid i32[F], wgt i64[F], rec i32[6] -> out_fs/out_wid/out_wgt
// (same shapes, separate buffers), rec[5] = live slots, n_rep i64[1];
// scratch flags u8[F], blocks i32[2 NB + 1] with NB = ceil(F / 256);
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
  cudaError_t err = cudaMemsetAsync(n_rep, 0, sizeof(int64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  mark_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      static_cast<const int32_t*>(fs), static_cast<const int32_t*>(wid),
      static_cast<const int64_t*>(wgt), F, static_cast<const int32_t*>(rec),
      static_cast<uint8_t*>(flags), cnt,
      static_cast<unsigned long long*>(n_rep));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<1, kScanThreads, 0, s>>>(
      cnt, nb, off, static_cast<int32_t*>(rec),
      static_cast<const long long*>(n_rep), static_cast<long long*>(sym_freq));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      static_cast<const int32_t*>(fs), static_cast<const int32_t*>(wid),
      static_cast<const int64_t*>(wgt), F, static_cast<const int32_t*>(rec),
      static_cast<const uint8_t*>(flags), off, nb,
      static_cast<int32_t*>(out_fs), static_cast<int32_t*>(out_wid),
      static_cast<int64_t*>(out_wgt));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
