// Batched BPE encoding: the per-word merge loop, one thread per word.
//
// Replaces the JAX package's jitted XLA program
//   subword_tokenizers_tpu/ops/bpe_encode.py: bpe_encode (with _pack,
//     _lookup and _apply_rows), and the merge half of bpe_encode_stacked.
// The XLA program steps every word in lockstep inside a while_loop: each
// trip packs every adjacent pair of the whole [W, L] tensor, probes the
// rank hash for all of them, and compacts every row with a stable sort,
// until no row found a pair. Here each thread runs its own word's trips
// and stops when its word has no pair left, so a short word costs only
// its own trips.
//
// A trip probes the rank of each adjacent pair of the row's symbols
// (the ids before its first PAD), keeps the first pair of lowest rank (in monotone mode only ranks >= the
// cursor), merges every occurrence left to right without overlap, and
// compacts the row in the same pass; monotone mode then sets the cursor
// to rank + 1. A left-to-right scan that skips the second member of each
// merge gives the JAX parity rule for a self-pair (in a run "a a a a"
// only pairs at even offsets of the run merge). Each merge removes a
// symbol, so a word takes at most L trips.
//
// Each row runs its trips to the end on its own. That equals the
// lockstep loop where a row's PADs all sit at its right end, as the
// front end builds them and the wrapper checks: a row that finds no pair
// is left as it is, so the trips of the other rows do not change it.
//
// The row is worked on in place in the output row in device memory (L1
// and L2 serve the thread's repeated reads), so any width L takes the one
// code path. The hash (H slots of 16 bytes; 512 KB for the 7,922 merges
// of the 8,000 vocab) is probed with __ldg from L2: slot
// ((key * HASH_GOLD) >> 29) & (H - 1) in signed 64-bit arithmetic, then
// linear probing up to max_probe slots, stopping early at an empty slot
// (the table has no deletions, so a key lies before the first empty slot
// of its probe run).
//
// What bounds it on the card: the bytes are small (train-85k's 22,971
// words x 24 columns of i32 in and out, about 4.4 MB, 1.3 us at 3.35 TB/s),
// so the time is the latency of the longest word's dependent chain:
// trips x pairs x one L2 probe each. One thread per word leaves most
// warps diverged on words of unequal length; a warp per word and the
// rows in shared memory are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSymBits = 21;
constexpr int32_t kInf = 0x7FFFFFFF;
constexpr uint64_t kHashGold = 0x9E3779B97F4A7C15ull;  // -7046029254386353131
constexpr int kHashShift = 29;

__device__ __forceinline__ int32_t lookup(int64_t key,
                                          const int64_t* __restrict__ hkeys,
                                          const int32_t* __restrict__ hrank,
                                          const int32_t* __restrict__ hout,
                                          int64_t H, int max_probe,
                                          int32_t* out) {
  // Signed wrapping multiply (done unsigned), then an arithmetic shift.
  const int64_t prod = static_cast<int64_t>(
      static_cast<uint64_t>(key) * kHashGold);
  const int64_t base = (prod >> kHashShift) & (H - 1);
  for (int p = 0; p < max_probe; ++p) {
    const int64_t idx = (base + p) & (H - 1);
    const int64_t k = __ldg(hkeys + idx);
    if (k == key) {
      *out = __ldg(hout + idx);
      return __ldg(hrank + idx);
    }
    if (k == -1) break;
  }
  return kInf;
}

// The first pair of lowest rank among row[0..n) (ranks >= cursor in
// monotone mode): its rank (kInf if none), members and merged id.
__device__ int32_t best_pair(const int32_t* row, int64_t n,
                             const int64_t* __restrict__ hkeys,
                             const int32_t* __restrict__ hrank,
                             const int32_t* __restrict__ hout, int64_t H,
                             int max_probe, int monotone, int32_t cursor,
                             int32_t* a, int32_t* b, int32_t* merged_id) {
  int32_t best = kInf;
  *a = *b = -3;
  *merged_id = 0;
  for (int64_t j = 0; j + 1 < n; ++j) {
    const int32_t x = row[j], y = row[j + 1];
    int32_t out = 0;
    const int32_t rk = lookup((static_cast<int64_t>(x) << kSymBits) | y,
                              hkeys, hrank, hout, H, max_probe, &out);
    if (monotone && rk < cursor) continue;
    if (rk < best) {
      best = rk;
      *merged_id = out;
      *a = x;
      *b = y;
    }
  }
  return best;
}

// Merge every occurrence of (a, b) in row[0..n) left to right; the
// write index never passes the read index, so in place is safe.
// PAD-fills the freed tail and returns the new length.
__device__ int64_t merge_pass(int32_t* row, int64_t n, int32_t a, int32_t b,
                              int32_t merged_id) {
  int64_t k = 0;
  for (int64_t i = 0; i < n;) {
    const int32_t x = row[i];
    if (x == a && i + 1 < n && row[i + 1] == b) {
      row[k++] = merged_id;
      i += 2;
    } else {
      row[k++] = x;
      ++i;
    }
  }
  for (int64_t j = k; j < n; ++j) row[j] = -1;
  return k;
}

__global__ void bpe_encode_kernel(const int32_t* __restrict__ sym,
                                  int64_t W, int64_t L,
                                  const int64_t* __restrict__ hkeys,
                                  const int32_t* __restrict__ hrank,
                                  const int32_t* __restrict__ hout,
                                  int64_t H, int monotone, int max_probe,
                                  int32_t* __restrict__ merged,
                                  int32_t* __restrict__ out_n) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (r >= W) return;
  const int32_t* src = sym + r * L;
  int32_t* row = merged + r * L;
  int64_t n = 0;
  for (int64_t j = 0; j < L; ++j) {
    row[j] = src[j];
    n += src[j] >= 0;
  }
  int32_t cursor = 0;
  for (;;) {
    int32_t a, b, merged_id;
    const int32_t best = best_pair(row, n, hkeys, hrank, hout, H, max_probe,
                                   monotone, cursor, &a, &b, &merged_id);
    if (best == kInf) break;
    n = merge_pass(row, n, a, b, merged_id);
    if (monotone) cursor = best + 1;
  }
  out_n[r] = static_cast<int32_t>(n);
}

}  // namespace

extern "C" {

// sym i32[W, L] (PAD -1, only at the right end of a row), hkeys i64[H],
// hrank/hout i32[H] (H a power of two) -> merged i32[W, L], out_n i32[W].
// W >= 1. Returns the cudaError_t of the launch.
int swt_bpe_encode(const void* sym, int64_t W, int64_t L, const void* hkeys,
                   const void* hrank, const void* hout, int64_t H,
                   int monotone, int max_probe, void* merged, void* out_n,
                   void* stream) {
  const auto blocks = static_cast<unsigned>((W + kThreads - 1) / kThreads);
  bpe_encode_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sym), W, L,
      static_cast<const int64_t*>(hkeys), static_cast<const int32_t*>(hrank),
      static_cast<const int32_t*>(hout), H, monotone, max_probe,
      static_cast<int32_t*>(merged), static_cast<int32_t*>(out_n));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
