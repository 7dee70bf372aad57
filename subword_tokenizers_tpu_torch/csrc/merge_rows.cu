// K3p: apply one merge to the padded training state [n, L], in place.
//
// Replaces the JAX package's jitted XLA program
//   subword_tokenizers_tpu/ops/merge.py: apply_merge (inside train_steps,
//   ops/train_loop.py:164, the padded-layout K-step loop),
// which marks matches with shifted copies, resolves self-merges by the
// parity of the offset in a run of equal symbols (a cummax), and compacts
// each row with a stable sort keyed on "is pad". Here one thread owns one
// row and makes the reference's own left-to-right pass: at column j, if
// sym[j] == a and sym[j + 1] == b the pair becomes new_id and the pass
// moves on by two, else a live symbol is kept and the pass moves on by
// one; PAD (-1) is dropped, and the row's tail is filled with PAD. The
// pass takes the even offsets of a run of a == b, and a != b pairs never
// overlap, so it equals JAX's rule on any row (PADs inside included). The
// write cursor never passes the read cursor, so the row is rewritten in
// place with no scan and no second buffer. (a, b, new_id, active) come
// from K2's record on the device; an inactive step only compacts.
//
// Bound on this card: memory traffic, each row read and written once
// (2 MB each way at train-85k's 22,971 x 22). A thread's loads stride L
// ints apart, so a warp's are not coalesced, and the launch's latency
// dominates at this size.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void merge_rows_kernel(int32_t* __restrict__ sym, int64_t n,
                                  int64_t L, const int32_t* __restrict__ rec) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (r >= n) return;
  const bool active = rec[4] != 0;
  const int32_t a = active ? rec[0] : -3;
  const int32_t b = active ? rec[1] : -3;
  const int32_t new_id = rec[2];
  int32_t* row = sym + r * L;
  int64_t w = 0;
  for (int64_t j = 0; j < L;) {
    const int32_t s = row[j];
    if (s == a && j + 1 < L && row[j + 1] == b) {
      row[w++] = new_id;
      j += 2;
    } else {
      if (s >= 0) row[w++] = s;
      ++j;
    }
  }
  for (; w < L; ++w) row[w] = -1;
}

}  // namespace

extern "C" {

// sym i32[n, L] (rewritten in place), rec i32[6] (columns 0-4 read).
// n >= 1, L >= 1, n * L < 2^31. Returns the cudaError_t.
int swt_merge_rows(void* sym, int64_t n, int64_t L, const void* rec,
                   void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  merge_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(sym), n, L, static_cast<const int32_t*>(rec));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
