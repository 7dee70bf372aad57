// K4: per-symbol total weight of the flat training state (WordPiece).
//
// Replaces the JAX package's
//   subword_tokenizers_tpu/ops/pairstats.py: symbol_freqs (a segment sum
//     over the symbol ids), and
//   subword_tokenizers_tpu/ops/train_loop.py:380-385, run_fused's host
//     np.add.at that builds the carried table before the first block.
// out[s] is the sum of wgt[i] over the slots with fs[i] == s; out has
// sym_cap + 1 entries, the last a trash bucket for padding (fs < 0), which
// adds weight 0 there, so it stays 0 as in JAX. Ids at or above sym_cap
// are dropped, as segment_sum drops out-of-range segments.
//
// One thread per slot, one int64 atomicAdd each, after a memset of out.
// Integer atomics give the same sums in any order, so the table is exact.
// Launched once per training run (after any resume replay); K3 then
// carries it step by step (merge_apply.cu).
//
// Bound on this card: memory traffic and atomics. 12 bytes a slot (2.2 MB
// at train-85k's 188,416 slots); the atomics land on a few thousand
// symbols, with contention only on the most frequent characters.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void symbol_freqs_kernel(const int32_t* __restrict__ fs,
                                    const int64_t* __restrict__ wgt,
                                    int64_t F, int64_t sym_cap,
                                    unsigned long long* out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= F) return;
  const int32_t s = fs[i];
  if (s >= 0 && s < sym_cap && wgt[i] != 0)
    atomicAdd(&out[s], static_cast<unsigned long long>(wgt[i]));
}

}  // namespace

extern "C" {

// fs i32[F], wgt i64[F] -> out i64[sym_cap + 1] (overwritten).
// 1 <= F < 2^31. Returns the cudaError_t.
int swt_symbol_freqs(const void* fs, const void* wgt, int64_t F,
                     int64_t sym_cap, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (sym_cap + 1) * sizeof(int64_t),
                                    s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nb = (F + kThreads - 1) / kThreads;
  symbol_freqs_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      static_cast<const int32_t*>(fs), static_cast<const int64_t*>(wgt), F,
      sym_cap, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
