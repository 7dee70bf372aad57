// K4: per-symbol total weight of the training state (WordPiece).
//
// Replaces the JAX package's
//   subword_tokenizers_tpu/ops/pairstats.py:201 symbol_freqs (a segment
//     sum over the symbol ids),
//   subword_tokenizers_tpu/parallel/train.py:97 _local_sym_freq (each
//     shard's symbol_freqs before the psum; here every shard of a device
//     in one launch, the psum's sum over them included),
//   subword_tokenizers_tpu/ops/train_loop.py:152-156 (the padded loop's
//     recount every step), and
//   subword_tokenizers_tpu/ops/train_loop.py:380-385, run_fused's host
//     np.add.at that builds the carried table before the first block.
// The input is R rows of L slots, sym i32[R * L], and the rows' weights,
// wgt i64[R]: a device's block of padded rows (its shards one after the
// other: their sum is the device's partial of the mesh's sum), the
// padded layout, or the flat state as F rows of one slot (a weight a
// slot). out[s] gains the sum of the row weights over the slots with
// sym == s for every s <= sym_cap: ids below 0 (PAD) and above sym_cap
// are dropped, and an id equal to sym_cap adds into out[sym_cap], the
// trash bucket, as the JAX package's segment_sum over sym_cap + 1
// segments does (PADs add their zero weight there).
// Integer adds give the same sums in any order, so the table is exact.
//
// out must be 0 on entry. There is no memset: the caller keeps two
// outputs and alternates between them, and the launch that fills one
// empties the other (``clear``), whose readers (the scorer, K2, the
// certificate) ran before it in stream order.
//
// Design. A grid sized to the SMs, not to the slots: each block keeps a
// histogram of its symbol range in shared memory (8 bytes a bin; 8,009
// bins are 64 KB at train-85k), walks its slots in whole warps, and adds
// into it. Lanes of a warp that hold the same symbol with the same weight
// (neighbouring slots of a row) are combined first by two
// __match_any_sync, so the lowest of them adds the group's sum once and a
// frequent character costs one shared atomic a warp, not one a slot. A
// block then flushes only its non-zero bins into out with global atomics:
// a few thousand a block at most, however frequent the symbol. More
// than kMaxBins ids (sym_cap + 1) split into ranges over blockIdx.y,
// each range's blocks reading every slot.
//
// Bound on this card: bytes. The rows (4 bytes a slot), the row weights
// (8 a row) and the output written and emptied (16 bytes a bin): 2.3 MB
// for the one-card mesh's 22,976 x 22 rows, about 0.0007 ms; the flush's
// atomics and the launch's latency dominate at that size.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr uint32_t kMaxBins = 26624;  // 208 KB of shared memory a block

__global__ void __launch_bounds__(kThreads)
    symbol_freqs_kernel(const int32_t* __restrict__ sym,
                        const int64_t* __restrict__ wgt, uint32_t slots,
                        uint32_t L, int32_t sym_cap, uint32_t bins,
                        unsigned long long* __restrict__ out,
                        unsigned long long* __restrict__ clear,
                        uint32_t n_clear) {
  extern __shared__ unsigned long long hist[];
  const uint32_t n_threads = gridDim.x * gridDim.y * kThreads;
  const uint32_t t = (blockIdx.y * gridDim.x + blockIdx.x) * kThreads +
                     threadIdx.x;
  for (uint32_t e = t; e < n_clear; e += n_threads) clear[e] = 0;
  const int32_t lo = static_cast<int32_t>(blockIdx.y * bins);
  const int32_t hi = min(lo + static_cast<int32_t>(bins), sym_cap + 1);
  for (int32_t e = threadIdx.x; e < hi - lo; e += kThreads) hist[e] = 0;
  __syncthreads();
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t stride = gridDim.x * kThreads;
  // Whole warps walk together, so every lane reaches the ballot.
  for (uint32_t base = blockIdx.x * kThreads + (threadIdx.x & ~31u);
       base < slots; base += stride) {
    const uint32_t i = base + lane;
    const int32_t s = i < slots ? sym[i] : -1;
    const bool in_range = s >= lo && s < hi;
    const unsigned long long w =
        in_range ? static_cast<unsigned long long>(wgt[L == 1 ? i : i / L])
                 : 0;
    const bool adds = in_range && w != 0;
    const unsigned act = __ballot_sync(0xffffffffu, adds);
    if (adds) {
      const unsigned peers =
          __match_any_sync(act, s) & __match_any_sync(act, w);
      if (lane == static_cast<uint32_t>(__ffs(peers) - 1))
        atomicAdd(&hist[s - lo], w * static_cast<unsigned>(__popc(peers)));
    }
  }
  __syncthreads();
  for (int32_t e = threadIdx.x; e < hi - lo; e += kThreads) {
    const unsigned long long v = hist[e];
    if (v != 0) atomicAdd(&out[lo + e], v);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace

extern "C" {

// sym i32[R * L] (R rows of L slots), wgt i64[R] -> out i64[sym_cap + 1],
// 0 on entry, gains the sums; clear i64[n_clear] is emptied (NULL when
// n_clear is 0). 1 <= R * L < 2^31, 0 <= sym_cap < 2^31 - 1. Returns the
// cudaError_t.
int swt_symbol_freqs(const void* sym, const void* wgt, int64_t R, int64_t L,
                     int64_t sym_cap, void* out, void* clear,
                     int64_t n_clear, void* stream) {
  // Above 48 KB a block needs the attribute, set once on each device.
  static uint64_t ready = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !(ready >> dev & 1)) {
    cudaError_t err = cudaFuncSetAttribute(
        symbol_freqs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxBins * sizeof(unsigned long long)));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready |= 1ULL << dev;
  }
  static const int sms = sm_count();
  const int64_t slots = R * L;
  // ids 0 .. sym_cap, the trash bucket's included
  const int64_t ranges = (sym_cap + kMaxBins) / kMaxBins;
  const int64_t bins = (sym_cap + ranges) / ranges;
  int64_t per_range = sms / ranges > 0 ? sms / ranges : 1;
  const int64_t needed = (slots + kThreads - 1) / kThreads;
  if (needed < per_range) per_range = needed;
  const dim3 grid(static_cast<unsigned>(per_range),
                  static_cast<unsigned>(ranges));
  symbol_freqs_kernel<<<grid, kThreads, bins * sizeof(unsigned long long),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sym), static_cast<const int64_t*>(wgt),
      static_cast<uint32_t>(slots), static_cast<uint32_t>(L),
      static_cast<int32_t>(sym_cap), static_cast<uint32_t>(bins),
      static_cast<unsigned long long*>(out),
      static_cast<unsigned long long*>(clear),
      static_cast<uint32_t>(clear != nullptr ? n_clear : 0));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
