// Flags byte and dense token stream of a batch of scanned rows.
//
// Replaces the JAX package's jitted XLA programs
//   subword_tokenizers_tpu/ops/fetch.py: compact_ids, and
//   subword_tokenizers_tpu/ops/wp_encode_e2e.py: the tail of
//     wp_e2e_scan_u16_stacked (the flags byte and the compaction).
// The XLA programs sort nothing here but write a u16 stream for the
// TPU's remote link; on the card the stream is i32 and in the caller's
// row order, which the host stitches by (offset, count).
//
// Two launches on the caller's stream:
// - Pass A, one block of 1024 threads: the exclusive prefix sum of the
//   per-row counts. Each thread sums a contiguous stretch serially, a
//   block scan in shared memory joins the stretches, and each thread
//   writes its stretch's offsets. One block is enough for the tens of
//   thousands of rows a batch holds; it is bound by one SM's latency, and
//   a multi-block scan is later work.
// - Pass B, one thread per row: copies out[r, :min(out_n[r], cap)] to
//   ids[off[r]:] (positions at or past R*cap are dropped, as in JAX) and
//   writes the row's flags byte ovf | stuck<<1 | crash<<2 | sawneg2<<3,
//   where sawneg2 marks a -2 ("'##' would hang") in the emitted prefix.
//   It is bound by uncoalesced row reads of R*cap*4 bytes.
//
// head (i32[2R+1]) = [offsets (R), total, flags (R)], so the host reads
// counts, flags and total with one copy.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kScanThreads = 1024;
constexpr int kRowThreads = 256;

__global__ void exclusive_scan_kernel(const int32_t* __restrict__ out_n,
                                      int64_t R, int32_t* __restrict__ head) {
  __shared__ int64_t part[kScanThreads];
  const int t = threadIdx.x;
  const int64_t per = (R + kScanThreads - 1) / kScanThreads;
  const int64_t b = t * per;
  const int64_t e = b + per < R ? b + per : R;
  int64_t sum = 0;
  for (int64_t k = b; k < e; ++k) sum += out_n[k];
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
    head[k] = static_cast<int32_t>(run);
    run += out_n[k];
  }
  if (t == kScanThreads - 1) head[R] = static_cast<int32_t>(part[t]);
}

__global__ void scatter_rows_kernel(
    const int32_t* __restrict__ out, int64_t R, int cap,
    const int32_t* __restrict__ out_n, const uint8_t* __restrict__ ovf,
    const uint8_t* __restrict__ stuck, const uint8_t* __restrict__ crash,
    const int32_t* __restrict__ offs, int32_t* __restrict__ ids,
    int32_t* __restrict__ flags) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (r >= R) return;
  const int n = out_n[r] < cap ? out_n[r] : cap;
  const int32_t* orow = out + r * cap;
  const int64_t off = offs[r];
  const int64_t lim = R * cap;
  bool neg2 = false;
  for (int j = 0; j < n; ++j) {
    const int32_t v = orow[j];
    neg2 |= v == -2;
    if (off + j < lim) ids[off + j] = v;
  }
  flags[r] = (ovf[r] != 0) | ((stuck[r] != 0) << 1) |
             ((crash[r] != 0) << 2) | (static_cast<int>(neg2) << 3);
}

}  // namespace

extern "C" {

// out i32[R, cap], out_n i32[R], ovf/stuck/crash u8[R] -> ids i32[R*cap],
// head i32[2R+1]. R >= 1. Returns the cudaError_t of the launches.
int swt_compact(const void* out, int64_t R, int cap, const void* out_n,
                const void* ovf, const void* stuck, const void* crash,
                void* ids, void* head, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* h = static_cast<int32_t*>(head);
  exclusive_scan_kernel<<<1, kScanThreads, 0, s>>>(
      static_cast<const int32_t*>(out_n), R, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (R + kRowThreads - 1) / kRowThreads;
  scatter_rows_kernel<<<static_cast<unsigned>(blocks), kRowThreads, 0, s>>>(
      static_cast<const int32_t*>(out), R, cap,
      static_cast<const int32_t*>(out_n), static_cast<const uint8_t*>(ovf),
      static_cast<const uint8_t*>(stuck), static_cast<const uint8_t*>(crash),
      h, static_cast<int32_t*>(ids), h + R + 1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
