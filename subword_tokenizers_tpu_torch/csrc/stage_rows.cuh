// A block's tile of padded rows copied into shared memory, shared by the
// kernels that walk rows staged there (wp_e2e_scan.cu: FastWP's scan;
// wp_match.cu: NaiveWP's greedy match), and the launch attribute that
// lets a block take more than 48 KB of it.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// Copies a tile's nrows rows of W char words (contiguous at src) into
// shared memory at a stride of ws words. Each thread first loads a batch
// of kBatch units, then stores them, so its loads are in flight together:
// 16-byte units where a row is a whole number of them, else single words.
template <typename Word>
__device__ __forceinline__ void stage_chars(const Word* src, int nrows,
                                            int W, int ws, Word* dst) {
  constexpr int kBatch = 4;
  const int tid = threadIdx.x;
  const int row_bytes = W * static_cast<int>(sizeof(Word));
  if (row_bytes % 16 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    constexpr int kPer = 16 / sizeof(Word);  // words a unit
    const int upr = row_bytes / 16;          // units a row
    const int n = nrows * upr;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    for (int b = tid; b < n; b += kBatch * blockDim.x) {
      int4 v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int u = b + k * blockDim.x;
        if (u < n) v[k] = __ldg(s4 + u);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int u = b + k * blockDim.x;
        if (u < n) {
          const int j = u / upr;
          uint32_t* d = reinterpret_cast<uint32_t*>(
              dst + j * ws + (u - j * upr) * kPer);
          d[0] = v[k].x;
          d[1] = v[k].y;
          d[2] = v[k].z;
          d[3] = v[k].w;
        }
      }
    }
    return;
  }
  const int n = nrows * W;
  for (int b = tid; b < n; b += 4 * kBatch * blockDim.x) {
    Word v[4 * kBatch];
#pragma unroll
    for (int k = 0; k < 4 * kBatch; ++k) {
      const int e = b + k * blockDim.x;
      if (e < n) v[k] = src[e];
    }
#pragma unroll
    for (int k = 0; k < 4 * kBatch; ++k) {
      const int e = b + k * blockDim.x;
      if (e < n) dst[(e / W) * ws + e % W] = v[k];
    }
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace
