// Gather-latency probe of the H100: how fast is a gather, and a chain of
// dependent gathers, from the table's place in the memory hierarchy?
//
// Replaces the JAX package's TPU probe tools/pallas_probe.py:
//   probe_take (pallas_call at :35): out[i] = tab[idx[i], col[i]], a row
//     gather then a column pick, from a VMEM-resident table;
//   probe_loop_gather (pallas_call at :74): 128 dependent gathers per
//     lane, v = (tab[(v + c) % N] + v) % N for c in 0..127.
// The TPU probe asked whether Mosaic can gather from VMEM at all. On the
// card the question is the latency of a dependent gather, the step of
// kernel 1 (csrc/wp_e2e_scan.cu), whose every trie step reads the goto
// entry of the node the last read gave.
//
// gather_take2d: one thread per index, one read of the table in global
// memory (int32[4096, 128], 2 MiB, which sits in the 50 MB L2). Bound by
// the launch: 1,024 threads read 4 KiB.
//
// gather_loop, one thread per lane, two modes:
// - global: the table (int32[50,000], 200,000 bytes) is read through
//   the L1 and L2 caches; each iteration waits for its read;
// - shared: each block first copies the whole table into dynamic shared
//   memory (200,000 bytes of the 232,448 a block may have, allowed by
//   cudaFuncSetAttribute), then runs the chain there. This is the card's
//   counterpart of the TPU probe's VMEM.
// Bound by latency, not by bytes or operations: each iteration is a read
// whose address depends on the last read, plus two adds and two
// remainders. The divisor is a compile-time constant for the probe's
// N = 50,000 (a multiply and shifts), a run-time one otherwise.
//
// Arithmetic is int32 with wrapping adds and floor remainders (the sign
// of the divisor), as PyTorch's and NumPy's int32 `%` compute it, so the
// kernels equal their plain versions on any int32 input. An index of
// gather_take2d outside the table gives -1, as the plain version does.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kProbeN = 50000;  // the TPU probe's N_TAB

__global__ void gather_take2d_kernel(const int32_t* __restrict__ tab,
                                     int64_t n_rows, int64_t n_cols,
                                     const int32_t* __restrict__ idx,
                                     const int32_t* __restrict__ col,
                                     int64_t n, int32_t* __restrict__ out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= n) return;
  const int64_t r = idx[i];
  const int64_t c = col[i];
  out[i] = (r >= 0 && r < n_rows && c >= 0 && c < n_cols)
               ? tab[r * n_cols + c]
               : -1;
}

// (a + b) with int32 wrap-around, then its floor remainder by d > 0.
template <int kN>
__device__ __forceinline__ int32_t add_mod(int32_t a, int32_t b, int32_t n) {
  const int32_t d = kN > 0 ? kN : n;
  const int32_t s = static_cast<int32_t>(static_cast<uint32_t>(a) +
                                         static_cast<uint32_t>(b));
  const int32_t m = s % d;
  return m < 0 ? m + d : m;
}

template <bool kShared, int kN>
__global__ void gather_loop_kernel(const int32_t* __restrict__ tab,
                                   int32_t n_tab,
                                   const int32_t* __restrict__ idx,
                                   int64_t n, int iters,
                                   int32_t* __restrict__ out) {
  extern __shared__ int32_t s_tab[];
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (kShared) {
    // every thread of the block helps copy the table, lanes past n too
    for (int32_t k = threadIdx.x; k < n_tab; k += blockDim.x)
      s_tab[k] = tab[k];
    __syncthreads();
  }
  if (i >= n) return;
  int32_t v = idx[i];
  if (kShared) {
    for (int c = 0; c < iters; ++c) {
      const int32_t g = s_tab[add_mod<kN>(v, c, n_tab)];
      v = add_mod<kN>(g, v, n_tab);
    }
  } else {
    for (int c = 0; c < iters; ++c) {
      const int32_t g = __ldg(tab + add_mod<kN>(v, c, n_tab));
      v = add_mod<kN>(g, v, n_tab);
    }
  }
  out[i] = v;
}

template <bool kShared, int kN>
cudaError_t launch_loop(const int32_t* tab, int32_t n_tab, const int32_t* idx,
                        int64_t n, int iters, int32_t* out, cudaStream_t s) {
  const size_t smem = kShared ? static_cast<size_t>(n_tab) * sizeof(int32_t)
                              : 0;
  if (kShared) {
    cudaError_t err = cudaFuncSetAttribute(
        gather_loop_kernel<kShared, kN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t nb = (n + kThreads - 1) / kThreads;
  gather_loop_kernel<kShared, kN><<<static_cast<unsigned>(nb), kThreads, smem,
                                    s>>>(tab, n_tab, idx, n, iters, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// tab i32[n_rows, n_cols], idx and col i32[n] -> out i32[n].
// 1 <= n < 2^31. Returns the cudaError_t.
int swt_gather_take2d(const void* tab, int64_t n_rows, int64_t n_cols,
                      const void* idx, const void* col, int64_t n, void* out,
                      void* stream) {
  const int64_t nb = (n + kThreads - 1) / kThreads;
  gather_take2d_kernel<<<static_cast<unsigned>(nb), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tab), n_rows, n_cols,
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(col), n,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// tab i32[n_tab], idx i32[n] -> out i32[n] after `iters` dependent
// gathers; shared != 0 copies the table into shared memory first
// (n_tab * 4 bytes, at most 232,448). 1 <= n_tab < 2^31, 1 <= n < 2^31.
// Returns the cudaError_t (a refused shared-memory size or launch).
int swt_gather_loop(const void* tab, int64_t n_tab, const void* idx,
                    int64_t n, int iters, int shared, void* out,
                    void* stream) {
  const auto* t = static_cast<const int32_t*>(tab);
  const auto* x = static_cast<const int32_t*>(idx);
  auto* o = static_cast<int32_t*>(out);
  const auto nt = static_cast<int32_t>(n_tab);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (shared)
    err = nt == kProbeN ? launch_loop<true, kProbeN>(t, nt, x, n, iters, o, s)
                        : launch_loop<true, 0>(t, nt, x, n, iters, o, s);
  else
    err = nt == kProbeN ? launch_loop<false, kProbeN>(t, nt, x, n, iters, o, s)
                        : launch_loop<false, 0>(t, nt, x, n, iters, o, s);
  return static_cast<int>(err);
}

}  // extern "C"
