// K2: one BPE step's winner and merged symbol.
//
// Replaces the JAX package's jitted XLA programs
//   subword_tokenizers_tpu/ops/pairstats.py: _select (and bpe_select's
//     selection), and
//   subword_tokenizers_tpu/ops/train_loop.py: _select_and_unify.
// Selection: over the pair table of K1 (pair_stats.cu), the pair with the
// largest count, then the least first position. Positions are unique, so
// the order is total and the result does not depend on where K1 put each
// pair. Counts reach 2^52, so (count, ~pos) cannot be packed into one u64
// for atomicMax (that packing would hold only while counts < 2^32):
// instead a two-stage reduction compares (count, pos) pairs exactly.
//   - select_partial_kernel: a grid strides over the table; each block
//     writes its best (count, pos, key) to part[3 * block].
//   - select_unify_kernel, one block: reduces the partials, then decides
//     active = alive && count > 0 && vocab_size < max_vocab (an inactive
//     step records a = b = 0), computes the merged symbol's hashes
//       m = (h[a] * B^len(b) + h[b]) mod (2^31 - 1)
//     in int64 (residues < 2^31, so products < 2^62) for both bases, and
//     searches (h1, h2, len) over ids < n_sym: a hit takes the LARGEST
//     matching id, a miss appends at n_sym and counts one more symbol.
//     It writes the record (a, b, new_id, matched, active) and updates
//     ctrl = (n_sym, vocab_size, alive && active).
// With host_ids set, the step is selection only (active = count > 0,
// new_id = -1 for the host to fill in), and neither the hash tables nor
// ctrl are touched: the exact per-step path of the trainer.
//
// Bound on this card: latency. The table is a few MB (T = 2^19 entries at
// train-85k's width), read once; the unify scans at most max_vocab + 8
// ids in one block. The two launches are a few microseconds each, which
// is why the step's kernels are queued K at a time with no host sync.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kEmpty = ~0ULL;
constexpr int64_t kMod = (1LL << 31) - 1;
constexpr int64_t kNoPos = INT64_MAX;

__device__ __forceinline__ bool better(int64_t c, int64_t p, int64_t bc,
                                       int64_t bp) {
  return c > bc || (c == bc && p < bp);
}

// Block-wide best (count, pos, key); the result is valid in thread 0.
__device__ void block_best(int64_t& cnt, int64_t& pos, int64_t& key) {
  __shared__ int64_t sc[kWarps], sp[kWarps], sk[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t oc = __shfl_down_sync(0xffffffffu, cnt, off);
    const int64_t op = __shfl_down_sync(0xffffffffu, pos, off);
    const int64_t ok = __shfl_down_sync(0xffffffffu, key, off);
    if (better(oc, op, cnt, pos)) {
      cnt = oc;
      pos = op;
      key = ok;
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    sc[warp] = cnt;
    sp[warp] = pos;
    sk[warp] = key;
  }
  __syncthreads();
  if (warp == 0) {
    cnt = lane < kWarps ? sc[lane] : -1;
    pos = lane < kWarps ? sp[lane] : kNoPos;
    key = lane < kWarps ? sk[lane] : -1;
    for (int off = 16; off > 0; off >>= 1) {
      const int64_t oc = __shfl_down_sync(0xffffffffu, cnt, off);
      const int64_t op = __shfl_down_sync(0xffffffffu, pos, off);
      const int64_t ok = __shfl_down_sync(0xffffffffu, key, off);
      if (better(oc, op, cnt, pos)) {
        cnt = oc;
        pos = op;
        key = ok;
      }
    }
  }
}

__global__ void select_partial_kernel(const unsigned long long* keys,
                                      const int64_t* counts,
                                      const uint32_t* pos, int64_t T,
                                      int64_t* part) {
  int64_t bc = -1, bp = kNoPos, bk = -1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       t < T; t += stride) {
    const unsigned long long k = keys[t];
    if (k == kEmpty) continue;
    const int64_t c = counts[t];
    const int64_t p = pos[t];
    if (better(c, p, bc, bp)) {
      bc = c;
      bp = p;
      bk = static_cast<int64_t>(k);
    }
  }
  block_best(bc, bp, bk);
  if (threadIdx.x == 0) {
    part[3 * blockIdx.x] = bc;
    part[3 * blockIdx.x + 1] = bp;
    part[3 * blockIdx.x + 2] = bk;
  }
}

__global__ void select_unify_kernel(const int64_t* part, int n_part,
                                    int64_t* h1, int64_t* h2, int64_t* slen,
                                    int64_t sym_cap, int32_t* ctrl,
                                    const int64_t* pw1, const int64_t* pw2,
                                    int64_t n_pow, int64_t max_vocab,
                                    int32_t* rec, int host_ids) {
  __shared__ int64_t s_key, s_cnt, s_m1, s_m2, s_lm;
  __shared__ int s_hit;
  int64_t bc = -1, bp = kNoPos, bk = -1;
  for (int j = threadIdx.x; j < n_part; j += blockDim.x) {
    const int64_t c = part[3 * j];
    const int64_t p = part[3 * j + 1];
    if (better(c, p, bc, bp)) {
      bc = c;
      bp = p;
      bk = part[3 * j + 2];
    }
  }
  block_best(bc, bp, bk);
  const int32_t n_sym = ctrl[0];
  const int32_t vocab = ctrl[1];
  const int32_t alive = ctrl[2];
  if (threadIdx.x == 0) {
    s_cnt = bc;
    s_key = bk;
    s_hit = -1;
  }
  __syncthreads();
  const int64_t cnt = s_cnt;
  const int64_t key = s_key;
  if (host_ids) {
    if (threadIdx.x == 0) {
      const bool active = cnt > 0;
      rec[0] = active ? static_cast<int32_t>(key >> 32) : 0;
      rec[1] = active ? static_cast<int32_t>(key & 0xffffffffLL) : 0;
      rec[2] = -1;
      rec[3] = 0;
      rec[4] = active;
    }
    return;
  }
  const bool active = alive != 0 && cnt > 0 && vocab < max_vocab;
  const int32_t a = active ? static_cast<int32_t>(key >> 32) : 0;
  const int32_t b = active ? static_cast<int32_t>(key & 0xffffffffLL) : 0;
  if (threadIdx.x == 0) {
    // B^len(b), with the index clamped to the table as XLA's gather does.
    const int64_t lb = slen[b] < n_pow - 1 ? slen[b] : n_pow - 1;
    s_m1 = (h1[a] * pw1[lb] % kMod + h1[b]) % kMod;
    s_m2 = (h2[a] * pw2[lb] % kMod + h2[b]) % kMod;
    s_lm = slen[a] + slen[b];
  }
  __syncthreads();
  const int64_t m1 = s_m1, m2 = s_m2, lm = s_lm;
  int best = -1;
  for (int id = threadIdx.x; id < n_sym; id += blockDim.x) {
    if (h1[id] == m1 && h2[id] == m2 && slen[id] == lm) best = id;
  }
  if (best >= 0) atomicMax(&s_hit, best);
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool matched = s_hit >= 0;
    const int32_t new_id = matched ? s_hit : n_sym;
    const bool grow = active && !matched && n_sym < sym_cap;
    if (grow) {
      h1[n_sym] = m1;
      h2[n_sym] = m2;
      slen[n_sym] = lm;
    }
    ctrl[0] = n_sym + grow;
    ctrl[1] = vocab + grow;
    ctrl[2] = alive != 0 && active;
    rec[0] = a;
    rec[1] = b;
    rec[2] = new_id;
    rec[3] = matched;
    rec[4] = active;
  }
}

}  // namespace

extern "C" {

// keys/counts i64[T], pos i32[T] (K1's table), part i64[3 * n_part]
// scratch; h1/h2/slen i64[sym_cap], ctrl i32[3], pw1/pw2 i64[n_pow],
// rec i32[6] (columns 0-4 written). Returns the cudaError_t.
int swt_select_unify(const void* keys, const void* counts, const void* pos,
                     int64_t T, void* part, int n_part, void* h1, void* h2,
                     void* slen, int64_t sym_cap, void* ctrl, const void* pw1,
                     const void* pw2, int64_t n_pow, int64_t max_vocab,
                     void* rec, int host_ids, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  select_partial_kernel<<<n_part, kThreads, 0, s>>>(
      static_cast<const unsigned long long*>(keys),
      static_cast<const int64_t*>(counts), static_cast<const uint32_t*>(pos),
      T, static_cast<int64_t*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  select_unify_kernel<<<1, kThreads, 0, s>>>(
      static_cast<const int64_t*>(part), n_part, static_cast<int64_t*>(h1),
      static_cast<int64_t*>(h2), static_cast<int64_t*>(slen), sym_cap,
      static_cast<int32_t*>(ctrl), static_cast<const int64_t*>(pw1),
      static_cast<const int64_t*>(pw2), n_pow, max_vocab,
      static_cast<int32_t*>(rec), host_ids);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
