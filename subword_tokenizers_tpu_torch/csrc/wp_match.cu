// NaiveWP greedy longest match: one thread per word.
//
// Replaces the JAX package's jitted XLA programs
//   subword_tokenizers_tpu/ops/wp_encode.py: wp_match_encode, and the
//     matcher half of wp_match_encode_stacked (with its [UNK]
//     substitution: out[0] = 0, out_n = 1).
// The XLA program steps every word in lockstep inside a while_loop, with
// the automaton's state (pos, pending '#' count, node, last accept,
// output pointer, mode) in device arrays, until no word is running or a
// global step cap. Here each thread keeps its word's state in registers
// and loops until the word is done or its own step cap, which is the
// same count: JAX counts one global iteration for each step a running
// word takes.
//
// The automaton, rule by rule as in JAX:
// - the next character is the injected '#' (hash_aid) while the pending
//   count is > 0, else words[r, min(pos, L-1)] while pos < wlen;
// - a step follows goto[node, aid] >= 0 and records the deepest accept
//   (token, pos, pending count) where accept[node] >= 0;
// - at a dead end with an accept, the token is emitted (a write at
//   ptr >= L+4 is dropped and flags ovf); the word is finished when the
//   accept reached the word's end with no '#' pending, else it restarts
//   at the root from the accept's pos with min(2 + pending, 16) '#'
//   pending (flagging ovf past 16);
// - a dead end with no accept makes the whole word [UNK];
// - a word still running after (L+18)(L+22)+32 steps flags ovf.
//
// What bounds it on the card: the chain of dependent goto gathers (one
// per step; the 8,000-token vocab's table is a few MB and sits in the
// 50 MB L2) and divergence between words of unequal length inside a warp.
// The bytes are small (train-85k's 22,971 words x 24 columns of i32 in,
// 28 out). A table in shared memory, a length sort and a warp per word
// are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxInject = 16;

__global__ void wp_match_kernel(const int32_t* __restrict__ words, int64_t W,
                                int64_t L, const int32_t* __restrict__ wlen,
                                const int32_t* __restrict__ goto_t,
                                int64_t A1,
                                const int32_t* __restrict__ accept,
                                int hash_aid, int cap, int64_t max_iter,
                                int32_t* __restrict__ out,
                                int32_t* __restrict__ out_n,
                                uint8_t* __restrict__ unk_out,
                                uint8_t* __restrict__ ovf_out) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (r >= W) return;
  const int32_t* word = words + r * L;
  int32_t* orow = out + r * cap;
  for (int c = 0; c < cap; ++c) orow[c] = 0;

  const int wl = wlen[r];
  int pos = 0, inject = 0, node = 0, ptr = 0;
  int acc_tok = -1, acc_pos = 0, acc_inj = 0;
  bool running = wl > 0, unk = false, ovf = false;
  for (int64_t it = 0; running && it < max_iter; ++it) {
    const bool have = inject > 0 || pos < wl;
    const int aid = inject > 0 ? hash_aid
                               : __ldg(word + (pos < L - 1 ? pos : L - 1));
    const int child = __ldg(goto_t + static_cast<int64_t>(node) * A1 + aid);
    if (have && child >= 0) {
      if (inject > 0) --inject;
      else ++pos;
      node = child;
      const int acc = __ldg(accept + node);
      if (acc >= 0) {
        acc_tok = acc;
        acc_pos = pos;
        acc_inj = inject;
      }
      continue;
    }
    if (acc_tok < 0) {  // no accept in this segment: the word is [UNK]
      unk = true;
      running = false;
      break;
    }
    if (ptr < cap) orow[ptr] = acc_tok;
    else ovf = true;
    ++ptr;
    if (acc_pos >= wl && acc_inj == 0) {
      running = false;
      break;
    }
    if (2 + acc_inj > kMaxInject) ovf = true;
    inject = 2 + acc_inj < kMaxInject ? 2 + acc_inj : kMaxInject;
    pos = acc_pos;
    node = 0;
    acc_tok = -1;
  }
  if (unk) {
    orow[0] = 0;
    ptr = 1;
  }
  out_n[r] = ptr;
  unk_out[r] = unk;
  ovf_out[r] = ovf || running;
}

}  // namespace

extern "C" {

// words i32[W, L] alphabet ids, wlen i32[W], goto i32[n_nodes, A1],
// accept i32[n_nodes] -> out i32[W, cap], out_n i32[W], unk/ovf u8[W].
// W >= 1, L >= 1. Returns the cudaError_t of the launch.
int swt_wp_match(const void* words, int64_t W, int64_t L, const void* wlen,
                 const void* goto_t, int64_t A1, const void* accept,
                 int hash_aid, int cap, int64_t max_iter, void* out,
                 void* out_n, void* unk, void* ovf, void* stream) {
  const int64_t blocks = (W + kThreads - 1) / kThreads;
  wp_match_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(words), W, L,
      static_cast<const int32_t*>(wlen), static_cast<const int32_t*>(goto_t),
      A1, static_cast<const int32_t*>(accept), hash_aid, cap, max_iter,
      static_cast<int32_t*>(out), static_cast<int32_t*>(out_n),
      static_cast<uint8_t*>(unk), static_cast<uint8_t*>(ovf));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
