// FastWP end-to-end LinMaxMatch scan: one thread per row.
//
// Replaces the JAX package's jitted XLA programs
//   subword_tokenizers_tpu/ops/wp_encode_e2e.py: _wp_e2e_scan_impl
//     (reached through wp_e2e_scan, wp_e2e_scan_u16 and the scan half of
//     wp_e2e_scan_u16_stacked / wp_e2e_scan_u16_fused), and
//   subword_tokenizers_tpu/ops/wp_encode.py: wp_e2e_encode
//     (the general-pops route).
// The XLA programs step every row in lockstep inside a while_loop; here
// each thread keeps its row's (i, node, mode, ptr, seg_ptr) in registers
// and loops until its row is DONE or the step cap, so a short row stops
// early and no state goes through device memory between steps.
//
// Per step a row reads one char word, one goto entry and, on a failure
// transition, its node's fail link and CSR pops. What bounds it on the
// card: the chain of dependent gathers into the goto table (20,840 nodes
// x 80 columns of i32 = 6.7 MB for the 8k vocab, which sits in the 50 MB
// L2), one thread per row (27k rows fill about 215 blocks of 128), and
// divergence between rows of unequal length inside a warp. Speed work
// (sorting rows by length, shared-memory tables, a warp per row) is
// later work; this kernel is the simple, exact one.
//
// Semantics follow the JAX programs bit for bit, including the flags:
// - the step cap and the output width come from the caller's route
//   (max_steps = 4*ceil((6T+64)/4) and cap = T+4 on the packed route,
//   6T+64 and 2T+4 on the general route), never from the row's length;
// - ptr advances past cap after an overflow; writes at or past cap are
//   dropped and set ovf (for the "['UNK']" rollback only when
//   unk_ovf != 0, as on the packed route);
// - crash = VALIDATE at i >= slen without a punctuation char before i.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

enum Mode : int { MATCH = 0, VALIDATE = 1, SKIP1 = 2, SKIP2 = 3, DONE = 4 };

struct Char {
  int aid;
  bool sp, pc, prev_pc;
};

// u16 word: aid in bits 0..12, (space, punct, prev-punct) in bits 13..15.
__device__ __forceinline__ Char decode(uint16_t w) {
  return {w & 0x1FFF, ((w >> 13) & 1) != 0, ((w >> 14) & 1) != 0,
          ((w >> 15) & 1) != 0};
}

// i32 word: aid | sp<<22 | pc<<23 | prev_pc<<24.
__device__ __forceinline__ Char decode(int32_t w) {
  return {w & ((1 << 22) - 1), ((w >> 22) & 1) != 0, ((w >> 23) & 1) != 0,
          ((w >> 24) & 1) != 0};
}

template <typename Word>
__global__ void wp_e2e_scan_kernel(
    const Word* __restrict__ chars, int64_t S, int64_t W,
    const int32_t* __restrict__ slen, const int32_t* __restrict__ goto_t,
    int64_t A1, const int32_t* __restrict__ fail,
    const int32_t* __restrict__ pops_off,
    const int32_t* __restrict__ pops_flat, const int32_t* __restrict__ sharp,
    int n_sharp, int root_p, int root_sharp, int unk_id, int cap,
    int max_steps, int unk_ovf, int32_t* __restrict__ out,
    int32_t* __restrict__ out_n, uint8_t* __restrict__ ovf_out,
    uint8_t* __restrict__ stuck_out, uint8_t* __restrict__ crash_out) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (r >= S) return;
  const Word* row = chars + r * W;
  int32_t* orow = out + r * cap;
  for (int c = 0; c < cap; ++c) orow[c] = 0;

  const int sl = slen[r];
  int i = 0, node = 0, ptr = 0, seg_ptr = 0;
  int mode = sl > 0 ? MATCH : DONE;
  bool ovf = false, crash = false;

  for (int step = 0; step < max_steps && mode != DONE; ++step) {
    const Char ch = decode(row[i < W ? i : W - 1]);
    const bool prev_pc = i > 0 && ch.prev_pc;
    // iswdbndry: punctuation before i, or a space/punct char at i < sl.
    const bool bnd = prev_pc || (i < sl && (ch.sp || ch.pc));
    switch (mode) {
      case MATCH: {
        if (i >= sl) {
          mode = VALIDATE;
          break;
        }
        const int child = goto_t[static_cast<int64_t>(node) * A1 + ch.aid];
        if (child >= 0) {
          node = child;
          ++i;
          break;
        }
        const int f = fail[node];
        if (f < 0) {
          mode = VALIDATE;
          break;
        }
        // Failure transition: emit the node's pops, climb to f.
        for (int k = pops_off[node]; k < pops_off[node + 1]; ++k, ++ptr) {
          if (ptr < cap) orow[ptr] = pops_flat[k];
          else ovf = true;
        }
        node = f;
        break;
      }
      case VALIDATE: {
        if (i >= sl && !prev_pc) crash = true;
        const bool at_root =
            node == 0 || node == root_sharp || node == root_p;
        if (!bnd || !at_root) {
          // Invalid segment: roll back and emit "['UNK']".
          ptr = seg_ptr;
          if (ptr < cap) orow[ptr] = unk_id;
          else if (unk_ovf) ovf = true;
          ++ptr;
        } else if (node == root_sharp && ptr == seg_ptr) {
          // A bare "##" segment: emit encode_word("##").
          for (int k = 0; k < n_sharp; ++k, ++ptr) {
            if (ptr < cap) orow[ptr] = sharp[k];
            else ovf = true;
          }
        }
        mode = SKIP1;
        break;
      }
      case SKIP1:  // advance to the next boundary
        if (i < sl && !bnd) ++i;
        else mode = SKIP2;
        break;
      case SKIP2:  // skip whitespace, then restart or finish
        if (i < sl && ch.sp) {
          ++i;
        } else if (i < sl) {
          node = 0;
          seg_ptr = ptr;
          mode = MATCH;
        } else {
          mode = DONE;
        }
        break;
    }
  }
  out_n[r] = ptr;
  ovf_out[r] = ovf;
  stuck_out[r] = mode != DONE;
  crash_out[r] = crash;
}

constexpr int kThreads = 128;

template <typename Word>
int launch_scan(const void* chars, int64_t S, int64_t W, const void* slen,
                const void* goto_t, int64_t A1, const void* fail,
                const void* pops_off, const void* pops_flat,
                const void* sharp, int n_sharp, int root_p, int root_sharp,
                int unk_id, int cap, int max_steps, int unk_ovf, void* out,
                void* out_n, void* ovf, void* stuck, void* crash,
                void* stream) {
  const int64_t blocks = (S + kThreads - 1) / kThreads;
  wp_e2e_scan_kernel<Word><<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Word*>(chars), S, W,
      static_cast<const int32_t*>(slen), static_cast<const int32_t*>(goto_t),
      A1, static_cast<const int32_t*>(fail),
      static_cast<const int32_t*>(pops_off),
      static_cast<const int32_t*>(pops_flat),
      static_cast<const int32_t*>(sharp), n_sharp, root_p, root_sharp,
      unk_id, cap, max_steps, unk_ovf, static_cast<int32_t*>(out),
      static_cast<int32_t*>(out_n), static_cast<uint8_t*>(ovf),
      static_cast<uint8_t*>(stuck), static_cast<uint8_t*>(crash));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// chars: u16 words [S, W]. Returns the cudaError_t of the launch.
int swt_wp_e2e_scan_u16(const void* chars, int64_t S, int64_t W,
                        const void* slen, const void* goto_t, int64_t A1,
                        const void* fail, const void* pops_off,
                        const void* pops_flat, const void* sharp,
                        int n_sharp, int root_p, int root_sharp, int unk_id,
                        int cap, int max_steps, int unk_ovf, void* out,
                        void* out_n, void* ovf, void* stuck, void* crash,
                        void* stream) {
  return launch_scan<uint16_t>(chars, S, W, slen, goto_t, A1, fail,
                               pops_off, pops_flat, sharp, n_sharp, root_p,
                               root_sharp, unk_id, cap, max_steps, unk_ovf,
                               out, out_n, ovf, stuck, crash, stream);
}

// chars: i32 words [S, W]. Returns the cudaError_t of the launch.
int swt_wp_e2e_scan_i32(const void* chars, int64_t S, int64_t W,
                        const void* slen, const void* goto_t, int64_t A1,
                        const void* fail, const void* pops_off,
                        const void* pops_flat, const void* sharp,
                        int n_sharp, int root_p, int root_sharp, int unk_id,
                        int cap, int max_steps, int unk_ovf, void* out,
                        void* out_n, void* ovf, void* stuck, void* crash,
                        void* stream) {
  return launch_scan<int32_t>(chars, S, W, slen, goto_t, A1, fail,
                              pops_off, pops_flat, sharp, n_sharp, root_p,
                              root_sharp, unk_id, cap, max_steps, unk_ovf,
                              out, out_n, ovf, stuck, crash, stream);
}

}  // extern "C"
