// FastWP's LinMaxMatch step machine for one row, shared by kernel 1's two
// forms (wp_e2e_scan.cu: the dense rows, and the rows compacted into the
// token stream in the same launch).
//
// Semantics follow the JAX programs bit for bit
// (subword_tokenizers_tpu/ops/wp_encode_e2e.py: _wp_e2e_scan_impl, and
// ops/wp_encode.py: wp_e2e_encode), including the flags:
// - the step cap and the output width come from the caller's route
//   (max_steps = 4*ceil((6T+64)/4) and cap = T+4 on the packed route,
//   6T+64 and 2T+4 on the general route), never from the row's length;
// - ptr advances past cap after an overflow; writes at or past cap are
//   dropped and set ovf (for the "['UNK']" rollback only when
//   unk_ovf != 0, as on the packed route);
// - crash = VALIDATE at i >= slen without a punctuation char before i.
//
// A node is one record of kRecInts int32 (two 16-byte words, the JAX
// package's node_info row with the CSR offset beside it):
//   [fail, pop count, pops_off, pop 0 | pop 1 .. pop kRecPops-1]
// A MATCH step issues the goto entry and the record's first word
// together, since both depend only on the node, so a failure transition
// that pops one token costs one dependent gather, not the three of fail,
// pops_off and pops_flat; the second word is read only when the node pops
// more than one token, and pops past the inline ones from pops_flat at
// pops_off + k (the general route's trie, whose nodes pop more than
// kRecPops tokens).

#pragma once

#include <cstdint>

namespace {

enum Mode : int { MATCH = 0, VALIDATE = 1, SKIP1 = 2, SKIP2 = 3, DONE = 4 };

constexpr int kRecInts = 8;
constexpr int kRecPops = kRecInts - 3;

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

// A read-only 16-byte load issued where it stands: volatile, so the
// compiler cannot sink it into the failure branch behind the goto load.
__device__ __forceinline__ int4 load_rec(const int4* p) {
  int4 v;
  asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// The trie and the route, the same for every row of a call.
struct Trie {
  const int32_t* goto_t;  // [n, A1]
  int64_t A1;
  const int4* rec;        // [n, kRecInts / 4]
  const int32_t* pops_flat;
  const int32_t* sharp;   // encode_word("##"), or [-2]
  int n_sharp, root_p, root_sharp, unk_id, cap, max_steps, unk_ovf;
};

// What a row's walk leaves: its token count (unclamped), the positions
// below hi (<= cap) it wrote at some step (the dense form keeps stale
// tokens of a rolled-back segment there, as JAX does), and its flags.
struct RowEnd {
  int n, hi;
  bool ovf, stuck, crash;
};

// Walks one row of sl characters (row[i] for i < W; the word at sl must
// exist) and calls put(pos, token) for each token written at pos < cap.
//
// Every mode's step is computed on one path, its transitions as selects:
// the lanes of a warp walk rows in different modes, and a switch would
// run the warp's modes one after another at every step. Only the
// emissions (a failure's pops, the "['UNK']" rollback, the "##"
// sequence) branch, and they are rare.
template <typename Word, typename Put>
__device__ __forceinline__ RowEnd walk_row(const Word* row, int W, int sl,
                                           const Trie& t, Put put) {
  int i = 0, node = 0, ptr = 0, seg_ptr = 0, hi = 0;
  int mode = sl > 0 ? MATCH : DONE;
  bool ovf = false, crash = false;
  const int cap = t.cap;
  auto emit = [&](int32_t v) {
    if (ptr < cap) put(ptr, v);
    else ovf = true;
    ++ptr;
  };

  for (int step = 0; step < t.max_steps && mode != DONE; ++step) {
    const Char ch = decode(row[i < W ? i : W - 1]);
    const bool in_row = i < sl;
    const bool prev_pc = i > 0 && ch.prev_pc;
    // iswdbndry: punctuation before i, or a space/punct char at i < sl.
    const bool bnd = prev_pc || (in_row && (ch.sp || ch.pc));
    // MATCH: the goto entry and the node's record (fail, count, offset,
    // first pop) in one round trip
    const bool m_act = mode == MATCH && in_row;
    const int4* nr = t.rec + 2 * static_cast<int64_t>(node);
    int child = -1;
    int4 r0 = make_int4(-1, 0, 0, 0);
    if (m_act) {
      r0 = load_rec(nr);
      child = __ldg(t.goto_t + node * t.A1 + ch.aid);
    }
    const bool adv = m_act && child >= 0;
    const bool climb = m_act && child < 0 && r0.x >= 0;
    // VALIDATE: the segment ends at a boundary at a root, or is "['UNK']"
    const bool v_act = mode == VALIDATE;
    const bool at_root =
        node == 0 || node == t.root_sharp || node == t.root_p;
    const bool inval = v_act && !(bnd && at_root);
    crash |= v_act && !in_row && !prev_pc;
    if (climb) {
      // a failure transition: emit the node's pops, climb to its fail
      const int cnt = r0.y;
      int4 r1 = make_int4(0, 0, 0, 0);
      if (cnt > 1) r1 = __ldg(nr + 1);
      if (cnt > 0) emit(r0.w);
      if (cnt > 1) emit(r1.x);
      if (cnt > 2) emit(r1.y);
      if (cnt > 3) emit(r1.z);
      if (cnt > 4) emit(r1.w);
      for (int k = kRecPops; k < cnt; ++k)
        emit(__ldg(t.pops_flat + r0.z + k));
    } else if (inval) {
      // an invalid segment: roll back and emit "['UNK']"
      ptr = seg_ptr;
      if (ptr < cap) put(ptr, t.unk_id);
      else if (t.unk_ovf) ovf = true;
      ++ptr;
    } else if (v_act && node == t.root_sharp && ptr == seg_ptr) {
      // a bare "##" segment: emit encode_word("##")
      for (int k = 0; k < t.n_sharp; ++k) emit(__ldg(t.sharp + k));
    }
    // SKIP1 advances to the next boundary; SKIP2 skips whitespace, then
    // restarts at the root or finishes
    const bool s1 = mode == SKIP1, s2 = mode == SKIP2;
    const bool adv1 = s1 && in_row && !bnd;
    const bool adv2 = s2 && in_row && ch.sp;
    const bool restart = s2 && !adv2 && in_row;
    i += adv || adv1 || adv2;
    node = adv ? child : climb ? r0.x : restart ? 0 : node;
    seg_ptr = restart ? ptr : seg_ptr;
    mode = mode == MATCH && !adv && !climb ? VALIDATE
           : v_act                         ? SKIP1
           : s1 && !adv1                   ? SKIP2
           : restart                       ? MATCH
           : s2 && !adv2                   ? DONE
                                           : mode;
    // ptr falls only in a rollback, which comes before the step's writes
    hi = ptr > hi ? ptr : hi;
  }
  return {ptr, hi < cap ? hi : cap, ovf, mode != DONE, crash};
}

}  // namespace
