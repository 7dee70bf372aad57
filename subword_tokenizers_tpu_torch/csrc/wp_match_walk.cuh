// NaiveWP's greedy longest match for one word, shared by kernel 6's two
// forms (wp_match.cu: the dense rows, and the rows compacted into the
// token stream in the same launch).
//
// Semantics follow the JAX program bit for bit
// (subword_tokenizers_tpu/ops/wp_encode.py: wp_match_encode, and the
// [UNK] substitution of wp_match_encode_stacked):
// - the next character is the injected '#' (hash_aid) while the pending
//   count is > 0, else the word's char at pos while pos < wlen;
// - a step follows goto[node, aid] >= 0 and records the deepest accept
//   (token, pos, pending count);
// - at a dead end with an accept, the token is emitted (a write at
//   ptr >= cap is dropped and sets ovf); the word is finished when the
//   accept reached the word's end with no '#' pending, else it restarts
//   at the root from the accept's pos with min(2 + pending, 16) '#'
//   pending (ovf past 16);
// - a dead end with no accept makes the whole word [UNK]: token 0, count
//   1 (the tokens emitted before stay in the dense row, as in JAX);
// - the JAX program steps every word in lockstep until none runs or
//   max_iter iterations, so a word's count is one step for each iteration
//   it runs, and a word still running at max_iter sets ovf.
//
// Two tables make a step one dependent gather:
// - rec[node, aid] = (child, accept[child]), 8 bytes: a step loads one
//   entry, and the child's accept comes with it;
// - jump[k] for k pending '#' (k <= 16): the walk from the root over the
//   injected '#' never reads the word, so it is one entry (steps, node,
//   the deepest accept's token or -1, its depth). A restart takes it in
//   one move and adds its steps to the count; a cap that falls inside it
//   stops the word as running, with the tokens emitted before, as the
//   lockstep program does. Where the walk meets a dead end before k, the
//   next step reads the dead end's entry as any step does.
// The word's char for the next position is read from shared memory while
// the step's entry is in flight, so only the entry is on the chain.

#pragma once

#include <cstdint>

namespace {

constexpr int kMaxInject = 16;
constexpr int kJumps = kMaxInject + 1;

// The trie's tables and the call's parameters, the same for every word.
struct MatchTables {
  const int2* rec;   // [n, A1]: (child, accept[child]), (-1, -1) if none
  int64_t A1;
  const int4* jump;  // [kJumps]: steps, node, token or -1, its depth
  int hash_aid, cap;
  long long max_iter;
};

// What a word's walk leaves: its token count (unclamped; 1 for [UNK]),
// the positions below hi (<= cap) written, and its flags.
struct WordEnd {
  int n, hi;
  bool unk, ovf;
};

// Walks one word of wl chars (word[i], i < wl) and calls put(pos, token)
// for each token written at pos < cap. jump: the tables' jump entries,
// where the block keeps them.
template <typename Put>
__device__ __forceinline__ WordEnd walk_word(const int32_t* word, int wl,
                                             const MatchTables& t,
                                             const int4* jump, Put put) {
  int pos = 0, inject = 0, node = 0, ptr = 0;
  int acc_tok = -1, acc_pos = 0, acc_inj = 0;
  long long it = 0;
  bool running = wl > 0, unk = false, ovf = false;
  const int cap = t.cap;
  int cur = wl > 0 ? word[0] : 0;  // the char at pos
  while (running && it < t.max_iter) {
    ++it;
    const bool inj = inject > 0;
    const bool have = inj || pos < wl;
    const int nxt = word[pos + 1 < wl ? pos + 1 : wl - 1];
    int2 r = make_int2(-1, -1);
    if (have) r = __ldg(t.rec + node * t.A1 + (inj ? t.hash_aid : cur));
    if (r.x >= 0) {
      if (inj) {
        --inject;
      } else {
        ++pos;
        cur = nxt;
      }
      node = r.x;
      if (r.y >= 0) {
        acc_tok = r.y;
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
    if (ptr < cap) put(ptr, acc_tok);
    else ovf = true;
    ++ptr;
    if (acc_pos >= wl && acc_inj == 0) {
      running = false;
      break;
    }
    ovf |= 2 + acc_inj > kMaxInject;
    const int k = 2 + acc_inj < kMaxInject ? 2 + acc_inj : kMaxInject;
    const int4 j = jump[k];
    if (it + j.x >= t.max_iter) break;  // the cap falls inside the jump
    it += j.x;
    pos = acc_pos;
    cur = word[pos < wl ? pos : wl - 1];
    node = j.y;
    inject = k - j.x;
    acc_tok = j.z;
    acc_inj = k - j.w;
  }
  int hi = ptr < cap ? ptr : cap;
  if (unk) {
    put(0, 0);
    ptr = 1;
    hi = hi > 1 ? hi : 1;
  }
  return {ptr, hi, unk, ovf || running};
}

}  // namespace
