// Native (C++) hot loop of the BERT-style pre-tokenization front end.
//
// This is the TPU framework's equivalent of the reference's single native
// dependency — the HuggingFace `tokenizers` Rust crate's BertPreTokenizer
// (reference: source/utils.py:26-29). Splitting rules:
//   * whitespace (Unicode White_Space) separates and is removed;
//   * punctuation (ASCII punct ranges or Unicode category P*) is isolated
//     as a single-codepoint token;
//   * everything else forms maximal runs.
// Character classes are passed in as packed bitmaps generated on the Python
// side (tools/gen_unicode_tables.py), so this file contains no Unicode
// tables of its own and stays in lock-step with the Python fallback.
//
// Build: g++ -O3 -shared -fPIC (driven by _native/binding.py).

#include <cstdint>

namespace {

inline bool bit(const uint8_t* bits, uint32_t cp) {
  // Bitmaps are produced by numpy.packbits: MSB-first within each byte.
  return (bits[cp >> 3] >> (7 - (cp & 7))) & 1;
}

}  // namespace

extern "C" {

// Split one lowered codepoint sequence [cps, cps+n) into tokens.
// starts/ends must each have capacity >= n. Returns the token count.
int64_t swt_split_bounds(const uint32_t* cps, int64_t n,
                         const uint8_t* ws_bits, const uint8_t* punct_bits,
                         int64_t* starts, int64_t* ends) {
  int64_t n_tokens = 0;
  int64_t i = 0;
  while (i < n) {
    uint32_t cp = cps[i];
    if (bit(ws_bits, cp)) {
      ++i;
      continue;
    }
    if (bit(punct_bits, cp)) {
      starts[n_tokens] = i;
      ends[n_tokens] = i + 1;
      ++n_tokens;
      ++i;
      continue;
    }
    int64_t start = i;
    while (i < n && !bit(ws_bits, cps[i]) && !bit(punct_bits, cps[i])) ++i;
    starts[n_tokens] = start;
    ends[n_tokens] = i;
    ++n_tokens;
  }
  return n_tokens;
}

// Batched variant over a sentence-concatenated corpus. sent_off has
// n_sent + 1 entries; tokens never span sentence boundaries. Offsets
// written into starts/ends are global (into cps); sent_ids records the
// sentence index per token. Capacity of the output buffers must be >=
// sent_off[n_sent]. Returns the total token count.
int64_t swt_split_corpus(const uint32_t* cps, const int64_t* sent_off,
                         int64_t n_sent, const uint8_t* ws_bits,
                         const uint8_t* punct_bits, int64_t* starts,
                         int64_t* ends, int32_t* sent_ids) {
  int64_t n_tokens = 0;
  for (int64_t s = 0; s < n_sent; ++s) {
    const int64_t lo = sent_off[s];
    const int64_t hi = sent_off[s + 1];
    int64_t i = lo;
    while (i < hi) {
      uint32_t cp = cps[i];
      if (bit(ws_bits, cp)) {
        ++i;
        continue;
      }
      if (bit(punct_bits, cp)) {
        starts[n_tokens] = i;
        ends[n_tokens] = i + 1;
        sent_ids[n_tokens] = static_cast<int32_t>(s);
        ++n_tokens;
        ++i;
        continue;
      }
      int64_t start = i;
      while (i < hi && !bit(ws_bits, cps[i]) && !bit(punct_bits, cps[i])) ++i;
      starts[n_tokens] = start;
      ends[n_tokens] = i;
      sent_ids[n_tokens] = static_cast<int32_t>(s);
      ++n_tokens;
    }
  }
  return n_tokens;
}

}  // extern "C"
