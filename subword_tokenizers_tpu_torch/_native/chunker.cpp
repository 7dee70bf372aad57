// Native whitespace-chunk splitter with inline dedup, for the FastWP
// batched end-to-end encoder's host pipeline (models/wordpiece.py
// _tokenize_batch_chunked). Splits lowered text on the Python-isspace
// class, assigns each chunk a unique id by content (FNV-1a hash with
// exact memcmp verification; collisions re-probe), and reports unique
// chunk spans so only unique chunks are padded/uploaded/scanned.

#include <cstdint>
#include <cstring>
#include <unordered_map>

namespace {
inline bool bit(const uint8_t* bits, uint32_t cp) {
  return (bits[cp >> 3] >> (7 - (cp & 7))) & 1;
}
}  // namespace

extern "C" {

// cps: lowered, whitespace-joined corpus codepoints. Output buffers must
// have capacity >= (n+1)/2 chunks. Returns the number of unique chunks;
// *n_chunks_out receives the total chunk count.
int64_t swt_chunk_unique(const uint32_t* cps, int64_t n,
                         const uint8_t* ws_bits, int32_t* inverse_out,
                         int64_t* chunk_start_out, int64_t* uniq_start_out,
                         int32_t* uniq_len_out, int64_t* n_chunks_out) {
  std::unordered_map<uint64_t, int32_t> seen;
  seen.reserve(1 << 14);
  int64_t n_chunks = 0;
  int32_t n_uniq = 0;
  int64_t i = 0;
  while (i < n) {
    if (bit(ws_bits, cps[i])) {
      ++i;
      continue;
    }
    const int64_t s = i;
    while (i < n && !bit(ws_bits, cps[i])) ++i;
    const int32_t len = static_cast<int32_t>(i - s);
    uint64_t h = 1469598103934665603ull;
    for (int64_t j = s; j < i; ++j)
      h = (h ^ cps[j]) * 1099511628211ull;
    int32_t uid;
    for (;;) {
      auto it = seen.find(h);
      if (it == seen.end()) {
        uid = n_uniq++;
        seen.emplace(h, uid);
        uniq_start_out[uid] = s;
        uniq_len_out[uid] = len;
        break;
      }
      const int32_t cand = it->second;
      if (uniq_len_out[cand] == len &&
          std::memcmp(cps + uniq_start_out[cand], cps + s,
                      sizeof(uint32_t) * len) == 0) {
        uid = cand;
        break;
      }
      ++h;  // hash collision with different content: re-probe
    }
    chunk_start_out[n_chunks] = s;
    inverse_out[n_chunks] = uid;
    ++n_chunks;
  }
  *n_chunks_out = n_chunks;
  return n_uniq;
}

// Content-dedup of arbitrary spans (e.g. the front end's word bounds):
// assigns each span a unique id in first-occurrence order. Outputs:
// inverse[i] = unique index of span i; uniq_idx[u] = index of the first
// span with that content. Returns the unique count.
int64_t swt_unique_spans(const uint32_t* cps, const int64_t* starts,
                         const int64_t* ends, int64_t n_spans,
                         int32_t* inverse_out, int64_t* uniq_idx_out) {
  std::unordered_map<uint64_t, int32_t> seen;
  seen.reserve(1 << 14);
  int32_t n_uniq = 0;
  for (int64_t k = 0; k < n_spans; ++k) {
    const int64_t s = starts[k];
    const int64_t e = ends[k];
    const int64_t len = e - s;
    uint64_t h = 1469598103934665603ull ^ static_cast<uint64_t>(len);
    for (int64_t j = s; j < e; ++j) h = (h ^ cps[j]) * 1099511628211ull;
    int32_t uid;
    for (;;) {
      auto it = seen.find(h);
      if (it == seen.end()) {
        uid = n_uniq++;
        seen.emplace(h, uid);
        uniq_idx_out[uid] = k;
        break;
      }
      const int32_t cand = it->second;
      const int64_t cs = starts[uniq_idx_out[cand]];
      const int64_t ce = ends[uniq_idx_out[cand]];
      if (ce - cs == len &&
          std::memcmp(cps + cs, cps + s, sizeof(uint32_t) * len) == 0) {
        uid = cand;
        break;
      }
      ++h;
    }
    inverse_out[k] = uid;
  }
  return n_uniq;
}

}  // extern "C"
