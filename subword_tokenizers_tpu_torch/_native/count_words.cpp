// Training's front end in one native pass: a Python str list -> the word
// types of the BERT pre-tokenizer's split, in first-occurrence order, with
// their counts (core/corpus.train_words).
//
// The same words as pretokenize_batch + unique_words (lowered through the
// LOWER table, split as swt_split_corpus splits), without the corpus-wide
// codepoint, span and inverse arrays those build: each worker lowers,
// splits and counts its own contiguous sentence range into a table keyed
// by content, and the main thread merges the tables in range order. The
// ranges are in corpus order, so the merged types are in global
// first-occurrence order, which decides the trainers' ties.
//
// A LOWER_SPECIAL codepoint (U+0130, U+03A3: Python lowers them to two
// codepoints or by context) aborts the pass with -1, and the caller takes
// the route that lowers with str.lower().
//
// GIL: bound with PYFUNCTYPE, so the GIL stays held while the workers read
// the str buffers snapshotted under it (no Python API in the workers).

#include <Python.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <system_error>
#include <thread>
#include <utility>
#include <vector>

namespace {

inline bool bit(const uint8_t* bits, uint32_t cp) {
  return (bits[cp >> 3] >> (7 - (cp & 7))) & 1;
}

inline uint64_t hash_word(const uint32_t* w, int64_t len) {
  uint64_t h = 1469598103934665603ull;  // FNV-1a over the codepoints
  for (int64_t j = 0; j < len; ++j) h = (h ^ w[j]) * 1099511628211ull;
  return h ^ (h >> 29);
}

// Word types, each stored once in the order first added, with counts.
struct Types {
  std::vector<uint32_t> cps;         // the types' codepoints, concatenated
  std::vector<int64_t> off{0};       // type k is cps[off[k], off[k + 1])
  std::vector<int64_t> count;
  std::vector<uint64_t> hash;
  std::vector<int32_t> slot;         // open addressing: type or -1
  size_t mask = 0;

  void rehash(size_t cap) {
    slot.assign(cap, -1);
    mask = cap - 1;
    for (size_t k = 0; k < hash.size(); ++k) {
      size_t i = hash[k] & mask;
      while (slot[i] >= 0) i = (i + 1) & mask;
      slot[i] = static_cast<int32_t>(k);
    }
  }

  // Adds n occurrences of the word w[0, len) whose hash is h.
  void add(const uint32_t* w, int64_t len, uint64_t h, int64_t n) {
    if (2 * (hash.size() + 1) > slot.size())
      rehash(slot.empty() ? 4096 : 2 * slot.size());
    for (size_t i = h & mask;; i = (i + 1) & mask) {
      const int32_t k = slot[i];
      if (k < 0) {
        slot[i] = static_cast<int32_t>(hash.size());
        cps.insert(cps.end(), w, w + len);
        off.push_back(static_cast<int64_t>(cps.size()));
        count.push_back(n);
        hash.push_back(h);
        return;
      }
      if (hash[k] == h && off[k + 1] - off[k] == len &&
          std::memcmp(cps.data() + off[k], w,
                      sizeof(uint32_t) * static_cast<size_t>(len)) == 0) {
        count[k] += n;
        return;
      }
    }
  }
};

}  // namespace

extern "C" {

// Returns the number of word types U >= 0 and sets *out to a result that
// swt_count_words_take copies out and frees, and *n_cps_out to the types'
// codepoints in all; or, with *out null:
//   -1  a LOWER_SPECIAL codepoint needs Python's str.lower()
//   -2  sents is not a list of str (the caller raises)
// n_threads workers at most; with exact == 0 one thread below 2^16
// codepoints or fewer than two sentences a thread, else n_threads exactly.
int64_t swt_count_words_mt(PyObject* sents, const uint32_t* lower,
                           const uint8_t* special_bits,
                           const uint8_t* ws_bits,
                           const uint8_t* punct_bits, int64_t n_threads,
                           int64_t exact, void** out, int64_t* n_cps_out) {
  *out = nullptr;
  if (!PyList_Check(sents)) return -2;
  const Py_ssize_t S = PyList_GET_SIZE(sents);
  // Phase 0 (GIL): snapshot each str's buffer and the codepoint offsets.
  std::vector<int> kinds(static_cast<size_t>(S));
  std::vector<const void*> datas(static_cast<size_t>(S));
  std::vector<int64_t> cp_off(static_cast<size_t>(S) + 1, 0);
  for (Py_ssize_t si = 0; si < S; ++si) {
    PyObject* s = PyList_GET_ITEM(sents, si);
    if (!PyUnicode_Check(s)) return -2;
    kinds[si] = PyUnicode_KIND(s);
    datas[si] = PyUnicode_DATA(s);
    cp_off[si + 1] = cp_off[si] + PyUnicode_GET_LENGTH(s);
  }
  const int64_t total = cp_off[S];
  int T = static_cast<int>(n_threads < 1 ? 1 : n_threads);
  if (!exact && (S < 2 * T || total < (1 << 16))) T = 1;

  // Contiguous sentence ranges balanced by codepoint count.
  std::vector<Py_ssize_t> range_end(T);
  {
    Py_ssize_t si = 0;
    for (int t = 0; t < T; ++t) {
      const int64_t target = (total * (t + 1)) / T;
      while (si < S && cp_off[si + 1] <= target) ++si;
      if (si < S && t < T - 1) ++si;
      range_end[t] = (t == T - 1) ? S : si;
    }
  }

  std::vector<Types> local(T);
  std::atomic<bool> special(false);
  auto work = [&](int t) {
    Types& L = local[t];
    std::vector<uint32_t> low;
    const Py_ssize_t s1 = range_end[t];
    for (Py_ssize_t si = (t == 0) ? 0 : range_end[t - 1]; si < s1; ++si) {
      if (special.load(std::memory_order_relaxed)) return;
      const int kind = kinds[si];
      const void* data = datas[si];
      const int64_t n = cp_off[si + 1] - cp_off[si];
      low.resize(static_cast<size_t>(n));
      for (int64_t i = 0; i < n; ++i) {
        const uint32_t cp =
            static_cast<uint32_t>(PyUnicode_READ(kind, data, i));
        if (bit(special_bits, cp)) {
          special.store(true, std::memory_order_relaxed);
          return;
        }
        low[i] = lower[cp];
      }
      // A word is a maximal run that is neither White_Space nor
      // punctuation, or one punctuation codepoint (swt_split_corpus).
      int64_t i = 0;
      while (i < n) {
        const uint32_t cp = low[i];
        if (bit(ws_bits, cp)) {
          ++i;
          continue;
        }
        const int64_t start = i++;
        if (!bit(punct_bits, cp))
          while (i < n && !bit(ws_bits, low[i]) && !bit(punct_bits, low[i]))
            ++i;
        const uint32_t* w = low.data() + start;
        L.add(w, i - start, hash_word(w, i - start), 1);
      }
    }
  };

  if (T == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(T);
    for (int t = 0; t < T; ++t) {
      try {
        threads.emplace_back(work, t);
      } catch (const std::system_error&) {
        work(t);  // no thread to be had: run the range here
      }
    }
    for (auto& th : threads) th.join();
  }
  if (special.load()) return -1;

  // Merge in range order: a type keeps its first range's place.
  Types* merged = new Types(std::move(local[0]));
  for (int t = 1; t < T; ++t) {
    const Types& L = local[t];
    for (size_t k = 0; k < L.hash.size(); ++k)
      merged->add(L.cps.data() + L.off[k], L.off[k + 1] - L.off[k],
                  L.hash[k], L.count[k]);
  }
  *out = merged;
  *n_cps_out = static_cast<int64_t>(merged->cps.size());
  return static_cast<int64_t>(merged->hash.size());
}

// Copies a result of swt_count_words_mt into cps u32[n_cps], off
// i64[U + 1] and counts i64[U], then frees it. With any of the three null
// it only frees.
void swt_count_words_take(void* result, uint32_t* cps, int64_t* off,
                          int64_t* counts) {
  Types* r = static_cast<Types*>(result);
  if (cps != nullptr && off != nullptr && counts != nullptr) {
    std::memcpy(cps, r->cps.data(), sizeof(uint32_t) * r->cps.size());
    std::memcpy(off, r->off.data(), sizeof(int64_t) * r->off.size());
    std::memcpy(counts, r->count.data(), sizeof(int64_t) * r->count.size());
  }
  delete r;
}

}  // extern "C"
