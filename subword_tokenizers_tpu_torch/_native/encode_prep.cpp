// Fused host front end for the FastWP chunked batch encoder
// (models/wordpiece.py _tokenize_batch_chunked): Python str list ->
// lowered unique chunks + stitch metadata in ONE native pass.
//
// Replaces, per call: the per-sentence str.lower(), the " ".join, the
// UTF-32 encode, the separate chunk-split/dedup pass, and the
// chunk->sentence searchsorted — together ~40% of warm encode wall time.
// Reads each str's codepoints in place via the PEP 393 kind/data API (no
// intermediate objects); lowering uses the same generated table as the
// vectorized host path (frontend/charclass.py LOWER), with the identical
// fallback contract: any codepoint flagged LOWER_SPECIAL (U+0130, whose
// lower expands to two codepoints, and U+03A3, where CPython applies the
// Final_Sigma context rule) aborts with -1 and the caller falls back to
// exact Python str.lower().
//
// GIL: bound with PYFUNCTYPE (GIL stays held — we read PyUnicode data).

#include <Python.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {
inline bool bit(const uint8_t* bits, uint32_t cp) {
  return (bits[cp >> 3] >> (7 - (cp & 7))) & 1;
}
}  // namespace

extern "C" {

// Returns the number of unique chunks U >= 0, or:
//   -1  a LOWER_SPECIAL codepoint needs the Python lower fallback
//   -2  bad argument (caller raises; no PyErr is set here)
// Outputs:
//   inverse_out  i32[cap_chunks]  chunk occurrence -> unique id
//   bounds_out   i64[S+1]         per-sentence chunk occurrence ranges
//   uniq_buf     u32[total_cps]   concatenated lowered unique chunks
//   uniq_len_out i32[cap_chunks]  per-unique chunk length
//   n_chunks_out i64[1]           total chunk occurrences
int64_t swt_encode_prep(PyObject* sents, const uint32_t* lower,
                        const uint8_t* special_bits, const uint8_t* ws_bits,
                        int32_t* inverse_out, int64_t* bounds_out,
                        uint32_t* uniq_buf, int32_t* uniq_len_out,
                        int64_t* n_chunks_out) {
  if (!PyList_Check(sents)) return -2;
  const Py_ssize_t S = PyList_GET_SIZE(sents);
  std::unordered_map<uint64_t, int32_t> seen;
  seen.reserve(1 << 14);
  std::vector<int64_t> uniq_off;
  uniq_off.reserve(1 << 14);
  uniq_off.push_back(0);
  std::vector<uint32_t> scratch;
  int64_t n_chunks = 0;
  int32_t n_uniq = 0;
  int64_t buf_len = 0;
  bounds_out[0] = 0;
  for (Py_ssize_t si = 0; si < S; ++si) {
    PyObject* s = PyList_GET_ITEM(sents, si);
    if (!PyUnicode_Check(s)) return -2;
    const Py_ssize_t n = PyUnicode_GET_LENGTH(s);
    const int kind = PyUnicode_KIND(s);
    const void* data = PyUnicode_DATA(s);
    scratch.resize(static_cast<size_t>(n));
    for (Py_ssize_t i = 0; i < n; ++i) {
      const uint32_t cp = static_cast<uint32_t>(PyUnicode_READ(kind, data, i));
      if (bit(special_bits, cp)) return -1;
      scratch[static_cast<size_t>(i)] = lower[cp];
    }
    Py_ssize_t i = 0;
    while (i < n) {
      if (bit(ws_bits, scratch[i])) {
        ++i;
        continue;
      }
      const Py_ssize_t cs = i;
      while (i < n && !bit(ws_bits, scratch[i])) ++i;
      const int32_t len = static_cast<int32_t>(i - cs);
      uint64_t h = 1469598103934665603ull;
      for (Py_ssize_t j = cs; j < i; ++j)
        h = (h ^ scratch[j]) * 1099511628211ull;
      int32_t uid;
      for (;;) {
        auto it = seen.find(h);
        if (it == seen.end()) {
          uid = n_uniq++;
          seen.emplace(h, uid);
          std::memcpy(uniq_buf + buf_len, scratch.data() + cs,
                      sizeof(uint32_t) * static_cast<size_t>(len));
          uniq_len_out[uid] = len;
          buf_len += len;
          uniq_off.push_back(buf_len);
          break;
        }
        const int32_t cand = it->second;
        if (uniq_len_out[cand] == len &&
            std::memcmp(uniq_buf + uniq_off[cand], scratch.data() + cs,
                        sizeof(uint32_t) * static_cast<size_t>(len)) == 0) {
          uid = cand;
          break;
        }
        ++h;  // hash collision with different content: re-probe
      }
      inverse_out[n_chunks++] = uid;
    }
    bounds_out[si + 1] = n_chunks;
  }
  *n_chunks_out = n_chunks;
  return n_uniq;
}

// Multithreaded variant of swt_encode_prep for multi-core hosts. Same
// contract and outputs, except unique-chunk NUMBERING is thread-partition
// order instead of global first-occurrence order — internally consistent
// (inverse/uniq_* agree) and invisible downstream: scan rows are
// independent and the stitch maps occurrences through `inverse`.
//
// Threading model: the main thread snapshots each str's PEP 393
// (kind, data, len) under the GIL; workers then only do raw memory reads
// (PyUnicode_READ is a macro over the snapshot — no Python API) plus
// writes into preallocated buffers, so the GIL can stay held by the main
// thread while workers run. Each worker lowers + splits + dedups its own
// contiguous sentence range into thread-local tables; the main thread
// merges the (few) per-thread uniques sequentially and renumbers each
// thread's inverse through a local->global LUT.
int64_t swt_encode_prep_mt(PyObject* sents, const uint32_t* lower,
                           const uint8_t* special_bits,
                           const uint8_t* ws_bits, int64_t n_threads,
                           int32_t* inverse_out, int64_t* bounds_out,
                           uint32_t* uniq_buf, int32_t* uniq_len_out,
                           int64_t* n_chunks_out) {
  if (!PyList_Check(sents)) return -2;
  const Py_ssize_t S = PyList_GET_SIZE(sents);
  // Phase 0 (GIL): snapshot string internals + codepoint offsets.
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
  int T = static_cast<int>(n_threads);
  if (T < 1) T = 1;
  if (T > 16) T = 16;
  if (S < 2 * T || total < (1 << 16)) T = 1;

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

  std::vector<uint32_t> low(static_cast<size_t>(total));
  struct Local {
    std::unordered_map<uint64_t, int32_t> seen;
    std::vector<int64_t> u_start;   // into `low`
    std::vector<int32_t> u_len;
    std::vector<uint64_t> u_hash;
    std::vector<int32_t> chunk_uid; // per chunk occurrence, local ids
    std::vector<int64_t> sent_chunks;  // per sentence in range
  };
  std::vector<Local> locals(T);
  std::atomic<bool> abort_special(false);

  auto work = [&](int t) {
    Local& L = locals[t];
    L.seen.reserve(1 << 12);
    const Py_ssize_t s0 = (t == 0) ? 0 : range_end[t - 1];
    const Py_ssize_t s1 = range_end[t];
    for (Py_ssize_t si = s0; si < s1 && !abort_special.load(
             std::memory_order_relaxed); ++si) {
      const int kind = kinds[si];
      const void* data = datas[si];
      const int64_t base = cp_off[si];
      const Py_ssize_t n = static_cast<Py_ssize_t>(cp_off[si + 1] - base);
      uint32_t* dst = low.data() + base;
      for (Py_ssize_t i = 0; i < n; ++i) {
        const uint32_t cp =
            static_cast<uint32_t>(PyUnicode_READ(kind, data, i));
        if (bit(special_bits, cp)) {
          abort_special.store(true, std::memory_order_relaxed);
          return;
        }
        dst[i] = lower[cp];
      }
      int64_t n_chunks_sent = 0;
      Py_ssize_t i = 0;
      while (i < n) {
        if (bit(ws_bits, dst[i])) {
          ++i;
          continue;
        }
        const Py_ssize_t cs = i;
        while (i < n && !bit(ws_bits, dst[i])) ++i;
        const int32_t len = static_cast<int32_t>(i - cs);
        uint64_t h = 1469598103934665603ull;
        for (Py_ssize_t j = cs; j < i; ++j)
          h = (h ^ dst[j]) * 1099511628211ull;
        int32_t uid;
        for (;;) {
          auto it = L.seen.find(h);
          if (it == L.seen.end()) {
            uid = static_cast<int32_t>(L.u_start.size());
            L.seen.emplace(h, uid);
            L.u_start.push_back(base + cs);
            L.u_len.push_back(len);
            L.u_hash.push_back(h);
            break;
          }
          const int32_t cand = it->second;
          if (L.u_len[cand] == len &&
              std::memcmp(low.data() + L.u_start[cand], dst + cs,
                          sizeof(uint32_t) * static_cast<size_t>(len))
                  == 0) {
            uid = cand;
            break;
          }
          ++h;  // hash collision with different content: re-probe
        }
        L.chunk_uid.push_back(uid);
        ++n_chunks_sent;
      }
      L.sent_chunks.push_back(n_chunks_sent);
    }
  };

  if (T == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(T);
    for (int t = 0; t < T; ++t) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  if (abort_special.load()) return -1;

  // Merge (sequential): global dedup over the per-thread uniques.
  std::unordered_map<uint64_t, int32_t> seen;
  seen.reserve(1 << 14);
  std::vector<int64_t> uniq_off;
  uniq_off.reserve(1 << 14);
  uniq_off.push_back(0);
  int32_t n_uniq = 0;
  int64_t buf_len = 0;
  int64_t n_chunks = 0;
  bounds_out[0] = 0;
  Py_ssize_t si_global = 0;
  for (int t = 0; t < T; ++t) {
    Local& L = locals[t];
    std::vector<int32_t> remap(L.u_start.size());
    for (size_t u = 0; u < L.u_start.size(); ++u) {
      const int32_t len = L.u_len[u];
      const uint32_t* src = low.data() + L.u_start[u];
      uint64_t h = L.u_hash[u];
      int32_t gid;
      for (;;) {
        auto it = seen.find(h);
        if (it == seen.end()) {
          gid = n_uniq++;
          seen.emplace(h, gid);
          std::memcpy(uniq_buf + buf_len, src,
                      sizeof(uint32_t) * static_cast<size_t>(len));
          uniq_len_out[gid] = len;
          buf_len += len;
          uniq_off.push_back(buf_len);
          break;
        }
        const int32_t cand = it->second;
        if (uniq_len_out[cand] == len &&
            std::memcmp(uniq_buf + uniq_off[cand], src,
                        sizeof(uint32_t) * static_cast<size_t>(len)) == 0) {
          gid = cand;
          break;
        }
        ++h;
      }
      remap[u] = gid;
    }
    int64_t ci = 0;
    for (size_t k = 0; k < L.sent_chunks.size(); ++k) {
      for (int64_t c = 0; c < L.sent_chunks[k]; ++c)
        inverse_out[n_chunks++] = remap[L.chunk_uid[ci++]];
      bounds_out[++si_global] = n_chunks;
    }
  }
  *n_chunks_out = n_chunks;
  return n_uniq;
}

// Pack unique chunks straight into the u16 wire matrix consumed by
// ops/wp_encode_e2e.wp_e2e_scan_u16: aid | sp<<13 | pc<<14 | prev_pc<<15,
// one trailing space plus space padding (cp 32), exactly matching
// pack_chars + pack_u16 on the padded codepoint matrix. Caller guarantees
// the alphabet fits 13 bits.
void swt_pack_u16(const uint32_t* uniq_buf, const int64_t* uniq_off,
                  const int32_t* uniq_len, int64_t U, int64_t Lc,
                  const int32_t* alpha, const uint8_t* ws_bits,
                  const uint8_t* punc_bits, uint16_t* mat) {
  const bool sp_is_punc = bit(punc_bits, 32u);  // false by construction
  const uint16_t pad_word =
      static_cast<uint16_t>(alpha[32] | (bit(ws_bits, 32u) ? 1u << 13 : 0) |
                            (sp_is_punc ? 1u << 14 : 0));
  for (int64_t u = 0; u < U; ++u) {
    uint16_t* row = mat + u * Lc;
    const uint32_t* cps = uniq_buf + uniq_off[u];
    const int32_t len = uniq_len[u];
    bool prev_pc = false;
    int64_t j = 0;
    for (; j < len; ++j) {
      const uint32_t cp = cps[j];
      const bool pc = bit(punc_bits, cp);
      row[j] = static_cast<uint16_t>(
          alpha[cp] | (bit(ws_bits, cp) ? 1u << 13 : 0) |
          (pc ? 1u << 14 : 0) | (prev_pc ? 1u << 15 : 0));
      prev_pc = pc;
    }
    // first padding cell carries the last content char's prev_pc bit
    if (j < Lc) {
      row[j] = static_cast<uint16_t>(pad_word | (prev_pc ? 1u << 15 : 0));
      ++j;
    }
    for (; j < Lc; ++j) row[j] = pad_word;
  }
}

}  // extern "C"
