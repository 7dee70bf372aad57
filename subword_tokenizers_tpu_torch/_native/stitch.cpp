// Native stitch for the batched encode path: token-id matrix -> Python
// list-of-list-of-str output, in one C pass. Also the trainers' symbol
// lists (swt_symbol_lists), built the same way from the final state.
//
// The Python/NumPy stitch (object fancy-indexing + per-row tolist + per-
// sentence chain) measures as the single largest cost of the whole encode
// path (~45% of wall time on the bench corpus); all it does is build
// PyList/PyUnicode structures, which this does directly.
//
// GIL: the ctypes binding uses PYFUNCTYPE, which does NOT release the GIL
// — required, since this manipulates Python objects throughout.

#include <Python.h>

#include <cstdint>
#include <vector>

extern "C" {

// strs: Python list of str, id -> token string (interned once per model).
// alt_strs: Py_None, or a same-length list used for token positions > 0
// within a row (the BPE '##'-continuation rendering, reference
// source/bpe.py:129-131 — prefixing depends on the position in the word,
// not on the token id).
// out[U, W] token ids per unique chunk row; out_n[U] valid counts.
// inverse[C]: chunk occurrence -> unique row.  bounds[S+1]: chunk ranges
// per sentence.  Returns: list of S lists of str (new reference), or
// NULL with an exception set.
PyObject* swt_stitch(PyObject* strs, PyObject* alt_strs, const int32_t* out,
                     const int32_t* out_n, int64_t U, int64_t W,
                     const int32_t* inverse, const int64_t* bounds,
                     int64_t S) {
  if (!PyList_Check(strs)) {
    PyErr_SetString(PyExc_TypeError, "strs must be a list");
    return nullptr;
  }
  const Py_ssize_t n_strs = PyList_GET_SIZE(strs);
  const bool has_alt = alt_strs != Py_None;
  if (has_alt && (!PyList_Check(alt_strs)
                  || PyList_GET_SIZE(alt_strs) != n_strs)) {
    PyErr_SetString(PyExc_TypeError,
                    "alt_strs must be None or a list of len(strs)");
    return nullptr;
  }

  PyObject* result = PyList_New(S);
  if (result == nullptr) return nullptr;

  for (int64_t s = 0; s < S; ++s) {
    int64_t total = 0;
    for (int64_t c = bounds[s]; c < bounds[s + 1]; ++c) {
      total += out_n[inverse[c]];
    }
    PyObject* row = PyList_New(total);
    if (row == nullptr) {
      Py_DECREF(result);
      return nullptr;
    }
    int64_t k = 0;
    for (int64_t c = bounds[s]; c < bounds[s + 1]; ++c) {
      const int64_t u = inverse[c];
      const int32_t* ids = out + u * W;
      const int32_t n = out_n[u];
      for (int32_t j = 0; j < n; ++j) {
        const int32_t id = ids[j];
        if (id < 0 || id >= n_strs) {
          Py_DECREF(row);
          Py_DECREF(result);
          PyErr_Format(PyExc_ValueError,
                       "token id %d out of range [0, %zd)", id, n_strs);
          return nullptr;
        }
        PyObject* src = (has_alt && j > 0) ? alt_strs : strs;
        PyObject* tok = PyList_GET_ITEM(src, id);   // borrowed
        Py_INCREF(tok);
        PyList_SET_ITEM(row, k++, tok);             // steals
      }
    }
    PyList_SET_ITEM(result, s, row);                // steals
  }
  return result;
}

// Flat-stream variant for the compact device fetch path
// (ops/wp_encode_e2e.wp_e2e_scan_u16_stacked): instead of a padded
// [U, W] matrix, token ids arrive as one dense stream with per-unique
// (start, count) spans — the layout the device compaction produces so
// the remote link moves ~10x fewer bytes. Same output contract as
// swt_stitch.
PyObject* swt_stitch_flat(PyObject* strs, PyObject* alt_strs,
                          const int32_t* ids, const int64_t* starts,
                          const int32_t* counts, int64_t n_ids,
                          const int32_t* inverse, const int64_t* bounds,
                          int64_t S) {
  if (!PyList_Check(strs)) {
    PyErr_SetString(PyExc_TypeError, "strs must be a list");
    return nullptr;
  }
  const Py_ssize_t n_strs = PyList_GET_SIZE(strs);
  const bool has_alt = alt_strs != Py_None;
  if (has_alt && (!PyList_Check(alt_strs)
                  || PyList_GET_SIZE(alt_strs) != n_strs)) {
    PyErr_SetString(PyExc_TypeError,
                    "alt_strs must be None or a list of len(strs)");
    return nullptr;
  }

  PyObject* result = PyList_New(S);
  if (result == nullptr) return nullptr;

  for (int64_t s = 0; s < S; ++s) {
    int64_t total = 0;
    for (int64_t c = bounds[s]; c < bounds[s + 1]; ++c) {
      total += counts[inverse[c]];
    }
    PyObject* row = PyList_New(total);
    if (row == nullptr) {
      Py_DECREF(result);
      return nullptr;
    }
    int64_t k = 0;
    for (int64_t c = bounds[s]; c < bounds[s + 1]; ++c) {
      const int64_t u = inverse[c];
      const int64_t st = starts[u];
      const int32_t n = counts[u];
      if (st < 0 || st + n > n_ids) {
        Py_DECREF(row);
        Py_DECREF(result);
        PyErr_Format(PyExc_ValueError,
                     "token span [%lld, %lld) out of stream [0, %lld)",
                     static_cast<long long>(st),
                     static_cast<long long>(st + n),
                     static_cast<long long>(n_ids));
        return nullptr;
      }
      for (int32_t j = 0; j < n; ++j) {
        const int32_t id = ids[st + j];
        if (id < 0 || id >= n_strs) {
          Py_DECREF(row);
          Py_DECREF(result);
          PyErr_Format(PyExc_ValueError,
                       "token id %d out of range [0, %zd)", id, n_strs);
          return nullptr;
        }
        PyObject* src = (has_alt && j > 0) ? alt_strs : strs;
        PyObject* tok = PyList_GET_ITEM(src, id);   // borrowed
        Py_INCREF(tok);
        PyList_SET_ITEM(row, k++, tok);             // steals
      }
    }
    PyList_SET_ITEM(result, s, row);                // steals
  }
  return result;
}

// The trainers' corpus_as_symbols from the final padded state: for each
// of the first min(n, n_freq) rows of sym[n, L] (int32, PAD = -1, which
// may sit anywhere in a row), the tuple (list of str, int): the strings
// of the row's ids >= 0 in column order, each the object strs holds
// (incref'd, no new string), and the row's freq as a Python int. The
// whole list is built here with no Python between rows, so the cyclic
// collector, which 3.12 runs only at the interpreter's next check, sees
// the new containers once afterwards. *n_items receives the symbols
// written. Returns a new list, or NULL with an exception set (ValueError
// for an id past strs, everything built so far released).
PyObject* swt_symbol_lists(PyObject* strs, const int32_t* sym, int64_t n,
                           int64_t L, const int64_t* freq, int64_t n_freq,
                           int64_t* n_items) {
  if (!PyList_Check(strs)) {
    PyErr_SetString(PyExc_TypeError, "strs must be a list");
    return nullptr;
  }
  const Py_ssize_t n_strs = PyList_GET_SIZE(strs);
  const int64_t m = n < n_freq ? n : n_freq;
  PyObject* result = PyList_New(m);
  if (result == nullptr) return nullptr;

  int64_t items = 0;
  for (int64_t r = 0; r < m; ++r) {
    const int32_t* ids = sym + r * L;
    Py_ssize_t live = 0;
    for (int64_t j = 0; j < L; ++j) {
      const int32_t id = ids[j];
      if (id < 0) continue;
      if (id >= n_strs) {
        Py_DECREF(result);
        PyErr_Format(PyExc_ValueError,
                     "symbol id %d out of range [0, %zd)", id, n_strs);
        return nullptr;
      }
      ++live;
    }
    PyObject* row = PyList_New(live);
    PyObject* count = row == nullptr ? nullptr : PyLong_FromLongLong(freq[r]);
    PyObject* pair = count == nullptr ? nullptr : PyTuple_New(2);
    if (pair == nullptr) {
      Py_XDECREF(row);
      Py_XDECREF(count);
      Py_DECREF(result);
      return nullptr;
    }
    Py_ssize_t k = 0;
    for (int64_t j = 0; j < L; ++j) {
      const int32_t id = ids[j];
      if (id < 0) continue;
      PyObject* tok = PyList_GET_ITEM(strs, id);    // borrowed
      Py_INCREF(tok);
      PyList_SET_ITEM(row, k++, tok);               // steals
    }
    PyTuple_SET_ITEM(pair, 0, row);                 // steals
    PyTuple_SET_ITEM(pair, 1, count);               // steals
    PyList_SET_ITEM(result, r, pair);               // steals
    items += live;
  }
  *n_items = items;
  return result;
}

}  // extern "C"
