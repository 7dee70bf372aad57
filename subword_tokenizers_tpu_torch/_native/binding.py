"""ctypes binding for the native host front end and stitch.

It serves FastWP's encode (``encode_prep``, ``pack_u16_rows``,
``chunk_unique``, the stitches) and its end-to-end trie (``e2e_trie``),
the encoders' front end (``split_bounds``, ``split_corpus``,
``unique_spans``), and the trainers' front end (``count_words``) and
symbol lists (``symbol_lists``).

The C++ sources are this package's own ``_native/{pretok,chunker,stitch,
encode_prep}.cpp`` (copies of the JAX package's, held to it by the
front-end and stitch parity tests, not by bytes) and
``_native/{count_words,e2e_trie}.cpp``, the port's own. They are
compiled with g++ once per source change into ``_native/build/``.
Without g++ the first call raises: the port has no slower host path to
fall back to.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sysconfig
import tempfile
from typing import Optional, Tuple

import numpy as np

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(SRC_DIR, name) for name in
         ("pretok.cpp", "chunker.cpp", "stitch.cpp", "encode_prep.cpp",
          "count_words.cpp", "e2e_trie.cpp")]
BUILD_DIR = os.path.join(SRC_DIR, "build")
_FLAGS = ["-O3", "-march=native", "-pthread", "-shared", "-fPIC",
          "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_tables = {}
_stitch_fn = None
_stitch_flat_fn = None
_symbols_fn = None
_prep_fn = None
_count_fn = None
_trie_fn = None


def _so_path() -> str:
    digest = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as f:
            digest.update(f.read())
    # -march=native bakes in the host's ISA: key on the host too.
    digest.update(platform.machine().encode())
    digest.update(platform.processor().encode())
    digest.update(" ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"native-{digest.hexdigest()[:16]}.so")


def _build(so_path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build into a temp file, then rename: concurrent builds are safe.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", *_FLAGS, f"-I{sysconfig.get_paths()['include']}",
               *_SRCS, "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(
                "g++ is needed to build the native front end") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> ctypes.CDLL:
    """Build (once) and load the native library; raises if it cannot."""
    global _lib, _stitch_fn, _stitch_flat_fn, _symbols_fn, _prep_fn, \
        _count_fn, _trie_fn
    if _lib is not None:
        return _lib
    so_path = _so_path()
    if not os.path.exists(so_path):
        _build(so_path)
    lib = ctypes.CDLL(so_path)
    i64 = ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.swt_split_bounds.restype = i64
    lib.swt_split_bounds.argtypes = [u32p, i64, u8p, u8p, i64p, i64p]
    lib.swt_split_corpus.restype = i64
    lib.swt_split_corpus.argtypes = [u32p, i64p, i64, u8p, u8p, i64p, i64p,
                                     i32p]
    lib.swt_unique_spans.restype = i64
    lib.swt_unique_spans.argtypes = [u32p, i64p, i64p, i64, i32p, i64p]
    lib.swt_chunk_unique.restype = i64
    lib.swt_chunk_unique.argtypes = [u32p, i64, u8p, i32p, i64p, i64p,
                                     i32p, i64p]
    lib.swt_pack_u16.restype = None
    lib.swt_pack_u16.argtypes = [u32p, i64p, i32p, i64, i64, i32p, u8p,
                                 u8p, ctypes.POINTER(ctypes.c_uint16)]
    # These build or read Python objects: PYFUNCTYPE keeps the GIL held.
    _stitch_fn = ctypes.PYFUNCTYPE(
        ctypes.py_object, ctypes.py_object, ctypes.py_object, i32p, i32p,
        i64, i64, i32p, i64p, i64)(("swt_stitch", lib))
    _stitch_flat_fn = ctypes.PYFUNCTYPE(
        ctypes.py_object, ctypes.py_object, ctypes.py_object, i32p, i64p,
        i32p, i64, i32p, i64p, i64)(("swt_stitch_flat", lib))
    _symbols_fn = ctypes.PYFUNCTYPE(
        ctypes.py_object, ctypes.py_object, i32p, i64, i64, i64p, i64,
        i64p)(("swt_symbol_lists", lib))
    _prep_fn = ctypes.PYFUNCTYPE(
        i64, ctypes.py_object, u32p, u8p, u8p, i64, i32p, i64p, u32p,
        i32p, i64p)(("swt_encode_prep_mt", lib))
    _count_fn = ctypes.PYFUNCTYPE(
        i64, ctypes.py_object, u32p, u8p, u8p, u8p, i64, i64,
        ctypes.POINTER(ctypes.c_void_p), i64p)(("swt_count_words_mt", lib))
    lib.swt_count_words_take.restype = None
    lib.swt_count_words_take.argtypes = [ctypes.c_void_p, u32p, i64p, i64p]
    _trie_fn = ctypes.PYFUNCTYPE(
        i64, ctypes.py_object, u8p, u8p, ctypes.POINTER(ctypes.c_void_p),
        i64p)(("swt_e2e_trie_build", lib))
    lib.swt_e2e_trie_take.restype = None
    lib.swt_e2e_trie_take.argtypes = [ctypes.c_void_p, i64p, i32p, i32p,
                                      i32p, i32p, i32p, i32p, i64p]
    from ..frontend.charclass import (ALNUM_PY, LOWER, LOWER_SPECIAL,
                                      PUNC_PY, PUNCT_HF, WS_HF, WS_PY)
    _tables.update(
        ws_hf=np.ascontiguousarray(np.packbits(WS_HF)),
        punct_hf=np.ascontiguousarray(np.packbits(PUNCT_HF)),
        ws_py=np.ascontiguousarray(np.packbits(WS_PY)),
        punc_py=np.ascontiguousarray(np.packbits(PUNC_PY)),
        alnum_py=np.ascontiguousarray(np.packbits(ALNUM_PY)),
        lower_special=np.ascontiguousarray(np.packbits(LOWER_SPECIAL)),
        lower=np.ascontiguousarray(LOWER, dtype=np.uint32))
    _lib = lib
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def split_bounds(cps: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Word (start, end) offsets of one lowered sentence: a word is a
    maximal run of codepoints that are neither White_Space nor
    punctuation, or one punctuation codepoint."""
    lib = load()
    cps = np.ascontiguousarray(cps, dtype=np.uint32)
    n = cps.shape[0]
    starts = np.empty(n, dtype=np.int64)
    ends = np.empty(n, dtype=np.int64)
    count = lib.swt_split_bounds(
        _ptr(cps, ctypes.c_uint32), n, _ptr(_tables["ws_hf"], ctypes.c_uint8),
        _ptr(_tables["punct_hf"], ctypes.c_uint8),
        _ptr(starts, ctypes.c_int64), _ptr(ends, ctypes.c_int64))
    return starts[:count], ends[:count]


def split_corpus(cps: np.ndarray, sent_cp_off: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`split_bounds` over a sentence-concatenated codepoint array.

    Returns (word_start i64, word_end i64, sent_id i32) with offsets into
    ``cps``."""
    lib = load()
    cps = np.ascontiguousarray(cps, dtype=np.uint32)
    sent_cp_off = np.ascontiguousarray(sent_cp_off, dtype=np.int64)
    n_sent = sent_cp_off.shape[0] - 1
    cap = int(sent_cp_off[-1])
    starts = np.empty(cap, dtype=np.int64)
    ends = np.empty(cap, dtype=np.int64)
    sids = np.empty(cap, dtype=np.int32)
    count = lib.swt_split_corpus(
        _ptr(cps, ctypes.c_uint32), _ptr(sent_cp_off, ctypes.c_int64),
        n_sent, _ptr(_tables["ws_hf"], ctypes.c_uint8),
        _ptr(_tables["punct_hf"], ctypes.c_uint8),
        _ptr(starts, ctypes.c_int64), _ptr(ends, ctypes.c_int64),
        _ptr(sids, ctypes.c_int32))
    return starts[:count], ends[:count], sids[:count]


def unique_spans(cps: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Spans of ``cps`` deduplicated by content, in first-occurrence
    order. Returns (inverse i32[n], uniq_idx i64[u]): ``uniq_idx[k]`` is
    the first span with the k-th distinct content."""
    lib = load()
    cps = np.ascontiguousarray(cps, dtype=np.uint32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    n = starts.shape[0]
    inverse = np.empty(n, dtype=np.int32)
    uniq_idx = np.empty(max(n, 1), dtype=np.int64)
    n_uniq = lib.swt_unique_spans(
        _ptr(cps, ctypes.c_uint32), _ptr(starts, ctypes.c_int64),
        _ptr(ends, ctypes.c_int64), n, _ptr(inverse, ctypes.c_int32),
        _ptr(uniq_idx, ctypes.c_int64))
    return inverse, uniq_idx[:n_uniq]


def chunk_unique(cps: np.ndarray):
    """Whitespace-chunk split + content dedup in one native pass.

    Returns (inverse i32[C], chunk_start i64[C], uniq_start i64[U],
    uniq_len i32[U]) over the Python-isspace class.
    """
    lib = load()
    cps = np.ascontiguousarray(cps, dtype=np.uint32)
    n = cps.shape[0]
    cap = max(n // 2 + 2, 4)
    inverse = np.empty(cap, dtype=np.int32)
    chunk_start = np.empty(cap, dtype=np.int64)
    uniq_start = np.empty(cap, dtype=np.int64)
    uniq_len = np.empty(cap, dtype=np.int32)
    n_chunks = np.zeros(1, dtype=np.int64)
    n_uniq = lib.swt_chunk_unique(
        _ptr(cps, ctypes.c_uint32), n, _ptr(_tables["ws_py"], ctypes.c_uint8),
        _ptr(inverse, ctypes.c_int32), _ptr(chunk_start, ctypes.c_int64),
        _ptr(uniq_start, ctypes.c_int64), _ptr(uniq_len, ctypes.c_int32),
        _ptr(n_chunks, ctypes.c_int64))
    c = int(n_chunks[0])
    return (inverse[:c], chunk_start[:c], uniq_start[:n_uniq],
            uniq_len[:n_uniq])


def stitch(strings: list, out_ids: np.ndarray, out_n: np.ndarray,
           inverse: np.ndarray, bounds: np.ndarray,
           alt: Optional[list] = None) -> list:
    """Token-id matrix -> list-of-list-of-str in one native pass.

    ``strings``: id -> token string; ``out_ids`` i32[U, W] with
    ``out_n`` i32[U] valid counts; ``inverse`` i32[C] chunk -> unique row;
    ``bounds`` i64[S+1] chunk ranges per sentence. ``alt``: None, or a
    list as long as ``strings`` whose entries render token positions > 0
    of a row (BPE's ``"##"`` continuations).
    """
    load()
    out_ids = np.ascontiguousarray(out_ids, dtype=np.int32)
    out_n = np.ascontiguousarray(out_n, dtype=np.int32)
    inverse = np.ascontiguousarray(inverse, dtype=np.int32)
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    U, W = out_ids.shape
    return _stitch_fn(strings, alt, _ptr(out_ids, ctypes.c_int32),
                      _ptr(out_n, ctypes.c_int32), U, W,
                      _ptr(inverse, ctypes.c_int32),
                      _ptr(bounds, ctypes.c_int64), bounds.shape[0] - 1)


def stitch_flat(strings: list, ids: np.ndarray, starts: np.ndarray,
                counts: np.ndarray, inverse: np.ndarray,
                bounds: np.ndarray, alt: Optional[list] = None) -> list:
    """Dense token-id stream -> list-of-list-of-str.

    ``ids`` i32[n]; ``starts`` i64[U] / ``counts`` i32[U] are each unique
    row's span in it; ``inverse``/``bounds``/``alt`` as in :func:`stitch`.
    """
    load()
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    inverse = np.ascontiguousarray(inverse, dtype=np.int32)
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    return _stitch_flat_fn(strings, alt, _ptr(ids, ctypes.c_int32),
                           _ptr(starts, ctypes.c_int64),
                           _ptr(counts, ctypes.c_int32), ids.shape[0],
                           _ptr(inverse, ctypes.c_int32),
                           _ptr(bounds, ctypes.c_int64),
                           bounds.shape[0] - 1)


def symbol_lists(strings: list, sym: np.ndarray,
                 freq: np.ndarray) -> Tuple[list, int]:
    """The trainers' ``corpus_as_symbols`` in one native pass
    (``stitch.cpp`` ``swt_symbol_lists``).

    ``strings``: id -> symbol string; ``sym`` i32[n, L], PAD (-1)
    anywhere in a row; ``freq`` i64. Returns (lists, items): for each of
    the first ``min(n, len(freq))`` rows the tuple (the strings of its
    ids >= 0 in column order, each the object ``strings`` holds; its
    frequency), and the number of symbols written. Raises ValueError on
    an id at or past ``len(strings)``.
    """
    load()
    sym = np.ascontiguousarray(sym, dtype=np.int32)
    freq = np.ascontiguousarray(freq, dtype=np.int64)
    n, L = sym.shape
    items = ctypes.c_int64()
    lists = _symbols_fn(strings, _ptr(sym, ctypes.c_int32), n, L,
                        _ptr(freq, ctypes.c_int64), freq.shape[0],
                        ctypes.byref(items))
    return lists, items.value


def encode_prep(sents: list):
    """Fused front end: str list -> lowered unique chunks + stitch metadata.

    One native pass that lowers, splits on whitespace and dedups.
    Returns (inverse i32[C], bounds i64[S+1], uniq_buf u32[total],
    uniq_off i64[U+1], uniq_len i32[U]), or None when a LOWER_SPECIAL
    codepoint (U+0130 / U+03A3) needs Python's own ``str.lower()``.
    """
    load()
    total = sum(map(len, sents))
    S = len(sents)
    cap_chunks = (total + S) // 2 + 2
    inverse = np.empty(cap_chunks, dtype=np.int32)
    bounds = np.empty(S + 1, dtype=np.int64)
    uniq_buf = np.empty(max(total, 1), dtype=np.uint32)
    uniq_len = np.empty(cap_chunks, dtype=np.int32)
    n_chunks = np.zeros(1, dtype=np.int64)
    u = _prep_fn(sents, _ptr(_tables["lower"], ctypes.c_uint32),
                 _ptr(_tables["lower_special"], ctypes.c_uint8),
                 _ptr(_tables["ws_py"], ctypes.c_uint8),
                 os.cpu_count() or 1,
                 _ptr(inverse, ctypes.c_int32),
                 _ptr(bounds, ctypes.c_int64),
                 _ptr(uniq_buf, ctypes.c_uint32),
                 _ptr(uniq_len, ctypes.c_int32),
                 _ptr(n_chunks, ctypes.c_int64))
    if u == -1:
        return None
    if u == -2:
        raise TypeError("encode_prep expects a list of str")
    c = int(n_chunks[0])
    uniq_len = uniq_len[:u]
    uniq_off = np.zeros(u + 1, dtype=np.int64)
    np.cumsum(uniq_len, out=uniq_off[1:])
    return inverse[:c], bounds, uniq_buf, uniq_off, uniq_len


def count_words(sents: list, *, _threads: Optional[int] = None):
    """Training's front end in one threaded native pass: the word types
    of ``sents`` (lowered, split as :func:`split_corpus` splits) in
    first-occurrence order, with their counts.

    Returns (words, freq i64[U]), equal to ``unique_words(
    pretokenize_batch(sents))``'s first two, or None when a
    LOWER_SPECIAL codepoint (U+0130 / U+03A3) needs Python's own
    ``str.lower()``. Raises TypeError unless ``sents`` is a list of str.
    Threads: as many as the process may use, at most 8, and one for a
    small corpus; ``_threads`` (tests) sets the count exactly.
    """
    lib = load()
    if _threads is None:
        n_threads, exact = min(len(os.sched_getaffinity(0)), 8), 0
    else:
        n_threads, exact = _threads, 1
    result = ctypes.c_void_p()
    n_cps = ctypes.c_int64()
    u = _count_fn(sents, _ptr(_tables["lower"], ctypes.c_uint32),
                  _ptr(_tables["lower_special"], ctypes.c_uint8),
                  _ptr(_tables["ws_hf"], ctypes.c_uint8),
                  _ptr(_tables["punct_hf"], ctypes.c_uint8),
                  n_threads, exact, ctypes.byref(result),
                  ctypes.byref(n_cps))
    if u == -1:
        return None
    if u == -2:
        raise TypeError("count_words expects a list of str")
    cps = off = freq = None
    try:
        cps = np.empty(n_cps.value, dtype=np.uint32)
        off = np.empty(u + 1, dtype=np.int64)
        freq = np.empty(u, dtype=np.int64)
    finally:
        # Copies the result out, or with a buffer missing only frees it.
        lib.swt_count_words_take(
            result, None if cps is None else _ptr(cps, ctypes.c_uint32),
            None if off is None else _ptr(off, ctypes.c_int64),
            None if freq is None else _ptr(freq, ctypes.c_int64))
    text = cps.tobytes().decode("utf-32-le")
    bounds = off.tolist()
    words = [text[a:b] for a, b in zip(bounds, bounds[1:])]
    return words, freq


def e2e_trie(vocab: list) -> dict:
    """FastWP's end-to-end trie of ``vocab`` (a list of str, inserted in
    its order after "##") in one native pass (``e2e_trie.cpp``).

    Returns the tables of :class:`models.trie.E2ETrie` under its field
    names, with the pops as ranks (``pops_rank`` i32[n_pops] in place of
    ``pops_flat``): rank k is the k-th ``is_end`` node the level-order
    pass meets, and ``end_token`` i64[n_ends] gives, by rank, the index
    in ``vocab`` of a token that ends there. Raises TypeError unless
    ``vocab`` is a list of str.
    """
    lib = load()
    result = ctypes.c_void_p()
    sizes = np.zeros(8, dtype=np.int64)
    if _trie_fn(vocab, _ptr(_tables["alnum_py"], ctypes.c_uint8),
                _ptr(_tables["ws_py"], ctypes.c_uint8), ctypes.byref(result),
                _ptr(sizes, ctypes.c_int64)) == -2:
        raise TypeError("e2e_trie expects a list of str")
    n, n_edges, n_alpha, n_pops, n_ends, root_sharp, root_p, has_ws = (
        sizes.tolist())
    out = None
    try:
        out = dict(edge_keys=np.empty(n_edges, dtype=np.int64),
                   edge_vals=np.empty(n_edges, dtype=np.int32),
                   fail=np.empty(n, dtype=np.int32),
                   pops_off=np.empty(n + 1, dtype=np.int32),
                   pops_rank=np.empty(n_pops, dtype=np.int32),
                   goto=np.empty((n, n_alpha + 1), dtype=np.int32),
                   alpha=np.empty(0x110000, dtype=np.int32),
                   end_token=np.empty(n_ends, dtype=np.int64))
    finally:
        # Copies the result out (the buffers in the take's order), or with
        # them missing only frees it.
        lib.swt_e2e_trie_take(result, *(
            [None] * 8 if out is None else
            [_ptr(a, ctypes.c_int64 if a.dtype == np.int64 else
                  ctypes.c_int32) for a in out.values()]))
    out.update(n_nodes=n, n_alpha=n_alpha, root_sharp=root_sharp,
               root_p=root_p, has_ws_token=bool(has_ws))
    return out


def pack_u16_rows(uniq_buf: np.ndarray, uniq_off: np.ndarray,
                  uniq_len: np.ndarray, Lc: int,
                  alpha: np.ndarray) -> np.ndarray:
    """Pack unique chunks into u16 char words (see
    ops/wp_encode_e2e.pack_u16), padded with spaces to ``Lc`` columns.
    The caller guarantees the alphabet fits 13 bits."""
    lib = load()
    alpha = np.ascontiguousarray(alpha, dtype=np.int32)
    u = uniq_len.shape[0]
    mat = np.empty((u, Lc), dtype=np.uint16)
    lib.swt_pack_u16(
        _ptr(uniq_buf, ctypes.c_uint32), _ptr(uniq_off, ctypes.c_int64),
        _ptr(uniq_len, ctypes.c_int32), u, Lc,
        _ptr(alpha, ctypes.c_int32), _ptr(_tables["ws_py"], ctypes.c_uint8),
        _ptr(_tables["punc_py"], ctypes.c_uint8),
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    return mat
