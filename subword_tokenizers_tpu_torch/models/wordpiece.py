"""WordPiece tokenizers of the port: NaiveWP (training, and greedy
longest-match encode, batched on the device) and FastWP (NaiveWP's
training, then batched end-to-end LinMaxMatch encode on the device).

Outputs equal the JAX package's ``subword_tokenizers_tpu/models/
wordpiece.py`` token for token and merge for merge, and its errors are
raised with the same type, order and text.

``train`` is BPE's, written once (models/training.py), with WordPiece's
three differences: words are interned as their first character and
``"##" + ch`` for every later one; the winner is the pair of largest
score ``count / (freq_a * freq_b)``, compared as the exact double
CPython computes (ops/bitmath.py), over per-symbol weights that kernel
K4 counts once and K3 carries; the merged token is ``a + b[2:]``. Only
the vocabulary is a resource; the merge log is kept for checkpoints
(``wp_state.json``), which resume replays.

NaiveWP's batched encode (``tokenize_batch``):

1. the C++ front end lowers and pre-splits the corpus, word types are
   deduplicated, and each becomes a row of the match trie's alphabet ids
   (``encode.frontend``);
2. one host-to-device copy (``encode.h2d``); the trie's tables and
   kernel 6's step records and '#' jumps are moved once per vocabulary
   (models/state.MatchState);
3. one launch matches every word type, writing ``[UNK]`` (token 0) for
   a word with an unmatched segment, and writes each word's flags byte
   and the dense token stream (``encode.wp_match``,
   ops/wp_encode.wp_match_compact: kernel 6 with kernel 2's compaction
   in its epilogue);
4. two device-to-host copies (``encode.d2h``); a word that overflowed
   raises here;
5. the C++ stitch builds the token lists (``encode.stitch``).

FastWP's batched encode:

1. the C++ front end lowers, splits on whitespace and dedups the
   sentences, and packs the unique chunks into u16 char words
   (``encode.native_prep``, ``encode.pack_u16``);
2. one host-to-device copy (``encode.h2d``);
3. one launch scans every unique chunk and writes each row's flags byte
   and the dense token stream (``encode.scan``,
   ops/wp_encode_e2e.wp_e2e_scan_compact: kernel 1 with kernel 2's
   compaction in its epilogue);
4. two device-to-host copies, of (offsets, total, flags) and then of the
   stream (``encode.d2h``); a set flag raises here;
5. the C++ stitch builds the token lists (``encode.stitch``).

The general route (whole sentences, for a vocab with whitespace in a
token) scans into dense rows (ops/wp_encode.wp_e2e_encode) and compacts
them with kernel 2 (``encode.compact``).

Every batch goes to the kernels, whatever its size. ``device="cpu"``
runs the kernels' plain PyTorch versions.

With ``mesh`` (parallel/mesh.py) training shards the word types as
BPE's does (models/training.py), and FastWP's scan sorts the unique rows
by length (stably), gives each shard a block of them with the trie's
tables on its device (parallel/encode.py), and restores their order
after the fetch. NaiveWP's match keeps its kernels on the mesh's first
device.

The profiling spans of ``train`` are models/training.py's;
FastWP's trie is built in ``train.trie``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._native import binding
from ..benchmarks import profiling
from ..core.corpus import build_wp_corpus, train_words, unique_words
from ..core.symbols import SymbolTable
from ..frontend.charclass import PUNC_PY, WS_PY, codepoints, \
    lower_codepoints
from ..ops.wp_encode import wp_e2e_encode, wp_match_compact
from ..ops.wp_encode_e2e import (pack_chars, route_params,
                                 wp_e2e_scan_compact)
from .base import SubwordTokenizer, fetch_head, fetch_stream
from .state import E2EState, MatchState, e2e_state_from_numpy
from .training import WIDE_SCORE_MIN  # noqa: F401
from .trie import E2ETrie, MatchTrie

# Exact-score domain ceiling: the scorer needs pair counts < 2**53 and
# fa, fb < 2**52, so total symbol occurrences < 2**52, as in the JAX
# package. Below WIDE_SCORE_MIN (2**26, models/training.py) occurrences
# every fa * fb < 2**53 (narrow scores, the only ones the tournament
# takes).
MAX_TOKENS_WP = 1 << 52

UNK = "[UNK]"
UNK_E2E = "['UNK']"  # FastWP's literal quirk, unlike NaiveWP's "[UNK]"

# Pops wider than this take the general route's output width and step
# cap, as the JAX package's routing does.
PACKED_MAX_POPS = 8


class NaiveWP(SubwordTokenizer):
    """WordPiece trained on ``device`` ("cuda" or "cpu"), with greedy
    longest-match word encoding. ``tokenizer``: an HF-style pre-tokenizer
    (models/base.py); ``mesh``: a data mesh on ``device``'s type
    (parallel/mesh.py)."""

    def __init__(self, tokenizer: Optional[object] = None,
                 mesh: Optional[object] = None, *, device="cuda") -> None:
        super().__init__(tokenizer, mesh, device=device)
        self._merge_log: List[Tuple[str, str]] = []
        self._drop_encode_state()

    # ------------------------------------------------------------ training
    # What models/training.py takes from WordPiece to train it.

    _WORDPIECE = True
    _DOMAIN = (MAX_TOKENS_WP, "exact-score")
    _TYPE_ERRORS = ("corpus must be a list of strings.",
                    "max_vocab must be an int.")
    _LABEL = "Training WordPiece"
    _LOG = "_merge_log"
    _build_corpus = staticmethod(build_wp_corpus)

    def _train_words(self, corpus: List[str]):
        """core/corpus.train_words, by this module's name for it."""
        return train_words(self, corpus)

    def _saved_merges(self) -> List[Tuple[str, str]]:
        """The merge log of the checkpoint to resume from."""
        state_file = os.path.join(self._resume_dir, "wp_state.json")
        with open(state_file, "r", encoding="utf-8") as f:
            return [tuple(p) for p in json.load(f)["merges"]]

    def _save_checkpoint(self) -> None:
        """Atomic mid-training checkpoint: ``wp_state.json`` (vocab and
        merge log) and ``vocab.json``."""
        os.makedirs(self._checkpoint_dir, exist_ok=True)
        target = os.path.join(self._checkpoint_dir, "wp_state.json")
        tmp = target + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"vocab": list(self.vocab),
                       "merges": self._merge_log}, f, ensure_ascii=False)
        os.replace(tmp, target)
        self.save_resources(self._checkpoint_dir)

    # ------------------------------------------------------------ encoding

    def encode_word(self, word: str) -> List[str]:
        """Greedy longest-prefix encoding with '##' continuations and
        whole-word "[UNK]". Raises where the remainder would grow one
        '#' per step forever ('#' in the vocab, '##' not)."""
        tokens: List[str] = []
        limit = 4 * len(word) + 64
        steps = 0
        while len(word) > 0:
            steps += 1
            if steps > limit:
                raise RuntimeError(
                    "greedy WordPiece encoding does not terminate on "
                    f"{word[:16]!r}... with this vocabulary (the reference "
                    "implementation would hang here)")
            i = len(word)
            while i > 0 and word[:i] not in self.vocab:
                i -= 1
            if i == 0:
                return [UNK]
            tokens.append(word[:i])
            word = word[i:]
            if len(word) > 0:
                word = f"##{word}"
        return tokens

    def _drop_encode_state(self) -> None:
        """Forget what encoding derived from the vocabulary."""
        self._encode_cache: Dict[str, List[str]] = {}
        self._match_trie: Optional[MatchTrie] = None
        self._match_out: Optional[SymbolTable] = None
        self._match_state: Optional[MatchState] = None

    def _build_match_trie(self) -> Tuple[MatchTrie, SymbolTable]:
        """The match trie of the sorted vocab; "[UNK]" is output id 0."""
        if self._match_trie is None:
            out = SymbolTable()
            out.intern(UNK)
            self._match_trie = MatchTrie.build(sorted(self.vocab), out)
            self._match_out = out
            self._match_state = None
        return self._match_trie, self._match_out

    def _match_device(self) -> MatchState:
        """The match trie's tables on ``self.device``, moved once."""
        trie, _ = self._build_match_trie()
        if self._match_state is None:
            self._match_state = MatchState.build(trie, self.device)
        return self._match_state

    def _match_inputs(self, words: List[str]):
        """(trie, output table, int32[W, L] alphabet ids padded with the
        OOV id, int32[W] lengths), L the longest word rounded up to a
        multiple of 8 (at least 8)."""
        trie, out_table = self._build_match_trie()
        W = len(words)
        wlen = np.fromiter((len(w) for w in words), dtype=np.int32, count=W)
        L = -(-max(2, int(wlen.max()) if W else 1) // 8) * 8
        wmat = np.full((W, L), trie.n_alpha, dtype=np.int32)
        wmat[np.arange(L, dtype=np.int32)[None, :] < wlen[:, None]] = \
            trie.alpha[codepoints("".join(words))]
        return trie, out_table, wmat, wlen

    def tokenize_batch(self, corpus: List[str]) -> List[List[str]]:
        """Tokenize a corpus; equals ``tokenize`` of each sentence. Every
        word type is matched once, by the kernels on ``self.device``."""
        S = len(corpus)
        dev = self.device
        with profiling.phase("encode.frontend"):
            wb = self.preprocessing_batch(corpus)
            words, _, inverse = unique_words(wb)
            if words:
                _, out_table, wmat, wlen = self._match_inputs(words)
        if not words:
            return [[] for _ in range(S)]
        st = self._match_device()
        with profiling.phase("encode.h2d", dev):
            wmat_d = torch.from_numpy(wmat).to(dev)
            wlen_d = torch.from_numpy(wlen).to(dev)
        with profiling.phase("encode.wp_match", dev):
            ids_d, head_d = wp_match_compact(
                wmat_d, wlen_d, st.goto, st.accept, st.hash_aid,
                rec=st.rec, jumps=st.jumps)
        ids, offs, flags = fetch_head(ids_d, head_d)
        if flags.any():
            raise RuntimeError(
                "wp_match_encode overflow: vocabulary drives the greedy "
                "matcher into unbounded '#' growth (the reference would "
                "not terminate on this input)")
        bounds = np.searchsorted(wb.sent_id, np.arange(S + 1))
        with profiling.phase("encode.stitch"):
            return binding.stitch_flat(out_table.strings(), ids, offs[:-1],
                                       np.diff(offs).astype(np.int32),
                                       inverse, bounds)

    # ------------------------------------------------------------- state io

    def reset(self) -> None:
        """Forget the vocabulary, the trained corpus, and what encoding
        derived from them."""
        self.vocab.clear()
        self.corpus_as_symbols.clear()
        self._drop_encode_state()

    def save_resources(self, path: str) -> None:
        """Write ``vocab.json``, a JSON list of the vocabulary, atomically."""
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, "vocab.json")
        tmp = target + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(list(self.vocab), f, ensure_ascii=False)
        os.replace(tmp, target)

    def load_resources(self, path: str, strict: bool = False) -> None:
        """Load ``vocab.json``. A missing file is a silent no-op, as in
        the reference; ``strict=True`` raises FileNotFoundError instead."""
        vocab_file = os.path.join(path, "vocab.json")
        if os.path.isfile(vocab_file):
            with open(vocab_file, "r", encoding="utf-8") as f:
                self.vocab = set(json.load(f))
            self._drop_encode_state()
        elif strict:
            raise FileNotFoundError(vocab_file)


class FastWP(NaiveWP):
    """End-to-end WordPiece: linear-time trie scan with punctuation-aware
    boundaries, batched on ``device`` (or sharded over ``mesh``)."""

    def __init__(self, tokenizer: Optional[object] = None,
                 mesh: Optional[object] = None, *, device="cuda") -> None:
        super().__init__(tokenizer, mesh, device=device)
        self._e2e_trie: Optional[E2ETrie] = None
        self._e2e_out: Optional[SymbolTable] = None
        self._sharp_seq: Optional[Tuple[int, ...]] = None
        self._unk_id: Optional[int] = None
        # (trie, {device: its tables there})
        self._state: Optional[Tuple[E2ETrie, Dict]] = None

    def train(self, corpus: List[str], max_vocab: int = 30_000,
              **kwargs) -> None:
        """NaiveWP's training, then the end-to-end trie of the new vocab."""
        super().train(corpus, max_vocab, **kwargs)
        with profiling.phase("train.trie"):
            self._build_e2e()

    def _build_e2e(self):
        out = SymbolTable()
        self._unk_id = out.intern(UNK_E2E)
        trie = E2ETrie.build(self.vocab, out)
        # NaiveWP's encoding of "##", emitted for a bare "##" segment.
        # None marks a vocab on which it would not terminate: the error
        # then fires only if a scan reaches that case.
        try:
            self._sharp_seq = tuple(out.intern(t)
                                    for t in NaiveWP.encode_word(self, "##"))
        except RuntimeError:
            self._sharp_seq = None
        self._e2e_trie = trie
        self._e2e_out = out
        return trie, out

    def _trie(self):
        if self._e2e_trie is None:
            self._build_e2e()
        return self._e2e_trie, self._e2e_out

    def _device_state(self, device=None) -> E2EState:
        """The trie's tables on ``device`` (default ``self.device``),
        moved once per trie and device."""
        trie, _ = self._trie()
        device = self.device if device is None else device
        if self._state is None or self._state[0] is not trie:
            self._state = (trie, {})
        states = self._state[1]
        if device not in states:
            states[device] = e2e_state_from_numpy(
                trie.goto, trie.alpha, trie.fail, trie.pops_off,
                trie.pops_flat, trie.root_p, trie.root_sharp, self._unk_id,
                self._sharp_seq, device)
        return states[device]

    # ------------------------------------------------------------ encoding

    def tokenize(self, text: str) -> List[str]:
        """Single-sentence end-to-end scan on the host."""
        if not isinstance(text, str):
            raise TypeError("Text to tokenize must be a string.")
        trie, out_table = self._trie()
        s = text.lower() + " "
        cps = codepoints(s)
        n = len(cps)
        is_sp = WS_PY[cps]
        is_pc = PUNC_PY[cps]
        keys, vals = trie.edge_keys, trie.edge_vals
        fail, pops_off, pops_flat = trie.fail, trie.pops_off, trie.pops_flat
        roots = {0, trie.root_sharp, trie.root_p}

        def goto(node: int, cp: int) -> int:
            key = (node << 21) | cp
            j = np.searchsorted(keys, key)
            if j < len(keys) and keys[j] == key:
                return int(vals[j])
            return -1

        def boundary(i: int) -> bool:
            if i > 0 and is_pc[i - 1]:
                return True
            if i >= n:
                # Reachable only when a whitespace-bearing token lets the
                # match loop consume the trailing space.
                raise RuntimeError(
                    "word-boundary check at end of input (the reference "
                    "implementation would crash with IndexError here)")
            return bool(is_sp[i] or is_pc[i])

        result: List[str] = []
        i = 0
        while i < n:
            iter_start = i
            node = 0
            seg: List[int] = []
            while i < n:
                child = goto(node, int(cps[i]))
                while child < 0:
                    f = int(fail[node])
                    if f < 0:
                        break
                    seg.extend(int(t) for t in
                               pops_flat[pops_off[node]:pops_off[node + 1]])
                    node = f
                    child = goto(node, int(cps[i]))
                if child < 0:
                    break
                node = child
                i += 1
            if not boundary(i) or node not in roots:
                seg = [self._unk_id]
            elif node == trie.root_sharp and not seg:
                if self._sharp_seq is None:
                    raise RuntimeError(
                        "encode_word('##') does not terminate with this "
                        "vocabulary (reference would hang on this input)")
                seg = list(self._sharp_seq)
            result.extend(out_table.string(t) for t in seg)
            while i < n and not boundary(i):
                i += 1
            while i < n and is_sp[i]:
                i += 1
            if i == iter_start:
                # A punctuation-class char absent from the trie re-enters
                # the same state forever: the reference hangs here.
                raise RuntimeError(
                    "end-to-end scan makes no progress at "
                    f"{s[i]!r} (position {i}); the reference "
                    "implementation would hang on this input")
        return result

    def tokenize_batch(self, corpus: List[str]) -> List[List[str]]:
        """Batched end-to-end scan on the device.

        No vocab token holds whitespace in real vocabularies, so the
        automaton never crosses a whitespace character: sentences split
        into independent chunks, and only the unique chunks are scanned.
        A vocab with a whitespace-bearing token scans whole sentences.
        """
        trie, _ = self._trie()
        if trie.has_ws_token:
            return self._tokenize_batch_sentences(corpus)
        return self._tokenize_batch_chunked(corpus)

    def _finish_e2e(self, flags: np.ndarray) -> None:
        """Raise the error of the first flag set, over all rows, in the
        order crash, stuck, overflow, '##'; row indices are unique-row
        order."""
        if (flags & 4).any():
            idx = np.flatnonzero(flags & 4)[:5].tolist()
            raise RuntimeError(
                "word-boundary check at end of input on row(s) "
                f"{idx} (the reference implementation would crash with "
                "IndexError here)")
        if (flags & 2).any():
            idx = np.flatnonzero(flags & 2)[:5].tolist()
            raise RuntimeError(
                "end-to-end scan makes no progress on input row(s) "
                f"{idx} — a punctuation-class character absent from the "
                "vocabulary; the reference implementation would hang on "
                "these inputs")
        if (flags & 1).any():
            raise RuntimeError("wp_e2e_encode output buffer overflow")
        if (flags & 8).any():
            raise RuntimeError(
                "encode_word('##') does not terminate with this vocabulary "
                "(reference would hang on this input)")

    def _finish_stream(self, ids, offs, flags):
        """(ids int32[total], starts int64[R], counts int32[R]) of a
        fetched stream, or the scan's error."""
        self._finish_e2e(flags)
        return ids, offs[:-1], np.diff(offs).astype(np.int32)

    def _run_e2e_packed(self, chars: np.ndarray, slen: np.ndarray):
        """Scan rows of packed char words (u16 or i32 [R, Lc]) and
        compact them in one launch, then fetch; see :meth:`_finish_stream`.
        Pops wider than 8 take the general route's parameters."""
        st = self._device_state()
        dev = self.device
        cap, max_steps, unk_ovf = route_params(
            chars.shape[1], general=st.max_pops > PACKED_MAX_POPS)
        if chars.dtype == np.uint16:
            chars = chars.view(np.int16)
        if self.mesh is not None:
            return self._run_e2e_sharded(chars, slen, cap, max_steps,
                                         unk_ovf)
        with profiling.phase("encode.h2d", dev):
            chars_d = torch.from_numpy(chars).to(dev)
            slen_d = torch.from_numpy(slen.astype(np.int32)).to(dev)
        with profiling.phase("encode.scan", dev):
            ids_d, head_d = wp_e2e_scan_compact(
                chars_d, slen_d, st.goto, st.fail, st.pops_off, st.pops_flat,
                st.root_p, st.root_sharp, st.unk_id, st.sharp, cap=cap,
                max_steps=max_steps, unk_ovf=unk_ovf, rec=st.rec)
        return self._finish_stream(*fetch_head(ids_d, head_d))

    def _run_e2e_sharded(self, chars, slen, cap, max_steps, unk_ovf):
        """The packed scan over ``self.mesh``: rows length-sorted
        (stably) so that each shard's block holds rows of like length,
        one fused scan a shard (parallel/encode.py), then each row's
        (start, count) and flags back in the caller's order."""
        from ..parallel.encode import sharded_e2e_scan
        order = np.argsort(slen, kind="stable")
        with profiling.phase("encode.sharded_scan"):
            ids, offs, flags = sharded_e2e_scan(
                self.mesh, chars[order], slen[order], self._device_state,
                cap, max_steps, unk_ovf)
        inv = np.empty_like(order)
        inv[order] = np.arange(order.shape[0])
        self._finish_e2e(flags[inv])
        return ids, offs[:-1][inv], np.diff(offs).astype(np.int32)[inv]

    def _run_e2e(self, cps: np.ndarray, slen: np.ndarray):
        """General route over padded codepoint rows [S, T]: the rows
        form, then kernel 2; see :meth:`_finish_stream`."""
        st = self._device_state()
        dev = self.device
        with profiling.phase("encode.h2d", dev):
            acp, is_sp, is_pc, slen_d = (
                torch.from_numpy(a).to(dev) for a in
                (st.alpha[cps], WS_PY[cps], PUNC_PY[cps],
                 slen.astype(np.int32)))
        with profiling.phase("encode.scan", dev):
            res = wp_e2e_encode(acp, is_sp, is_pc, slen_d, st.goto, st.fail,
                                st.pops_off, st.pops_flat, st.root_p,
                                st.root_sharp, st.unk_id, st.sharp,
                                rec=st.rec)
        return self._finish_stream(*fetch_stream(*res))

    def _tokenize_batch_chunked(self, corpus: List[str]) -> List[List[str]]:
        if len(corpus) == 0:
            return []
        fused = self._try_fused_chunked(corpus)
        if fused is not None:
            return fused
        # Sentence-level dedup: repeated sentences tokenize once, and
        # each duplicate gets its own list (callers may mutate rows).
        seen: Dict[str, int] = {}
        order: List[str] = []
        backmap = np.empty(len(corpus), dtype=np.int64)
        for i, s in enumerate(corpus):
            j = seen.get(s)
            if j is None:
                j = len(order)
                seen[s] = j
                order.append(s)
            backmap[i] = j
        if len(order) < len(corpus):
            uniq = self._tokenize_batch_chunked(order)
            used = np.zeros(len(order), dtype=bool)
            out: List[List[str]] = []
            for j in backmap:
                out.append(list(uniq[j]) if used[j] else uniq[j])
                used[j] = True
            return out

        S = len(corpus)
        flat = lower_codepoints(" ".join(corpus))
        if flat is not None:
            lens = np.fromiter((len(s) for s in corpus), dtype=np.int64,
                               count=S)
        else:
            # U+0130 / U+03A3: Python's own str.lower().
            lowered = [s.lower() for s in corpus]
            flat = codepoints(" ".join(lowered))
            lens = np.fromiter((len(s) for s in lowered), dtype=np.int64,
                               count=S)
        if flat.size == 0:
            return [[] for _ in range(S)]
        sent_start = np.zeros(S, dtype=np.int64)
        np.cumsum(lens[:-1] + 1, out=sent_start[1:])

        inverse, chunk_start, uniq_start, uniq_len = \
            binding.chunk_unique(flat)
        if chunk_start.size == 0:
            return [[] for _ in range(S)]
        sid = np.searchsorted(sent_start, chunk_start, side="right") - 1
        # +2 for the trailing space and the boundary lookback; a multiple
        # of 8, as the JAX package pads (the step cap depends on it).
        Lc = -(-(int(uniq_len.max()) + 2) // 8) * 8
        flatp = np.concatenate([flat, np.full(Lc, 32, np.uint32)])
        take = uniq_start[:, None] + np.arange(Lc, dtype=np.int64)[None, :]
        umask = np.arange(Lc, dtype=np.int32)[None, :] < uniq_len[:, None]
        umat = np.where(umask, flatp[take], np.uint32(32))
        trie, out_table = self._trie()
        pchar = pack_chars(trie.alpha[umat], WS_PY[umat], PUNC_PY[umat])
        ids, starts, counts = self._run_e2e_packed(pchar, uniq_len + 1)
        bounds = np.searchsorted(sid, np.arange(S + 1, dtype=sid.dtype))
        with profiling.phase("encode.stitch"):
            return binding.stitch_flat(out_table.strings(), ids, starts,
                                       counts, inverse, bounds)

    def _try_fused_chunked(self, corpus: List[str]):
        """Fused native chunked encode; None when a precondition fails (an
        alphabet too wide for u16 words, input that is not a list of str,
        or a case-special codepoint that needs Python's ``str.lower()``)."""
        trie, out_table = self._trie()
        if (trie.n_alpha >= (1 << 13)
                or not isinstance(corpus, list)
                or not all(isinstance(s, str) for s in corpus)):
            return None
        with profiling.phase("encode.native_prep"):
            prep = binding.encode_prep(corpus)
        if prep is None:
            return None
        inverse, bounds, uniq_buf, uniq_off, uniq_len = prep
        if uniq_len.size == 0:
            return [[] for _ in range(len(corpus))]
        Lc = -(-(int(uniq_len.max()) + 2) // 8) * 8
        with profiling.phase("encode.pack_u16"):
            mat16 = binding.pack_u16_rows(uniq_buf, uniq_off, uniq_len, Lc,
                                          trie.alpha)
        ids, starts, counts = self._run_e2e_packed(mat16, uniq_len + 1)
        with profiling.phase("encode.stitch"):
            return binding.stitch_flat(out_table.strings(), ids, starts,
                                       counts, inverse, bounds)

    def _tokenize_batch_sentences(self, corpus: List[str]
                                  ) -> List[List[str]]:
        S = len(corpus)
        if S == 0:
            return []
        lowered = [s.lower() + " " for s in corpus]
        flat = codepoints("".join(lowered))
        slen = np.fromiter((len(s) for s in lowered), dtype=np.int32,
                           count=S)
        T = int(slen.max())
        cps = np.full((S, T), 32, dtype=np.uint32)
        cps[np.arange(T, dtype=np.int32)[None, :] < slen[:, None]] = flat
        ids, starts, counts = self._run_e2e(cps, slen)
        _, out_table = self._trie()
        return binding.stitch_flat(out_table.strings(), ids, starts, counts,
                                   np.arange(S, dtype=np.int32),
                                   np.arange(S + 1, dtype=np.int64))

    # ------------------------------------------------------------- state io

    def reset(self) -> None:
        """NaiveWP's reset, and the trie and its device tables go too."""
        super().reset()
        self._e2e_trie = None
        self._e2e_out = None
        self._state = None

    def load_resources(self, path: str, strict: bool = False) -> None:
        """Load the vocab and rebuild the trie."""
        super().load_resources(path, strict=strict)
        self._build_e2e()
