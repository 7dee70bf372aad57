"""BPE tokenizers of the port: NaiveBPE and FastBPE, training and
resources.

``train`` (models/training.py, written once for both models) gives the
JAX package's ``models/bpe.py`` results exactly (``merges_list``,
``vocab``, ``corpus_as_symbols``, ``merges.json``, FastBPE's
``_bpe_ranks``) and raises its errors; FastBPE then ranks the merges
(``train.ranks``).

Encoding gives the JAX package's token lists. ``tokenize`` and
``encode_word`` run on the host (NaiveBPE: the cursor-monotone greedy
loop, which equals applying every merge in order; FastBPE: greedy
lowest rank). ``tokenize_batch``:

1. the C++ front end lowers and pre-splits the corpus, word types are
   deduplicated, and each becomes a row of symbol ids in the rank hash's
   table, unseen characters getting fresh ids (``encode.frontend``);
2. one host-to-device copy (``encode.h2d``); the rank hash itself is
   moved once per merge list (models/state.BPEState);
3. kernel 5 runs every word's merge loop (``encode.bpe_merge``,
   ops/bpe_encode.bpe_encode), kernel 2 writes the dense token stream
   (``encode.compact``, ops/fetch.compact_ids);
4. two device-to-host copies, of the offsets and of the stream
   (``encode.d2h``);
5. the C++ stitch builds the token lists, rendering positions > 0 as
   ``"##" + s`` (``encode.stitch``).

With ``end_of_word_suffix`` (GPT-1's ``"</w>"``, the subword-nmt form)
a word starts as its characters with the suffix on the last one, in
training and in encoding alike (core/corpus.bpe_symbols), and its
tokens are the merged symbols as they are, suffix included, with no
``"##"``: GPT-1's ``TextEncoder.bpe`` and HuggingFace's
``OpenAIGPTTokenizer`` give these. ``merges.json`` keeps its form; its
strings carry the suffix, which the constructor gives. The suffix must
hold a character the BERT pre-tokenizer isolates (punctuation), so no
symbol made of a word's inner characters spells it.

Every batch goes to the kernels, whatever its size. Two routes are the
JAX package's: NaiveBPE with a merge pair listed twice encodes on the
host (``encode.host``), since applying every merge in order is then not
the cursor rule; and FastBPE rows that merge to nothing are assembled on
the host as ``[""]``.

``device="cpu"`` runs the kernels' plain PyTorch versions.

With ``mesh`` (parallel/mesh.py) training shards the word types across
the mesh (models/training.py), with the same merges as one device;
encoding keeps its kernels on the mesh's first device.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._native import binding
from ..benchmarks import profiling
from ..core.corpus import (bpe_symbols, build_bpe_corpus, train_words,
                           unique_words)
from ..core.symbols import SymbolTable
from ..frontend.charclass import PUNCT_HF, codepoints
from ..ops.bpe_encode import SYM_BITS, bpe_encode, build_rank_hash
from .base import SubwordTokenizer, fetch_stream
from .state import BPEState

# Training domain ceiling: per-pair counts, and every sum of them the
# kernels take, stay below 2**52 symbol occurrences (exact in int64 with
# room to spare), as in the JAX package.
MAX_TOKENS_BPE = 1 << 52


def _merge_pass(pair: Tuple[str, str], word: List[str]) -> List[str]:
    """One left-to-right, non-overlapping replacement of ``pair``."""
    merged = pair[0] + pair[1]
    out: List[str] = []
    i, n = 0, len(word)
    while i < n:
        if i < n - 1 and word[i] == pair[0] and word[i + 1] == pair[1]:
            out.append(merged)
            i += 2
        else:
            out.append(word[i])
            i += 1
    return out


def _assemble(encoded: List[List[str]], sent_id: np.ndarray,
              inverse: np.ndarray, n_sentences: int) -> List[List[str]]:
    """Per-sentence token lists from each word type's tokens."""
    out: List[List[str]] = [[] for _ in range(n_sentences)]
    for s, u in zip(sent_id.tolist(), inverse.tolist()):
        out[s].extend(encoded[u])
    return out


def _read_merges(path: str, strict: bool) -> Optional[List[Tuple[str, str]]]:
    """The merges of ``path/merges.json``; None when the file is missing
    and not ``strict``."""
    merges_file = os.path.join(path, "merges.json")
    if not os.path.isfile(merges_file):
        if strict:
            raise FileNotFoundError(merges_file)
        return None
    with open(merges_file, "r", encoding="utf-8") as f:
        return [tuple(pair) for pair in json.load(f)]


def check_suffix(suffix: Optional[str]) -> Optional[str]:
    """``suffix``, an end-of-word suffix or None; raises ValueError for a
    string that holds no character the BERT pre-tokenizer isolates."""
    if suffix is None:
        return None
    if not isinstance(suffix, str):
        raise TypeError("end_of_word_suffix must be a string or None")
    if not any(PUNCT_HF[ord(c)] for c in suffix):
        raise ValueError(f"end_of_word_suffix {suffix!r} holds no "
                         f"punctuation character")
    return suffix


class NaiveBPE(SubwordTokenizer):
    """BPE trained on ``device`` ("cuda" or "cpu"), whose encoder applies
    every merge once, in order. ``tokenizer``: an HF-style pre-tokenizer
    (models/base.py); ``mesh``: a data mesh on ``device``'s type, which
    shards training (parallel/train.py); ``end_of_word_suffix``: None
    (the upstream's form) or the suffix of each word's last symbol
    (GPT-1's ``"</w>"``)."""

    _MONOTONE = True

    def __init__(self, tokenizer: Optional[object] = None,
                 mesh: Optional[object] = None, *, device="cuda",
                 end_of_word_suffix: Optional[str] = None) -> None:
        super().__init__(tokenizer, mesh, device=device)
        self.end_of_word_suffix = check_suffix(end_of_word_suffix)
        self.merges_list: List[Tuple[str, str]] = []
        self._drop_encode_state()

    # ------------------------------------------------------------ training
    # What models/training.py takes from BPE to train it.

    _WORDPIECE = False
    _DOMAIN = (MAX_TOKENS_BPE, "exact-selection")
    _TYPE_ERRORS = ("Corpus must be a list of strings.",
                    "Maximum vocabulary size must be an integer.")
    _LABEL = "Training BPE"
    _LOG = "merges_list"

    def _build_corpus(self, words, freq, table):
        """core/corpus.build_bpe_corpus, with this model's suffix."""
        return build_bpe_corpus(words, freq, table, self.end_of_word_suffix)

    def _train_words(self, corpus: List[str]):
        """core/corpus.train_words, by this module's name for it."""
        return train_words(self, corpus)

    def _save_checkpoint(self) -> None:
        """The training checkpoint: ``merges.json``."""
        self.save_resources(self._checkpoint_dir)

    def _saved_merges(self) -> List[Tuple[str, str]]:
        """The merges of the checkpoint to resume from."""
        return _read_merges(self._resume_dir, strict=True)

    # ------------------------------------------------------------ encoding

    def _drop_encode_state(self) -> None:
        """Forget what encoding derived from the merge list."""
        self._encode_cache: Dict[str, List[str]] = {}
        self._bpe_state: Optional[BPEState] = None
        self._alt_cache = None
        self._host_ranks: Optional[Dict[Tuple[str, str], int]] = None
        self._has_dups: Optional[bool] = None

    def _ranks_first(self) -> Dict[Tuple[str, str], int]:
        """Each merge pair's first rank, cached."""
        if self._host_ranks is None:
            ranks: Dict[Tuple[str, str], int] = {}
            for i, p in enumerate(self.merges_list):
                ranks.setdefault(p, i)
            self._host_ranks = ranks
        return self._host_ranks

    def _rank_map(self) -> Dict[Tuple[str, str], int]:
        """The ranks the device encoder uses."""
        return self._ranks_first()

    def _has_duplicate_merges(self) -> bool:
        if self._has_dups is None:
            self._has_dups = (len(set(self.merges_list))
                              != len(self.merges_list))
        return self._has_dups

    def _encode_symbols(self, word: str) -> List[str]:
        """The cursor-monotone greedy loop: the lowest-ranked pair whose
        rank is at least the cursor, which then moves past it. With a
        pair listed twice, every merge pass in order instead."""
        symbols = bpe_symbols(word, self.end_of_word_suffix)
        if self._has_duplicate_merges():
            for pair in self.merges_list:
                symbols = _merge_pass(pair, symbols)
            return symbols
        ranks = self._ranks_first()
        cursor = 0
        while len(symbols) > 1:
            best = None
            best_rank = None
            for i in range(len(symbols) - 1):
                r = ranks.get((symbols[i], symbols[i + 1]))
                if r is not None and r >= cursor and (
                        best_rank is None or r < best_rank):
                    best_rank, best = r, (symbols[i], symbols[i + 1])
            if best is None:
                break
            symbols = _merge_pass(best, symbols)
            cursor = best_rank + 1
        return symbols

    def _rendered(self, symbols: List[str]) -> List[str]:
        """A word's tokens from its symbols: every one after the first
        with a '##' prefix, or with an end-of-word suffix the symbols as
        they are."""
        if len(symbols) > 1 and self.end_of_word_suffix is None:
            symbols[1:] = ["##" + s for s in symbols[1:]]
        return symbols

    def encode_word(self, word: str) -> List[str]:
        """Encode one word (see :meth:`_rendered`)."""
        return self._rendered(self._encode_symbols(word))

    def _device_tables(self) -> BPEState:
        """The rank hash on ``self.device``, built once per merge list:
        each pair's strings and its merge interned in rank-map order."""
        if self._bpe_state is None:
            table = SymbolTable()
            entries = []  # (key, rank, out_id)
            for (sa, sb), rank in self._rank_map().items():
                a, b = table.intern(sa), table.intern(sb)
                entries.append(((a << SYM_BITS) | b, rank,
                                table.intern(sa + sb)))
            self._bpe_state = BPEState.build(
                table, *build_rank_hash(entries), self.device)
        return self._bpe_state

    @staticmethod
    def _encode_inputs(words: List[str], table: SymbolTable,
                       suffix: Optional[str] = None) -> np.ndarray:
        """int32[W, L] symbol ids of the words' initial symbols
        (core/corpus.bpe_symbols with ``suffix``), PAD-filled, L the
        longest word rounded up to a multiple of 8 (at least 8). Symbols
        the table lacks are interned in order of first occurrence (the
        characters, then the suffixed ones): they take part in no
        merge."""
        W = len(words)
        wlen = np.fromiter(map(len, words), dtype=np.int64, count=W)
        L = -(-max(int(wlen.max()), 2) // 8) * 8
        cps = codepoints("".join(words))

        def interned(cps, spell):
            """The ids of ``spell(c)`` for each codepoint of ``cps``."""
            uniq, first = np.unique(cps, return_index=True)
            ids = np.empty(uniq.shape[0], dtype=np.int32)
            for k in np.argsort(first, kind="stable").tolist():
                ids[k] = table.intern(spell(chr(int(uniq[k]))))
            return ids[np.searchsorted(uniq, cps)]

        sym = np.full((W, L), -1, dtype=np.int32)
        sym[np.arange(L)[None, :] < wlen[:, None]] = interned(cps, str)
        if suffix is not None:
            sym[np.arange(W), wlen - 1] = interned(
                cps[np.cumsum(wlen) - 1], lambda c: c + suffix)
        if len(table) > 1 << SYM_BITS:
            raise ValueError(f"{len(table)} symbols do not fit the "
                             f"{SYM_BITS}-bit pair keys")
        return sym

    def _alt_strings(self, table: SymbolTable) -> Optional[List[str]]:
        """``"##" + s`` per id (the rendering of positions > 0), cached
        per table state; None with an end-of-word suffix, whose tokens
        are the symbols as they are."""
        if self.end_of_word_suffix is not None:
            return None
        key = (id(table), len(table))
        if self._alt_cache is None or self._alt_cache[0] != key:
            self._alt_cache = (key, ["##" + s for s in table.strings()])
        return self._alt_cache[1]

    def tokenize_batch(self, corpus: List[str]) -> List[List[str]]:
        """Tokenize a corpus; equals ``tokenize`` of each sentence. Every
        word type is encoded once, by the kernels on ``self.device``."""
        S = len(corpus)
        dev = self.device
        with profiling.phase("encode.frontend"):
            wb = self.preprocessing_batch(corpus)
            words, _, inverse = unique_words(wb)
            host_route = self._has_duplicate_merges()
            if words and not host_route:
                st = self._device_tables()
                sym = self._encode_inputs(words, st.table,
                                          self.end_of_word_suffix)
        if not words:
            return [[] for _ in range(S)]
        if host_route:
            # Merges listed twice: the exact sequential passes, on the host.
            with profiling.phase("encode.host"):
                encoded = [self.encode_word(w) for w in words]
                return _assemble(encoded, wb.sent_id, inverse, S)
        with profiling.phase("encode.h2d", dev):
            sym_d = torch.from_numpy(sym).to(dev)
        with profiling.phase("encode.bpe_merge", dev):
            merged, out_n = bpe_encode(sym_d, st.hkeys, st.hrank, st.hout,
                                       self._MONOTONE, st.max_probe)
        ids, offs, _ = fetch_stream(merged, out_n)
        starts, counts = offs[:-1], np.diff(offs).astype(np.int32)
        strings = st.table.strings()
        if not self._MONOTONE and not counts.all():
            # FastBPE renders a word that merges to nothing as [""].
            encoded = []
            for b, n in zip(starts.tolist(), counts.tolist()):
                encoded.append(self._rendered(
                    [strings[t] for t in ids[b:b + n].tolist()] or [""]))
            return _assemble(encoded, wb.sent_id, inverse, S)
        bounds = np.searchsorted(wb.sent_id, np.arange(S + 1))
        with profiling.phase("encode.stitch"):
            return binding.stitch_flat(strings, ids, starts, counts,
                                       inverse, bounds,
                                       alt=self._alt_strings(st.table))

    # ------------------------------------------------------------- state io

    def reset(self) -> None:
        """Forget every learned merge, and what encoding derived from
        them."""
        self.merges_list.clear()
        self.vocab.clear()
        self.corpus_as_symbols.clear()
        self._drop_encode_state()

    def save_resources(self, path: str) -> None:
        """Write ``merges.json`` (a JSON list of [a, b] pairs) atomically:
        it doubles as the training checkpoint."""
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, "merges.json")
        tmp = target + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.merges_list, f, ensure_ascii=False)
        os.replace(tmp, target)

    def load_resources(self, path: str, strict: bool = False) -> None:
        """Load ``merges.json``. A missing file is a silent no-op, as in
        the reference; ``strict=True`` raises FileNotFoundError instead."""
        merges = _read_merges(path, strict)
        if merges is not None:
            self.merges_list = merges
            self._drop_encode_state()


class FastBPE(NaiveBPE):
    """BPE whose encoder merges greedily by rank; training is
    NaiveBPE's, and the ranks are kept in ``_bpe_ranks``. As in the JAX
    package (and the reference), ``reset`` keeps ``_bpe_ranks``: the host
    encoder (``tokenize``, ``encode_word``) goes on using the last
    trained or loaded ranks, while ``tokenize_batch`` ranks the current
    ``merges_list``."""

    _MONOTONE = False

    def __init__(self, tokenizer: Optional[object] = None,
                 mesh: Optional[object] = None, *, device="cuda",
                 end_of_word_suffix: Optional[str] = None) -> None:
        super().__init__(tokenizer, mesh, device=device,
                         end_of_word_suffix=end_of_word_suffix)
        self._bpe_ranks: Dict[Tuple[str, str], int] = {}

    def train(self, corpus: List[str], max_vocab: int = 30_000,
              **kwargs) -> None:
        super().train(corpus, max_vocab, **kwargs)
        with profiling.phase("train.ranks"):
            self._bpe_ranks = {pair: i for i, pair in
                               enumerate(self.merges_list)}

    def _rank_map(self) -> Dict[Tuple[str, str], int]:
        """The ranks of ``merges_list`` (a later duplicate overwrites the
        rank), which the device encoder uses."""
        return {pair: i for i, pair in enumerate(self.merges_list)}

    def _has_duplicate_merges(self) -> bool:
        # Greedy encoding uses dict ranks: duplicates change nothing.
        return False

    def _encode_symbols(self, word: str) -> List[str]:
        """Greedy loop: merge the present pair of lowest rank until none
        is left."""
        symbols = bpe_symbols(word, self.end_of_word_suffix)
        if len(symbols) < 2:
            return symbols
        if self._host_ranks is None:
            self._host_ranks = self._bpe_ranks or self._rank_map()
        ranks = self._host_ranks
        while len(symbols) > 1:
            best = None
            best_rank = None
            for i in range(len(symbols) - 1):
                r = ranks.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best = r, (symbols[i], symbols[i + 1])
            if best is None:
                break
            symbols = _merge_pass(best, symbols)
        return symbols

    def encode_word(self, word: str) -> List[str]:
        """As NaiveBPE's, but the empty word encodes as ``[""]``."""
        return super().encode_word(word) or [""]

    def load_resources(self, path: str, strict: bool = False) -> None:
        super().load_resources(path, strict=strict)
        self._bpe_ranks = {pair: i for i, pair in
                           enumerate(self.merges_list)}
        self._host_ranks = None
