"""Corpus -> the trainers' symbol-id tensors.

The reference trains over ``corpus_as_symbols``: one (symbols, frequency)
entry per word type, in first-occurrence order. That order decides
ties between equally frequent pairs, so word types are enumerated in
exactly that order here, as in the JAX package's ``core/corpus.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from .._native import binding
from ..frontend.charclass import to_text
from ..frontend.pretokenize import WordBatch
from .symbols import SymbolTable

PAD = -1


def unique_words(wb: WordBatch) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Word types in first-occurrence order with their frequencies.

    Returns (words, freq i64[n_types], inverse i32[n_words]), where
    ``inverse[i]`` is the type of word occurrence ``i``."""
    cps, ws, we = wb.cps, wb.word_start, wb.word_end
    inverse, uniq_idx = binding.unique_spans(cps, ws, we)
    words = [to_text(cps[ws[i]:we[i]]) for i in uniq_idx]
    freq = np.bincount(inverse, minlength=len(words)).astype(np.int64)
    return words, freq, inverse


@dataclass
class SymbolCorpus:
    """Padded word-type tensor and the symbol table it is written in."""

    sym: np.ndarray          # i32[n_types, max_len], PAD-filled
    freq: np.ndarray         # i64[n_types]
    table: SymbolTable
    words: List[str]         # word types, first-occurrence order


def build_bpe_corpus(words: Sequence[str], freq: np.ndarray,
                     table: SymbolTable) -> SymbolCorpus:
    """BPE's initial state: each word split into its characters, interned
    in scan order."""
    max_len = max((len(w) for w in words), default=1)
    sym = np.full((max(len(words), 1), max_len), PAD, dtype=np.int32)
    for i, w in enumerate(words):
        for j, ch in enumerate(w):
            sym[i, j] = table.intern(ch)
    return SymbolCorpus(sym=sym, freq=np.asarray(freq, dtype=np.int64),
                        table=table, words=list(words))


def build_wp_corpus(words: Sequence[str], freq: np.ndarray,
                    table: SymbolTable) -> SymbolCorpus:
    """WordPiece's initial state: each word's first character bare and
    every later one as ``"##" + ch``, interned in scan order."""
    max_len = max((len(w) for w in words), default=1)
    sym = np.full((max(len(words), 1), max_len), PAD, dtype=np.int32)
    for i, w in enumerate(words):
        for j, ch in enumerate(w):
            sym[i, j] = table.intern(ch if j == 0 else "##" + ch)
    return SymbolCorpus(sym=sym, freq=np.asarray(freq, dtype=np.int64),
                        table=table, words=list(words))
