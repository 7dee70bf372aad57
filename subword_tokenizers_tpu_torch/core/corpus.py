"""Corpus -> the trainers' symbol-id tensors.

The reference trains over ``corpus_as_symbols``: one (symbols, frequency)
entry per word type, in first-occurrence order. That order decides
ties between equally frequent pairs, so word types are enumerated in
exactly that order here, as in the JAX package's ``core/corpus.py``.

Two routes give those word types. Training takes :func:`train_words`:
one threaded native pass from the sentence list to the types and their
counts (``_native/count_words.cpp``), with no corpus-wide arrays.
Encode needs every word occurrence mapped to its type, so it keeps
:func:`unique_words` over ``pretokenize_batch``'s spans, with its
``inverse``; so does training with an injected tokenizer, or with a
codepoint the lowering table cannot lower.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .._native import binding
from ..benchmarks import profiling
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


def train_words(tokenizer, corpus: List[str]
                ) -> Tuple[List[str], np.ndarray]:
    """The trainers' word types in first-occurrence order with their
    frequencies (i64), for ``tokenizer`` (models/base.SubwordTokenizer)
    over ``corpus``.

    The native pass (counted as ``train.frontend.fused``) unless an HF
    tokenizer is injected or the corpus holds U+0130 or U+03A3; those
    take ``unique_words(tokenizer.preprocessing_batch(corpus))``
    (``train.frontend.fallback``). Both give the same words and counts.
    """
    if tokenizer.tokenizer is None:
        got = binding.count_words(corpus)
        if got is not None:
            profiling.count("train.frontend.fused")
            return got
    profiling.count("train.frontend.fallback")
    words, freq, _ = unique_words(tokenizer.preprocessing_batch(corpus))
    return words, freq


@dataclass
class SymbolCorpus:
    """Padded word-type tensor and the symbol table it is written in."""

    sym: np.ndarray          # i32[n_types, max_len], PAD-filled
    freq: np.ndarray         # i64[n_types]
    table: SymbolTable
    words: List[str]         # word types, first-occurrence order


def symbol_lists(sym: np.ndarray, freq: np.ndarray, table: SymbolTable
                 ) -> List[Tuple[List[str], int]]:
    """``corpus_as_symbols`` of a trained state: for each word type, the
    strings of the symbol ids of its row of ``sym`` (PAD left out) and
    its frequency.

    One native pass (``_native/binding.symbol_lists``), counted as
    ``train.symbols.native``, its symbols as ``train.symbols.items``."""
    lists, items = binding.symbol_lists(table.strings(), sym, freq)
    profiling.count("train.symbols.native")
    profiling.count("train.symbols.items", items)
    return lists


def bpe_symbols(word: str, suffix: Optional[str] = None) -> List[str]:
    """BPE's initial symbols of ``word``: its characters, the last one
    followed by ``suffix`` where one is given (GPT-1's ``"</w>"``)."""
    if suffix is None or not word:
        return list(word)
    return list(word[:-1]) + [word[-1] + suffix]


def build_bpe_corpus(words: Sequence[str], freq: np.ndarray,
                     table: SymbolTable, suffix: Optional[str] = None
                     ) -> SymbolCorpus:
    """BPE's initial state: each word split into its initial symbols
    (:func:`bpe_symbols`), interned in scan order. With ``suffix`` the
    distinct suffixed symbols are counted as ``train.eow.symbols``."""
    max_len = max((len(w) for w in words), default=1)
    sym = np.full((max(len(words), 1), max_len), PAD, dtype=np.int32)
    for i, w in enumerate(words):
        for j, s in enumerate(bpe_symbols(w, suffix)):
            sym[i, j] = table.intern(s)
    if suffix is not None:
        profiling.count("train.eow.symbols",
                        len({w[-1] for w in words if w}))
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
