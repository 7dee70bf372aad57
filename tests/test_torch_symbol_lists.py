"""``core/corpus.symbol_lists``, one native pass
(``_native/stitch.cpp`` ``swt_symbol_lists``), against the element by
element comprehension it replaced, written here as the oracle: equal
lists, each symbol the table's own ``str`` object, the table's strings'
reference counts back where they were once the result is gone, and a
train's counters (one native build, its symbols counted)."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from subword_tokenizers_tpu_torch import FastBPE, FastWP, NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.benchmarks import profiling
from subword_tokenizers_tpu_torch.core.corpus import PAD, symbol_lists
from subword_tokenizers_tpu_torch.core.symbols import SymbolTable

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ASCII, a continuation with a two-byte letter, CJK, an emoji and its
# continuation: the three kinds of str (1, 2 and 4 bytes a codepoint).
UNICODE = ["a", "ab", "##ż", "##b", "日本", "##語", "\U0001F600",
           "##\U0001F600", "x\U0001F600ż"]


def oracle(sym, freq, table):
    return [([table.string(int(s)) for s in row if s >= 0], int(f))
            for row, f in zip(sym, freq)]


def _table(n, strings=None):
    # Strings built at run time, so none of two characters or more is
    # interned or immortal, and their reference counts move.
    strings = strings or ["t" + str(i) for i in range(n)]
    return SymbolTable("".join(list(s)) for s in strings)


def _random(rng, n, L, n_strs, holes):
    """Rows of 0..L ids, PAD at the end, or (``holes``) anywhere."""
    sym = np.full((n, L), PAD, dtype=np.int32)
    for i, k in enumerate(rng.integers(0, L + 1, n)):
        cols = (np.sort(rng.choice(L, k, replace=False)) if holes
                else np.arange(k))
        sym[i, cols] = rng.integers(0, n_strs, k)
    return sym


def _case(name):
    """(sym, freq, table) of one case."""
    rng = np.random.default_rng(sorted(CASES).index(name) + 2861)
    if name == "pad_at_end":
        table = _table(300)
        sym = _random(rng, 2000, 22, 300, holes=False)
        return sym, rng.integers(1, 1000, 2000), table
    if name == "interior_holes":
        table = _table(300)
        sym = _random(rng, 2000, 22, 300, holes=True)
        return sym, rng.integers(1, 1000, 2000), table
    if name == "all_pad_row":
        table = _table(10)
        sym = np.array([[3, 1, PAD], [PAD, PAD, PAD], [PAD, 9, PAD]],
                       dtype=np.int32)
        return sym, np.array([5, 7, 2], dtype=np.int64), table
    if name == "more_rows_than_freqs":
        table = _table(50)
        sym = _random(rng, 40, 6, 50, holes=True)
        return sym, rng.integers(1, 9, 25), table
    if name == "empty_corpus":
        # build_*_corpus of no words: one all-PAD row and no frequency
        return (np.full((1, 1), PAD, dtype=np.int32),
                np.zeros(0, dtype=np.int64), _table(3))
    if name == "freq_above_2_31":
        table = _table(40)
        sym = _random(rng, 64, 8, 40, holes=True)
        freq = rng.integers(2**31, 2**62, 64)
        freq[:3] = [2**31, 2**32 + 1, 2**63 - 1]
        return sym, freq, table
    if name == "unicode_kinds":
        table = _table(0, UNICODE)
        sym = _random(rng, 200, 7, len(UNICODE), holes=True)
        return sym, rng.integers(1, 2**40, 200), table
    if name == "single_column":
        table = _table(20)
        sym = _random(rng, 100, 1, 20, holes=False)
        return sym, rng.integers(0, 3, 100), table
    raise KeyError(name)


def _assert_the_tables_objects(got, sym, strings):
    """Every symbol is the table's own object, every frequency an int."""
    for (symbols, f), row in zip(got, sym):
        assert type(f) is int
        for s, i in zip(symbols, row[row >= 0]):
            assert s is strings[i]


CASES = ("pad_at_end", "interior_holes", "all_pad_row",
         "more_rows_than_freqs", "empty_corpus", "freq_above_2_31",
         "unicode_kinds", "single_column")


@pytest.mark.parametrize("name", CASES)
def test_symbol_lists_equal_the_comprehension(name):
    sym, freq, table = _case(name)
    want = oracle(sym, freq, table)
    strings = table.strings()
    watched = [s for s in dict.fromkeys(
        table.string(int(i)) for i in sym.ravel() if i >= 0)
        if len(s) > 1][:5]
    before = [sys.getrefcount(s) for s in watched]
    profiling.reset()
    try:
        got = symbol_lists(sym, freq, table)
        counted = profiling.counters("train.symbols.")
    finally:
        profiling.reset()
    assert got == want
    assert len(got) == min(len(sym), len(freq))
    _assert_the_tables_objects(got, sym, strings)
    live = int(np.count_nonzero(sym[:len(got)] >= 0))
    assert counted == {"train.symbols.native": 1,
                       "train.symbols.items": live}
    held = [sys.getrefcount(s) for s in watched]
    assert all(h > b for h, b in zip(held, before))
    del got
    assert [sys.getrefcount(s) for s in watched] == before


def test_an_id_past_the_table_raises():
    table = _table(4)
    sym = np.array([[0, 1, PAD], [2, 4, 3]], dtype=np.int32)
    watched = [table.string(i) for i in range(4)]
    before = [sys.getrefcount(s) for s in watched]
    with pytest.raises(ValueError, match="out of range"):
        symbol_lists(sym, np.array([1, 2], dtype=np.int64), table)
    # the first row's list and tuple were released with the rest
    assert [sys.getrefcount(s) for s in watched] == before


@pytest.mark.parametrize("cls", [NaiveBPE, FastBPE, NaiveWP, FastWP],
                         ids=lambda c: c.__name__)
def test_a_train_builds_its_symbol_lists_natively_once(cls):
    """A small CPU train counts one native build, whose symbols are the
    non-PAD ids of the final state's rows that have a frequency: the
    symbols of ``corpus_as_symbols``."""
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        corpus = json.load(f)[:200]
    profiling.reset()
    try:
        tok = cls(device="cpu")
        tok.train(corpus, 180)
        counted = profiling.counters("train.symbols.")
    finally:
        profiling.reset()
    items = sum(len(symbols) for symbols, _ in tok.corpus_as_symbols)
    assert counted == {"train.symbols.native": 1,
                       "train.symbols.items": items}
    assert items > len(tok.corpus_as_symbols) > 0
