"""BERT-style pre-tokenization: ``str.lower()`` followed by the split of
HuggingFace's ``BertPreTokenizer.pre_tokenize_str``.

Same output as the JAX package's ``frontend/pretokenize.py``:

1. lower-case with Python's own semantics (a table for every codepoint
   whose lowercase is one codepoint; ``str.lower()`` itself when the text
   holds U+0130 or U+03A3, which lower by context or to two codepoints);
2. split on Unicode White_Space, which is dropped;
3. every punctuation codepoint (ASCII punctuation or general category
   P*) is a word of its own;
4. offsets are codepoint offsets into the lowered text.

The split runs in the C++ front end (``_native/binding``); the port has
no slower NumPy route, so without g++ the first call raises.

Encode takes :func:`pretokenize_batch` (every word occurrence as a span,
which ``core/corpus.unique_words`` maps to its type). Training does not:
it needs only the word types and their counts, which
``core/corpus.train_words`` takes from one threaded native pass over the
sentence list (``_native/count_words.cpp``, the same lowering and
split), and falls back to this module's route for an injected tokenizer
or for U+0130 or U+03A3.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from .._native import binding
from .charclass import codepoints, lower_codepoints, to_text

Token = Tuple[str, Tuple[int, int]]


def split_bounds(cps: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Word (start, end) offsets of one lowered codepoint array."""
    return binding.split_bounds(cps)


def pre_tokenize_str(text: str) -> List[Token]:
    """Lower and pre-split one sentence: ``[(word, (start, end)), ...]``,
    as ``BertPreTokenizer().pre_tokenize_str(text.lower())`` gives it."""
    lowered = text.lower()
    starts, ends = split_bounds(codepoints(lowered))
    return [(lowered[s:e], (s, e))
            for s, e in zip(starts.tolist(), ends.tolist())]


@dataclass
class WordBatch:
    """A pre-tokenized corpus as flat arrays.

    - ``cps``        : uint32[total] codepoints of the lowered corpus,
                       sentences concatenated.
    - ``word_start`` : int64[n_words] offset of each word in ``cps``.
    - ``word_end``   : int64[n_words] end offset (exclusive).
    - ``sent_id``    : int32[n_words] sentence of each word.
    - ``sent_cp_off``: int64[n_sent + 1] offset of each sentence in
                       ``cps``.
    """

    cps: np.ndarray
    word_start: np.ndarray
    word_end: np.ndarray
    sent_id: np.ndarray
    sent_cp_off: np.ndarray

    @property
    def n_words(self) -> int:
        return int(self.word_start.shape[0])

    @property
    def n_sentences(self) -> int:
        return int(self.sent_cp_off.shape[0]) - 1

    def word(self, i: int) -> str:
        return to_text(self.cps[int(self.word_start[i]):
                                int(self.word_end[i])])

    def words(self) -> List[str]:
        return [self.word(i) for i in range(self.n_words)]


def pretokenize_batch(corpus: Sequence[str]) -> WordBatch:
    """Lower and pre-split a whole corpus into a :class:`WordBatch`."""
    cps = lower_codepoints("".join(corpus))
    if cps is not None:
        # The table lowers codepoint for codepoint: lengths are kept.
        sent_lens = np.fromiter((len(s) for s in corpus), dtype=np.int64,
                                count=len(corpus))
    else:
        lowered = [s.lower() for s in corpus]
        cps = codepoints("".join(lowered))
        sent_lens = np.fromiter((len(s) for s in lowered), dtype=np.int64,
                                count=len(lowered))
    sent_cp_off = np.zeros(len(corpus) + 1, dtype=np.int64)
    np.cumsum(sent_lens, out=sent_cp_off[1:])
    word_start, word_end, sent_id = binding.split_corpus(cps, sent_cp_off)
    return WordBatch(cps=cps, word_start=word_start, word_end=word_end,
                     sent_id=sent_id, sent_cp_off=sent_cp_off)
