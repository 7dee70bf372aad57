"""The upstream's front end, written plainly: ``str.lower()`` of each
sentence, then the BERT pre-tokenizer's split.

The BERT pre-tokenizer (HuggingFace ``tokenizers``, ``BertPreTokenizer``)
drops Unicode White_Space (Rust ``char::is_whitespace``) and isolates
every punctuation character: ASCII punctuation or a character of Unicode
general category P*. Nothing else is changed: no accent stripping, no
control-character removal, no CJK isolation.

Word types are counted in first-occurrence order, which is the order the
trainers scan them in and which decides their ties.
"""
from __future__ import annotations

import string
import sys
import unicodedata
from typing import Dict, Iterable, List, Sequence

# Unicode White_Space, the set Rust's char::is_whitespace tests.
WHITESPACE = "".join(chr(c) for c in (
    *range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
    0x2028, 0x2029, 0x202F, 0x205F, 0x3000))


def _punctuation() -> str:
    chars = set(string.punctuation)
    for cp in range(sys.maxunicode + 1):
        ch = chr(cp)
        if unicodedata.category(ch).startswith("P"):
            chars.add(ch)
    return "".join(sorted(chars - set(WHITESPACE)))


_TABLE = None


def _table():
    """``str.translate`` table: whitespace to a space, punctuation to
    itself between spaces."""
    global _TABLE
    if _TABLE is None:
        _TABLE = {ord(ch): " " for ch in WHITESPACE}
        for ch in _punctuation():
            _TABLE[ord(ch)] = f" {ch} "
    return _TABLE


def words_of(sentence: str) -> List[str]:
    """The words the upstream trains on from one sentence."""
    return [w for w in sentence.lower().translate(_table()).split(" ") if w]


def count_words(sentences: Iterable[str]) -> Dict[str, int]:
    """{word type: occurrences}, in first-occurrence order."""
    counts: Dict[str, int] = {}
    get = counts.get
    for s in sentences:
        for w in words_of(s):
            counts[w] = get(w, 0) + 1
    return counts


def count_drawn(source: Sequence[str], draw: Sequence[int]) -> Dict[str, int]:
    """``count_words([source[i] for i in draw])``, splitting each source
    sentence once and adding its words times the draws that chose it."""
    times: Dict[int, int] = {}
    for i in draw:
        times[i] = times.get(i, 0) + 1
    counts: Dict[str, int] = {}
    get = counts.get
    for i, n in times.items():  # first draws first: first-occurrence order
        for w in words_of(source[i]):
            counts[w] = get(w, 0) + n
    return counts
