"""Plain BPE and WordPiece training, by the upstream's rules, with a pair
index instead of the upstream's full rescan per merge.

The upstream (phtryll/subword-tokenizers, ``source/bpe.py`` and
``source/wordpiece.py``) trains over ``corpus_as_symbols``: one
(symbols, frequency) entry per word type, in first-occurrence order. Each
merge it counts every adjacent pair inside the words, weighted by the
word's frequency, and picks

- BPE: the pair of largest count (``Counter.most_common(1)``);
- WordPiece: the pair of largest ``count / (freq(a) * freq(b))``, a
  Python float (``max(scores, key=scores.get)``), where ``freq(s)`` is
  the weighted count of symbol ``s``;

and among equals, the pair met first in scan order (word types in order,
then positions left to right). The merged symbol is ``a + b`` (BPE) or
``a + b[2:]`` (WordPiece, whose words start as ``[c0, "##c1", ...]``);
it replaces the pair left to right, without overlap, in every word. The
loop runs while the vocabulary (a set of strings: the initial symbols
and every merged string) is smaller than ``max_vocab``, and stops early
when no pair is left.

Here the counts are kept per pair and changed only in the words a merge
touches, and a heap holds every pair's current key (its score, then its
first word type and position), so each merge costs the words it touches
and the pairs whose key it changes. Keys that went stale stay in the heap
and are skipped when popped.

``variant`` selects a deliberately wrong trainer, the control of the
benchmark's comparison (never used for the reference itself):
``"float32"`` scores WordPiece pairs in float32 instead of the exact
double; ``"pair_order"`` breaks BPE ties by the symbols' ids (the order a
selection over a hash table of pairs would give) instead of scan order.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

SHIFT = 21  # a pair's key is a << SHIFT | b
VARIANTS = (None, "float32", "pair_order")


@dataclass
class Trained:
    """What a train learned: the merges in order, as (a, b) strings, and
    the vocabulary (every symbol string)."""

    merges: List[Tuple[str, str]]
    vocab: Set[str]
    # (live slots, live pairs, symbols) of the state each merge was
    # selected from, when asked for: the work a step must do
    states: Optional[List[Tuple[int, int, int]]] = field(default=None)
    n_final: int = 0  # live slots after the last merge


def _pairs_in(word: List[int]) -> Dict[int, List[int]]:
    """{pair key: [occurrences, first position]} of one word."""
    out: Dict[int, List[int]] = {}
    for i in range(len(word) - 1):
        k = word[i] << SHIFT | word[i + 1]
        e = out.get(k)
        if e is None:
            out[k] = [1, i]
        else:
            e[0] += 1
    return out


def _merge_word(word: List[int], a: int, b: int, m: int) -> List[int]:
    out: List[int] = []
    i, n = 0, len(word)
    while i < n:
        if i < n - 1 and word[i] == a and word[i + 1] == b:
            out.append(m)
            i += 2
        else:
            out.append(word[i])
            i += 1
    return out


def train(word_counts: Dict[str, int], max_vocab: int, wordpiece: bool,
          variant: Optional[str] = None, record_states: bool = False
          ) -> Trained:
    """Train on ``word_counts`` ({word type: frequency}, first-occurrence
    order) until the vocabulary holds ``max_vocab`` strings or no pair is
    left."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    names: List[str] = []
    ids: Dict[str, int] = {}

    def intern(s: str) -> int:
        i = ids.get(s)
        if i is None:
            i = ids[s] = len(names)
            names.append(s)
            if i >> SHIFT:
                raise ValueError("too many symbols for the pair keys")
        return i

    words: List[List[int]] = []
    wfreq: List[int] = []
    for w, f in word_counts.items():
        if wordpiece:
            words.append([intern(c if j == 0 else "##" + c)
                          for j, c in enumerate(w)])
        else:
            words.append([intern(c) for c in w])
        wfreq.append(int(f))

    sfreq: List[int] = [0] * len(names)  # symbol weights (WordPiece)
    pcount: Dict[int, int] = {}
    pwords: Dict[int, Set[int]] = {}
    first: Dict[int, Tuple[int, int]] = {}
    sympairs: Dict[int, Set[int]] = {}
    n_slots = 0
    for wi, word in enumerate(words):
        f = wfreq[wi]
        n_slots += len(word)
        for s in word:
            sfreq[s] += f
        for k, (n, pos) in _pairs_in(word).items():
            if k in pcount:
                pcount[k] += n * f
                pwords[k].add(wi)
            else:
                pcount[k] = n * f
                pwords[k] = {wi}
                first[k] = (wi, pos)
                sympairs.setdefault(k >> SHIFT, set()).add(k)
                sympairs.setdefault(k & ((1 << SHIFT) - 1), set()).add(k)

    mask = (1 << SHIFT) - 1
    f32 = np.float32

    def key_of(k: int):
        c = pcount[k]
        if wordpiece:
            d = sfreq[k >> SHIFT] * sfreq[k & mask]
            score = float(f32(c) / f32(d)) if variant == "float32" else c / d
        else:
            score = c
        w, pos = first[k]
        if variant == "pair_order":
            return (-score, k >> SHIFT, k & mask, k)
        return (-score, w, pos, k)

    cur: Dict[int, tuple] = {}
    heap: List[tuple] = []
    for k in pcount:
        e = cur[k] = key_of(k)
        heap.append(e)
    heapq.heapify(heap)

    merges: List[Tuple[str, str]] = []
    states: Optional[List[Tuple[int, int, int]]] = [] if record_states \
        else None
    while len(names) < max_vocab:
        while heap and cur.get(heap[0][3]) != heap[0]:
            heapq.heappop(heap)
        if not heap:
            break
        best = heapq.heappop(heap)[3]
        del cur[best]
        if states is not None:
            states.append((n_slots, len(pcount), len(names)))
        a, b = best >> SHIFT, best & mask
        sa, sb = names[a], names[b]
        merges.append((sa, sb))
        m = intern(sa + (sb[2:] if wordpiece else sb))
        if m == len(sfreq):
            sfreq.append(0)

        touched: Set[int] = set()
        refirst: Set[int] = set()
        for wi in sorted(pwords[best]):
            old = words[wi]
            new = _merge_word(old, a, b, m)
            f = wfreq[wi]
            n_rep = len(old) - len(new)
            n_slots -= n_rep
            if wordpiece:
                sfreq[a] -= n_rep * f
                sfreq[b] -= n_rep * f
                sfreq[m] += n_rep * f
            po, pn = _pairs_in(old), _pairs_in(new)
            for k in po.keys() | pn.keys():
                eo, en = po.get(k), pn.get(k)
                no = eo[0] if eo else 0
                nn = en[0] if en else 0
                touched.add(k)
                if nn:
                    if no:
                        pcount[k] += (nn - no) * f
                        if first[k][0] == wi:
                            first[k] = (wi, en[1])
                    elif k in pcount:
                        pcount[k] += nn * f
                        pwords[k].add(wi)
                        if wi < first[k][0]:
                            first[k] = (wi, en[1])
                    else:
                        pcount[k] = nn * f
                        pwords[k] = {wi}
                        first[k] = (wi, en[1])
                        sympairs.setdefault(k >> SHIFT, set()).add(k)
                        sympairs.setdefault(k & mask, set()).add(k)
                else:
                    pcount[k] -= no * f
                    pwords[k].discard(wi)
                    if first[k][0] == wi:
                        refirst.add(k)
            words[wi] = new
        for k in refirst:
            if pwords[k]:
                wi = min(pwords[k])
                first[k] = (wi, _pairs_in(words[wi])[k][1])
        if wordpiece:
            for s in (a, b, m):
                touched |= sympairs.get(s, set())
        for k in touched:
            if not pwords.get(k):
                if k in pcount:
                    del pcount[k], pwords[k], first[k]
                    cur.pop(k, None)
                    sympairs[k >> SHIFT].discard(k)
                    sympairs[k & mask].discard(k)
                continue
            e = key_of(k)
            if cur.get(k) != e:
                cur[k] = e
                heapq.heappush(heap, e)
    return Trained(merges=merges, vocab=set(names), states=states,
                   n_final=n_slots)


def train_sentences(sentences: Sequence[str], max_vocab: int,
                    wordpiece: bool, **kw) -> Trained:
    """:func:`train` on the word types of ``sentences``."""
    from .pretok import count_words
    return train(count_words(sentences), max_vocab, wordpiece, **kw)
