"""Plain BPE with an end-of-word suffix, GPT-1's form: each word starts as
its characters with the suffix on the last one (``"low"`` ->
``["l", "o", "w</w>"]``), as ``openai/finetune-transformer-lm``
``text_utils.py`` ``TextEncoder.bpe`` splits a word
(``tuple(token[:-1]) + (token[-1] + '</w>',)``) and HuggingFace's
``OpenAIGPTTokenizer.bpe`` does.

Training follows the upstream's rules otherwise (``trainer.py``): the
pair of largest count, ties to the pair met first in scan order (word
types in order, then positions left to right), the merged symbol
``a + b`` replacing the pair left to right without overlap, and the
loop runs while the vocabulary (the initial symbols and every merged
string) is smaller than ``max_vocab``.

The pair index is ``trainer.py``'s, kept leaner for BPE: a merge
changes only the pairs beside the positions it merges, so only those
are taken out and put back, and an occurrence's place in its word is
the offset of its first character in the word, which merges elsewhere
in the word leave as it is. ``trainer.train`` on the same words, with
each word's last character renamed to a private one of its own, learns
the same merges and walks the same states
(``portbench/tests/test_pb_eow.py``). The suffix must hold a character
that the BERT pre-tokenizer isolates (punctuation), which no word of two
characters or more holds: a symbol with the suffix then never spells
one without it.

The encoder is GPT-1's: the present pair of lowest rank merged
everywhere in the word, left to right without overlap, until no ranked
pair is left; the tokens are the symbols as they are, suffix included.

Nothing here imports the program.
"""
from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional, Set, Tuple

from . import pretok, trainer


def check_suffix(suffix: str) -> None:
    """Raise ValueError unless ``suffix`` holds a character the BERT
    pre-tokenizer isolates."""
    table = pretok._table()
    if not isinstance(suffix, str) or not any(
            table.get(ord(c), "").strip() == c for c in suffix):
        raise ValueError(f"the end-of-word suffix {suffix!r} holds no "
                         f"punctuation character")


def initial_symbols(word: str, suffix: str) -> List[str]:
    """The word's characters, the last with ``suffix`` appended."""
    return list(word[:-1]) + [word[-1] + suffix] if word else []


def train(word_counts: Dict[str, int], max_vocab: int, suffix: str,
          variant: Optional[str] = None, record_states: bool = False
          ) -> trainer.Trained:
    """BPE on ``word_counts`` ({word type: frequency}, first-occurrence
    order) with ``suffix`` on each word's last character, until the
    vocabulary holds ``max_vocab`` strings or no pair is left.
    ``variant`` (None or ``"pair_order"``) and ``record_states`` as for
    ``trainer.train``."""
    check_suffix(suffix)
    if variant not in (None, "pair_order"):
        raise ValueError("variant must be None or 'pair_order'")
    shift = trainer.SHIFT
    mask = (1 << shift) - 1
    names: List[str] = []
    ids: Dict[str, int] = {}

    def intern(s: str) -> int:
        i = ids.get(s)
        if i is None:
            i = ids[s] = len(names)
            names.append(s)
            if i >> shift:
                raise ValueError("too many symbols for the pair keys")
        return i

    words: List[List[int]] = []  # each word's symbol ids
    offs: List[List[int]] = []   # the offset of each symbol's first character
    wfreq: List[int] = []
    pcount: Dict[int, int] = {}  # pair key -> weighted count
    pwords: Dict[int, Dict[int, int]] = {}  # pair -> {word: occurrences}
    first: Dict[int, Tuple[int, int]] = {}  # pair -> (word, offset) met first
    n_slots = 0
    for wi, (w, f) in enumerate(word_counts.items()):
        word = [intern(s) for s in initial_symbols(w, suffix)]
        words.append(word)
        offs.append(list(range(len(word))))
        wfreq.append(int(f))
        n_slots += len(word)
        for j in range(len(word) - 1):
            k = word[j] << shift | word[j + 1]
            occ = pwords.get(k)
            if occ is None:
                pwords[k] = {wi: 1}
                pcount[k] = f
                first[k] = (wi, j)
            else:
                occ[wi] = occ.get(wi, 0) + 1
                pcount[k] += f

    def key_of(k: int):
        if variant == "pair_order":
            return (-pcount[k], k >> shift, k & mask, k)
        w, off = first[k]
        return (-pcount[k], w, off, k)

    cur = {k: key_of(k) for k in pcount}
    heap = list(cur.values())
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
        if states is not None:
            states.append((n_slots, len(pcount), len(names)))
        a, b = best >> shift, best & mask
        merges.append((names[a], names[b]))
        m = intern(names[a] + names[b])

        changed: Set[int] = set()
        refirst: Set[int] = set()
        for wi in sorted(pwords[best]):
            old, oo, f = words[wi], offs[wi], wfreq[wi]
            new: List[int] = []
            no: List[int] = []
            gone: Set[int] = set()  # old pair indices beside a merge
            made: List[int] = []    # new indices of merged symbols
            i, n = 0, len(old)
            while i < n:
                if i < n - 1 and old[i] == a and old[i + 1] == b:
                    gone.update((i - 1, i, i + 1))
                    made.append(len(new))
                    new.append(m)
                    no.append(oo[i])
                    i += 2
                else:
                    new.append(old[i])
                    no.append(oo[i])
                    i += 1
            n_slots -= n - len(new)
            words[wi], offs[wi] = new, no
            delta: Dict[int, int] = {}
            for j in gone:
                if 0 <= j < n - 1:
                    k = old[j] << shift | old[j + 1]
                    delta[k] = delta.get(k, 0) - 1
                    if first[k] == (wi, oo[j]):
                        refirst.add(k)
            for t in {j for t in made for j in (t - 1, t)}:
                if 0 <= t < len(new) - 1:
                    k = new[t] << shift | new[t + 1]
                    delta[k] = delta.get(k, 0) + 1
                    at = (wi, no[t])
                    got = first.get(k)
                    if got is None or at < got:
                        first[k] = at
            for k, d in delta.items():
                if not d:
                    continue
                changed.add(k)
                occ = pwords.get(k)
                if occ is None:
                    pwords[k] = {wi: d}
                    pcount[k] = d * f
                    continue
                pcount[k] = pcount.get(k, 0) + d * f
                left = occ.get(wi, 0) + d
                if left:
                    occ[wi] = left
                else:
                    del occ[wi]
        for k in refirst:
            occ = pwords.get(k)
            if occ:
                wi = min(occ)
                word, oo = words[wi], offs[wi]
                first[k] = (wi, next(oo[j] for j in range(len(word) - 1)
                                     if word[j] << shift | word[j + 1] == k))
        for k in changed | refirst:
            if not pwords.get(k):
                if k in pwords:
                    del pwords[k], pcount[k], first[k]
                cur.pop(k, None)
                continue
            e = key_of(k)
            if cur.get(k) != e:
                cur[k] = e
                heapq.heappush(heap, e)
    return trainer.Trained(merges=merges, vocab=set(names), states=states,
                           n_final=n_slots)


def train_sentences(sentences: Iterable[str], max_vocab: int, suffix: str,
                    **kw) -> trainer.Trained:
    """:func:`train` on the word types of ``sentences``."""
    return train(pretok.count_words(sentences), max_vocab, suffix, **kw)


def ranks_of(merges: Iterable[Tuple[str, str]]) -> Dict[Tuple[str, str], int]:
    """Each pair's rank, as ``TextEncoder`` builds ``bpe_ranks``
    (``dict(zip(merges, range(len(merges))))``: a later duplicate
    overwrites the rank)."""
    return {tuple(p): i for i, p in enumerate(merges)}


def encode_word(word: str, ranks: Dict[Tuple[str, str], int],
                suffix: str) -> List[str]:
    """GPT-1's ``TextEncoder.bpe`` of one word, as a list of symbols."""
    symbols = initial_symbols(word, suffix)
    while len(symbols) > 1:
        pairs = set(zip(symbols, symbols[1:]))
        best = min(pairs, key=lambda p: ranks.get(p, float("inf")))
        if best not in ranks:
            break
        a, b = best
        out: List[str] = []
        i = 0
        while i < len(symbols):
            if i < len(symbols) - 1 and symbols[i] == a and \
                    symbols[i + 1] == b:
                out.append(a + b)
                i += 2
            else:
                out.append(symbols[i])
                i += 1
        symbols = out
    return symbols


def encode(sentences: Iterable[str], merges: Iterable[Tuple[str, str]],
           suffix: str) -> List[List[str]]:
    """Each sentence's tokens: its words (``pretok.words_of``) encoded by
    :func:`encode_word`, each word type once."""
    ranks = ranks_of(merges)
    memo: Dict[str, List[str]] = {}
    out = []
    for s in sentences:
        toks: List[str] = []
        for w in pretok.words_of(s):
            got = memo.get(w)
            if got is None:
                got = memo[w] = encode_word(w, ranks, suffix)
            toks.extend(got)
        out.append(toks)
    return out
