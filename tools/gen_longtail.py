"""Generate a long-tailed training corpus from the stand-in corpus.

    python3 tools/gen_longtail.py [--seed 1] [--sentences 160000]
        [--out data/longtail-160k.json]

writes a JSON list of sentences (``data/longtail-160k.json`` with the
defaults; ``data/README.md`` gives its digest). Standard library only;
the input is ``data/train-85k.json``; the same arguments give the same
file.

- The lexicon: its head is the stand-in's word types (as the BERT
  pre-tokenizer splits lower-cased text, ``portbench/reference/
  pretok.py``) other than its punctuation characters, by count, ties in
  first-occurrence order; the rest, up to :data:`LEXICON` words, are
  pseudo-words drawn from a character 4-gram model fitted on those
  types (each type once): at least 2 characters, at most the longest
  type's, each new and unique.
- A sentence takes the frame of a stand-in sentence drawn by the seed:
  its whitespace and punctuation as they stand, each word run between
  them replaced by a lexicon word drawn by Zipf's law (exponent
  :data:`EXPONENT`) over the lexicon's ranks.

So the corpus keeps the stand-in's characters and sentence shapes, and
its word types follow a Zipf tail far beyond the stand-in's 22,971
types: about half of them occur once in a draw of its size.
"""
from __future__ import annotations

import argparse
import functools
import itertools
import json
import os
import random
import sys
from typing import Dict, List, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.reference import pretok  # noqa: E402

SOURCE = os.path.join(ROOT, "data", "train-85k.json")
START, END = "\x02", "\x03"  # the 4-gram model's word boundaries
ORDER = 4
LEXICON = 1_000_000  # words in the lexicon
EXPONENT = 1.1  # Zipf's law over the lexicon's ranks


def frame(sentence: str, punct) -> List[str]:
    """The sentence's frame: the text between its word runs, in order
    (one more piece than runs). A word run is a maximal run of
    characters that are neither whitespace nor punctuation."""
    pieces, cur, in_word = [], [], False
    for ch in sentence:
        word = ch not in pretok.WHITESPACE and ch not in punct
        if word and not in_word:
            pieces.append("".join(cur))
            cur = []
        if not word:
            cur.append(ch)
        in_word = word
    pieces.append("".join(cur))
    return pieces


def head_types(source: Sequence[str], punct) -> List[str]:
    """The stand-in's word types but its punctuation characters, by
    count, ties in first-occurrence order."""
    counts = pretok.count_words(source)
    words = [w for w in counts if not (len(w) == 1 and w in punct)]
    return sorted(words, key=lambda w: -counts[w])  # stable: ties in order


def fit(types: Sequence[str]) -> Dict[str, Tuple[List[str], List[int]]]:
    """The character 4-gram model of ``types``: each context of three
    characters to (next characters, their cumulative counts), in the
    order first met."""
    model: Dict[str, Dict[str, int]] = {}
    for w in types:
        s = START * (ORDER - 1) + w + END
        for i in range(len(s) - ORDER + 1):
            nxt = model.setdefault(s[i:i + ORDER - 1], {})
            ch = s[i + ORDER - 1]
            nxt[ch] = nxt.get(ch, 0) + 1
    return {ctx: (list(nxt), list(itertools.accumulate(nxt.values())))
            for ctx, nxt in model.items()}


def pseudo_word(model, rng: random.Random, longest: int) -> str:
    """One walk of the model from the start, cut off past ``longest``."""
    ctx, out = START * (ORDER - 1), []
    while len(out) <= longest:
        chars, cum = model[ctx]
        ch = rng.choices(chars, cum_weights=cum)[0]
        if ch == END:
            break
        out.append(ch)
        ctx = ctx[1:] + ch
    return "".join(out)


def lexicon(head: Sequence[str], size: int, rng: random.Random
            ) -> List[str]:
    """``head``, then new unique pseudo-words up to ``size`` words."""
    model = fit(head)
    longest = max(len(w) for w in head)
    words = list(head)
    seen = set(words)  # membership only: never iterated
    while len(words) < size:
        w = pseudo_word(model, rng, longest)
        if 2 <= len(w) <= longest and w not in seen:
            seen.add(w)
            words.append(w)
    return words


@functools.lru_cache(maxsize=1)
def stand_in():
    """(the stand-in's sentences, the punctuation characters, the
    lexicon's head), read once a process."""
    with open(SOURCE, encoding="utf-8") as f:
        source = json.load(f)
    punct = frozenset(pretok._punctuation())
    return source, punct, head_types(source, punct)


def generate(seed: int, sentences: int, lexicon_size: int = LEXICON
             ) -> List[str]:
    """The corpus: ``sentences`` sentences of the stand-in's frames with
    Zipf-drawn lexicon words (the tests take a smaller lexicon)."""
    source, punct, head = stand_in()
    rng = random.Random(seed)
    words = lexicon(head, lexicon_size, rng)
    cum = list(itertools.accumulate(
        k ** -EXPONENT for k in range(1, len(words) + 1)))
    frames: Dict[int, List[str]] = {}
    out = []
    for _ in range(sentences):
        i = rng.randrange(len(source))
        pieces = frames.get(i)
        if pieces is None:
            pieces = frames[i] = frame(source[i], punct)
        drawn = rng.choices(words, cum_weights=cum, k=len(pieces) - 1)
        parts = [pieces[0]]
        for w, p in zip(drawn, pieces[1:]):
            parts += (w, p)
        out.append("".join(parts))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--sentences", type=int, default=160_000)
    p.add_argument("--out", default=os.path.join(ROOT, "data",
                                                 "longtail-160k.json"))
    args = p.parse_args(argv)
    corpus = generate(args.seed, args.sentences)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(corpus, f, ensure_ascii=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
