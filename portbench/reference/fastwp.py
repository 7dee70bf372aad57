"""The upstream's FastWordPiece encoder, written plainly: LinMaxMatch,
the end-to-end WordPiece scan over a trie with failure links and pops
(Song et al., "Fast WordPiece Tokenization", 2021), by the upstream's
rules (phtryll/subword-tokenizers ``source/utils.py`` builds the trie,
``source/wordpiece.py`` ``FastWordPiece.tokenize`` scans):

- the trie holds ``"##"`` and every vocabulary entry; three roots: the
  root, ``root_sharp`` (the ``"##"`` node, where a word continues) and
  ``root_p`` (a node of its own, no edges, where a punctuation character
  fails to);
- failure links and pops in level order from the root and ``root_sharp``:
  a node that ends an entry fails to ``root_sharp`` and pops its entry;
  any other node fails where its parent's failure chain first has an
  edge for its character, and pops the parent's pops and those met on
  the chain; a node whose character is not ``str.isalnum()`` then fails
  to ``root_p``, keeping its pops;
- the scan is over ``text.lower() + " "``: from the root, follow edges,
  and where none, emit the node's pops and follow its failure link; the
  segment stands if it ends at a word boundary (a punctuation character
  before it, or a space or punctuation character at it) on one of the
  three roots, else it is the literal ``"['UNK']"``; a segment that ends
  on ``root_sharp`` having popped nothing is the greedy encoding of
  ``"##"``; then skip to the next boundary and over whitespace.
  Punctuation here is neither ``str.isalnum()`` nor ``str.isspace()``;
- where the upstream would hang (a punctuation character absent from the
  trie re-enters the same state; a greedy ``"##"`` that never ends) or
  crash (a boundary check past the end), this raises ``RuntimeError``.

A vocabulary without whitespace in any entry never lets the scan cross
a space, and the scan restarts at the root after one, so a sentence's
tokens are those of its whitespace-separated chunks, each scanned alone
(as ``chunk + " "``) once and remembered. A vocabulary with whitespace in
an entry scans whole sentences.

Nothing here imports the program: this is the yardstick the benchmark
holds the port's ``FastWP.tokenize_batch`` to.
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict, Iterable, List, Optional, Tuple

UNK = "['UNK']"         # the upstream's literal, for an invalid segment
GREEDY_UNK = "[UNK]"    # the greedy encoder's, for "##" alone


def digest(token_lists: List[List[str]]) -> str:
    """sha256 of the token lists as JSON (UTF-8, not ASCII-escaped)."""
    return hashlib.sha256(json.dumps(token_lists, ensure_ascii=False)
                          .encode("utf-8")).hexdigest()


def _is_punc(c: str) -> bool:
    return not c.isalnum() and not c.isspace()


class FastWordPiece:
    """The LinMaxMatch automaton of ``vocab`` (an iterable of strings)."""

    def __init__(self, vocab: Iterable[str]) -> None:
        self.vocab = set(vocab)
        self.children: List[Dict[str, int]] = [{}]
        self.string: List[str] = [""]
        self.is_end: List[bool] = [False]
        self.root_sharp = self._insert("##")
        for tok in sorted(self.vocab):
            self._insert(tok)
        self.root_p = len(self.children)
        self.children.append({})
        self.string.append("")
        self.is_end.append(False)
        n = len(self.children)
        self.fail: List[Optional[int]] = [None] * n
        self.pops: List[List[str]] = [[] for _ in range(n)]
        queue = [0, self.root_sharp]
        for cur in queue:  # grows while read: level order
            for c, child in self.children[cur].items():
                if child == self.root_sharp:
                    continue
                if self.is_end[child]:
                    self.fail[child] = self.root_sharp
                    self.pops[child] = [self.string[child]]
                else:
                    f, met = self.fail[cur], []
                    while f is not None and c not in self.children[f]:
                        met += self.pops[f]
                        f = self.fail[f]
                    if f is not None:
                        self.fail[child] = self.children[f][c]
                        self.pops[child] = self.pops[cur] + met
                if not c.isalnum():
                    self.fail[child] = self.root_p
                queue.append(child)
        self.roots = {0, self.root_sharp, self.root_p}
        self.has_space = any(c.isspace() for t in self.vocab for c in t)
        self._sharp: Optional[List[str]] = None
        self._memo: Dict[str, Tuple[List[str], int]] = {}

    def _insert(self, word: str) -> int:
        node = 0
        for c in word:
            nxt = self.children[node].get(c)
            if nxt is None:
                nxt = len(self.children)
                self.children[node][c] = nxt
                self.children.append({})
                self.string.append(self.string[node] + c)
                self.is_end.append(False)
            node = nxt
        self.is_end[node] = True
        return node

    def greedy(self, word: str) -> List[str]:
        """The upstream's greedy longest-prefix WordPiece of one word."""
        tokens: List[str] = []
        for _ in range(4 * len(word) + 64):
            if not word:
                return tokens
            i = len(word)
            while i > 0 and word[:i] not in self.vocab:
                i -= 1
            if i == 0:
                return [GREEDY_UNK]
            tokens.append(word[:i])
            word = word[i:]
            if word:
                word = "##" + word
        raise RuntimeError("the greedy encoding of '##' does not end with "
                           "this vocabulary (the upstream would hang)")

    def walk(self, s: str, looked: Optional[set] = None
             ) -> Tuple[List[str], int]:
        """(tokens, steps) of the scan over ``s``, already lowered and
        ending in a space. A step is one edge looked up at a node: an
        edge followed, a failure link followed, or the last look-up that
        ends a segment's match. ``looked`` gathers each step's (node,
        character)."""
        n, out, steps, i = len(s), [], 0, 0

        def boundary(j: int) -> bool:
            if j > 0 and _is_punc(s[j - 1]):
                return True
            if j >= n:
                raise RuntimeError("a word-boundary check past the end of "
                                   "the input (the upstream would crash)")
            return s[j].isspace() or _is_punc(s[j])

        while i < n:
            start, node, seg = i, 0, []
            while i < n:
                while True:
                    steps += 1
                    if looked is not None:
                        looked.add((node, s[i]))
                    child = self.children[node].get(s[i])
                    if child is not None or self.fail[node] is None:
                        break
                    seg += self.pops[node]
                    node = self.fail[node]
                if child is None:
                    break
                node, i = child, i + 1
            if not boundary(i) or node not in self.roots:
                seg = [UNK]
            elif node == self.root_sharp and not seg:
                if self._sharp is None:
                    self._sharp = self.greedy("##")
                seg = list(self._sharp)
            out += seg
            while i < n and not boundary(i):
                i += 1
            while i < n and s[i].isspace():
                i += 1
            if i == start:
                raise RuntimeError(f"the scan makes no progress at {s[i]!r}"
                                   " (the upstream would hang)")
        return out, steps

    def chunk(self, chunk: str) -> Tuple[List[str], int]:
        """(tokens, steps) of one lowered chunk without whitespace, scanned
        as ``chunk + " "``; remembered."""
        got = self._memo.get(chunk)
        if got is None:
            got = self._memo[chunk] = self.walk(chunk + " ")
        return got

    def tokenize(self, text: str) -> List[str]:
        """The upstream's ``FastWordPiece.tokenize(text)``."""
        s = text.lower()
        if self.has_space:
            return self.walk(s + " ")[0]
        out: List[str] = []
        for c in s.split():
            out += self.chunk(c)[0]
        return out

    def tokenize_batch(self, texts: Iterable[str]) -> List[List[str]]:
        return [self.tokenize(t) for t in texts]


def scan_rows(fwp: FastWordPiece, texts: Iterable[str]) -> Dict[str, int]:
    """The work of one scan of each distinct lowered chunk of ``texts``,
    each with its trailing space, as a batched encode that scans each
    distinct chunk once must do it: ``rows``, their ``chars`` (the space
    included), ``steps``, ``tokens`` emitted, and the distinct ``nodes``
    and (node, character) ``edges`` looked up."""
    looked: set = set()
    rows = chars = steps = tokens = 0
    seen = set()
    for t in texts:
        for c in t.lower().split():
            if c not in seen:
                seen.add(c)
                toks, st = fwp.walk(c + " ", looked)
                rows, chars = rows + 1, chars + len(c) + 1
                steps, tokens = steps + st, tokens + len(toks)
    return {"rows": rows, "chars": chars, "steps": steps, "tokens": tokens,
            "nodes": len({n for n, _ in looked}), "edges": len(looked)}
