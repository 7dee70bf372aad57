"""The vocabulary tries of the WordPiece encoders, as flat integer arrays.

:class:`MatchTrie` is NaiveWP's plain prefix trie, for the greedy
longest-match kernel: a dense ``goto`` table and each node's output
token id (``accept``, -1 where no vocab token ends).

:class:`E2ETrie` is FastWP's LinMaxMatch end-to-end trie. Both hold the
tables the JAX package builds (``subword_tokenizers_tpu/models/trie.py``);
``MatchTrie`` is built in Python, ``E2ETrie`` in one native pass
(``_native/e2e_trie.cpp``). For ``E2ETrie``: level-order processing;
is_end nodes fail to the "##" node with a single pop; other nodes
accumulate pops along the parent's failure chain; and any node whose
character is not Python-alphanumeric has its failure link overridden to
a dedicated punctuation root ``root_p``.

Transitions are kept twice: as a dense ``goto[node, alpha[cp]]`` table
(the device scan's one gather per step; column ``A`` is the all -1 OOV
class) and as a sorted i64 key array ``(node << 21) | cp`` for the host
scan of single sentences. Failure pops are CSR: ``pops_flat[
pops_off[n]:pops_off[n+1]]``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

import numpy as np

from .._native import binding
from ..benchmarks import profiling

CP_BITS = 21
NO_NODE = -1
MAX_CP = 0x110000


def _dense_tables(children: List[Dict[int, int]]
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(goto i32[n_nodes, A+1], alpha i32[MAX_CP], A) over the sorted
    edge alphabet; out-of-alphabet codepoints map to A."""
    alphabet = sorted({cp for ch in children for cp in ch})
    A = len(alphabet)
    alpha = np.full(MAX_CP, A, dtype=np.int32)
    alpha[alphabet] = np.arange(A, dtype=np.int32)
    goto = np.full((len(children), A + 1), NO_NODE, dtype=np.int32)
    for node, ch in enumerate(children):
        for cp, child in ch.items():
            goto[node, alpha[cp]] = child
    return goto, alpha, A


def _pack_edges(children: List[Dict[int, int]]
                ) -> Tuple[np.ndarray, np.ndarray]:
    keys, vals = [], []
    for node, ch in enumerate(children):
        for cp, child in ch.items():
            keys.append((node << CP_BITS) | cp)
            vals.append(child)
    keys = np.asarray(keys, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.int32)
    order = np.argsort(keys, kind="stable")
    return keys[order], vals[order]


@dataclass
class MatchTrie:
    """Prefix trie: the greedy longest-match automaton's tables."""

    edge_keys: np.ndarray   # i64[n_edges], sorted (node<<21)|cp
    edge_vals: np.ndarray   # i32[n_edges]
    accept: np.ndarray      # i32[n_nodes], output token id or -1
    n_nodes: int
    goto: np.ndarray        # i32[n_nodes, n_alpha+1] dense transitions
    alpha: np.ndarray       # i32[MAX_CP] codepoint -> alphabet id (OOV=A)
    n_alpha: int

    @classmethod
    def build(cls, vocab: Iterable[str], out_table) -> "MatchTrie":
        """``out_table``: SymbolTable interning the output tokens, in
        ``vocab``'s order."""
        children: List[Dict[int, int]] = [{}]
        accept: List[int] = [NO_NODE]
        for tok in vocab:
            node = 0
            for c in tok:
                cp = ord(c)
                nxt = children[node].get(cp)
                if nxt is None:
                    nxt = len(children)
                    children[node][cp] = nxt
                    children.append({})
                    accept.append(NO_NODE)
                node = nxt
            accept[node] = out_table.intern(tok)
        keys, vals = _pack_edges(children)
        goto, alpha, n_alpha = _dense_tables(children)
        return cls(edge_keys=keys, edge_vals=vals,
                   accept=np.asarray(accept, dtype=np.int32),
                   n_nodes=len(children), goto=goto, alpha=alpha,
                   n_alpha=n_alpha)


@dataclass
class E2ETrie:
    """LinMaxMatch trie with failure links and pops."""

    edge_keys: np.ndarray    # i64[n_edges], sorted (node<<21)|cp
    edge_vals: np.ndarray    # i32[n_edges]
    fail: np.ndarray         # i32[n_nodes], NO_NODE = no failure link
    pops_off: np.ndarray     # i32[n_nodes+1] CSR offsets into pops_flat
    pops_flat: np.ndarray    # i32[total_pops] output token ids
    root: int                # = 0
    root_p: int
    root_sharp: int
    n_nodes: int
    goto: np.ndarray         # i32[n_nodes, n_alpha+1] dense transitions
    alpha: np.ndarray        # i32[MAX_CP] codepoint -> alphabet id (OOV=A)
    n_alpha: int
    has_ws_token: bool       # a vocab token holds a whitespace char

    @classmethod
    def build(cls, vocab: Iterable[str], out_table) -> "E2ETrie":
        """``out_table``: SymbolTable interning the output tokens, in the
        order the level-order pass meets their nodes."""
        vocab = vocab if isinstance(vocab, list) else list(vocab)
        t = binding.e2e_trie(vocab)
        ids = np.fromiter(
            map(out_table.intern, map(vocab.__getitem__,
                                      t.pop("end_token").tolist())),
            dtype=np.int32)
        profiling.count("trie.native")
        profiling.count("trie.nodes", t["n_nodes"])
        return cls(pops_flat=ids[t.pop("pops_rank")], root=0, **t)

    @property
    def max_pops(self) -> int:
        return int(np.max(np.diff(self.pops_off)))
