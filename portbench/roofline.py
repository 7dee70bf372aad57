"""The card's peaks, the least time of each training step's kernels, and
that of FastWP's fused scan.

A step of the flat training route is three kernels: K1 counts the pairs
of the live slots into a hash table, K2 selects the best pair over the
table's live entries and unifies its id, K3 merges and compacts. Their
bytes, as the functions need them, at a state of ``n`` live slots
(symbol id int32, word id int32, weight int64: 16 bytes a slot), ``p``
distinct live pairs and ``s`` symbols:

- K1: every slot read (16 n), each pair's 20-byte entry written and the
  entry the call before filled emptied (40 p); 10 operations a slot;
- K2: each live entry through the claim list (claim, key, count,
  position: 24 p; WordPiece also gathers both symbols' weights, 40 p),
  the 8-byte hash of each symbol id (8 s), the three control words and
  the 24-byte record; 4 operations an entry (WordPiece 24: the score's
  correctly rounded division);
- K3: every slot read (16 n) and every slot it keeps written (16 n'),
  the record (24); WordPiece also moves three symbol weights (24); 6
  operations a slot.

A kernel's least time is the larger of its bytes over the device
memory's bandwidth and its operations over the scalar rate. These are
the counts ``chip_smoke.py`` evaluates once, at the initial state (its
rows 11a, 12a and 11b), evaluated here at each step's own state, which
the benchmark's plain trainer walks.

FastWP's batched encode scans each distinct chunk of a batch once in one
launch (``scan_compact_kernel``: the LinMaxMatch walk, then the
compaction of the tokens into one stream). As the function needs them,
over ``rows`` distinct chunks of ``chars`` characters (each chunk's
trailing space included), whose walk takes ``steps`` look-ups at
``nodes`` distinct trie nodes over ``edges`` distinct (node, character)
pairs and emits ``tokens``: each packed character read (2 bytes), each
row's length read (4), each node's 32-byte record and each edge's 4-byte
goto entry read once, 4 bytes a token written, and the head (an offset
a row, the total, a flags word a row: 4 bytes each) written; about 30
integer operations a step. The plain encoder (``reference/fastwp.py``,
``scan_rows``) walks the same rows and counts them.
"""
from __future__ import annotations

from typing import Iterable, Tuple

# NVIDIA H100 SXM, published dense peaks at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12  # float32 outside the tensor cores


def least_s(n_bytes: int, n_ops: int) -> float:
    """The least time: bytes over the bandwidth or operations over the
    scalar rate, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / SCALAR_OPS_PER_S)


def step_work(n: int, n_next: int, p: int, s: int, wordpiece: bool
              ) -> Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]:
    """((bytes, operations) of K1, of K2, of K3) for one step from a state
    of ``n`` live slots, ``p`` live pairs and ``s`` symbols to one of
    ``n_next`` live slots."""
    k1 = (16 * n + 40 * p, 10 * n)
    k2 = ((40 if wordpiece else 24) * p + 8 * s + 12 + 24,
          (24 if wordpiece else 4) * p)
    k3 = (16 * n + 16 * n_next + 24 + (24 if wordpiece else 0), 6 * n)
    return k1, k2, k3


def steps_least_s(states: Iterable[Tuple[int, int, int]], n_final: int,
                  wordpiece: bool) -> float:
    """Seconds: the sum over steps of K1's, K2's and K3's least times.
    ``states``: (live slots, live pairs, symbols) before each step;
    ``n_final``: the live slots after the last."""
    states = list(states)
    total = 0.0
    for i, (n, p, s) in enumerate(states):
        n_next = states[i + 1][0] if i + 1 < len(states) else n_final
        total += sum(least_s(b, o)
                     for b, o in step_work(n, n_next, p, s, wordpiece))
    return total


def scan_work(rows: int, chars: int, steps: int, tokens: int, nodes: int,
              edges: int) -> Tuple[int, int]:
    """(bytes, operations) of one fused FastWP scan (see above)."""
    n_bytes = (2 * chars + 4 * rows + 32 * nodes + 4 * edges + 4 * tokens
               + 4 * (2 * rows + 1))
    return n_bytes, 30 * steps
