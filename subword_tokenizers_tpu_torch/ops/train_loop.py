"""The training merge loop on the device, for BPE and WordPiece:
selection and string unification (kernel K2), and the host loop that
runs blocks of K steps of K1 -> K2 -> K3 with no host sync between
them. On the card each block after a run's first is one replay of a
CUDA graph of its launches (:class:`BlockRunner`), and the loop keeps
two blocks in flight, as the JAX package's ``run_fused`` keeps two
dispatches.

The only host dependency of a merge step is interning the merged string
(two merges that spell the same string are one symbol). As in the JAX
package's ``ops/train_loop.py``, it is resolved on the device: every
symbol carries two rolling hashes mod the Mersenne prime 2^31 - 1 and
its length; the merged symbol's are computed from its parts, and an
exact (h1, h2, len) match over the live ids reuses an id, a miss
appends one. After each block the host checks every record against real
interning and raises :class:`HashCollision` on any disagreement; the
model then redoes the run on the exact per-step path.

WordPiece differs in three places, each a ``wordpiece`` argument: K2
selects on the exact score ``count / (freq_a * freq_b)``
(ops/bitmath.py) over per-symbol weights that K4 counts once per run
and K3 carries from step to step; the merged string is ``a + b[2:]``,
its hashes stripped of the leading "##"; the host checks records with
the same string.

Each step writes one int32 record ``(a, b, new_id, matched, active,
n_live)`` (column names in ops/flat.py).

:func:`run_fused` also runs the JAX package's other routes of the same
loop, each giving the same merges: deferred compaction (``skip``, K1 and
K3 in skip mode behind an overflow guard), the padded layout
(``flat=False``: :class:`PaddedState`, K3p) and WordPiece's tournament
(K2's tournament mode).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..benchmarks import profiling
from . import check_tensor
from .bitmath import score_bits_ref
from .flat import (ACTIVE, NEW_ID, N_LIVE, MergeScratch, merge_apply,
                   merge_skip, skip_guard)
from .merge import apply_merge
from .pairstats import (EMPTY_KEY, PairTable, TablePair, pair_stats,
                        symbol_freqs, symbol_rows)
from .shard_select import certificate_ref
from .wp_tournament import wp_tournament_select

MOD = (1 << 31) - 1  # Mersenne prime; products of residues fit in int64
HASH_B1 = 1_000_003
HASH_B2 = 805_306_457
# K2's blocks at most (csrc/select_unify.cu kMaxPart: two an SM of an
# H100; over a claim list one an SM, since tens of thousands of claims
# fill them) and its scratch: a partial of 5 words a block, then the
# last-block ticket
SELECT_PARTS = 264
CLAIM_PARTS = 132
SELECT_SCRATCH = 5 * SELECT_PARTS + 1


def select_scratch(device) -> torch.Tensor:
    """K2's scratch on ``device``, built once by a caller that selects
    every step (int64[SELECT_SCRATCH]: the blocks' partials and the
    ticket, which is 0 between calls)."""
    return torch.zeros(SELECT_SCRATCH, dtype=torch.int64, device=device)


def str_hashes(s: str) -> Tuple[int, int]:
    """The two rolling hashes of a string, on the host."""
    h1 = h2 = 0
    for c in s:
        v = (ord(c) + 1) % MOD
        h1 = (h1 * HASH_B1 + v) % MOD
        h2 = (h2 * HASH_B2 + v) % MOD
    return h1, h2


def pow_tables(max_len: int):
    """B^l mod M for l in [0, max_len], both bases (numpy int64)."""
    p1 = np.ones(max_len + 1, dtype=np.int64)
    p2 = np.ones(max_len + 1, dtype=np.int64)
    for l in range(1, max_len + 1):
        p1[l] = (p1[l - 1] * HASH_B1) % MOD
        p2[l] = (p2[l - 1] * HASH_B2) % MOD
    return p1, p2


def _exact_best(keys, counts, pos, wordpiece: bool, sym_freq):
    """(metric, key) of the exact selection: the largest count (BPE) or
    score bits (WordPiece), then the least position; metric -1 and key 0
    for an empty table."""
    live = keys != EMPTY_KEY
    metric = counts
    if wordpiece:
        k = torch.where(live, keys, 0)
        metric = score_bits_ref(counts, sym_freq[k >> 32],
                                sym_freq[k & 0xFFFFFFFF])
    best = int(torch.where(live, metric, -1).max()) if keys.numel() else -1
    key = 0
    if best >= 0:
        at = live & (metric == best)
        first = int(pos.to(torch.int64)[at].min())
        key = int(keys[at & (pos.to(torch.int64) == first)].max())
    return best, key


def select_unify_ref(keys, counts, pos, h1, h2, slen, ctrl, pw1, pw2,
                     max_vocab: int, rec, host_ids: bool = False,
                     wordpiece: bool = False, sym_freq=None,
                     sharp=(0, 0), tournament: bool = False,
                     redo=None, claims: Optional[PairTable] = None,
                     kth=None, wide_score: bool = False) -> None:
    """Plain PyTorch version of :func:`select_unify` (same writes); with
    ``claims`` only the entries its last fill claimed are read; with
    ``kth`` the selection is followed by
    :func:`~.shard_select.certificate_ref`."""
    if claims is not None:
        idx = claims.claimed()
        keys, counts, pos = keys[idx], counts[idx], pos[idx]
    if tournament:
        key, _, _, best, risky = wp_tournament_select(keys, counts, pos,
                                                      sym_freq)
        if risky:
            best, key = _exact_best(keys, counts, pos, True, sym_freq)
            redo += 1
    else:
        best, key = _exact_best(keys, counts, pos, wordpiece, sym_freq)
    n_sym, vocab, alive = ctrl.tolist()
    if host_ids:
        active = best > 0
        a, b = (key >> 32, key & 0xFFFFFFFF) if active else (0, 0)
        rec[:ACTIVE + 1] = torch.tensor([a, b, -1, 0, int(active)])
        if kth is not None:
            certificate_ref(kth, keys, counts, rec,
                            sym_freq if wordpiece else None, wide_score)
        return
    active = bool(alive) and best > 0 and vocab < max_vocab
    a, b = (key >> 32, key & 0xFFFFFFFF) if active else (0, 0)
    lb = int(slen[b])
    hb1, hb2 = int(h1[b]), int(h2[b])
    if wordpiece:
        lb = max(lb - 2, 0)
    k = min(lb, pw1.shape[0] - 1)
    if wordpiece:
        hb1 = (hb1 - sharp[0] * int(pw1[k])) % MOD
        hb2 = (hb2 - sharp[1] * int(pw2[k])) % MOD
    m1 = (int(h1[a]) * int(pw1[k]) % MOD + hb1) % MOD
    m2 = (int(h2[a]) * int(pw2[k]) % MOD + hb2) % MOD
    lm = int(slen[a]) + lb
    ids = torch.arange(h1.shape[0], device=h1.device)
    hit = (ids < n_sym) & (h1 == m1) & (h2 == m2) & (slen == lm)
    matched = bool(hit.any())
    new_id = int(ids[hit].max()) if matched else n_sym
    if active and not matched:
        h1[n_sym], h2[n_sym], slen[n_sym] = m1, m2, lm
        n_sym += 1
        vocab += 1
    ctrl.copy_(torch.tensor([n_sym, vocab, int(alive and active)]))
    rec[:ACTIVE + 1] = torch.tensor([a, b, new_id, int(matched),
                                     int(active)])


def select_unify(keys, counts, pos, h1, h2, slen, ctrl, pw1, pw2,
                 max_vocab: int, rec, host_ids: bool = False,
                 wordpiece: bool = False, sym_freq=None,
                 sharp=(0, 0), tournament: bool = False,
                 redo=None, claims: Optional[PairTable] = None,
                 scratch: Optional[torch.Tensor] = None, kth=None,
                 wide_score: bool = False) -> None:
    """One step's winner and merged symbol, written into ``rec`` (int32[6]).

    The pair table (keys, counts, pos) is either layout of
    ops/pairstats.pair_stats. The winner is the pair of largest count,
    then least first position (the reference's ``most_common(1)``). With
    ``wordpiece`` it is the pair of largest score ``count / (sym_freq[a]
    * sym_freq[b])``, compared as the exact double (ops/bitmath.py),
    then least first position (the reference's ``max`` over its dict);
    ``sym_freq`` is int64 over the symbol ids. The step is active while
    ``ctrl`` = int32 (n_sym, vocab_size, alive) is alive, the count is
    positive and vocab_size < max_vocab; an inactive step records
    a = b = 0.

    Unless ``host_ids``, the merged symbol's hashes (``h1``, ``h2`` int64
    and ``slen`` int64 over [sym_cap] ids; ``pw1``/``pw2`` the powers of
    :func:`pow_tables`) are matched against every id below n_sym: a hit
    takes the largest matching id, a miss appends the symbol at n_sym
    and counts it in n_sym and vocab_size. With ``wordpiece`` the merged
    string is ``a + b[2:]``: its hashes strip b's leading "##", whose
    hashes are ``sharp``. ``ctrl`` stops being alive after an inactive
    step. With ``host_ids`` only the
    selection runs (active = count > 0), ``new_id`` is left to the host
    and the hash tables and ``ctrl`` are not touched.

    ``claims``, the :class:`~.pairstats.PairTable` whose first entries
    (keys, counts, pos) are (K1's last fill), restricts the read to the
    entries that fill claimed: every live entry and no other, so the
    winner is the same. On the card the kernel then reads the claim list
    and its counter on the device, not the table. Without it every entry
    is read (the sharded step's gathered candidates). ``scratch``
    (:func:`select_scratch`, on the same device) is the kernel's partials
    and ticket, kept by a caller that selects every step; without it the
    call builds its own. A call on the card is one kernel launch.

    ``kth`` (int64[3 * D], with ``host_ids`` over the sharded top-K
    tier's gathered candidates: each shard's K-th best metric, count and
    key, ops/shard_select.nominate_tables) adds that tier's certificate
    to the same launch: its proven flag goes to ``rec[5]``, as
    :func:`~.shard_select.certificate` computes it over (keys, counts)
    as the candidates and their summed counts, ``wide_score`` as there.
    Not with ``claims`` or the tournament.

    Launches the CUDA kernel for CUDA tensors, runs the PyTorch version
    for CPU tensors, and raises for any other device.
    """
    dev = keys.device
    check_tensor("keys", keys, (torch.int64,), 1, dev)
    check_tensor("counts", counts, (torch.int64,), 1, dev)
    check_tensor("pos", pos, (torch.int32, torch.int64), 1, dev)
    for name, t in (("h1", h1), ("h2", h2), ("slen", slen), ("pw1", pw1),
                    ("pw2", pw2)):
        check_tensor(name, t, (torch.int64,), 1, dev)
    check_tensor("ctrl", ctrl, (torch.int32,), 1, dev)
    check_tensor("rec", rec, (torch.int32,), 1, dev)
    if wordpiece:
        if sym_freq is None:
            raise ValueError("select_unify: wordpiece needs sym_freq")
        check_tensor("sym_freq", sym_freq, (torch.int64,), 1, dev)
    if tournament:
        if not wordpiece or redo is None:
            raise ValueError("select_unify: the tournament needs wordpiece "
                             "and a redo counter")
        check_tensor("redo", redo, (torch.int32,), 1, dev)
    if kth is not None:
        check_tensor("kth", kth, (torch.int64,), 1, dev)
        if not host_ids or tournament or claims is not None:
            raise ValueError("select_unify: the certificate (kth) runs in "
                             "host_ids mode over dense candidates only")
        if kth.shape[0] % 3 or kth.shape[0] == 0:
            raise ValueError(f"select_unify: kth of {kth.shape[0]} words, "
                             f"expected 3 a shard")
    T = keys.shape[0]
    if (counts.shape[0] != T or pos.shape[0] != T or ctrl.shape[0] != 3
            or rec.shape[0] != 6 or h2.shape[0] != h1.shape[0]
            or slen.shape[0] != h1.shape[0]
            or pw2.shape[0] != pw1.shape[0] or pw1.shape[0] == 0):
        raise ValueError("select_unify: inconsistent shapes")
    bound = T
    if claims is not None:
        _check_claims(claims, keys, counts, pos, dev)
        bound = claims.claims.shape[0]
    if scratch is not None:
        check_tensor("scratch", scratch, (torch.int64,), 1, dev)
        if scratch.shape[0] != SELECT_SCRATCH:
            raise ValueError(f"select_unify: scratch of {scratch.shape[0]} "
                             f"words, expected {SELECT_SCRATCH}")
    if dev.type == "cpu":
        return select_unify_ref(keys, counts, pos, h1, h2, slen, ctrl, pw1,
                                pw2, max_vocab, rec, host_ids, wordpiece,
                                sym_freq, sharp, tournament, redo, claims,
                                kth, wide_score)
    if dev.type != "cuda":
        raise ValueError(f"select_unify: no kernel for device {dev}")
    if pos.dtype != torch.int32:
        raise TypeError("select_unify: the kernel takes int32 positions")
    if scratch is None:
        scratch = select_scratch(dev)
    n_part = max(1, min(SELECT_PARTS if claims is None else CLAIM_PARTS,
                        -(-bound // 256)))
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_select_unify", keys.data_ptr(), counts.data_ptr(),
                     pos.data_ptr(), T,
                     None if claims is None else claims.ptrs[3],
                     None if claims is None else claims.counter(),
                     scratch.data_ptr(), n_part,
                     h1.data_ptr(), h2.data_ptr(), slen.data_ptr(),
                     h1.shape[0], ctrl.data_ptr(), pw1.data_ptr(),
                     pw2.data_ptr(), pw1.shape[0], max_vocab,
                     rec.data_ptr(), int(host_ids),
                     sym_freq.data_ptr() if wordpiece else None,
                     int(wordpiece), int(sharp[0]), int(sharp[1]),
                     int(tournament),
                     redo.data_ptr() if tournament else None,
                     None if kth is None else kth.data_ptr(),
                     0 if kth is None else kth.shape[0] // 3,
                     int(wide_score))
    profiling.count("launch.select_unify")
    if kth is not None:
        profiling.count("launch.select_unify.cert")
    if wordpiece:
        profiling.count("launch.select_unify.wp")
    if tournament:
        profiling.count("launch.select_unify.tournament")


def _check_claims(claims, keys, counts, pos, dev) -> None:
    """Raise unless ``claims`` is the PairTable that (keys, counts, pos)
    view, on ``dev``, holding a fill's count (whose counter K2 reads)."""
    if not isinstance(claims, PairTable):
        raise TypeError(f"select_unify: claims must be the PairTable K1 "
                        f"filled, not {type(claims).__name__}")
    if claims.keys.device != dev:
        raise ValueError(f"select_unify: claims on {claims.keys.device}, "
                         f"expected {dev}")
    if (keys.data_ptr(), counts.data_ptr(), pos.data_ptr()) != \
            claims.ptrs[:3] or keys.shape[0] > claims.size:
        raise ValueError("select_unify: the claim list is another table's "
                         "(the keys, counts and positions must view its "
                         "first entries)")
    if not claims.dirty:
        raise ValueError("select_unify: the PairTable holds no count, so "
                         "no fill's counter gives its claims")


class HashCollision(Exception):
    """Device hash unification disagreed with real string interning."""


class FlatState:
    """The flat training state on ``device`` (ops/flat.py layout) with a
    second buffer of each array for K3 to write into, K3's scratch
    (``scratch``, built once: a merge, a skip merge or the skip route's
    guard allocates nothing), and K1's two tables (on CUDA), each call
    filling one and emptying the other.

    ``F`` is the width the kernels see; the caller may lower it to cut a
    dead tail off (merges only consume slots, and K3 compacts to the
    front). ``sym_freq`` is WordPiece's per-symbol weight table, None
    until :meth:`count_symbols`; K3 then carries it with every merge.
    ``n_words`` is the number of word types (rows of :meth:`padded`);
    ``n_live`` the live slots while the host knows them: at the build,
    None once a merge has run.
    """

    def __init__(self, fs: np.ndarray, wid: np.ndarray, wgt: np.ndarray,
                 device) -> None:
        self.device = torch.device(device)
        self.F = int(fs.shape[0])
        live = fs >= 0
        self.n_words = int(wid[live].max()) + 1 if live.any() else 0
        self.n_live: Optional[int] = int(live.sum())
        cur = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device) for x in (fs, wid, wgt))
        self._bufs = [cur, tuple(torch.empty_like(x) for x in cur)]
        self._cur = 0
        self._tables = None  # K1's TablePair, made by the first count
        self.scratch = MergeScratch(self.F, self.device)
        self.sym_freq: Optional[torch.Tensor] = None

    def arrays(self):
        """(fs, wid, wgt) views of the current state."""
        return tuple(x[:self.F] for x in self._bufs[self._cur])

    def _other(self):
        return tuple(x[:self.F] for x in self._bufs[1 - self._cur])

    def pairs(self, skip: int = 0):
        """K1 over the current state, with window ``skip`` (the tables'
        first ``table_size(F)`` entries as F shrinks)."""
        if self._tables is None and self.device.type == "cuda":
            self._tables = TablePair(self.F, self.device)
        if self._tables is None:
            return pair_stats(*self.arrays(), skip=skip)
        return self._tables.pairs(*self.arrays(), skip=skip)

    def claims(self) -> Optional[PairTable]:
        """The table :meth:`pairs` last filled, for K2's claims mode; None
        when it ran the plain version."""
        return None if self._tables is None else self._tables.claims()

    def count_symbols(self, sym_cap: int) -> None:
        """K4: ``sym_freq`` becomes the state's per-symbol weights, int64
        [sym_cap + 1], counted from the slots (once a run; K3 carries
        it)."""
        fs, _, wgt = self.arrays()
        self.sym_freq = symbol_freqs(fs, wgt, sym_cap)

    def merge(self, rec, skip: int = 0) -> None:
        """K3 with the step record ``rec`` (on the device); the state
        becomes the result, and ``sym_freq`` follows it. With a window
        ``skip`` the merge is in place, nothing is compacted, and the
        scratch's gate tells the next :meth:`guard` whether the state
        overflows; a compacting merge closes that gate."""
        self.n_live = None
        if skip:
            merge_skip(*self.arrays(), rec, skip, self.sym_freq,
                       scratch=self.scratch)
            return
        merge_apply(*self.arrays(), rec, out=self._other(),
                    sym_freq=self.sym_freq, scratch=self.scratch)
        self._cur = 1 - self._cur

    def guard(self, count) -> None:
        """Before a step of the skip route: compact the state in place
        when the last skip merge left a gap wider than its window,
        counting it in ``count`` (int32[1])."""
        skip_guard(*self.arrays(), count, self.scratch)

    def close(self, rec) -> None:
        """The skip route's block end: compact the state in place (it
        stays in its buffers), its live slots into ``rec[N_LIVE]``."""
        skip_guard(*self.arrays(), None, self.scratch, close=rec)

    def host_key(self) -> tuple:
        """The host values a block's launches read beyond the width:
        which buffer holds the state, and K1's tables'
        (:meth:`~.pairstats.TablePair.host_key`). K3's epochs and gate
        are the scratch's device words."""
        return (self._cur,) + self._tables.host_key()

    def host(self) -> Tuple[np.ndarray, np.ndarray]:
        """(fs, wid) on the host, in one copy."""
        fs, wid, _ = self.arrays()
        both = torch.stack([fs, wid]).cpu().numpy()
        return both[0], both[1]

    def padded(self) -> np.ndarray:
        """The state as a padded host tensor [n_words, longest word]."""
        return _flat_to_padded(*self.host(), self.n_words)


class PaddedState:
    """The padded training state on ``device``: ``sym`` int32[n, L], a
    row per word type, and each row's weight ``wgt`` int64[n]. K1 sees it
    as n * L flat slots whose word is the row and whose weight is the
    row's (positions row * L + j order pairs as the flat layout's do),
    into one of two tables (on CUDA) each call; K3p (ops/merge.py)
    merges each row in place. As in the JAX package's ``train_steps``,
    WordPiece recounts ``sym_freq`` every step: K4 over the rows and
    their weights, into one of two vectors, the launch emptying the
    other.
    """

    def __init__(self, sym: np.ndarray, freq: np.ndarray, device) -> None:
        self.device = torch.device(device)
        sym = np.asarray(sym, dtype=np.int32)
        if sym.shape[1] < 2:  # K1 needs two slots; PAD changes nothing
            sym = np.pad(sym, ((0, 0), (0, 2 - sym.shape[1])),
                         constant_values=-1)
        n, L = sym.shape
        self.sym = torch.from_numpy(np.ascontiguousarray(sym)).to(
            self.device)
        self._wid = torch.from_numpy(np.repeat(
            np.arange(n, dtype=np.int32), L)).to(self.device)
        self.wgt = torch.from_numpy(np.asarray(freq, dtype=np.int64)).to(
            self.device)
        self._wgt = self.wgt.repeat_interleave(L)
        self._tables = None  # K1's TablePair, made by the first count
        self._freqs = None  # K4's two outputs, made by the first count
        self.sym_freq: Optional[torch.Tensor] = None

    def rows(self, lo: int, hi: int) -> "PaddedState":
        """Rows ``[lo, hi)`` as a state of their own whose tensors are
        views of this one's (a merge through either shows in both); its
        K1 table is its own. The data-parallel layer's shards are such
        views of one block a device (parallel/train.py)."""
        L = self.sym.shape[1]
        view = object.__new__(PaddedState)
        view.device = self.device
        view.sym = self.sym[lo:hi]
        view.wgt = self.wgt[lo:hi]
        view._wid = self._wid[lo * L:hi * L]
        view._wgt = self._wgt[lo * L:hi * L]
        view._tables = None
        view._freqs = None
        view.sym_freq = None
        return view

    @classmethod
    def from_flat(cls, state: FlatState) -> "PaddedState":
        """The same corpus state in the padded layout."""
        fs, wid, wgt = (x.cpu().numpy() for x in state.arrays())
        live = fs >= 0
        freq = np.zeros(state.n_words, dtype=np.int64)
        freq[wid[live]] = wgt[live]
        return cls(_flat_to_padded(fs, wid, state.n_words), freq,
                   state.device)

    def pairs(self, skip: int = 0):
        """K1 over the rows seen as flat slots (no window: rows stay
        compacted)."""
        fs = self.sym.view(-1)
        if self._tables is None and self.device.type == "cuda":
            self._tables = TablePair(fs.shape[0], self.device)
        if self._tables is None:
            return pair_stats(fs, self._wid, self._wgt)
        return self._tables.pairs(fs, self._wid, self._wgt)

    def claims(self) -> Optional[PairTable]:
        """The table :meth:`pairs` last filled, for K2's claims mode; None
        when it ran the plain version."""
        return None if self._tables is None else self._tables.claims()

    def count_symbols(self, sym_cap: int) -> torch.Tensor:
        """K4 over the rows and their weights: ``sym_freq`` int64
        [sym_cap + 1], returned. On CUDA it is one of two vectors, the
        launch emptying the other: valid until the next count."""
        out = clear = None
        if self.device.type == "cuda" and (
                self._freqs is None
                or self._freqs[0].shape[0] != sym_cap + 1):
            self._freqs = [torch.zeros(sym_cap + 1, dtype=torch.int64,
                                       device=self.device)
                           for _ in range(2)]
        if self._freqs is not None:
            out, clear = self._freqs
            self._freqs = [clear, out]
        self.sym_freq = symbol_rows(self.sym, self.wgt, sym_cap, out, clear)
        return self.sym_freq

    def merge(self, rec, skip: int = 0) -> None:
        """K3p with the step record ``rec``, in place."""
        apply_merge(self.sym, rec)

    def host_key(self) -> tuple:
        """The host values a block's launches read: the order of K4's two
        outputs, the weights K2 reads, and K1's tables' (none on the CPU,
        whose plain version keeps no tables)."""
        return (None if self._freqs is None else
                tuple(x.data_ptr() for x in self._freqs),
                None if self.sym_freq is None else self.sym_freq.data_ptr()
                ) + (() if self._tables is None else self._tables.host_key())

    def padded(self) -> np.ndarray:
        return self.sym.cpu().numpy()


# Floor of the between-block shrink: below it a step is cheap anyway.
_FLAT_MIN = 8192


def sym_capacity(table, max_vocab: int) -> int:
    """Symbol ids a run from ``table`` to ``max_vocab`` can reach, with
    room to spare: the length of the hash tables, and of ``sym_freq``
    less its trash bucket."""
    return max(max_vocab, len(table)) + 8


def init_tables(table, max_vocab: int, max_len: int, device):
    """(h1, h2, slen, ctrl, pw1, pw2) on ``device`` for a run from the
    symbols of ``table`` to ``max_vocab``, and the host hashes of "##";
    words are at most ``max_len`` symbols long.

    The powers reach the longest symbol the run can make: a word's
    characters and what its initial symbols add to them (WordPiece's
    ``"##"``, BPE's end-of-word suffix), so ``max_len`` plus the longest
    symbol of ``table`` less one character, and at least ``max_len +
    4``."""
    n0 = len(table)
    sym_cap = sym_capacity(table, max_vocab)
    h1 = np.zeros(sym_cap, dtype=np.int64)
    h2 = np.zeros(sym_cap, dtype=np.int64)
    sl = np.zeros(sym_cap, dtype=np.int64)
    for i, s in enumerate(table.strings()):
        h1[i], h2[i] = str_hashes(s)
        sl[i] = len(s)
    pw1, pw2 = pow_tables(max_len + max(4, int(sl[:n0].max(initial=1)) - 1))
    ctrl = np.array([n0, n0, 1], dtype=np.int32)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (h1, h2, sl, ctrl, pw1, pw2)) + (str_hashes("##"),)


def default_skip() -> int:
    """The deferred-compaction window: ``SWT_SKIP_COMPACT`` (an integer;
    0 and below compact every step), else 0. The JAX package's default is
    12; the port compacts every step unless asked (PERF.md)."""
    v = os.environ.get("SWT_SKIP_COMPACT")
    if v is None:
        return 0
    try:
        return max(int(v), 0)
    except ValueError:
        raise ValueError(
            f"SWT_SKIP_COMPACT must be an integer, got {v!r}") from None


def use_tournament(wordpiece: bool, wide_score: bool) -> bool:
    """Whether WordPiece selects by tournament: ``SWT_WP_TOURNAMENT``
    "1" (on) or "0"/unset (off; the JAX package's default is on for its
    CPU backend). The value is checked first, for BPE too; a forced "1"
    on a wide-score run (at least 2**26 symbol occurrences), which the
    tournament cannot take, raises."""
    t = os.environ.get("SWT_WP_TOURNAMENT")
    if t not in (None, "0", "1"):
        raise ValueError(f"SWT_WP_TOURNAMENT must be '0' or '1', got {t!r}")
    if t == "1" and wordpiece and wide_score:
        raise ValueError(
            "SWT_WP_TOURNAMENT=1 needs the narrow score domain (fewer than "
            "2**26 symbol occurrences); this corpus has wide scores")
    return t == "1" and wordpiece


class _BlockGraph:
    """A captured block: its CUDA graph, the host values its launches
    read (``state.host_key()``, the same before and after the block), the
    launches it holds by ``launch.*`` counter, and its calls of K3's
    family (their epochs)."""

    def __init__(self, graph, host_key, launches, k3_calls: int) -> None:
        self.graph = graph
        self.host_key = host_key
        self.launches = launches
        self.k3_calls = k3_calls


class BlockRunner:
    """The blocks of one training run on ``state`` (a :class:`FlatState`
    or :class:`PaddedState`): K steps of K1 -> K2 -> K3 (the skip route:
    the guard, K1 and K2, K3's skip mode, then the block's closing
    compaction, in place; the padded route: K4 for WordPiece, K1, K2,
    K3p), their records in ``recs``, int32[K + 2, 6]: row K the closing
    compaction's, row K + 1 the run's counts (K2's tournament redos, the
    guard's compactions) in its first two columns.

    :meth:`dispatch` queues a block and a copy of its records into one
    of two host buffers; :meth:`fetch` waits for that copy. On the CPU a
    block runs the kernels' plain versions step by step
    (:meth:`queue_steps`). On the card a run's first block is queued
    step by step too (it builds K1's tables and warms every launcher);
    every later block is one replay of a ``torch.cuda.CUDAGraph`` of
    :meth:`queue_steps`, captured once for each width ``F``. A block of K
    steps, K a multiple of 4, ends in the host state it began in: it
    flips the state's buffers K times (the skip route's closing
    compaction is in place), fills each of K1's two tables K / 2 times
    and flips K4's outputs K times, so every block of one width launches
    with the same host values (``state.host_key()``, checked at each
    capture and replay). K3's epochs and the skip route's gate are
    device words (ops/flat.MergeScratch). After a replay every
    ``launch.*`` counter gains the launches the graph holds, so each stays
    the true number of kernels run. A capture that allocates, or fails,
    raises; nothing falls back to queuing steps. :meth:`close` releases
    the graphs.

    The blocks, replays and captures are counted in the profiler
    (benchmarks/profiling.py): ``train.blocks``, ``train.eager_blocks``,
    ``train.graph_replays``, ``train.graph_captures``, and by width
    (``F``; 0 for the padded layout) ``train.blocks.<F>`` and
    ``train.graph_replays.<F>``.
    """

    def __init__(self, state, table, max_vocab: int, max_len: int, K: int,
                 wordpiece: bool, flat: bool, skip: int,
                 tournament: bool) -> None:
        dev = state.device
        cuda = dev.type == "cuda"
        if cuda and K % 4:
            raise ValueError(f"BlockRunner: K = {K} on the card must be a "
                             f"multiple of 4 (a block then ends in the "
                             f"buffers and table counters it began in)")
        self.state, self.K, self.dev = state, K, dev
        self.max_vocab, self.wordpiece, self.flat = max_vocab, wordpiece, flat
        self.skip, self.tournament = skip, tournament
        (self.h1, self.h2, self.sl, self.ctrl, self.pw1, self.pw2,
         self.sharp) = init_tables(table, max_vocab, max_len, dev)
        self.sym_cap = sym_capacity(table, max_vocab)
        if wordpiece and flat:
            state.count_symbols(self.sym_cap)
        self.recs = torch.zeros((K + 2, 6), dtype=torch.int32, device=dev)
        self.stats = self.recs[K + 1, :2]  # redos, overflow compactions
        self.k2_scratch = select_scratch(dev)
        self.host = [torch.empty((K + 2, 6), dtype=torch.int32,
                                 pin_memory=cuda) for _ in range(2)]
        self.events = [torch.cuda.Event() for _ in range(2)] if cuda \
            else None
        self.graphs = {} if cuda else None  # width -> _BlockGraph
        self._stream = None
        self.blocks = 0

    def queue_steps(self) -> None:
        """One block's launches, queued step by step."""
        st, recs = self.state, self.recs
        for k in range(self.K):
            rec = recs[k]
            if self.skip:
                st.guard(self.stats[1:])
            keys, counts, pos = st.pairs(self.skip)
            if self.wordpiece and not self.flat:
                st.count_symbols(self.sym_cap)
            select_unify(keys, counts, pos, self.h1, self.h2, self.sl,
                         self.ctrl, self.pw1, self.pw2, self.max_vocab, rec,
                         wordpiece=self.wordpiece, sym_freq=st.sym_freq,
                         sharp=self.sharp, tournament=self.tournament,
                         redo=self.stats[:1], claims=st.claims(),
                         scratch=self.k2_scratch)
            st.merge(rec, self.skip)
        if self.skip:
            st.close(recs[self.K])

    def dispatch(self, slot: int) -> None:
        """Queue the next block, then the copy of its records into host
        buffer ``slot`` (0 or 1), which :meth:`fetch` waits for."""
        width = self._width()
        if self.graphs is None:
            with profiling.phase("train.device_block"):
                self.queue_steps()
            profiling.count("train.eager_blocks")
            self.host[slot].copy_(self.recs)
        else:
            with torch.cuda.device(self.dev):
                if self.blocks == 0:
                    with profiling.phase("train.device_block", self.dev):
                        self.queue_steps()
                    profiling.count("train.eager_blocks")
                else:
                    self._replay()
                    profiling.count(f"train.graph_replays.{width}")
                self.host[slot].copy_(self.recs, non_blocking=True)
                self.events[slot].record()
        profiling.count("train.blocks")
        profiling.count(f"train.blocks.{width}")
        self.blocks += 1

    def _width(self) -> int:
        return getattr(self.state, "F", 0)

    def fetch(self, slot: int) -> np.ndarray:
        """The records of the block whose copy went to ``slot``, once
        they are on the host: int32[K + 2, 6]."""
        with profiling.phase("train.fetch_records"):
            if self.events is not None:
                self.events[slot].synchronize()
            return self.host[slot].numpy().copy()

    def drain(self) -> None:
        """Wait until every queued block has run."""
        if self.events is not None:
            torch.cuda.current_stream(self.dev).synchronize()

    def close(self) -> None:
        """Release the graphs (after the blocks that replay them)."""
        if self.graphs:
            self.drain()
            for g in self.graphs.values():
                g.graph.reset()
            self.graphs.clear()

    def _replay(self) -> None:
        key = self.state.host_key()
        g = self.graphs.get(self._width())
        if g is None:
            self._capture(key)
        elif key != g.host_key:
            raise RuntimeError(f"BlockRunner: a block at width "
                               f"{self._width()} starts from host values "
                               f"{key}, its graph was captured at "
                               f"{g.host_key}")
        else:
            scratch = getattr(self.state, "scratch", None)
            if scratch is not None:
                scratch.advance(g.k3_calls)
            with profiling.phase("train.device_block", self.dev):
                g.graph.replay()
            for name, n in g.launches.items():
                profiling.count(name, n)
        profiling.count("train.graph_replays")

    def _capture(self, key) -> None:
        """Capture :meth:`queue_steps` on a side stream and replay it
        once. The capture queues nothing to run, but the wrappers it calls
        count their launches and move the host values as the block moves
        them, back to ``key``."""
        with profiling.phase("train.capture"):
            launched = profiling.counters("launch.")
            scratch = getattr(self.state, "scratch", None)
            if scratch is not None:  # no restart of the epochs inside
                scratch.room(2 * self.K + 1)
            calls = scratch.calls if scratch is not None else 0
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(self._stream):
                # (capture_begin itself may allocate PyTorch's RNG state
                # for graphs, once: not the block's)
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    allocated = _allocations(self.dev)
                    self.queue_steps()
                    allocated = _allocations(self.dev) - allocated
                finally:
                    graph.capture_end()
            if allocated:
                raise RuntimeError(f"BlockRunner: the capture of a block "
                                   f"allocated device memory {allocated} "
                                   f"times")
            if self.state.host_key() != key:
                raise RuntimeError(f"BlockRunner: a block began at host "
                                   f"values {key} and ended at "
                                   f"{self.state.host_key()}")
            self.graphs[self._width()] = _BlockGraph(
                graph, key, profiling.counted_since(launched, "launch."),
                0 if scratch is None else scratch.calls - calls)
        with profiling.phase("train.device_block", self.dev):
            graph.replay()
        profiling.count("train.graph_captures")


def _allocations(dev) -> int:
    """Device allocations made so far on ``dev`` (the caching
    allocator's count)."""
    return torch.cuda.memory_stats(dev).get("allocation.all.allocated", 0)


def run_fused(state: FlatState, table, max_vocab: int, max_len: int,
              on_merge, K: int = 256, checkpoint_cb=None,
              progress_cb=None, wordpiece: bool = False, flat: bool = True,
              skip: Optional[int] = None,
              wide_score: bool = False) -> np.ndarray:
    """Train on ``state`` until ``max_vocab`` symbols or no pair is left;
    return the final state as a padded host tensor [word types, L].

    Each block runs K steps (K1, K2, K3) with no host sync between them
    (:class:`BlockRunner`: on the card a run's first block step by step,
    every later one as one CUDA graph replay); every stop condition is
    enforced on the device, so steps past the end are no-ops. As in the
    JAX package's ``run_fused``, two blocks are in flight: block k + 1 is
    queued before block k's records are read. The block's [K, 6] records
    come back in one copy, and each active record is checked against
    ``table.intern`` (raising :class:`HashCollision` on a disagreement,
    once the block in flight has run) and reported with ``on_merge(sa,
    sb, merged)``. ``progress_cb(steps)`` and ``checkpoint_cb(steps)`` run
    after each block that merged; the caller keeps its own cadence. Once a
    record is inactive or ``max_vocab`` is reached, the block in flight is
    drained and never read. Before a block is queued the state shrinks to
    half its width while the live slots of the newest records read fit
    (a block later than the JAX package's host would see them, as there:
    the shrink only cuts a dead tail, and positions are unchanged).

    The profiler counts the size of the state (benchmarks/profiling.py):
    ``train.word_types``, ``train.slots`` (the live slots the run starts
    from) and, on the flat route that compacts every step, whose records
    carry each step's live slots, ``train.live_slots``: the sum over the
    merges learned of the live slots each step read. They come from the
    host's state and the records it reads anyway, with no wait of their
    own.

    With ``wordpiece`` the run first counts ``state.sym_freq`` with K4,
    selects by score, and merges into ``a + b[2:]``; the tournament
    (:func:`use_tournament`, narrow scores only: ``wide_score`` False)
    selects the same pairs without division.

    The routes of the JAX package's ``run_fused``, each with the same
    merges: ``skip`` (None: :func:`default_skip`, 0 with ``flat=False``)
    defers the compaction with that window, clamped as JAX clamps it to
    ``min(skip, 64, min(F, 8192) - 2)``: each step first compacts only
    when a live gap outgrows the window (:func:`~.flat.skip_guard`), K1
    and K3 run in skip mode, and each block ends compacted. ``flat=False``
    trains the padded layout instead (:class:`PaddedState`, K3p, no
    shrink; WordPiece recounts its weights with K4 every step).
    """
    if skip is None:
        skip = default_skip() if flat else 0
    tournament = use_tournament(wordpiece, wide_score)
    if len(table) >= max_vocab:
        return state.padded()
    live = state.n_live
    if live is None:  # merged before the run (a resumed train)
        live = int((state.arrays()[0] >= 0).sum())
    profiling.count("train.word_types", state.n_words)
    profiling.count("train.slots", live)
    if flat:
        skip = min(skip, 64, max(min(state.F, _FLAT_MIN) - 2, 0))
    else:
        state, skip = PaddedState.from_flat(state), 0
    count_live = flat and not skip
    read_live = 0  # live slots read by the merges learned
    with profiling.phase("train.loop_setup"):
        run = BlockRunner(state, table, max_vocab, max_len, K, wordpiece,
                          flat, skip, tournament)
    try:
        run.dispatch(0)
        pending = [0]  # host buffers of the blocks in flight, oldest first
        shrink_live = None  # the newest n_live read (it only decreases)
        stats = (0, 0)
        done = False
        while pending:
            if not done:
                if flat and shrink_live is not None and \
                        state.F >= 2 * _FLAT_MIN and \
                        shrink_live <= state.F // 2:
                    state.F //= 2
                run.dispatch(1 - pending[0])
                pending.append(1 - pending[0])
            recs_np = run.fetch(pending.pop(0))
            with profiling.phase("train.verify"):
                steps = 0
                for a, b, new_id, _, active, n_live in \
                        recs_np[:K].tolist():
                    if not active:
                        done = True
                        break
                    sa, sb = table.string(a), table.string(b)
                    merged = join(sa, sb, wordpiece)
                    nid = table.intern(merged)
                    if nid != new_id:
                        run.drain()
                        raise HashCollision(
                            f"step {len(table)}: device id {new_id} != "
                            f"host id {nid} for {merged!r}")
                    on_merge(sa, sb, merged)
                    steps += 1
                    read_live += live
                    live = n_live
            profiling.count("train.merges", steps)
            stats = tuple(int(x) for x in recs_np[K + 1, :2])
            if progress_cb is not None and steps:
                progress_cb(steps)
            if checkpoint_cb is not None and steps:
                checkpoint_cb(steps)
            if len(table) >= max_vocab:
                done = True
            if steps and flat:
                shrink_live = int(recs_np[K if skip else steps - 1, N_LIVE])
            if done:
                # the block in flight continues a finished run: no-ops,
                # never read
                run.drain()
                pending.clear()
        redos, overflows = stats
        profiling.count("train.redos", redos)
        profiling.count("train.overflow_compactions", overflows)
        if count_live:
            profiling.count("train.live_slots", read_live)
        with profiling.phase("train.final_fetch"), \
                profiling.phase("train.final_copy"):
            return state.padded()
    finally:
        with profiling.phase("train.close"):
            run.close()


# device -> (empty, ctrl) for select_host_ids: host_ids mode never writes
# them, so they are made once, not allocated and filled every call
_HOST_IDS_ARGS = {}


def select_host_ids(keys, counts, pos, rec, sym_freq=None,
                    claims: Optional[PairTable] = None,
                    scratch: Optional[torch.Tensor] = None, kth=None,
                    wide_score: bool = False) -> None:
    """K2's selection only, over a pair table (either form of
    ops/pairstats.pair_stats): ``rec`` gets (a, b, -1, 0, active) of the
    pair of largest count, or with ``sym_freq`` of largest exact score,
    then least position; active = the metric is positive. ``claims``,
    ``scratch``, and ``kth`` with ``wide_score`` (the top-K tier's
    certificate into ``rec[5]``, in the same launch) as for
    :func:`select_unify`."""
    dev = keys.device
    args = _HOST_IDS_ARGS.get(dev)
    if args is None:
        args = _HOST_IDS_ARGS[dev] = (
            torch.zeros(1, dtype=torch.int64, device=dev),
            torch.zeros(3, dtype=torch.int32, device=dev))
    empty, ctrl = args
    select_unify(keys, counts, pos, empty, empty, empty, ctrl, empty, empty,
                 0, rec, host_ids=True, wordpiece=sym_freq is not None,
                 sym_freq=sym_freq, claims=claims, scratch=scratch, kth=kth,
                 wide_score=wide_score)


def join(sa: str, sb: str, wordpiece: bool) -> str:
    """The symbol that merging ``sa`` with ``sb`` makes: ``sa + sb``, or
    with ``wordpiece`` ``sa + sb[2:]`` (``sb`` without its "##")."""
    return sa + (sb[2:] if wordpiece else sb)


def select_ids(state: FlatState, rec,
               wordpiece: bool = False) -> Optional[Tuple[int, int]]:
    """The exact per-step selection: K1, then K2's selection only. The
    (a, b) of the next merge, or None when no pair is left. With
    ``wordpiece`` the caller has counted ``state.sym_freq``
    (:meth:`FlatState.count_symbols`) and K3 carries it."""
    select_host_ids(*state.pairs(), rec, state.sym_freq if wordpiece
                    else None, claims=state.claims())
    a, b, _, _, active = rec[:ACTIVE + 1].tolist()
    return (a, b) if active else None


def step_host_ids(state: FlatState, table, rec,
                  wordpiece: bool = False) -> Optional[Tuple[str, str, str]]:
    """One exact per-step merge: :func:`select_ids`, interning on the
    host, K3 with the host's id. Returns (sa, sb, merged), or None when
    no pair is left (nothing is merged then)."""
    got = select_ids(state, rec, wordpiece)
    if got is None:
        return None
    sa, sb = table.string(got[0]), table.string(got[1])
    merged = join(sa, sb, wordpiece)
    rec[NEW_ID] = table.intern(merged)
    state.merge(rec)
    return sa, sb, merged


def merge_host_ids(state: FlatState, a: int, b: int, new_id: int,
                   rec) -> None:
    """K3 with ids the host already knows (resume replay)."""
    rec.copy_(torch.tensor([a, b, new_id, 0, 1, 0], dtype=torch.int32))
    state.merge(rec)


def _flat_to_padded(fs: np.ndarray, wid: np.ndarray, n_words: int):
    """Rebuild a padded [n_words, max_len] host tensor from flat state."""
    live = fs >= 0
    fs = fs[live]
    wid = wid[live]
    counts = np.bincount(wid, minlength=n_words)
    L = max(int(counts.max()) if counts.size else 1, 1)
    out = np.full((n_words, L), -1, dtype=np.int32)
    # flat order is word-major: position within word = running index
    offs = np.zeros(n_words + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    pos = np.arange(fs.size, dtype=np.int64) - offs[wid]
    out[wid, pos] = fs
    return out
