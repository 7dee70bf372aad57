"""Weighted pair counts of the flat training state (kernel K1).

For every distinct valid pair (a, b) of adjacent slots, ``fs[i] = a``
and ``fs[i+1] = b`` within one word, its count is the sum of ``wgt[i]``
over its occurrences and its first position the least such ``i``: the
reference's ``Counter`` of pairs with its first-insertion order. The JAX
package gets them by sorting (key, position) and aggregating runs
(``ops/pairstats.py`` ``_run_aggregate``, ``ops/flat.py``
``flat_aggregate``); the kernel inserts into a hash table instead.

With a window ``skip`` = S > 0 (deferred compaction, ops/flat.py) slot i
pairs instead with its nearest live successor within S + 1 slots, and
its position is the raw slot index i: deletion never reorders live
slots, so positions order the pairs as the JAX package's compacted
indices do. The padded layout [n, L] is counted as n * L slots with
``wid`` the row and ``wgt`` the row's weight (ops/train_loop.PaddedState).

A pair's key is ``a << 32 | b`` in int64; the kernel's table marks empty
entries with ``EMPTY_KEY``. Its layout has no counterpart in the plain
version, so the two are compared in :func:`canonical` form: the pairs
sorted by key, with counts and first positions.

In runs mode (:func:`pair_stats_runs`) the inputs are (key, count,
position) triples, every shard's compacted runs (ops/shard_select.py),
and the table sums their counts and keeps their least positions: the
compact tier of the data-parallel selection (parallel/train.py).

In grouped rows mode (:func:`pair_rows`) one launch counts the padded
rows of every shard of one device, each shard into its own table at
local positions ``row * L + j``, with no per-slot word ids or weights,
and empties the other half of a double buffer of tables: the data-parallel
step's K1 (parallel/train.py).

On the card :func:`pair_stats` and :func:`pair_stats_runs` fill a
:class:`PairTable`, which must be empty, and empty another in the same
launch: only the entries that table's last fill claimed, from its claim
list. Their callers keep two and alternate (:class:`TablePair`), so a
call is one kernel launch and no memset.

WordPiece also needs each symbol's total weight (kernel K4):
:func:`symbol_freqs` over the flat state's slots, counted once per run
and then carried by K3, and :func:`symbol_rows` over padded rows and
their row weights, every step of the padded route and of the
data-parallel step (one launch over a device's block of shards).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import check_tensor
from .flat import WID_PAD, skip_next

EMPTY_KEY = -1


def table_size(F: int) -> int:
    """Entries of the kernel's table for a state of width ``F``: the
    next power of two at or above 2(F-1), so it is at most half full."""
    T = 2
    while T < 2 * (F - 1):
        T <<= 1
    return T


def clean_table(F: int, device) -> Tuple[torch.Tensor, ...]:
    """(keys int64[T], counts int64[T], pos int32[T]) for a state of
    width up to ``F``, T = ``table_size(F)``, every entry empty (keys
    ``EMPTY_KEY``, counts 0, positions all ones)."""
    T = table_size(F)
    return (torch.full((T,), EMPTY_KEY, dtype=torch.int64, device=device),
            torch.zeros(T, dtype=torch.int64, device=device),
            torch.full((T,), -1, dtype=torch.int32, device=device))


class PairTable:
    """A K1 table on a CUDA device for :func:`pair_stats` and
    :func:`pair_stats_runs`: ``keys``/``counts`` int64 and ``pos`` int32
    of ``size`` entries (``table_size(F)`` for a state of width up to
    ``F``; a call uses the first ``table_size`` of its own width), the
    claim list ``claims`` int32 (the entries a fill claimed, indices into
    the whole buffer) and its two counters ``n`` int32[2]: fill number j
    counts its claims in ``n[j % 2]`` and zeroes the other, which the
    empty after the fill before read. Made empty; the host tracks
    ``fills`` and whether it holds a count (``dirty``), and the
    kernel's pointers (``ptrs``)."""

    def __init__(self, F: int, device) -> None:
        keys, counts, pos = clean_table(F, device)
        self.keys, self.counts, self.pos = keys, counts, pos
        self.size = keys.shape[0]
        # distinct pairs of a state of width F: at most F - 1 <= size / 2
        self.claims = torch.empty(self.size // 2, dtype=torch.int32,
                                  device=keys.device)
        self.n = torch.zeros(2, dtype=torch.int32, device=keys.device)
        self.fills = 0
        self.dirty = False
        self.ptrs = tuple(t.data_ptr() for t in (keys, counts, pos,
                                                  self.claims))

    def view(self, T: int):
        """(keys, counts, pos) of the first ``T`` entries."""
        return self.keys[:T], self.counts[:T], self.pos[:T]

    def counter(self) -> int:
        """The address of the counter of the last fill's claims (K2's
        claims mode reads it on the device; the host never does)."""
        return self.n.data_ptr() + 4 * ((self.fills - 1) % 2)

    def claimed(self) -> torch.Tensor:
        """The entries the last fill claimed, as int64 indices (the plain
        version's view of the claim list: one read of the counter)."""
        n = int(self.n[(self.fills - 1) % 2])
        return self.claims[:n].to(torch.int64)


class TablePair:
    """Two :class:`PairTable` for a state of width up to ``F``, used on
    alternate calls: each call of :meth:`pairs` fills one and empties
    the other, whose readers were queued before it."""

    def __init__(self, F: int, device) -> None:
        self.tables = (PairTable(F, device), PairTable(F, device))
        self._next = 0
        self.filled: Optional[PairTable] = None  # the last call's table

    def _take(self):
        fill = self.tables[self._next]
        self._next = 1 - self._next
        self.filled = fill
        return fill, self.tables[self._next]

    def claims(self) -> Optional[PairTable]:
        """The table the last call filled, for K2's claims mode
        (ops/train_loop.select_unify), or None when the call ran the plain
        version (CPU tensors: the table holds no count)."""
        t = self.filled
        return t if t is not None and t.dirty else None

    def host_key(self) -> tuple:
        """The host values that choose a call's tables and counters:
        which table is next and which was last filled, the parity of each
        table's fills (it chooses a counter) and whether it holds a
        count. A CUDA graph of calls is valid for as long as these are as
        they were at its capture (ops/train_loop.BlockRunner)."""
        return (self._next, None if self.filled is None else
                self.tables.index(self.filled)) + tuple(
                    (t.fills & 1, t.dirty) for t in self.tables)

    def pairs(self, fs, wid, wgt, skip: int = 0):
        """:func:`pair_stats` into this call's table."""
        fill, clear = self._take()
        return pair_stats(fs, wid, wgt, fill, skip, clear)

    def runs(self, rk, rc, rp):
        """:func:`pair_stats_runs` into this call's table."""
        fill, clear = self._take()
        return pair_stats_runs(rk, rc, rp, fill, clear)


def _launch_tables(name: str, table, clear, T: int, dev) -> tuple:
    """The kernel's table arguments: the table to fill (a clean
    PairTable of at least ``T`` entries) with its counters, and the
    claims of ``clear`` to empty (nothing when it holds no count). Marks
    both for after the launch."""
    if not isinstance(table, PairTable):
        raise TypeError(f"{name}: the table must be a PairTable (the "
                        f"kernel empties only what a fill claimed), not "
                        f"{type(table).__name__}")
    if table.keys.device != dev:
        raise ValueError(f"{name}: a table on {table.keys.device}, "
                         f"expected {dev}")
    if table.dirty:
        raise ValueError(f"{name}: the table holds a count; pass it as "
                         f"`clear` to a call that fills another first")
    if table.size < T:
        raise ValueError(f"{name}: table of {table.size} < {T}")
    if clear is not None:
        if not isinstance(clear, PairTable):
            raise TypeError(f"{name}: `clear` must be a PairTable")
        if clear is table or clear.keys.device != dev:
            raise ValueError(f"{name}: the table to empty must be another "
                             f"on {dev}")
    j = table.fills
    n0 = table.n.data_ptr()
    args = (*table.ptrs[:3], T, table.ptrs[3], n0 + 4 * (j % 2),
            n0 + 4 * ((j + 1) % 2))
    if clear is None or not clear.dirty:
        return args + (None,) * 5
    cn = clear.n.data_ptr() + 4 * ((clear.fills - 1) % 2)
    return args + (*clear.ptrs, cn)


def _mark(table, clear) -> None:
    table.fills += 1
    table.dirty = True
    if clear is not None:
        clear.dirty = False


def pair_stats_ref(fs, wid, wgt, skip: int = 0):
    """Plain PyTorch version: (keys, counts, first) int64, one entry per
    distinct pair, sorted by key."""
    dev = fs.device
    if skip:
        b, wb = skip_next(fs, wid, skip)
    else:
        b = torch.cat([fs[1:], fs.new_full((1,), -1)])
        wb = torch.cat([wid[1:], wid.new_full((1,), WID_PAD)])
    valid = (fs >= 0) & (b >= 0) & (wid == wb)
    pos = torch.nonzero(valid).flatten()
    keys, inv = torch.unique((fs[valid].to(torch.int64) << 32)
                             | b[valid].to(torch.int64), sorted=True,
                             return_inverse=True)
    counts = torch.zeros(keys.shape[0], dtype=torch.int64, device=dev)
    counts.scatter_add_(0, inv, wgt[valid])
    first = torch.full((keys.shape[0],), 2 ** 62, dtype=torch.int64,
                       device=dev)
    first.scatter_reduce_(0, inv, pos, "amin")
    return keys, counts, first


def canonical(keys, counts, pos):
    """A pair table in the plain version's form: the non-empty entries
    sorted by key, as (keys, counts, first) int64."""
    live = keys != EMPTY_KEY
    order = torch.argsort(keys[live])
    return (keys[live][order], counts[live][order],
            pos[live][order].to(torch.int64))


def pair_stats(fs, wid, wgt, table: Optional[PairTable] = None,
               skip: int = 0, clear: Optional[PairTable] = None):
    """Pair counts and first positions of a flat state (fs int32[F], wid
    int32[F], wgt int64[F]), with window ``skip`` (0: adjacent slots).

    For CUDA tensors, launches the kernel once into ``table``, an empty
    :class:`PairTable` of at least ``table_size(F)`` entries (a new one
    when None), and returns its first ``table_size(F)`` entries as
    (keys, counts, pos), empty entries keyed ``EMPTY_KEY``. The same
    launch empties ``clear``, another PairTable, if it holds a count:
    the other half of the caller's double buffer (:class:`TablePair`),
    whose readers must be queued before. For CPU tensors, runs the
    PyTorch version and returns its sorted (keys, counts, first). Both
    forms feed ops/train_loop.select_unify. Raises for any other device.
    """
    dev = fs.device
    check_tensor("fs", fs, (torch.int32,), 1, dev)
    check_tensor("wid", wid, (torch.int32,), 1, dev)
    check_tensor("wgt", wgt, (torch.int64,), 1, dev)
    F = fs.shape[0]
    if wid.shape[0] != F or wgt.shape[0] != F:
        raise ValueError("pair_stats: inconsistent shapes")
    if F < 2 or F >= 2 ** 31:
        raise ValueError(f"pair_stats: width {F} outside [2, 2**31)")
    if not 0 <= skip < max(F - 1, 1):
        raise ValueError(f"pair_stats: window {skip} outside [0, {F - 1})")
    if dev.type == "cpu":
        return pair_stats_ref(fs, wid, wgt, skip)
    if dev.type != "cuda":
        raise ValueError(f"pair_stats: no kernel for device {dev}")
    if table is None:
        table = PairTable(F, dev)
    T = table_size(F)
    args = _launch_tables("pair_stats", table, clear, T, dev)
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_pair_stats", fs.data_ptr(), wid.data_ptr(),
                     wgt.data_ptr(), F, *args, skip)
    _mark(table, clear)
    pair_stats.launches += 1
    if skip:
        pair_stats.skip_launches += 1
    return table.view(T)


pair_stats.launches = 0
pair_stats.skip_launches = 0  # launches with a window


def pair_stats_runs_ref(rk, rc, rp):
    """Plain PyTorch version of :func:`pair_stats_runs`: (keys, counts,
    first) int64, one entry per distinct key, sorted by key."""
    live = rk != EMPTY_KEY
    keys, inv = torch.unique(rk[live], sorted=True, return_inverse=True)
    counts = torch.zeros(keys.shape[0], dtype=torch.int64, device=rk.device)
    counts.scatter_add_(0, inv, rc[live])
    first = torch.full((keys.shape[0],), 2 ** 62, dtype=torch.int64,
                       device=rk.device)
    first.scatter_reduce_(0, inv, rp[live].to(torch.int64), "amin")
    return keys, counts, first


def pair_stats_runs(rk, rc, rp, table: Optional[PairTable] = None,
                    clear: Optional[PairTable] = None):
    """Aggregate runs (rk int64[M] keys, EMPTY_KEY for none; rc int64[M]
    counts; rp int32[M] positions, int64 on the CPU): per distinct key
    the summed count and the least position, in :func:`pair_stats`'s two
    forms (for CUDA tensors the first ``table_size(M + 1)`` entries of
    ``table``, an empty PairTable, new when None, with ``clear`` emptied
    in the same launch; the sorted plain form for CPU tensors). Raises
    for any other device.
    """
    dev = rk.device
    check_tensor("rk", rk, (torch.int64,), 1, dev)
    check_tensor("rc", rc, (torch.int64,), 1, dev)
    check_tensor("rp", rp, (torch.int32, torch.int64), 1, dev)
    M = rk.shape[0]
    if rc.shape[0] != M or rp.shape[0] != M:
        raise ValueError("pair_stats_runs: inconsistent shapes")
    if dev.type == "cpu":
        return pair_stats_runs_ref(rk, rc, rp)
    if dev.type != "cuda":
        raise ValueError(f"pair_stats_runs: no kernel for device {dev}")
    if rp.dtype != torch.int32:
        raise TypeError("pair_stats_runs: the kernel takes int32 positions")
    if table is None:
        table = PairTable(M + 1, dev)
    T = table_size(M + 1)
    args = _launch_tables("pair_stats_runs", table, clear, T, dev)
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_pair_stats_runs", rk.data_ptr(), rc.data_ptr(),
                     rp.data_ptr(), M, *args)
    _mark(table, clear)
    pair_stats_runs.launches += 1
    return table.view(T)


pair_stats_runs.launches = 0


def pair_rows_ref(sym, wgt, rows: int):
    """Plain PyTorch version of :func:`pair_rows`: per shard its (keys,
    counts, first) int64, one entry per distinct pair, sorted by key."""
    R, L = sym.shape
    dev = sym.device
    local = (torch.arange(rows, device=dev)[:, None] * L
             + torch.arange(L - 1, device=dev))
    out = []
    for lo in range(0, R, rows):
        s = sym[lo:lo + rows].to(torch.int64)
        a, b = s[:, :-1], s[:, 1:]
        valid = (a >= 0) & (b >= 0)
        keys, inv = torch.unique((a[valid] << 32) | b[valid], sorted=True,
                                 return_inverse=True)
        counts = torch.zeros(keys.shape[0], dtype=torch.int64, device=dev)
        counts.scatter_add_(0, inv, wgt[lo:lo + rows, None].expand_as(a)[
            valid])
        first = torch.full((keys.shape[0],), 2 ** 62, dtype=torch.int64,
                           device=dev)
        first.scatter_reduce_(0, inv, local[valid], "amin")
        out.append((keys, counts, first))
    return out


def _check_row_tables(tset, dev) -> None:
    """Check once that a TableSet's tables are K1 tables :func:`pair_rows`
    can fill or empty: int64 keys and counts, int32 positions, contiguous
    on ``dev``, a power-of-two size, 16-byte aligned."""
    if tset.k1_checked:
        return
    for keys, counts, pos in tset.tables:
        T = keys.shape[0]
        for name, t, dt in (("keys", keys, torch.int64),
                            ("counts", counts, torch.int64),
                            ("pos", pos, torch.int32)):
            check_tensor(name, t, (dt,), 1, dev)
            if t.shape[0] != T:
                raise ValueError("pair_rows: inconsistent table")
            if t.data_ptr() % 16:
                raise ValueError(f"pair_rows: {name} not 16-byte aligned")
        if T < 2 or T & (T - 1):
            raise ValueError(f"pair_rows: table size {T} is not a power "
                             f"of 2")
    tset.k1_checked = True


def pair_rows(sym, wgt, rows: int, tset=None, clear=None):
    """K1 over the padded rows of one device's consecutive shards, in one
    launch. ``sym`` int32[R, L] holds D = R / ``rows`` shards, shard i its
    rows ``[i * rows, (i + 1) * rows)``; ``wgt`` int64[R] the rows'
    weights. For each shard: every distinct pair (a, b) of adjacent slots
    of a row (both >= 0), the sum of the row weights over its occurrences
    and its least local position ``row * L + j``, rows counted from the
    shard's first.

    For CUDA tensors, launches ``swt_pair_rows`` once and returns the D
    tables of ``tset`` (a TableSet, ops/shard_select.py, which the caller
    builds once and must give): shard i's pairs go into its table i,
    a K1 table (keys, counts, pos) of at least ``table_size(rows * L)``
    entries that must be empty on entry, as :func:`clean_table` makes it
    or an earlier call's ``clear`` leaves it. ``clear``, if given, is the
    TableSet of other tables that the same launch empties, the other half
    of a double buffer (parallel/train.ShardBlock); the caller's readers
    of them must be queued before. For CPU tensors, runs the PyTorch
    version and returns each shard's sorted (keys, counts, first); given
    ``tset`` (CPU tables), it writes them at the front of the set's
    tables, every other entry empty, empties ``clear``'s tables, and
    returns the set's tables, as the card does. Raises for any other
    device.
    """
    dev = sym.device
    check_tensor("sym", sym, (torch.int32,), 2, dev)
    check_tensor("wgt", wgt, (torch.int64,), 1, dev)
    R, L = sym.shape
    if wgt.shape[0] != R:
        raise ValueError(f"pair_rows: {wgt.shape[0]} weights for {R} rows")
    if rows < 1 or R < 1 or R % rows or L < 1 or R * L >= 2 ** 31:
        raise ValueError(f"pair_rows: {R} x {L} rows in shards of {rows} "
                         f"(a positive multiple, fewer than 2**31 slots)")
    D = R // rows
    if dev.type == "cpu" and tset is None:
        return pair_rows_ref(sym, wgt, rows)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"pair_rows: no kernel for device {dev}")
    if tset is None:
        raise ValueError("pair_rows: CUDA tensors need the TableSet of "
                         "the tables to fill")
    for ts in (tset,) if clear is None else (tset, clear):
        if ts.desc.device != dev:
            raise ValueError(f"pair_rows: a TableSet on {ts.desc.device}, "
                             f"expected {dev}")
        _check_row_tables(ts, dev)
    if tset.D != D:
        raise ValueError(f"pair_rows: {tset.D} tables for {D} shards")
    need = table_size(rows * L)
    if any(tset.rows[6 * i + 3] < need for i in range(D)):
        raise ValueError(f"pair_rows: a table of fewer than {need} "
                         f"entries for {rows} x {L} rows")
    T_max = 0
    if clear is not None:
        if {tset.rows[6 * i] for i in range(D)}.intersection(
                clear.rows[6 * i] for i in range(clear.D)):
            raise ValueError("pair_rows: a table to empty is one to fill")
        T_max = max(clear.rows[6 * i + 3] for i in range(clear.D))
    if dev.type == "cpu":
        _fill_plain(pair_rows_ref(sym, wgt, rows), tset, clear)
        return list(tset.tables)
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_pair_rows", sym.data_ptr(), wgt.data_ptr(), R, L,
                     rows, tset.desc.data_ptr(),
                     None if clear is None else clear.desc.data_ptr(),
                     0 if clear is None else clear.D, T_max)
    pair_rows.launches += 1
    return list(tset.tables)


pair_rows.launches = 0


def _fill_plain(got, tset, clear) -> None:
    """The plain version's tables ``got`` written as CPU K1 tables: each
    shard's pairs at the front of its table of ``tset``, in key order,
    every other entry empty; ``clear``'s tables emptied."""
    for (keys, counts, pos), (k, c, p) in zip(tset.tables, got):
        n = k.shape[0]
        keys.fill_(EMPTY_KEY)
        counts.zero_()
        pos.fill_(-1)
        keys[:n], counts[:n], pos[:n] = k, c, p
    for keys, counts, pos in () if clear is None else clear.tables:
        keys.fill_(EMPTY_KEY)
        counts.zero_()
        pos.fill_(-1)


def symbol_freqs_ref(fs, wgt, sym_cap: int):
    """Plain PyTorch version of :func:`symbol_freqs`."""
    ok = (fs >= 0) & (fs <= sym_cap)
    out = torch.zeros(sym_cap + 1, dtype=torch.int64, device=fs.device)
    out.index_add_(0, torch.where(ok, fs, sym_cap).to(torch.int64),
                   torch.where(ok, wgt, 0))
    return out


def symbol_rows_ref(sym, wgt, sym_cap: int):
    """Plain PyTorch version of :func:`symbol_rows`."""
    n, L = sym.shape
    return symbol_freqs_ref(sym.reshape(-1),
                            wgt[:, None].expand(n, L).reshape(-1), sym_cap)


def _k4(name, sym, wgt, R: int, L: int, sym_cap: int, out, clear):
    """Launch K4 over R rows of L slots into ``out`` (zero on entry; new
    when None), emptying ``clear``; return ``out``."""
    dev = sym.device
    if out is None:
        out = torch.zeros(sym_cap + 1, dtype=torch.int64, device=dev)
    for what, t in (("out", out), ("clear", clear)):
        if t is None:
            continue
        check_tensor(what, t, (torch.int64,), 1, dev)
        if t.shape[0] != sym_cap + 1:
            raise ValueError(f"{name}: {what} of {t.shape[0]} entries, "
                             f"expected {sym_cap + 1}")
    if clear is not None and clear.data_ptr() == out.data_ptr():
        raise ValueError(f"{name}: the output to empty is the one to fill")
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_symbol_freqs", sym.data_ptr(), wgt.data_ptr(), R,
                     L, sym_cap, out.data_ptr(),
                     None if clear is None else clear.data_ptr(),
                     0 if clear is None else sym_cap + 1)
    return out


def _check_sym_cap(name: str, sym_cap: int) -> None:
    if not 0 <= sym_cap < 2 ** 31 - 1:
        raise ValueError(f"{name}: sym_cap {sym_cap} outside [0, 2**31 - 1)")


def symbol_freqs(fs, wgt, sym_cap: int, out=None):
    """Per-symbol total weight of a flat state (fs int32[F], wgt
    int64[F]): int64[sym_cap + 1], whose entry ``s`` sums ``wgt`` over
    the slots of symbol ``s``; ids below 0 or above ``sym_cap`` are
    dropped, and the last entry, the trash bucket, sums an id equal to
    ``sym_cap``, as the JAX package's segment sum does (WordPiece's
    ``freq_a``, ``freq_b``).

    Launches kernel K4 once for CUDA tensors, adding into ``out``
    (int64[sym_cap + 1], zero on entry; a new one when None) and
    returning it; runs the PyTorch version for CPU tensors, and raises
    for any other device.
    """
    dev = fs.device
    check_tensor("fs", fs, (torch.int32,), 1, dev)
    check_tensor("wgt", wgt, (torch.int64,), 1, dev)
    F = fs.shape[0]
    if wgt.shape[0] != F:
        raise ValueError("symbol_freqs: inconsistent shapes")
    if F < 1 or F >= 2 ** 31:
        raise ValueError(f"symbol_freqs: width {F} outside [1, 2**31)")
    _check_sym_cap("symbol_freqs", sym_cap)
    if dev.type == "cpu":
        return symbol_freqs_ref(fs, wgt, sym_cap)
    if dev.type != "cuda":
        raise ValueError(f"symbol_freqs: no kernel for device {dev}")
    out = _k4("symbol_freqs", fs, wgt, F, 1, sym_cap, out, None)
    symbol_freqs.launches += 1
    return out


symbol_freqs.launches = 0


def symbol_rows(sym, wgt, sym_cap: int, out=None, clear=None):
    """K4 over padded rows: ``sym`` int32[R, L] and the rows' weights
    ``wgt`` int64[R]; entry ``s`` of the int64[sym_cap + 1] result sums
    the row weights over the slots of symbol ``s`` (PAD and ids above
    ``sym_cap`` dropped; the trash bucket ``sym_cap`` sums that id, as in
    :func:`symbol_freqs`). Over a device's block
    of shards (parallel/train.ShardBlock) it is the sum of the shards'
    counts, that device's part of the mesh's sum.

    For CUDA tensors, launches kernel K4 once: it adds into ``out``
    (int64[sym_cap + 1], zero on entry; a new one when None), empties
    ``clear`` (another such vector, the other half of the caller's
    double buffer, whose readers must be queued before) in the same
    launch, and returns ``out``. For CPU tensors, runs the PyTorch
    version (``out`` and ``clear`` unused). Raises for any other device.
    """
    dev = sym.device
    check_tensor("sym", sym, (torch.int32,), 2, dev)
    check_tensor("wgt", wgt, (torch.int64,), 1, dev)
    R, L = sym.shape
    if wgt.shape[0] != R:
        raise ValueError(f"symbol_rows: {wgt.shape[0]} weights for {R} "
                         f"rows")
    if R < 1 or L < 1 or R * L >= 2 ** 31:
        raise ValueError(f"symbol_rows: {R} x {L} rows outside [1, 2**31) "
                         f"slots")
    _check_sym_cap("symbol_rows", sym_cap)
    if dev.type == "cpu":
        return symbol_rows_ref(sym, wgt, sym_cap)
    if dev.type != "cuda":
        raise ValueError(f"symbol_rows: no kernel for device {dev}")
    out = _k4("symbol_rows", sym, wgt, R, L, sym_cap, out, clear)
    symbol_rows.launches += 1
    return out


symbol_rows.launches = 0
