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

WordPiece also needs each symbol's total weight: :func:`symbol_freqs`
(kernel K4), counted once per run and then carried by K3.
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


def alloc_table(F: int, device) -> Tuple[torch.Tensor, ...]:
    """(keys int64[T], counts int64[T], pos int32[T]) for
    :func:`pair_stats` on a state of width up to ``F``."""
    T = table_size(F)
    return (torch.empty(T, dtype=torch.int64, device=device),
            torch.empty(T, dtype=torch.int64, device=device),
            torch.empty(T, dtype=torch.int32, device=device))


def clean_table(F: int, device) -> Tuple[torch.Tensor, ...]:
    """:func:`alloc_table` with every entry empty (keys ``EMPTY_KEY``,
    counts 0, positions all ones), as :func:`pair_rows` takes it."""
    keys, counts, pos = alloc_table(F, device)
    keys.fill_(EMPTY_KEY)
    counts.zero_()
    pos.fill_(-1)
    return keys, counts, pos


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


def pair_stats(fs, wid, wgt, table: Optional[tuple] = None,
               skip: int = 0):
    """Pair counts and first positions of a flat state (fs int32[F], wid
    int32[F], wgt int64[F]), with window ``skip`` (0: adjacent slots).

    For CUDA tensors, launches the kernel into ``table`` (from
    :func:`alloc_table`, allocated when None) and returns it as (keys,
    counts, pos), empty entries keyed ``EMPTY_KEY``. For CPU tensors,
    runs the PyTorch version and returns its sorted (keys, counts,
    first). Both forms feed ops/train_loop.select_unify. Raises for any
    other device.
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
        table = alloc_table(F, dev)
    keys, counts, pos = table
    T = keys.shape[0]
    for name, t, dt in (("keys", keys, torch.int64),
                        ("counts", counts, torch.int64),
                        ("pos", pos, torch.int32)):
        check_tensor(name, t, (dt,), 1, dev)
        if t.shape[0] != T:
            raise ValueError("pair_stats: inconsistent table")
    if T < table_size(F):
        raise ValueError(f"pair_stats: table of {T} < {table_size(F)}")
    # The kernel probes with a power-of-two mask.
    if T & (T - 1):
        raise ValueError(f"pair_stats: table size {T} is not a power of 2")
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_pair_stats", fs.data_ptr(), wid.data_ptr(),
                     wgt.data_ptr(), F, keys.data_ptr(), counts.data_ptr(),
                     pos.data_ptr(), T, skip)
    pair_stats.launches += 1
    if skip:
        pair_stats.skip_launches += 1
    return table


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


def pair_stats_runs(rk, rc, rp, table: Optional[tuple] = None):
    """Aggregate runs (rk int64[M] keys, EMPTY_KEY for none; rc int64[M]
    counts; rp int32[M] positions, int64 on the CPU): per distinct key
    the summed count and the least position, in :func:`pair_stats`'s two
    forms (a table of at least ``table_size(M + 1)`` entries for CUDA
    tensors, allocated when None; the sorted plain form for CPU tensors).
    Raises for any other device.
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
        table = alloc_table(M + 1, dev)
    keys, counts, pos = table
    T = keys.shape[0]
    if (counts.shape[0] != T or pos.shape[0] != T or T < table_size(M + 1)
            or T & (T - 1)):
        raise ValueError(f"pair_stats_runs: bad table of {T} entries for "
                         f"{M} runs")
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_pair_stats_runs", rk.data_ptr(), rc.data_ptr(),
                     rp.data_ptr(), M, keys.data_ptr(), counts.data_ptr(),
                     pos.data_ptr(), T)
    pair_stats_runs.launches += 1
    return table


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
    version and returns each shard's sorted (keys, counts, first). Raises
    for any other device.
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
    if dev.type == "cpu":
        return pair_rows_ref(sym, wgt, rows)
    if dev.type != "cuda":
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
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_pair_rows", sym.data_ptr(), wgt.data_ptr(), R, L,
                     rows, tset.desc.data_ptr(),
                     None if clear is None else clear.desc.data_ptr(),
                     0 if clear is None else clear.D, T_max)
    pair_rows.launches += 1
    return list(tset.tables)


pair_rows.launches = 0


def symbol_freqs_ref(fs, wgt, sym_cap: int):
    """Plain PyTorch version of :func:`symbol_freqs`."""
    ok = (fs >= 0) & (fs < sym_cap)
    out = torch.zeros(sym_cap + 1, dtype=torch.int64, device=fs.device)
    out.index_add_(0, torch.where(ok, fs, sym_cap).to(torch.int64),
                   torch.where(ok, wgt, 0))
    return out


def symbol_freqs(fs, wgt, sym_cap: int):
    """Per-symbol total weight of a flat state (fs int32[F], wgt
    int64[F]): int64[sym_cap + 1], whose entry ``s`` sums ``wgt`` over
    the slots of symbol ``s``; the last entry is the trash bucket of the
    padding and stays 0 (WordPiece's ``freq_a``, ``freq_b``).

    Launches kernel K4 for CUDA tensors, runs the PyTorch version for
    CPU tensors, and raises for any other device.
    """
    dev = fs.device
    check_tensor("fs", fs, (torch.int32,), 1, dev)
    check_tensor("wgt", wgt, (torch.int64,), 1, dev)
    F = fs.shape[0]
    if wgt.shape[0] != F:
        raise ValueError("symbol_freqs: inconsistent shapes")
    if F < 1 or F >= 2 ** 31 or sym_cap < 0:
        raise ValueError(f"symbol_freqs: width {F} outside [1, 2**31) or "
                         f"sym_cap {sym_cap} < 0")
    if dev.type == "cpu":
        return symbol_freqs_ref(fs, wgt, sym_cap)
    if dev.type != "cuda":
        raise ValueError(f"symbol_freqs: no kernel for device {dev}")
    out = torch.empty(sym_cap + 1, dtype=torch.int64, device=dev)
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_symbol_freqs", fs.data_ptr(), wgt.data_ptr(), F,
                     sym_cap, out.data_ptr())
    symbol_freqs.launches += 1
    return out


symbol_freqs.launches = 0
