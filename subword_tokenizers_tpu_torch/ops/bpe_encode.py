"""Batched BPE encoding: the per-word merge loop (kernel 5).

Same semantics as the JAX package's ``ops/bpe_encode.py``
(``bpe_encode``, with ``_pack``, ``_lookup`` and ``_apply_rows``), for
both encoders:

- **greedy** (FastBPE): repeatedly merge the present pair of lowest
  rank, ranks from a dict over the merge list (later duplicates
  overwrite);
- **monotone** (NaiveBPE, which applies every merge once, in order):
  repeatedly merge the lowest-ranked present pair whose rank is at least
  a per-word cursor, which then moves past the applied rank.

Each trip merges every occurrence of the chosen pair left to right
without overlap (in a run ``a a a a`` of a self-pair only pairs at even
offsets of the run merge) and compacts the row left. A pair with a PAD
(-1) member never matches. :func:`bpe_encode_ref` keeps the JAX
program's lockstep loop for any row; the wrapper takes rows whose PADs
all sit at their right end, as the front end builds them, where each
row's trips run on their own.

Ranks come from an open-addressing hash over the packed pair key
``(a << SYM_BITS) | b``: slot ``((key * HASH_GOLD) >> 29) & (H - 1)``
in signed 64-bit arithmetic, then linear probing.
:func:`build_rank_hash` builds it on the host and mirrors that
arithmetic exactly.

- :func:`bpe_encode` is the wrapper: on CUDA tensors it launches the
  hand-written kernel ``csrc/bpe_encode.cu`` (a warp per word, which also
  checks the rows' layout as it loads them), on CPU tensors it runs the
  plain PyTorch version :func:`bpe_encode_ref`.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from ..benchmarks import profiling
from . import check_tensor as _check

SYM_BITS = 21  # symbol ids per packed pair key, as in the JAX package
PAD = -1
I32_INF = 2 ** 31 - 1
HASH_GOLD = -7046029254386353131  # 2^64 / golden ratio, signed
HASH_SHIFT = 29


def build_rank_hash(entries: Iterable[Tuple[int, int, int]]
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Open-addressing table for (packed pair key) -> (rank, merged id).

    ``entries``: (key, rank, out_id) triples. Returns (hkeys i64[H],
    hrank i32[H], hout i32[H], max_probe), H a power of two at least four
    times the entries; empty slots hold key -1.
    """
    entries = list(entries)
    H = 8
    while H < 4 * max(len(entries), 1):
        H *= 2
    hkeys = np.full(H, -1, dtype=np.int64)
    hrank = np.zeros(H, dtype=np.int32)
    hout = np.zeros(H, dtype=np.int32)
    max_probe = 1
    keys = np.asarray([e[0] for e in entries], dtype=np.int64)
    with np.errstate(over="ignore"):
        # The device's hash: signed wrapping multiply, arithmetic shift.
        bases = ((keys * np.int64(HASH_GOLD)) >> HASH_SHIFT) & (H - 1)
    for (key, rank, out), h in zip(entries, bases.tolist()):
        probes = 1
        while hkeys[h] != -1:
            h = (h + 1) & (H - 1)
            probes += 1
        hkeys[h] = key
        hrank[h] = rank
        hout[h] = out
        max_probe = max(max_probe, probes)
    return hkeys, hrank, hout, max_probe


def _pack(sym):
    a = sym[:, :-1].to(torch.int64)
    b = sym[:, 1:].to(torch.int64)
    valid = (a >= 0) & (b >= 0)
    keys = torch.where(valid, (a << SYM_BITS) | b, -1)
    return keys, valid


def _lookup(hkeys, hrank, hout, keys, valid, max_probe):
    """(rank or I32_INF, merged id) of each key, probing max_probe slots."""
    H = hkeys.shape[0]
    base = ((keys * HASH_GOLD) >> HASH_SHIFT) & (H - 1)
    rank = torch.full(keys.shape, I32_INF, dtype=torch.int32,
                      device=keys.device)
    out = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    for p in range(max_probe):
        idx = (base + p) & (H - 1)
        hit = valid & (hkeys[idx] == keys) & (rank == I32_INF)
        rank = torch.where(hit, hrank[idx], rank)
        out = torch.where(hit, hout[idx], out)
    return rank, out


def _apply_rows(sym, a, b, new):
    """Merge (a[r], b[r]) -> new[r] in every row r, then compact left."""
    n, L = sym.shape
    dev = sym.device
    a, b = a[:, None], b[:, None]
    nxt = torch.cat([sym[:, 1:], torch.full((n, 1), PAD, dtype=sym.dtype,
                                            device=dev)], dim=1)
    match = (sym == a) & (nxt == b)
    js = torch.arange(L, device=dev)[None, :].expand(n, L)
    prev = torch.cat([torch.full((n, 1), -2, dtype=sym.dtype, device=dev),
                      sym[:, :-1]], dim=1)
    run_start = torch.cummax(torch.where(sym != prev, js, 0), dim=1).values
    parity_ok = ((js - run_start) & 1) == 0
    match = match & torch.where(a == b, parity_ok, True)
    dead = torch.cat([torch.zeros((n, 1), dtype=torch.bool, device=dev),
                      match[:, :-1]], dim=1)
    keep = (sym >= 0) & ~dead
    newsym = torch.where(match, new[:, None], sym)
    newsym = torch.where(keep, newsym, PAD)
    order = torch.sort((~keep).to(torch.int32), dim=1, stable=True).indices
    return torch.gather(newsym, 1, order)


def bpe_encode_ref(sym, hkeys, hrank, hout, monotone: bool, max_probe: int):
    """Plain PyTorch version of the kernel: every row takes its trip in
    lockstep, as the JAX program does, until no row found a pair.
    Returns (merged int32[W, L], out_n int32[W])."""
    return _lockstep(sym, hkeys, hrank, hout, monotone, max_probe)[:2]


def bpe_encode_trips(sym, hkeys, hrank, hout, monotone: bool,
                     max_probe: int):
    """The trips each row takes (int64[W]), its last, which finds no pair,
    included: the chain of dependent probes the kernel's warp for that row
    runs, and in all the work of the kernel's warps."""
    return _lockstep(sym, hkeys, hrank, hout, monotone, max_probe)[2]


def _lockstep(sym, hkeys, hrank, hout, monotone: bool, max_probe: int):
    W, L = sym.shape
    merged = sym
    trips = torch.ones(W, dtype=torch.int64, device=sym.device)
    if W > 0 and L >= 2 and hkeys.shape[0] > 0:
        cursor = torch.zeros(W, dtype=torch.int32, device=sym.device)
        rows = torch.arange(W, device=sym.device)
        while True:
            keys, valid = _pack(merged)
            rank, out_tab = _lookup(hkeys, hrank, hout, keys, valid,
                                    max_probe)
            if monotone:
                rank = torch.where(rank >= cursor[:, None], rank, I32_INF)
            best, bi = torch.min(rank, dim=1)
            active = best < I32_INF
            sel = keys[rows, bi]
            a = torch.where(active, (sel >> SYM_BITS).to(torch.int32), -3)
            b = torch.where(active, (sel & ((1 << SYM_BITS) - 1))
                            .to(torch.int32), -3)
            merged = _apply_rows(merged, a, b, out_tab[rows, bi])
            if monotone:
                cursor = torch.where(active, best + 1, cursor)
            trips += active
            if not bool(active.any()):
                break
    out_n = (merged >= 0).sum(dim=1).to(torch.int32)
    return merged.to(torch.int32), out_n, trips


def bpe_encode(sym, hkeys, hrank, hout, monotone: bool, max_probe: int):
    """Encode every row of ``sym`` (int32[W, L] symbol ids, PAD = -1).

    hkeys int64[H], hrank / hout int32[H]: the rank hash of
    :func:`build_rank_hash` (H a power of two) and its ``max_probe``.
    ``monotone``: NaiveBPE's cursor rule; else FastBPE's greedy rule.

    Every entry is PAD or an id >= 0, and a row's PADs all sit at its
    right end (a ValueError otherwise: on the CPU one reduction over
    ``sym``; on the card the kernel checks each row as it loads it and
    the wrapper reads one word back).

    Returns (merged int32[W, L] PAD-filled on the right, out_n int32[W]
    symbols per row). Launches the CUDA kernel for CUDA tensors, runs
    the PyTorch version for CPU tensors, and raises for any other device.
    """
    dev = sym.device
    _check("sym", sym, (torch.int32,), 2, dev)
    _check("hkeys", hkeys, (torch.int64,), 1, dev)
    _check("hrank", hrank, (torch.int32,), 1, dev)
    _check("hout", hout, (torch.int32,), 1, dev)
    H = hkeys.shape[0]
    if hrank.shape[0] != H or hout.shape[0] != H:
        raise ValueError("bpe_encode: inconsistent hash table shapes")
    if H == 0 or H & (H - 1) or not 1 <= max_probe <= H:
        raise ValueError(f"bpe_encode: bad hash table (H={H}, "
                         f"max_probe={max_probe})")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"bpe_encode: no kernel for device {dev}")
    if dev.type == "cpu":
        pad = sym < 0
        if bool((sym < PAD).any() | (pad[:, :-1] & ~pad[:, 1:]).any()):
            raise ValueError(_BAD_LAYOUT)
        return bpe_encode_ref(sym, hkeys, hrank, hout, monotone, max_probe)
    W, L = sym.shape
    merged = torch.empty_like(sym)
    out_n = torch.empty(W, dtype=torch.int32, device=dev)
    if W == 0:
        return merged, out_n
    flag, epoch = _layout_flag(dev)
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_bpe_encode", sym.data_ptr(), W, L,
                     hkeys.data_ptr(), hrank.data_ptr(), hout.data_ptr(), H,
                     int(bool(monotone)), int(max_probe), merged.data_ptr(),
                     out_n.data_ptr(), flag.data_ptr(), epoch)
    profiling.count("launch.bpe_encode")
    if int(flag.item()) == epoch:
        raise ValueError(_BAD_LAYOUT)
    return merged, out_n

_BAD_LAYOUT = "bpe_encode: a row holds an id < -1 or a PAD before an id"
_FLAGS = {}  # device -> [the kernel's layout flag word, the last epoch]


def _layout_flag(dev):
    """The layout flag word on ``dev`` (made once) and this call's epoch:
    a bad row sets the word to the epoch, so the word needs no clearing
    between calls; it is cleared once when the epochs wrap."""
    entry = _FLAGS.get(dev)
    if entry is None or entry[1] == I32_INF:
        if entry is None:
            entry = _FLAGS[dev] = [torch.zeros(1, dtype=torch.int32,
                                               device=dev), 0]
        entry[0].zero_()
        entry[1] = 0
    entry[1] += 1
    return entry[0], entry[1]
