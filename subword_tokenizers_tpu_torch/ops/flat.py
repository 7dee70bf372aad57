"""The flat training state and the merge step over it (kernel K3).

The corpus of word types is one flat concatenation of symbol ids, as in
the JAX package's ``ops/flat.py``:

- ``fs``  : int32[F] symbol ids, word-major, padded with -1 at the end;
- ``wid`` : int32[F] word-type index of each slot (``WID_PAD`` on padding);
- ``wgt`` : int64[F] the word type's frequency at each of its slots.

The flat index is the reference's scan order (word type, then position),
and the left compaction after a merge shifts positions exactly as
rebuilding the reference's symbol lists does, so first-position
tie-breaks are unchanged. A pair (i, i+1) counts only within one word.
Weights are int64 whatever the corpus size: the JAX package's i32 weight
layout served its TPU's sort and never changes a result.

Deferred compaction (``skip`` = S > 0, the JAX package's
``SWT_SKIP_COMPACT``): a merge leaves the consumed slot dead (-1) where
it stands (:func:`merge_skip`), and a slot pairs with its nearest live
successor within S + 1 slots (:func:`skip_next`). Each merge also tests
the state it leaves for a live gap wider than the window
(:func:`skip_overflow`) into a gate word; before the next step,
:func:`skip_guard` compacts the state when the gate is open, so no pair
is missed; the training loop compacts in place at the end of each
block (:func:`skip_guard` with ``close``), which closes the gate.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..benchmarks import profiling
from . import check_tensor

WID_PAD = 2 ** 30
# A step's int32 record is (a, b, new_id, matched, active, n_live): K2
# (ops/train_loop.select_unify) writes the first five, K3 reads a, b,
# new_id and active and writes n_live.
NEW_ID, ACTIVE, N_LIVE = 2, 4, 5
TILE = 2048  # slots of one tile of K3's kernel (csrc/merge_apply.cu)
# the look-back epochs (csrc/lookback.cuh) of K3 and the table compaction
EPOCH_MAX = (1 << 30) - 1
EPOCH = 2  # a MergeScratch's epoch word: the last call's epoch
GATE = 3  # a MergeScratch's gate word: merge_skip's epoch << 1 | overflow


def build_flat(sym2d: np.ndarray, freq: np.ndarray, pad_to: int = 1024
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten a padded host tensor [n_types, max_len] into (fs, wid,
    wgt), padded at the end to a multiple of ``pad_to`` (at least 2)."""
    mask = sym2d >= 0
    fs = sym2d[mask].astype(np.int32)
    wid = np.nonzero(mask)[0].astype(np.int32)
    wgt = np.asarray(freq)[wid].astype(np.int64)
    n = fs.size
    F = -(-max(n, 2) // pad_to) * pad_to
    pad = F - n
    if pad:
        fs = np.concatenate([fs, np.full(pad, -1, np.int32)])
        wid = np.concatenate([wid, np.full(pad, WID_PAD, np.int32)])
        wgt = np.concatenate([wgt, np.zeros(pad, np.int64)])
    return fs, wid, wgt


def _check_state(what, fs, wid, wgt, rec, sym_freq) -> None:
    """Raise unless (fs, wid, wgt) is a flat state of one width in [2,
    2**31) on one device, with an int32[6] record (or None) and an
    optional int64 ``sym_freq`` there."""
    dev = fs.device
    check_tensor("fs", fs, (torch.int32,), 1, dev)
    check_tensor("wid", wid, (torch.int32,), 1, dev)
    check_tensor("wgt", wgt, (torch.int64,), 1, dev)
    if rec is not None:
        check_tensor("rec", rec, (torch.int32,), 1, dev)
    F = fs.shape[0]
    if wid.shape[0] != F or wgt.shape[0] != F or (
            rec is not None and rec.shape[0] != 6):
        raise ValueError(f"{what}: inconsistent shapes")
    if F < 2 or F >= 2 ** 31:
        raise ValueError(f"{what}: width {F} outside [2, 2**31)")
    if sym_freq is not None:
        check_tensor("sym_freq", sym_freq, (torch.int64,), 1, dev)


def _out_buffers(what, fs, wid, wgt, out):
    """``out``, or three new tensors like (fs, wid, wgt); each a separate
    buffer of the state's width."""
    if out is None:
        return (torch.empty_like(fs), torch.empty_like(wid),
                torch.empty_like(wgt))
    for name, o, like in zip(("out_fs", "out_wid", "out_wgt"), out,
                             (fs, wid, wgt)):
        check_tensor(name, o, (like.dtype,), 1, fs.device)
        if o.shape[0] != fs.shape[0] or o.data_ptr() == like.data_ptr():
            raise ValueError(f"{what}: {name} must be a separate buffer of "
                             f"width {fs.shape[0]}")
    return out


class MergeScratch:
    """K3's scratch for a flat state of width up to ``F`` on ``device``,
    built once by the state's owner (ops/train_loop.FlatState), so a
    merge, a skip merge or the skip route's guard allocates and clears
    nothing: ``words`` int64[4 + 2 ceil(F / TILE)] holds the merge's
    weight (``n_rep``, written by every merge), the tile ticket (0
    between calls), the epoch word (``EPOCH``: the last call's epoch)
    and the gate word (``GATE``: the last :func:`merge_skip`'s epoch << 1
    | whether the state it left overflows its window; 0, closed, once a
    compaction has run), then two words a tile (its look-back status and
    value).

    Both words live on the device and no call takes them from the host:
    each call's epoch is one past the epoch word, which the call
    advances, and each call's look-back words carry it, so a word of an
    earlier call is never read as this call's; :func:`skip_guard` reads
    the gate word itself, and :func:`merge_apply` and a guard that fired
    close it. So a CUDA graph of a training block (ops/train_loop.py)
    replays with the epochs and the gate the device holds. ``calls``
    counts on the host the calls queued since the epochs last restarted,
    at least the epoch word: :meth:`advance` restarts them before they
    would pass ``EPOCH_MAX``. A scratch serves one state."""

    def __init__(self, F: int, device) -> None:
        self.words = torch.zeros(_scratch_words(F), dtype=torch.int64,
                                 device=device)
        self.calls = 0

    @property
    def n_rep(self) -> torch.Tensor:
        """The last merge's weight (int64, 0-d, rewritten by each call)."""
        return self.words[0]

    @property
    def epoch(self) -> int:
        """The epoch word: the last call's epoch (a read of the device)."""
        return int(self.words[EPOCH])

    def room(self, n: int) -> None:
        """Make room for ``n`` more calls: when they could take the epoch
        word past ``EPOCH_MAX``, restart the epochs now (the epoch word
        and the look-back words zeroed on the device, queued before the
        calls), so no word of an earlier call carries a new epoch. The
        gate word is kept. A restart inside a CUDA graph's capture would
        be replayed with it, so it raises there: make room before one."""
        if self.calls + n <= EPOCH_MAX:
            return
        if (self.words.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError("MergeScratch: the epochs would restart "
                               "inside a capture")
        self.words[EPOCH] = 0
        self.words[4:].zero_()
        self.calls = 0

    def advance(self, n: int = 1) -> None:
        """Count ``n`` calls about to be queued (one call, or a replayed
        block's calls of K3's family), after :meth:`room` for them."""
        self.room(n)
        self.calls += n


def call_epoch(words) -> int:
    """The plain versions' epoch of a call with the scratch ``words``:
    one past the epoch word, as the kernels read it."""
    return (int(words[EPOCH]) + 1) & EPOCH_MAX


def _scratch_words(F: int) -> int:
    return 4 + 2 * -(-F // TILE)


def _check_scratch(what, scratch, F: int, dev) -> None:
    if not isinstance(scratch, MergeScratch):
        raise TypeError(f"{what}: scratch must be a MergeScratch, not "
                        f"{type(scratch).__name__}")
    if scratch.words.device != dev:
        raise ValueError(f"{what}: scratch on {scratch.words.device}, "
                         f"expected {dev}")
    if scratch.words.shape[0] < _scratch_words(F):
        raise ValueError(f"{what}: scratch for a width below {F}")


def merge_apply_ref(fs, wid, wgt, rec, sym_freq=None):
    """Plain PyTorch version of :func:`merge_apply` (same outputs, and
    the same writes of ``rec[N_LIVE]`` and ``sym_freq``)."""
    dev = fs.device
    F = fs.shape[0]
    ra, rb, new_id, _, active = rec[:N_LIVE].tolist()
    a, b = (ra, rb) if active else (-3, -3)
    neg = torch.full((1,), -1, dtype=torch.int32, device=dev)
    neg2 = torch.full((1,), -2, dtype=torch.int32, device=dev)
    nxt = torch.cat([fs[1:], neg])
    wnxt = torch.cat([wid[1:], neg2])
    match = (fs == a) & (nxt == b) & (wid == wnxt)
    if a == b:
        # Self-merge: within a run of equal symbols of one word, the
        # reference merges at even offsets from the run's start.
        prev = torch.cat([neg2, fs[:-1]])
        wprev = torch.cat([neg2, wid[:-1]])
        change = (fs != prev) | (wid != wprev)
        js = torch.arange(F, device=dev)
        run_start = torch.cummax(torch.where(change, js, 0), 0).values
        match &= ((js - run_start) & 1) == 0
    dead = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      match[:-1]])
    keep = (fs >= 0) & ~dead
    n_live = int(keep.sum())
    pad = F - n_live
    nfs = torch.cat([torch.where(match, new_id, fs)[keep],
                     torch.full((pad,), -1, dtype=torch.int32, device=dev)])
    nwid = torch.cat([wid[keep], torch.full((pad,), WID_PAD,
                                            dtype=torch.int32, device=dev)])
    nwgt = torch.cat([wgt[keep], torch.zeros(pad, dtype=torch.int64,
                                             device=dev)])
    rec[N_LIVE] = n_live
    n_rep = wgt[match].sum()
    if active and sym_freq is not None:
        sym_freq[ra] -= n_rep
        sym_freq[rb] -= n_rep
        sym_freq[new_id] += n_rep
    return nfs, nwid, nwgt, n_rep


def merge_apply(fs, wid, wgt, rec, out: Optional[tuple] = None,
                sym_freq=None, scratch: Optional[MergeScratch] = None):
    """Apply one merge to the flat state and left-compact it.

    ``rec`` is the step's int32[6] record (see ``N_LIVE``):
    every non-overlapping (a, b) adjacency within a word becomes
    ``new_id`` (the right slot dies), scanning left to right as the
    reference does; with ``active == 0`` nothing is merged. Live slots
    are compacted to the front, stably; the rest is padding.

    Writes ``rec[N_LIVE]`` (live slots after the step) and returns
    (fs, wid, wgt, n_rep): the new state, in ``out`` when given (three
    tensors like the inputs, none of them an input), and int64 ``n_rep``,
    the total weight of the replacements: with ``scratch`` (a
    :class:`MergeScratch` for a width of at least F on the same device,
    kept by the caller) its ``n_rep`` word, rewritten by the next call;
    the call advances the scratch's epoch word and, the new state being
    compacted, closes its gate.

    ``sym_freq`` (int64, WordPiece's per-symbol weights, or None) is
    updated in place when the step is active: ``n_rep`` off ``a`` and
    off ``b`` (twice off ``a`` for a self-merge), onto ``new_id``.

    On the card the call is one kernel launch (a tile of 2,048 slots a
    block, its offset by a look-back over ``scratch``'s status words) and,
    with ``out`` and ``scratch``, allocates nothing; without ``scratch`` it
    builds one for the call.

    Launches the CUDA kernel for CUDA tensors, runs the PyTorch version
    for CPU tensors, and raises for any other device.
    """
    dev = fs.device
    _check_state("merge_apply", fs, wid, wgt, rec, sym_freq)
    F = fs.shape[0]
    if scratch is not None:
        _check_scratch("merge_apply", scratch, F, dev)
    if dev.type == "cpu":
        nfs, nwid, nwgt, n_rep = merge_apply_ref(fs, wid, wgt, rec, sym_freq)
        if scratch is not None:
            scratch.advance()
            words = scratch.words
            words[0], words[EPOCH], words[GATE] = n_rep, call_epoch(words), 0
            n_rep = scratch.n_rep
        if out is None:
            return nfs, nwid, nwgt, n_rep
        for dst, src in zip(out, (nfs, nwid, nwgt)):
            dst.copy_(src)
        return (*out, n_rep)
    if dev.type != "cuda":
        raise ValueError(f"merge_apply: no kernel for device {dev}")
    out = _out_buffers("merge_apply", fs, wid, wgt, out)
    if any(t.data_ptr() % 16 for t in (fs, wid, wgt, *out)):
        raise ValueError("merge_apply: the state and its second buffer must "
                         "be 16-byte aligned")
    if scratch is None:
        scratch = MergeScratch(F, dev)
    scratch.advance()
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_merge_apply", fs.data_ptr(), wid.data_ptr(),
                     wgt.data_ptr(), F, rec.data_ptr(), out[0].data_ptr(),
                     out[1].data_ptr(), out[2].data_ptr(),
                     scratch.words.data_ptr(),
                     None if sym_freq is None else sym_freq.data_ptr())
    profiling.count("launch.merge_apply")
    if sym_freq is not None:
        profiling.count("launch.merge_apply.wp")
    return (*out, scratch.n_rep)


def _shift(x, k: int, fill):
    """x[i + k] (k > 0) or x[i - |k|] (k < 0), ``fill`` out of range."""
    out = torch.full_like(x, fill)
    if k > 0:
        out[:-k] = x[k:]
    else:
        out[-k:] = x[:k]
    return out


def skip_next(fs, wid, S: int):
    """(nsym, nwid): symbol and word of each slot's nearest live successor
    within ``S + 1`` slots, (-1, ``WID_PAD``) when there is none (the JAX
    package's ``skip_next``)."""
    nsym = torch.full_like(fs, -1)
    nwid = torch.full_like(wid, WID_PAD)
    for k in range(1, S + 2):
        cs = _shift(fs, k, -1)
        take = (nsym < 0) & (cs >= 0)
        nsym = torch.where(take, cs, nsym)
        nwid = torch.where(take, _shift(wid, k, WID_PAD), nwid)
    return nsym, nwid


def skip_prev_select(fs, S: int, payload, fill):
    """``payload`` at each slot's nearest live predecessor within ``S + 1``
    slots, ``fill`` where there is none."""
    out = torch.full_like(payload, fill)
    done = torch.zeros_like(fs, dtype=torch.bool)
    for k in range(1, S + 2):
        cs = _shift(fs, -k, -1)
        take = ~done & (cs >= 0)
        out = torch.where(take, _shift(payload, -k, fill), out)
        done |= cs >= 0
    return out


def skip_overflow(fs, wid, S: int) -> bool:
    """True when a live slot has no live successor within ``S + 1`` slots
    while a later live slot exists: the window would miss a pair. Across
    words too (conservative, as in the JAX package)."""
    live = fs >= 0
    found = skip_next(fs, wid, S)[0] >= 0
    later = torch.flip(torch.cummax(torch.flip(live.to(torch.int32), [0]),
                                    0).values, [0])
    later = _shift(later, 1, 0) > 0
    return bool((live & later & ~found).any())


def merge_skip_ref(fs, wid, wgt, rec, S: int, sym_freq=None, words=None):
    """Plain PyTorch version of :func:`merge_skip` (the JAX package's
    ``flat_skip_apply``, then ``skip_overflow`` of the state it leaves);
    returns the int64 ``n_rep``. With ``words`` (a :class:`MergeScratch`'s)
    it takes the call's epoch from the epoch word and writes ``n_rep``,
    the advanced epoch word and the gate word there, as the kernel
    does."""
    ra, rb, new_id, _, active = rec[:N_LIVE].tolist()
    a, b = (ra, rb) if active else (-3, -3)
    live = fs >= 0
    nsym, nwid = skip_next(fs, wid, S)
    match = live & (fs == a) & (nsym == b) & (nwid == wid)
    if a == b:
        # Self-merge: even offsets in a run of equal live symbols of one
        # word, counted over live slots (the compacted index cpos).
        change = ((fs != skip_prev_select(fs, S, fs, -2))
                  | (wid != skip_prev_select(fs, S, wid, -2)))
        cpos = torch.cumsum(live.to(torch.int64), 0) - 1
        start = torch.cummax(torch.where(change & live, cpos, 0), 0).values
        match &= ((cpos - start) & 1) == 0
    dead = live & skip_prev_select(fs, S, match, False)
    n_rep = wgt[match].sum()
    fs[match] = new_id
    fs[dead] = -1
    wid[dead] = WID_PAD
    wgt[dead] = 0
    if active and sym_freq is not None:
        sym_freq[ra] -= n_rep
        sym_freq[rb] -= n_rep
        sym_freq[new_id] += n_rep
    if words is not None:
        epoch = call_epoch(words)
        words[0], words[EPOCH] = n_rep, epoch
        words[GATE] = epoch << 1 | int(skip_overflow(fs, wid, S))
    return n_rep


def merge_skip(fs, wid, wgt, rec, S: int, sym_freq=None,
               scratch: Optional[MergeScratch] = None):
    """Apply one merge to the flat state in place, with window ``S``, and
    test the state it leaves for an overflow.

    Slot i matches when it is live, holds a, and its nearest live
    successor within ``S + 1`` slots (:func:`skip_next`) holds b in the
    same word; for a == b only at an even offset in its run of equal
    live symbols. A match takes new_id; the live slot after it dies where
    it stands (-1, ``WID_PAD``, 0). ``rec`` and ``sym_freq`` are as for
    :func:`merge_apply`; ``rec[N_LIVE]`` is not written.

    ``scratch`` (a :class:`MergeScratch` for a width of at least F on
    the same device, kept by the caller; without it one is built for the
    call) gets the gate word, :func:`skip_overflow` of the new state
    under this call's epoch (one past its epoch word, which the call
    advances), so the next :func:`skip_guard` with it compacts exactly
    when the state overflows. Returns ``n_rep``, the total weight of the
    replacements: the scratch's word, rewritten by the next call.

    On the card the call is one kernel launch (tiles of 2,048 slots, each
    staged once with 68 slots either side) and allocates nothing. Launches
    the CUDA kernel for CUDA tensors, runs the PyTorch version for CPU
    tensors, and raises for any other device.
    """
    dev = fs.device
    _check_state("merge_skip", fs, wid, wgt, rec, sym_freq)
    F = fs.shape[0]
    if not 0 < S <= min(F - 2, 64):
        raise ValueError(f"merge_skip: window {S} outside [1, "
                         f"{min(F - 2, 64)}]")
    if scratch is None:
        scratch = MergeScratch(F, dev)
    _check_scratch("merge_skip", scratch, F, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"merge_skip: no kernel for device {dev}")
    scratch.advance()
    if dev.type == "cpu":
        merge_skip_ref(fs, wid, wgt, rec, S, sym_freq, scratch.words)
        return scratch.n_rep
    if any(t.data_ptr() % 16 for t in (fs, wid)):
        raise ValueError("merge_skip: fs and wid must be 16-byte aligned")
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_merge_skip", fs.data_ptr(), wid.data_ptr(),
                     wgt.data_ptr(), F, S, rec.data_ptr(),
                     scratch.words.data_ptr(),
                     None if sym_freq is None else sym_freq.data_ptr())
    profiling.count("launch.merge_skip")
    return scratch.n_rep


def skip_guard_ref(fs, wid, wgt, count, words, close=None) -> None:
    """Plain PyTorch version of :func:`skip_guard`: when the gate word
    ``words[GATE]`` is open (bit 0 set), or with ``close``, compact (fs,
    wid, wgt) in place, advance the epoch word and close the gate; then
    add one to ``count``, or with ``close`` write the live slots to
    ``close[N_LIVE]``."""
    if close is None and not int(words[GATE]) & 1:
        return
    keep = fs >= 0
    n = int(keep.sum())
    for x, pad in ((fs, -1), (wid, WID_PAD), (wgt, 0)):
        x[:n] = x[keep]
        x[n:] = pad
    if close is None:
        count += 1
    else:
        close[N_LIVE] = n
    words[EPOCH], words[GATE] = call_epoch(words), 0


def skip_guard(fs, wid, wgt, count, scratch: MergeScratch,
               close=None) -> None:
    """Before a step of the skip route: when the gate word of ``scratch``
    is open (the last :func:`merge_skip` left the state overflowing its
    window, and no compaction ran since), compact the state in place
    (live slots to the front, in order; padding after), add one to
    ``count`` (int32[1]) and close the gate; else change nothing. The
    gate is read on the device: the host names no epoch and no gate.

    With ``close``, an int32[6] record (``count`` is then unused, and may
    be None), the call is a block's closing compaction: it compacts the
    state in place whatever the gate, writes the live slots to
    ``close[N_LIVE]``, closes the gate and counts nothing, so the state
    stays in the buffers it was in.

    On the card the call is one kernel launch, with no host sync: each
    block returns at once while the gate is closed, else the launch
    compacts as :func:`merge_apply` does, in place. Launches the CUDA
    kernel for CUDA tensors, runs the PyTorch version for CPU tensors,
    and raises for any other device.
    """
    dev = fs.device
    _check_state("skip_guard", fs, wid, wgt, close, None)
    if close is None:
        check_tensor("count", count, (torch.int32,), 1, dev)
    F = fs.shape[0]
    _check_scratch("skip_guard", scratch, F, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"skip_guard: no kernel for device {dev}")
    scratch.advance()
    if dev.type == "cpu":
        skip_guard_ref(fs, wid, wgt, count, scratch.words, close)
        return
    if any(t.data_ptr() % 16 for t in (fs, wid, wgt)):
        raise ValueError("skip_guard: the state must be 16-byte aligned")
    from . import _cuda
    with torch.cuda.device(dev):
        if close is None:
            _cuda.launch("swt_skip_guard", fs.data_ptr(), wid.data_ptr(),
                         wgt.data_ptr(), F, scratch.words.data_ptr(),
                         count.data_ptr())
        else:
            _cuda.launch("swt_skip_close", fs.data_ptr(), wid.data_ptr(),
                         wgt.data_ptr(), F, scratch.words.data_ptr(),
                         close.data_ptr())
            profiling.count("launch.skip_guard.close")
    profiling.count("launch.skip_guard")
