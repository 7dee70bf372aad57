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
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import check_tensor

WID_PAD = 2 ** 30
# A step's int32 record is (a, b, new_id, matched, active, n_live): K2
# (ops/train_loop.select_unify) writes the first five, K3 reads a, b,
# new_id and active and writes n_live.
NEW_ID, ACTIVE, N_LIVE = 2, 4, 5


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
                sym_freq=None):
    """Apply one merge to the flat state and left-compact it.

    ``rec`` is the step's int32[6] record (see ``N_LIVE``):
    every non-overlapping (a, b) adjacency within a word becomes
    ``new_id`` (the right slot dies), scanning left to right as the
    reference does; with ``active == 0`` nothing is merged. Live slots
    are compacted to the front, stably; the rest is padding.

    Writes ``rec[N_LIVE]`` (live slots after the step) and returns
    (fs, wid, wgt, n_rep): the new state, in ``out`` when given (three
    tensors like the inputs, none of them an input), and int64 ``n_rep``,
    the total weight of the replacements.

    ``sym_freq`` (int64, WordPiece's per-symbol weights, or None) is
    updated in place when the step is active: ``n_rep`` off ``a`` and
    off ``b`` (twice off ``a`` for a self-merge), onto ``new_id``.

    Launches the CUDA kernel for CUDA tensors, runs the PyTorch version
    for CPU tensors, and raises for any other device.
    """
    dev = fs.device
    check_tensor("fs", fs, (torch.int32,), 1, dev)
    check_tensor("wid", wid, (torch.int32,), 1, dev)
    check_tensor("wgt", wgt, (torch.int64,), 1, dev)
    check_tensor("rec", rec, (torch.int32,), 1, dev)
    F = fs.shape[0]
    if wid.shape[0] != F or wgt.shape[0] != F or rec.shape[0] != 6:
        raise ValueError("merge_apply: inconsistent shapes")
    if F < 2 or F >= 2 ** 31:
        raise ValueError(f"merge_apply: width {F} outside [2, 2**31)")
    if sym_freq is not None:
        check_tensor("sym_freq", sym_freq, (torch.int64,), 1, dev)
    if dev.type == "cpu":
        nfs, nwid, nwgt, n_rep = merge_apply_ref(fs, wid, wgt, rec, sym_freq)
        if out is None:
            return nfs, nwid, nwgt, n_rep
        for dst, src in zip(out, (nfs, nwid, nwgt)):
            dst.copy_(src)
        return (*out, n_rep)
    if dev.type != "cuda":
        raise ValueError(f"merge_apply: no kernel for device {dev}")
    if out is None:
        out = (torch.empty_like(fs), torch.empty_like(wid),
               torch.empty_like(wgt))
    for name, o, like in zip(("out_fs", "out_wid", "out_wgt"), out,
                             (fs, wid, wgt)):
        check_tensor(name, o, (like.dtype,), 1, dev)
        if o.shape[0] != F or o.data_ptr() == like.data_ptr():
            raise ValueError(f"merge_apply: {name} must be a separate "
                             f"buffer of width {F}")
    nb = -(-F // 256)
    flags = torch.empty(F, dtype=torch.uint8, device=dev)
    blocks = torch.empty(2 * nb + 1, dtype=torch.int32, device=dev)
    n_rep = torch.empty((), dtype=torch.int64, device=dev)
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_merge_apply", fs.data_ptr(), wid.data_ptr(),
                     wgt.data_ptr(), F, rec.data_ptr(), out[0].data_ptr(),
                     out[1].data_ptr(), out[2].data_ptr(), flags.data_ptr(),
                     blocks.data_ptr(), n_rep.data_ptr(),
                     None if sym_freq is None else sym_freq.data_ptr())
    merge_apply.launches += 1
    if sym_freq is not None:
        merge_apply.wp_launches += 1
    return (*out, n_rep)


merge_apply.launches = 0
merge_apply.wp_launches = 0  # launches that carried WordPiece's sym_freq
