"""The merge step over the padded training state (kernel K3p).

The padded layout is the JAX package's first one: int32[n, L], a row per
word type, symbol ids left-aligned and padded with -1. Its
``ops/merge.py`` ``apply_merge`` replaces every non-overlapping (a, b)
adjacency with ``new_id`` as the reference scans a word left to right
(for a == b, at even offsets from the start of a run of a), and
left-compacts each row. The flat layout (ops/flat.py) is the port's
default; the padded one serves ``run_fused(flat=False)`` and the shards
of the data-parallel layer (parallel/train.py).
"""
from __future__ import annotations

import operator

import torch

from . import check_tensor
from .flat import N_LIVE


def apply_merge_ref(sym, rec=None, merge=None):
    """Plain PyTorch version of :func:`apply_merge` (JAX's formula: the
    parity of the offset in a run, then a stable compaction); returns the
    new tensor."""
    n, L = sym.shape
    if merge is not None:
        a, b, new_id = merge
    else:
        ra, rb, new_id, _, active = rec[:N_LIVE].tolist()
        a, b = (ra, rb) if active else (-3, -3)
    nxt = torch.cat([sym[:, 1:], sym.new_full((n, 1), -1)], 1)
    match = (sym == a) & (nxt == b)
    if a == b:
        js = torch.arange(L, device=sym.device).expand(n, L)
        prev = torch.cat([sym.new_full((n, 1), -2), sym[:, :-1]], 1)
        start = torch.cummax(torch.where(sym != prev, js, 0), 1).values
        match &= ((js - start) & 1) == 0
    dead = torch.cat([torch.zeros_like(match[:, :1]), match[:, :-1]], 1)
    keep = (sym >= 0) & ~dead
    new = torch.where(match, new_id, sym)
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    return torch.where(torch.gather(keep, 1, order),
                       torch.gather(new, 1, order), -1)


def apply_merge(sym, rec=None, *, merge=None):
    """Apply one merge to the padded state ``sym`` (int32[n, L]) in place
    and return it. The merge is either ``rec``, the step's int32[6]
    record (ops/flat.py) on the device, whose a, b and new_id the kernel
    reads there (an inactive step only compacts the rows), or ``merge`` =
    (a, b, new_id), ids the host knows, which go to the kernel as its
    arguments: no record and no copy (the mesh's merge,
    parallel/train.py). Exactly one of the two.

    Launches kernel K3p (``csrc/merge_rows.cu``) once for CUDA tensors,
    whatever ``n``: one device's shards merge in one call over their
    block of rows. Runs the PyTorch version for CPU tensors, and raises
    for any other device.
    """
    dev = sym.device
    check_tensor("sym", sym, (torch.int32,), 2, dev)
    n, L = sym.shape
    if (rec is None) == (merge is None):
        raise ValueError("apply_merge: give either the record or the "
                         "merge")
    if rec is not None:
        check_tensor("rec", rec, (torch.int32,), 1, dev)
        if rec.shape[0] != 6:
            raise ValueError("apply_merge: rec must hold 6 entries")
    else:
        merge = tuple(operator.index(x) for x in merge)
        if len(merge) != 3 or not all(0 <= x < 2 ** 31 for x in merge):
            raise ValueError(f"apply_merge: merge {merge} must be three "
                             f"symbol ids in [0, 2**31)")
    if n < 1 or L < 1 or n * L >= 2 ** 31:
        raise ValueError(f"apply_merge: shape {(n, L)} outside [1, 2**31)")
    if dev.type == "cpu":
        sym.copy_(apply_merge_ref(sym, rec, merge))
        return sym
    if dev.type != "cuda":
        raise ValueError(f"apply_merge: no kernel for device {dev}")
    args = (rec.data_ptr(), 0, 0, 0) if merge is None else (None, *merge)
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_merge_rows", sym.data_ptr(), n, L, *args)
    apply_merge.launches += 1
    return sym


apply_merge.launches = 0
