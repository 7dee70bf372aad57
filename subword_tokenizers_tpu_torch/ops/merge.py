"""The merge step over the padded training state (kernel K3p).

The padded layout is the JAX package's first one: int32[n, L], a row per
word type, symbol ids left-aligned and padded with -1. Its
``ops/merge.py`` ``apply_merge`` replaces every non-overlapping (a, b)
adjacency with ``new_id`` as the reference scans a word left to right
(for a == b, at even offsets from the start of a run of a), and
left-compacts each row. The flat layout (ops/flat.py) is the port's
default; the padded one serves ``run_fused(flat=False)``.
"""
from __future__ import annotations

import torch

from . import check_tensor
from .flat import N_LIVE


def apply_merge_ref(sym, rec):
    """Plain PyTorch version of :func:`apply_merge` (JAX's formula: the
    parity of the offset in a run, then a stable compaction); returns the
    new tensor."""
    n, L = sym.shape
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


def apply_merge(sym, rec):
    """Apply one merge to the padded state ``sym`` (int32[n, L]) in place
    and return it. ``rec`` is the step's int32[6] record (ops/flat.py):
    a, b and new_id are read on the device, and an inactive step only
    compacts the rows.

    Launches kernel K3p (``csrc/merge_rows.cu``) for CUDA tensors, runs
    the PyTorch version for CPU tensors, and raises for any other device.
    """
    dev = sym.device
    check_tensor("sym", sym, (torch.int32,), 2, dev)
    check_tensor("rec", rec, (torch.int32,), 1, dev)
    n, L = sym.shape
    if rec.shape[0] != 6:
        raise ValueError("apply_merge: rec must hold 6 entries")
    if n < 1 or L < 1 or n * L >= 2 ** 31:
        raise ValueError(f"apply_merge: shape {(n, L)} outside [1, 2**31)")
    if dev.type == "cpu":
        sym.copy_(apply_merge_ref(sym, rec))
        return sym
    if dev.type != "cuda":
        raise ValueError(f"apply_merge: no kernel for device {dev}")
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_merge_rows", sym.data_ptr(), n, L, rec.data_ptr())
    apply_merge.launches += 1
    return sym


apply_merge.launches = 0
