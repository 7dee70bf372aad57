"""Data-parallel batched encode: rows shard across a mesh, the trie's
tables are replicated on every shard's device, and each shard runs the
end-to-end scan with the compaction in its epilogue (one launch,
ops/wp_encode_e2e.wp_e2e_scan_compact) on its own block of rows, with no
traffic between shards (the JAX package's ``parallel/encode.py``; its
``sharded_e2e_scan`` and ``sharded_e2e_scan_u16`` are one function
here, as the port's kernel 1 takes both char-word widths).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..models.base import fetch_head
from ..ops.wp_encode_e2e import wp_e2e_scan_compact
from .mesh import DataMesh


def pad_rows(mesh: DataMesh, *arrays):
    """Pad axis 0 with zero rows to a multiple of the mesh size; returns
    (padded..., n) with n the rows before padding."""
    n = arrays[0].shape[0]
    pad = (-n) % mesh.size
    out = []
    for a in arrays:
        if pad:
            a = np.concatenate([a, np.zeros((pad,) + a.shape[1:],
                                            dtype=a.dtype)])
        out.append(a)
    return (*out, n)


def put_sharded(mesh: DataMesh, *arrays) -> List[Tuple]:
    """Each of this process's shards' block of rows of ``arrays`` on its
    device: one tuple per shard."""
    import torch
    rows = arrays[0].shape[0] // mesh.size
    out = []
    for i, dev in enumerate(mesh.devices):
        lo = (mesh.first + i) * rows
        out.append(tuple(torch.from_numpy(np.ascontiguousarray(
            a[lo:lo + rows])).to(dev) for a in arrays))
    return out


def sharded_e2e_scan(mesh: DataMesh, chars: np.ndarray, slen: np.ndarray,
                     state_of, cap: int, max_steps: int, unk_ovf: bool):
    """The fused scan on every shard of a one-process mesh over char
    words ``chars`` (int16 or int32 [R, Lc]) and their lengths: (ids
    int32[total], offsets int64[R + 1], flags int32[R]) for all R rows in
    order, as ops/fetch.compact_ids gives them for one device.
    ``state_of(device)`` is the trie's E2EState on that device."""
    if mesh.group:
        raise RuntimeError(
            "FastWP.tokenize_batch under a process-group mesh: each process "
            "would hold only its own rows of the output, and the JAX "
            "package cannot fetch such an array either; encode with a "
            "one-process mesh or without one")
    chars_p, slen_p, n = pad_rows(mesh, chars, slen.astype(np.int32))
    ids, offs, flags = [], [np.zeros(1, dtype=np.int64)], []
    for (chars_d, slen_d), dev in zip(put_sharded(mesh, chars_p, slen_p),
                                      mesh.devices):
        st = state_of(dev)
        i, o, f = fetch_head(*wp_e2e_scan_compact(
            chars_d, slen_d, st.goto, st.fail, st.pops_off, st.pops_flat,
            st.root_p, st.root_sharp, st.unk_id, st.sharp, cap=cap,
            max_steps=max_steps, unk_ovf=unk_ovf, rec=st.rec))
        ids.append(i)
        offs.append(o[1:] + offs[-1][-1])
        flags.append(f)
    offs = np.concatenate(offs)[:n + 1]
    ids = np.concatenate(ids)[:int(offs[-1])]
    return ids, offs, np.concatenate(flags)[:n]
