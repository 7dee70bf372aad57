"""FastWP's end-to-end LinMaxMatch scan over padded rows (kernel 1).

Same semantics as the JAX package's ``ops/wp_encode_e2e.py``
(``_wp_e2e_scan_impl``) and ``ops/wp_encode.py`` (``wp_e2e_encode``):
modes MATCH, VALIDATE, SKIP1, SKIP2 and DONE; failure pops, the literal
"['UNK']" rollback, the root_sharp "##" sequence; flags for rows that
overflow the output, get stuck at the step cap, or would crash the
reference (a boundary check past the end of the row).

- :func:`wp_e2e_scan` is the rows form: on CUDA tensors it launches the
  hand-written kernel ``csrc/wp_e2e_scan.cu`` (a thread a row, a block's
  rows staged in shared memory), on CPU tensors it runs the plain
  PyTorch version :func:`wp_e2e_scan_ref`.
- :func:`wp_e2e_scan_compact` is the same scan with kernel 2's
  compaction (ops/fetch.py) in the same launch, the counterpart of the
  JAX package's ``wp_e2e_scan_u16_stacked`` at one slice: (ids, head)
  as ``compact_ids`` gives them, and no [R, cap] buffer.
- Pops are CSR (``fail``, ``pops_off``, ``pops_flat``) of any width;
  the kernel reads each node as one record (:func:`node_records`).
- A char word is u16 (aid in bits 0..12, space/punct/prev-punct in bits
  13..15; torch carries it as int16 bits) or i32 (aid | sp<<22 | pc<<23
  | prev_pc<<24, any alphabet). The word at position ``slen`` must exist:
  its prev-punct bit decides the boundary at the end of the row.
"""
from __future__ import annotations

import numpy as np
import torch

from ..benchmarks import profiling
from . import check_tensor as _check
from .fetch import compact_ids_ref, stream_scratch

SP_BIT = 1 << 22
PC_BIT = 1 << 23
PREV_PC_BIT = 1 << 24
AID_MASK = (1 << 22) - 1
U16_AID_MASK = (1 << 13) - 1

MATCH, VALIDATE, SKIP1, SKIP2, DONE = range(5)

# The JAX scan checks its step cap once per UNROLL steps.
UNROLL = 4

# A node record (csrc/wp_scan_walk.cuh): fail, pop count, pops_off and
# the first REC_POPS pops, zero past the count (the JAX package's
# node_info row with the CSR offset beside it).
REC_INTS = 8
REC_POPS = REC_INTS - 3
# A block's rows in the kernel (a multiple of 32), and the shared memory
# its staged chars and tokens may take.
MAX_TILE_ROWS = 128
STAGE_BYTES = 200 * 1024


def pack_chars(aid, is_sp, is_pc):
    """Host: i32 char words from alphabet ids and class masks [S, T]."""
    prev_pc = np.zeros_like(is_pc)
    prev_pc[:, 1:] = is_pc[:, :-1]
    return (aid.astype(np.int32)
            | (is_sp.astype(np.int32) << 22)
            | (is_pc.astype(np.int32) << 23)
            | (prev_pc.astype(np.int32) << 24))


def pack_u16(pchar):
    """Host: i32 char words -> u16 words (alphabet ids below 2**13)."""
    return ((pchar & U16_AID_MASK) | ((pchar >> 9) & 0xE000)).astype(
        np.uint16)


def route_params(T: int, general: bool):
    """(cap, max_steps, unk_ovf) of a route over rows padded to width T.

    The packed route (JAX ``wp_e2e_scan``) writes T+4 columns and caps a
    row at 6T+64 steps, checked every UNROLL steps; the general route
    (JAX ``wp_e2e_encode``, for pops wider than 8 and for whole
    sentences) writes 2T+4 columns, caps at exactly 6T+64 steps, and
    does not flag an "['UNK']" that lands past its columns.
    """
    if general:
        return 2 * T + 4, 6 * T + 64, False
    return T + 4, -(-(6 * T + 64) // UNROLL) * UNROLL, True


def node_records(fail, pops_off, pops_flat):
    """int32[n, REC_INTS] records of the trie's nodes, on their device."""
    n = fail.shape[0]
    rec = torch.zeros(n, REC_INTS, dtype=torch.int32, device=fail.device)
    cnt = pops_off[1:] - pops_off[:-1]
    rec[:, 0] = fail
    rec[:, 1] = cnt
    rec[:, 2] = pops_off[:-1]
    if pops_flat.numel():
        for j in range(REC_POPS):
            idx = (pops_off[:-1].to(torch.int64) + j).clamp(
                max=pops_flat.numel() - 1)
            rec[:, 3 + j] = torch.where(j < cnt, pops_flat[idx], 0)
    return rec


def tile_layout(W: int, cap: int, word_bytes: int):
    """(rows, ws, st): a block's rows for char rows of width W and rows of
    cap tokens, and the strides of a staged char row (ws words) and token
    row (st int32). The strides are odd counts of 4-byte words, so lanes
    at one column hit distinct banks; rows are as many as stage in
    STAGE_BYTES of shared memory, a multiple of 32 up to MAX_TILE_ROWS,
    or 0 when not even 32 do (the kernel then stages in device memory)."""
    st = cap | 1
    if word_bytes == 4:
        ws = W | 1
    else:
        ws = (W + 1) & ~1
        ws += 0 if (ws // 2) % 2 else 2
    rows = STAGE_BYTES // (4 * st + word_bytes * ws) // 32 * 32
    return min(rows, MAX_TILE_ROWS), ws, st


def _decode(chars):
    w = chars.to(torch.int32)
    if chars.dtype == torch.int16:
        w = w & 0xFFFF
        return (w & U16_AID_MASK, (w >> 13) & 1 == 1, (w >> 14) & 1 == 1,
                (w >> 15) & 1 == 1)
    return (w & AID_MASK, (w & SP_BIT) != 0, (w & PC_BIT) != 0,
            (w & PREV_PC_BIT) != 0)


def wp_e2e_scan_ref(chars, slen, goto, fail, pops_off, pops_flat, root_p,
                    root_sharp, unk_id, sharp, cap, max_steps, unk_ovf):
    """Plain PyTorch version of the kernel: every row steps in lockstep,
    as the JAX program does; a DONE row's step changes nothing."""
    dev = chars.device
    S, W = chars.shape
    aid_m, sp_m, pc_m, ppc_m = _decode(chars)
    rows = torch.arange(S, device=dev)
    slen = slen.to(torch.int64)
    zeros = torch.zeros(S, dtype=torch.int64, device=dev)
    i, node, ptr, seg = zeros, zeros, zeros, zeros
    mode = torch.where(slen > 0, MATCH, DONE)
    out = torch.zeros(S, cap, dtype=torch.int32, device=dev)
    ovf = torch.zeros(S, dtype=torch.bool, device=dev)
    crash = torch.zeros(S, dtype=torch.bool, device=dev)
    goto_flat = goto.reshape(-1)
    A1 = goto.shape[1]
    off_all = pops_off[:-1].to(torch.int64)
    cnt_all = (pops_off[1:] - pops_off[:-1]).to(torch.int64)
    pops_pad = torch.cat([pops_flat, pops_flat.new_zeros(1)])
    n_sharp = sharp.shape[0]
    K = max(int(cnt_all.max()) if cnt_all.numel() else 0, n_sharp, 1)
    sharp_pad = torch.cat([sharp, sharp.new_zeros(K - n_sharp)])
    for step in range(max_steps):
        if step % UNROLL == 0 and not bool((mode != DONE).any()):
            break
        ic = i.clamp(max=W - 1)
        aid, sp, pc, ppc = (m[rows, ic] for m in (aid_m, sp_m, pc_m, ppc_m))
        child = goto_flat[node * A1 + aid].to(torch.int64)
        f = fail[node].to(torch.int64)
        cnt = cnt_all[node]
        off = off_all[node]
        in_row = i < slen

        m_act = mode == MATCH
        step_ = m_act & in_row & (child >= 0)
        climb = m_act & in_row & (child < 0) & (f >= 0)
        to_val = m_act & (~in_row | ((child < 0) & (f < 0)))

        v_act = mode == VALIDATE
        prev_pc = (i > 0) & ppc
        bnd = prev_pc | (in_row & (sp | pc))
        at_root = (node == 0) | (node == root_sharp) | (node == root_p)
        inval = v_act & ~(bnd & at_root)
        corner = v_act & ~inval & (node == root_sharp) & (ptr == seg)
        crash = crash | (v_act & ~in_row & ~prev_pc)

        ptr_eff = torch.where(inval, seg, ptr)
        emit = torch.where(climb, cnt, torch.where(
            inval, 1, torch.where(corner, n_sharp, 0)))
        for j in range(K):
            on = j < emit
            col = ptr_eff + j
            val = torch.where(
                climb, pops_pad[torch.where(j < cnt, off + j, -1)],
                torch.where(inval, unk_id, sharp_pad[j]))
            keep = on & (col < cap)
            out[rows[keep], col[keep]] = val[keep].to(torch.int32)
            past = on & (col >= cap)
            ovf = ovf | (past if unk_ovf else past & ~inval)
        ptr = ptr_eff + emit

        n_node = torch.where(step_, child, torch.where(climb, f, node))
        n_i = torch.where(step_, i + 1, i)
        n_mode = torch.where(to_val, VALIDATE, mode)
        n_mode = torch.where(v_act, SKIP1, n_mode)

        s1 = mode == SKIP1
        adv1 = s1 & in_row & ~bnd
        n_i = torch.where(adv1, i + 1, n_i)
        n_mode = torch.where(s1 & ~adv1, SKIP2, n_mode)

        s2 = mode == SKIP2
        adv2 = s2 & in_row & sp
        n_i = torch.where(adv2, i + 1, n_i)
        restart = s2 & ~adv2 & in_row
        finish = s2 & ~adv2 & ~in_row
        n_node = torch.where(restart, 0, n_node)
        seg = torch.where(restart, ptr, seg)
        n_mode = torch.where(restart, MATCH,
                             torch.where(finish, DONE, n_mode))
        i, node, mode = n_i, n_node, n_mode
    return (out, ptr.to(torch.int32), ovf, mode != DONE, crash)


def _prepare(what, chars, slen, goto, fail, pops_off, pops_flat, sharp,
             cap, max_steps, unk_ovf, rec):
    """Check a scan's inputs; (cap, max_steps, unk_ovf) with the packed
    route's defaults over width W."""
    dev = chars.device
    _check("chars", chars, (torch.int16, torch.int32), 2, dev)
    _check("slen", slen, (torch.int32,), 1, dev)
    _check("goto", goto, (torch.int32,), 2, dev)
    for name, t in (("fail", fail), ("pops_off", pops_off),
                    ("pops_flat", pops_flat), ("sharp", sharp)):
        _check(name, t, (torch.int32,), 1, dev)
    S, W = chars.shape
    n = goto.shape[0]
    if (slen.shape[0] != S or fail.shape[0] != n
            or pops_off.shape[0] != n + 1 or sharp.shape[0] < 1):
        raise ValueError(f"{what}: inconsistent shapes")
    if rec is not None:
        _check("rec", rec, (torch.int32,), 2, dev)
        if tuple(rec.shape) != (n, REC_INTS) or rec.data_ptr() % 16:
            raise ValueError(f"{what}: rec must be int32[{n}, {REC_INTS}] "
                             "on a 16-byte boundary")
    d_cap, d_steps, d_unk = route_params(W, general=False)
    cap = d_cap if cap is None else int(cap)
    max_steps = d_steps if max_steps is None else int(max_steps)
    unk_ovf = d_unk if unk_ovf is None else bool(unk_ovf)
    if dev.type == "cuda" and rec is None:
        raise ValueError(f"{what}: the kernel needs the trie's node records "
                         "(rec=node_records(fail, pops_off, pops_flat))")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {dev}")
    return cap, max_steps, unk_ovf


def _scan_args(chars, slen, goto, rec, pops_flat, sharp, root_p,
               root_sharp, unk_id, cap, max_steps, unk_ovf):
    """The C arguments the two forms share, and the block's rows."""
    S, W = chars.shape
    rows, ws, st = tile_layout(W, cap, chars.element_size())
    return (chars.data_ptr(), S, W, slen.data_ptr(), goto.data_ptr(),
            goto.shape[1], rec.data_ptr(), pops_flat.data_ptr(),
            sharp.data_ptr(), sharp.shape[0], int(root_p), int(root_sharp),
            int(unk_id), cap, max_steps, int(unk_ovf), rows, ws, st), rows


def wp_e2e_scan(chars, slen, goto, fail, pops_off, pops_flat, root_p,
                root_sharp, unk_id, sharp, cap=None, max_steps=None,
                unk_ovf=None, rec=None):
    """Scan padded rows of char words; see the module docstring.

    chars: int16 (u16 bits) or int32 [S, W]; slen: int32[S], each row's
    length including its trailing space, < W; goto: int32[n, A+1];
    fail: int32[n]; pops_off: int32[n+1]; pops_flat: int32[*];
    sharp: int32[k >= 1], the tokens of encode_word("##") (or [-2] when
    that would hang). cap, max_steps and unk_ovf default to the packed
    route over width W (:func:`route_params`). rec: the trie's
    :func:`node_records` on the device (models/state.E2EState.rec), which
    the kernel reads; the plain version reads the CSR pops.

    Returns (out int32[S, cap], out_n int32[S], ovf, stuck, crash bool[S]).
    Launches the CUDA kernel for CUDA tensors, runs the PyTorch version
    for CPU tensors, and raises for any other device.
    """
    cap, max_steps, unk_ovf = _prepare(
        "wp_e2e_scan", chars, slen, goto, fail, pops_off, pops_flat, sharp,
        cap, max_steps, unk_ovf, rec)
    dev = chars.device
    if dev.type == "cpu":
        return wp_e2e_scan_ref(chars, slen, goto, fail, pops_off, pops_flat,
                               root_p, root_sharp, unk_id, sharp, cap,
                               max_steps, unk_ovf)
    S = chars.shape[0]
    out = torch.empty(S, cap, dtype=torch.int32, device=dev)
    out_n = torch.empty(S, dtype=torch.int32, device=dev)
    ovf, stuck, crash = (torch.empty(S, dtype=torch.bool, device=dev)
                         for _ in range(3))
    if S == 0:
        return out, out_n, ovf, stuck, crash
    from . import _cuda
    name = ("swt_wp_e2e_scan_u16" if chars.dtype == torch.int16
            else "swt_wp_e2e_scan_i32")
    args, _ = _scan_args(chars, slen, goto, rec, pops_flat, sharp, root_p,
                         root_sharp, unk_id, cap, max_steps, unk_ovf)
    with torch.cuda.device(dev):
        _cuda.launch(name, *args, out.data_ptr(), out_n.data_ptr(),
                     ovf.data_ptr(), stuck.data_ptr(), crash.data_ptr())
    profiling.count("launch.wp_e2e_scan")
    return out, out_n, ovf, stuck, crash


def wp_e2e_scan_compact_ref(chars, slen, goto, fail, pops_off, pops_flat,
                            root_p, root_sharp, unk_id, sharp, cap,
                            max_steps, unk_ovf):
    """Plain PyTorch version of the fused kernel: the scan's plain
    version, then kernel 2's."""
    return compact_ids_ref(*wp_e2e_scan_ref(
        chars, slen, goto, fail, pops_off, pops_flat, root_p, root_sharp,
        unk_id, sharp, cap, max_steps, unk_ovf))


def wp_e2e_scan_compact(chars, slen, goto, fail, pops_off, pops_flat,
                        root_p, root_sharp, unk_id, sharp, cap=None,
                        max_steps=None, unk_ovf=None, rec=None):
    """:func:`wp_e2e_scan` and ops/fetch.compact_ids in one launch.

    Arguments as :func:`wp_e2e_scan`. Returns (ids int32[S*cap], head
    int32[2S+1]) as ``compact_ids`` gives them for the scan's outputs:
    ``head`` = [offsets (S), total, flags (S)], the flags byte ovf |
    stuck<<1 | crash<<2 | sawneg2<<3. Launches the CUDA kernel for CUDA
    tensors (rows too wide to stage in shared memory stage in an [S, cap]
    buffer made for the call), runs the PyTorch version for CPU tensors,
    and raises for any other device.
    """
    cap, max_steps, unk_ovf = _prepare(
        "wp_e2e_scan_compact", chars, slen, goto, fail, pops_off, pops_flat,
        sharp, cap, max_steps, unk_ovf, rec)
    dev = chars.device
    S = chars.shape[0]
    if S * cap >= 2 ** 31:
        raise ValueError("wp_e2e_scan_compact: stream would pass 2**31 "
                         "entries")
    if dev.type == "cpu":
        return wp_e2e_scan_compact_ref(chars, slen, goto, fail, pops_off,
                                       pops_flat, root_p, root_sharp, unk_id,
                                       sharp, cap, max_steps, unk_ovf)
    ids = torch.empty(S * cap, dtype=torch.int32, device=dev)
    if S == 0:
        return ids, torch.zeros(1, dtype=torch.int32, device=dev)
    head = torch.empty(2 * S + 1, dtype=torch.int32, device=dev)
    args, rows = _scan_args(chars, slen, goto, rec, pops_flat, sharp,
                            root_p, root_sharp, unk_id, cap, max_steps,
                            unk_ovf)
    gstage = (None if rows else
              torch.empty(S, cap, dtype=torch.int32, device=dev))
    words, epoch = stream_scratch(dev).take(
        -(-S // (rows or MAX_TILE_ROWS)))
    from . import _cuda
    name = ("swt_wp_e2e_scan_compact_u16" if chars.dtype == torch.int16
            else "swt_wp_e2e_scan_compact_i32")
    with torch.cuda.device(dev):
        _cuda.launch(name, *args,
                     0 if gstage is None else gstage.data_ptr(),
                     ids.data_ptr(), head.data_ptr(), words.data_ptr(),
                     epoch)
    profiling.count("launch.wp_e2e_scan_compact")
    return ids, head
