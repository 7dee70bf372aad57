"""WordPiece word automatons: NaiveWP's greedy longest match (kernel 6)
and the general-pops route of FastWP's end-to-end scan.

:func:`wp_match_encode` has the semantics of the JAX package's
``ops/wp_encode.py`` (``wp_match_encode``, and the ``[UNK]``
substitution of ``wp_match_encode_stacked``): per word, walk the vocab
trie recording the deepest accepting node; on a dead end emit that
token and restart on the remainder with an injected ``"##"`` prefix (a
count of pending ``'#'`` characters, capped at :data:`MAX_INJECT`); a
segment with no accept makes the whole word ``[UNK]`` (token id 0). A
vocabulary with ``"#"`` but not ``"##"`` can grow the pending prefix
forever, as the reference would; the cap, the output width ``L+4`` and
the per-word step cap ``(L+18)(L+22)+32`` flag such words instead of
hanging. :func:`wp_match_compact` is the same match with kernel 2's
compaction (ops/fetch.py) in the same launch, the counterpart of JAX's
``wp_match_encode_stacked``: (ids, head) as ``compact_ids`` gives them,
and no [W, L+4] buffer. On CUDA tensors both launch
``csrc/wp_match.cu`` (a thread a word, a block's words staged in shared
memory, one dependent gather a step through :func:`match_records`, the
injected ``'#'`` in one move through :func:`match_jumps`); on CPU
tensors they run :func:`wp_match_encode_ref` and
:func:`wp_match_compact_ref`.

:func:`wp_e2e_encode` has the semantics of the JAX ``wp_e2e_encode``:
the end-to-end automaton over unpacked alphabet ids and class masks,
with CSR pops of any width, an output width of 2T+4 and a step cap of
6T+64. It serves vocabularies whose failure pops are wider than 8 and
the whole-sentence route for vocabularies with whitespace in a token,
and runs the same kernel as the packed route
(ops/wp_encode_e2e.wp_e2e_scan) with the general route's parameters.
"""
from __future__ import annotations

import torch

from . import check_tensor as _check
from .fetch import compact_ids_ref, stream_scratch
from .wp_encode_e2e import (MAX_TILE_ROWS, route_params, tile_layout,
                            wp_e2e_scan)

MAX_INJECT = 16  # cap on pending '#' prefix characters


def match_params(L: int):
    """(output width, per-word step cap) of words padded to width L."""
    return L + 4, (L + MAX_INJECT + 2) * (L + MAX_INJECT + 6) + 32


def _match_lockstep(words, wlen, goto, accept, hash_aid: int):
    """Every word steps in lockstep, as the JAX program does, until no
    word is running or the step cap. Returns the four outputs of
    :func:`wp_match_encode` and each word's steps and, of those, the
    steps that took an injected '#'."""
    dev = words.device
    W, L = words.shape
    cap, max_iter = match_params(L)
    rows = torch.arange(W, device=dev)
    wlen = wlen.to(torch.int64)
    zeros = torch.zeros(W, dtype=torch.int64, device=dev)
    pos, inject, node, acc_pos, acc_inj, ptr, steps, hashed = (zeros,) * 8
    acc_tok = zeros - 1
    running = wlen > 0
    out = torch.zeros(W, cap + 1, dtype=torch.int32, device=dev)
    unk = torch.zeros(W, dtype=torch.bool, device=dev)
    ovf = torch.zeros(W, dtype=torch.bool, device=dev)
    goto_flat = goto.reshape(-1)
    A1 = goto.shape[1]
    it = 0
    while bool(running.any()) and it < max_iter:
        it += 1
        steps = steps + running
        aid = torch.where(inject > 0, hash_aid,
                          words[rows, pos.clamp(max=L - 1)].to(torch.int64))
        have = (inject > 0) | (pos < wlen)
        child = goto_flat[node * A1 + aid].to(torch.int64)
        step = running & have & (child >= 0)
        hashed = hashed + (step & (inject > 0))
        n_inject = torch.where(step & (inject > 0), inject - 1, inject)
        n_pos = torch.where(step & (inject == 0), pos + 1, pos)
        n_node = torch.where(step, child, node)
        acc = accept[n_node].to(torch.int64)
        here = step & (acc >= 0)
        acc_tok = torch.where(here, acc, acc_tok)
        acc_pos = torch.where(here, n_pos, acc_pos)
        acc_inj = torch.where(here, n_inject, acc_inj)

        stuck = running & ~step
        emit = stuck & (acc_tok >= 0)
        col = torch.where(emit & (ptr < cap), ptr, cap)
        out[rows, col] = torch.where(emit, acc_tok, 0).to(torch.int32)
        ovf = ovf | (emit & (ptr >= cap))
        ptr = torch.where(emit, ptr + 1, ptr)
        finished = emit & (acc_pos >= wlen) & (acc_inj == 0)
        restart = emit & ~finished
        failed = stuck & (acc_tok < 0)
        ovf = ovf | (restart & (2 + acc_inj > MAX_INJECT))
        inject = torch.where(restart, (2 + acc_inj).clamp(max=MAX_INJECT),
                             n_inject)
        pos = torch.where(restart, acc_pos, n_pos)
        node = torch.where(restart, 0, n_node)
        acc_tok = torch.where(restart, -1, acc_tok)
        running = running & ~(finished | failed)
        unk = unk | failed
    ovf = ovf | running  # the step cap was hit
    out = out[:, :cap].contiguous()
    out[:, 0] = torch.where(unk, 0, out[:, 0])
    out_n = torch.where(unk, 1, ptr).to(torch.int32)
    return (out, out_n, unk, ovf, steps.to(torch.int32),
            hashed.to(torch.int32))


def wp_match_encode_ref(words, wlen, goto, accept, hash_aid: int):
    """Plain PyTorch version of the rows form: every word steps in
    lockstep, as the JAX program does, until no word is running or the
    step cap."""
    return _match_lockstep(words, wlen, goto, accept, hash_aid)[:4]


def wp_match_steps(words, wlen, goto, accept, hash_aid: int):
    """Plain: (steps, hashed) int32[W], each word's steps as the JAX
    program counts them (one an iteration the word runs) and, of those,
    the steps that took an injected '#' (the kernel takes them in one
    move through :func:`match_jumps`). The slowest word's other steps are
    the kernel's chain of dependent gathers."""
    return _match_lockstep(words, wlen, goto, accept, hash_aid)[4:]


def match_records(goto, accept):
    """int32[n, A+1, 2]: (child, accept[child]) of every goto entry,
    (-1, -1) where there is no child: the kernel's 8-byte step record."""
    child = goto.to(torch.int64)
    acc = torch.where(child >= 0, accept[child.clamp(min=0)], -1)
    return torch.stack([goto, acc.to(torch.int32)], dim=-1).contiguous()


def match_jumps(goto, accept, hash_aid: int):
    """int32[MAX_INJECT + 1, 4]: for k pending '#' at the root, the walk
    over them: (steps, node, the deepest accept's token or -1, its
    depth). It stops at k steps or at a dead end."""
    col = goto[:, hash_aid].tolist()
    acc = accept.tolist()
    steps, node, tok, depth = 0, 0, -1, 0
    rows = [[0, 0, -1, 0]]
    for k in range(1, MAX_INJECT + 1):
        if steps == k - 1 and col[node] >= 0:
            node = col[node]
            steps = k
            if acc[node] >= 0:
                tok, depth = acc[node], k
        rows.append([steps, node, tok, depth])
    return torch.tensor(rows, dtype=torch.int32, device=goto.device)


def _prepare_match(what, words, wlen, goto, accept, hash_aid, rec, jumps):
    """Check a match's inputs; raise for a CUDA call without the tables
    the kernel reads."""
    dev = words.device
    _check("words", words, (torch.int32,), 2, dev)
    _check("wlen", wlen, (torch.int32,), 1, dev)
    _check("goto", goto, (torch.int32,), 2, dev)
    _check("accept", accept, (torch.int32,), 1, dev)
    W, L = words.shape
    n, A1 = goto.shape
    if wlen.shape[0] != W or accept.shape[0] != n:
        raise ValueError(f"{what}: inconsistent shapes")
    if L < 1 or n < 1 or not 0 <= hash_aid < A1:
        raise ValueError(f"{what}: empty words, trie or bad hash_aid "
                         f"{hash_aid}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {dev}")
    if dev.type == "cuda" and (rec is None or jumps is None):
        raise ValueError(f"{what}: the kernel needs the trie's step "
                         "records and jumps (rec=match_records(goto, "
                         "accept), jumps=match_jumps(goto, accept, "
                         "hash_aid))")
    if rec is not None:
        _check("rec", rec, (torch.int32,), 3, dev)
        if tuple(rec.shape) != (n, A1, 2) or rec.data_ptr() % 8:
            raise ValueError(f"{what}: rec must be int32[{n}, {A1}, 2] on "
                             "an 8-byte boundary")
    if jumps is not None:
        _check("jumps", jumps, (torch.int32,), 2, dev)
        if tuple(jumps.shape) != (MAX_INJECT + 1, 4) or \
                jumps.data_ptr() % 16:
            raise ValueError(f"{what}: jumps must be int32"
                             f"[{MAX_INJECT + 1}, 4] on a 16-byte boundary")


def _match_args(words, wlen, rec, jumps, hash_aid):
    """The C arguments the two forms share, and the block's words."""
    W, L = words.shape
    cap, max_iter = match_params(L)
    rows, ws, st = tile_layout(L, cap, 4)
    return (words.data_ptr(), W, L, wlen.data_ptr(), rec.data_ptr(),
            rec.shape[1], jumps.data_ptr(), int(hash_aid), cap, max_iter,
            rows, ws, st), rows


def wp_match_encode(words, wlen, goto, accept, hash_aid: int, rec=None,
                    jumps=None):
    """Greedy longest match over padded words, the rows form.

    words: int32[W, L] alphabet ids (OOV = A), L >= 1; wlen: int32[W]
    lengths (<= L); goto: int32[n_nodes, A+1] (column A all -1);
    accept: int32[n_nodes] output token id or -1; hash_aid: the
    alphabet id of '#' (A when the vocab has none); rec, jumps: the
    trie's :func:`match_records` and :func:`match_jumps` on the device
    (models/state.MatchState), which the kernel reads in place of goto
    and accept.

    Returns (out int32[W, L+4], out_n int32[W], unk bool[W], ovf bool[W]).
    ``unk`` rows are already the single token 0 (``[UNK]``); ``ovf``
    marks a word that passed the output width, the '#' cap or the step
    cap. Positions a row never wrote are 0. Launches the CUDA kernel for
    CUDA tensors, runs the PyTorch version for CPU tensors, and raises
    for any other device.
    """
    _prepare_match("wp_match_encode", words, wlen, goto, accept, hash_aid,
                   rec, jumps)
    dev = words.device
    if dev.type == "cpu":
        return wp_match_encode_ref(words, wlen, goto, accept, hash_aid)
    W, L = words.shape
    cap = match_params(L)[0]
    out = torch.empty(W, cap, dtype=torch.int32, device=dev)
    out_n = torch.empty(W, dtype=torch.int32, device=dev)
    unk, ovf = (torch.empty(W, dtype=torch.bool, device=dev)
                for _ in range(2))
    if W == 0:
        return out, out_n, unk, ovf
    from . import _cuda
    args, _ = _match_args(words, wlen, rec, jumps, hash_aid)
    with torch.cuda.device(dev):
        _cuda.launch("swt_wp_match", *args, out.data_ptr(),
                     out_n.data_ptr(), unk.data_ptr(), ovf.data_ptr())
    wp_match_encode.launches += 1
    return out, out_n, unk, ovf


wp_match_encode.launches = 0


def wp_match_compact_ref(words, wlen, goto, accept, hash_aid: int):
    """Plain PyTorch version of the fused kernel: the rows form's plain
    version, then kernel 2's over its rows with flags = ovf."""
    out, out_n, _, ovf = wp_match_encode_ref(words, wlen, goto, accept,
                                             hash_aid)
    return compact_ids_ref(out, out_n, ovf)


def wp_match_compact(words, wlen, goto, accept, hash_aid: int, rec=None,
                     jumps=None):
    """:func:`wp_match_encode` and ops/fetch.compact_ids in one launch.

    Arguments as :func:`wp_match_encode`. Returns (ids int32[W*(L+4)],
    head int32[2W+1]) as ``compact_ids`` gives them for the rows form's
    (out, out_n, ovf): ``head`` = [offsets (W), total, flags (W)], the
    flags byte ovf. Launches the CUDA kernel for CUDA tensors (words too
    wide to stage in shared memory stage in a [W, L+4] buffer made for
    the call), runs the PyTorch version for CPU tensors, and raises for
    any other device.
    """
    _prepare_match("wp_match_compact", words, wlen, goto, accept, hash_aid,
                   rec, jumps)
    dev = words.device
    W, L = words.shape
    cap = match_params(L)[0]
    if W * cap >= 2 ** 31:
        raise ValueError("wp_match_compact: stream would pass 2**31 "
                         "entries")
    if dev.type == "cpu":
        return wp_match_compact_ref(words, wlen, goto, accept, hash_aid)
    ids = torch.empty(W * cap, dtype=torch.int32, device=dev)
    if W == 0:
        return ids, torch.zeros(1, dtype=torch.int32, device=dev)
    head = torch.empty(2 * W + 1, dtype=torch.int32, device=dev)
    args, rows = _match_args(words, wlen, rec, jumps, hash_aid)
    gstage = (None if rows else
              torch.empty(W, cap, dtype=torch.int32, device=dev))
    scratch, epoch = stream_scratch(dev).take(
        -(-W // (rows or MAX_TILE_ROWS)))
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_wp_match_compact", *args,
                     0 if gstage is None else gstage.data_ptr(),
                     ids.data_ptr(), head.data_ptr(), scratch.data_ptr(),
                     epoch)
    wp_match_compact.launches += 1
    return ids, head


wp_match_compact.launches = 0


def pack_words(acp, is_space, is_punc):
    """i32 char words [S, T+1] from alphabet ids and class masks [S, T].

    The extra column is the word at position T: its prev-punct bit
    decides the boundary at the end of a row of length T.
    """
    S, T = acp.shape
    pc = torch.zeros(S, T + 1, dtype=torch.int32, device=acp.device)
    pc[:, :T] = is_punc.to(torch.int32)
    words = torch.zeros(S, T + 1, dtype=torch.int32, device=acp.device)
    words[:, :T] = acp | (is_space.to(torch.int32) << 22)
    words |= pc << 23
    words[:, 1:] |= pc[:, :T] << 24
    return words


def wp_e2e_encode(acp, is_space, is_punc, slen, goto, fail, pops_off,
                  pops_flat, root_p, root_sharp, unk_id, sharp, rec=None):
    """End-to-end scan over padded sentences.

    acp: int32[S, T] alphabet ids (OOV = A), positions >= slen padded;
    is_space/is_punc: bool[S, T] Python str.isspace / FastWP ispunc;
    slen: int32[S] lengths with the trailing space (<= T); the trie,
    ``sharp`` and ``rec`` as in ops/wp_encode_e2e.wp_e2e_scan.

    Returns (out int32[S, 2T+4], out_n int32[S], ovf, stuck, crash bool[S]).
    """
    cap, max_steps, unk_ovf = route_params(acp.shape[1], general=True)
    return wp_e2e_scan(pack_words(acp, is_space, is_punc), slen, goto,
                       fail, pops_off, pops_flat, root_p, root_sharp,
                       unk_id, sharp, cap=cap, max_steps=max_steps,
                       unk_ovf=unk_ovf, rec=rec)
