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
hanging. On CUDA tensors it launches ``csrc/wp_match.cu`` (one thread
per word), on CPU tensors it runs :func:`wp_match_encode_ref`.

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
from .wp_encode_e2e import route_params, wp_e2e_scan

MAX_INJECT = 16  # cap on pending '#' prefix characters


def match_params(L: int):
    """(output width, per-word step cap) of words padded to width L."""
    return L + 4, (L + MAX_INJECT + 2) * (L + MAX_INJECT + 6) + 32


def wp_match_encode_ref(words, wlen, goto, accept, hash_aid: int):
    """Plain PyTorch version of the kernel: every word steps in lockstep,
    as the JAX program does, until no word is running or the step cap."""
    dev = words.device
    W, L = words.shape
    cap, max_iter = match_params(L)
    rows = torch.arange(W, device=dev)
    wlen = wlen.to(torch.int64)
    zeros = torch.zeros(W, dtype=torch.int64, device=dev)
    pos, inject, node, acc_pos, acc_inj, ptr = (zeros,) * 6
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
        aid = torch.where(inject > 0, hash_aid,
                          words[rows, pos.clamp(max=L - 1)].to(torch.int64))
        have = (inject > 0) | (pos < wlen)
        child = goto_flat[node * A1 + aid].to(torch.int64)
        step = running & have & (child >= 0)
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
    return out, out_n, unk, ovf


def wp_match_encode(words, wlen, goto, accept, hash_aid: int):
    """Greedy longest match over padded words.

    words: int32[W, L] alphabet ids (OOV = A), L >= 1; wlen: int32[W]
    lengths (<= L); goto: int32[n_nodes, A+1] (column A all -1);
    accept: int32[n_nodes] output token id or -1; hash_aid: the
    alphabet id of '#' (A when the vocab has none).

    Returns (out int32[W, L+4], out_n int32[W], unk bool[W], ovf bool[W]).
    ``unk`` rows are already the single token 0 (``[UNK]``); ``ovf``
    marks a word that passed the output width, the '#' cap or the step
    cap. Launches the CUDA kernel for CUDA tensors, runs the PyTorch
    version for CPU tensors, and raises for any other device.
    """
    dev = words.device
    _check("words", words, (torch.int32,), 2, dev)
    _check("wlen", wlen, (torch.int32,), 1, dev)
    _check("goto", goto, (torch.int32,), 2, dev)
    _check("accept", accept, (torch.int32,), 1, dev)
    W, L = words.shape
    if wlen.shape[0] != W or accept.shape[0] != goto.shape[0]:
        raise ValueError("wp_match_encode: inconsistent shapes")
    if L < 1 or goto.shape[0] < 1 or not 0 <= hash_aid < goto.shape[1]:
        raise ValueError("wp_match_encode: empty words, trie or bad "
                         f"hash_aid {hash_aid}")
    if dev.type == "cpu":
        return wp_match_encode_ref(words, wlen, goto, accept, hash_aid)
    if dev.type != "cuda":
        raise ValueError(f"wp_match_encode: no kernel for device {dev}")
    cap, max_iter = match_params(L)
    out = torch.empty(W, cap, dtype=torch.int32, device=dev)
    out_n = torch.empty(W, dtype=torch.int32, device=dev)
    unk, ovf = (torch.empty(W, dtype=torch.bool, device=dev)
                for _ in range(2))
    if W == 0:
        return out, out_n, unk, ovf
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_wp_match", words.data_ptr(), W, L,
                     wlen.data_ptr(), goto.data_ptr(), goto.shape[1],
                     accept.data_ptr(), int(hash_aid), cap, max_iter,
                     out.data_ptr(), out_n.data_ptr(), unk.data_ptr(),
                     ovf.data_ptr())
    wp_match_encode.launches += 1
    return out, out_n, unk, ovf


wp_match_encode.launches = 0


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
