"""The general-pops route of FastWP's end-to-end scan.

Same semantics as the JAX package's ``ops/wp_encode.py``
(``wp_e2e_encode``): the automaton over unpacked alphabet ids and class
masks, with CSR pops of any width, an output width of 2T+4 and a step
cap of 6T+64. It serves vocabularies whose failure pops are wider than 8
and the whole-sentence route for vocabularies with whitespace in a
token. It runs the same kernel as the packed route
(ops/wp_encode_e2e.wp_e2e_scan) with the general route's parameters.
"""
from __future__ import annotations

import torch

from .wp_encode_e2e import route_params, wp_e2e_scan


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
                  pops_flat, root_p, root_sharp, unk_id, sharp):
    """End-to-end scan over padded sentences.

    acp: int32[S, T] alphabet ids (OOV = A), positions >= slen padded;
    is_space/is_punc: bool[S, T] Python str.isspace / FastWP ispunc;
    slen: int32[S] lengths with the trailing space (<= T); the trie and
    ``sharp`` as in ops/wp_encode_e2e.wp_e2e_scan.

    Returns (out int32[S, 2T+4], out_n int32[S], ovf, stuck, crash bool[S]).
    """
    cap, max_steps, unk_ovf = route_params(acp.shape[1], general=True)
    return wp_e2e_scan(pack_words(acp, is_space, is_punc), slen, goto,
                       fail, pops_off, pops_flat, root_p, root_sharp,
                       unk_id, sharp, cap=cap, max_steps=max_steps,
                       unk_ovf=unk_ovf)
