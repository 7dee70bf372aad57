"""The encoders' weights on the device.

For a tokenizer the weights are its lookup tables, moved to ``device``
once per vocabulary and dropped with it (``reset``, ``load_resources``,
``train``):

- FastWP: the end-to-end trie's tables. :func:`e2e_state_from_numpy`
  takes them as numpy arrays, from this package's ``models/trie.E2ETrie``
  or from the JAX package's (the two build equal arrays);
- NaiveBPE and FastBPE: the rank hash of ``ops/bpe_encode.build_rank_hash``
  (:class:`BPEState`);
- NaiveWP: the match trie's ``goto`` and ``accept``, and kernel 6's step
  records and '#' jumps (:class:`MatchState`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.symbols import SymbolTable
from ..ops.wp_encode import match_jumps, match_records
from ..ops.wp_encode_e2e import node_records


def _put(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclass
class BPEState:
    """The BPE encoders' rank hash on the device, and the host table of
    the symbol ids it is written in (unseen characters are interned into
    it at encode time and take part in no merge)."""

    table: SymbolTable
    hkeys: torch.Tensor  # int64[H]
    hrank: torch.Tensor  # int32[H]
    hout: torch.Tensor   # int32[H]
    max_probe: int

    @classmethod
    def build(cls, table, hkeys, hrank, hout, max_probe, device
              ) -> "BPEState":
        return cls(table, _put(hkeys, device), _put(hrank, device),
                   _put(hout, device), int(max_probe))


@dataclass
class MatchState:
    """NaiveWP's match trie on the device: its tables, and the step
    records and '#' jumps kernel 6 reads (ops/wp_encode.match_records,
    match_jumps), built once per vocabulary."""

    goto: torch.Tensor    # int32[n_nodes, A+1]
    accept: torch.Tensor  # int32[n_nodes]
    rec: torch.Tensor     # int32[n_nodes, A+1, 2]: (child, accept[child])
    jumps: torch.Tensor   # int32[MAX_INJECT+1, 4]
    hash_aid: int         # the alphabet id of '#'

    @classmethod
    def build(cls, trie, device) -> "MatchState":
        goto = torch.from_numpy(np.ascontiguousarray(trie.goto))
        accept = torch.from_numpy(np.ascontiguousarray(trie.accept))
        hash_aid = int(trie.alpha[ord("#")])
        return cls(goto.to(device), accept.to(device),
                   match_records(goto, accept).to(device),
                   match_jumps(goto, accept, hash_aid).to(device), hash_aid)


@dataclass
class E2EState:
    """Device-resident tables of the end-to-end scan."""

    goto: torch.Tensor       # int32[n_nodes, A+1]
    fail: torch.Tensor       # int32[n_nodes]
    pops_off: torch.Tensor   # int32[n_nodes+1]
    pops_flat: torch.Tensor  # int32[total_pops]
    rec: torch.Tensor        # int32[n_nodes, 8]: ops/wp_encode_e2e.node_records
    sharp: torch.Tensor      # int32[k]: encode_word("##"), or [-2]
    alpha: np.ndarray        # int32[0x110000] codepoint -> alphabet id, host
    root_p: int
    root_sharp: int
    unk_id: int
    max_pops: int


def e2e_state_from_numpy(goto, alpha, fail, pops_off, pops_flat, root_p,
                         root_sharp, unk_id,
                         sharp_seq: Optional[Sequence[int]],
                         device) -> E2EState:
    """The scan's state on ``device``. ``sharp_seq`` None means that
    encode_word("##") would not terminate: the scan then emits -2 where
    it needs it, and the caller raises."""
    device = torch.device(device)

    def put_cpu(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))

    def put(a):
        return put_cpu(a).to(device)

    pops_off = np.asarray(pops_off)
    sharp = [-2] if sharp_seq is None else list(sharp_seq)
    rec = node_records(*(put_cpu(a) for a in (fail, pops_off, pops_flat)))
    return E2EState(
        goto=put(goto), fail=put(fail), pops_off=put(pops_off),
        pops_flat=put(pops_flat), rec=rec.to(device),
        sharp=put(np.asarray(sharp)),
        alpha=np.asarray(alpha, dtype=np.int32), root_p=int(root_p),
        root_sharp=int(root_sharp), unk_id=int(unk_id),
        max_pops=int(np.diff(pops_off).max()))
