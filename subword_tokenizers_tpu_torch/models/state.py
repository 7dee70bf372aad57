"""FastWP's weights on the device.

For a tokenizer the weights are the trie tables. :func:`e2e_state_from_
numpy` takes them as numpy arrays, from this package's
``models/trie.E2ETrie`` or from the JAX package's (the two build equal
arrays), and moves the ones the scan reads to ``device`` once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch


@dataclass
class E2EState:
    """Device-resident tables of the end-to-end scan."""

    goto: torch.Tensor       # int32[n_nodes, A+1]
    fail: torch.Tensor       # int32[n_nodes]
    pops_off: torch.Tensor   # int32[n_nodes+1]
    pops_flat: torch.Tensor  # int32[total_pops]
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

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)
                                ).to(device)

    pops_off = np.asarray(pops_off)
    sharp = [-2] if sharp_seq is None else list(sharp_seq)
    return E2EState(
        goto=put(goto), fail=put(fail), pops_off=put(pops_off),
        pops_flat=put(pops_flat), sharp=put(np.asarray(sharp)),
        alpha=np.asarray(alpha, dtype=np.int32), root_p=int(root_p),
        root_sharp=int(root_sharp), unk_id=int(unk_id),
        max_pops=int(np.diff(pops_off).max()))
