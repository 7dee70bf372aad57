"""BPE tokenizers of the port: NaiveBPE and FastBPE, training and
resources.

``train`` gives the JAX package's ``models/bpe.py`` results exactly
(``merges_list``, ``vocab``, ``corpus_as_symbols``, ``merges.json``,
FastBPE's ``_bpe_ranks``) and raises its errors. The path:

1. the C++ front end lowers and pre-splits the corpus, and word types
   are counted in first-occurrence order (``train.frontend``);
2. the word types become the flat state (ops/flat.py), interned
   character by character (``train.corpus``), and go to ``device``;
3. ops/train_loop.run_fused runs blocks of K merge steps, each step
   kernel K1 (pair counts), K2 (selection and hash unification) and K3
   (merge and compaction), then checks the block's records on the host
   (``train.device_block``, ``train.fetch_records``, ``train.verify``);
4. on a hash collision the run is redone on the exact per-step path
   (K1, K2 selection only, host interning, K3);
5. the final state comes back in one copy (``train.final_fetch``).

``device="cpu"`` runs the kernels' plain PyTorch versions. Encoding
(``tokenize``, ``tokenize_batch``, ``encode_word``) is not ported yet.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..benchmarks import profiling
from ..core.corpus import build_bpe_corpus, unique_words
from ..core.symbols import SymbolTable
from ..ops import train_loop
from ..ops.flat import build_flat
from .base import SubwordTokenizer, resolve_device

# Training domain ceiling: per-pair counts, and every sum of them the
# kernels take, stay below 2**52 symbol occurrences (exact in int64 with
# room to spare), as in the JAX package.
MAX_TOKENS_BPE = 1 << 52


def _read_merges(path: str, strict: bool) -> Optional[List[Tuple[str, str]]]:
    """The merges of ``path/merges.json``; None when the file is missing
    and not ``strict``."""
    merges_file = os.path.join(path, "merges.json")
    if not os.path.isfile(merges_file):
        if strict:
            raise FileNotFoundError(merges_file)
        return None
    with open(merges_file, "r", encoding="utf-8") as f:
        return [tuple(pair) for pair in json.load(f)]


class NaiveBPE(SubwordTokenizer):
    """BPE trained on ``device`` ("cuda" or "cpu")."""

    def __init__(self, device="cuda") -> None:
        self.device = resolve_device(self, device)
        self.merges_list: List[Tuple[str, str]] = []
        self.vocab: set = set()
        self.corpus_as_symbols: List[Tuple[List[str], int]] = []
        self._checkpoint_dir: Optional[str] = None
        self._checkpoint_every = 1000
        self._resume_dir: Optional[str] = None
        self._progress = False
        self._force_per_step = False

    # ------------------------------------------------------------ training

    def train(self, corpus: List[str], max_vocab: int = 30_000, *,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 1000, resume: bool = False,
              progress: bool = False) -> None:
        """Learn merges until the vocabulary reaches ``max_vocab``.

        ``checkpoint_dir`` writes ``merges.json`` there every
        ``checkpoint_every`` merges (after the block that passes it) and
        at the end; ``resume=True`` replays the merges found there over
        the rebuilt corpus first and trains on from that state.
        ``progress`` shows a tqdm bar.
        """
        if not isinstance(corpus, list) or not all(
                isinstance(example, str) for example in corpus):
            raise TypeError("Corpus must be a list of strings.")
        if not isinstance(max_vocab, int):
            raise TypeError("Maximum vocabulary size must be an integer.")

        self.reset()
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_every = max(int(checkpoint_every), 1)
        self._resume_dir = checkpoint_dir if resume else None
        self._progress = progress

        with profiling.phase("train.frontend"):
            words, freq, _ = unique_words(self.preprocessing_batch(corpus))
        for w in words:
            self.vocab.update(w)
        if not words:
            return

        total_tokens = int((np.array([len(w) for w in words],
                                     dtype=np.int64) * freq).sum())
        if total_tokens >= MAX_TOKENS_BPE:
            raise ValueError(
                "corpus exceeds the exact-selection domain "
                f"({total_tokens} symbol occurrences >= 2**52)")

        dev = self.device
        table = SymbolTable()
        with profiling.phase("train.corpus", dev):
            arrays = build_bpe_corpus(words, freq, table)
            state = train_loop.FlatState(*build_flat(arrays.sym,
                                                     arrays.freq), dev)
        max_len = arrays.sym.shape[1]
        rec = torch.zeros(6, dtype=torch.int32, device=dev)

        if self._resume_dir is not None:
            # Training is deterministic: replaying the checkpointed
            # merges rebuilds the interrupted state exactly.
            with profiling.phase("train.resume", dev):
                for sa, sb in _read_merges(self._resume_dir, strict=True):
                    a_id, b_id = table.get(sa), table.get(sb)
                    if a_id is None or b_id is None:
                        raise ValueError(
                            "checkpoint does not match this corpus: "
                            f"unknown symbol in merge ({sa!r}, {sb!r})")
                    merged = sa + sb
                    self.vocab.add(merged)
                    self.merges_list.append((sa, sb))
                    train_loop.merge_host_ids(state, a_id, b_id,
                                              table.intern(merged), rec)

        pbar = None
        if self._progress:
            from tqdm import tqdm
            pbar = tqdm(total=max_vocab - len(self.vocab),
                        desc="Training BPE")

        if not self._force_per_step:
            def on_merge(sa, sb, merged):
                self.vocab.add(merged)
                self.merges_list.append((sa, sb))

            since_ckpt = [0]

            def ckpt_cb(steps):
                since_ckpt[0] += steps
                if since_ckpt[0] >= self._checkpoint_every:
                    since_ckpt[0] = 0
                    self.save_resources(self._checkpoint_dir)

            try:
                train_loop.run_fused(
                    state, table, max_vocab, max_len, on_merge,
                    checkpoint_cb=(ckpt_cb if self._checkpoint_dir
                                   is not None else None),
                    progress_cb=pbar.update if pbar is not None else None)
            except train_loop.HashCollision:
                # A double-hash collision: redo the whole run on the
                # exact per-step path.
                if pbar is not None:
                    pbar.close()
                self._force_per_step = True
                try:
                    return self.train(
                        corpus, max_vocab,
                        checkpoint_dir=self._checkpoint_dir,
                        checkpoint_every=self._checkpoint_every,
                        resume=self._resume_dir is not None,
                        progress=self._progress)
                finally:
                    self._force_per_step = False
        else:
            steps = 0
            with profiling.phase("train.per_step", dev):
                while len(self.vocab) < max_vocab:
                    got = train_loop.step_host_ids(state, table, rec)
                    if got is None:
                        break
                    sa, sb, merged = got
                    self.vocab.add(merged)
                    self.merges_list.append((sa, sb))
                    steps += 1
                    if pbar is not None:
                        pbar.update(1)
                    if (self._checkpoint_dir is not None
                            and steps % self._checkpoint_every == 0):
                        self.save_resources(self._checkpoint_dir)
        if pbar is not None:
            pbar.close()
        if self._checkpoint_dir is not None:
            self.save_resources(self._checkpoint_dir)

        with profiling.phase("train.final_fetch"):
            sym_host = train_loop._flat_to_padded(*state.host(),
                                                  len(arrays.freq))
            self.corpus_as_symbols = [
                ([table.string(int(s)) for s in row if s >= 0], int(f))
                for row, f in zip(sym_host, arrays.freq)
            ]

    # ------------------------------------------------------------- state io

    def reset(self) -> None:
        """Forget every learned merge."""
        self.merges_list.clear()
        self.vocab.clear()
        self.corpus_as_symbols.clear()

    def save_resources(self, path: str) -> None:
        """Write ``merges.json`` (a JSON list of [a, b] pairs) atomically:
        it doubles as the training checkpoint."""
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, "merges.json")
        tmp = target + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.merges_list, f, ensure_ascii=False)
        os.replace(tmp, target)

    def load_resources(self, path: str, strict: bool = False) -> None:
        """Load ``merges.json``. A missing file is a silent no-op, as in
        the reference; ``strict=True`` raises FileNotFoundError instead."""
        merges = _read_merges(path, strict)
        if merges is not None:
            self.merges_list = merges


class FastBPE(NaiveBPE):
    """BPE whose encoder merges greedily by rank; training is
    NaiveBPE's, and the ranks are kept in ``_bpe_ranks``."""

    def __init__(self, device="cuda") -> None:
        super().__init__(device)
        self._bpe_ranks: Dict[Tuple[str, str], int] = {}

    def train(self, corpus: List[str], max_vocab: int = 30_000,
              **kwargs) -> None:
        super().train(corpus, max_vocab, **kwargs)
        self._bpe_ranks = {pair: i for i, pair in
                           enumerate(self.merges_list)}

    def load_resources(self, path: str, strict: bool = False) -> None:
        super().load_resources(path, strict=strict)
        self._bpe_ranks = {pair: i for i, pair in
                           enumerate(self.merges_list)}
