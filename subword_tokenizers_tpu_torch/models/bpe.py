"""BPE tokenizers of the port: NaiveBPE and FastBPE, training and
resources.

``train`` gives the JAX package's ``models/bpe.py`` results exactly
(``merges_list``, ``vocab``, ``corpus_as_symbols``, ``merges.json``,
FastBPE's ``_bpe_ranks``) and raises its errors. The path:

1. the C++ front end lowers and pre-splits the corpus, and word types
   are counted in first-occurrence order (``train.frontend``), and the
   initial symbols gathered (``train.alphabet``);
2. the word types become the flat state (ops/flat.py), interned
   character by character (``train.corpus``), and go to ``device``;
3. ops/train_loop.run_fused runs blocks of K merge steps, each step
   kernel K1 (pair counts), K2 (selection and hash unification) and K3
   (merge and compaction), then checks the block's records on the host
   (``train.loop_setup``, ``train.device_block``, ``train.capture``,
   ``train.fetch_records``, ``train.verify``, ``train.close``);
4. on a hash collision the run is redone on the exact per-step path
   (K1, K2 selection only, host interning, K3);
5. the final state comes back in one copy (``train.final_fetch``,
   holding ``train.final_copy``), and becomes ``corpus_as_symbols``
   (``train.symbols``, inside ``train.final_fetch``); FastBPE then
   ranks the merges (``train.ranks``).

``SWT_SKIP_COMPACT`` (and, for WordPiece, ``SWT_WP_TOURNAMENT``) choose
the other routes of step 3, with the same merges, as in the JAX package
(ops/train_loop.run_fused); unset, every step compacts.

Encoding gives the JAX package's token lists. ``tokenize`` and
``encode_word`` run on the host (NaiveBPE: the cursor-monotone greedy
loop, which equals applying every merge in order; FastBPE: greedy
lowest rank). ``tokenize_batch``:

1. the C++ front end lowers and pre-splits the corpus, word types are
   deduplicated, and each becomes a row of symbol ids in the rank hash's
   table, unseen characters getting fresh ids (``encode.frontend``);
2. one host-to-device copy (``encode.h2d``); the rank hash itself is
   moved once per merge list (models/state.BPEState);
3. kernel 5 runs every word's merge loop (``encode.bpe_merge``,
   ops/bpe_encode.bpe_encode), kernel 2 writes the dense token stream
   (``encode.compact``, ops/fetch.compact_ids);
4. two device-to-host copies, of the offsets and of the stream
   (``encode.d2h``);
5. the C++ stitch builds the token lists, rendering positions > 0 as
   ``"##" + s`` (``encode.stitch``).

Every batch goes to the kernels, whatever its size. Two routes are the
JAX package's: NaiveBPE with a merge pair listed twice encodes on the
host (``encode.host``), since applying every merge in order is then not
the cursor rule; and FastBPE rows that merge to nothing are assembled on
the host as ``[""]``.

``device="cpu"`` runs the kernels' plain PyTorch versions.

With ``mesh`` (parallel/mesh.py) training shards the word types across
the mesh and picks each merge through the tiered selection of
parallel/train.py, with the same merges as one device (there is no
fused block loop under a mesh, as in the JAX package); encoding keeps
its kernels on the mesh's first device.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import utils
from .._native import binding
from ..benchmarks import profiling
from ..core.corpus import build_bpe_corpus, unique_words
from ..core.symbols import SymbolTable
from ..frontend.charclass import codepoints
from ..ops import train_loop
from ..ops.bpe_encode import SYM_BITS, bpe_encode, build_rank_hash
from ..ops.flat import build_flat
from .base import (SubwordTokenizer, fetch_stream, resolve_device,
                   resolve_mesh)
from .state import BPEState

# Training domain ceiling: per-pair counts, and every sum of them the
# kernels take, stay below 2**52 symbol occurrences (exact in int64 with
# room to spare), as in the JAX package.
MAX_TOKENS_BPE = 1 << 52


def _merge_pass(pair: Tuple[str, str], word: List[str]) -> List[str]:
    """One left-to-right, non-overlapping replacement of ``pair``."""
    merged = pair[0] + pair[1]
    out: List[str] = []
    i, n = 0, len(word)
    while i < n:
        if i < n - 1 and word[i] == pair[0] and word[i + 1] == pair[1]:
            out.append(merged)
            i += 2
        else:
            out.append(word[i])
            i += 1
    return out


def _assemble(encoded: List[List[str]], sent_id: np.ndarray,
              inverse: np.ndarray, n_sentences: int) -> List[List[str]]:
    """Per-sentence token lists from each word type's tokens."""
    out: List[List[str]] = [[] for _ in range(n_sentences)]
    for s, u in zip(sent_id.tolist(), inverse.tolist()):
        out[s].extend(encoded[u])
    return out


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
    """BPE trained on ``device`` ("cuda" or "cpu"), whose encoder applies
    every merge once, in order. ``tokenizer``: an HF-style pre-tokenizer
    (models/base.py); ``mesh``: a data mesh on ``device``'s type, which
    shards training (parallel/train.py)."""

    _MONOTONE = True

    def __init__(self, tokenizer: Optional[object] = None,
                 mesh: Optional[object] = None, *, device="cuda") -> None:
        super().__init__(tokenizer)
        self.mesh = mesh
        self.device = resolve_mesh(self, mesh, resolve_device(self, device))
        self.merges_list: List[Tuple[str, str]] = []
        self.vocab: set = set()
        self.corpus_as_symbols: List[Tuple[List[str], int]] = []
        self._drop_encode_state()
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
        ``progress`` writes the count of merges to stderr
        (``utils.Progress``).
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
        with profiling.phase("train.alphabet"):
            for w in words:
                self.vocab.update(w)
            total_tokens = int((np.array([len(w) for w in words],
                                         dtype=np.int64) * freq).sum())
        if not words:
            return
        if total_tokens >= MAX_TOKENS_BPE:
            raise ValueError(
                "corpus exceeds the exact-selection domain "
                f"({total_tokens} symbol occurrences >= 2**52)")

        dev = self.device
        table = SymbolTable()
        if self.mesh is not None:
            with profiling.phase("train.corpus", dev):
                arrays = build_bpe_corpus(words, freq, table)
            self._train_on_mesh(
                arrays, table, max_vocab, self.merges_list,
                lambda sa, sb: sa + sb,
                _read_merges(self._resume_dir, strict=True)
                if self._resume_dir is not None else [],
                lambda: self.save_resources(self._checkpoint_dir),
                "Training BPE")
            return
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

        sym_host = None  # the final state, when run_fused returns it
        pbar = None
        if self._progress:
            pbar = utils.Progress(total=max_vocab - len(self.vocab),
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
                sym_host = train_loop.run_fused(
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
                    profiling.count("train.merges")
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
            if sym_host is None:
                with profiling.phase("train.final_copy"):
                    sym_host = state.padded()
            with profiling.phase("train.symbols"):
                self.corpus_as_symbols = [
                    ([table.string(int(s)) for s in row if s >= 0], int(f))
                    for row, f in zip(sym_host, arrays.freq)
                ]

    # ------------------------------------------------------------ encoding

    def _drop_encode_state(self) -> None:
        """Forget what encoding derived from the merge list."""
        self._encode_cache: Dict[str, List[str]] = {}
        self._bpe_state: Optional[BPEState] = None
        self._alt_cache = None
        self._host_ranks: Optional[Dict[Tuple[str, str], int]] = None
        self._has_dups: Optional[bool] = None

    def _ranks_first(self) -> Dict[Tuple[str, str], int]:
        """Each merge pair's first rank, cached."""
        if self._host_ranks is None:
            ranks: Dict[Tuple[str, str], int] = {}
            for i, p in enumerate(self.merges_list):
                ranks.setdefault(p, i)
            self._host_ranks = ranks
        return self._host_ranks

    def _rank_map(self) -> Dict[Tuple[str, str], int]:
        """The ranks the device encoder uses."""
        return self._ranks_first()

    def _has_duplicate_merges(self) -> bool:
        if self._has_dups is None:
            self._has_dups = (len(set(self.merges_list))
                              != len(self.merges_list))
        return self._has_dups

    def _encode_symbols(self, word: str) -> List[str]:
        """The cursor-monotone greedy loop: the lowest-ranked pair whose
        rank is at least the cursor, which then moves past it. With a
        pair listed twice, every merge pass in order instead."""
        symbols = list(word)
        if self._has_duplicate_merges():
            for pair in self.merges_list:
                symbols = _merge_pass(pair, symbols)
            return symbols
        ranks = self._ranks_first()
        cursor = 0
        while len(symbols) > 1:
            best = None
            best_rank = None
            for i in range(len(symbols) - 1):
                r = ranks.get((symbols[i], symbols[i + 1]))
                if r is not None and r >= cursor and (
                        best_rank is None or r < best_rank):
                    best_rank, best = r, (symbols[i], symbols[i + 1])
            if best is None:
                break
            symbols = _merge_pass(best, symbols)
            cursor = best_rank + 1
        return symbols

    def encode_word(self, word: str) -> List[str]:
        """Encode one word; tokens after the first get a '##' prefix."""
        symbols = self._encode_symbols(word)
        if len(symbols) > 1:
            symbols[1:] = ["##" + s for s in symbols[1:]]
        return symbols

    def _device_tables(self) -> BPEState:
        """The rank hash on ``self.device``, built once per merge list:
        each pair's strings and its merge interned in rank-map order."""
        if self._bpe_state is None:
            table = SymbolTable()
            entries = []  # (key, rank, out_id)
            for (sa, sb), rank in self._rank_map().items():
                a, b = table.intern(sa), table.intern(sb)
                entries.append(((a << SYM_BITS) | b, rank,
                                table.intern(sa + sb)))
            self._bpe_state = BPEState.build(
                table, *build_rank_hash(entries), self.device)
        return self._bpe_state

    @staticmethod
    def _encode_inputs(words: List[str], table: SymbolTable) -> np.ndarray:
        """int32[W, L] symbol ids of the words' characters, PAD-filled, L
        the longest word rounded up to a multiple of 8 (at least 8).
        Characters the table lacks are interned in order of first
        occurrence: they take part in no merge."""
        W = len(words)
        wlen = np.fromiter(map(len, words), dtype=np.int64, count=W)
        L = -(-max(int(wlen.max()), 2) // 8) * 8
        cps = codepoints("".join(words))
        uniq, first = np.unique(cps, return_index=True)
        ids = np.empty(uniq.shape[0], dtype=np.int32)
        for k in np.argsort(first, kind="stable").tolist():
            ids[k] = table.intern(chr(int(uniq[k])))
        if len(table) > 1 << SYM_BITS:
            raise ValueError(f"{len(table)} symbols do not fit the "
                             f"{SYM_BITS}-bit pair keys")
        sym = np.full((W, L), -1, dtype=np.int32)
        sym[np.arange(L)[None, :] < wlen[:, None]] = \
            ids[np.searchsorted(uniq, cps)]
        return sym

    def _alt_strings(self, table: SymbolTable) -> List[str]:
        """``"##" + s`` per id (the rendering of positions > 0), cached
        per table state."""
        key = (id(table), len(table))
        if self._alt_cache is None or self._alt_cache[0] != key:
            self._alt_cache = (key, ["##" + s for s in table.strings()])
        return self._alt_cache[1]

    def tokenize_batch(self, corpus: List[str]) -> List[List[str]]:
        """Tokenize a corpus; equals ``tokenize`` of each sentence. Every
        word type is encoded once, by the kernels on ``self.device``."""
        S = len(corpus)
        dev = self.device
        with profiling.phase("encode.frontend"):
            wb = self.preprocessing_batch(corpus)
            words, _, inverse = unique_words(wb)
            host_route = self._has_duplicate_merges()
            if words and not host_route:
                st = self._device_tables()
                sym = self._encode_inputs(words, st.table)
        if not words:
            return [[] for _ in range(S)]
        if host_route:
            # Merges listed twice: the exact sequential passes, on the host.
            with profiling.phase("encode.host"):
                encoded = [self.encode_word(w) for w in words]
                return _assemble(encoded, wb.sent_id, inverse, S)
        with profiling.phase("encode.h2d", dev):
            sym_d = torch.from_numpy(sym).to(dev)
        with profiling.phase("encode.bpe_merge", dev):
            merged, out_n = bpe_encode(sym_d, st.hkeys, st.hrank, st.hout,
                                       self._MONOTONE, st.max_probe)
        ids, offs, _ = fetch_stream(merged, out_n)
        starts, counts = offs[:-1], np.diff(offs).astype(np.int32)
        strings = st.table.strings()
        if not self._MONOTONE and not counts.all():
            # FastBPE renders a word that merges to nothing as [""].
            encoded = []
            for b, n in zip(starts.tolist(), counts.tolist()):
                toks = [strings[t] for t in ids[b:b + n].tolist()] or [""]
                encoded.append(toks[:1] + ["##" + t for t in toks[1:]])
            return _assemble(encoded, wb.sent_id, inverse, S)
        bounds = np.searchsorted(wb.sent_id, np.arange(S + 1))
        with profiling.phase("encode.stitch"):
            return binding.stitch_flat(strings, ids, starts, counts,
                                       inverse, bounds,
                                       alt=self._alt_strings(st.table))

    # ------------------------------------------------------------- state io

    def reset(self) -> None:
        """Forget every learned merge, and what encoding derived from
        them."""
        self.merges_list.clear()
        self.vocab.clear()
        self.corpus_as_symbols.clear()
        self._drop_encode_state()

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
            self._drop_encode_state()


class FastBPE(NaiveBPE):
    """BPE whose encoder merges greedily by rank; training is
    NaiveBPE's, and the ranks are kept in ``_bpe_ranks``. As in the JAX
    package (and the reference), ``reset`` keeps ``_bpe_ranks``: the host
    encoder (``tokenize``, ``encode_word``) goes on using the last
    trained or loaded ranks, while ``tokenize_batch`` ranks the current
    ``merges_list``."""

    _MONOTONE = False

    def __init__(self, tokenizer: Optional[object] = None,
                 mesh: Optional[object] = None, *, device="cuda") -> None:
        super().__init__(tokenizer, mesh, device=device)
        self._bpe_ranks: Dict[Tuple[str, str], int] = {}

    def train(self, corpus: List[str], max_vocab: int = 30_000,
              **kwargs) -> None:
        super().train(corpus, max_vocab, **kwargs)
        with profiling.phase("train.ranks"):
            self._bpe_ranks = {pair: i for i, pair in
                               enumerate(self.merges_list)}

    def _rank_map(self) -> Dict[Tuple[str, str], int]:
        """The ranks of ``merges_list`` (a later duplicate overwrites the
        rank), which the device encoder uses."""
        return {pair: i for i, pair in enumerate(self.merges_list)}

    def _has_duplicate_merges(self) -> bool:
        # Greedy encoding uses dict ranks: duplicates change nothing.
        return False

    def _encode_symbols(self, word: str) -> List[str]:
        """Greedy loop: merge the present pair of lowest rank until none
        is left."""
        symbols = list(word)
        if len(symbols) < 2:
            return symbols
        if self._host_ranks is None:
            self._host_ranks = self._bpe_ranks or self._rank_map()
        ranks = self._host_ranks
        while len(symbols) > 1:
            best = None
            best_rank = None
            for i in range(len(symbols) - 1):
                r = ranks.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best = r, (symbols[i], symbols[i + 1])
            if best is None:
                break
            symbols = _merge_pass(best, symbols)
        return symbols

    def encode_word(self, word: str) -> List[str]:
        """As NaiveBPE's, but the empty word encodes as ``[""]``."""
        symbols = self._encode_symbols(word)
        if not symbols:
            return [""]
        if len(symbols) > 1:
            symbols[1:] = ["##" + s for s in symbols[1:]]
        return symbols

    def load_resources(self, path: str, strict: bool = False) -> None:
        super().load_resources(path, strict=strict)
        self._bpe_ranks = {pair: i for i, pair in
                           enumerate(self.merges_list)}
        self._host_ranks = None
