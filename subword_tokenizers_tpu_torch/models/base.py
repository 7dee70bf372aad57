"""Model base class: what every tokenizer of the port shares, including
the built-in BERT-style front end (frontend/pretokenize.py) and, as in
the JAX package, an injected HF-style tokenizer used only for
pre-tokenization (any object exposing
``backend_tokenizer.pre_tokenizer.pre_tokenize_str``)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import utils
from ..benchmarks import profiling
from ..frontend.charclass import codepoints
from ..frontend.pretokenize import (Token, WordBatch, pre_tokenize_str,
                                    pretokenize_batch)
from ..ops.fetch import compact_ids


def resolve_device(owner: object, device) -> torch.device:
    """The ``torch.device`` a tokenizer of class ``owner`` runs on: "cpu"
    (the kernels' plain versions) or a CUDA device, which must exist and
    gets an explicit index. Raises for anything else."""
    dev = torch.device(device)
    name = type(owner).__name__
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{name}(device='cuda'): CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def fetch_stream(out2d, out_n, ovf=None, stuck=None, crash=None):
    """Kernel 2 over encoded rows, then the two copies back
    (``encode.compact``, ``encode.d2h``): numpy (ids int32[total],
    offsets int64[R+1], flags int32[R]), the flags byte of
    ops/fetch.compact_ids. A flag passed as None is false on every row."""
    dev = out2d.device
    with profiling.phase("encode.compact", dev):
        ids_d, head_d = compact_ids(out2d, out_n, ovf, stuck, crash)
    return fetch_head(ids_d, head_d)


def fetch_head(ids_d, head_d):
    """The two copies back of a compacted stream (``encode.d2h``): numpy
    (ids int32[total], offsets int64[R+1], flags int32[R]) from the
    (ids, head) of ops/fetch.compact_ids."""
    R = (head_d.shape[0] - 1) // 2
    with profiling.phase("encode.d2h", head_d.device):
        head = head_d.cpu().numpy()
        offs = head[:R + 1].astype(np.int64)
        ids = ids_d[:int(offs[R])].cpu().numpy()
    return ids, offs, head[R + 1:]


def resolve_mesh(owner: object, mesh, device: torch.device) -> torch.device:
    """The device of a tokenizer built with ``mesh`` (parallel/mesh.py):
    the mesh's home device, which must be of ``device``'s type."""
    if mesh is None:
        return device
    if mesh.type != device.type:
        raise ValueError(f"{type(owner).__name__}: the mesh is on "
                         f"{mesh.type}, the tokenizer on {device.type}")
    return mesh.home


class SubwordTokenizer:
    """Parent class for the port's tokenizers."""

    def __init__(self, tokenizer: Optional[object] = None) -> None:
        """``tokenizer``: an HF-style tokenizer used only for
        pre-tokenization; None takes the built-in front end."""
        self.tokenizer = tokenizer

    def preprocessing(self, corpus: List[str]) -> List[List[Token]]:
        """Lower and pre-split each sentence: per sentence,
        ``[(word, (start, end)), ...]`` (the reference's schema)."""
        if self.tokenizer is not None:
            pt = self.tokenizer.backend_tokenizer.pre_tokenizer
            return [pt.pre_tokenize_str(example.lower())
                    for example in corpus]
        return [pre_tokenize_str(example) for example in corpus]

    def preprocessing_batch(self, corpus: List[str]) -> WordBatch:
        """The front end's output as flat arrays (the trainers' input);
        an injected tokenizer's words go through the reference's schema
        into the same arrays."""
        if self.tokenizer is None:
            return pretokenize_batch(corpus)
        toks = self.preprocessing(corpus)
        lowered = [s.lower() for s in corpus]
        sent_off = np.zeros(len(corpus) + 1, dtype=np.int64)
        np.cumsum([len(s) for s in lowered], out=sent_off[1:])
        ws, we, sid = [], [], []
        for i, sent in enumerate(toks):
            for _, (s, e) in sent:
                ws.append(s + sent_off[i])
                we.append(e + sent_off[i])
                sid.append(i)
        return WordBatch(cps=codepoints("".join(lowered)),
                         word_start=np.asarray(ws, dtype=np.int64),
                         word_end=np.asarray(we, dtype=np.int64),
                         sent_id=np.asarray(sid, dtype=np.int32),
                         sent_cp_off=sent_off)

    def _train_on_mesh(self, arrays, table, max_vocab: int, log: list,
                       join, resume, save, desc: str, sym_cap=None,
                       wide_score: bool = False) -> None:
        """Training under ``self.mesh`` (parallel/train.py), the JAX
        package's per-step loop: the tiered selection, host interning of
        ``join(sa, sb)``, K3p on every shard. ``resume`` is the merges to
        replay first, ``save()`` writes a checkpoint, ``log`` gets each
        merge's pair; ``sym_cap`` (WordPiece) selects by exact score.
        Sets ``vocab``, ``corpus_as_symbols``, ``_sel_stats``,
        ``_topk_fallbacks`` and ``_graph_stats`` (the run's captures,
        replays and steps queued step by step: ShardedTrainer);
        ``_force_tier`` ('compact' or 'full') pins the selection to one
        exact tier. The trainer's graphs are released when the run ends."""
        from ..parallel.train import ShardedTrainer
        dev = self.device
        with profiling.phase("train.corpus", dev):
            trainer = ShardedTrainer(
                self.mesh, arrays.sym, arrays.freq, sym_cap=sym_cap,
                wide_score=wide_score,
                force_tier=getattr(self, "_force_tier", None))
        self._sel_stats = trainer.sel_stats
        self._topk_fallbacks = 0
        self._graph_stats = trainer.graph_stats

        def merge(a_id, b_id, sa, sb):
            merged = join(sa, sb)
            self.vocab.add(merged)
            log.append((sa, sb))
            trainer.merge(a_id, b_id, table.intern(merged))

        try:
            for sa, sb in resume:
                a_id, b_id = table.get(sa), table.get(sb)
                if a_id is None or b_id is None:
                    raise ValueError(
                        "checkpoint does not match this corpus: "
                        f"unknown symbol in merge ({sa!r}, {sb!r})")
                merge(a_id, b_id, sa, sb)
            pbar = None
            if self._progress:
                pbar = utils.Progress(total=max_vocab - len(self.vocab),
                                      desc=desc)
            steps = 0
            with profiling.phase("train.sharded", dev):
                while len(self.vocab) < max_vocab:
                    got = trainer.select()
                    self._topk_fallbacks = trainer.topk_fallbacks
                    if got is None:
                        break
                    merge(*got, table.string(got[0]), table.string(got[1]))
                    steps += 1
                    profiling.count("train.merges")
                    if pbar is not None:
                        pbar.update(1)
                    if (self._checkpoint_dir is not None
                            and steps % self._checkpoint_every == 0):
                        save()
        finally:
            with profiling.phase("train.close"):
                trainer.close()
        if pbar is not None:
            pbar.close()
        if self._checkpoint_dir is not None:
            save()
        with profiling.phase("train.final_fetch"):
            with profiling.phase("train.final_copy"):
                sym_host = trainer.host()
            with profiling.phase("train.symbols"):
                self.corpus_as_symbols = [
                    ([table.string(int(s)) for s in row if s >= 0], int(f))
                    for row, f in zip(sym_host, arrays.freq)
                ]

    def vocab_length(self, corpus: List[str]) -> int:
        """Number of distinct characters in the corpus."""
        return len({symbol for example in corpus for symbol in example})

    def tokenize(self, text: str) -> List[str]:
        """Tokenize one sentence on the host with the subclass's
        ``encode_word``, each word type encoded once per vocabulary."""
        if not isinstance(text, str):
            raise TypeError("Text to tokenize must be a string.")
        cache = self._encode_cache
        out: List[str] = []
        for word, _ in self.preprocessing([text])[0]:
            toks = cache.get(word)
            if toks is None:
                toks = self.encode_word(word)
                cache[word] = toks
            out.extend(toks)
        return out

    def tokenize_batch(self, corpus: List[str]) -> List[List[str]]:
        raise NotImplementedError

    def tokenize_stream(self, sentences, batch_sentences: int = 8192):
        """Bounded-memory streaming encode: consume any iterable of
        sentences, yield one token list per sentence, in order, running
        ``tokenize_batch`` on ``batch_sentences`` at a time."""
        if batch_sentences < 1:
            raise ValueError("batch_sentences must be >= 1")
        block: List[str] = []
        for s in sentences:
            block.append(s)
            if len(block) >= batch_sentences:
                yield from self.tokenize_batch(block)
                block = []
        if block:
            yield from self.tokenize_batch(block)
