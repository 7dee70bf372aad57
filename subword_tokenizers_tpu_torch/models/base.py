"""Model base class: what every tokenizer of the port shares, including
the built-in BERT-style front end (frontend/pretokenize.py) and, as in
the JAX package, an injected HF-style tokenizer used only for
pre-tokenization (any object exposing
``backend_tokenizer.pre_tokenizer.pre_tokenize_str``)."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..benchmarks import profiling
from ..frontend.charclass import codepoints
from ..frontend.pretokenize import (Token, WordBatch, pre_tokenize_str,
                                    pretokenize_batch)
from ..ops.fetch import compact_ids
from . import training


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

    def __init__(self, tokenizer: Optional[object] = None,
                 mesh: Optional[object] = None, *, device="cuda") -> None:
        """``tokenizer``: an HF-style tokenizer used only for
        pre-tokenization; None takes the built-in front end. ``mesh``: a
        data mesh on ``device``'s type (parallel/mesh.py), which shards
        training; ``device``: "cuda" or "cpu"."""
        self.tokenizer = tokenizer
        self.mesh = mesh
        self.device = resolve_mesh(self, mesh, resolve_device(self, device))
        self.vocab: set = set()
        self.corpus_as_symbols: List[Tuple[List[str], int]] = []
        self._checkpoint_dir: Optional[str] = None
        self._checkpoint_every = 1000
        self._resume_dir: Optional[str] = None
        self._progress = False
        self._force_per_step = False

    def train(self, corpus: List[str], max_vocab: int = 30_000, *,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 1000, resume: bool = False,
              progress: bool = False) -> None:
        """Learn merges until the vocabulary holds ``max_vocab`` tokens
        or no pair is left (models/training.py, for every model and
        route).

        ``checkpoint_dir`` writes a checkpoint there (BPE's
        ``merges.json``, WordPiece's ``wp_state.json`` and
        ``vocab.json``) every ``checkpoint_every`` merges (after the
        block that passes it) and at the end; ``resume=True`` replays
        the merges found there over the rebuilt corpus first and trains
        on from that state. ``progress`` writes the count of merges to
        stderr (``utils.Progress``).

        Under a mesh it also sets ``_sel_stats`` (the steps each tier
        settled), ``_topk_fallbacks`` and ``_graph_stats`` (the run's
        captures, replays and steps queued step by step:
        parallel/train.ShardedTrainer); ``_force_tier`` ('compact' or
        'full') pins the selection to one exact tier.
        """
        training.train(self, corpus, max_vocab, checkpoint_dir,
                       checkpoint_every, resume, progress)

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
