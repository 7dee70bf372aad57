"""Model base class: what every tokenizer of the port shares, including
the built-in BERT-style front end (frontend/pretokenize.py)."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..benchmarks import profiling
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
    R = out2d.shape[0]
    with profiling.phase("encode.compact", dev):
        no = torch.zeros(R, dtype=torch.bool, device=dev)
        ids_d, head_d = compact_ids(out2d, out_n, *(
            no if f is None else f for f in (ovf, stuck, crash)))
    with profiling.phase("encode.d2h", dev):
        head = head_d.cpu().numpy()
        offs = head[:R + 1].astype(np.int64)
        ids = ids_d[:int(offs[R])].cpu().numpy()
    return ids, offs, head[R + 1:]


class SubwordTokenizer:
    """Parent class for the port's tokenizers."""

    def preprocessing(self, corpus: List[str]) -> List[List[Token]]:
        """Lower and pre-split each sentence: per sentence,
        ``[(word, (start, end)), ...]`` (the reference's schema)."""
        return [pre_tokenize_str(example) for example in corpus]

    def preprocessing_batch(self, corpus: List[str]) -> WordBatch:
        """The front end's output as flat arrays (the trainers' input)."""
        return pretokenize_batch(corpus)

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
