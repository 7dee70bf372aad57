"""Model base class: what every tokenizer of the port shares, including
the built-in BERT-style front end (frontend/pretokenize.py)."""
from __future__ import annotations

from typing import List

import torch

from ..frontend.pretokenize import (Token, WordBatch, pre_tokenize_str,
                                    pretokenize_batch)


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
