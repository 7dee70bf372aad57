"""Model base class: what every tokenizer of the port shares."""
from __future__ import annotations

from typing import List


class SubwordTokenizer:
    """Parent class for the port's tokenizers."""

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
