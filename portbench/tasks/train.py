"""The ``train`` task: one call of a tokenizer's public ``train`` on the
cell's corpus, and its check against the plain trainer.

A configuration of this task names the port's tokenizer class
(``tokenizer``: ``FastBPE`` or ``FastWP``) and
``max_vocab``. One call builds a new tokenizer on the device and trains
it to ``max_vocab``; ``train`` returns once the merges are on the host.

What a call produces is its ordered merge list (``merges_list`` of the
BPE classes, the merge log of the WordPiece classes) and, for WordPiece,
its vocabulary. Each is compared whole with what the plain trainer
(``portbench/reference/trainer.py``) learns on the same corpus; the
number compared is how many calls differ from it, whose limit is 0.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..reference import pretok, trainer

TOKENIZERS = ("FastBPE", "FastWP")


class Task:
    """Calls of ``config``'s tokenizer on ``corpus`` (portbench/corpus.py)
    on ``device``."""

    def __init__(self, config: dict, corpus, device: str) -> None:
        name = config["tokenizer"]
        if name not in TOKENIZERS:
            raise ValueError(f"tokenizer must be one of {TOKENIZERS}")
        import subword_tokenizers_tpu_torch as port
        self.cls = getattr(port, name)
        self.max_vocab = int(config["max_vocab"])
        self.wordpiece = name == "FastWP"
        self.corpus = corpus
        self.device = device

    def once(self) -> Tuple[List[Tuple[str, str]], Optional[set]]:
        """One train on a fresh tokenizer; (merges, vocabulary or None)."""
        tok = self.cls(device=self.device)
        tok.train(list(self.corpus.sentences), self.max_vocab)
        if self.wordpiece:
            return tok._merge_log, tok.vocab
        return tok.merges_list, None

    def work(self, output) -> int:
        """The merges one call learned."""
        return len(output[0])

    def reference(self, record_states: bool = False) -> trainer.Trained:
        """What the plain trainer learns on the corpus."""
        counts = pretok.count_drawn(self.corpus.source, self.corpus.draw)
        return trainer.train(counts, self.max_vocab, self.wordpiece,
                             record_states=record_states)

    def wrong(self, outputs, expected: trainer.Trained) -> int:
        """How many of ``outputs`` differ from ``expected``."""
        vocab = expected.vocab if self.wordpiece else None
        return sum(1 for merges, v in outputs
                   if merges != expected.merges or v != vocab)
