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

The control (:func:`control`): the plain trainer put in the program's
place in the form a tempting shortcut would give it: WordPiece (whose
configuration states a float64 score) scoring in float32, the precision
below; BPE (whose counts are exact integers and state no precision) with
the stated tie-break broken, ties going to the smaller symbol ids (the
order a selection over a hash table of pairs gives) instead of the pair
met first in scan order.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..reference import pretok, trainer

TOKENIZERS = ("FastBPE", "FastWP")
VARIANT = {False: "pair_order", True: "float32"}  # the control's, by
# wordpiece


class Task:
    """Calls of ``config``'s tokenizer on ``corpus`` (portbench/corpus.py)
    on ``device``; ``mix``, the traffic mix, sets nothing more."""

    def __init__(self, config: dict, corpus, mix: dict, device: str
                 ) -> None:
        name = config["tokenizer"]
        if name not in TOKENIZERS:
            raise ValueError(f"tokenizer must be one of {TOKENIZERS}")
        import subword_tokenizers_tpu_torch as port
        self.cls = getattr(port, name)
        self.max_vocab = int(config["max_vocab"])
        self.wordpiece = name == "FastWP"
        self.corpus = corpus
        self.device = device

    def warm(self) -> None:
        """Set-up's one train, which captures the loop's graphs."""
        self.once()

    def once(self) -> Tuple[List[Tuple[str, str]], Optional[set]]:
        """One train on a fresh tokenizer; (merges, vocabulary or None)."""
        tok = self.cls(device=self.device)
        tok.train(list(self.corpus.sentences), self.max_vocab)
        if self.wordpiece:
            return tok._merge_log, tok.vocab
        return tok.merges_list, None

    def keep(self, output):
        """All of it: a train's merges are what is compared."""
        return output

    def route_error(self, phases: dict) -> Optional[str]:
        """Every route of ``train`` is measured."""
        return None

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


def control(task: Task) -> None:
    """Turn ``task`` into the control: its calls the plain trainer in
    the control's form (:data:`VARIANT`) on its corpus."""
    def once():
        got = trainer.train(
            pretok.count_drawn(task.corpus.source, task.corpus.draw),
            task.max_vocab, task.wordpiece, variant=VARIANT[task.wordpiece])
        return got.merges, (got.vocab if task.wordpiece else None)
    task.once = once
