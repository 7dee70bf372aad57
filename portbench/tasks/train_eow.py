"""The ``train_eow`` task: GPT-1's BPE, one call of FastBPE's public
``train`` with an end-of-word suffix on the cell's corpus, and its check
against the plain trainer with that suffix.

A configuration of this task names ``FastBPE`` as its ``tokenizer``,
``max_vocab`` and ``end_of_word_suffix`` (GPT-1's ``"</w>"``). One call
builds a new tokenizer with that suffix on the device and trains it to
``max_vocab``; what it produces is its ordered merge list, compared whole
with what ``portbench/reference/eow.py`` learns on the same corpus (the
number compared is how many calls differ, whose limit is 0).

The control (:func:`control`): that plain trainer with its tie-break
broken, ties going to the smaller symbol ids instead of the pair met
first in scan order, as ``train``'s control for BPE.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..reference import eow, pretok
from . import train


class Task(train.Task):
    """``train``'s task with the configuration's ``end_of_word_suffix``;
    ``wordpiece`` and ``max_vocab`` as there."""

    def __init__(self, config: dict, corpus, mix: dict, device: str
                 ) -> None:
        if config["tokenizer"] != "FastBPE":
            raise ValueError("the train_eow task trains FastBPE")
        super().__init__(config, corpus, mix, device)
        self.suffix = config["end_of_word_suffix"]

    def once(self) -> Tuple[List[Tuple[str, str]], Optional[set]]:
        """One train on a fresh tokenizer; (merges, None)."""
        tok = self.cls(device=self.device, end_of_word_suffix=self.suffix)
        tok.train(list(self.corpus.sentences), self.max_vocab)
        return tok.merges_list, None

    def counts(self):
        """The corpus's word types and counts, as the plain trainer
        takes them."""
        return pretok.count_drawn(self.corpus.source, self.corpus.draw)

    def reference(self, record_states: bool = False):
        """What the plain trainer learns on the corpus with the suffix."""
        return eow.train(self.counts(), self.max_vocab, self.suffix,
                         record_states=record_states)


def control(task: Task) -> None:
    """Turn ``task`` into the control: its calls the plain trainer with
    ties broken by symbol ids."""
    def once():
        got = eow.train(task.counts(), task.max_vocab, task.suffix,
                        variant="pair_order")
        return got.merges, None
    task.once = once
