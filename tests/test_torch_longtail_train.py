"""Training on the long-tailed corpus (``data/longtail-160k.json``, from
``tools/gen_longtail.py``): the port's FastWP and FastBPE, on their CPU
versions, learn the plain trainer's merges and vocabulary from its first
sentences, and the training loop's counters of the state's size
(``train.word_types``, ``train.slots``, ``train.live_slots``) equal what
the plain trainer's recorded states give on the same corpus."""
import json
import os

import pytest

from portbench.reference import pretok, trainer
from subword_tokenizers_tpu_torch import FastBPE, FastWP
from subword_tokenizers_tpu_torch.benchmarks import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = ("train.word_types", "train.slots", "train.live_slots")


@pytest.fixture(scope="module")
def corpus():
    with open(os.path.join(ROOT, "data", "longtail-160k.json"),
              encoding="utf-8") as f:
        return json.load(f)[:100]


@pytest.mark.parametrize("cls,wordpiece,vocab", [
    (FastWP, True, 600), (FastBPE, False, 600)])
def test_trains_and_counters_equal_the_plain_trainer(corpus, cls, wordpiece,
                                                     vocab):
    counts = pretok.count_words(corpus)
    assert sum(1 for n in counts.values() if n == 1) > len(counts) // 3
    expected = trainer.train(counts, vocab, wordpiece, record_states=True)
    assert len(expected.merges) >= 450
    profiling.reset()
    tok = cls(device="cpu")
    tok.train(list(corpus), vocab)
    got = {name: profiling.counter(name) for name in SIZE}
    profiling.reset()
    if wordpiece:
        assert tok._merge_log == expected.merges
        assert tok.vocab == expected.vocab
    else:
        assert tok.merges_list == expected.merges
    assert got == {
        "train.word_types": len(counts),
        "train.slots": expected.states[0][0],
        "train.live_slots": sum(s[0] for s in expected.states)}


def test_the_skip_route_counts_no_live_slots(corpus, monkeypatch):
    """Deferred compaction's records carry no step's live slots: its
    trains count the corpus's size and leave ``train.live_slots`` out."""
    monkeypatch.setenv("SWT_SKIP_COMPACT", "4")
    counts = pretok.count_words(corpus[:30])
    profiling.reset()
    FastBPE(device="cpu").train(list(corpus[:30]), 150)
    got = {name: profiling.counter(name) for name in SIZE}
    profiling.reset()
    assert got == {"train.word_types": len(counts),
                   "train.slots": sum(len(w) for w in counts),
                   "train.live_slots": 0}
