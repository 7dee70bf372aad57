"""A run's ``correct`` with the timed path broken underneath.

Each test skips the harness's look for a card and drives the rest of a
run on the port's plain versions (``device="cpu"``) at a small size: a
sound run comes out correct; a merge step that leaves its state
unchanged, half of the corpus left out, and a merge altered where the
loop produces it each come out not correct; so does the control, the
plain trainer in the lower precision or with the broken tie-break put in
the program's place. (One card: no exchange between chips to leave
out.)"""
import time

import pytest

from portbench import harness
from portbench.tasks import train as train_task

CELLS = ("bpe-v20000.t85k", "wp-v20000.t85k")


def small(name, vocab=300, sentences=1000):
    bench, entry, cell, config, mix = harness.cell_files(name)
    return (bench, entry, cell, dict(config, max_vocab=vocab),
            dict(mix, sentences=sentences))


def run(name, **kw):
    files = small(name, **kw)
    return harness.run(name, 2 ** 31 + 99, 0.01, False, time.perf_counter(),
                       device="cpu", files=files, check_chip=False)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run(name)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["checks"] == {"calls_wrong": {
        "value": 0, "limit": 0, "of": res["attempted"]}}
    assert set(res["metrics"]) == {"vocab_s", "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_a_step_that_leaves_its_state_unchanged(name, monkeypatch):
    from subword_tokenizers_tpu_torch.ops import train_loop
    merge = train_loop.FlatState.merge

    def stuck(self, rec, skip=0):
        self.steps_seen = getattr(self, "steps_seen", 0) + 1
        if self.steps_seen != 40:  # each train's 40th step merges nothing
            merge(self, rec, skip)
    monkeypatch.setattr(train_loop.FlatState, "merge", stuck)
    res = run(name)
    assert not res["correct"] and res["failed"] == res["attempted"]


@pytest.mark.parametrize("name", CELLS)
def test_half_the_corpus_left_out(name, monkeypatch):
    """The trainers' word types counted over half of the corpus (both
    trainers call ``train_words`` by the name their module imports)."""
    from subword_tokenizers_tpu_torch.models import bpe, wordpiece
    for mod in (bpe, wordpiece):
        def half(tok, corpus, words=mod.train_words):
            return words(tok, corpus[: len(corpus) // 2])
        monkeypatch.setattr(mod, "train_words", half)
    res = run(name)
    assert not res["correct"] and res["failed"] == res["attempted"]


@pytest.mark.parametrize("name", CELLS)
def test_a_merge_altered_where_it_is_produced(name, monkeypatch):
    from subword_tokenizers_tpu_torch.ops import train_loop
    run_fused = train_loop.run_fused

    def altered(state, table, max_vocab, max_len, on_merge, *a, **kw):
        seen = [0]

        def report(sa, sb, merged):
            seen[0] += 1
            if seen[0] == 25:
                sa, sb = sb, sa
            on_merge(sa, sb, merged)
        return run_fused(state, table, max_vocab, max_len, report, *a, **kw)
    monkeypatch.setattr(train_loop, "run_fused", altered)
    res = run(name)
    assert not res["correct"] and res["failed"] == res["attempted"]


@pytest.mark.parametrize("name,variant,sentences,vocab", [
    ("bpe-v20000.t85k", "pair_order", 1000, 300),
    # at 1,000 sentences float32 scores pick the same merges: the first
    # size at which they differ on this seed is far larger
    ("wp-v20000.t85k", "float32", 85000, 3000)])
def test_the_control_is_not_correct(name, variant, sentences, vocab,
                                    monkeypatch):
    """The plain trainer in the control's form, in the program's place
    (as ``portbench/control.py`` puts it there)."""
    assert train_task.VARIANT[name.startswith("wp")] == variant
    init = train_task.Task.__init__

    def controlled(self, *a, **kw):
        init(self, *a, **kw)
        train_task.control(self)
    monkeypatch.setattr(train_task.Task, "__init__", controlled)
    res = run(name, vocab=vocab, sentences=sentences)
    assert not res["correct"] and res["failed"] == res["attempted"]
