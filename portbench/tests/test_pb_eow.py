"""GPT-1's BPE cell ``bpe-eow-v40478.zipf200k``: the plain reference
``reference/eow.py`` against a naive upstream-style loop, its encoder,
the control of the cell's comparison, the cell's files and metrics as
the harness reads them, and a sound run of it on the CPU at a small
size."""
import random
import time
from collections import Counter

import pytest

from conftest import need_card
from portbench import corpus, harness
from portbench.reference import eow, pretok, trainer

CELL = "bpe-eow-v40478.zipf200k"


def naive(counts, max_vocab, suffix):
    """The upstream's loop with the suffix split: every merge a full
    rescan of every word's pairs and ``Counter.most_common(1)``.
    Returns (merges, vocabulary, each word's final symbols)."""
    words = [(eow.initial_symbols(w, suffix), f) for w, f in counts.items()]
    vocab = {s for symbols, _ in words for s in symbols}
    merges = []
    while len(vocab) < max_vocab:
        pairs = Counter()
        for symbols, f in words:
            for p in zip(symbols, symbols[1:]):
                pairs[p] += f
        if not pairs:
            break
        (a, b), _ = pairs.most_common(1)[0]
        merges.append((a, b))
        vocab.add(a + b)
        merged = []
        for symbols, f in words:
            out, i = [], 0
            while i < len(symbols):
                if i + 1 < len(symbols) and (symbols[i], symbols[i + 1]) \
                        == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(symbols[i])
                    i += 1
            merged.append((out, f))
        words = merged
    return merges, vocab, {w: s for w, (s, _) in zip(counts, words)}


def tiny_counts(seed):
    """Word counts of a few dozen random words over a small alphabet,
    with one-character words and repeated endings."""
    rng = random.Random(seed)
    counts = {}
    for _ in range(rng.randint(20, 60)):
        w = "".join(rng.choice("abcdeś") for _ in range(rng.randint(1, 7)))
        counts[w] = counts.get(w, 0) + rng.randint(1, 9)
    return counts


@pytest.mark.parametrize("seed", range(2 ** 31 + 1, 2 ** 31 + 13))
@pytest.mark.parametrize("suffix", ["</w>", "<<eow>>"])
def test_the_reference_equals_the_naive_loop(seed, suffix):
    counts = tiny_counts(seed)
    max_vocab = 10 + seed % 90
    merges, vocab, final = naive(counts, max_vocab, suffix)
    got = eow.train(counts, max_vocab, suffix, record_states=True)
    assert got.merges == merges
    assert got.vocab == vocab
    assert len(got.states) == len(merges)
    ranks = eow.ranks_of(got.merges)
    for w, symbols in final.items():
        assert eow.encode_word(w, ranks, suffix) == symbols


def test_the_reference_refuses_a_suffix_without_punctuation():
    for suffix in ("ab", "", "w"):
        with pytest.raises(ValueError):
            eow.train({"ab": 1}, 10, suffix)


def test_the_encoder_is_gpt1s():
    """Lowest rank first, every occurrence, the suffix kept; a pair
    listed twice keeps its later rank."""
    merges = [("l", "o"), ("o", "w</w>"), ("lo", "w</w>"), ("e", "r</w>")]
    ranks = eow.ranks_of(merges)
    assert eow.encode_word("low", ranks, "</w>") == ["low</w>"]
    assert eow.encode_word("lower", ranks, "</w>") == [
        "lo", "w", "er</w>"]
    assert eow.encode_word("owe", ranks, "</w>") == ["o", "w", "e</w>"]
    assert eow.encode_word("a", ranks, "</w>") == ["a</w>"]
    assert eow.ranks_of([("a", "b"), ("c", "d"), ("a", "b")])[("a", "b")] \
        == 2
    assert eow.encode(["Low, lower"], merges, "</w>") == [
        ["low</w>", ",</w>", "lo", "w", "er</w>"]]


def small_files(sentences=200, max_vocab=400):
    bench, entry, cell, config, mix = harness.cell_files(CELL)
    return (bench, entry, cell, dict(config, max_vocab=max_vocab),
            dict(mix, sentences=sentences))


def test_the_control_is_caught():
    """The cell's task turned into its control (ties by symbol ids)
    gives other merges than the reference on a small draw of the mix;
    the task itself gives the same."""
    files = small_files()
    mod = harness.task_module(files[3])
    data = corpus.draw(files[4], 2 ** 31 + 77)
    task = mod.Task(files[3], data, files[4], "cpu")
    expected = task.reference()
    assert task.wrong([task.once()], expected) == 0
    mod.control(task)
    assert task.wrong([task.once()], expected) == 1


def test_the_cell_reads_what_the_cells_beside_it_read():
    """Every cell of ``BENCHMARK.json`` trains, and this cell reports
    the same metrics as each of them."""
    bench = harness.cell_files(CELL)[0]
    for trace in (False, True):
        mine = [m["name"] for m in harness.cell_metrics(bench, CELL, trace)]
        for w in bench["workloads"]:
            assert [m["name"] for m in harness.cell_metrics(
                bench, w["name"], trace)] == mine
    assert "vocab_s" in [m["name"] for m in
                         harness.cell_metrics(bench, CELL, False)]


def test_the_cells_files():
    bench, entry, cell, config, mix = harness.cell_files(CELL)
    assert (config["task"], config["tokenizer"], config["max_vocab"],
            config["end_of_word_suffix"]) == ("train_eow", "FastBPE",
                                              40478, "</w>")
    assert config["reduced"] == ["corpus_sentences"]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    assert conf["reduced"] == config["reduced"]
    assert config["corpus_sentences"] == mix["sentences"] == 160_000
    assert (cell["traffic"], cell["chips"]) == ("zipf200k", 1)


def test_a_small_traced_run_is_correct():
    """The cell's traced run on the port's plain versions at a small
    size: correct, its program spans read."""
    res = harness.run(CELL, 2 ** 31 + 25, 0.01, True, time.perf_counter(),
                      device="cpu", files=small_files(100, 300),
                      check_chip=False)
    assert res["correct"] and res["attempted"] == 2
    assert "tail_ms" in res["metrics"] and "corpus_ms" in res["metrics"]


@pytest.fixture(scope="module")
def longtail_counts():
    """Word counts of 3,000 sentences drawn from the long tail."""
    mix = harness.cell_files(CELL)[4]
    data = corpus.draw(dict(mix, sentences=3000), 2 ** 31 + 91)
    return pretok.count_drawn(data.source, data.draw)


@pytest.mark.parametrize("variant", [None, "pair_order"])
def test_the_reference_walks_the_plain_trainers_states(longtail_counts,
                                                        variant):
    """``trainer.train`` on the same words, each word's last character
    renamed to a private code point of its own (one-to-one, since the
    suffix holds punctuation), learns the reference's merges and
    vocabulary and walks its states, renamed back."""
    suffix = "</w>"
    private = {}
    renamed = {}
    for w, f in longtail_counts.items():
        last = private.setdefault(w[-1], chr(0xF0000 + len(private)))
        renamed[w[:-1] + last] = f
    back = {v: k + suffix for k, v in private.items()}

    def name(s):
        return s[:-1] + back[s[-1]] if s[-1] in back else s

    plain = trainer.train(renamed, 2500, False, variant=variant,
                          record_states=True)
    got = eow.train(longtail_counts, 2500, suffix, variant=variant,
                    record_states=True)
    assert len(got.merges) > 2000
    assert got.merges == [(name(a), name(b)) for a, b in plain.merges]
    assert got.vocab == {name(s) for s in plain.vocab}
    assert got.states == plain.states and got.n_final == plain.n_final


@pytest.mark.chip
def test_the_cell_on_the_card():
    """A traced run of the cell on the card at its own size: correct,
    with the kernels' metrics read."""
    need_card()
    res = harness.run(CELL, 3929000099, 1.0, True, time.perf_counter())
    assert res["correct"]
    assert res["metrics"]["kernel_ps_per_slot"]["value"] > 0
    assert res["metrics"]["launches_per_merge"]["value"] > 3
