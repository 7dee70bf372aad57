"""Training's front end (``_native/count_words.cpp`` through
``binding.count_words`` and ``core/corpus.train_words``) against the route
encode keeps, ``unique_words(pretokenize_batch(...))``, and against the
plain reference's counts (``portbench/reference/pretok.py``): the same
word types in the same first-occurrence order, with the same counts, on
every thread count; U+0130 and U+03A3 and an injected tokenizer take the
old route, and the counters say which route each train took."""
import json
import os
import random

import numpy as np
import pytest

from portbench.reference import pretok
from ref_oracle import REFERENCE_PATH
from subword_tokenizers_tpu_torch import FastBPE, FastWP, NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch._native import binding
from subword_tokenizers_tpu_torch.benchmarks import profiling
from subword_tokenizers_tpu_torch.core.corpus import (train_words,
                                                      unique_words)
from subword_tokenizers_tpu_torch.frontend.pretokenize import \
    pretokenize_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_DATA = os.path.join(REFERENCE_PATH, "data")
THREADS = (1, 2, 3, 7)

# Latin-2 letters, both cases
LATIN2 = "ąćęłńóśźżĄĆĘŁŃÓŚŹŻáäčďéěíľĺňôŕšťúůýžÁÄČĎÉĚÍĽĹŇÔŔŠŤÚŮÝŽ"
# non-BMP: Deseret capitals (lowered by the table), emoji, Gothic, math
NON_BMP = "\U00010400\U00010401\U00010428\U0001F600\U00010348\U0001D518"
# punctuation of every class the split isolates: ASCII punctuation of
# categories S* as well as P*, and Pc, Pd, Ps, Pe, Pi, Pf, Po beyond ASCII
PUNCT = ("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
         "\u203f\u2014\u2010\u300c\uff09\u00ab\u00bb\u2018\u2019"
         "\u00bf\u3001\u00a7\u2026")
# White_Space, and separators Python calls space (or zero-width) that are
# not White_Space
WHITE = (" \t\n\r\x0b\x0c\x85\xa0\u1680\u2000\u2003\u200a\u2028"
         "\u2029\u202f\u205f\u3000")
NOT_WHITE = "\x1c\x1d\x1e\x1f\u200b"


def _mixed(seed: int):
    """Seeded sentences of every kind above, with runs of repeated words
    long enough that partition boundaries fall inside them."""
    rng = random.Random(seed)
    letters = "abcdefghijklmnopqrstuvwxyzABCXYZ" + LATIN2 + NON_BMP
    vocab = ["".join(rng.choice(letters + NOT_WHITE)
                     for _ in range(rng.randint(1, 9))) for _ in range(60)]
    out = []
    for _ in range(400):
        kind = rng.random()
        if kind < 0.05:
            out.append("")
        elif kind < 0.1:
            out.append("".join(rng.choice(WHITE) for _ in range(5)))
        elif kind < 0.3:
            word = rng.choice(vocab)
            out.append(" ".join([word] * rng.randint(20, 120)))
        else:
            parts = []
            for _ in range(rng.randint(1, 30)):
                r = rng.random()
                if r < 0.6:
                    parts.append(rng.choice(vocab))
                elif r < 0.85:
                    parts.append(rng.choice(PUNCT) * rng.randint(1, 3))
                else:
                    parts.append(rng.choice(WHITE) * rng.randint(1, 4))
                parts.append(rng.choice(WHITE) if rng.random() < 0.7
                             else "")
            out.append("".join(parts))
    return out


def _reference(name):
    path = os.path.join(REFERENCE_DATA, name)
    if not os.path.exists(path):
        pytest.skip(f"{path}: the reference's corpus is not present")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _corpus(case):
    if case == "t85k_5000":
        with open(os.path.join(ROOT, "data", "train-85k.json"),
                  encoding="utf-8") as f:
            return json.load(f)[:5000]
    if case == "sub200":  # as tests/test_train_golden.py trains on it
        return _reference("train-5K.json")[:200]
    if case == "pt989":
        return _reference("pan_tadeusz.json")
    if case == "empty_list":
        return []
    if case == "repeats":  # every partition boundary inside a run
        return ["ala ma", "ala", "ma kota"] * 50
    if case == "blank":
        return ["", "   ", "\t\n", "\u3000\xa0", ""]
    return _mixed(int(case.rsplit("_", 1)[1]))


CASES = ("t85k_5000", "sub200", "pt989", "mixed_0", "mixed_1", "mixed_2",
         "repeats", "blank", "empty_list")


@pytest.fixture(scope="module")
def corpora():
    return {}


def _get(corpora, case):
    if case not in corpora:
        corpora[case] = _corpus(case)
    return corpora[case]


@pytest.fixture
def clean():
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", CASES)
def test_count_words_equals_unique_words(corpora, case, threads):
    corpus = _get(corpora, case)
    words, freq = binding.count_words(corpus, _threads=threads)
    want_words, want_freq, _ = unique_words(pretokenize_batch(corpus))
    assert words == want_words
    assert freq.dtype == np.int64
    assert freq.tolist() == want_freq.tolist()


@pytest.mark.parametrize("case", CASES)
def test_count_words_equals_the_plain_reference(corpora, case):
    corpus = _get(corpora, case)
    words, freq = binding.count_words(corpus)
    want = pretok.count_words(corpus)
    assert words == list(want)
    assert freq.tolist() == list(want.values())


@pytest.mark.parametrize("cls", [NaiveBPE, FastWP])
@pytest.mark.parametrize("case", CASES)
def test_train_words_takes_the_fused_pass(corpora, clean, case, cls):
    corpus = _get(corpora, case)
    words, freq = train_words(cls(device="cpu"), corpus)
    want_words, want_freq, _ = unique_words(pretokenize_batch(corpus))
    assert words == want_words and freq.tolist() == want_freq.tolist()
    assert profiling.counter("train.frontend.fused") == 1
    assert profiling.counter("train.frontend.fallback") == 0


SPECIAL = [["İstanbul, İzmir i ISTANBUL.", "tak"],
           ["ΟΔΥΣΣΕΥΣ σοφός, ΣΑΣ Σ.", "Σ"],
           ["abc abd"] * 40 + ["x İ y"]]


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("corpus", SPECIAL)
def test_a_special_codepoint_stops_the_fused_pass(corpus, threads):
    assert binding.count_words(corpus, _threads=threads) is None


@pytest.mark.parametrize("cls", [NaiveBPE, FastWP])
@pytest.mark.parametrize("corpus", SPECIAL)
def test_a_special_codepoint_falls_back_to_the_old_route(clean, corpus,
                                                         cls):
    words, freq = train_words(cls(device="cpu"), corpus)
    want_words, want_freq, _ = unique_words(pretokenize_batch(corpus))
    assert words == want_words and freq.tolist() == want_freq.tolist()
    want = pretok.count_words(corpus)
    assert words == list(want) and freq.tolist() == list(want.values())
    assert profiling.counter("train.frontend.fallback") == 1
    assert profiling.counter("train.frontend.fused") == 0


@pytest.mark.parametrize("bad", [["a", 3], ["a", None], [b"a"], ("a",)])
def test_a_non_str_element_raises(bad):
    with pytest.raises(TypeError):
        binding.count_words(bad)


class _SpaceSplitter:
    """An HF-style tokenizer whose pre-tokenizer splits on spaces."""

    class backend_tokenizer:
        class pre_tokenizer:
            @staticmethod
            def pre_tokenize_str(text):
                out, pos = [], 0
                for w in text.split(" "):
                    if w:
                        out.append((w, (pos, pos + len(w))))
                    pos += len(w) + 1
                return out


@pytest.mark.parametrize("cls", [NaiveBPE, FastWP])
def test_an_injected_tokenizer_never_reaches_the_fused_pass(
        monkeypatch, clean, cls):
    def refuse(*args, **kwargs):
        raise AssertionError("the fused pass ran")

    monkeypatch.setattr(binding, "count_words", refuse)
    corpus = ["Ala, ma kota.", "ala ma  psa,kota"]
    words, freq = train_words(cls(tokenizer=_SpaceSplitter(), device="cpu"),
                              corpus)
    assert words == ["ala,", "ma", "kota.", "ala", "psa,kota"]
    assert freq.tolist() == [1, 2, 1, 1, 1]
    assert profiling.counter("train.frontend.fallback") == 1
    assert profiling.counter("train.frontend.fused") == 0


ROUTES = {"fused": ["Ala ma kota, a kot ma Alę.", "kot i pies"] * 3,
          "special": ["Ala ma kota, a kot ma Alę.", "İzmir i kot"] * 3,
          "injected": ["Ala ma kota, a kot ma Alę.", "kot i pies"] * 3}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("cls", [NaiveBPE, FastBPE, NaiveWP, FastWP])
def test_each_train_counts_its_route_once(clean, cls, route):
    kw = {"tokenizer": _SpaceSplitter()} if route == "injected" else {}
    tok = cls(device="cpu", **kw)
    tok.train(ROUTES[route], 40)
    tok.train(ROUTES[route], 40)
    fused = 2 if route == "fused" else 0
    assert profiling.counter("train.frontend.fused") == fused
    assert profiling.counter("train.frontend.fallback") == 2 - fused
