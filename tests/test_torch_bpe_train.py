"""The port's BPE training (``NaiveBPE(device="cpu")`` / ``FastBPE``, the
kernels' plain PyTorch versions) against the JAX package's trainers on
the same corpora: merges, vocab and ``corpus_as_symbols`` are equal, and
so are the errors. Every comparison is exact."""
import json
import os

import numpy as np
import pytest
import torch

from ref_oracle import REFERENCE_PATH
from subword_tokenizers_tpu import NaiveBPE as JaxNaiveBPE
from subword_tokenizers_tpu.models import bpe as jax_bpe_mod
from subword_tokenizers_tpu_torch import FastBPE, NaiveBPE
from subword_tokenizers_tpu_torch._native import binding
from subword_tokenizers_tpu_torch.models import bpe as bpe_mod

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")


@pytest.fixture(scope="module")
def t85k():
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        return json.load(f)


def _same(port, jax_tok):
    assert port.merges_list == jax_tok.merges_list
    assert port.vocab == jax_tok.vocab
    assert port.corpus_as_symbols == jax_tok.corpus_as_symbols


def _pair(corpus, max_vocab, **kw):
    jax_tok = JaxNaiveBPE()
    jax_tok.train(corpus, max_vocab, **kw)
    port = NaiveBPE(device="cpu")
    port.train(corpus, max_vocab, **kw)
    _same(port, jax_tok)
    return port, jax_tok


@pytest.mark.parametrize("lo,hi,max_vocab", [(0, 500, 300),
                                             (500, 1100, 420)])
def test_train_85k_slices_match_jax(t85k, lo, hi, max_vocab):
    port, _ = _pair(t85k[lo:hi], max_vocab)
    assert len(port.vocab) == max_vocab and len(port.merges_list) > 200


@pytest.mark.parametrize("corpus,max_vocab", [
    (["aaaa aaab baaa abab"], 30),
    (["aaa aab abab banana bandana!", "ab ab ab cd cd c d aaaa"], 40),
    (["ab ba ab ba abab baba aaaa bbbb"] * 3, 25),
])
def test_tie_heavy_corpora_match_jax(corpus, max_vocab):
    port, _ = _pair(corpus, max_vocab)
    assert port.merges_list


def _inject(monkeypatch, words, freqs):
    def fake_unique_words(wb):
        return (list(words), np.asarray(freqs, dtype=np.int64),
                np.zeros(1, dtype=np.int32))
    monkeypatch.setattr(bpe_mod, "train_words",
                        lambda tok, corpus: fake_unique_words(None)[:2])
    monkeypatch.setattr(jax_bpe_mod, "unique_words", fake_unique_words)


WIDE_WORDS = ["abcab", "bca", "cab", "aab", "bb", "abab", "ccc", "ba"]
WIDE_BASE = [31, 17, 13, 11, 7, 5, 3, 2]


@pytest.mark.parametrize("scale", [1, (1 << 28) + 9871, 1 << 42])
def test_wide_frequencies_match_jax(monkeypatch, scale):
    """Injected word frequencies up to a total of about 2**50.3: counts
    past 2**31 and 2**32 stay exact."""
    _inject(monkeypatch, WIDE_WORDS, [b * scale for b in WIDE_BASE])
    port, _ = _pair([""], 40)
    assert len(port.merges_list) >= 10


def test_domain_ceiling_matches_jax(monkeypatch):
    _inject(monkeypatch, ["ab"], [1 << 51])
    errors = []
    for tok in (NaiveBPE(device="cpu"), JaxNaiveBPE()):
        with pytest.raises(ValueError, match="2\\*\\*52") as e:
            tok.train([""], 10)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_small_and_empty_corpora_match_jax():
    _pair(["abc abd"], 3)           # max_vocab below the alphabet
    port, _ = _pair(["abc abd"], 4)  # exactly the alphabet
    assert port.merges_list == []
    for corpus in ([], [""], ["   ", "!"]):
        _pair(corpus, 10)


def test_type_errors_match_jax():
    for args in (("not a list", 10), ([1, 2], 10), ([], "10")):
        msgs = []
        for tok in (NaiveBPE(device="cpu"), JaxNaiveBPE()):
            with pytest.raises(TypeError) as e:
                tok.train(*args)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_golden_prefix_is_the_reference_anchor():
    with open(os.path.join(GOLDEN, "port_t85k_v8000_bpe_merges.json"),
              encoding="utf-8") as f:
        golden = json.load(f)
    with open(os.path.join(GOLDEN, "t85k_v578_merges.json"),
              encoding="utf-8") as f:
        anchor = json.load(f)
    assert len(golden) == 7922 and golden[:len(anchor)] == anchor


def test_whole_85k_reproduces_the_reference_anchor(t85k):
    """The full-width state (all 85,000 sentences, 187,885 slots) on the
    plain versions: the first 500 merges are the reference trainer's."""
    with open(os.path.join(GOLDEN, "t85k_v578_merges.json"),
              encoding="utf-8") as f:
        anchor = [tuple(p) for p in json.load(f)]
    port = NaiveBPE(device="cpu")
    port.train(t85k, 578)
    assert port.merges_list == anchor
    assert len(port.vocab) == 578


def _sub200(t85k, source):
    """The golden tests' 200 sentences of the reference's train-5K, or
    train-85k's first 200."""
    if source == "t85k200":
        return t85k[:200]
    path = os.path.join(REFERENCE_PATH, "data", "train-5K.json")
    if not os.path.exists(path):
        pytest.skip(f"{path}: the reference's corpus is not present")
    with open(path, encoding="utf-8") as f:
        return json.load(f)[:200]


@pytest.mark.parametrize("source", ["sub200", "t85k200"])
def test_fused_front_end_trains_as_before(t85k, monkeypatch, source):
    """FastBPE to 600 with training's fused front end and with the route
    it replaced (unique_words over pretokenize_batch): the same
    merges, and on sub200 the reference's golden."""
    corpus = _sub200(t85k, source)
    fused = FastBPE(device="cpu")
    fused.train(corpus, 600)
    monkeypatch.setattr(binding, "count_words", lambda sents: None)
    old = FastBPE(device="cpu")
    old.train(corpus, 600)
    assert fused.merges_list == old.merges_list
    assert fused.vocab == old.vocab
    if source == "sub200":
        with open(os.path.join(GOLDEN, "sub200_v600_merges.json"),
                  encoding="utf-8") as f:
            assert fused.merges_list == [tuple(p) for p in json.load(f)]


def test_device_argument():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls in (NaiveBPE, FastBPE):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(device="cuda")
        with pytest.raises(ValueError):
            cls(device="meta")
