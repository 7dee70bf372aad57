"""GPT-1-style BPE in the port: NaiveBPE and FastBPE with an end-of-word
suffix (``end_of_word_suffix``, GPT-1's ``"</w>"``), on the kernels'
CPU versions, against the plain reference ``portbench/reference/eow.py``:
the merges and the vocabulary on every training route, the encoders, a
save and load, the suffix's checks, the hash tables' reach past the
longest symbol, and the profiler's two counters of the suffix."""
import json
import os
import random

import pytest

from portbench.reference import eow, pretok, trainer
from subword_tokenizers_tpu_torch import FastBPE, FastWP, NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.benchmarks import profiling
from subword_tokenizers_tpu_torch.core.corpus import build_bpe_corpus
from subword_tokenizers_tpu_torch.core.symbols import SymbolTable
from subword_tokenizers_tpu_torch.ops import train_loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUFFIX = "</w>"
EOW = ("train.eow.symbols", "train.eow.merges")


@pytest.fixture(scope="module")
def longtail():
    with open(os.path.join(ROOT, "data", "longtail-160k.json"),
              encoding="utf-8") as f:
        return json.load(f)[:2000]


def drawn(longtail, seed, n=90):
    """``n`` sentences drawn with replacement from the long tail's first
    ones by ``seed``."""
    rng = random.Random(seed)
    return [longtail[rng.randrange(len(longtail))] for _ in range(n)]


def random_words(seed, n=70):
    """Sentences of random words over a small alphabet, with
    punctuation between them."""
    rng = random.Random(seed)
    letters = "abcdeéfghło"
    out = []
    for _ in range(n):
        words = ["".join(rng.choice(letters)
                         for _ in range(rng.randint(1, 9)))
                 for _ in range(rng.randint(1, 8))]
        out.append(rng.choice([" ", ", ", " - "]).join(words)
                   + rng.choice(["", ".", "!"]))
    return out


def corpus_of(kind, longtail, seed):
    return drawn(longtail, seed) if kind == "longtail" \
        else random_words(seed)


def trained(cls, sentences, vocab, suffix=SUFFIX, **kw):
    tok = cls(device="cpu", end_of_word_suffix=suffix)
    tok.train(list(sentences), vocab, **kw)
    return tok


def check_learned(tok, expected, suffix=SUFFIX):
    """The reference's merges and vocabulary, and every word's symbols
    spelling the word with the suffix on its end."""
    assert tok.merges_list == expected.merges
    assert tok.vocab == expected.vocab
    for symbols, _ in tok.corpus_as_symbols:
        assert symbols[-1].endswith(suffix)
        assert not any(s.endswith(suffix) for s in symbols[:-1])


@pytest.mark.parametrize("route",
                         ["flat", "per_step", "skip", "resume", "mesh"])
@pytest.mark.parametrize("kind,seed", [("longtail", 2 ** 31 + 11),
                                       ("random", 2 ** 31 + 12)])
def test_fastbpe_learns_the_reference_on_every_route(
        kind, seed, route, longtail, monkeypatch, tmp_path):
    sentences = corpus_of(kind, longtail, seed)
    expected = eow.train_sentences(sentences, 600, SUFFIX)
    assert len(expected.merges) >= 400
    if route == "skip":
        monkeypatch.setenv("SWT_SKIP_COMPACT", "4")
    if route == "per_step":
        tok = FastBPE(device="cpu", end_of_word_suffix=SUFFIX)
        tok._force_per_step = True
        tok.train(list(sentences), 600)
    elif route == "resume":
        writer = FastBPE(device="cpu", end_of_word_suffix=SUFFIX)
        writer.train(list(sentences), 300, checkpoint_dir=str(tmp_path),
                     checkpoint_every=50)
        tok = trained(FastBPE, sentences, 600,
                      checkpoint_dir=str(tmp_path), resume=True)
    elif route == "mesh":
        from subword_tokenizers_tpu_torch.parallel.mesh import \
            make_data_mesh
        tok = FastBPE(mesh=make_data_mesh(2, devices=["cpu"] * 2),
                      device="cpu", end_of_word_suffix=SUFFIX)
        tok.train(list(sentences), 600)
    else:
        tok = trained(FastBPE, sentences, 600)
    check_learned(tok, expected)


@pytest.mark.parametrize("kind,seed", [("longtail", 2 ** 31 + 21),
                                       ("random", 2 ** 31 + 22)])
def test_naivebpe_learns_the_reference(kind, seed, longtail):
    sentences = corpus_of(kind, longtail, seed)
    check_learned(trained(NaiveBPE, sentences, 650),
                  eow.train_sentences(sentences, 650, SUFFIX))


def long_word_corpus():
    """Words that share their tails, the longest of them merged whole."""
    rng = random.Random(5)
    base = "abcdefghijkl"
    words = [base, base[1:], base[2:], "x" + base[3:], base[:6],
             "zz" + base[4:]]
    return [" ".join(rng.choice(words) for _ in range(8))
            for _ in range(200)]


def test_a_long_suffix_stays_inside_the_hash_tables(monkeypatch):
    """A 7-character suffix on a corpus whose longest word is merged
    whole: the device interns every symbol with its string's hashes,
    which it can only where the powers reach past the longest symbol
    (the longest word and the suffix)."""
    suffix = "<<eow>>"
    sentences = long_word_corpus()
    seen = {}
    close = train_loop.BlockRunner.close

    def spy(run):
        n = int(run.ctrl[0])
        seen["hashes"] = set(zip(run.h1[:n].tolist(), run.h2[:n].tolist()))
        seen["powers"] = run.pw1.shape[0]
        return close(run)

    monkeypatch.setattr(train_loop.BlockRunner, "close", spy)
    tok = trained(FastBPE, sentences, 400, suffix=suffix)
    check_learned(tok, eow.train_sentences(sentences, 400, suffix), suffix)
    longest = "abcdefghijkl" + suffix
    assert longest in tok.vocab
    assert seen["powers"] > len(longest)
    assert all(train_loop.str_hashes(s) in seen["hashes"]
               for s in tok.vocab)


@pytest.mark.parametrize("suffix", ["</w>", "<<eow>>", "@", ".x"])
def test_the_powers_reach_the_longest_symbol(suffix):
    words = ["ab", "abcdefghij", "q"]
    table = SymbolTable()
    arrays = build_bpe_corpus(words, [1, 2, 3], table, suffix)
    max_len = arrays.sym.shape[1]
    pw1, pw2, *_ = train_loop.init_tables(table, 100, max_len, "cpu")[4:]
    assert pw1.shape[0] > max_len + len(suffix)
    assert pw2.shape[0] == pw1.shape[0]
    plain = train_loop.init_tables(SymbolTable(), 100, max_len, "cpu")
    assert plain[4].shape[0] == max_len + 5


@pytest.mark.parametrize("suffix,error", [("ab", ValueError),
                                          ("", ValueError),
                                          ("w", ValueError),
                                          (5, TypeError)])
def test_a_suffix_without_punctuation_is_refused(suffix, error):
    for cls in (NaiveBPE, FastBPE):
        with pytest.raises(error):
            cls(device="cpu", end_of_word_suffix=suffix)


def test_wordpiece_takes_no_suffix():
    for cls in (NaiveWP, FastWP):
        with pytest.raises(TypeError):
            cls(device="cpu", end_of_word_suffix=SUFFIX)


def encode_sentences(sentences):
    """Training sentences and some with characters no merge knows, a
    one-character word and words ending in them."""
    return sentences[:40] + ["żółw ą x q", "ξαβ abcξ, a ξ!", "", "a"]


@pytest.mark.parametrize("kind,seed", [("longtail", 2 ** 31 + 31),
                                       ("random", 2 ** 31 + 32)])
def test_encoders_equal_the_reference(kind, seed, longtail):
    """``tokenize_batch`` (kernel 5's CPU version) equals ``tokenize``;
    FastBPE's equals GPT-1's encoder, the symbols as they are."""
    sentences = corpus_of(kind, longtail, seed)
    texts = encode_sentences(sentences)
    for cls in (FastBPE, NaiveBPE):
        tok = trained(cls, sentences, 500)
        batch = tok.tokenize_batch(texts)
        assert batch == [tok.tokenize(t) for t in texts]
        assert not any(t.startswith("##") for s in batch for t in s)
        if cls is FastBPE:
            assert batch == eow.encode(texts, tok.merges_list, SUFFIX)
            for w in ("ab", "x", "abcξ"):
                assert tok.encode_word(w) == eow.encode_word(
                    w, eow.ranks_of(tok.merges_list), SUFFIX)


def test_a_saved_vocabulary_encodes_alike(longtail, tmp_path):
    sentences = drawn(longtail, 2 ** 31 + 41)
    texts = encode_sentences(sentences)
    for cls in (FastBPE, NaiveBPE):
        tok = trained(cls, sentences, 500)
        tok.save_resources(str(tmp_path / cls.__name__))
        back = cls(device="cpu", end_of_word_suffix=SUFFIX)
        back.load_resources(str(tmp_path / cls.__name__), strict=True)
        assert back.merges_list == tok.merges_list
        assert back.tokenize_batch(texts) == tok.tokenize_batch(texts)
        assert [back.tokenize(t) for t in texts] == \
            [tok.tokenize(t) for t in texts]


def test_no_suffix_is_the_upstreams_bpe(longtail):
    """``None`` and no keyword train and encode alike, the plain
    trainer's merges, the words rendered with ``"##"``."""
    sentences = drawn(longtail, 2 ** 31 + 51)
    texts = encode_sentences(sentences)
    expected = trainer.train(pretok.count_words(sentences), 500, False)
    got = []
    for tok in (FastBPE(device="cpu"),
                FastBPE(device="cpu", end_of_word_suffix=None)):
        profiling.reset()
        tok.train(list(sentences), 500)
        assert [profiling.counter(n) for n in EOW] == [0, 0]
        assert tok.merges_list == expected.merges
        assert tok.vocab == expected.vocab
        got.append((tok.merges_list, tok.vocab, tok.corpus_as_symbols,
                    tok.tokenize_batch(texts)))
    profiling.reset()
    assert got[0] == got[1]
    assert any(t.startswith("##") for s in got[0][3] for t in s)


@pytest.mark.parametrize("kind,seed", [("longtail", 2 ** 31 + 61),
                                       ("random", 2 ** 31 + 62)])
def test_the_suffix_counters_equal_the_reference(kind, seed, longtail):
    """``train.eow.symbols``: the initial symbols with the suffix (one
    per distinct last character); ``train.eow.merges``: the merges whose
    right symbol carries it."""
    sentences = corpus_of(kind, longtail, seed)
    counts = pretok.count_words(sentences)
    expected = eow.train(counts, 600, SUFFIX)
    profiling.reset()
    tok = trained(FastBPE, sentences, 600)
    got = [profiling.counter(n) for n in EOW]
    profiling.reset()
    assert tok.merges_list == expected.merges
    assert got == [
        len({w[-1] for w in counts}),
        sum(1 for _, b in expected.merges if b.endswith(SUFFIX))]
    assert 0 < got[1] < len(expected.merges)
