"""The port's WordPiece training (``NaiveWP(device="cpu")`` / ``FastWP``,
the kernels' plain PyTorch versions) against the JAX package's trainers
on the same corpora: the vocab, the merge log and ``corpus_as_symbols``
are equal, and so are the errors, the checkpoints (either package
resumes the other's) and FastWP's encode of the trained vocab. Every
comparison is exact."""
import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

from ref_oracle import REFERENCE_PATH
from subword_tokenizers_tpu import FastWP as JaxFastWP
from subword_tokenizers_tpu import NaiveWP as JaxNaiveWP
from subword_tokenizers_tpu.models import wordpiece as jax_wp_mod
from subword_tokenizers_tpu_torch import FastWP, NaiveWP, utils
from subword_tokenizers_tpu_torch._native import binding
from subword_tokenizers_tpu_torch.models import wordpiece as wp_mod
from subword_tokenizers_tpu_torch.ops import train_loop

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")

CORPUS = [
    "Litwo! Ojczyzno moja! ty jesteś jak zdrowie.",
    "Ile cię trzeba cenić, ten tylko się dowie,",
    "aaa aab abab banana bandana!",
]


@pytest.fixture(scope="module")
def t85k():
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_full():
    tok = JaxNaiveWP()
    tok.train(CORPUS, 120)
    return tok


def _same(port, jax_tok):
    assert port._merge_log == jax_tok._merge_log
    assert port.vocab == jax_tok.vocab
    assert port.corpus_as_symbols == jax_tok.corpus_as_symbols


def _pair(corpus, max_vocab, **kw):
    jax_tok = JaxNaiveWP()
    jax_tok.train(corpus, max_vocab, **kw)
    port = NaiveWP(device="cpu")
    port.train(corpus, max_vocab, **kw)
    _same(port, jax_tok)
    return port, jax_tok


@pytest.mark.parametrize("lo,hi,max_vocab", [(0, 500, 300),
                                             (500, 1100, 420)])
def test_train_85k_slices_match_jax(t85k, lo, hi, max_vocab):
    port, _ = _pair(t85k[lo:hi], max_vocab)
    assert len(port.vocab) == max_vocab and len(port._merge_log) > 150


@pytest.mark.parametrize("corpus", [
    ["aaaaaaaaaaaaaaaaaaaaaa", "abababab ababab",
     "aaa aab aba abb baa bab bba bbb", "xy" * 11],
    # every pair count 1 and unit weights: exact score ties everywhere
    ["zy xw vu ts rq po nm lk ji hg fe dc ba"],
])
def test_pathological_corpora_match_jax(corpus):
    port, _ = _pair(corpus, 40)
    assert port._merge_log


def _fuzz_corpus(trial):
    """The fuzz corpora of the JAX package's tournament tests (seed 7,
    trials 0-5)."""
    rng = np.random.default_rng(7)
    letters = "abcdefgh"
    for t in range(trial + 1):
        corpus = [" ".join(
            "".join(rng.choice(list(letters), size=rng.integers(1, 9)))
            for _ in range(rng.integers(3, 30)))
            for _ in range(rng.integers(2, 10))]
    return corpus


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_corpora_match_jax(trial):
    _pair(_fuzz_corpus(trial), 64)


def _inject(monkeypatch, words, freqs):
    def fake_unique_words(wb):
        return (list(words), np.asarray(freqs, dtype=np.int64),
                np.zeros(1, dtype=np.int32))
    monkeypatch.setattr(wp_mod, "train_words",
                        lambda tok, corpus: fake_unique_words(None)[:2])
    monkeypatch.setattr(jax_wp_mod, "unique_words", fake_unique_words)


WIDE_WORDS = ["abcab", "bca", "cab", "aab", "bb", "abab", "ccc", "ba"]
WIDE_BASE = [31, 17, 13, 11, 7, 5, 3, 2]


@pytest.mark.parametrize("scale", [1, (1 << 28) + 9871, 1 << 42])
def test_injected_frequencies_match_jax(monkeypatch, scale):
    """Word frequencies scaled up to a total of about 2**50.3: from 2**26
    symbol occurrences on, fa * fb passes 2**53 and the scores take the
    wide division."""
    _inject(monkeypatch, WIDE_WORDS, [b * scale for b in WIDE_BASE])
    port, _ = _pair([""], 40)
    assert len(port._merge_log) >= 10


def test_domain_ceiling_matches_jax(monkeypatch):
    _inject(monkeypatch, ["ab"], [1 << 51])
    errors = []
    for tok in (NaiveWP(device="cpu"), JaxNaiveWP()):
        with pytest.raises(ValueError, match="2\\*\\*52") as e:
            tok.train([""], 10)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert wp_mod.MAX_TOKENS_WP == jax_wp_mod.MAX_TOKENS_WP


def test_small_and_empty_corpora_match_jax():
    _pair(["abc abd"], 3)  # max_vocab below the alphabet
    for corpus in ([], [""], ["   ", "!"]):
        port, _ = _pair(corpus, 10)
    assert not port._merge_log


def test_type_errors_match_jax():
    for args in (("not a list", 10), ([1, 2], 10), ([], "10")):
        msgs = []
        for tok in (NaiveWP(device="cpu"), JaxNaiveWP()):
            with pytest.raises(TypeError) as e:
                tok.train(*args)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("first", ["port", "jax"])
def test_checkpoint_resumes_across_packages(tmp_path, jax_full, first):
    """A checkpoint written by one package is resumed by the other, and
    the result equals the uninterrupted run; both packages write the same
    bytes at the same point."""
    classes = {"port": lambda: NaiveWP(device="cpu"), "jax": JaxNaiveWP}
    second = "jax" if first == "port" else "port"
    part = classes[first]()
    part.train(CORPUS, 80, checkpoint_dir=str(tmp_path / "a"),
               checkpoint_every=10)
    other = classes[second]()
    other.train(CORPUS, 80, checkpoint_dir=str(tmp_path / "b"),
                checkpoint_every=10)
    for name in ("wp_state.json", "vocab.json"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes(), name
    resumed = classes[second]()
    resumed.train(CORPUS, 120, checkpoint_dir=str(tmp_path / "a"),
                  resume=True)
    _same(resumed, jax_full)
    with open(tmp_path / "a" / "wp_state.json", encoding="utf-8") as f:
        state = json.load(f)
    assert [tuple(p) for p in state["merges"]] == jax_full._merge_log
    assert set(state["vocab"]) == jax_full.vocab


def test_resume_mismatched_corpus(tmp_path):
    NaiveWP(device="cpu").train(CORPUS, 80, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="checkpoint does not match"):
        NaiveWP(device="cpu").train(["zzz qqq vvv"], 80,
                                    checkpoint_dir=str(tmp_path),
                                    resume=True)
    with pytest.raises(FileNotFoundError):
        NaiveWP(device="cpu").train(CORPUS, 80, resume=True,
                                    checkpoint_dir=str(tmp_path / "no"))


def test_per_step_path_matches(jax_full):
    port = NaiveWP(device="cpu")
    port._force_per_step = True
    port.train(CORPUS, 120)
    _same(port, jax_full)


def test_hash_collision_falls_back_to_per_step(monkeypatch, jax_full):
    """Every string hashes to (0, 0), "##" included: merged symbols of one
    length then collide on the device, the host's interning disagrees,
    and the run is redone on the per-step path with JAX's result."""
    monkeypatch.setattr(train_loop, "str_hashes", lambda s: (0, 0))
    raised = []
    real = train_loop.run_fused

    def spy(*args, **kwargs):
        try:
            return real(*args, **kwargs)
        except train_loop.HashCollision as e:
            raised.append(e)
            raise

    monkeypatch.setattr(train_loop, "run_fused", spy)
    port = NaiveWP(device="cpu")
    port.train(CORPUS, 120)
    assert len(raised) == 1
    assert not port._force_per_step
    _same(port, jax_full)


def test_small_blocks_and_shrinks_match(monkeypatch, jax_full):
    """Blocks of 16 steps, and the state halved between blocks while its
    live slots fit, give the same run."""
    monkeypatch.setattr(train_loop, "run_fused",
                        functools.partial(train_loop.run_fused, K=16))
    monkeypatch.setattr(train_loop, "_FLAT_MIN", 64)
    widths = set()
    pair_stats = train_loop.pair_stats
    monkeypatch.setattr(train_loop, "pair_stats", lambda fs, *a, **k: (
        widths.add(fs.shape[0]), pair_stats(fs, *a, **k))[1])
    port = NaiveWP(device="cpu")
    port.train(CORPUS, 120)
    assert widths >= {1024, 512, 256, 128}
    _same(port, jax_full)


def test_fast_wp_train_then_encode_matches_jax(jax_full):
    """FastWP.train, then tokenize_batch through the new vocab's trie;
    a second train drops the old trie and its device tables."""
    port = FastWP(device="cpu")
    jax_tok = JaxFastWP()
    for corpus, max_vocab in ((CORPUS, 120), (CORPUS[2:], 40)):
        port.train(corpus, max_vocab)
        jax_tok.train(corpus, max_vocab)
        assert port.vocab == jax_tok.vocab
        got = port.tokenize_batch(corpus)
        assert got == jax_tok.tokenize_batch(corpus)
        assert [port.tokenize(s) for s in corpus] == got
    assert port._merge_log != jax_full._merge_log
    port.reset()
    assert port._e2e_trie is None and port._state is None
    assert not port.vocab and not port.corpus_as_symbols


def test_resources_match_jax(tmp_path, jax_full):
    port = NaiveWP(device="cpu")
    port.train(CORPUS, 120)
    port.save_resources(str(tmp_path / "port"))
    loaded = NaiveWP(device="cpu")
    loaded.load_resources(str(tmp_path / "port"), strict=True)
    assert loaded.vocab == jax_full.vocab
    jax_loaded = JaxNaiveWP()
    jax_loaded.load_resources(str(tmp_path / "port"), strict=True)
    assert jax_loaded.vocab == jax_full.vocab
    assert not (tmp_path / "port" / "vocab.json.tmp").exists()


def test_progress_bar_counts_merges(monkeypatch):
    """``progress=True`` counts every merge in the port's own progress
    writer (``utils.Progress``), with no tqdm installed."""
    updates = []

    class Bar:
        def __init__(self, total, desc):
            self.total = total

        def update(self, n):
            updates.append(n)

        def close(self):
            pass

    monkeypatch.setitem(sys.modules, "tqdm", None)
    monkeypatch.setattr(utils, "Progress", Bar)
    port = NaiveWP(device="cpu")
    port.train(CORPUS, 60, progress=True)
    assert sum(updates) == len(port._merge_log) > 0


def test_golden_is_whole(t85k):
    """The full-width golden: the JAX NaiveWP over all of train-85k to an
    8,000-token vocab, every merged token in the vocab."""
    with open(os.path.join(GOLDEN, "port_t85k_v8000_wp_vocab.json"),
              encoding="utf-8") as f:
        golden = json.load(f)
    merges, vocab = golden["merges"], golden["vocab"]
    assert len(vocab) == 8000 and vocab == sorted(set(vocab))
    assert len(merges) == 7879
    assert {a + b[2:] for a, b in merges} <= set(vocab)
    assert all(b.startswith("##") for _, b in merges)


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
    """FastWP to 600 with training's fused front end and with the route
    it replaced (unique_words over pretokenize_batch): the same
    merges and vocabulary, and on sub200 the reference's golden."""
    corpus = _sub200(t85k, source)
    fused = FastWP(device="cpu")
    fused.train(corpus, 600)
    monkeypatch.setattr(binding, "count_words", lambda sents: None)
    old = FastWP(device="cpu")
    old.train(corpus, 600)
    assert fused._merge_log == old._merge_log
    assert fused.vocab == old.vocab
    if source == "sub200":
        with open(os.path.join(GOLDEN, "sub200_v600_wp_vocab.json"),
                  encoding="utf-8") as f:
            assert fused.vocab == set(json.load(f))


def test_device_argument():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls in (NaiveWP, FastWP):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(device="cuda")
        with pytest.raises(ValueError):
            cls(device="meta")
