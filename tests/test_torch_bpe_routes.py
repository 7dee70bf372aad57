"""The port's BPE training routes besides the fused loop, against the JAX
package: checkpoint and resume, the exact per-step path, the fallback on
a hash collision, FastBPE's ranks and the ``merges.json`` resources."""
import functools
import json
import sys

import pytest
import torch

from subword_tokenizers_tpu import FastBPE as JaxFastBPE
from subword_tokenizers_tpu import NaiveBPE as JaxNaiveBPE
from subword_tokenizers_tpu_torch import FastBPE, NaiveBPE, utils
from subword_tokenizers_tpu_torch.models import bpe as bpe_mod
from subword_tokenizers_tpu_torch.ops import train_loop

torch.set_num_threads(1)

CORPUS = [
    "Litwo! Ojczyzno moja! ty jesteś jak zdrowie.",
    "Ile cię trzeba cenić, ten tylko się dowie,",
    "aaa aab abab banana bandana!",
]


@pytest.fixture(scope="module")
def jax_full():
    tok = JaxNaiveBPE()
    tok.train(CORPUS, 120)
    return tok


def _same(port, jax_tok):
    assert port.merges_list == jax_tok.merges_list
    assert port.vocab == jax_tok.vocab
    assert port.corpus_as_symbols == jax_tok.corpus_as_symbols


@pytest.mark.parametrize("every", [10, 1000])
def test_resume_matches_full_run(tmp_path, jax_full, every):
    part = NaiveBPE(device="cpu")
    part.train(CORPUS, 80, checkpoint_dir=str(tmp_path),
               checkpoint_every=every)
    assert (tmp_path / "merges.json").exists()
    resumed = NaiveBPE(device="cpu")
    resumed.train(CORPUS, 120, checkpoint_dir=str(tmp_path), resume=True)
    _same(resumed, jax_full)
    with open(tmp_path / "merges.json", encoding="utf-8") as f:
        assert [tuple(p) for p in json.load(f)] == jax_full.merges_list


def test_resume_mismatched_corpus(tmp_path):
    part = NaiveBPE(device="cpu")
    part.train(CORPUS, 80, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="checkpoint does not match"):
        NaiveBPE(device="cpu").train(["zzz qqq vvv"], 80,
                                     checkpoint_dir=str(tmp_path),
                                     resume=True)
    with pytest.raises(FileNotFoundError):
        NaiveBPE(device="cpu").train(CORPUS, 80, resume=True,
                                     checkpoint_dir=str(tmp_path / "no"))


def test_per_step_path_matches(jax_full):
    port = NaiveBPE(device="cpu")
    port._force_per_step = True
    port.train(CORPUS, 120)
    _same(port, jax_full)
    ref = JaxNaiveBPE()
    ref._force_per_step = True
    ref.train(CORPUS, 120)
    _same(port, ref)


def test_hash_collision_falls_back_to_per_step(monkeypatch, jax_full):
    """Every symbol hashes to (0, 0): merged symbols of one length then
    collide on the device, the host's interning disagrees, and the run
    is redone on the per-step path with the JAX package's result."""
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
    port = NaiveBPE(device="cpu")
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
    port = NaiveBPE(device="cpu")
    port.train(CORPUS, 120)
    assert widths == {1024, 512, 256, 128}
    _same(port, jax_full)


def test_fast_bpe_ranks(jax_full):
    port = FastBPE(device="cpu")
    port.train(CORPUS, 120)
    jax_tok = JaxFastBPE()
    jax_tok.train(CORPUS, 120)
    assert port._bpe_ranks == jax_tok._bpe_ranks
    assert port.merges_list == jax_full.merges_list


def test_resources_match_jax(tmp_path, jax_full):
    port = NaiveBPE(device="cpu")
    port.train(CORPUS, 120)
    port.save_resources(str(tmp_path / "port"))
    jax_full.save_resources(str(tmp_path / "jax"))
    assert (tmp_path / "port" / "merges.json").read_bytes() == \
        (tmp_path / "jax" / "merges.json").read_bytes()
    assert not (tmp_path / "port" / "merges.json.tmp").exists()

    fast = FastBPE(device="cpu")
    fast.load_resources(str(tmp_path / "port"))
    assert fast.merges_list == jax_full.merges_list
    assert fast._bpe_ranks == {p: i for i, p in
                               enumerate(jax_full.merges_list)}
    # a missing file: a silent no-op, or FileNotFoundError when strict
    for strict in (False, True):
        tok = NaiveBPE(device="cpu")
        tok.merges_list = [("a", "b")]
        if strict:
            with pytest.raises(FileNotFoundError):
                tok.load_resources(str(tmp_path / "nope"), strict=True)
        else:
            tok.load_resources(str(tmp_path / "nope"))
        assert tok.merges_list == [("a", "b")]


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
    port = NaiveBPE(device="cpu")
    port.train(CORPUS, 60, progress=True)
    assert sum(updates) == len(port.merges_list) > 0


def test_reset_and_vocab_length():
    port = NaiveBPE(device="cpu")
    port.train(CORPUS, 50)
    assert port.vocab_length(CORPUS) == JaxNaiveBPE().vocab_length(CORPUS)
    assert port.preprocessing(CORPUS) == JaxNaiveBPE().preprocessing(CORPUS)
    port.reset()
    assert not port.merges_list and not port.vocab
    assert not port.corpus_as_symbols
    assert bpe_mod.MAX_TOKENS_BPE == 1 << 52
