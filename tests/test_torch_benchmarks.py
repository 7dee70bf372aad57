"""The port's benchmark suite (``benchmarks/metrics.py`` and
``benchmarks/suite.py``) against the JAX package's: every metric exactly
on the same inputs, token-sequence equivalence of the same pair of
tokenizers trained in each package, ``benchmarks()`` in its three modes
(the returned dict and the printed report, timings removed), and the
call semantics of the timed path."""
import math
import re

import pytest
import torch

from subword_tokenizers_tpu import FastBPE as JaxFastBPE
from subword_tokenizers_tpu import FastWP as JaxFastWP
from subword_tokenizers_tpu import NaiveBPE as JaxNaiveBPE
from subword_tokenizers_tpu import NaiveWP as JaxNaiveWP
from subword_tokenizers_tpu.benchmarks import metrics as jax_metrics
from subword_tokenizers_tpu.benchmarks.suite import \
    benchmarks as jax_benchmarks
from subword_tokenizers_tpu_torch import FastBPE, FastWP, NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.benchmarks import metrics as M
from subword_tokenizers_tpu_torch.benchmarks.suite import benchmarks

torch.set_num_threads(1)

TOKENIZED = [["li", "##two", "!"], ["oj", "##czy", "##zno", "mo", "##ja"],
             ["ty"], []]
WORDS = {"litwo": ["li", "##two"], "ty": ["ty"], "x": ["[UNK]"],
         "ab": ["a", "##b"]}
CORPUS = ["aaa aab abab banana bandana!", "ab ab ab cd cd c d aaaa"]
PAIRS = {"bpe": ((NaiveBPE, FastBPE), (JaxNaiveBPE, JaxFastBPE)),
         "wp": ((NaiveWP, FastWP), (JaxNaiveWP, JaxFastWP))}
TIMED = ("Training time", "Total time", "Throughput", "Avg. latency",
         "Batch latency")


@pytest.mark.parametrize("name,args", [
    ("avg_tokens_per_sentence", (TOKENIZED,)),
    ("avg_tokens_per_sentence", ([],)),
    ("avg_tokens_per_word", (WORDS,)),
    ("avg_tokens_per_word", ({},)),
    ("normalized_sequence_length", (10, 40)),
    ("normalized_sequence_length", (10, 0)),
    ("subword_fragmentation_rate", (WORDS,)),
    ("subword_fragmentation_rate", ({},)),
    ("vocabulary_coverage_rate", (WORDS,)),
    ("vocabulary_coverage_rate", ({},)),
    ("compression_rate", (100, TOKENIZED)),
    ("compression_rate", (100, [[]])),
])
def test_metric_equals_jax(name, args):
    got = getattr(M, name)(*args)
    want = getattr(jax_metrics, name)(*args)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("tokenized", [TOKENIZED, [], [["a"]],
                                       [["a", "b", "a"], ["c", "a"]]])
def test_zipf_equals_jax(tokenized):
    got = M.zipf_distribution(tokenized)
    want = jax_metrics.zipf_distribution(tokenized)
    assert list(got) == list(want)
    for k in want:
        assert math.isclose(got[k], want[k], rel_tol=0, abs_tol=0), k


def _trained(classes, vocab=40, **kw):
    toks = [cls(**kw) for cls in classes]
    for t in toks:
        t.train(CORPUS, vocab)
    return toks


@pytest.mark.parametrize("kind", ["bpe", "wp"])
def test_equivalence_equals_jax(kind):
    port_cls, jax_cls = PAIRS[kind]
    a, b = _trained(port_cls, device="cpu")
    ja, jb = _trained(jax_cls)
    got = M.token_sequence_equivalence(a, b, CORPUS)
    assert got == jax_metrics.token_sequence_equivalence(ja, jb, CORPUS)
    # the port's metric over the JAX tokenizers gives the same tuple
    assert got == M.token_sequence_equivalence(ja, jb, CORPUS)


class _SpyTok:
    """Counts batch and single calls, to pin the latency semantics."""

    def __init__(self):
        self.batch_calls = 0
        self.single_calls = 0

    def tokenize_batch(self, sents):
        self.batch_calls += 1
        return [[s] for s in sents]

    def tokenize(self, s):
        self.single_calls += 1
        return [s]


class _Plain:
    def __init__(self):
        self.single_calls = 0

    def tokenize(self, s):
        self.single_calls += 1
        return [s]


@pytest.mark.parametrize("n,sample,batch,single", [
    (10, 256, 1, 10),      # <= latency_sample: a full sweep
    (1000, 16, 1, 16),     # strided to latency_sample
    (0, 256, 1, 0),        # nothing to time
])
def test_tokenization_performance_semantics(n, sample, batch, single):
    spy = _SpyTok()
    perf = M.tokenization_performance(spy, [f"s{i}" for i in range(n)],
                                      latency_sample=sample)
    assert (spy.batch_calls, spy.single_calls) == (batch, single)
    assert set(perf) == {"total_time_s", "throughput_tokens_per_s",
                         "avg_latency_s", "avg_batch_latency_s"}
    assert all(v >= 0 for v in perf.values())


def test_tokenization_performance_without_batch():
    """No batch path: both timings come from per-sentence calls."""
    p = _Plain()
    sents = [f"s{i}" for i in range(10)]
    perf = M.tokenization_performance(p, sents)
    assert p.single_calls == 2 * len(sents)
    assert perf["avg_latency_s"] >= 0


def test_training_performance():
    tok = NaiveBPE(device="cpu")
    perf = M.training_performance(tok, CORPUS, 30)
    assert list(perf) == ["train_time_s"] and perf["train_time_s"] > 0
    assert tok.merges_list


def _strip(res):
    """The result dict without its timings."""
    out = {}
    for k, v in res.items():
        if k == "performance":
            out[k] = sorted(v)
        elif isinstance(v, dict):
            out[k] = _strip(v)
        elif k != "train_time_s":
            out[k] = v
        else:
            out[k] = "timed"
    return out


def _mask(out):
    return [re.sub(r"\d+(\.\d+)?(e[-+]?\d+)?", "#", ln)
            if ln.startswith(TIMED) else ln for ln in out.splitlines()]


@pytest.mark.parametrize("kind", ["bpe", "wp"])
@pytest.mark.parametrize("mode", ["compare", "tokenization", "training"])
def test_suite_equals_jax(kind, mode, capsys):
    port_cls, jax_cls = PAIRS[kind]
    runs = []
    for toks in (_trained(port_cls, 30, device="cpu"),
                 _trained(jax_cls, 30)):
        bench = benchmarks if toks[0].__module__.startswith(
            "subword_tokenizers_tpu_torch") else jax_benchmarks
        kw = {"compare": dict(pretrained=True, pretrained_path="",
                              compare_only=True),
              "tokenization": dict(pretrained=True, pretrained_path=""),
              "training": dict(train_corpus=CORPUS)}[mode]
        res = bench(toks[0], 30, [] if mode == "training" else CORPUS,
                    reference_tokenizers=toks[1:], **kw)
        runs.append((res, capsys.readouterr().out))
    (port_res, port_out), (jax_res, jax_out) = runs
    assert port_res["mode"] == mode
    assert _strip(port_res) == _strip(jax_res)
    assert _mask(port_out) == _mask(jax_out)
    if mode == "compare":
        assert port_res["equivalence"][type(toks[1]).__name__]["positions"]
    if mode == "training":
        assert all(port_res[type(t).__name__]["train_time_s"] > 0
                   for t in toks)


def test_suite_edge_cases(capsys):
    a = NaiveBPE(device="cpu")
    res = benchmarks(a, 30, CORPUS, pretrained=True, compare_only=True)
    assert res == {"primary": "NaiveBPE", "mode": "compare"}
    assert "No reference tokenizers" in capsys.readouterr().out
    with pytest.raises(ValueError, match="train_corpus is required"):
        benchmarks(a, 30, [], train_corpus=[])
