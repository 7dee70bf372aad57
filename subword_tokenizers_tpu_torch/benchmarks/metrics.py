"""Benchmark metric functions, formula for formula the JAX package's
``benchmarks/metrics.py`` (and so the reference suite's).

Each function is a pure host computation over tokenized data; the
orchestration, and the tokenize calls it times, live in
``benchmarks.suite``. The reference's quirks are kept, since these
numbers are compared across packages: "non-space chars" are counted with
an ASCII-space-only strip (by the caller, ``suite.benchmarks``), the
unordered-match rate divides by *positions* rather than by the union's
size, and the per-sentence latency is taken over an evenly strided
sample of at most ``latency_sample`` sentences.
"""
from __future__ import annotations

import math
from collections import Counter
from timeit import default_timer as timer
from typing import Any, Dict, List, Tuple


def avg_tokens_per_sentence(tokenized_inputs: List[List[str]]) -> float:
    """Mean token count per sentence."""
    if not tokenized_inputs:
        return 0.0
    return sum(len(t) for t in tokenized_inputs) / len(tokenized_inputs)


def avg_tokens_per_word(tokenized_words: Dict[str, List[str]]) -> float:
    """Mean token count per unique word."""
    if not tokenized_words:
        return 0.0
    return sum(len(t) for t in tokenized_words.values()) / len(tokenized_words)


def normalized_sequence_length(total_tokens: int, total_chars: int) -> float:
    """Tokens per character."""
    return total_tokens / total_chars if total_chars else float("inf")


def subword_fragmentation_rate(tokenized_words: Dict[str, List[str]]) -> float:
    """% of unique words split into more than one token."""
    if not tokenized_words:
        return 0.0
    split = sum(1 for t in tokenized_words.values() if len(t) > 1)
    return split / len(tokenized_words) * 100


def vocabulary_coverage_rate(tokenized_words: Dict[str, List[str]]) -> float:
    """% of unique words kept whole."""
    if not tokenized_words:
        return 0.0
    covered = sum(1 for t in tokenized_words.values() if len(t) == 1)
    return covered / len(tokenized_words) * 100


def compression_rate(total_chars: int,
                     tokenized_inputs: List[List[str]]) -> float:
    """Non-space chars per token."""
    total_tokens = sum(len(t) for t in tokenized_inputs)
    return total_chars / total_tokens if total_tokens else float("inf")


def _strip_sharp(tokens: List[str]) -> List[str]:
    return [t[2:] if t.startswith("##") else t for t in tokens]


def token_sequence_equivalence(
        tokenizer1: Any, tokenizer2: Any, input: List[str]
) -> Tuple[int, int, float, int, float, int, int, float]:
    """Positional, unordered and per-word agreement of two tokenizers,
    each sentence and each of its words tokenized on the host. Returns
    (positional matches, positions, rate, unordered matches, rate, word
    matches, words, rate)."""
    total_pos = 0
    pos_matches = 0
    unordered_matches = 0
    total_words = 0
    word_matches = 0

    for sentence in input:
        t1 = _strip_sharp(tokenizer1.tokenize(sentence))
        t2 = _strip_sharp(tokenizer2.tokenize(sentence))
        n = min(len(t1), len(t2))
        pos_matches += sum(1 for i in range(n) if t1[i] == t2[i])
        total_pos += n
        f1, f2 = Counter(t1), Counter(t2)
        unordered_matches += sum(min(f1[t], f2[t]) for t in f1.keys() & f2)
        words = sentence.split()
        total_words += len(words)
        for word in words:
            s1 = set(_strip_sharp(tokenizer1.tokenize(word)))
            s2 = set(_strip_sharp(tokenizer2.tokenize(word)))
            if s1 & s2:
                word_matches += 1

    pos_rate = pos_matches / total_pos * 100 if total_pos else 0.0
    unordered_rate = (unordered_matches / total_pos * 100
                      if total_pos else 0.0)
    word_rate = word_matches / total_words * 100 if total_words else 0.0
    return (pos_matches, total_pos, pos_rate, unordered_matches,
            unordered_rate, word_matches, total_words, word_rate)


def tokenization_performance(tokenizer: Any, input: List[str],
                             latency_sample: int = 256) -> Dict[str, float]:
    """Wall-clock tokenize performance, two timings:

    - ``total_time_s`` / ``throughput_tokens_per_s`` /
      ``avg_batch_latency_s``: one ``tokenize_batch`` call when the
      tokenizer has one (the device path), else per-sentence calls; the
      batch latency is the total over the sentence count;
    - ``avg_latency_s``: the reference's definition, the wall time of
      single ``tokenize`` calls per sentence, over an evenly strided
      sample of at most ``latency_sample`` sentences
      (``latency_sample=len(input)`` sweeps them all).
    """
    start = timer()
    if hasattr(tokenizer, "tokenize_batch"):
        all_tokens = tokenizer.tokenize_batch(input)
    else:
        all_tokens = [tokenizer.tokenize(s) for s in input]
    total_time = timer() - start
    total_tokens = sum(len(t) for t in all_tokens)
    throughput = total_tokens / total_time if total_time > 0 else float("inf")
    batch_latency = total_time / len(input) if input else 0.0

    if input:
        if len(input) > latency_sample:
            step = len(input) / latency_sample
            sample = [input[int(i * step)] for i in range(latency_sample)]
        else:
            sample = input
        lat_start = timer()
        for s in sample:
            tokenizer.tokenize(s)
        avg_latency = (timer() - lat_start) / len(sample)
    else:
        avg_latency = 0.0

    return {"total_time_s": total_time,
            "throughput_tokens_per_s": throughput,
            "avg_latency_s": avg_latency,
            "avg_batch_latency_s": batch_latency}


def training_performance(tokenizer: Any, test_corpus: List[str],
                         max_vocab_size: int) -> Dict[str, float]:
    """Wall-clock train time."""
    start = timer()
    tokenizer.train(test_corpus, max_vocab_size)
    return {"train_time_s": timer() - start}


def zipf_distribution(tokenized_inputs: List[List[str]]) -> Dict[str, float]:
    """Least-squares line through log frequency against log rank."""
    all_tokens = [t for sentence in tokenized_inputs for t in sentence]
    freqs = Counter(all_tokens)
    sorted_freqs = [c for _, c in freqs.most_common()]
    n = len(sorted_freqs)
    if n == 0:
        return {"slope": 0.0, "intercept": 0.0, "correlation": 0.0}
    log_ranks = [math.log(r) for r in range(1, n + 1)]
    log_freqs = [math.log(f) for f in sorted_freqs]
    mean_r = sum(log_ranks) / n
    mean_f = sum(log_freqs) / n
    cov = sum((x - mean_r) * (y - mean_f)
              for x, y in zip(log_ranks, log_freqs))
    var_r = sum((x - mean_r) ** 2 for x in log_ranks)
    var_f = sum((y - mean_f) ** 2 for y in log_freqs)
    slope = cov / var_r if var_r else 0.0
    intercept = mean_f - slope * mean_r
    corr = (cov / math.sqrt(var_r * var_f)) if var_r and var_f else 0.0
    return {"slope": slope, "intercept": intercept, "correlation": corr}
