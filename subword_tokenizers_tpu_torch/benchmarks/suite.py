"""Benchmark orchestrator: the JAX package's ``benchmarks/suite.py``,
its three modes, its printed report and its returned dict.

Modes:
- compare-only (pretrained and compare): token-sequence equivalence of
  the primary tokenizer against each reference tokenizer;
- pretrained: the tokenization metrics, performance and Zipf fit of the
  primary and of each reference tokenizer;
- training: the training wall time of every tokenizer.

As in the JAX package (and the reference), the pretrained mode calls
``load_resources`` again with the CLI's raw ``--pretrained`` value, a
silent no-op since the CLI has already loaded the real path.

The tokenization report batches the corpus and its unique words through
``tokenize_batch``, so on the card it runs the tokenizer's encode
kernels (kernels 1-2 for FastWP, K5 or K6 and kernel 2 for the others).
"""
from __future__ import annotations

from typing import Any, Dict, List

from .metrics import (avg_tokens_per_sentence, avg_tokens_per_word,
                      compression_rate, normalized_sequence_length,
                      subword_fragmentation_rate, token_sequence_equivalence,
                      tokenization_performance, training_performance,
                      vocabulary_coverage_rate, zipf_distribution)


def _tokenization_report(tokenizer: Any, name: str, test_corpus: List[str],
                         total_chars: int) -> Dict[str, Any]:
    if hasattr(tokenizer, "tokenize_batch"):
        tokenized_inputs = tokenizer.tokenize_batch(test_corpus)
    else:
        tokenized_inputs = [tokenizer.tokenize(s) for s in test_corpus]
    unique_words = {w for sent in tokenizer.preprocessing(test_corpus)
                    for w, _ in sent}
    # Word-level metrics need every unique word tokenized alone: one
    # batch of the whole set, not one host call per word.
    uw = list(unique_words)
    if hasattr(tokenizer, "tokenize_batch"):
        tokenized_words = dict(zip(uw, tokenizer.tokenize_batch(uw)))
    else:
        tokenized_words = {w: tokenizer.tokenize(w) for w in uw}
    total_tokens = sum(len(t) for t in tokenized_inputs)

    print(f"=== Tokenization Metrics for {name} ===")
    m = {
        "avg_tokens_per_sentence": avg_tokens_per_sentence(tokenized_inputs),
        "avg_tokens_per_word": avg_tokens_per_word(tokenized_words),
        "compression_rate": compression_rate(total_chars, tokenized_inputs),
        "normalized_sequence_length":
            normalized_sequence_length(total_tokens, total_chars),
        "subword_fragmentation_rate":
            subword_fragmentation_rate(tokenized_words),
        "vocabulary_coverage_rate":
            vocabulary_coverage_rate(tokenized_words),
    }
    print(f"Average tokens per sentence:        "
          f"{m['avg_tokens_per_sentence']:.2f}")
    print(f"Average tokens per word:            "
          f"{m['avg_tokens_per_word']:.2f}")
    print(f"Compression rate (chars per token): "
          f"{m['compression_rate']:.2f}")
    print(f"Normalized sequence length:         "
          f"{m['normalized_sequence_length']:.4f}")
    print(f"Subword fragmentation rate:         "
          f"{m['subword_fragmentation_rate']:.2f}%")
    print(f"Vocabulary coverage rate:           "
          f"{m['vocabulary_coverage_rate']:.2f}%")

    print("\n=== Tokenization Performance ===")
    perf = tokenization_performance(tokenizer, test_corpus)
    print(f"Total time:     {perf['total_time_s']:.4f}s")
    print(f"Throughput:     {perf['throughput_tokens_per_s']:.2f} tokens/s")
    print(f"Avg. latency:   {perf['avg_latency_s']:.6f}s per sentence")
    print(f"Batch latency:  {perf['avg_batch_latency_s']:.6f}s per sentence "
          f"(amortized)")

    print("\n=== Zipf Distribution Fit ===")
    zipf = zipf_distribution(tokenized_inputs)
    print(f"Slope:          {zipf['slope']:.4f}")
    print(f"Intercept:      {zipf['intercept']:.4f}")
    print(f"Correlation:    {zipf['correlation']:.4f}")

    m["performance"] = perf
    m["zipf"] = zipf
    return m


def benchmarks(
    tokenizer: Any,
    max_vocab_size: int,
    test_corpus: List[str],
    train_corpus: List[str] = [],
    pretrained: bool = False,
    pretrained_path: str = "",
    reference_tokenizers: List[Any] = [],
    compare_only: bool = False,
) -> Dict[str, Any]:
    """Run the selected benchmark mode; print the reference-format report
    and return the results as a dict."""
    name1 = tokenizer.__class__.__name__
    results: Dict[str, Any] = {"primary": name1, "mode": None}

    if pretrained and compare_only:
        results["mode"] = "compare"
        if not reference_tokenizers:
            print("No reference tokenizers provided for comparison.")
            return results
        results["equivalence"] = {}
        for other in reference_tokenizers:
            name2 = other.__class__.__name__
            (pos_m, pos_t, pos_rate, un_m, un_rate, w_m, w_t,
             w_rate) = token_sequence_equivalence(tokenizer, other,
                                                  test_corpus)
            print(f"=== Token Sequence Equivalence ({name1} vs {name2}) ===")
            print(f"Positional match rate: {pos_rate:.2f}% ({pos_m}/{pos_t})")
            print(f"Unordered match rate:  {un_rate:.2f}% ({un_m}/{pos_t})")
            print(f"Word match rate:       {w_rate:.2f}% ({w_m}/{w_t})")
            results["equivalence"][name2] = {
                "positional_rate": pos_rate, "unordered_rate": un_rate,
                "word_match_rate": w_rate, "positional_matches": pos_m,
                "positions": pos_t, "unordered_matches": un_m,
                "word_matches": w_m, "words": w_t,
            }
        return results

    if pretrained:
        results["mode"] = "tokenization"
        # The reference's quirk: load again from the raw CLI value, a
        # silent no-op (the CLI already loaded the real path).
        tokenizer.load_resources(pretrained_path)
        total_chars = sum(len(s.replace(" ", "")) for s in test_corpus)
        results[name1] = _tokenization_report(tokenizer, name1, test_corpus,
                                              total_chars)
        for other in reference_tokenizers:
            name2 = other.__class__.__name__
            other.load_resources(pretrained_path)
            print()
            results[name2] = _tokenization_report(other, name2, test_corpus,
                                                  total_chars)
        return results

    results["mode"] = "training"
    if not train_corpus:
        raise ValueError("train_corpus is required for training metrics.")
    perf = training_performance(tokenizer, train_corpus, max_vocab_size)
    print(f"=== Training Performance for {name1} ===")
    print(f"Training time:  {perf['train_time_s']:.4f}s")
    results[name1] = perf
    for other in reference_tokenizers:
        name2 = other.__class__.__name__
        perf2 = training_performance(other, train_corpus, max_vocab_size)
        print(f"\n=== Training Performance for {name2} ===")
        print(f"Training time:  {perf2['train_time_s']:.4f}s")
        results[name2] = perf2
    return results
