"""Write the digests that hold the PyTorch port's FastBPE, NaiveBPE and
NaiveWP batched encoders to the JAX package.

Run once, on the CPU, with the JAX package (a few seconds of encoding):

    env JAX_PLATFORMS=cpu python3 tools/gen_port_encode_fixtures.py

It writes ``tests/golden/port_t85k_encode_expect.json``: the sha256 and
the token count of ``tokenize_batch`` over all of ``data/train-85k.json``
and over its first 3,000 sentences, for

- FastBPE and NaiveBPE with the 7,922 merges of
  ``port_t85k_v8000_bpe_merges.json`` (``golden``) and with the same
  merges shuffled by ``random.Random(7)`` (``shuffled``: the greedy and
  the monotone encoders disagree on them);
- NaiveWP with the ``vocab`` of ``port_t85k_v8000_wp_vocab.json``;
- NaiveBPE on the first 3,000 sentences with one merge listed twice
  (``duplicated``: the exact host route), the copy put first.

The merge lists and the vocab are ``chip_smoke.merge_lists`` and
``chip_smoke.wp_vocab``, which the checks on the card read too.

The digest is ``sha256(json.dumps(token_lists, ensure_ascii=False))``
over the UTF-8 bytes, so a checker needs neither JAX nor this script.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (SHUFFLE_SEED, digest, load,  # noqa: E402
                        merge_lists, wp_vocab)

OUT = os.path.join(ROOT, "tests", "golden", "port_t85k_encode_expect.json")
N_SMALL = 3000


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from subword_tokenizers_tpu import FastBPE, NaiveBPE, NaiveWP

    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        corpus = json.load(f)
    lists = merge_lists()
    expect = {"n_sentences": len(corpus), "small_n": N_SMALL,
              "shuffle_seed": SHUFFLE_SEED}
    seconds = {}

    def record(key, tok, small_only=False):
        small = tok.tokenize_batch(corpus[:N_SMALL])
        expect[key] = {"small_sha256": digest(small),
                       "small_tokens": sum(map(len, small))}
        if small_only:
            return
        t0 = time.perf_counter()
        full = tok.tokenize_batch(corpus)
        seconds[key] = round(time.perf_counter() - t0, 3)
        assert full[:N_SMALL] == small
        expect[key].update(full_sha256=digest(full),
                           full_tokens=sum(map(len, full)))

    for order in ("golden", "shuffled"):
        for cls in (FastBPE, NaiveBPE):
            record(f"{cls.__name__}_{order}",
                   load(cls(), "merges.json", lists[order]))
    record("NaiveBPE_duplicated",
           load(NaiveBPE(), "merges.json", lists["duplicated"]),
           small_only=True)
    record("NaiveWP_golden", load(NaiveWP(), "vocab.json", wp_vocab()))
    with open(OUT, "w", encoding="utf-8") as f:
        json.dump(expect, f, indent=1)
        f.write("\n")
    print(json.dumps(expect))
    print(f"JAX on {jax.devices()[0].platform}, whole corpus, s: "
          f"{json.dumps(seconds)}", file=sys.stderr)


if __name__ == "__main__":
    main()
