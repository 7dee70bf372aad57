"""Write the fixtures that hold the PyTorch port of FastWP batched encode
to the JAX package.

Run once, on the CPU, with the JAX package:

    env JAX_PLATFORMS=cpu python3 tools/gen_port_fixtures.py

It writes two files under ``tests/golden/``:

- ``port_t85k_fastwp_vocab.json``: the 8,000-token WordPiece vocab
  ``t5k2500_v8000_wp_vocab.json`` plus every non-space character of the
  lowered ``data/train-85k.json`` and its ``##`` form. A real WordPiece
  vocab holds its corpus's alphabet; without these the JAX encoder
  refuses some sentences of the corpus ("scan makes no progress").
- ``port_t85k_fastwp_expect.json``: the sha256 of the JAX package's
  ``FastWP.tokenize_batch`` output for the first 3,000 sentences and for
  all 85,000, the total token count and the number of unique chunks.

The digest is ``sha256(json.dumps(token_lists, ensure_ascii=False))``
over the UTF-8 bytes, so a checker needs neither JAX nor this script.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
VOCAB_OUT = os.path.join(GOLDEN, "port_t85k_fastwp_vocab.json")
EXPECT_OUT = os.path.join(GOLDEN, "port_t85k_fastwp_expect.json")
N_SMALL = 3000


def digest(token_lists) -> str:
    return hashlib.sha256(json.dumps(token_lists, ensure_ascii=False)
                          .encode("utf-8")).hexdigest()


def main() -> None:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from subword_tokenizers_tpu import FastWP
    from subword_tokenizers_tpu._native import binding

    with open(os.path.join(GOLDEN, "t5k2500_v8000_wp_vocab.json"),
              encoding="utf-8") as f:
        base = json.load(f)
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        corpus = json.load(f)
    chars = sorted({c for s in corpus for c in s.lower() if not c.isspace()})
    vocab = sorted(set(base) | set(chars) | {"##" + c for c in chars})
    with open(VOCAB_OUT, "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False, indent=0)
        f.write("\n")

    tok = FastWP()
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(vocab, f, ensure_ascii=False)
        tok.load_resources(d, strict=True)
    small = tok.tokenize_batch(corpus[:N_SMALL])
    t0 = time.perf_counter()
    full = tok.tokenize_batch(corpus)
    seconds = time.perf_counter() - t0
    assert full[:N_SMALL] == small
    n_unique = int(binding.encode_prep(corpus)[4].size)
    expect = {
        "vocab_size": len(vocab),
        "n_sentences": len(corpus),
        "small_n": N_SMALL,
        "small_sha256": digest(small),
        "full_sha256": digest(full),
        "full_tokens": sum(map(len, full)),
        "unique_chunks": n_unique,
    }
    with open(EXPECT_OUT, "w", encoding="utf-8") as f:
        json.dump(expect, f, indent=1)
        f.write("\n")
    print(json.dumps(expect))
    print(f"JAX FastWP on {jax.devices()[0].platform}: {seconds:.2f} s "
          "for the whole corpus", file=sys.stderr)


if __name__ == "__main__":
    main()
