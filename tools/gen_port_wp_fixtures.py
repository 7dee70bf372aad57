"""Write the golden that holds the PyTorch port's WordPiece training to the
JAX package at full width.

Run once, on the CPU, with the JAX package (about 15 minutes on two
cores; run it in the background):

    env JAX_PLATFORMS=cpu python3 tools/gen_port_wp_fixtures.py

It trains the JAX ``NaiveWP`` over the whole of ``data/train-85k.json``
to ``max_vocab=8000`` and writes ``tests/golden/port_t85k_v8000_wp_vocab.json``
as ``{"merges": [[a, b], ...], "vocab": [...]}``: the trainer's merge log
in the order the merges were taken, and the sorted vocabulary.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "golden", "port_t85k_v8000_wp_vocab.json")
MAX_VOCAB = 8000


def main() -> None:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from subword_tokenizers_tpu import NaiveWP

    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        corpus = json.load(f)

    tok = NaiveWP()
    t0 = time.perf_counter()
    tok.train(corpus, MAX_VOCAB)
    seconds = time.perf_counter() - t0
    merges = [list(p) for p in tok._merge_log]
    with open(OUT, "w", encoding="utf-8") as f:
        json.dump({"merges": merges, "vocab": sorted(tok.vocab)}, f,
                  ensure_ascii=False)
        f.write("\n")
    print(json.dumps({"merges": len(merges), "vocab": len(tok.vocab)}))
    print(f"JAX NaiveWP on {jax.devices()[0].platform}: {seconds:.1f} s "
          f"to max_vocab={MAX_VOCAB}", file=sys.stderr)


if __name__ == "__main__":
    main()
