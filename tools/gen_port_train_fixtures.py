"""Write the golden that holds the PyTorch port's BPE training to the JAX
package at full width.

Run once, on the CPU, with the JAX package (about 7 minutes):

    env JAX_PLATFORMS=cpu python3 tools/gen_port_train_fixtures.py

It trains the JAX ``NaiveBPE`` over the whole of ``data/train-85k.json``
to ``max_vocab=8000``, asserts that its first 500 merges equal the
reference trainer's anchor ``tests/golden/t85k_v578_merges.json``, and
writes every merge to ``tests/golden/port_t85k_v8000_bpe_merges.json``
in the ``merges.json`` format (a JSON list of ``[a, b]`` pairs).
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
ANCHOR = os.path.join(GOLDEN, "t85k_v578_merges.json")
OUT = os.path.join(GOLDEN, "port_t85k_v8000_bpe_merges.json")
MAX_VOCAB = 8000


def main() -> None:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from subword_tokenizers_tpu import NaiveBPE

    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        corpus = json.load(f)
    with open(ANCHOR, encoding="utf-8") as f:
        anchor = [tuple(p) for p in json.load(f)]

    tok = NaiveBPE()
    t0 = time.perf_counter()
    tok.train(corpus, MAX_VOCAB)
    seconds = time.perf_counter() - t0
    merges = tok.merges_list
    assert merges[:len(anchor)] == anchor, "JAX trainer left the anchor"
    with open(OUT, "w", encoding="utf-8") as f:
        json.dump(merges, f, ensure_ascii=False)
        f.write("\n")
    print(json.dumps({"merges": len(merges), "vocab": len(tok.vocab)}))
    print(f"JAX NaiveBPE on {jax.devices()[0].platform}: {seconds:.1f} s "
          f"to max_vocab={MAX_VOCAB}", file=sys.stderr)


if __name__ == "__main__":
    main()
