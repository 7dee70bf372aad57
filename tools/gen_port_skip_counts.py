"""Write the golden that holds the PyTorch port's skip route (deferred
compaction) to the JAX package's count of overflow compactions.

Run once, on the CPU, with the JAX package (about 30 minutes for the
three trains; run it in the background):

    env JAX_PLATFORMS=cpu python3 tools/gen_port_skip_counts.py

For each route of ``chip_smoke.py``'s phase 12 with a window
(``bpe_skip12``, ``bpe_skip2``, ``wp_skip12``) it trains the JAX model
over the whole of ``data/train-85k.json`` to ``max_vocab=8000`` under
``SWT_SKIP_COMPACT``, counting the overflow compactions as the sum of
``rec["ovf"]`` from ``flat_train_steps(..., count_ovf=True)``, checks the
merges against the routes' goldens, and writes
``tests/golden/port_t85k_skip_overflows.json``: ``{route: count}``.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
OUT = os.path.join(GOLDEN, "port_t85k_skip_overflows.json")
MAX_VOCAB = 8000
ROUTES = (("bpe_skip12", "NaiveBPE", 12), ("bpe_skip2", "NaiveBPE", 2),
          ("wp_skip12", "NaiveWP", 12))


def main() -> None:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from subword_tokenizers_tpu import NaiveBPE, NaiveWP
    from subword_tokenizers_tpu.ops import train_loop

    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        corpus = json.load(f)
    with open(os.path.join(GOLDEN, "port_t85k_v8000_bpe_merges.json"),
              encoding="utf-8") as f:
        bpe = [tuple(p) for p in json.load(f)]
    with open(os.path.join(GOLDEN, "port_t85k_v8000_wp_vocab.json"),
              encoding="utf-8") as f:
        wp = [tuple(p) for p in json.load(f)["merges"]]
    real = train_loop.flat_train_steps
    ovf = []

    def counting(*args, **kwargs):
        carry, recs = real(*args, **{**kwargs, "count_ovf": True})
        recs = dict(recs)
        ovf.append(int(np.asarray(recs.pop("ovf")).sum()))
        return carry, recs

    train_loop.flat_train_steps = counting
    counts = {}
    for name, model, skip in ROUTES:
        os.environ["SWT_SKIP_COMPACT"] = str(skip)
        ovf.clear()
        tok = (NaiveBPE if model == "NaiveBPE" else NaiveWP)()
        t0 = time.perf_counter()
        tok.train(corpus, MAX_VOCAB)
        got = tok.merges_list if model == "NaiveBPE" else tok._merge_log
        assert [tuple(p) for p in got] == (bpe if model == "NaiveBPE"
                                           else wp), name
        counts[name] = sum(ovf)
        print(f"{name}: {counts[name]} overflow compactions, "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
    with open(OUT, "w", encoding="utf-8") as f:
        json.dump(counts, f)
        f.write("\n")
    print(json.dumps(counts))


if __name__ == "__main__":
    main()
