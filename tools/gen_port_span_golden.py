"""Write the golden that holds the port's ``train`` to what it traced
and learned: ``tests/golden/port_train_spans.json``.

Run on the CPU, from the repo root (about 25 s; no JAX):

    python3 tools/gen_port_span_golden.py

For ``NaiveBPE``, ``FastBPE``, ``NaiveWP`` and ``FastWP`` it trains four
routes of ``train`` on slices of ``data/train-85k.json``:

- ``fused``: the first 300 sentences to 220, as ``tests/
  test_torch_profiling.py`` trains them (ops/train_loop.run_fused), with
  a checkpoint every 40 merges and the progress bar on;
- ``per_step``: the same with ``_force_per_step = True``;
- ``resume``: a train to 150 on the per-step path that checkpoints every
  30 merges, then a fresh tokenizer resumed from that checkpoint to 220
  on the fused route, both with the progress bar;
- ``mesh``: the first 60 sentences on a 2-shard CPU mesh to 160 (BPE) or
  180 (WordPiece), with a checkpoint every 40 merges and the progress
  bar (parallel/train.ShardedTrainer).

Each train records its spans in the order they open, each as the
``/``-joined path of the spans holding it (``profiling.phase``
swapped), with the checkpoint writes (``<save>``) and the progress bar's
calls (``<bar ...>``, ``<update n>``, ``<close>``) at the point they
happen; its counters; and digests of the merges, ``vocab`` and
``corpus_as_symbols``, FastBPE's ranks, the checkpoint's files, and a
mesh's tier counts. ``tests/test_torch_train_spans.py`` runs the same
cases through :func:`record` and compares.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "golden", "port_train_spans.json")
MODELS = ("NaiveBPE", "FastBPE", "NaiveWP", "FastWP")
ROUTES = ("fused", "per_step", "resume", "mesh")
SENTENCES, VOCAB, HALF = 300, 220, 150
MESH_SENTENCES, MESH_VOCAB = 60, {"BPE": 160, "WP": 180}


def _digest(obj) -> str:
    text = json.dumps(obj, ensure_ascii=False, sort_keys=True)
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def _files(path: str) -> dict:
    """Digests of a checkpoint's files, sets of strings sorted."""
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), encoding="utf-8") as f:
            data = json.load(f)
        if name == "vocab.json":
            data = sorted(data)
        elif name == "wp_state.json":
            data = {"vocab": sorted(data["vocab"]), "merges": data["merges"]}
        out[name] = _digest(data)
    return out


@contextlib.contextmanager
def _traced(events: list):
    """Spans, checkpoint writes and the progress bar's calls into
    ``events``, for the trains run inside."""
    from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP, utils
    from subword_tokenizers_tpu_torch.benchmarks import profiling
    stack = []

    @contextlib.contextmanager
    def phase(name, device=None):
        stack.append(name)
        events.append("/".join(stack))
        try:
            yield
        finally:
            stack.pop()

    def note(what):
        events.append("/".join(stack + [what]))

    class Bar:
        def __init__(self, total, desc):
            note(f"<bar {total} {desc}>")

        def update(self, n=1):
            note(f"<update {n}>")

        def close(self):
            note("<close>")

    saves = {cls: cls.save_resources for cls in (NaiveBPE, NaiveWP)}

    def saver(real):
        def save_resources(self, path):
            note("<save>")
            return real(self, path)
        return save_resources

    real_phase, real_bar = profiling.phase, utils.Progress
    profiling.phase, utils.Progress = phase, Bar
    for cls, real in saves.items():
        cls.save_resources = saver(real)
    try:
        yield
    finally:
        profiling.phase, utils.Progress = real_phase, real_bar
        for cls, real in saves.items():
            cls.save_resources = real


def _train(tok, corpus, vocab, **kwargs) -> dict:
    """One traced train: its events and counters."""
    from subword_tokenizers_tpu_torch.benchmarks import profiling
    events = []
    profiling.reset()
    with _traced(events):
        tok.train(corpus, vocab, **kwargs)
    counters = dict(sorted(profiling.counters().items()))
    profiling.reset()
    return {"events": events, "counters": counters}


def _outputs(tok) -> dict:
    merges = tok.merges_list if hasattr(tok, "merges_list") \
        else tok._merge_log
    out = {"merges": len(merges), "vocab": len(tok.vocab),
           "merges_sha": _digest([list(p) for p in merges]),
           "vocab_sha": _digest(sorted(tok.vocab)),
           "symbols_sha": _digest([[s, f] for s, f in
                                   tok.corpus_as_symbols])}
    if hasattr(tok, "_bpe_ranks"):
        out["ranks_sha"] = _digest(sorted(
            [list(p), r] for p, r in tok._bpe_ranks.items()))
    if getattr(tok, "mesh", None) is not None:
        out["sel_stats"] = dict(tok._sel_stats)
        out["topk_fallbacks"] = tok._topk_fallbacks
        out["graph_stats"] = tok._graph_stats
    return out


def record(model: str, route: str, corpus: list) -> dict:
    """One case: ``model``'s train on ``route`` over ``corpus`` (the
    whole of train-85k, sliced here)."""
    import subword_tokenizers_tpu_torch as port
    from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh
    cls = getattr(port, model)
    text = corpus[:SENTENCES]
    got = {}
    with tempfile.TemporaryDirectory() as ckpt:
        if route in ("fused", "per_step"):
            tok = cls(device="cpu")
            tok._force_per_step = route == "per_step"
            got["train"] = _train(tok, text, VOCAB, checkpoint_dir=ckpt,
                                  checkpoint_every=40, progress=True)
        elif route == "resume":
            writer = cls(device="cpu")
            writer._force_per_step = True
            got["write"] = _train(writer, text, HALF, checkpoint_dir=ckpt,
                                  checkpoint_every=30, progress=True)
            tok = cls(device="cpu")
            got["train"] = _train(tok, text, VOCAB, checkpoint_dir=ckpt,
                                  resume=True, progress=True)
        else:
            mesh = make_data_mesh(2, devices=["cpu"] * 2)
            tok = cls(mesh=mesh, device="cpu")
            vocab = MESH_VOCAB["WP" if model.endswith("WP") else "BPE"]
            got["train"] = _train(tok, corpus[:MESH_SENTENCES], vocab,
                                  checkpoint_dir=ckpt, checkpoint_every=40,
                                  progress=True)
        got["outputs"] = _outputs(tok)
        got["checkpoint"] = _files(ckpt)
    return got


def load_corpus() -> list:
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        return json.load(f)


def main() -> None:
    sys.path.insert(0, ROOT)
    import torch
    torch.set_num_threads(1)
    corpus = load_corpus()
    golden = {}
    t0 = time.perf_counter()
    for model in MODELS:
        for route in ROUTES:
            golden[f"{model}.{route}"] = record(model, route, corpus)
    seconds = time.perf_counter() - t0
    with open(OUT, "w", encoding="utf-8") as f:
        json.dump(golden, f, ensure_ascii=False, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(golden)} cases in {seconds:.1f} s -> "
          f"{os.path.relpath(OUT, ROOT)}")


if __name__ == "__main__":
    main()
