"""The port's ``train`` (models/training.py) against a golden of what
it traced and learned: for NaiveBPE, FastBPE, NaiveWP and FastWP on the
fused route, the exact per-step path, a resume from a checkpoint and a
2-shard CPU mesh, the spans in the order they open and nested as they
were, the checkpoint writes and the progress bar's calls among them,
the counters, and digests of the merges, the vocabulary, the symbol
lists and the checkpoint's files. ``tools/gen_port_span_golden.py`` wrote
``tests/golden/port_train_spans.json`` and runs the cases here (about
25 s for all 16 on one core)."""
import importlib.util
import json
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "gen_port_span_golden",
    os.path.join(ROOT, "tools", "gen_port_span_golden.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus():
    return gen.load_corpus()


@pytest.fixture(scope="module")
def golden():
    with open(gen.OUT, encoding="utf-8") as f:
        return json.load(f)


@pytest.mark.parametrize("model", gen.MODELS)
@pytest.mark.parametrize("route", gen.ROUTES)
def test_train_traces_and_learns_as_recorded(model, route, corpus, golden):
    want = golden[f"{model}.{route}"]
    got = gen.record(model, route, corpus)
    for part in sorted(want):
        if part in ("train", "write"):
            assert got[part]["events"] == want[part]["events"], part
            assert got[part]["counters"] == want[part]["counters"], part
    assert got == want
