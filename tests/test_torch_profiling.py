"""The port's profiler (benchmarks/profiling.py): spans that time the
host's wall and never wait on the device, that annotate a recording
``torch.profiler`` themselves, nested as in the code, and the per-train
counters beside them; and the training spans of a small CPU train of
FastBPE and FastWP, which cover the train's wall."""
import ast
import contextlib
import glob
import json
import os
import tempfile

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from subword_tokenizers_tpu_torch import FastBPE, FastWP
from subword_tokenizers_tpu_torch.benchmarks import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "subword_tokenizers_tpu_torch")
MARK = "test.train"
# the tail's spans that lie inside another span: {span: the span holding it}
NESTED = {"train.final_copy": "train.final_fetch",
          "train.symbols": "train.final_fetch"}
SPANS = {FastBPE: ("train.frontend", "train.alphabet", "train.corpus",
                   "train.loop_setup", "train.device_block",
                   "train.fetch_records", "train.verify",
                   "train.final_fetch", "train.final_copy", "train.close",
                   "train.symbols", "train.ranks"),
         FastWP: ("train.frontend", "train.alphabet", "train.corpus",
                  "train.loop_setup", "train.device_block",
                  "train.fetch_records", "train.verify",
                  "train.final_fetch", "train.final_copy", "train.close",
                  "train.symbols", "train.trie")}


@pytest.fixture
def clean():
    """The profiler off and empty before and after a test."""
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


@pytest.fixture(scope="module")
def corpus():
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        return json.load(f)[:300]


@pytest.mark.parametrize("timed", [False, True])
def test_a_span_never_synchronises(monkeypatch, clean, timed):
    def refuse(*args, **kwargs):
        raise AssertionError("a span synchronised the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    profiling.enable(timed)
    with profiling.phase("train.device_block", torch.device("cuda")):
        pass
    with profiling.phase("train.device_block", torch.device("cuda:0")):
        pass
    assert ("train.device_block" in profiling.report()) == timed


def test_a_span_opens_no_annotation_while_no_profiler_records(
        monkeypatch, clean):
    def refuse(*args, **kwargs):
        raise AssertionError("an annotation opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for timed in (False, True):
        profiling.enable(timed)
        with profiling.phase("train.frontend"):
            pass
    assert profiling.report()["train.frontend"]["count"] == 1


def test_counters_count_with_timing_off_and_reset_zeroes_them(clean):
    profiling.count("train.merges")
    profiling.count("train.merges", 4)
    profiling.count("launch.pair_stats", 3)
    assert profiling.counter("train.merges") == 5
    assert profiling.counter("launch.select_unify") == 0
    before = profiling.counters("launch.")
    assert before == {"launch.pair_stats": 3}
    profiling.count("launch.pair_stats", 2)
    profiling.count("launch.merge_apply")
    assert profiling.counted_since(before, "launch.") == {
        "launch.pair_stats": 2, "launch.merge_apply": 1}
    assert profiling.report() == {"train.merges": {"count": 5},
                                  "launch.pair_stats": {"count": 5},
                                  "launch.merge_apply": {"count": 1}}
    profiling.reset()
    assert profiling.counter("train.merges") == 0
    assert profiling.report() == {}


def test_report_keeps_span_entries_beside_counters(clean):
    profiling.enable(True)
    with profiling.phase("train.verify"):
        pass
    with profiling.phase("train.verify"):
        pass
    profiling.count("train.blocks", 2)
    rep = profiling.report()
    assert set(rep) == {"train.verify", "train.blocks"}
    assert set(rep["train.verify"]) == {"total_s", "count", "mean_s"}
    assert rep["train.verify"]["count"] == 2
    assert rep["train.verify"]["mean_s"] == pytest.approx(
        rep["train.verify"]["total_s"] / 2)
    assert rep["train.blocks"] == {"count": 2}


def test_every_caller_calls_phase_through_the_module():
    """No module of the port imports ``phase`` (or ``count``) by name, so
    a caller that swaps ``profiling.phase`` (portbench/devtrace.py's
    ``annotate_phases``) sees every span."""
    found = []
    for path in glob.glob(os.path.join(PACKAGE, "**", "*.py"),
                          recursive=True):
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and \
                    (node.module or "").endswith("profiling"):
                found += [(path, a.name) for a in node.names]
    assert not found, found


def _annotations(fn):
    """The user annotations of one call of ``fn`` under a CPU
    ``torch.profiler``, inside a mark: [(name, start, end)] and the
    mark's (start, end), in microseconds."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(MARK):
                fn()
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    notes = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    mark = next((a, b) for n, a, b in notes if n == MARK)
    return [n for n in notes if n[0] != MARK], mark


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("cls", [FastBPE, FastWP])
def test_a_cpu_train_annotates_the_profiler_nested_as_in_the_code(
        corpus, clean, cls):
    """Under a CPU profiler, with timing off and no help from outside,
    a train shows its spans; the final copy and the symbol lists lie in
    ``train.final_fetch``, and the other spans of the tail outside it;
    the top-level spans cover at least 90 % of the train's wall."""
    notes, (t0, t1) = _annotations(
        lambda: cls(device="cpu").train(corpus, 220))
    names = {n for n, _, _ in notes}
    assert set(SPANS[cls]) <= names, set(SPANS[cls]) - names
    for note in notes:
        if note[0] in NESTED:
            assert any(_inside(note, o) for o in notes
                       if o[0] == NESTED[note[0]]), note
        if note[0] in ("train.close", "train.ranks", "train.trie",
                       "train.frontend", "train.corpus"):
            assert not any(_inside(note, o) for o in notes
                           if o is not note), note
    top = sorted((a, b) for n, a, b in notes
                 if not any(_inside((n, a, b), o) for o in notes
                            if o[1:] != (a, b)))
    covered, end = 0.0, t0
    for a, b in top:
        covered += max(0.0, b - max(a, end))
        end = max(end, b)
    assert covered >= 0.9 * (t1 - t0), (covered, t1 - t0, top)


@pytest.mark.parametrize("cls", [FastBPE, FastWP])
def test_a_cpu_train_counts_its_merges_and_blocks(corpus, clean, cls):
    tok = cls(device="cpu")
    tok.train(corpus, 220)
    merges = tok.merges_list if cls is FastBPE else tok._merge_log
    assert profiling.counter("train.merges") == len(merges) > 0
    # the CPU steps every block through the plain versions: no graph,
    # and no kernel launch counted
    blocks = profiling.counter("train.blocks")
    assert blocks >= 1 and profiling.counter("train.eager_blocks") == blocks
    assert sum(n for k, n in profiling.counters("train.blocks.").items()
               ) == blocks
    assert profiling.counter("train.graph_replays") == 0
    assert profiling.counter("train.graph_captures") == 0
    assert profiling.counters("launch.") == {}
    assert profiling.counter("train.redos") == 0


@pytest.mark.parametrize("cls", [FastBPE, FastWP])
def test_a_swapped_phase_sees_every_span_of_a_train(monkeypatch, corpus,
                                                    clean, cls):
    seen = []

    @contextlib.contextmanager
    def phase(name, device=None):
        seen.append(name)
        yield

    monkeypatch.setattr(profiling, "phase", phase)
    cls(device="cpu").train(corpus, 220)
    assert set(SPANS[cls]) <= set(seen)
    assert seen.index("train.final_copy") < seen.index("train.close") < \
        seen.index("train.symbols")
