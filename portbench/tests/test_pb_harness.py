"""The harness as data drives it: a task picked by a configuration's name,
the check kept outside the calls' times, and metrics kept to the cells
they list."""
import json
import os
import shutil
import sys
import time

import pytest

from conftest import ENCODE_CELL, ROOT, encode_files
from portbench import harness

PLANTED_TASK = '''
"""A planted task: each sentence of a batch reversed."""
import hashlib


class Task:
    def __init__(self, config, corpus, mix, device):
        size = int(mix["batch"])
        s = corpus.sentences
        self.batches = [s[i:i + size] for i in range(0, len(s), size)]
        self.batch_bytes = [sum(len(t.encode()) for t in b)
                            for b in self.batches]
        self.call_s, self.keep_s = config["call_s"], config["keep_s"]
        self.clock = config.get("clock")
        self.next = 0

    def warm(self):
        self.once()

    def once(self):
        if self.clock:
            self.clock.t += self.call_s
        i = self.next
        self.next = (i + 1) % len(self.batches)
        return i, [t[::-1] for t in self.batches[i]]

    def keep(self, output):
        if self.clock:
            self.clock.t += self.keep_s
        i, out = output
        return i, hashlib.sha256("\\n".join(out).encode()).hexdigest()

    def route_error(self, phases):
        return None

    def reference(self, record_states=False):
        return [hashlib.sha256("\\n".join(t[::-1] for t in b).encode())
                .hexdigest() for b in self.batches]

    def wrong(self, kept, expected):
        return sum(1 for i, d in kept if d != expected[i])


def control(task):
    task.once = lambda: (0, [])
'''


@pytest.fixture
def planted(tmp_path, monkeypatch):
    """A checkout's benchmark files with a planted task, configuration,
    mix and cell added (and nothing of the harness edited), the harness
    pointed at them."""
    bench = tmp_path / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench", "metrics"),
                    bench / "metrics")
    for d in ("tasks", "configs", "traffic", "workloads"):
        (bench / d).mkdir()
    (bench / "tasks" / "planted.py").write_text(PLANTED_TASK)
    config = {"name": "planted", "task": "planted", "call_s": 0.5,
              "keep_s": 0.0}
    (bench / "configs" / "planted.json").write_text(json.dumps(config))
    with open(os.path.join(ROOT, "portbench", "traffic",
                           "t85k.json")) as f:
        mix = dict(json.load(f), sentences=300, batch=100)
    (bench / "traffic" / "p100.json").write_text(json.dumps(mix))
    cell = {"config": "planted", "traffic": "p100", "chips": 1,
            "why": "planted"}
    (bench / "workloads" / "planted.p100.json").write_text(json.dumps(cell))
    real = encode_files()[0]
    e2e = {m["name"]: m for m in real["end_to_end"]}
    bench_json = dict(real, configs=[{
        "name": "planted", "source": "planted",
        "file": "portbench/configs/planted.json", "reduced": [],
        "why": "planted"}], workloads=[dict(cell, name="planted.p100")],
        end_to_end=[dict(e2e[n], workloads=["planted.p100"])
                    for n in ("vocab_s", "encode_mbps", "setup_s")],
        per_layer=[])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    monkeypatch.setattr(harness, "BENCH", str(bench))
    monkeypatch.delitem(sys.modules, "portbench.tasks.planted",
                        raising=False)
    return tmp_path


def test_a_planted_task_runs_with_files_added_alone(planted):
    res = harness.run("planted.p100", 2 ** 31 + 5, 0.05, False,
                      time.perf_counter(), device="cpu", check_chip=False)
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"vocab_s", "encode_mbps", "setup_s"}
    assert harness.task_module(
        harness.cell_files("planted.p100")[3]).__file__ == str(
        planted / "portbench" / "tasks" / "planted.py")


class Clock:
    """A planted clock: time moves only where the planted task moves it."""

    def __init__(self):
        self.t = 1000.0

    def perf_counter(self):
        return self.t


@pytest.mark.parametrize("keep_s", [0.0, 7.0])
def test_a_slow_keep_moves_no_metric(planted, keep_s, monkeypatch):
    """Each call takes 0.5 s on the planted clock; a keep of 7 s between
    calls leaves ``vocab_s`` and ``encode_mbps`` where a free one does."""
    clock = Clock()
    monkeypatch.setattr(harness, "time", clock)
    files = list(harness.cell_files("planted.p100"))
    files[3] = dict(files[3], keep_s=keep_s, clock=clock)
    res = harness.run("planted.p100", 2 ** 31 + 5, 30.0, False, 0.0,
                      device="cpu", files=tuple(files), check_chip=False)
    assert res["correct"]
    calls = res["attempted"]  # the window's 30 s hold fewer calls
    assert calls == (60 if keep_s == 0 else 5)
    assert res["call_s"] == [0.5] * calls
    assert res["metrics"]["vocab_s"]["value"] == 0.5
    sents = harness.corpus_mod.draw(files[4], 2 ** 31 + 5).sentences
    size = [sum(len(s.encode()) for s in sents[i:i + 100])
            for i in (0, 100, 200)]
    done = sum(size[(1 + k) % 3] for k in range(calls))  # warm-up: 0
    assert res["metrics"]["encode_mbps"]["value"] == pytest.approx(
        done / (0.5 * calls) / 1e6, rel=1e-12)


def test_a_planted_control_is_not_correct(planted, monkeypatch):
    mod = harness.task_module(harness.cell_files("planted.p100")[3])
    init = mod.Task.__init__

    def controlled(self, *a, **kw):
        init(self, *a, **kw)
        mod.control(self)
    monkeypatch.setattr(mod.Task, "__init__", controlled)
    res = harness.run("planted.p100", 3, 0.05, False, time.perf_counter(),
                      device="cpu", check_chip=False)
    assert not res["correct"] and res["failed"] == res["attempted"]


def test_metrics_keep_to_the_cells_they_list():
    """The training metrics list the training cells; with the encode
    cell's entries planted, each cell reads its own metrics alone."""
    bench = encode_files()[0]
    enc = ENCODE_CELL
    train = [w["name"] for w in bench["workloads"] if w["name"] != enc]
    assert len(train) == 4
    for name in train:
        assert [m["name"] for m in harness.cell_metrics(bench, name, False)
                ] == ["vocab_s", "setup_s"]
        assert {m["name"] for m in harness.cell_metrics(bench, name, True)
                } == {"frontend_ms", "corpus_ms", "capture_ms",
                      "fetch_wait_ms", "kernel_us_per_merge",
                      "kernel_roofline", "device_idle", "tail_ms",
                      "launches_per_merge"}
    assert [m["name"] for m in harness.cell_metrics(bench, enc, False)] == [
        "setup_s", "encode_mbps"]
    assert {m["name"] for m in harness.cell_metrics(bench, enc, True)} == {
        "enc_frontend_ms", "enc_device_ms", "enc_stitch_ms",
        "enc_scan_roofline", "device_idle.encode"}
    # a metric without the key is in every cell, those added later too
    extra = dict(bench, end_to_end=bench["end_to_end"] + [
        {"name": "x", "unit": "s", "better": "lower", "bound": 0.1,
         "source": "host_clock"}])
    assert all(any(m["name"] == "x" for m in
                   harness.cell_metrics(extra, w, False))
               for w in train + [enc, "later.cell"])


def test_each_metric_that_lists_cells_is_read_there():
    """Every cell a metric lists reports the end-to-end metric it moves,
    and every metric has a reader: in BENCHMARK.json, and with the
    encode cell's entries planted."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        real = json.load(f)
    for bench in (real, encode_files()[0]):
        cells = {w["name"] for w in bench["workloads"]}
        for m in bench["per_layer"]:
            for w in m["workloads"]:
                assert w in cells
                assert m["moves"] in {
                    e["name"] for e in harness.cell_metrics(bench, w, False)}
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] != "setup_s":
                assert callable(harness.reader(m["name"]))
