"""The run's contract around the measurement: what it imports, where it
refuses to give a result, and how a trace is reduced."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, need_card
from portbench import devtrace, harness

PROBE = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from portbench import harness
bench, entry, cell, config, mix = harness.cell_files(sys.argv[2])
files = (bench, entry, cell, dict(config, max_vocab=200),
         dict(mix, sentences=300))
res = harness.run(sys.argv[2], 5, 0.01, True, time.perf_counter(),
                  device="cpu", files=files, check_chip=False)
print(json.dumps({"correct": res["correct"], "modules": sorted(sys.modules)}))
"""


@pytest.mark.parametrize("name", ["bpe-v20000.t85k", "wp-v20000.t85k"])
def test_a_run_imports_no_jax(name):
    """Every module a run imports (a traced run, on the CPU at a small
    size, in a fresh process), by top-level name compared whole: nothing
    of JAX or of the JAX package, whose name begins the port's."""
    out = subprocess.run([sys.executable, "-c", PROBE, ROOT, name],
                         capture_output=True, text=True, check=True,
                         cwd=ROOT, timeout=600)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    tops = {m.split(".", 1)[0] for m in got["modules"]}
    assert "subword_tokenizers_tpu_torch" in tops and "torch" in tops
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


LEAK = r"""
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[3]]
from portbench import harness
bench, entry, cell, config, mix = harness.cell_files(sys.argv[2])
bench = dict(bench, end_to_end=bench["end_to_end"] + [
    {"name": "leak", "unit": "s", "better": "lower", "bound": 0.1,
     "source": "host_clock"}])
harness.BENCH = sys.argv[4]
files = (bench, entry, cell, dict(config, max_vocab=200),
         dict(mix, sentences=300))
try:
    res = harness.run(sys.argv[2], 5, 0.01, False, time.perf_counter(),
                      device="cpu", files=files, check_chip=False)
except harness.RunError as e:
    print("refused:", e)
else:
    print(json.dumps(res))
"""


def test_a_reader_that_loads_jax_gives_no_result(tmp_path):
    """A metric's reader runs after the window and the reference; one
    that imports a module of a forbidden name (here a stand-in ``flax``)
    still leaves the run without a result."""
    stubs = tmp_path / "stubs" / "flax"
    stubs.mkdir(parents=True)
    (stubs / "__init__.py").write_text("")
    bench = tmp_path / "bench"
    for d in ("metrics", "tasks"):
        shutil.copytree(os.path.join(ROOT, "portbench", d), bench / d)
    (bench / "metrics" / "leak.py").write_text(
        "import flax  # noqa: F401\n\n\ndef read(r):\n    return 1.0\n")
    out = subprocess.run(
        [sys.executable, "-c", LEAK, ROOT, "bpe-v20000.t85k",
         str(tmp_path / "stubs"), str(bench)], capture_output=True,
        text=True, check=True, cwd=ROOT, timeout=600)
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("refused:") and "'flax'" in last, last


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "subword_tokenizers_tpu_torchx", None)
    assert "subword_tokenizers_tpu_torchx" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "subword_tokenizers_tpu.models", None)
    assert harness.forbidden_modules() == ["subword_tokenizers_tpu.models"]


def cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "bpe-v20000.t85k",
         "--seed", "3", "--seconds", "1", *extra], capture_output=True,
        text=True, cwd=cwd, timeout=600)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = cli(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_unknown_cell_is_refused():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "nope", "--seed",
         "1", "--seconds", "1"], capture_output=True, text=True, cwd=ROOT,
        timeout=600)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.chip
def test_benchmark_files_alone_give_no_result(tmp_path):
    """In a directory of BENCHMARK.json and portbench/ alone (no program,
    no corpus) a run fails and prints no result."""
    need_card()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    out = cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.chip
@pytest.mark.parametrize("name", ["bpe-v20000.t85k", "wp-v20000.t85k",
                                  "bpe-v20000.t340k", "wp-v20000.t340k"])
def test_cell_runs_correct_on_the_card(name):
    need_card()
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 3), "--seconds", "1"], capture_output=True,
        text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


def test_trace_reduction():
    """Busy time is the union of device spans inside the traced call; gaps
    are named by the phase covering most of them."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.MARK,
         "ts": 100, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#1",
         "ts": 90, "dur": 120},
        {"ph": "X", "cat": "user_annotation", "name": "train.frontend",
         "ts": 101, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)"
         "::k1<(bool)0>(int const*, long)", "ts": 140, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k2(int)", "ts": 145,
         "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> "
         "Pinned)", "ts": 180, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "k2(int)", "ts": 50,
         "dur": 10},  # the untraced call's: outside the window
    ]
    t = devtrace.reduce(ev)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(20e-6)
    assert t.kernels == {"k1<(bool)0>": [1, pytest.approx(10e-6)],
                         "k2": [1, pytest.approx(10e-6)]}
    assert set(t.device_ops) == {"k1<(bool)0>", "k2",
                                 "Memcpy DtoH (Device -> Pinned)"}
    assert [g[0] for g in t.idle_gaps] == ["train.frontend", "host", "host"]
    assert [round(g[1] * 1e6) for g in t.idle_gaps] == [40, 25, 15]


def test_a_gap_is_named_by_the_innermost_span_over_half_of_it():
    """A gap inside ``train.symbols``, which lies inside
    ``train.final_fetch``: the outer span overlaps it most (as much as the
    inner, and more where the inner stops short), yet the gap bears the
    inner one's name. A gap that no span covers by half takes the one
    that covers most of it."""
    def note(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name,
                "ts": ts, "dur": dur}
    ev = [note(devtrace.MARK, 0, 1000),
          note("train.final_fetch", 100, 800),
          note("train.final_copy", 100, 20),
          note("train.symbols", 130, 760),
          note("train.close", 905, 20),
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 110,
           "dur": 15},
          {"ph": "X", "cat": "kernel", "name": "k()", "ts": 900, "dur": 100}]
    t = devtrace.reduce(ev)
    # gaps: 125-900 (775: symbols 760, final_fetch 775), 0-110 (110:
    # final_fetch and final_copy cover 10 of it each)
    assert [(g[0], round(g[1] * 1e6)) for g in t.idle_gaps] == [
        ("train.symbols", 775), ("train.final_copy", 110)]
