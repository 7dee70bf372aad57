"""Tests of the benchmark itself (``python -m pytest portbench/tests``).

Tests marked ``chip`` need an NVIDIA card; each decides inside itself
whether one is there and skips otherwise."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card; skips without one")


@pytest.fixture(scope="session")
def t85k_mix():
    with open(os.path.join(ROOT, "portbench", "traffic", "t85k.json")) as f:
        return json.load(f)


@pytest.fixture(scope="session")
def source(t85k_mix):
    from portbench import corpus
    return corpus.load_source(t85k_mix)


@pytest.fixture(scope="session")
def source_counts(source):
    """Word types of the whole source file, unresampled."""
    from portbench.reference import pretok
    return pretok.count_words(source)


def golden(name):
    with open(os.path.join(ROOT, "tests", "golden", name),
              encoding="utf-8") as f:
        return json.load(f)


def need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


ENCODE_CELL = "wp-v20000-encode.b1000"
# the encode cell's metrics, as BENCHMARK.json would hold them once the
# cell is in it (PERF.md, section 7)
ENCODE_METRICS = {
    "end_to_end": [
        {"name": "encode_mbps", "unit": "MB/s", "better": "higher",
         "bound": 0.25, "source": "host_clock"}],
    "per_layer": [
        {"name": "enc_frontend_ms", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "encode front end",
         "moves": "encode_mbps"},
        {"name": "enc_device_ms", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "encode device path",
         "moves": "encode_mbps"},
        {"name": "enc_stitch_ms", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "encode stitch",
         "moves": "encode_mbps"},
        {"name": "enc_scan_roofline", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "kernels",
         "moves": "encode_mbps"},
        {"name": "device_idle.encode", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "encode_mbps"}]}


def encode_files(sentences=None):
    """The encode cell's files (``harness.cell_files``' tuple) from
    ``portbench/``, with BENCHMARK.json's entries for the cell, its
    configuration and its metrics planted beside the others; the mix cut
    to ``sentences`` where given."""
    def load(*parts):
        with open(os.path.join(ROOT, "portbench", *parts)) as f:
            return json.load(f)
    cell = load("workloads", ENCODE_CELL + ".json")
    config = load("configs", cell["config"] + ".json")
    mix = load("traffic", cell["traffic"] + ".json")
    if sentences:
        mix = dict(mix, sentences=sentences)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = dict(cell, name=ENCODE_CELL)
    mine = {k: [dict(m, workloads=[ENCODE_CELL]) for m in v]
            for k, v in ENCODE_METRICS.items()}
    bench = dict(
        bench, workloads=bench["workloads"] + [entry],
        configs=bench["configs"] + [{
            "name": config["name"], "source": config["source"],
            "file": f"portbench/configs/{config['name']}.json",
            "reduced": config["reduced"], "why": "FastWP's batched encode"}],
        end_to_end=bench["end_to_end"] + mine["end_to_end"],
        per_layer=bench["per_layer"] + mine["per_layer"])
    return bench, entry, cell, config, mix
