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
