"""The long-tailed corpus (``tools/gen_longtail.py``, ``data/longtail-160k
.json``) and the benchmark's reader of the training state's size
(``portbench/metrics/kernel_ps_per_slot.py``): the generator gives the
same sentences for the same seed and others for another, keeps to the
stand-in's characters and grows its word types past the stand-in's;
the committed file is the one the traffic mix freezes; the reader reads
a planted reading, and nothing without the program's counter."""
import hashlib
import json
import os
import sys

import pytest

from portbench import harness
from portbench.reference import pretok

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import gen_longtail  # noqa: E402

MIX = os.path.join(ROOT, "portbench", "traffic", "zipf200k.json")


@pytest.fixture(scope="module")
def small():
    """2,000 sentences of seed 5 over a 30,000-word lexicon."""
    return gen_longtail.generate(5, 2000, 30_000)


def test_same_seed_same_sentences_other_seed_others(small):
    assert len(small) == 2000
    assert gen_longtail.generate(5, 2000, 30_000) == small
    assert gen_longtail.generate(6, 2000, 30_000) != small


def test_words_beyond_the_stand_in_in_its_characters(small):
    """The head is the stand-in's 22,971 word types but its 26
    punctuation characters, by count; every other word is new, 2 to the
    longest type's length long; the characters are the stand-in's."""
    source, punct, head = gen_longtail.stand_in()
    assert len(head) == 22_971 - 26
    marks = punct & set("".join(source))
    assert len(marks) == 26 and not marks & set(head)
    words = pretok.count_words(small)
    chars = {c for w in head for c in w} | marks
    assert len(chars) == 78
    assert {c for w in words for c in w} <= chars
    known = set(head) | marks
    new = [w for w in words if w not in known]
    assert len(new) >= 100
    assert all(2 <= len(w) <= max(map(len, head)) for w in new)


def test_committed_source_is_the_mixs():
    with open(MIX, encoding="utf-8") as f:
        mix = json.load(f)
    with open(os.path.join(ROOT, mix["source"]), "rb") as f:
        raw = f.read()
    assert hashlib.sha256(raw).hexdigest() == mix["sha256"]
    assert len(raw) <= 16 * 2 ** 20
    assert len(json.loads(raw.decode("utf-8"))) == mix["sentences"] == 160_000


class _Trace:
    def __init__(self, kernels):
        self.kernels = kernels


TRACE = _Trace({"pair_insert_kernel": (20224, 0.40),
                "select_kernel<false>": (20224, 0.35),
                "merge_tiles_kernel<false>": (20224, 0.25),
                "symbol_freqs_kernel": (1, 0.001)})


def reading(phases, trace=TRACE):
    return harness.Reading(task=None, setup_s=0.0, phases=phases,
                           trace=trace)


@pytest.mark.parametrize("phases,trace,want", [
    ({"train.live_slots": {"count": 10 ** 10}}, TRACE, 1.0 / 1e10 * 1e12),
    ({"train.live_slots": {"count": 2 * 10 ** 10},
      "train.slots": {"count": 1_800_000}}, TRACE, 50.0),
    ({"train.slots": {"count": 1_800_000}}, TRACE, None),
    ({"train.live_slots": {"count": 0}}, TRACE, None),
    ({"train.live_slots": {"count": 10 ** 10}}, _Trace({}), None),
    ({"train.live_slots": {"count": 10 ** 10}}, None, None),
    ({}, TRACE, None), (None, TRACE, None)])
def test_kernel_ps_per_slot(phases, trace, want):
    got = harness.reader("kernel_ps_per_slot")(reading(phases, trace))
    assert got == pytest.approx(want) if want is not None else got is None
