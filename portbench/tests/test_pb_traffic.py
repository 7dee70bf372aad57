"""The seeded draw of the traffic mixes."""
import json
import os

import pytest

from conftest import ROOT
from portbench import corpus
from portbench.reference import pretok


def mix(name):
    with open(os.path.join(ROOT, "portbench", "traffic", name + ".json")) as f:
        return json.load(f)


def test_same_seed_same_corpus_other_seed_other(source):
    m = dict(mix("t85k"), sentences=5000)
    seed = 2 ** 31 + 2 ** 20 + 11  # larger than 32 signed bits hold
    a, b = corpus.draw(m, seed, source), corpus.draw(m, seed, source)
    c = corpus.draw(m, seed + 1, source)
    assert a.sentences == b.sentences and a.draw == b.draw
    assert len(a.sentences) == 5000
    assert a.draw != c.draw
    assert a.sentences == [source[i] for i in a.draw]


def test_mixes_draw_their_sizes_from_the_frozen_source(source):
    m85, m340 = mix("t85k"), mix("t340k")
    assert (m85["sentences"], m340["sentences"]) == (85_000, 340_000)
    assert m85["source"] == m340["source"] == "data/train-85k.json"
    c = corpus.draw(m85, 7, source)
    assert len(c.sentences) == 85_000
    assert 7_000_000 < sum(len(s.encode()) for s in c.sentences) < 7_800_000


def test_t340k_keeps_t85k_word_types(source, source_counts):
    """t340k is t85k's word types with about four times the counts; the
    draw keeps nearly every word type of the source."""
    m85, m340 = mix("t85k"), mix("t340k")
    for seed in (1, 2 ** 33 + 5):
        w85 = pretok.count_drawn(source, corpus.draw(m85, seed, source).draw)
        w340 = pretok.count_drawn(source,
                                  corpus.draw(m340, seed, source).draw)
        assert set(w340) <= set(source_counts)
        assert len(w340) >= 0.999 * len(source_counts)
        assert len(w85) >= 0.995 * len(source_counts)
        ratio = sum(w340.values()) / sum(w85.values())
        assert 3.9 < ratio < 4.1


def test_another_source_file_is_refused(tmp_path):
    path = tmp_path / "other.json"
    path.write_text(json.dumps(["a b c"]))
    m = dict(mix("t85k"), source=os.path.relpath(path, ROOT))
    with pytest.raises(ValueError, match="sha256"):
        corpus.load_source(m)
