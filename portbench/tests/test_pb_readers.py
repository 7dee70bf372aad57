"""The readers of the program's spans and counters, on planted
``Reading.phases`` (the phase timer's report of one train): what each
reads, and that each reads nothing where the program has no such span
or counter, as a program without them gives."""
import time

import pytest

from portbench import harness


def span(total_s):
    return {"total_s": total_s, "count": 1, "mean_s": total_s}


def reading(phases):
    return harness.Reading(task=None, setup_s=0.0, phases=phases)


OLD = {"train.frontend": span(0.3), "train.corpus": span(0.07),
       "train.fetch_records": span(0.05), "train.final_fetch": span(0.2),
       "train.capture": span(0.1)}
NEW = dict(OLD, **{
    "train.final_copy": span(0.004), "train.close": span(0.05),
    "train.symbols": span(0.15), "train.ranks": span(0.006),
    "launch.pair_stats": {"count": 20224},
    "launch.select_unify": {"count": 20224},
    "launch.select_unify.wp": {"count": 20224},
    "launch.merge_apply": {"count": 20224},
    "launch.merge_apply.wp": {"count": 20224},
    "launch.symbol_freqs": {"count": 1},
    "train.merges": {"count": 19879}, "train.blocks": {"count": 79}})


@pytest.mark.parametrize("phases,want", [
    (NEW, 4 + 50 + 150 + 6),
    (dict(NEW, **{"train.trie": span(0.3)}), 4 + 50 + 150 + 6 + 300),
    ({"train.close": span(0.002)}, 2),
    (OLD, None), ({}, None), (None, None)])
def test_tail_ms(phases, want):
    got = harness.reader("tail_ms")(reading(phases))
    assert got == pytest.approx(want) if want is not None else got is None


@pytest.mark.parametrize("phases,want", [
    (NEW, (3 * 20224 + 1) / 19879),
    (dict(NEW, **{"train.merges": {"count": 0}}), None),
    ({k: v for k, v in NEW.items() if k != "train.merges"}, None),
    ({k: v for k, v in NEW.items() if not k.startswith("launch.")}, None),
    (OLD, None), ({}, None), (None, None)])
def test_launches_per_merge(phases, want):
    got = harness.reader("launches_per_merge")(reading(phases))
    assert got == pytest.approx(want) if want is not None else got is None


def test_traced_run_reads_the_tail():
    """A traced run on the CPU at a small size reports ``tail_ms``; the
    plain versions launch no kernel, so ``launches_per_merge`` reads
    nothing there."""
    name = "bpe-v20000.t85k"
    bench, entry, cell, config, mix = harness.cell_files(name)
    files = (bench, entry, cell, dict(config, max_vocab=200),
             dict(mix, sentences=300))
    res = harness.run(name, 2 ** 31 + 7, 0.01, True, time.perf_counter(),
                      device="cpu", files=files, check_chip=False)
    assert res["correct"]
    assert res["metrics"]["tail_ms"]["value"] > 0
    assert res["metrics"]["tail_ms"]["unit"] == "ms"
    assert "launches_per_merge" not in res["metrics"]
