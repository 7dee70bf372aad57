"""The long-tail cell ``wp-v30522.zipf200k``: its files as the harness
reads them, its metrics beside the other cells' in ``BENCHMARK.json``,
and a sound run of it on the CPU at a small size."""
import time

import pytest

from conftest import need_card
from portbench import corpus, harness

CELL = "wp-v30522.zipf200k"


def test_the_cell_reads_what_the_cells_beside_it_read():
    """Every cell of ``BENCHMARK.json`` trains, and the long-tail cell
    reports the same metrics as each of them, ``kernel_ps_per_slot``
    among its traced ones."""
    bench = harness.cell_files(CELL)[0]
    for trace in (False, True):
        mine = [m["name"] for m in harness.cell_metrics(bench, CELL, trace)]
        for w in bench["workloads"]:
            assert [m["name"] for m in harness.cell_metrics(
                bench, w["name"], trace)] == mine
    assert "kernel_ps_per_slot" in mine


def test_the_cells_files():
    bench, entry, cell, config, mix = harness.cell_files(CELL)
    assert (config["tokenizer"], config["max_vocab"]) == ("FastWP", 30522)
    assert config["reduced"] == ["corpus_sentences"]
    assert config["corpus_sentences"] == mix["sentences"] == 160_000
    assert len(corpus.load_source(mix)) == mix["sentences"]


def test_a_small_traced_run_is_correct():
    """The cell's traced run on the port's plain versions at a small
    size: correct, and on the CPU, where no kernel runs, without
    ``kernel_ps_per_slot``."""
    bench, entry, cell, config, mix = harness.cell_files(CELL)
    files = (bench, entry, cell, dict(config, max_vocab=300),
             dict(mix, sentences=100))
    res = harness.run(CELL, 2 ** 31 + 25, 0.01, True, time.perf_counter(),
                      device="cpu", files=files, check_chip=False)
    assert res["correct"] and res["attempted"] == 2
    assert "tail_ms" in res["metrics"]
    assert "kernel_ps_per_slot" not in res["metrics"]


@pytest.mark.chip
def test_the_cell_on_the_card_reads_the_state_size():
    """A traced run of the cell on the card at its own size: correct,
    with ``kernel_ps_per_slot`` read and a memory peak past 150 MB."""
    need_card()
    res = harness.run(CELL, 3925000099, 1.0, True, time.perf_counter())
    assert res["correct"]
    assert res["metrics"]["kernel_ps_per_slot"]["value"] > 0
    assert res["device"]["memory_peak_bytes"] > 150 * 10 ** 6
