"""The control of the comparison that decides ``correct``, at a cell's
own size: a run of the cell whose calls are the plain trainer in the
control's form, put in the program's place.

- WordPiece (whose configuration states a float64 score): the scores in
  float32, the precision below it;
- BPE (whose counts are exact integers and state no precision): the
  stated tie-break broken, ties going to the smaller symbol ids (the
  order a selection over a hash table of pairs gives) instead of the
  pair met first in scan order.

Each control run has to come out not correct. It needs no card for its
calls, but is read on the card's machine at the cell's size, as the
benchmark's runs are:

    python3 -m portbench.control bpe-v20000.t85k ... --seeds 1 2 3

prints one JSON line a run: the cell, the seed, ``calls_wrong`` of the
run and how many merges of its first call differ from the reference's.
The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import time

VARIANT = {False: "pair_order", True: "float32"}


def once(task):
    """A stand-in for ``tasks/train.Task.once``: the plain trainer in the
    control's form, on the task's corpus."""
    from portbench.reference import pretok, trainer
    got = trainer.train(
        pretok.count_drawn(task.corpus.source, task.corpus.draw),
        task.max_vocab, task.wordpiece, variant=VARIANT[task.wordpiece])
    return got.merges, (got.vocab if task.wordpiece else None)


def one(args):
    """(cell, seed) -> the control run's reading, with how many merges of
    its window's last call differ from the reference's."""
    name, seed = args
    from portbench import corpus, harness
    from portbench.tasks import train as train_task
    calls = []

    def recorded(task):
        out = once(task)
        calls.append(out[0])
        return out

    train_task.Task.once = recorded
    t0 = time.perf_counter()
    res = harness.run(name, seed, 0.001, False, t0)
    _, _, _, config, mix = harness.cell_files(name)
    ref = train_task.Task(config, corpus.draw(mix, seed), "cpu").reference()
    differ = sum(a != b for a, b in zip(calls[-1], ref.merges)) + abs(
        len(calls[-1]) - len(ref.merges))
    check = res["checks"]["calls_wrong"]
    return {"cell": name, "seed": seed, "correct": res["correct"],
            "calls_wrong": check["value"], "of": check["of"],
            "merges_differing": differ, "merges": len(ref.merges),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cells", nargs="+")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--procs", type=int, default=3)
    args = p.parse_args(argv)
    jobs = [(c, s) for c in args.cells for s in args.seeds]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(args.procs) as pool:
        for got in pool.imap(one, jobs):
            print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
