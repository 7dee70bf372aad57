"""The control of the comparison that decides ``correct``, at a cell's
own size: a run of the cell whose task is turned into its control by the
task's own ``control`` (``tasks/<task>.py``): for ``train`` the plain
trainer in a lower precision or with its tie-break broken, put in the
program's place; for ``encode`` the port loaded with one vocabulary
entry left out.

Each control run has to come out not correct. It is read on the card's
machine at the cell's size, as the benchmark's runs are:

    python3 -m portbench.control bpe-v20000.t85k ... --seeds 1 2 3 \
        [--seconds 30] [--procs 1]

prints one JSON line a run: the cell, the seed, ``calls_wrong`` of the
run and how many calls it compared. ``--seconds`` is the window: a train
cell's control needs one call (the default), an encode cell's the
cell's own window, so that it compares as many calls as a run does. The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import time


def one(args):
    """(cell, seed, seconds) -> the control run's reading."""
    name, seed, seconds = args
    from portbench import harness
    mod = harness.task_module(harness.cell_files(name)[3])
    init = mod.Task.__init__

    def controlled(self, *a, **kw):
        init(self, *a, **kw)
        mod.control(self)

    mod.Task.__init__ = controlled
    t0 = time.perf_counter()
    res = harness.run(name, seed, seconds, False, t0)
    check = res["checks"]["calls_wrong"]
    return {"cell": name, "seed": seed, "correct": res["correct"],
            "calls_wrong": check["value"], "of": check["of"],
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cells", nargs="+")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.001)
    p.add_argument("--procs", type=int, default=3)
    args = p.parse_args(argv)
    jobs = [(c, s, args.seconds) for c in args.cells for s in args.seeds]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(args.procs) as pool:
        for got in pool.imap(one, jobs):
            print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
