"""The benchmark's core: one run of one cell.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (from the checkout's root) runs the cell once on the
card and prints one JSON line as the last line of its standard output.

Everything of one cell is found by name (``BENCHMARK.json`` at the
root, and the files under ``portbench/``), so adding a cell, a
configuration, a traffic mix or a metric adds files and edits none:

- ``workloads/<cell>.json``: the cell's ``config``, ``traffic`` and
  ``chips`` (as ``BENCHMARK.json`` names them);
- ``configs/<config>.json``: the parameters of the one task,
  ``tasks/train.py``, which makes one call of the program and checks it;
- ``traffic/<mix>.json``: the parameters of the one generator,
  ``corpus.py``;
- ``metrics/<metric>.py``: each metric's reader, ``read(reading)``,
  returning the number or None where it finds nothing to read; every
  metric but ``setup_s``, which this module takes.

A run: the corpus is drawn from the seed; the task's first call, which
builds and loads the kernels (from the program's fixed build directories
in the checkout) and captures its graphs, is the warm-up; ``setup_s`` is
the time from the process's start to the warm-up's end. With ``--trace
0`` calls then run back to back until ``--seconds`` have passed (the
last call started in time finishes); with ``--trace 1`` one call runs
under ``torch.profiler`` with the program's phases as host annotations
(after an untraced one), then one with the program's phase timer on,
whose synchronisations so never reach the trace. Once the calls are
done the peak device memory is read, the program's state is freed, and
every call's output is compared with the plain reference's, and the
metrics are read. Then no module of JAX, jaxlib, flax or the JAX package
may have been loaded, or the run gives no result.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import List, Optional

from . import corpus as corpus_mod
from .tasks.train import Task

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# no module of these may be loaded: top-level names, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "subword_tokenizers_tpu")


class RunError(Exception):
    """A run that cannot give a result; its message goes to stderr."""


@dataclass
class Reading:
    """What a metric's reader reads."""

    task: object
    setup_s: float
    calls: int = 0             # calls in the measured window
    window_s: float = 0.0      # from the first call's start to the last's end
    phases: Optional[dict] = None  # the phase timer's report of one call
    trace: Optional[object] = None  # devtrace.Trace of one traced call
    call_s: Optional[List[float]] = None  # each window call's seconds
    traced_work: int = 0       # the traced call's work
    reference: Optional[object] = None  # the reference's result

    def phase_ms(self, *names: str) -> Optional[float]:
        """Milliseconds the phase-timed call spent in the program's
        phases ``names`` (0 for one it never entered); None without that
        call."""
        if not self.phases:
            return None
        return 1e3 * sum(self.phases[n]["total_s"] for n in names
                         if n in self.phases)

    def kernel_s(self, *parts: str) -> float:
        """Device seconds of the traced call's kernels whose names hold
        one of ``parts``."""
        return sum(s for name, (_, s) in self.trace.kernels.items()
                   if any(p in name for p in parts))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def load_json(*parts) -> dict:
    path = os.path.join(*parts)
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def cell_files(name: str):
    """(BENCHMARK.json, its workload entry, the cell's file, the
    configuration, the traffic mix) of cell ``name``."""
    bench = load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    cell = load_json(BENCH, "workloads", name + ".json")
    for key in ("config", "traffic", "chips"):
        if cell.get(key) != entry[key]:
            raise RunError(f"workloads/{name}.json: {key} {cell.get(key)!r}"
                           f", BENCHMARK.json says {entry[key]!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT, conf["file"])
    mix = load_json(BENCH, "traffic", entry["traffic"] + ".json")
    return bench, entry, cell, config, mix


def cell_metrics(bench: dict, name: str, trace: bool) -> List[dict]:
    """The metrics a run of cell ``name`` reports: end-to-end without a
    trace, per-layer with one; each in every cell, or in the cells it
    lists under ``workloads``."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(BENCH, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run(name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", files=None, check_chip: bool = True) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``device``, ``files`` (:func:`cell_files`'s tuple) and ``check_chip``
    are for the CPU tests, which run the rest of a run on the port's
    plain versions at a small size."""
    bench, entry, cell, config, mix = files or cell_files(name)
    import torch
    if check_chip:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device")
        if torch.cuda.device_count() < entry["chips"]:
            raise RunError(f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell wants {entry['chips']}")
    cuda = device.startswith("cuda")
    data = corpus_mod.draw(mix, seed)
    task = Task(config, data, device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    task.once()
    sync()
    r = Reading(task=task, setup_s=time.perf_counter() - t_start)
    outputs = []
    if not trace:
        ends = [time.perf_counter()]
        deadline = ends[0] + seconds
        while ends[-1] < deadline:
            outputs.append(task.once())
            sync()
            ends.append(time.perf_counter())
        r.calls, r.window_s = len(outputs), ends[-1] - ends[0]
        r.call_s = [b - a for a, b in zip(ends, ends[1:])]
    else:
        from subword_tokenizers_tpu_torch.benchmarks import profiling
        from . import devtrace
        with devtrace.annotate_phases(profiling):
            out, r.trace = devtrace.trace_call(task.once, cuda)
        outputs.append(out)
        r.traced_work = task.work(out)
        profiling.reset()
        profiling.enable(True)
        try:
            outputs.append(task.once())
            sync()
        finally:
            profiling.enable(False)
        r.phases = profiling.report()
        profiling.reset()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    r.reference = task.reference(record_states=trace)
    wrong = task.wrong(outputs, r.reference)

    metrics = {}
    for m in cell_metrics(bench, name, trace):
        value = r.setup_s if m["name"] == "setup_s" else reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": entry["chips"], "memory_peak_bytes": peak}
    result = {"correct": wrong == 0, "attempted": len(outputs),
              "failed": wrong, "metrics": metrics, "device": dev}
    if r.call_s:
        result["call_s"] = r.call_s
    if trace:
        t = r.trace
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        ops = sorted(t.device_ops.items(), key=lambda kv: -kv[1][1])
        result["breakdown"] = {
            "device_ops": [[k, v[1]] for k, v in ops[:10]],
            "idle_gaps": [[k, v] for k, v in t.idle_gaps[:10]]}
    result["checks"] = {"calls_wrong": {"value": wrong, "limit": 0,
                                        "of": len(outputs)}}
    # last: the reference and every reader have run by now
    found = forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package are loaded: "
                       f"{found}")
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    if t_start is None:
        t_start = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start)
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']}, of "
              f"{c['of']})", file=sys.stderr, flush=True)
    return 0
