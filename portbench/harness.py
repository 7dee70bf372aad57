"""The benchmark's core: one run of one cell.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (from the checkout's root) runs the cell once on the
card and prints one JSON line as the last line of its standard output.

Everything of one cell is found by name (``BENCHMARK.json`` at the
root, and the files under ``portbench/``), so adding a cell, a
configuration, a task, a traffic mix or a metric adds files and edits
none:

- ``workloads/<cell>.json``: the cell's ``config``, ``traffic`` and
  ``chips`` (as ``BENCHMARK.json`` names them);
- ``configs/<config>.json``: the parameters of its ``task`` (default
  ``train``);
- ``tasks/<task>.py``: the task's ``Task(config, corpus, mix, device)``,
  which makes the calls of the program and checks them: ``warm()``, the
  set-up's calls (every shape the window will use); ``once()``, one
  call; ``keep(output)``, what the check needs of a call's output;
  ``route_error(phases)``, why the phase-timed call took a route the
  cell does not measure (None where it did not); ``reference()``,
  ``wrong(kept, reference)``, the calls whose output differs from the
  plain reference's; and ``control(task)``, the task turned into the
  control of that comparison (``control.py``);
- ``traffic/<mix>.json``: the parameters of the one generator,
  ``corpus.py``, and of the task (a batch's size);
- ``metrics/<metric>.py``: each metric's reader, ``read(reading)``,
  returning the number or None where it finds nothing to read; every
  metric but ``setup_s``, which this module takes.

A run: the corpus is drawn from the seed; the task's warm-up, which
builds and loads the kernels (from the program's fixed build directories
in the checkout), is set-up; ``setup_s`` is the time from the process's
start to the warm-up's end. With ``--trace 0`` calls then run back to
back until ``--seconds`` have passed (the last call started in time
finishes); each call is timed alone, from its start to its return, and
what ``keep`` keeps of it is taken between calls, outside that time.
With ``--trace 1`` one call runs under ``torch.profiler``, where the
program's phases annotate the trace themselves (after an untraced one),
then one with the program's phase timer on. Once the calls are done the
peak device memory is read, the program's state is freed, every kept
call is compared with the plain reference's, and the metrics are read.
Then no module of JAX, jaxlib, flax or the JAX package may have been
loaded, or the run gives no result.
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
    kept: Optional[list] = None  # what keep kept of each window call
    traced: Optional[object] = None  # what keep kept of the traced call
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


def load_file(kind: str, name: str):
    """The module ``<kind>/<name>.py`` under the benchmark's directory,
    loaded by its path as ``portbench.<kind>.<name>`` (one module a
    path in a process)."""
    path = os.path.join(BENCH, kind, name + ".py")
    if not os.path.isfile(path):
        raise RunError(f"no file {kind}/{name}.py")
    mod_name = f"portbench.{kind}." + name.replace(".", "_").replace(
        "-", "_")
    mod = sys.modules.get(mod_name)
    if mod is not None and getattr(mod, "__file__", None) == path:
        return mod
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def task_module(config: dict):
    """The module of ``config``'s task, ``tasks/<task>.py``."""
    return load_file("tasks", config.get("task", "train"))


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return load_file("metrics", metric).read


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
    task = task_module(config).Task(config, data, mix, device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    task.warm()
    sync()
    r = Reading(task=task, setup_s=time.perf_counter() - t_start)
    kept = []
    if not trace:
        r.call_s = []
        start = end = time.perf_counter()
        deadline = start + seconds
        while end < deadline:
            t0 = time.perf_counter()
            out = task.once()
            sync()
            end = time.perf_counter()
            r.call_s.append(end - t0)
            kept.append(task.keep(out))
            del out
        r.calls, r.window_s, r.kept = len(kept), end - start, kept
    else:
        from subword_tokenizers_tpu_torch.benchmarks import profiling
        from . import devtrace
        out, r.trace = devtrace.trace_call(task.once, cuda)
        r.traced = task.keep(out)
        kept.append(r.traced)
        del out
        profiling.reset()
        profiling.enable(True)
        try:
            out = task.once()
            sync()
        finally:
            profiling.enable(False)
        kept.append(task.keep(out))
        del out
        r.phases = profiling.report()
        profiling.reset()
        why = task.route_error(r.phases)
        if why:
            raise RunError(f"the phase-timed call: {why}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    r.reference = task.reference(record_states=trace)
    wrong = task.wrong(kept, r.reference)

    metrics = {}
    for m in cell_metrics(bench, name, trace):
        value = r.setup_s if m["name"] == "setup_s" else reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": entry["chips"], "memory_peak_bytes": peak}
    result = {"correct": wrong == 0, "attempted": len(kept),
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
                                        "of": len(kept)}}
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
