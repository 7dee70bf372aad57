"""One call traced by ``torch.profiler``, reduced to what the metrics read.

The method is ``chip_smoke.device_trace``'s: the profiler's first step
runs the call once untraced (a short trace taken cold can lose its first
device events), a few small copies and a pause prime it, then the call
runs traced inside a ``record_function`` mark. From the Chrome trace:

- the traced window is the mark's span on the host;
- the device is busy where any kernel, memcpy or memset runs: the union
  of those spans inside the window (``busy_s``);
- each kernel's count and device seconds, by name;
- the idle gaps: the stretches of the window in which nothing runs on
  the device, each named by a host annotation (the program's spans
  annotate a recording profiler themselves): the innermost (shortest)
  one that covers more than half of the gap; where none does, the one
  that covers most of it, the innermost at a tie; ``"host"`` where none
  overlaps it.

The trace file goes to the temporary directory and is deleted once read.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

MARK = "portbench.traced_call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10  # idle gaps named, longest first


@dataclass
class Trace:
    """What one traced call shows."""

    window_s: float                  # the traced call's span on the host
    busy_s: float                    # union of device spans in it
    kernels: Dict[str, List[float]]  # name: [count, device seconds]
    device_ops: Dict[str, List[float]]  # kernels, copies, memsets
    # the longest idle gaps, longest first: (host annotation, seconds)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace marks and
    argument list."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.endswith(")"):  # cut the argument list: the last (...)
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    if name.startswith("void "):
        name = name[5:]
    return name.strip()[:100]


def trace_call(fn: Callable[[], object], cuda: bool = True
               ) -> Tuple[object, Trace]:
    """Run ``fn`` once untraced and once traced; return the traced call's
    result and its :class:`Trace`. ``cuda`` False traces the host alone
    (the CPU tests)."""
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    out = []
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])

    def sync():
        if cuda:
            torch.cuda.synchronize()
    try:
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            fn()
            sync()
            prof.step()
            if cuda:
                for _ in range(8):
                    torch.ones(1, device="cuda").cpu()
            time.sleep(0.2)
            with record_function(MARK):
                out.append(fn())
                sync()
            prof.step()
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out[0], reduce(events)


def reduce(events: List[dict]) -> Trace:
    """The :class:`Trace` of a Chrome trace's events holding one
    :data:`MARK` span."""
    marks = [e for e in events if e.get("name") == MARK
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} spans of the "
                           f"traced call, not one")
    t0, t1 = marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]
    spans = []
    kernels: Dict[str, List[float]] = {}
    ops: Dict[str, List[float]] = {}
    notes = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
            if b <= a:
                continue
            spans.append((a, b))
            name = e.get("name", "")
            if cat == "kernel":
                name = short_name(name)
            for into in ((ops, kernels) if cat == "kernel" else (ops,)):
                rec = into.setdefault(name, [0, 0.0])
                rec[0] += 1
                rec[1] += (b - a) / 1e6
        elif cat == "user_annotation" and e.get("name") != MARK and \
                not e.get("name", "").startswith("ProfilerStep"):
            notes.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps, at = [], t0
    for a, b in merged + [[t1, t1]]:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:TOP]:
        over = [(min(b, n[1]) - max(a, n[0]), n[0] - n[1], n[2])
                for n in notes if n[0] < b and n[1] > a]
        most = [o for o in over if 2 * o[0] > b - a]
        if most:  # the innermost: the largest start - end
            name = max(most, key=lambda o: o[1])[2]
        else:
            name = max(over)[2] if over else "host"
        named.append((name, (b - a) / 1e6))
    return Trace(window_s=(t1 - t0) / 1e6, busy_s=busy / 1e6,
                 kernels=kernels, device_ops=ops, idle_gaps=named)
