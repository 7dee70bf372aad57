"""Per-phase wall-clock timing of the encode and training paths.

FastWP's batched encode wraps each stage in :func:`phase`:
``encode.native_prep``, ``encode.pack_u16``, ``encode.h2d``,
``encode.scan``, ``encode.compact``, ``encode.d2h`` and
``encode.stitch``. The BPE encoders and NaiveWP's batched encode:
``encode.frontend`` (pre-split, word-type dedup, symbol or alphabet
ids), ``encode.h2d``, ``encode.bpe_merge`` or ``encode.wp_match``,
``encode.compact``, ``encode.d2h`` and ``encode.stitch``; NaiveBPE's
host route for a merge list with a pair listed twice is
``encode.host``. BPE and WordPiece training: ``train.frontend``,
``train.corpus`` (symbol interning, flat state, host-to-device copy),
``train.resume``, ``train.device_block`` (a block of K steps queued
step by step or replayed as one CUDA graph and, while profiling, run),
``train.capture`` (a block's graph captured), ``train.fetch_records``
(the wait for a block's records), ``train.verify``, ``train.per_step``
and ``train.final_fetch``; under a mesh ``train.sharded`` (the step
loop) holds ``train.device_step`` (a tier queued step by step),
``train.capture`` (a tier's graph captured), ``train.step_replay`` (a
tier's graph replayed) and ``train.fetch_records`` (the wait for a
tier's record). Off by default (one
module-bool check per block);
on with ``SWT_PROFILE=1`` or :func:`enable`. Kernels launch
asynchronously, so while profiling is on a device phase ends with
``torch.cuda.synchronize()`` and is charged its own device time; while
it is off nothing synchronises.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


class StepTimer:
    """Accumulates wall time per named phase."""

    def __init__(self) -> None:
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, device=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if device is not None and device.type == "cuda":
                import torch
                torch.cuda.synchronize(device)
            self._total[name] += time.perf_counter() - t0
            self._count[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self._total[name],
                "count": self._count[name],
                "mean_s": self._total[name] / max(self._count[name], 1),
            }
            for name in self._total
        }


_enabled = os.environ.get("SWT_PROFILE", "") not in ("", "0")
_timer = StepTimer()


def enable(on: bool = True) -> None:
    """Turn the global phase profiler on or off."""
    global _enabled
    _enabled = on


@contextlib.contextmanager
def phase(name: str, device=None) -> Iterator[None]:
    """Time a named stage. ``device``: the torch.device whose queued
    work the stage launches; a CUDA device is synchronised at the end
    of the stage, and only while profiling is on."""
    if not _enabled:
        yield
        return
    with _timer.phase(name, device):
        yield


def reset() -> None:
    global _timer
    _timer = StepTimer()


def report() -> Dict[str, Dict[str, float]]:
    """Per-phase totals across everything run since :func:`reset`."""
    return _timer.report()
