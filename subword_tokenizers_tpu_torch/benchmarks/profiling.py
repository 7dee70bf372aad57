"""The port's profiler: named spans of the host's wall, and counters.

Spans. FastWP's batched encode wraps each stage in :func:`phase`:
``encode.native_prep``, ``encode.pack_u16``, ``encode.h2d``,
``encode.scan``, ``encode.compact``, ``encode.d2h`` and
``encode.stitch``. The BPE encoders and NaiveWP's batched encode:
``encode.frontend`` (pre-split, word-type dedup, symbol or alphabet
ids), ``encode.h2d``, ``encode.bpe_merge`` or ``encode.wp_match``,
``encode.compact``, ``encode.d2h`` and ``encode.stitch``; NaiveBPE's
host route for a merge list with a pair listed twice is
``encode.host``. BPE and WordPiece training, opened by
models/training.py unless named otherwise: ``train.frontend``,
``train.alphabet`` (the corpus's size),
``train.corpus`` (symbol interning, flat state, host-to-device copy;
under a mesh a second one builds the sharded trainer),
``train.resume``, ``train.per_step`` (the exact per-step loop), and
``train.final_fetch`` (the final state and the symbol lists built from
it, holding ``train.final_copy``, the state's copy to the host, and
``train.symbols``, the lists); ops/train_loop.run_fused opens
``train.loop_setup`` (a run's tables, host buffers and events, and
WordPiece's first K4), ``train.verify``, its own ``train.final_fetch``
holding ``train.final_copy`` (models/training.py's then holds only
``train.symbols``) and ``train.close`` (the block in flight drained and
the graphs released), and its ``BlockRunner`` ``train.device_block`` (a
block of K steps queued step by step or replayed as one CUDA graph),
``train.capture`` (a block's graph captured) and
``train.fetch_records`` (the host's wait for a block's records);
models/bpe.FastBPE opens ``train.ranks`` and models/wordpiece.FastWP
``train.trie``. Under a mesh models/training.py's ``train.sharded`` (the step
loop) holds parallel/train.ShardedTrainer's ``train.device_step`` (a
tier queued step by step), ``train.capture`` (a tier's graph
captured), ``train.step_replay`` (a tier's graph replayed) and
``train.fetch_records`` (the wait for a tier's record), and
models/training.py closes the trainer in ``train.close``.

A span times the host's wall alone (``time.perf_counter``) and never
waits on the device: kernels launch asynchronously, so a span that
queues work ends once it is queued, and the host's waits on the card
fall in the spans that wait (``train.fetch_records``,
``train.final_copy``, ``train.close``). The card's own time is the
device trace's. Timing is off by default; on with ``SWT_PROFILE=1`` or
:func:`enable`. While a ``torch.profiler`` records, each span also
opens a ``record_function`` of its name, so the spans sit on the
trace's timeline, nested as in the code. With timing off and no
profiler recording a span costs one check. Callers call
``profiling.phase`` through this module, so a caller may swap the
attribute.

Counters. :func:`count` always counts, timing on or off; :func:`counter`
reads one. The program's:

- ``launch.<wrapper>``: the kernel launches of an ops wrapper, replays of
  captured graphs included; ``launch.<wrapper>.<mode>`` those of one
  mode, a part of the wrapper's count (``launch.select_unify.wp``,
  ``.tournament``, ``.cert``; ``launch.pair_stats.skip``;
  ``launch.merge_apply.wp``; ``launch.skip_guard.close``;
  ``launch.gather_loop.shared``);
- ``train.merges`` (merges learned), ``train.blocks``,
  ``train.eager_blocks`` (blocks queued step by step),
  ``train.graph_captures``, ``train.graph_replays``,
  ``train.blocks.<F>`` and ``train.graph_replays.<F>`` (at width F, 0
  for the padded layout), ``train.redos`` (K2's tournament redos),
  ``train.overflow_compactions`` (the skip route's guard), the size of
  the state of ``ops/train_loop.run_fused``: ``train.word_types``,
  ``train.slots`` (the live slots it starts from) and
  ``train.live_slots`` (the live slots its steps read, summed over the
  merges learned; on the flat route that compacts every step), BPE's
  with an end-of-word suffix (models/bpe.py), once a train and never
  without one: ``train.eow.symbols`` (the initial symbols that carry
  the suffix, counted in ``train.corpus`` by
  core/corpus.build_bpe_corpus) and ``train.eow.merges`` (the merges
  whose right symbol carries it, counted at the end of
  models/training.py's train), and
  ``train.frontend.fused`` / ``train.frontend.fallback`` (trains whose
  word types came from the native pass of core/corpus.train_words, or
  from the route it falls back to: an injected tokenizer, or U+0130 or
  U+03A3 in the corpus);
- ``trie.native`` (FastWP's end-to-end tries built, each in one native
  pass of ``models/trie.E2ETrie.build``: one a FastWP train) and
  ``trie.nodes`` (their nodes, summed);
- ``train.symbols.native`` (symbol lists built, each in one native pass
  of ``core/corpus.symbol_lists``: one a train) and
  ``train.symbols.items`` (the symbols they hold, summed).

:func:`reset` zeroes the spans and the counters; :func:`report` lists
each span as ``{"total_s", "count", "mean_s"}`` and each counter as
``{"count": n}``, under its name.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

_enabled = os.environ.get("SWT_PROFILE", "") not in ("", "0")
_total: Dict[str, float] = defaultdict(float)
_spans: Dict[str, int] = defaultdict(int)
_counts: Dict[str, int] = defaultdict(int)
_NULL = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def enable(on: bool = True) -> None:
    """Turn the spans' timing on or off."""
    global _enabled
    _enabled = on


@contextlib.contextmanager
def _span(name: str, timed: bool, traced: bool):
    with torch.profiler.record_function(name) if traced else _NULL:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if timed:
                _total[name] += time.perf_counter() - t0
                _spans[name] += 1


def phase(name: str, device=None):
    """A named span (a context manager): its host wall while timing is
    on, a ``record_function`` while a profiler records. ``device``, the
    device whose work the span queues, is the caller's note; the span
    never waits on it."""
    timed, traced = _enabled, _recording()
    if not (timed or traced):
        return _NULL
    return _span(name, timed, traced)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    _counts[name] += n


def counter(name: str) -> int:
    """Counter ``name`` (0 if never counted)."""
    return _counts.get(name, 0)


def counters(prefix: str = "") -> Dict[str, int]:
    """A copy of the counters whose names start with ``prefix``."""
    return {k: n for k, n in _counts.items() if k.startswith(prefix)}


def counted_since(before: Dict[str, int], prefix: str) -> Dict[str, int]:
    """How far each counter under ``prefix`` moved since ``before``
    (:func:`counters` of that prefix); unmoved ones left out."""
    return {k: n - before.get(k, 0) for k, n in counters(prefix).items()
            if n != before.get(k, 0)}


def reset() -> None:
    """Zero every span and counter."""
    _total.clear()
    _spans.clear()
    _counts.clear()


def report() -> Dict[str, Dict[str, float]]:
    """Each span's totals and each counter since :func:`reset`."""
    out = {name: {"total_s": _total[name], "count": _spans[name],
                  "mean_s": _total[name] / max(_spans[name], 1)}
           for name in _total}
    out.update((name, {"count": n}) for name, n in _counts.items())
    return out
