#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Drives FastWP batched encode (``subword_tokenizers_tpu_torch``) on the
card at the size of ``data/train-85k.json`` with the 8,043-token
WordPiece vocab ``tests/golden/port_t85k_fastwp_vocab.json``:

0. the card's name and power limit (nvidia-smi) and the versions;
1. builds the native front end (g++) and the CUDA kernels (nvcc,
   sm_90a) from the sources in the checkout;
2. holds FastWP's kernels against their plain PyTorch versions on the
   same tensors on the card, exactly (every output is an integer): the
   fused scan (kernel 1's walk with kernel 2's compaction in one launch),
   kernel 1's rows form and kernel 2 over its rows, on seeded random
   tries and rows that raise every flag (u16 and i32 words, packed and
   general parameters), batches across the tiles' edges, rows staged 96
   and 32 a block and rows too wide to stage in shared memory, kernel 2
   alone across its tiles with overflowing rows, the general-pops route,
   and the 27,482 unique chunks of the corpus; times each beside its
   bound, kernel 2 also beside ``torch.masked_select``;
3. encodes the whole corpus five times through ``FastWP(device="cuda")
   .tokenize_batch``; the output's sha256 must equal the one the JAX
   package gave (``tests/golden/port_t85k_fastwp_expect.json``) and each
   call must make one fused launch and no other; the front end it ran is
   the library built from the port's own ``_native/`` sources (its path
   printed, under ``subword_tokenizers_tpu_torch/_native/build/``); then ``tokenize_stream``
   and small batches against the host ``tokenize``; (3c) one traced call
   shows one kernel and no memset; (3d) the whole-sentence route (a
   vocab token with a space) through the rows form and kernel 2 equals
   the CPU path;
4. an input on which the reference would hang raises on the card;
5. holds the three BPE training kernels (pair counts, selection with
   hash unification, merge with compaction) against their plain
   versions, exactly, on seeded random flat states, on the corpus's
   initial state (187,885 slots) and on its state after 1,000 merges
   (shrunk to half the width), K1 into a TablePair (the training
   loop's own after the merges), K2 over the claims of that fill, over
   every entry and over the claims of a copy whose unclaimed entries
   hold poison, K3 with a MergeScratch kept across calls; times each at
   the initial state beside its bound;
6. trains ``NaiveBPE(device="cuda")`` on the whole corpus to an
   8,000-symbol vocab: every merge must equal the JAX package's
   (``tests/golden/port_t85k_v8000_bpe_merges.json``, whose first 500
   are the reference trainer's ``t85k_v578_merges.json``) and every
   kernel must have been launched; each run's first block is queued step
   by step and every later one is a CUDA graph replay (ops/train_loop.py
   ``BlockRunner``), with a replay at every width, and each kernel's count
   is 256 a block; cold and warm times, the phase split and (6c) the
   device's idle share under ``torch.profiler``, with the trace's graph
   launches and each kernel's spans, which must equal the launches its
   counter counted in that train, replays included;
6b. the other training routes: a checkpoint at 1,400 resumed to 8,000,
   the exact per-step path to 578, and a forced hash collision, each
   through graphs;
6d. one block captured at the corpus's initial state and replayed 50
   times, each from a copy of that state: every replay's records equal
   the block queued step by step, two replays back to back equal 512
   steps queued step by step;
7. holds the WordPiece training kernels against their plain versions,
   exactly: the exact scorer on about 10^6 seeded cases up to d = 2^104,
   symbol weights (K4), selection by score with "##"-stripping
   unification (K2's WordPiece mode, exact and tournament, over the
   claims, every entry and a poisoned copy's claims) and the merge
   carrying the weights (K3), on the corpus's initial WordPiece state,
   after 1,000 merges, on the BPE state at half the width, with weights
   scaled into the wide score domain, and on a near tie of relative gap
   2^-51; times each at the initial state beside its bound;
8. trains ``NaiveWP(device="cuda")`` on the whole corpus to an
   8,000-token vocab: every merge and the vocab must equal the JAX
   package's (``tests/golden/port_t85k_v8000_wp_vocab.json``), the
   carried weights a recount, and every kernel must have been launched;
   every block after a run's first a graph replay, as in phase 6; cold
   and warm times, the phase split, and (8c) the idle share and the
   kernels' spans against their counters, as in 6c;
8b. the other WordPiece routes: a checkpoint at 1,400 merges resumed to
   8,000, the per-step path to 1,000, a forced hash collision, and
   ``FastWP.train`` then ``tokenize_batch`` against the golden vocab;
9. holds the two encode kernels against their plain versions, exactly:
   the BPE merge loop (greedy and monotone; a warp a word) on seeded
   random rows (runs of one symbol, PAD at the end, unseen ids, lengths
   0, 1 and L) at widths from 1 to 13,000 (every path of the kernel: the
   row in registers, in shared memory and in place), on self-pair runs
   longer than 32, and on the corpus's 22,971 word types with the
   trained and the shuffled merges, and the kernel's own layout check
   raising on each bad row; the WordPiece greedy match (kernel 6's fused
   form, the match with kernel 2's compaction in one launch, and its rows
   form) on seeded random vocabs, batches across its tiles' edges, words
   staged 96 and 32 a block and words too wide to stage, words at the
   step cap, a vocab with "#" and no "##" (overflow), a word forced to
   [UNK] and the word types with the trained vocab; times each at the
   word types' shapes (the BPE kernel alone, its plain version and its
   wrapper, in both modes, and the trips of its slowest word; both forms
   of kernel 6, and the steps of its slowest word);
10. encodes the whole corpus with ``FastBPE``, ``NaiveBPE`` (the trained
   merges) and ``NaiveWP`` (the trained vocab) on the card: a cold and
   three warm runs, each equal to the JAX package's digest
   (``tests/golden/port_t85k_encode_expect.json``), each call with its
   own launch counts (K5 and kernel 2 once each; one fused kernel 6), the
   phase split, and (10c) the idle share under ``torch.profiler``, each
   trace holding the encoder's own kernel;
10b. the other encode routes: the shuffled merges through both BPE
   encoders, NaiveBPE with a merge listed twice (the host route, no
   kernel launch), ``tokenize_stream`` and small batches against the
   host ``tokenize``, and the WordPiece overflow error on the card;
11. holds the kernels of the training loop's other routes against their
   plain versions, exactly: K1 and K3 in skip mode (deferred compaction,
   K3's gate word too) and the overflow guard on seeded flat states with
   holes, runs and gaps wider than the window (windows 1-64), on states
   cut at the skip kernels' tile edges (runs longer than a tile, gaps at
   an edge and in the slots a tile stages from its neighbours; 2,048
   tiles) and on the corpus's state after 1,000 skip-mode merges; K3p
   (the padded layout's
   merge) and K1 over padded rows on seeded rows (lengths 0, 1 and L,
   PADs inside) and the corpus's 22,971 x 22 tensor; K2's tournament
   mode on the Bezout near tie (which must be redone), an exact tie, a
   clear order, seeded tables and the corpus's WordPiece tables; times
   each at the corpus's shapes;
12. trains all of the corpus to 8,000 through each route of
   ``run_fused`` (``SWT_SKIP_COMPACT=12`` and ``=2`` for BPE, ``=12``
   for WordPiece, ``SWT_WP_TOURNAMENT=1``, and
   ``run_fused(flat=False)`` for both): every run equals the JAX golden,
   each route launches its kernels (``=2`` must compact on overflow) and
   the skip routes compact as often as the JAX package
   (``tests/golden/port_t85k_skip_overflows.json``), with cold and warm
   times, the captures and replays, the phase split and (12c) the skip
   route traced: its idle share and graph launches, at most 4 kernel
   launches a step (and the block's close), each kernel's spans equal to
   its counter, no memset and no allocation in a block after the
   first;
13. holds the kernels of the data-parallel selection against their
   plain versions, exactly: the nomination (each shard's 256 best pairs
   and its K-th row), the candidate lookup and the table
   compaction, each one launch over every table of a device (and over
   one table alone), the nomination also on all-equal counts, dense
   tables past a block's staging and tables of 2 and 0 live entries,
   the compaction with caps that overflow on every
   shard and on some shards only and 1,000 times back to back with
   alternating tables and caps, K1's runs mode and the certificate (by
   its check launcher and inside K2's dense launch), on
   seeded sharded states, on the corpus's 8-shard state (22,976 rows,
   2,872 x 22 a shard) initial and after 1,000 merges for BPE and
   WordPiece, on the mesh of 1's table (2^20 entries, 8 clusters of the
   compaction and a look-back between them), with weights scaled into
   the wide score domain, and on hand-made certificates (a near tie, an
   exact tie, saturation, a 62-bit veto, a zero sum); times each at the
   corpus's shapes, beside the launch floors, ``torch.nonzero`` over the
   compaction's own keys, 8 ``torch.topk`` over the nomination's
   metrics, the nomination's registers and spills, K2's dense launch
   over the candidates without and with the certificate (BPE and
   WordPiece), and K1 and K3p (a real merge) at a shard's shape; (13b)
   the sharded step's grouped K1
   (``pair_rows``: every shard of a device in one launch, which fills one
   set of tables and empties the other) and K3p (one launch over the
   device's block, ids from the host or the record) against their plain
   versions, exactly, on seeded rows (L of 2 to 70, 1 and 8 shards, PADs
   inside, runs of a == b, inactive records), a double buffer over three
   steps, and the corpus's 8 shards and the mesh of 1 at the golden's
   1,001st merge; their times beside the per-shard launches they replace
   (8 x ``swt_pair_stats``, 8 x ``swt_merge_rows``); (13c) K4 in its
   grouped rows mode (``symbol_rows``: a device's block of shards in one
   launch, filling one of two outputs and emptying the other) and flat
   mode against the plain version, exactly, on seeded rows (PADs inside,
   all-PAD rows, ids at and above sym_cap, a sym_cap of 40,000), the
   WordPiece corpus's 8-shard block over three steps, the mesh of 1, the
   padded route and the flat route, with times beside 8 per-shard
   launches and ``index_add_``; the single-device K1 (one launch a call
   into one of two tables, emptying the other's claimed entries) on five
   consecutive flat-route steps across a shrink, five in skip mode and
   three padded, each table emptied whole, timed at the initial state
   beside its bound as the function needs and with a full clear;
   WordPiece's scorer alone at a shard's table; and a traced 256-step
   block, one graph replay, of the flat route (BPE and WordPiece: one
   graph launch, 3 kernels a step, no memset, no allocation inside the
   block) and of the padded route (no memset);
14. trains ``NaiveBPE`` and ``NaiveWP(mesh=make_data_mesh(8,
   devices=["cuda:0"] * 8))`` on the whole corpus to 8,000, each equal to
   its golden, with the tiers that settled each step and the shard
   kernels' launches (one grouped K1, one nomination and one lookup a
   step, one compaction a step the certificate did not settle, one
   grouped K3p a merge, one grouped K4 a WordPiece step, the
   certificate inside K2's launch every step, 5 kernel-wrapper calls a
   BPE step and 6 a WordPiece step, the per-shard K1 only in the full
   tier, no scorer and no certificate launch); the forced tiers and
   a mesh of 1 to 1,000, each equal to the golden's prefix, with their K1
   and K3p launches (the forced full tier too a graph replay every step
   after the first); FastWP's sharded encode (one fused launch a shard)
   and the other three encoders under the mesh against the JAX digests;
   and (14d) the idle share of
   one warm sharded train traced after an untraced one, with the grouped
   kernels by name, their spans equal to the launch counters and its
   graph launches to its replays, no memset, no ``torch.topk`` kernel
   and no ``certificate_kernel``. On the one-card mesh each tier of a
   step after a run's first, top-K, compact or full, is one CUDA graph
   replay (parallel/train.ShardedTrainer; phase 14 asserts the counts
   and the tiers); (14e) a captured top-K and compact tier replayed 50
   times from copies of one state, each equal to the tiers queued step
   by step;
15. the process-group route: ``torch.distributed`` with NCCL at world
   size 1 (NCCL takes one rank per GPU; its version printed), a TCP
   store on localhost, an 8-shard process-group mesh on the card:
   NaiveBPE and NaiveWP on the whole corpus to 8,000, cold and warm,
   each equal to its golden (BPE's first 500 merges the reference
   anchor), every tier after a run's first step one graph replay that
   holds the tier's collectives, the tiers, launches and collectives
   counted as phase 14 counts them; the coordinator and
   ``fetch_global``; (15c) a traced warm BPE train to 2,000 after an
   untraced one, each kernel's spans equal to its counter, the graph
   launches to the replays and the device work of the collectives to
   the collectives counted (the graphs' included); (15d) phase 14e on
   the NCCL mesh;
16. the gather probe (``subword_tokenizers_tpu_torch.tools.gather_probe``,
   the port of the TPU probe ``tools/pallas_probe.py``): its ``main`` on
   the card, then its three kernels (a 2-D gather, a chain of 128
   dependent gathers through the caches and from shared memory) against
   their plain versions, exactly, with their times, the marginal time of
   one dependent iteration, the loops' latency bound, and kernel 1's
   slowest row on the corpus at each mode's iteration time; (16b) kernel
   6's latency bound at that time;
17. the CLI (``python3 -m subword_tokenizers_tpu_torch.cli``) at full
   width in a temporary directory: ``--train`` of the four models on the
   whole corpus to 8,000 (the saved merges and vocabs equal the goldens),
   ``--tokenize`` of the corpus file (each model's digest equals the JAX
   package's; FastWordPiece with the 8,043-token vocab), the pretrained
   ``--benchmark`` of the corpus and ``--compare`` on its first 2,000
   sentences (equal to the CPU path's report), each step's launches.

Each phase prints one line; any failure raises. The line before the last
is the kernels' JSON record, the last ``{"ok": true, "device": ...}``.
Each kernel's ``bound_ms`` is the larger of the bytes it must move (its
inputs read once, its outputs written once, at the timed shapes; of a
table it probes, such as a trie or a hash, only the entries this run's
data visits, counted low) over
3.35 TB/s and a lower count of its operations over 67 T/s, the H100's
scalar 32-bit rate outside the tensor cores (the integer rate is lower,
so the bound stays a bound); ``library_ms`` is one PyTorch call that
computes the same function, where there is one.
Without CUDA, or without the rest of the repo, it exits non-zero.
"""
from __future__ import annotations

import hashlib
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
SEED = 20261016
SHUFFLE_SEED = 7  # the shuffled merge list of the encode goldens
DEVICE = "cuda:0"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12   # H100 SXM float32 outside the tensor cores
# host-to-device copies a sharded train may make in its set-up (the
# corpus's blocks, the records); none a step
H2D_SETUP_MAX = 50
# the sharded BPE train's tiers on the whole corpus to 8,000, as the
# step-by-step route counted them on the card (the certificate proves the
# first 473 steps, as in the JAX package); WordPiece's certificate proves
# every step
SHARDED_BPE_TIERS = {"proven": 473, "compact": 7449, "full": 0}
# the sharded step's kernels: each wrapper's launch counter (as
# shard_kernels() names them) and a part of its kernel's name in a trace
SHARD_TRACE_KERNELS = (("pair_rows", "pair_rows_kernel"),
                       ("nominate_tables", "nominate_kernel"),
                       ("lookup_reduce", "lookup_reduce_kernel"),
                       ("compact_tables", "compact_tables_kernel"),
                       ("pair_stats_runs", "runs_insert_kernel"),
                       ("select_unify", "select_kernel"),
                       ("merge_rows", "merge_rows_kernel"))
# words in the names of torch.topk's CUDA kernels (sbtopk, mbtopk)
TOPK_KERNEL_WORDS = ("topk", "radixfindkth", "kthcounts", "withinkcounts")
# batch sizes at the edges of kernel 1's tiles (128 rows) and kernel 2's
# (256 rows)
TILE_EDGE_ROWS = (1, 127, 128, 129, 255, 256, 257, 3 * 256 + 7)
# each word-level encoder: the wrappers it launches once a call (phase
# 10's launch counts) and the names of their kernels, one of which its
# traced call must hold (phase 10c)
ENCODE_KERNELS = {
    "FastBPE": (("bpe_encode", "compact_ids"),
                ("encode_regs_kernel", "encode_wide_kernel")),
    "NaiveBPE": (("bpe_encode", "compact_ids"),
                 ("encode_regs_kernel", "encode_wide_kernel")),
    "NaiveWP": (("wp_match_compact",), ("match_compact_kernel",)),
}
# row widths whose staging takes 96 and 32 rows a block, and one too wide
# to stage in shared memory at all (ops/wp_encode_e2e.tile_layout)
STAGE_WIDTHS = (300, 700, 1100)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def visited(n_visits: int, bytes_each: int, *table) -> int:
    """Bytes a kernel reads of a table it probes: ``bytes_each`` per
    visit, and no more than the whole table."""
    return min(n_visits * bytes_each, nbytes(*table))


def bound(n_bytes: int, n_ops: int):
    """(least ms, "bytes" or "operations"): the larger of the two times."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else \
        (by_ops, "operations")


def digest(token_lists) -> str:
    return hashlib.sha256(json.dumps(token_lists, ensure_ascii=False)
                          .encode("utf-8")).hexdigest()


def merge_lists():
    """{"golden", "shuffled", "duplicated"}: the merge lists the encode
    goldens (``tests/golden/port_t85k_encode_expect.json``) encode: the
    7,922 trained merges, the same shuffled by ``random.Random(7)``, and
    the trained list with one merge copied to the front."""
    with open(os.path.join(GOLDEN, "port_t85k_v8000_bpe_merges.json"),
              encoding="utf-8") as f:
        merges = [tuple(p) for p in json.load(f)]
    shuffled = random.Random(SHUFFLE_SEED).sample(merges, len(merges))
    # The first merge from 1,000 on whose halves are single characters,
    # copied to the front: it then applies before the merges it follows.
    i = next(i for i in range(1000, len(merges))
             if len(merges[i][0]) == len(merges[i][1]) == 1)
    return {"golden": merges, "shuffled": shuffled,
            "duplicated": [merges[i]] + merges}


def wp_vocab():
    """The 8,000-token trained WordPiece vocab of the encode goldens."""
    with open(os.path.join(GOLDEN, "port_t85k_v8000_wp_vocab.json"),
              encoding="utf-8") as f:
        return json.load(f)["vocab"]


def load(tok, name, data):
    """``tok.load_resources`` from a temp dir holding ``data`` as
    ``name``."""
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, name), "w", encoding="utf-8") as f:
            json.dump(data, f, ensure_ascii=False)
        tok.load_resources(d, strict=True)
    return tok


def cuda_ms(fn, reps: int, queue_ahead: bool = False) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up,
    by CUDA events. ``queue_ahead`` holds the stream in a spin of 1e8
    cycles (about 50 ms) while the host queues the calls, so that a
    kernel shorter than its wrapper's host overhead is timed back to
    back (only for ``fn`` that never waits for the device)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(got, want) -> int:
    """Largest absolute difference of two integer outputs; 0 if equal."""
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def emitted(ids, head, out_n, cap):
    """The stream entries that rows wrote (the kernel leaves the rest
    unset)."""
    import torch
    R = out_n.shape[0]
    n = out_n.to(torch.int64).clamp(max=cap)
    cols = torch.arange(cap, device=ids.device)[None, :]
    dest = head[:R].to(torch.int64)[:, None] + cols
    keep = (cols < n[:, None]) & (dest < R * cap)
    return ids[dest[keep]]


# The host's CUDA calls of the last trace device_trace read: its graph
# launches (cudaGraphLaunch) and its kernel launches (cudaLaunchKernel).
TRACE_API = {}
# The names of the last trace's kernels, in the order they started.
TRACE_KERNELS = []


def counter(name: str) -> int:
    """Counter ``name`` of the port's profiler (benchmarks/profiling.py)
    so far."""
    from subword_tokenizers_tpu_torch.benchmarks import profiling
    return profiling.counter(name)


def launches_total() -> int:
    """Every kernel launch the port's wrappers counted so far: the
    profiler's ``launch.<wrapper>`` counters (their modes' parts left
    out), replays included."""
    from subword_tokenizers_tpu_torch.benchmarks import profiling
    return sum(n for k, n in profiling.counters("launch.").items()
               if k.count(".") == 1)


def reset_spans() -> None:
    """The profiler's spans zeroed and its counters kept (a phase reads
    the counts of several calls, the spans of one)."""
    from subword_tokenizers_tpu_torch.benchmarks import profiling
    kept = profiling.counters()
    profiling.reset()
    for k, n in kept.items():
        profiling.count(k, n)


def span_ms(report) -> dict:
    """{span: total ms} of a ``profiling.report()``, its counters left
    out."""
    return {k: round(v["total_s"] * 1e3, 3) for k, v in report.items()
            if "total_s" in v}


def graph_counts():
    """The training loop's graph counts so far (the profiler's
    ``train.*`` counters of ops/train_loop.BlockRunner), by width where
    they are kept by width."""
    from collections import Counter

    from subword_tokenizers_tpu_torch.benchmarks import profiling

    def by_width(prefix):
        return Counter({int(k[len(prefix):]): n for k, n in
                        profiling.counters(prefix).items()})
    return dict(captures=counter("train.graph_captures"),
                replays=counter("train.graph_replays"),
                eager_blocks=counter("train.eager_blocks"),
                blocks=by_width("train.blocks."),
                replayed=by_width("train.graph_replays."))


def graph_check(before, runs: int, what: str, K: int = 256):
    """The graph counts since ``before`` (:func:`graph_counts`) of ``runs``
    calls of run_fused. Raises unless each call queued only its first
    block step by step, every other block was a graph replay, and every
    width a call ran at had a replay. Returns (blocks, a line)."""
    now = graph_counts()
    d = {k: now[k] - before[k] for k in ("captures", "replays",
                                         "eager_blocks")}
    blocks = now["blocks"] - before["blocks"]
    replayed = now["replayed"] - before["replayed"]
    n_blocks = sum(blocks.values())
    if (d["eager_blocks"] != runs or d["replays"] + runs != n_blocks
            or set(blocks) != set(replayed) or not d["captures"]):
        raise AssertionError(f"{what}: {runs} runs, graph counts {d}, "
                             f"blocks by width {dict(blocks)}, replays by "
                             f"width {dict(replayed)}")
    return n_blocks, (
        f"{n_blocks} blocks of {K} steps in {runs} runs: {runs} queued "
        f"step by step (each run's first), {d['replays']} graph replays of "
        f"{d['captures']} captures, replays by width "
        f"{dict(sorted(replayed.items()))}")


def trace_graph_line(by_name):
    """How the last trace's kernels were launched: its graph launches, the
    kernels the host launched and the kernel spans on the device."""
    spans = kernel_launches(by_name)
    if by_name and (not TRACE_API.get("graph_launches")
                    or spans <= TRACE_API.get("kernel_launches", 0)):
        raise AssertionError(f"the traced train ran no kernel from a graph "
                             f"launch: {TRACE_API}, {spans} kernel spans")
    return (f"{TRACE_API.get('graph_launches')} cudaGraphLaunch, "
            f"{TRACE_API.get('kernel_launches')} kernels launched by the "
            f"host, {spans} kernel spans on the device (the rest from "
            f"graph launches)")


# The kernels of a training block: the route_counters() name of each
# wrapper's launch counter, and a part of its kernel's name in a trace.
BLOCK_KERNELS = (("pair_stats", "pair_insert_kernel"),
                 ("select_unify", "select_kernel"),
                 ("merge_apply", "merge_tiles_kernel<false>"),
                 ("skip_guard", "merge_tiles_kernel<true>"),
                 ("merge_skip", "merge_skip_kernel"))


def block_counters():
    """{name: launches so far} of the kernels of ``BLOCK_KERNELS``, by
    their wrappers' counters."""
    counters = route_counters()
    return {k: counter(counters[k]) for k, _ in BLOCK_KERNELS}


def traced_launches(by_name, before, per_block, blocks, what):
    """The launches of one traced train, measured: raises unless each
    kernel of ``BLOCK_KERNELS`` ran as many times in the trace (its
    kernel spans, ``by_name`` of :func:`device_trace`) as its wrapper's
    counter counted since ``before`` (:func:`block_counters`, read as the
    traced train started), replays included, and as ``per_block[name]``
    (0 when absent) times the train's ``blocks``. Returns {name: spans}.
    On a difference it names the steps (K1's spans in order) before
    which the trace holds other kernels of the block than a step
    should."""
    if not by_name:
        raise AssertionError(f"{what}: the trace holds no device events, "
                             f"so the launches are not measured")
    now = block_counters()
    counted = {k: now[k] - before[k] for k in now}
    spans = {k: sum(c for n, (c, _) in by_name.items() if part in n)
             for k, part in BLOCK_KERNELS}
    want = {k: per_block.get(k, 0) * blocks for k in counted}
    if counted != spans or spans != want:
        from collections import Counter
        parts, skip = dict(BLOCK_KERNELS), bool(per_block.get("skip_guard"))
        steps, since, odd = 0, Counter(), []
        for n in TRACE_KERNELS:
            k = next((k for k, part in parts.items() if part in n), None)
            if k == "pair_stats":
                # the step before's K2 and K3, a block's close, the guard
                usual = Counter()
                if steps:
                    usual["select_unify"] = 1
                    usual["merge_skip" if skip else "merge_apply"] = 1
                if skip:
                    usual["skip_guard"] = 1 + (steps > 0
                                               and steps % 256 == 0)
                if since != usual and len(odd) < 8:
                    odd.append((steps, dict(since)))
                steps, since = steps + 1, Counter()
            elif k is not None:
                since[k] += 1
        raise AssertionError(
            f"{what}: launches counted {counted}, kernel spans in the "
            f"trace {spans}, {blocks} blocks want {want}; steps whose "
            f"kernels before K1 differ (step, kernels) {odd}, after the "
            f"last K1 {dict(since)}; the trace's first kernels "
            f"{TRACE_KERNELS[:6]}")
    return spans


def traced_train(train):
    """``train`` as :func:`device_trace` with ``warmup`` calls it (once
    untraced, then traced), noting :func:`block_counters` and
    :func:`graph_counts` as each call starts. Returns (fn, marks): the
    traced call's are ``marks[-1]``."""
    marks = []

    def fn():
        marks.append((block_counters(), graph_counts()))
        train()
    return fn, marks


def device_trace(fn, path, warmup=False):
    """Run ``fn`` once under torch.profiler; return (host wall ms, device
    busy ms, {kernel or copy name: [count, device ms]}) read from the
    Chrome trace, which is kept at ``path``. ``warmup`` runs ``fn`` once
    more first, as the profiler's untraced warm-up step: a short call
    traced alone can come back without its kernels. The first device
    events of the traced step can be missing from its trace too (the
    copies and the kernel of an encode call before its first wait), so
    with ``warmup`` a primer of small copies and a pause run first, and
    only the device events from the start of ``fn`` on are counted."""
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    mark = "device_trace.fn"
    if warmup:
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(8):
                torch.ones(1, device="cuda").cpu()
            time.sleep(0.2)
            with record_function(mark):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            prof.step()
    else:
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    start = min((e["ts"] for e in events if e.get("name") == mark
                 and e.get("cat") == "user_annotation"),
                default=float("-inf"))
    spans, by_name, kernels = [], {}, []
    TRACE_API.clear()
    TRACE_API.update(graph_launches=0, kernel_launches=0)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in (
                "cuda_runtime", "cuda_driver") and e["ts"] >= start:
            n = e.get("name", "")
            if "GraphLaunch" in n:
                TRACE_API["graph_launches"] += 1
            elif "LaunchKernel" in n:
                TRACE_API["kernel_launches"] += 1
        if e.get("ph") == "X" and e.get("cat") in (
                "kernel", "gpu_memcpy", "gpu_memset") and e["ts"] >= start:
            spans.append((e["ts"], e["ts"] + e["dur"]))
            rec = by_name.setdefault(e["name"][:60], [0, 0.0])
            rec[0] += 1
            rec[1] += e["dur"] / 1e3
            if e["cat"] == "kernel":
                kernels.append((e["ts"], e["name"]))
    TRACE_KERNELS[:] = [n for _, n in sorted(kernels)]
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return wall * 1e3, busy / 1e3, by_name


def random_case(rng, S, W, n_nodes, A, max_pops, hang_sharp):
    """Random trie tables and char words that reach every mode and flag:
    failure chains with cycles (stuck rows), wide pops (overflow), rows
    whose last char is not punctuation (crash)."""
    import numpy as np
    goto = rng.integers(-1, n_nodes, size=(n_nodes, A + 1))
    goto[rng.random(goto.shape) < 0.5] = -1
    goto[:, A] = -1
    fail = np.array([rng.integers(-1, max(n, 1)) for n in range(n_nodes)])
    cyc = rng.random(n_nodes) < 0.05
    fail[cyc] = rng.integers(0, n_nodes, size=int(cyc.sum()))
    # root_sharp (node 2): a dead end reached from the root, so that bare
    # "##" segments (the sharp sequence) occur.
    goto[0, :4] = 2
    goto[2] = -1
    fail[2] = -1
    cnt = rng.integers(0, max_pops + 1, size=n_nodes)
    pops_off = np.concatenate([[0], np.cumsum(cnt)])
    pops_flat = rng.integers(0, 1000, size=int(pops_off[-1]))
    sharp = [-2] if hang_sharp else list(rng.integers(0, 1000, size=2))
    aid = rng.integers(0, A + 1, size=(S, W))
    bits = (rng.random((3, S, W)) < 0.25).astype(np.int64)
    words = aid | (bits[0] << 22) | (bits[1] << 23) | (bits[2] << 24)
    slen = rng.integers(0, W, size=S)
    tables = [np.asarray(a, dtype=np.int32) for a in
              (goto, fail, pops_off, pops_flat, sharp)]
    return (np.asarray(words, dtype=np.int32),
            np.asarray(slen, dtype=np.int32), tables,
            dict(root_p=n_nodes - 1, root_sharp=2, unk_id=1000))


def bpe_random_case(rng, W, L, n_sym, n_merges, inner_pad=False):
    """Seeded rows for the BPE merge loop and the entries of a rank hash.

    Merges join ids already known (the base symbols 0..n_sym-1 and
    earlier merges' outputs, a fifth of them self-pairs) into fresh ids,
    with ranks in random order, so the greedy and the monotone rules
    disagree. Rows hold runs of one symbol (the self-pair parity rule),
    PAD (-1) at the end (and inside, with ``inner_pad``: only the plain
    version takes such rows), unseen ids above every merge output, and
    lengths 0, 1 and L among random ones. Returns (sym int32[W, L],
    [(key, rank, out_id)])."""
    import numpy as np
    pairs = {}
    n_ids = n_sym
    while len(pairs) < n_merges:
        a = int(rng.integers(0, n_ids))
        b = a if rng.random() < 0.2 else int(rng.integers(0, n_ids))
        if (a, b) not in pairs:
            pairs[(a, b)] = n_ids
            n_ids += 1
    ranks = rng.permutation(n_merges).tolist()
    entries = [((a << 21) | b, r, out)
               for ((a, b), out), r in zip(pairs.items(), ranks)]
    lens = rng.integers(0, L + 1, size=W)
    lens[:3] = (0, 1, L)
    sym = np.full((W, L), -1, dtype=np.int32)
    for w in range(W):
        s = int(rng.integers(0, n_sym))
        j = 0
        for _ in range(int(lens[w])):
            u = rng.random()
            if u < 0.04:
                sym[w, j] = n_ids + int(rng.integers(0, 3))
            elif u < 0.07 and inner_pad:
                pass  # PAD inside the row
            else:
                if u > 0.45:
                    s = int(rng.integers(0, n_sym))
                sym[w, j] = s
            j += 1
    return sym, entries


def self_pair_case(rng, W, L):
    """Rows of long self-pair runs for the BPE merge loop and the entries
    of a rank hash: runs of symbol 0 of lengths 1 to L (the first row all
    of L, the others broken by a 1 here and there), and merges that join
    a run pairwise again and again (0 0, 2 2, 3 3, 4 4, 5 5) beside mixed
    ones (0 2, 2 0, 1 0, 3 0, 1 1), ranks in a seeded order. Returns
    (sym int32[W, L], [(key, rank, out_id)])."""
    import numpy as np
    pairs = ((0, 0, 2), (2, 2, 3), (3, 3, 4), (4, 4, 5), (5, 5, 6),
             (0, 2, 7), (2, 0, 8), (1, 0, 9), (3, 0, 10), (1, 1, 11))
    ranks = rng.permutation(len(pairs)).tolist()
    entries = [((a << 21) | b, r, out)
               for (a, b, out), r in zip(pairs, ranks)]
    sym = np.full((W, L), -1, dtype=np.int32)
    sym[0] = 0
    for w in range(1, W):
        n = int(rng.integers(1, L + 1))
        sym[w, :n] = 0
        sym[w, rng.integers(0, n, size=int(rng.integers(0, 3)))] = 1
    return sym, entries


def wp_random_case(rng, W, max_len, alphabet, n_tokens):
    """A seeded vocab of ``n_tokens`` strings over ``alphabet`` (half of
    them "##" continuations) and W words over ``alphabet`` plus "!",
    which no token holds, of lengths 0 to max_len. Where the alphabet
    holds '#', the vocab holds "#" and not "##", so that some words grow
    '#' without end (the matcher's overflow)."""
    import numpy as np
    chars = list(alphabet)
    vocab = set()
    while len(vocab) < n_tokens:
        t = "".join(rng.choice(chars, size=int(rng.integers(1, 5))))
        vocab.add("##" + t if rng.random() < 0.5 else t)
    if "#" in chars:
        vocab.add("#")
        vocab.discard("##")
    words = ["".join(rng.choice(chars + ["!"] * (len(chars) // 8 + 1),
                                size=int(rng.integers(0, max_len + 1))))
             for _ in range(W)]
    return vocab, words


def match_rows(alpha, n_alpha, words, L):
    """int32[W, L] alphabet ids of ``words`` (each at most L long),
    padded with the OOV id, and int32[W] lengths."""
    import numpy as np
    wlen = np.array([len(w) for w in words], dtype=np.int32)
    wmat = np.full((len(words), L), n_alpha, dtype=np.int32)
    for r, w in enumerate(words):
        wmat[r, :len(w)] = alpha[[ord(c) for c in w]]
    return wmat, wlen


def bpe_random_state(rng, n_words, max_len, n_sym, wscale, unit, holes):
    """A seeded flat BPE state (numpy fs, wid, wgt) with word boundaries,
    tail padding, runs of equal symbols, and optionally equal weights
    (ties decided by first position) or dead slots inside."""
    import numpy as np
    from subword_tokenizers_tpu_torch.ops.flat import WID_PAD, build_flat
    sym = np.full((n_words, max_len), -1, dtype=np.int32)
    for w in range(n_words):
        n = int(rng.integers(1, max_len + 1))
        s = int(rng.integers(0, n_sym))
        for j in range(n):
            if rng.random() > 0.45:
                s = int(rng.integers(0, n_sym))
            sym[w, j] = s
    freq = (np.ones(n_words, np.int64) if unit
            else rng.integers(1, 50, size=n_words)) * wscale
    fs, wid, wgt = build_flat(sym, freq, pad_to=64)
    if holes:
        dead = (rng.random(fs.shape[0]) < 0.08) & (fs >= 0)
        fs[dead], wid[dead], wgt[dead] = -1, WID_PAD, 0
    return fs, wid, wgt


def skip_random_state(rng, n_words, max_len, n_sym, holes, gaps):
    """A seeded flat state (numpy fs, wid, wgt) for the skip mode: runs of
    equal symbols (self-merges through dead slots), a share ``holes`` of
    the live slots dead, and ``gaps`` stretches of 70 dead slots, wider
    than every window up to 64 (overflows)."""
    import numpy as np
    from subword_tokenizers_tpu_torch.ops.flat import WID_PAD
    fs, wid, wgt = bpe_random_state(rng, n_words, max_len, n_sym, 1, False,
                                    False)
    dead = (rng.random(fs.shape[0]) < holes) & (fs >= 0)
    for g in rng.integers(0, int((fs >= 0).sum()) - 80, size=gaps):
        dead[g:g + 70] |= fs[g:g + 70] >= 0
    fs[dead], wid[dead], wgt[dead] = -1, WID_PAD, 0
    return fs, wid, wgt


def skip_tile_state(rng, kind, F):
    """A seeded flat state (numpy fs, wid, wgt) of width ``F`` cut at the
    skip kernels' tiles of 2,048 slots: ``runs``, every third word 3,000
    slots of one symbol (a twentieth of them another) across the tile
    edges; ``edge``, 70 dead slots ending at each edge and 70 starting
    right after it; ``halo``, 30 dead slots inside the 68 a tile stages
    from each neighbour; and a share of the live slots dead elsewhere."""
    import numpy as np
    from subword_tokenizers_tpu_torch.ops.flat import WID_PAD
    n = F - 40
    lens = rng.integers(1, 12, size=n // 2 + 1)
    if kind == "runs":
        lens[1::3] = 3000
    word = np.searchsorted(np.cumsum(lens), np.arange(n), side="right")
    fs = np.full(F, -1, np.int32)
    fs[:n] = rng.integers(0, 3, size=n)
    if kind == "runs":
        long_ = lens[word] == 3000
        fs[:n][long_] = np.where(rng.random(int(long_.sum())) < 0.05, 1, 0)
    wid = np.full(F, WID_PAD, np.int32)
    wid[:n] = word
    dead = rng.random(F) < (0.05 if kind == "runs" else 0.1)
    offs = {"edge": np.r_[-70:0, 1:71], "halo": np.r_[-50:-20, 20:50]}.get(
        kind)
    if offs is not None:
        at = (np.arange(2048, F, 2048)[:, None] + offs).ravel()
        dead[at[at < F]] = True
    dead &= fs >= 0
    fs[dead], wid[dead] = -1, WID_PAD
    wgt = np.where(fs >= 0, 1 + wid.astype(np.int64) % 5, 0)
    return fs, wid, wgt


def skip_steps(state, table, n_steps, skip, max_len, dev,
               wordpiece=False):
    """``n_steps`` merges of the skip route on a FlatState, as
    ``run_fused`` queues them, without the block's closing compaction:
    the state keeps its dead slots."""
    import torch
    from subword_tokenizers_tpu_torch.ops import train_loop
    h1, h2, sl, ctrl, pw1, pw2, sharp = train_loop.init_tables(
        table, len(table) + n_steps, max_len, dev)
    if wordpiece:
        state.count_symbols(train_loop.sym_capacity(table,
                                                    len(table) + n_steps))
    stats = torch.zeros(2, dtype=torch.int32, device=dev)
    rec = torch.zeros(6, dtype=torch.int32, device=dev)
    for _ in range(n_steps):
        state.guard(stats[1:])
        train_loop.select_unify(*state.pairs(skip), h1, h2, sl, ctrl, pw1,
                                pw2, len(table) + n_steps, rec,
                                wordpiece=wordpiece,
                                sym_freq=state.sym_freq, sharp=sharp)
        state.merge(rec, skip)
    return int(stats[1])


def replay_check(dev, arrays, table, max_len, smi, reps=50, K=256):
    """Phase 6d: one block of the flat BPE route captured as a CUDA graph
    (ops/train_loop.BlockRunner) and replayed ``reps`` times, each from a
    copy of train-85k's initial state (the state's slots, the hash tables
    and the control words restored; K1's tables, K2's and K3's scratch
    and K3's epoch word as the last block left them). Every replay's
    records [K + 1, 6] must equal those of the same block queued step by
    step from that state, and two replays back to back the 2K steps
    queued step by step: a replay that took a stale look-back epoch or
    gate, or a host value of its capture, would differ. Also the host
    time to queue a block step by step and to replay it, and a block's
    device time."""
    import numpy as np
    import torch
    from subword_tokenizers_tpu_torch.ops import train_loop
    from subword_tokenizers_tpu_torch.ops.flat import EPOCH, build_flat
    st = train_loop.FlatState(*build_flat(arrays.sym, arrays.freq), dev)
    t = type(table)(table.strings())
    run = train_loop.BlockRunner(st, t, 8000, max_len, K, False, True, 0,
                                 False)
    kept = [*st._bufs[st._cur], run.h1, run.h2, run.sl, run.ctrl, run.recs]
    initial = [x.clone() for x in kept]

    def restore():
        for x, x0 in zip(kept, initial):
            x.copy_(x0)

    # 2K steps queued step by step: the run's first block, then K more
    run.dispatch(0)
    eager = [run.fetch(0)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.queue_steps()
    t_queue = time.perf_counter() - t0
    torch.cuda.synchronize()
    eager.append(run.recs.cpu().numpy())
    if not eager[0][:K, 4].all() or not eager[1][:K, 4].all():
        raise AssertionError("phase 6d: a reference block has an inactive "
                             "step")
    epoch0 = int(st.scratch.words[EPOCH])
    bad, host_ms, dev_ms = [], [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for r in range(reps):
        restore()
        start.record()
        t0 = time.perf_counter()
        run.dispatch(r % 2)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        got = run.fetch(r % 2)
        dev_ms.append(start.elapsed_time(end))
        if not np.array_equal(got[:K + 1], eager[0][:K + 1]):
            bad.append(r)
    restore()
    run.dispatch(0)
    run.dispatch(1)
    pair = [run.fetch(0), run.fetch(1)]
    epochs = int(st.scratch.words[EPOCH]) - epoch0
    captures = len(run.graphs)
    run.close()
    if bad or any(not np.array_equal(g[:K + 1], e[:K + 1])
                  for g, e in zip(pair, eager)) or captures != 1:
        raise AssertionError(f"phase 6d: replays {bad} of {reps} differ "
                             f"from the block queued step by step, or the "
                             f"pair differs, or {captures} captures")
    if epochs != K * (reps + 2):
        raise AssertionError(f"phase 6d: K3's epoch word advanced {epochs} "
                             f"times in {reps + 2} replays of {K} steps")
    host_ms.sort()
    dev_ms.sort()
    print(f"phase 6d: one block of {K} flat BPE steps captured once and "
          f"replayed {reps} times, each from a copy of train-85k's initial "
          f"state: every replay's records [{K + 1}, 6] equal the block "
          f"queued step by step, two replays back to back equal {2 * K} "
          f"steps queued step by step, K3's epoch word advanced once a "
          f"step on the device ({epochs}); the host queues a block step "
          f"by step in {t_queue * 1e3:.3f} ms, a replay (records' copy "
          f"included) in median {host_ms[len(host_ms) // 2]:.3f} ms (max "
          f"{host_ms[-1]:.3f}); a replayed block's device time median "
          f"{dev_ms[len(dev_ms) // 2]:.3f} ms (CUDA events, the first "
          f"replay's capture included in its host time); {smi}")


def phase11(dev, rng, flat_bpe, table, flat_wp, table_wp, sym_pad, max_len,
            smi):
    """Phase 11: the slice's kernels against their plain versions, exactly
    (K1 and K3 in skip mode and the overflow guard, K3p, K2's tournament
    mode), and their times at the main path's shapes. Returns (errs,
    timing, bounds, notes)."""
    import numpy as np
    import torch
    from subword_tokenizers_tpu_torch.ops import train_loop
    from subword_tokenizers_tpu_torch.ops.flat import (EPOCH, GATE,
                                                       MergeScratch,
                                                       merge_skip,
                                                       merge_skip_ref,
                                                       skip_guard,
                                                       skip_guard_ref)
    from subword_tokenizers_tpu_torch.ops.merge import (apply_merge,
                                                        apply_merge_ref)
    from subword_tokenizers_tpu_torch.ops.pairstats import (
        EMPTY_KEY, TablePair, canonical, pair_stats, pair_stats_ref,
        symbol_freqs)
    from subword_tokenizers_tpu_torch.ops.train_loop import (select_unify,
                                                             select_unify_ref)
    names = ("pair_stats_skip", "pair_stats_rows", "skip_guard",
             "merge_skip", "merge_rows", "select_unify_tournament")
    errs = dict.fromkeys(names, 0)
    timing, bounds = {}, {}
    notes = {"guard_fired": 0, "skip_states": 0, "rows_states": 0,
             "tournament_tables": 0, "redos": {}}

    def err_all(got, want):
        return max(max_err(g, w) for g, w in zip(got, want))

    def clone(*ts):
        return [t.clone() for t in ts]

    def check_skip(fs, wid, wgt, S, recs):
        """K1 and K3 in skip mode and the guard, on one state: K3 with an
        inactive record (the gate of the state as it stands), then with
        each record, each followed by the guard reading its gate, and by
        the block's closing compaction (the guard with a record); the
        kernels' scratch words (the weight, the epoch word and the gate)
        against the plain versions', which take the epoch and the gate
        from the same words."""
        errs["pair_stats_skip"] = max(errs["pair_stats_skip"], err_all(
            canonical(*pair_stats(fs, wid, wgt, skip=S)),
            pair_stats_ref(fs, wid, wgt, S)))
        sc_k, sc_r = MergeScratch(fs.shape[0], dev), MergeScratch(
            fs.shape[0], dev)
        cap = int(fs.max()) + 2
        sf = symbol_freqs(fs, wgt, cap)
        for row in [[0] * 6] + recs:
            rec = torch.tensor(row, dtype=torch.int32, device=dev)
            got, want = clone(fs, wid, wgt, sf), clone(fs, wid, wgt, sf)
            merge_skip(*got[:3], rec, S, got[3], scratch=sc_k)
            merge_skip_ref(*want[:3], rec, S, want[3], sc_r.words)
            errs["merge_skip"] = max(
                errs["merge_skip"], err_all(got, want),
                max_err(got[3], symbol_freqs(got[0], got[2], cap)),
                max_err(sc_k.words[[0, EPOCH, GATE]],
                        sc_r.words[[0, EPOCH, GATE]]))
            cnt_k = torch.zeros(1, dtype=torch.int32, device=dev)
            cnt_r = cnt_k.clone()
            skip_guard(*got[:3], cnt_k, sc_k)
            skip_guard_ref(*want[:3], cnt_r, sc_r.words)
            errs["skip_guard"] = max(errs["skip_guard"], err_all(
                [*got[:3], cnt_k, sc_k.words[[EPOCH, GATE]]],
                [*want[:3], cnt_r, sc_r.words[[EPOCH, GATE]]]))
            notes["guard_fired"] += int(cnt_k)
            # the block's closing compaction, in place whatever the gate
            got, want = clone(fs, wid, wgt), clone(fs, wid, wgt)
            merge_skip(*got, rec, S, scratch=sc_k)
            merge_skip_ref(*want, rec, S, words=sc_r.words)
            close_k = torch.zeros(6, dtype=torch.int32, device=dev)
            close_r = close_k.clone()
            skip_guard(*got, None, sc_k, close=close_k)
            skip_guard_ref(*want, None, sc_r.words, close_r)
            errs["skip_guard"] = max(errs["skip_guard"], err_all(
                [*got, close_k, sc_k.words[[EPOCH, GATE]]],
                [*want, close_r, sc_r.words[[EPOCH, GATE]]]))
        notes["skip_states"] += 1

    def records(fs, wid, wgt, S):
        keys, counts, _ = pair_stats_ref(fs, wid, wgt, S)
        top = int(keys[counts.argmax()])
        live = fs[fs >= 0]
        mode = int(live.mode().values)
        n = int(fs.max()) + 1
        return [[top >> 32, top & 0xFFFFFFFF, n, 0, 1, 0],
                [mode, mode, n, 0, 1, 0],
                [top >> 32, top & 0xFFFFFFFF, n, 0, 0, 0]]

    for S, holes, gaps in ((2, 0.3, 0), (3, 0.2, 2), (8, 0.3, 2),
                           (12, 0.4, 2), (64, 0.5, 2), (12, 0.05, 0)):
        fs, wid, wgt = (torch.from_numpy(x).to(dev) for x in
                        skip_random_state(rng, 4000, 12, 3, holes, gaps))
        check_skip(fs, wid, wgt, S, records(fs, wid, wgt, S))
    # the kernels' tile edges: self-merge runs longer than a tile across
    # them, gaps at an edge and inside the slots a tile stages from its
    # neighbours; and 2,048 tiles, more than the card holds at once
    for kind, S in (("runs", 1), ("runs", 12), ("runs", 64), ("edge", 2),
                    ("edge", 64), ("halo", 12), ("halo", 64)):
        fs, wid, wgt = (torch.from_numpy(x).to(dev) for x in
                        skip_tile_state(rng, kind, 4 * 2048 + 640))
        check_skip(fs, wid, wgt, S, records(fs, wid, wgt, S))
    fs, wid, wgt = (torch.from_numpy(x).to(dev) for x in
                    skip_tile_state(rng, "halo", 2048 * 2048))
    check_skip(fs, wid, wgt, 12, records(fs, wid, wgt, 12))
    # the train-85k state after 1,000 skip-mode merges (window 12)
    state = train_loop.FlatState(*flat_bpe, dev)
    t1000 = type(table)(table.strings())
    fired = skip_steps(state, t1000, 1000, 12, max_len, dev)
    fs, wid, wgt = state.arrays()
    live = fs >= 0
    n_dead = int(torch.nonzero(live).max()) + 1 - int(live.sum())
    for S in (2, 12):
        check_skip(fs, wid, wgt, S, records(fs, wid, wgt, S))

    # K3p: random padded rows, and the train-85k tensor
    def check_rows(sym):
        pst = train_loop.PaddedState(sym.cpu().numpy(), np.ones(
            sym.shape[0], np.int64), dev)
        errs["pair_stats_rows"] = max(errs["pair_stats_rows"], err_all(
            canonical(*pst.pairs()), pair_stats_ref(
                pst.sym.view(-1), pst._wid, pst._wgt)))
        keys, counts, _ = pair_stats_ref(pst.sym.view(-1), pst._wid,
                                         pst._wgt)
        top = int(keys[counts.argmax()]) if keys.numel() else 7 << 32 | 8
        mode = int(sym[sym >= 0].mode().values)
        n = int(sym.max()) + 1
        for row in ([top >> 32, top & 0xFFFFFFFF, n, 0, 1, 0],
                    [mode, mode, n, 0, 1, 0], [7, 7, n, 0, 0, 0]):
            rec = torch.tensor(row, dtype=torch.int32, device=dev)
            got = apply_merge(sym.clone(), rec)
            errs["merge_rows"] = max(errs["merge_rows"], max_err(
                got, apply_merge_ref(sym, rec)))
        notes["rows_states"] += 1
        return rec

    for W, L, n_sym in ((3000, 12, 3), (3000, 33, 2), (512, 1, 3),
                        (4000, 24, 6)):
        sym, _ = bpe_random_case(rng, W, L, n_sym, 1, inner_pad=True)
        check_rows(torch.from_numpy(sym).to(dev))
    sym85 = torch.from_numpy(sym_pad).to(dev)
    check_rows(sym85)

    # K2's tournament mode: equal to the exact mode's record
    z = torch.zeros(1, dtype=torch.int64, device=dev)
    redo = torch.zeros(1, dtype=torch.int32, device=dev)

    def check_tournament(tab, sf, want_redo=None):
        rec_k = torch.zeros(6, dtype=torch.int32, device=dev)
        rec_e, rec_t = rec_k.clone(), rec_k.clone()
        ctrl = torch.zeros(3, dtype=torch.int32, device=dev)
        before = int(redo)
        select_unify(*tab, z, z, z, ctrl, z, z, 0, rec_k, True, True, sf,
                     tournament=True, redo=redo)
        after = int(redo)
        select_unify_ref(*tab, z, z, z, ctrl, z, z, 0, rec_e, True, True, sf)
        select_unify_ref(*tab, z, z, z, ctrl, z, z, 0, rec_t, True, True, sf,
                         tournament=True, redo=redo.clone())
        errs["select_unify_tournament"] = max(
            errs["select_unify_tournament"], max_err(rec_k, rec_e),
            max_err(rec_k, rec_t))
        if want_redo is not None and after - before != want_redo:
            raise AssertionError(f"tournament redo {after - before}, "
                                 f"expected {want_redo}")
        notes["tournament_tables"] += 1
        return after - before, rec_k

    def table_of(entries, T):
        keys = torch.full((T,), EMPTY_KEY, dtype=torch.int64)
        counts = torch.zeros(T, dtype=torch.int64)
        pos = torch.zeros(T, dtype=torch.int32)
        slots = torch.from_numpy(rng.permutation(T)[:len(entries)])
        for s, (a, b, c, p) in zip(slots.tolist(), entries):
            keys[s], counts[s], pos[s] = (a << 32) | b, c, p
        return [x.to(dev) for x in (keys, counts, pos)]

    q, p = (1 << 26) - 1, (1 << 26) - 3
    c1 = (1 << 25) - 1
    c2 = (c1 * p - 1) // q
    A = (1 << 20) + 7
    sf_b = torch.tensor([1, A, p, q, 1], dtype=torch.int64, device=dev)
    for pos1, pos2 in ((5, 9), (9, 5)):  # the Bezout near tie: a redo
        check_tournament(table_of([(1, 3, c1, pos1), (1, 2, c2, pos2)], 64),
                         sf_b, 1)
    sf_t = torch.tensor([1, 12, 18, 18, 12], dtype=torch.int64, device=dev)
    _, rec = check_tournament(table_of([(1, 2, 6, 11), (3, 4, 6, 3)], 64),
                              sf_t, 0)  # an exact tie: the least position
    if rec.tolist()[:2] != [3, 4]:
        raise AssertionError(f"exact tie won by {rec.tolist()}")
    sf_c = torch.tensor([1, 10, 20, 30, 1], dtype=torch.int64, device=dev)
    check_tournament(table_of([(1, 2, 7, 4), (2, 3, 5, 2)], 64), sf_c, 0)
    for k in range(8):  # random tables, weights from a few values (ties)
        n_sym = 40
        sf_r = torch.from_numpy(rng.choice([1 << 10, 3 << 9, 1 << 11, 5],
                                           size=n_sym)).to(dev)
        pairs = {(int(a), int(b)) for a, b in
                 rng.integers(0, n_sym, size=(3000, 2))}
        entries = [(a, b, int(rng.integers(1, 20 if k % 2 else 3)),
                    int(i * 7 + 1)) for i, (a, b) in enumerate(pairs)]
        check_tournament(table_of(entries, 4096), sf_r)
    # the train-85k WordPiece tables: initial, and after 1,000 merges
    fs_w, wid_w, wgt_w = (torch.from_numpy(x).to(dev) for x in flat_wp)
    sf_w = symbol_freqs(fs_w, wgt_w, 8008)
    pair_w = TablePair(fs_w.shape[0], dev)  # K2 times over its claims
    tab_w = pair_w.pairs(fs_w, wid_w, wgt_w)
    notes["redos"]["85k initial"], _ = check_tournament(tab_w, sf_w)
    st_w = train_loop.FlatState(*flat_wp, dev)
    tw = type(table_wp)(table_wp.strings())
    skip_steps(st_w, tw, 1000, 12, max_len, dev, wordpiece=True)
    notes["redos"]["85k after 1,000"], _ = check_tournament(
        st_w.pairs(12), st_w.sym_freq)
    if any(errs.values()):
        raise AssertionError(f"a kernel of this slice differs: {errs}")

    # times at the main path's shapes: the 85k state after 1,000
    # skip-mode merges (window 12), the 85k padded tensor, the 85k
    # WordPiece table
    k1 = TablePair(fs.shape[0], dev)
    tab = k1.pairs(fs, wid, wgt, skip=12)
    rec = records(fs, wid, wgt, 12)[0]
    rec = torch.tensor(rec, dtype=torch.int32, device=dev)
    cnt = torch.zeros(1, dtype=torch.int32, device=dev)
    work = clone(fs, wid, wgt)
    ovf = skip_random_state(rng, 40000, 12, 3, 0.3, 4)
    ovf = [torch.from_numpy(x).to(dev) for x in ovf]
    F = fs.shape[0]
    n_live = int((fs >= 0).sum())
    timing["pair_stats_skip"] = (
        cuda_ms(lambda: k1.pairs(fs, wid, wgt, skip=12), 200, True),
        cuda_ms(lambda: pair_stats_ref(fs, wid, wgt, 12), 5))
    # K3 with the record's matches: the state restored before each call
    # (three copies, timed alone and taken off); then passes with no
    # match left, as most of a step's tiles are
    sc = MergeScratch(F, dev)
    work0 = clone(*work)

    def restore_work():
        for dst, src in zip(work, work0):
            dst.copy_(src)

    t_restore = cuda_ms(restore_work, 100, True)
    timing["merge_skip_merging"] = (
        cuda_ms(lambda: (restore_work(), merge_skip(*work, rec, 12,
                                                    scratch=sc)), 100, True)
        - t_restore,
        cuda_ms(lambda: (restore_work(), merge_skip_ref(*work, rec, 12)), 5)
        - t_restore)
    changed = [int((w != w0).sum()) for w, w0 in zip(work, work0)]
    timing["merge_skip"] = (
        cuda_ms(lambda: merge_skip(*work, rec, 12, scratch=sc), 200, True),
        cuda_ms(lambda: merge_skip_ref(*work, rec, 12), 5))
    # the guard with its gate closed (each call closes it)
    timing["skip_guard"] = (
        cuda_ms(lambda: skip_guard(*work, cnt, sc), 200, True),
        cuda_ms(lambda: skip_guard_ref(*work, cnt, sc.words), 5))
    # The guard fired: a state with 70-slot gaps at window 2, its gate
    # opened by an inactive K3; a compaction ends the overflow and closes
    # the gate, so each timed call first restores the state and the gate
    # word, as above.
    sc_o = MergeScratch(ovf[0].shape[0], dev)
    merge_skip(*ovf, torch.zeros(6, dtype=torch.int32, device=dev), 2,
               scratch=sc_o)
    opened = sc_o.words[GATE:GATE + 1].clone()
    if not int(opened) & 1:
        raise AssertionError("the gapped state does not overflow")
    ovf0 = clone(*ovf)

    def restore():
        for dst, src in zip(ovf, ovf0):
            dst.copy_(src)
        sc_o.words[GATE:GATE + 1].copy_(opened)

    t_restore = cuda_ms(restore, 100, True)
    fired0 = int(cnt)
    timing["skip_guard_fired"] = (
        cuda_ms(lambda: (restore(), skip_guard(*ovf, cnt, sc_o)), 100, True)
        - t_restore,
        cuda_ms(lambda: (restore(), skip_guard_ref(*ovf, cnt, sc_o.words)),
                5)
        - t_restore)
    if int(cnt) - fired0 != 101 + 6:  # every call compacted
        raise AssertionError(f"the timed guard fired {int(cnt) - fired0} "
                             f"times of 107")
    sym_t = sym85.clone()
    rec_p = check_rows(sym85)
    rec_p = torch.tensor([int(rec_p[0]), int(rec_p[1]), 9000, 0, 1, 0],
                         dtype=torch.int32, device=dev)
    timing["merge_rows"] = (
        cuda_ms(lambda: apply_merge(sym_t, rec_p), 200, True),
        cuda_ms(lambda: apply_merge_ref(sym_t, rec_p), 5))
    h1, h2, sl, ctrl, pw1, pw2, sharp = train_loop.init_tables(
        table_wp, 8000, max_len, dev)
    rec_w = torch.zeros(6, dtype=torch.int32, device=dev)
    tab_ref = pair_stats_ref(fs_w, wid_w, wgt_w)
    n_pairs_w = int(tab_ref[0].shape[0])
    k2_scratch = train_loop.select_scratch(dev)
    timing["select_unify_tournament"] = (
        cuda_ms(lambda: select_unify(*tab_w, h1, h2, sl, ctrl, pw1, pw2,
                                     8000, rec_w, False, True, sf_w, sharp,
                                     True, redo, claims=pair_w.claims(),
                                     scratch=k2_scratch), 200, True),
        cuda_ms(lambda: select_unify_ref(*tab_ref, h1, h2, sl, ctrl, pw1,
                                         pw2, 8000, rec_w, False, True,
                                         sf_w, sharp, True, redo), 5))
    timing["select_unify_exact_wp"] = (
        cuda_ms(lambda: select_unify(*tab_w, h1, h2, sl, ctrl, pw1, pw2,
                                     8000, rec_w, False, True, sf_w, sharp,
                                     claims=pair_w.claims(),
                                     scratch=k2_scratch), 200, True), None)
    n_rows, L = sym85.shape
    # Bytes: each input read once and each output written once (the
    # in-place kernels count the slots they change, low: none); the pair
    # table as K1's; K2's tournament reads each live entry through the
    # claim list with its two weights (40) and the h1 of each id below
    # n_sym. Operations, counted low: a window probe and a hash insert per
    # live slot (10), a liveness test per slot (2), a match test per slot
    # (6), a move per row slot (2), a 128-bit compare per live entry (12).
    bounds["pair_stats_skip"] = bound(nbytes(fs, wid, wgt, *tab),
                                      10 * n_live)
    # The guard: the gate word (closed), or every slot read and written
    # (fired); K3 in skip mode: fs and wid read, the record, the weight and
    # gate words written, and, merging, the changed words and the matches'
    # weights (changed: fs, wid and wgt words that differ after the merge)
    bounds["skip_guard"] = bound(8, 1)
    bounds["skip_guard_fired"] = bound(2 * nbytes(*ovf), 8 * ovf[0].shape[0])
    bounds["merge_skip"] = bound(nbytes(fs, wid, rec) + 16, 6 * F)
    bounds["merge_skip_merging"] = bound(
        nbytes(fs, wid, rec) + 16 + 4 * changed[0] + 4 * changed[1]
        + 16 * changed[2], 6 * F)
    bounds["merge_rows"] = bound(nbytes(sym85, rec_p), 2 * n_rows * L)
    bounds["select_unify_tournament"] = bound(
        40 * n_pairs_w + 8 * int(ctrl[0]) + nbytes(ctrl, rec_w),
        12 * n_pairs_w)
    notes.update(fired_1000=fired, dead_1000=n_dead, F=F, n_live=n_live,
                 rows=(n_rows, L), merge_skip_changed=changed)
    torch.cuda.synchronize()
    print(f"phase 11: the slice's kernels equal their plain versions "
          f"exactly: K1 and K3 in skip mode and the guard on "
          f"{notes['skip_states']} states (windows 2, 3, 8, 12, 64 with "
          f"holes, runs and 70-slot gaps; the 85k state after 1,000 "
          f"skip-mode merges, {n_dead} dead slots, at windows 2 and 12; the "
          f"guard compacted {notes['guard_fired']} of them, and {fired} "
          f"times in the 1,000 merges; tile edges: runs longer than a "
          f"tile, gaps at the edges and in the staged neighbours, windows "
          f"1-64; 2,048 tiles at window 12), K1 and K3p on "
          f"{notes['rows_states']} padded states (lengths 0, 1, L, PADs "
          f"inside, the {n_rows} x {L} train-85k tensor), K2's tournament "
          f"on {notes['tournament_tables']} tables (the Bezout near tie "
          f"redone in both orders, an exact tie to the least position, a "
          f"clear order, 8 random, the 85k WordPiece tables: redos "
          f"{notes['redos']}); at F = {F} ({n_live} live): " + ", ".join(
              f"{k} {timing[k][0]:.4f} ms (plain {timing[k][1]:.3f}, bound "
              f"{bounds[k][0]:.6f})" for k in (
                  "pair_stats_skip", "skip_guard", "skip_guard_fired",
                  "merge_skip", "merge_skip_merging", "merge_rows",
                  "select_unify_tournament"))
          + f"; ptxas merge_skip_kernel: {ptxas_lines('merge_skip_kernel')}"
          + f"; merge_tiles_kernel<true>: "
          f"{ptxas_lines('merge_tiles_kernelILb1')}"
          + f"; exact WordPiece K2 on the same table "
          f"{timing['select_unify_exact_wp'][0]:.4f} ms; {smi}")
    return errs, timing, bounds, notes


ROUTES = (
    # (name, model, environment, flat)
    ("bpe_skip12", "NaiveBPE", {"SWT_SKIP_COMPACT": "12"}, True),
    ("bpe_skip2", "NaiveBPE", {"SWT_SKIP_COMPACT": "2"}, True),
    ("wp_skip12", "NaiveWP", {"SWT_SKIP_COMPACT": "12"}, True),
    ("wp_tournament", "NaiveWP", {"SWT_WP_TOURNAMENT": "1"}, True),
    ("bpe_padded", "NaiveBPE", {}, False),
    ("wp_padded", "NaiveWP", {}, False),
)


def route_counters():
    """{name: the profiler's counter} of every launch and event count the
    routes of phase 12 read."""
    return {"pair_stats": "launch.pair_stats",
            "pair_stats_skip": "launch.pair_stats.skip",
            "select_unify": "launch.select_unify",
            "select_unify_tournament": "launch.select_unify.tournament",
            "merge_apply": "launch.merge_apply",
            "merge_skip": "launch.merge_skip",
            "skip_guard": "launch.skip_guard",
            "skip_close": "launch.skip_guard.close",
            "merge_rows": "launch.apply_merge",
            "symbol_freqs": "launch.symbol_freqs",
            "symbol_rows": "launch.symbol_rows",
            "overflow_compactions": "train.overflow_compactions",
            "risky_redos": "train.redos"}


# The kernels each route must launch (phase 12).
ROUTE_KERNELS = {
    "bpe_skip12": ("pair_stats_skip", "skip_guard", "skip_close",
                   "merge_skip", "select_unify"),
    "bpe_skip2": ("pair_stats_skip", "skip_guard", "skip_close",
                  "merge_skip", "overflow_compactions"),
    "wp_skip12": ("pair_stats_skip", "skip_guard", "skip_close",
                  "merge_skip", "symbol_freqs"),
    "wp_tournament": ("select_unify_tournament", "pair_stats", "merge_apply"),
    "bpe_padded": ("pair_stats", "merge_rows", "select_unify"),
    "wp_padded": ("pair_stats", "merge_rows", "symbol_rows"),
}


def phase12(dev, corpus, check_bpe, check_wp, smi, trace_dir,
            max_vocab=8000, overflows=None):
    """Phase 12: each route of this slice trains all of ``corpus`` to
    ``max_vocab`` (a cold, a warm and a profiled run), each run checked against
    the JAX golden by ``check_bpe`` / ``check_wp``, the skip routes' overflow
    compactions against the JAX package's count a run (``overflows``:
    {route: count}, None to skip that check); then (12c) one skip-route
    run under torch.profiler, its device blocks counted: the kernel
    launches a step (the wrappers' counts), the allocations a block
    (``torch.cuda.memory_stats``), and from the trace the memsets and
    the kernels it holds once a step. Returns ({route: launches of its
    three runs}, 12c's numbers)."""
    import contextlib
    import functools
    import torch
    from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP
    from subword_tokenizers_tpu_torch.benchmarks import profiling
    from subword_tokenizers_tpu_torch.ops import train_loop
    models = {"NaiveBPE": NaiveBPE, "NaiveWP": NaiveWP}
    counters = route_counters()
    real_run = train_loop.run_fused
    saved = {k: os.environ.get(k) for k in ("SWT_SKIP_COMPACT",
                                           "SWT_WP_TOURNAMENT")}
    by_route, lines = {}, []
    try:
        for name, model, env, flat in ROUTES:
            for k in saved:
                os.environ.pop(k, None)
            os.environ.update(env)
            train_loop.run_fused = real_run if flat else functools.partial(
                real_run, flat=False)
            base = {k: counter(n) for k, n in counters.items()}
            g = graph_counts()
            walls = []
            # run 0 is cold (the route's first), run 1 warm, run 2 warm
            # with the phase profiler on
            for run in range(3):
                profiling.enable(run == 2)
                reset_spans()
                tok = models[model](device=dev)
                t0 = time.perf_counter()
                tok.train(corpus, max_vocab)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                (check_bpe if model == "NaiveBPE" else check_wp)(
                    tok, f"{name} run {run}")
            phases = span_ms(profiling.report())
            profiling.enable(False)
            counts = {k: counter(n) - base[k] for k, n in counters.items()}
            missing = [k for k in ROUTE_KERNELS[name] if not counts[k]]
            if missing:
                raise AssertionError(f"{name}: nothing counted for "
                                     f"{missing}: {counts}")
            # every block, queued or replayed, runs K1 and K2 256 times
            blocks, graphs = graph_check(g, 3, name)
            if counts["pair_stats"] != 256 * blocks or \
                    counts["select_unify"] != 256 * blocks:
                raise AssertionError(f"{name}: {counts} for {blocks} "
                                     f"blocks of 256 steps")
            # the skip routes: a guard and a skip merge a step, and the
            # closing compaction (the guard's kernel) once a block
            if "skip" in name and (
                    counts["merge_skip"] != 256 * blocks
                    or counts["skip_guard"] != 257 * blocks
                    or counts["skip_close"] != blocks
                    or counts["merge_apply"]):
                raise AssertionError(f"{name}: {counts} for {blocks} "
                                     f"blocks of 256 steps")
            if overflows is not None and name in overflows and counts[
                    "overflow_compactions"] != 3 * overflows[name]:
                raise AssertionError(
                    f"{name}: {counts['overflow_compactions']} overflow "
                    f"compactions in 3 runs, the JAX package's "
                    f"{overflows[name]} a run")
            by_route[name] = counts
            lines.append(
                f"{name} cold {walls[0]:.3f} s, warm {walls[1]:.3f} s, "
                f"profiled {walls[2]:.3f} s, {graphs}, phases (ms) "
                f"{json.dumps(phases)}, counts of 3 runs "
                f"{ {k: v for k, v in counts.items() if v} }")
        os.environ.pop("SWT_WP_TOURNAMENT", None)
        os.environ["SWT_SKIP_COMPACT"] = "12"
        train_loop.run_fused = real_run
        # each device block's allocations (a capture checks its own
        # steps: capture_begin may allocate PyTorch's RNG state for
        # graphs, which is counted apart), and the kernel launches (the
        # wrappers' counts, replays included)
        inside, captured = [], []
        real_phase = profiling.phase

        @contextlib.contextmanager
        def counted_phase(name, device=None):
            allocated = torch.cuda.memory_stats(dev)[
                "allocation.all.allocated"]
            with real_phase(name, device):
                yield
            if name in ("train.device_block", "train.capture"):
                (inside if name == "train.device_block" else
                 captured).append(torch.cuda.memory_stats(dev)[
                     "allocation.all.allocated"] - allocated)

        def train():  # the traced call's blocks only
            inside.clear()
            captured.clear()
            NaiveBPE(device=dev).train(corpus, max_vocab)

        fn, marks = traced_train(train)
        profiling.phase = counted_phase
        try:
            wall, busy, by_name = device_trace(
                fn, os.path.join(trace_dir, "skip_train_trace.json"),
                warmup=True)
        finally:
            profiling.phase = real_phase
        before, g = marks[-1]
        blocks, graphs = graph_check(g, 1, "phase 12c")
        launched = sum(block_counters().values()) - sum(before.values())
        traced = traced_launches(
            by_name, before, {"pair_stats": 256, "select_unify": 256,
                              "merge_skip": 256, "skip_guard": 257},
            blocks, "phase 12c")
        api_line = trace_graph_line(by_name)
    finally:
        train_loop.run_fused = real_run
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    steps = 256 * blocks
    allocs = inside
    per_step = launched / steps
    step_kernels = {n: c for n, (c, _) in by_name.items()
                    if "memcpy" not in n.lower() and "memset" not in n.lower()
                    and c >= steps // 2}
    skip_ms = sum(ms for n, (_, ms) in by_name.items()
                  if "merge_skip_kernel" in n
                  or "merge_tiles_kernel<true>" in n)
    notes = dict(blocks=blocks, launches_a_step=per_step,
                 allocations_first_block=allocs[0] if allocs else None,
                 allocations_later_blocks=sum(allocs[1:]),
                 allocations_captures=captured,
                 memsets=memsets(by_name) if by_name else None,
                 traced_step_kernels=step_kernels if by_name else None,
                 guard_and_merge_skip_device_ms=skip_ms if by_name else None,
                 traced_launches=traced, wall_ms=wall, busy_ms=busy)
    if (not inside or sum(allocs[1:]) or per_step > 4 + 1 / 256
            or (by_name and (notes["memsets"] or len(step_kernels) > 4))):
        raise AssertionError(f"the traced skip train: {notes}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    dev_line = ("not measured (the trace holds no device events)"
                if not by_name else
                f"device busy {busy:.3f} ms of {wall:.1f} ms (idle share "
                f"{1 - busy / wall:.4f}); "
                + "; ".join(f"{n} x{c} {ms:.3f} ms" for n, (c, ms) in top)
                + f"; the guard and K3 skip together {skip_ms:.3f} ms; "
                f"{notes['memsets']} memsets; the kernels once a step "
                f"{sorted(step_kernels.values())}; {api_line}")
    print(f"phase 12: all of {len(corpus)} sentences to {max_vocab} through "
          f"each route equal the JAX golden (merges; WordPiece's vocab too)"
          + ("" if overflows is None else
             f", the skip routes' overflow compactions the JAX package's "
             f"{overflows} a run")
          + ": " + "; ".join(lines) + f"; {smi}")
    print(f"phase 12c: one warm NaiveBPE train with SWT_SKIP_COMPACT=12 "
          f"under torch.profiler: {graphs}; {per_step:.4f} kernel launches "
          f"a step (4 a step and the block's closing compaction), kernel "
          f"spans in the trace {traced}, equal to the launches the "
          f"counters counted in this train (the guard's kernel 256 a "
          f"block and the closing compaction), "
          f"allocations: {allocs[0]} in the first block (K1's tables, made "
          f"by the first count), {sum(allocs[1:])} in the {blocks - 1} "
          f"replays after it, {captured} in the captures' spans (none in "
          f"their steps, which each capture checks: PyTorch's RNG state "
          f"for graphs at its first capture_begin); {dev_line}; {smi}")
    return by_route, notes


def padded_random(rng, n, L, n_sym, wscale=1):
    """Seeded padded rows [n, L] (runs of one symbol, lengths 0 to L, PAD
    at the end) and their weights."""
    import numpy as np
    sym = np.full((n, L), -1, dtype=np.int32)
    for r in range(n):
        s = int(rng.integers(0, n_sym))
        for j in range(int(rng.integers(0, L + 1))):
            if rng.random() > 0.5:
                s = int(rng.integers(0, n_sym))
            sym[r, j] = s
    return sym, rng.integers(1, 50, size=n).astype(np.int64) * wscale


# Hand-made certificate cases (kth rows, candidates, summed counts, the
# record, sym_freq or None, wide scores), the CPU tests' and a near tie:
# each shard's K-th (metric, count, key), the winner (1, 2).
_KEY = (1 << 32) | 2
_KTH1 = [1, 1, (3 << 32) | 4]
CERT_CASES = (
    ([[4, 4, 0], [5, 5, 0]], [_KEY], [10], None, False),
    ([[4, 4, 0], [6, 6, 0]], [_KEY], [10], None, False),
    ([[-1, 0, 0], [-1, 0, 0]], [_KEY], [1], None, False),   # sum t == 0
    ([_KTH1], [_KEY], [6], [0, 3, 4, 2, 2], False),
    ([_KTH1, _KTH1], [_KEY], [6], [0, 3, 4, 2, 2], False),
    ([_KTH1], [_KEY], [1], [0, 2, 2, 2, 2], False),          # an exact tie
    ([[1, 1 << 20, (3 << 32) | 4], [-1, 0, 0]], [_KEY], [6],
     [0, 3, 4, 0, 2], False),                                # saturated
    ([_KTH1], [_KEY], [6], [0, 3, 4, 1 << 31, 1 << 31], True),  # unsafe
    ([_KTH1], [_KEY], [6], [0, 3, 4, 1 << 31, 1 << 31], False),
    # a near tie: (2^30 + 1) / d against 2^30 / d, d = 2^36 + 1, inside
    # the margin
    ([[1, 1 << 30, (3 << 32) | 4]], [_KEY], [(1 << 30) + 1],
     [0, (1 << 36) + 1, 1, (1 << 36) + 1, 1], False),
)


def dense_table(rng, T, fill, cmax, n_ids, dev):
    """A table of K1's shape (keys, counts, pos) of ``T`` entries, a
    share ``fill`` of them live, with unique keys a << 32 | b (a, b <
    ``n_ids``) at random slots and counts below ``cmax`` (all 7 when
    ``cmax`` is 1)."""
    import numpy as np
    import torch
    n = int(T * fill)
    draw = 2 * n + 16
    keys_live = np.unique((rng.integers(0, n_ids, draw) << 32)
                          | rng.integers(0, n_ids, draw))
    rng.shuffle(keys_live)
    keys_live = keys_live[:n]
    slots = rng.permutation(T)[:keys_live.shape[0]]
    keys = np.full(T, -1, dtype=np.int64)
    keys[slots] = keys_live
    counts = np.zeros(T, dtype=np.int64)
    counts[slots] = 7 if cmax == 1 else rng.integers(0, cmax, slots.shape[0])
    pos = np.zeros(T, dtype=np.int32)
    pos[slots] = np.arange(slots.shape[0])
    return tuple(torch.from_numpy(x).to(dev) for x in (keys, counts, pos))


def ptxas_lines(kernel: str) -> str:
    """ptxas's registers and spills of a kernel, from this process's
    build of the kernels' library."""
    from subword_tokenizers_tpu_torch.ops import _cuda
    lines = _cuda.build_log.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "Function properties for" in ln and kernel in ln:
            out += [x.strip() for x in lines[i + 1:i + 3]
                    if "spill" in x or "registers" in x]
    return "; ".join(out) or "not in this process's build log"


def shard_kernels():
    """{name: its launch counter's name in the port's profiler} of every
    kernel the sharded path launches. "certificate" counts K2's launches
    that ran the certificate (not calls of their own:
    :func:`wrapper_calls` leaves it out), "certificate_launcher" the
    check launcher's, which no training path makes."""
    return {name: "launch." + wrapper for name, wrapper in (
        ("nominate_tables", "nominate_tables"),
        ("lookup_reduce", "lookup_reduce"),
        ("compact_tables", "compact_tables"),
        ("pair_stats_runs", "pair_stats_runs"),
        ("certificate", "select_unify.cert"),
        ("certificate_launcher", "certificate"),
        ("pair_rows", "pair_rows"), ("pair_stats", "pair_stats"),
        ("select_unify", "select_unify"), ("merge_rows", "apply_merge"),
        ("symbol_freqs", "symbol_freqs"), ("symbol_rows", "symbol_rows"),
        ("wp_score", "score_bits"), ("wp_e2e_scan", "wp_e2e_scan"),
        ("compact_ids", "compact_ids"),
        ("wp_e2e_scan_compact", "wp_e2e_scan_compact"))}


def wrapper_calls(counts) -> int:
    """The kernel-wrapper calls in ``counts`` (read_counts of
    :func:`shard_kernels`): the certificate runs in K2's calls."""
    return sum(n for k, n in counts.items() if k != "certificate")


def read_counts(kernels):
    """{name: its counter so far} of ``kernels`` ({name: counter name})."""
    return {name: counter(c) for name, c in kernels.items()}


def counts_since(kernels, before):
    """{name: how far its counter moved} since ``before`` (read_counts of
    ``kernels``)."""
    return {name: n - before[name]
            for name, n in read_counts(kernels).items()}


def phase13(dev, rng, arrays, table, arrays_wp, table_wp, golden,
            wp_merges, smi, trace_dir, n_back_to_back=1000):
    """Phase 13: the shard kernels (the grouped nomination, candidate
    lookup and table compaction, K1's runs mode, the certificate) against
    their plain versions, exactly, on seeded padded states, the corpus's
    8-shard initial state and its state after 1,000 merges (BPE and
    WordPiece), all counts equal, the mesh of 1's one table at both BPE
    states, the nomination also on dense tables (a block's staging
    overflowed, counts to 2^40, wide scores, 2 and 0 live entries), caps
    that overflow on
    every shard and on some shards only, weights scaled wide, and the
    hand-made certificate cases; the grouped kernels over the 8 tables of
    a state (one launch) and over each table alone (the one-table
    wrappers); ``n_back_to_back`` compactions in a row with alternating
    table sets and caps, each compared; then each timed at the corpus's
    shapes with its bound (the compaction's also at the mesh of 1), the
    launch floors, ``torch.nonzero`` over the same keys (the compaction's
    library yardstick, its device time from traces in ``trace_dir``),
    ``torch.topk`` over each shard's metrics (the nomination's), and K1
    and K3p (the golden's 1,001st merge) at a
    shard's shape. Returns (errs, timing, bounds, library, notes)."""
    import numpy as np
    import torch
    from subword_tokenizers_tpu_torch.ops import _cuda
    from subword_tokenizers_tpu_torch.ops.merge import (apply_merge,
                                                        apply_merge_ref)
    from subword_tokenizers_tpu_torch.ops.pairstats import (
        EMPTY_KEY, TablePair, canonical, pair_stats_runs,
        pair_stats_runs_ref)
    from subword_tokenizers_tpu_torch.ops.shard_select import (
        certificate, certificate_ref, compact_table, compact_table_ref,
        compact_tables, compact_tables_ref, lookup_reduce, lookup_reduce_ref,
        lookup_runs, lookup_runs_ref, nominate, nominate_tables,
        nominate_tables_ref, LOW32, ROUND_SPAN, TableSet)
    from subword_tokenizers_tpu_torch.ops.bitmath import score_bits
    from subword_tokenizers_tpu_torch.ops.train_loop import (select_host_ids,
                                                             select_scratch,
                                                             sym_capacity)
    from subword_tokenizers_tpu_torch.parallel import train as ptrain
    from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh
    names = ("nominate_tables", "lookup_reduce", "compact_tables",
             "pair_stats_runs", "certificate", "certificate_fused")
    errs = dict.fromkeys(names, 0)
    timing, bounds, library = {}, {}, {}
    notes = {"states": 0, "overflowed_caps": 0, "mixed_caps": 0,
             "proven": 0, "refused": 0, "grouped_checks": 0,
             "one_table_checks": 0, "mesh1_checks": 0, "nominations": 0,
             "nominate_tables": 0, "short_shards": 0}
    mesh = make_data_mesh(8, devices=[dev] * 8)
    absent = torch.tensor([EMPTY_KEY, (60000 << 32) | 60001, 0],
                          dtype=torch.int64, device=dev)

    def diff(name, got, want):
        errs[name] = max(errs[name], *(max_err(g, w)
                                       for g, w in zip(got, want)))

    def cert(kth, cand, g_cnt, g_pos, rec, sf, wide):
        """The check launcher on K2's winner ``rec``, and K2's dense
        selection with the certificate in its launch, each against the
        plain certificate (after K2's selection alone)."""
        got, want = rec.clone(), rec.clone()
        certificate(kth, cand, g_cnt, got, sf, wide)
        certificate_ref(kth, cand, g_cnt, want, sf, wide)
        errs["certificate"] = max(errs["certificate"], max_err(got, want))
        fused, plain = torch.zeros_like(rec), torch.zeros_like(rec)
        select_host_ids(cand, g_cnt, g_pos, fused, sf, kth=kth,
                        wide_score=wide)
        select_host_ids(cand, g_cnt, g_pos, plain, sf)
        certificate_ref(kth, cand, g_cnt, plain, sf, wide)
        errs["certificate_fused"] = max(errs["certificate_fused"],
                                        max_err(fused, plain))
        notes["proven" if int(plain[5]) else "refused"] += 1

    def check_nominate(tables, k, sf=None):
        """The nomination over ``tables`` in one launch against its plain
        version; returns (cand, kth)."""
        got = nominate_tables(tables, k, sf)
        diff("nominate_tables", got, nominate_tables_ref(tables, k, sf))
        notes["nominations"] += 1
        notes["nominate_tables"] += len(tables)
        notes["short_shards"] += int((got[1].view(-1, 3)[:, 0] < 0).sum())
        return got

    def check(corpus, sf=None, wide=False, topk=ptrain.TOPK):
        """Every kernel against its plain version on one sharded state,
        as the tiers use them: the grouped kernels over the 8 tables in
        one launch, and over each table alone."""
        tables = [s.pairs() for s in corpus.shards]
        bases = corpus.bases
        k = min(topk, corpus.n_local_pairs)
        cand, kth = check_nominate(tables, k, sf)
        for t in tables:
            diff("nominate_tables", nominate(t, k, sf),
                 nominate_tables_ref([t], k, sf))
            notes["one_table_checks"] += 1
        probe = torch.cat([cand, absent])
        for t, base in zip(tables, bases):
            diff("lookup_reduce", lookup_runs(probe, t, base),
                 lookup_runs_ref(probe, t, base))
            notes["one_table_checks"] += 1
        diff("lookup_reduce", lookup_reduce(probe, tables, bases),
             lookup_reduce_ref(probe, tables, bases))
        notes["grouped_checks"] += 1
        g_cnt, g_pos = lookup_reduce(cand, tables, bases)
        rec = torch.zeros(6, dtype=torch.int32, device=dev)
        select_host_ids(cand, g_cnt, g_pos, rec, sf)
        cert(kth, cand, g_cnt, g_pos, rec, sf, wide)
        n_live = sorted(int((t[0] != EMPTY_KEY).sum()) for t in tables)
        cap0 = min(ptrain.run_gather_cap(corpus.n_local_pairs),
                   corpus.n_local_pairs)
        # the main path's cap, one that overflows every shard, and one
        # between the shards' sizes (some overflow, some do not)
        for cap in (cap0, max(n_live[0] // 2, 1), n_live[len(n_live) // 2]):
            for t, base in zip(tables, bases):
                diff("compact_tables", compact_table(t, cap, base),
                     compact_table_ref(t, cap, base))
                notes["one_table_checks"] += 1
            runs = compact_tables(tables, bases, cap)
            diff("compact_tables", runs,
                 compact_tables_ref(tables, bases, cap))
            notes["grouped_checks"] += 1
            over = sum(n > cap for n in n_live)
            notes["overflowed_caps"] += over > 0
            notes["mixed_caps"] += 0 < over < len(n_live)
            gk, gc, gp = runs[:3]
            diff("pair_stats_runs", canonical(*pair_stats_runs(gk, gc, gp)),
                 pair_stats_runs_ref(gk, gc, gp))
        notes["states"] += 1
        return tables, cand, kth, g_cnt, g_pos, rec

    for n, L, n_sym, topk in ((400, 9, 6, 16), (1003, 12, 20, 256),
                              (64, 5, 3, 256)):
        sym, freq = padded_random(rng, n, L, n_sym)
        corpus = ptrain.shard_corpus(mesh, sym, freq)
        check(corpus, topk=topk)
        check(corpus, ptrain.sharded_sym_freq(corpus, n_sym + 9), topk=topk)
    # every pair once, of one weight: all counts equal, the keys decide
    eq_pairs = rng.permutation(300 * 300)[:40000]
    eq_sym = np.stack([eq_pairs // 300, eq_pairs % 300], 1).astype(np.int32)
    equal = ptrain.shard_corpus(mesh, eq_sym,
                                np.full(eq_sym.shape[0], 5, dtype=np.int64))
    check(equal)
    check(equal, ptrain.sharded_sym_freq(equal, 309), topk=16)
    # dense tables the nomination alone takes: blocks of a cluster past
    # its staging (fill 0.5 and 0.6 of 131,072), all counts equal, counts
    # to 2^40 and 0 (a BPE metric that nominates nothing), wide scores, a
    # table of 2 entries and an empty one, one of 2^20 entries
    for T, fill, cmax, n_ids, n_tab in ((1 << 17, 0.5, 1 << 40, 1 << 20, 8),
                                        (1 << 17, 0.6, 1, 1 << 20, 3),
                                        (1 << 17, 0.3, 4, 1 << 20, 2),
                                        (1 << 14, 0.4, 1 << 20, 1 << 12, 2),
                                        (2, 0.5, 9, 4, 1), (64, 0.0, 9, 4, 1),
                                        (1 << 20, 0.3, 1 << 16, 1 << 20, 1)):
        tabs = [dense_table(rng, T, fill, cmax, n_ids, dev)
                for _ in range(n_tab)]
        for k in (ptrain.TOPK, 16, 1):
            check_nominate(tabs, k)
        sf = torch.from_numpy(rng.integers(
            1, 1 << (40 if n_ids == 1 << 12 else 24),
            size=n_ids)).to(dev)
        check_nominate(tabs, ptrain.TOPK, sf)
        check_nominate(tabs, 16, sf)

    def check_mesh1(corpus, shard_tables):
        """The mesh of 1's one table (2^20 entries, 8 clusters of the
        compaction): the one-table wrappers, and the grouped compaction
        over the table twice (two shards of 8 clusters each), at the
        tier's cap, one that overflows and 1; probed with the candidates
        of the 8 shards' tables ``shard_tables`` (a shard's next count
        would empty them)."""
        t = corpus.shards[0].pairs()
        check_nominate([t], ptrain.TOPK)
        check_nominate([t, t], 16)
        probe = torch.cat([check_nominate(shard_tables, ptrain.TOPK)[0],
                           absent])
        diff("lookup_reduce", lookup_runs(probe, t, 0),
             lookup_runs_ref(probe, t, 0))
        n = int((t[0] != EMPTY_KEY).sum())
        cap1 = min(ptrain.run_gather_cap(corpus.n_local_pairs),
                   corpus.n_local_pairs)
        for cap in (cap1, n // 2, 1):
            diff("compact_tables", compact_table(t, cap, 0),
                 compact_table_ref(t, cap, 0))
            diff("compact_tables", compact_tables([t, t], [0, 1 << 20], cap),
                 compact_tables_ref([t, t], [0, 1 << 20], cap))
            notes["mesh1_checks"] += 2
        return t, cap1

    # the corpus: BPE and WordPiece, initial and after 1,000 merges; BPE
    # also on the mesh of 1
    bpe = ptrain.shard_corpus(mesh, arrays.sym, arrays.freq)
    tables = check(bpe)[0]
    mesh1 = ptrain.shard_corpus(make_data_mesh(1, devices=[dev]), arrays.sym,
                                arrays.freq)
    check_mesh1(mesh1, tables)
    t1000 = type(table)(table.strings())
    for sa, sb in golden[:1000]:
        ab = t1000.get(sa), t1000.get(sb), t1000.intern(sa + sb)
        ptrain.sharded_apply_merge(bpe, *ab)
        ptrain.sharded_apply_merge(mesh1, *ab)
    # K3p's timed merge: the golden's 1,001st at this state
    sa, sb = golden[1000]
    rec_k3p = torch.tensor([t1000.get(sa), t1000.get(sb),
                            t1000.intern(sa + sb), 0, 1, 0],
                           dtype=torch.int32, device=dev)
    tables, cand, kth, g_cnt, g_pos, rec = check(bpe)
    big, cap_big = check_mesh1(mesh1, tables)
    sym_cap = sym_capacity(table_wp, 8000)
    wp = ptrain.shard_corpus(mesh, arrays_wp.sym, arrays_wp.freq)
    check(wp, ptrain.sharded_sym_freq(wp, sym_cap))
    t1000 = type(table_wp)(table_wp.strings())
    for sa, sb in wp_merges[:1000]:
        ptrain.sharded_apply_merge(wp, t1000.get(sa), t1000.get(sb),
                                   t1000.intern(sa + sb[2:]))
    sf_wp = ptrain.sharded_sym_freq(wp, sym_cap).clone()
    wp_tables, cand_wp, kth_wp, g_cnt_wp, g_pos_wp, _ = check(wp, sf_wp)
    # weights scaled into the wide score domain: K-th denominators of
    # more than 62 bits veto
    wide = ptrain.shard_corpus(mesh, arrays_wp.sym,
                               arrays_wp.freq * (1 << 26))
    check(wide, ptrain.sharded_sym_freq(wide, sym_cap), wide=True)
    for kth_c, cand_c, cnt_c, sf_c, wide_c in CERT_CASES:
        rec_c = torch.tensor([1, 2, -1, 0, 1, 0], dtype=torch.int32,
                             device=dev)
        cert(torch.tensor(kth_c, dtype=torch.int64, device=dev).flatten(),
             torch.tensor(cand_c, dtype=torch.int64, device=dev),
             torch.tensor(cnt_c, dtype=torch.int64, device=dev),
             torch.arange(len(cand_c), dtype=torch.int32, device=dev), rec_c,
             None if sf_c is None else
             torch.tensor(sf_c, dtype=torch.int64, device=dev), wide_c)

    # compactions back to back: five table sets (BPE's 8, WordPiece's 8,
    # one WordPiece table, the mesh of 1's table alone and twice, whose 8
    # clusters a table run the look-back) and four caps (the main path's,
    # every shard over, some over, none over at 8 shards) in turn, every
    # call against the plain version's result on the device, read back
    # once at the end
    cap = min(ptrain.run_gather_cap(bpe.n_local_pairs), bpe.n_local_pairs)
    n_live = sorted(int((t[0] != EMPTY_KEY).sum()) for t in tables)
    sets = ((tables, bpe.bases), (wp_tables, wp.bases),
            (wp_tables[3:4], wp.bases[3:4]), ([big], [0]),
            ([big, big], [0, 1 << 20]))
    caps = (cap, 1, n_live[4], 1 << 17)
    want = {(s, c): compact_tables_ref(*sets[s], caps[c])
            for s in range(len(sets)) for c in range(len(caps))}
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    flags = [0, 0]
    for i in range(n_back_to_back):
        s, c = i % len(sets), (i // len(sets)) % len(caps)
        got = compact_tables(*sets[s], caps[c])
        for g, w in zip(got, want[(s, c)]):
            bad += (g.to(torch.int64) != w.to(torch.int64)).sum()
        flags[int(want[(s, c)][3][0])] += 1
    notes["back_to_back"] = n_back_to_back
    notes["back_to_back_flags"] = flags  # calls without and with overflow
    notes["back_to_back_wrong"] = int(bad)
    if any(errs.values()) or notes["back_to_back_wrong"]:
        raise AssertionError(f"a shard kernel differs: {errs}, back to "
                             f"back {notes['back_to_back_wrong']}")
    if not notes["overflowed_caps"] or not notes["mixed_caps"] or \
            not all(flags):
        raise AssertionError(f"the caps did not overflow as planned: {notes}")

    # times at the corpus's 8-shard BPE state after 1,000 merges (most of
    # a BPE train's fallback steps are later than step 473)
    t0, base0, bases = tables[0], bpe.bases[0], bpe.bases
    M = cand.shape[0]
    runs = compact_tables(tables, bases, cap)
    gk, gc, gp = runs[:3]
    agg = TablePair(gk.shape[0] + 1, dev)  # filled on alternate calls
    metric = torch.where(t0[0] != EMPTY_KEY, t0[1], -1)
    out = bpe.run_buffers(0, cap)
    k2_scr = select_scratch(dev)
    rec_t = torch.zeros(6, dtype=torch.int32, device=dev)
    rec_wp = torch.zeros(6, dtype=torch.int32, device=dev)
    select_host_ids(cand_wp, g_cnt_wp, g_pos_wp, rec_wp, sf_wp)
    # the sets built once, as a sharded run keeps them (a wrapper called
    # without one builds and copies one each call)
    tset = TableSet(tables, bases)
    tset0 = TableSet([t0], [base0])
    tset_big = TableSet([big], [0])

    # the nomination: one launch over the 8 tables, its TableSet and
    # outputs kept as a sharded run keeps them, BPE and WordPiece after
    # 1,000 merges, and the mesh of 1's table; beside 8 torch.topk over
    # the same shards' metrics, one a shard, as the tier called it before
    K = ptrain.TOPK
    tset_wp = TableSet(wp_tables, wp.bases)

    def nom_out(n):
        return (torch.empty(n * K, dtype=torch.int64, device=dev),
                torch.empty(3 * n, dtype=torch.int64, device=dev))

    outs = {"nominate_tables": nom_out(len(tables)),
            "nominate_tables_wp": nom_out(len(wp_tables)),
            "nominate_mesh1": nom_out(1)}

    def metric_of(t, sf=None):
        live = t[0] != EMPTY_KEY
        if sf is None:
            return torch.where(live, t[1], -1)
        k0 = torch.where(live, t[0], 0)
        return torch.where(live, score_bits(t[1], sf[k0 >> 32],
                                            sf[k0 & LOW32]), -1)

    metrics = {"nominate_tables": [metric_of(t) for t in tables],
               "nominate_tables_wp": [metric_of(t, sf_wp)
                                      for t in wp_tables],
               "nominate_mesh1": [metric_of(big)]}
    nom_sets = {"nominate_tables": (tables, None, tset),
                "nominate_tables_wp": (wp_tables, sf_wp, tset_wp),
                "nominate_mesh1": ([big], None, tset_big)}
    for name, (tabs, sf, ts) in nom_sets.items():
        diff("nominate_tables", nominate_tables(tabs, K, sf, ts, outs[name]),
             nominate_tables_ref(tabs, K, sf))
        timing[name] = (
            cuda_ms(lambda: nominate_tables(tabs, K, sf, ts, outs[name]),
                    200, True),
            cuda_ms(lambda: nominate_tables_ref(tabs, K, sf), 5))
        library[name] = cuda_ms(
            lambda: [torch.topk(m, K) for m in metrics[name]], 50, True)
        live = sum(int((t[0] != EMPTY_KEY).sum()) for t in tabs)
        T_all = sum(t[0].shape[0] for t in tabs)
        # Bytes: every key (8), the count of each live entry (8) and, for
        # WordPiece, its two symbol weights (16), the outputs; operations:
        # a test an entry and a division a live entry's score (20).
        bounds[name] = bound(
            8 * T_all + 8 * live + (16 * live if sf is not None else 0)
            + 8 * (K + 3) * len(tabs),
            T_all + (20 * live if sf is not None else 0))
        notes[f"{name}_live"] = live
        notes[f"{name}_T"] = T_all
    if errs["nominate_tables"]:
        raise AssertionError(f"the nomination differs: {errs}")
    notes["nominate_ptxas"] = ptxas_lines("nominate_kernel")

    def nom_line(name):
        return (f"{timing[name][0]:.4f} ms (plain {timing[name][1]:.3f}, "
                f"bound {bounds[name][0]:.5f}, {len(nom_sets[name][0])} x "
                f"torch.topk {library[name]:.4f}; {notes[name + '_live']} "
                f"live of {notes[name + '_T']})")

    print(f"phase 13 (nomination): nominate_tables (one launch a "
          f"device) equals its plain version exactly in "
          f"{notes['nominations']} grouped calls over "
          f"{notes['nominate_tables']} tables ({notes['short_shards']} "
          f"with fewer than k live entries) and on every table alone: the "
          f"seeded states (k 16 and 256, BPE and WordPiece), the corpus's "
          f"8 shards initial and after 1,000 merges, all counts equal, "
          f"dense tables past a block's staging (fill 0.5-0.6 of 131,072), "
          f"counts to 2^40 and 0, wide scores, tables of 2 and of 0 live "
          f"entries, the mesh of 1's 2^20 entries; k = {K} over the "
          f"corpus's BPE tables after 1,000 merges "
          + nom_line("nominate_tables") + ", WordPiece "
          + nom_line("nominate_tables_wp") + ", the mesh of 1 "
          + nom_line("nominate_mesh1")
          + f"; ptxas: {notes['nominate_ptxas']}; {smi}")
    shard = bpe.shards[0]
    sym0 = shard.sym.clone()
    n_changed = int((apply_merge_ref(sym0, rec_k3p) != sym0).sum())

    def merge_once():
        """K3p's device time of one real merge, each call on the state
        before it (the copy outside the events)."""
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(50)]
        apply_merge(shard.sym.copy_(sym0), rec_k3p)
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)  # queue the calls ahead
        for a, b in ev:
            shard.sym.copy_(sym0)
            a.record()
            apply_merge(shard.sym, rec_k3p)
            b.record()
        torch.cuda.synchronize()
        shard.sym.copy_(sym0)
        return statistics.median(a.elapsed_time(b) for a, b in ev)

    timing.update({
        "lookup_reduce": (
            cuda_ms(lambda: lookup_reduce(cand, tables, bases, tset), 200,
                    True),
            cuda_ms(lambda: lookup_reduce_ref(cand, tables, bases), 10)),
        "lookup_one_table": (
            cuda_ms(lambda: lookup_reduce(cand, [t0], [base0], tset0), 200,
                    True),
            cuda_ms(lambda: lookup_runs_ref(cand, t0, base0), 10)),
        "compact_tables": (
            cuda_ms(lambda: compact_tables(tables, bases, cap, out=out,
                                           tset=tset), 200, True),
            cuda_ms(lambda: compact_tables_ref(tables, bases, cap), 10)),
        "compact_mesh1": (
            cuda_ms(lambda: compact_tables([big], [0], cap_big,
                                           tset=tset_big), 200, True),
            cuda_ms(lambda: compact_table_ref(big, cap_big, 0), 10)),
        "compact_one_table": (
            cuda_ms(lambda: compact_tables([t0], [base0], cap, tset=tset0),
                    200, True),
            cuda_ms(lambda: compact_table_ref(t0, cap, base0), 10)),
        "launch_floor": (
            cuda_ms(lambda: _cuda.launch("swt_launch_floor", 0), 200, True),
            None),
        "launch_floor_cluster": (
            cuda_ms(lambda: _cuda.launch("swt_launch_floor",
                                         tset.clusters * len(tables)),
                    200, True), None),
        "pair_stats_runs": (
            cuda_ms(lambda: agg.runs(gk, gc, gp), 200, True),
            cuda_ms(lambda: pair_stats_runs_ref(gk, gc, gp), 10)),
        "certificate": (
            cuda_ms(lambda: certificate(kth, cand, g_cnt, rec), 200, True),
            cuda_ms(lambda: certificate_ref(kth, cand, g_cnt, rec.clone()),
                    10)),
        # K2's dense launch over the gathered candidates without and with
        # the certificate, on a scratch kept as the sharded run keeps it
        "k2_dense": (
            cuda_ms(lambda: select_host_ids(cand, g_cnt, g_pos, rec_t,
                                            scratch=k2_scr), 200, True),
            None),
        "k2_dense_cert": (
            cuda_ms(lambda: select_host_ids(cand, g_cnt, g_pos, rec_t,
                                            scratch=k2_scr, kth=kth),
                    200, True), None),
        "k2_dense_wp": (
            cuda_ms(lambda: select_host_ids(cand_wp, g_cnt_wp, g_pos_wp,
                                            rec_t, sf_wp, scratch=k2_scr),
                    200, True), None),
        "k2_dense_cert_wp": (
            cuda_ms(lambda: select_host_ids(cand_wp, g_cnt_wp, g_pos_wp,
                                            rec_t, sf_wp, scratch=k2_scr,
                                            kth=kth_wp), 200, True),
            None),
        "certificate_wp": (
            cuda_ms(lambda: certificate(kth_wp, cand_wp, g_cnt_wp, rec_wp,
                                        sf_wp), 200, True),
            cuda_ms(lambda: certificate_ref(kth_wp, cand_wp, g_cnt_wp,
                                            rec_wp.clone(), sf_wp), 10)),
        "topk": (cuda_ms(lambda: torch.topk(metric, ptrain.TOPK), 200,
                         True), None),
        "shard_pair_stats": (cuda_ms(shard.pairs, 200, True), None),
        "shard_merge_rows": (merge_once(), None)})
    shard.pairs()  # the table as the state gives it (timed calls rewrote it)
    # torch.nonzero waits for its count: its device time comes from a
    # trace of 50 calls, over the compaction's own inputs: the 8 tables'
    # keys (concatenated before the trace), one table's, the mesh of 1's
    reps = 50
    all_keys = torch.cat([t[0] for t in tables])
    for k, keys in (("compact_tables", all_keys), ("compact_one_table", t0[0]),
                    ("compact_mesh1", big[0])):
        _, busy, by_kernel = device_trace(
            lambda: [torch.nonzero(keys != EMPTY_KEY) for _ in range(reps)],
            os.path.join(trace_dir, f"nonzero_{k}_trace.json"), warmup=True)
        library[k] = busy / reps if by_kernel else None
    T = t0[0].shape[0]
    D = len(tables)
    live = [int((t[0] != EMPTY_KEY).sum()) for t in tables]
    n_live0 = live[0]
    live_big = int((big[0] != EMPTY_KEY).sum())
    live_wp = int((cand_wp != EMPTY_KEY).sum())
    n_slots = shard.sym.numel()

    def compact_bytes(T_i, live_i, cap_i):
        """What a compaction must move: every key (8 bytes), the count and
        position of each live entry of rank < cap (12), and each output
        slot (20)."""
        return 8 * T_i + 12 * min(live_i, cap_i) + 20 * cap_i

    # Bytes: inputs once, outputs once; of a probed table, one 20-byte
    # entry per lookup; K3p reads every slot and writes the slots its
    # merge changes. Operations, counted low: a hash and a compare per
    # lookup (10), a test and a scan step per table entry (4), a hash
    # insert per run or live slot (10), a division per shard (20) and a
    # compare per candidate (2); torch.topk reads the metric once, writes
    # its values and indices (int64 each) and compares once an entry; K3p
    # tests each slot and its neighbour (2). K2's dense launch reads the
    # candidates, their counts and positions (and, for WordPiece, two
    # symbol weights of each live one, and scores it: 20), writes the
    # record, and with the certificate reads the K-th rows (and their
    # weights) too.
    bounds.update({
        "lookup_reduce": bound(nbytes(cand) + 12 * M
                               + sum(visited(M, 20, *t) for t in tables),
                               10 * M * D),
        "lookup_one_table": bound(nbytes(cand) + 12 * M
                                  + visited(M, 20, *t0), 10 * M),
        "compact_tables": bound(sum(compact_bytes(t[0].shape[0], n, cap)
                                    for t, n in zip(tables, live)) + 4,
                                4 * T * D),
        "compact_one_table": bound(compact_bytes(T, n_live0, cap) + 4, 4 * T),
        "compact_mesh1": bound(compact_bytes(big[0].shape[0], live_big,
                                             cap_big) + 4,
                               4 * big[0].shape[0]),
        "pair_stats_runs": bound(nbytes(gk, gc, gp, *agg.tables[0].view(
            agg.tables[0].size)), 10 * M),
        "certificate": bound(nbytes(kth, cand, g_cnt, rec), 20 * D + 2 * M),
        "certificate_wp": bound(nbytes(kth_wp, cand_wp, g_cnt_wp, rec_wp)
                                + 16 * len(wp_tables) + 16,
                                20 * len(wp_tables) + 2 * M),
        "k2_dense": bound(nbytes(cand, g_cnt, g_pos, rec_t), 2 * M),
        "k2_dense_cert": bound(nbytes(cand, g_cnt, g_pos, rec_t, kth),
                               2 * M + 20 * D),
        "k2_dense_wp": bound(nbytes(cand_wp, g_cnt_wp, g_pos_wp, rec_t)
                             + 16 * live_wp, 2 * M + 20 * live_wp),
        "k2_dense_cert_wp": bound(nbytes(cand_wp, g_cnt_wp, g_pos_wp, rec_t,
                                         kth_wp) + 16 * live_wp
                                  + 16 * len(wp_tables),
                                  2 * M + 20 * live_wp
                                  + 20 * len(wp_tables)),
        "topk": bound(nbytes(metric) + 16 * ptrain.TOPK, T),
        "shard_pair_stats": bound(nbytes(shard.sym, shard._wid, shard._wgt,
                                         *t0), 10 * n_slots),
        "shard_merge_rows": bound(nbytes(sym0, rec_k3p) + 4 * n_changed,
                                  2 * n_slots)})
    notes.update(T=T, live=n_live0, cap=cap, M=M, runs=gk.shape[0], D=D,
                 launch_floor_ms=timing["launch_floor"][0],
                 launch_floor_cluster_ms=timing["launch_floor_cluster"][0],
                 rows=tuple(shard.sym.shape), merge_changed=n_changed,
                 mesh1=dict(T=big[0].shape[0], live=live_big, cap=cap_big,
                            clusters=-(-big[0].shape[0] // ROUND_SPAN)))
    torch.cuda.synchronize()

    def line(k):
        return (f"{k} {timing[k][0]:.4f} ms (plain {timing[k][1]:.3f}, "
                f"bound {bounds[k][0]:.5f})")

    print(f"phase 13: the shard kernels equal their plain versions exactly "
          f"on {notes['states']} sharded states (3 seeded, BPE and "
          f"WordPiece; the corpus's 8 shards of {bpe.rows} x {bpe.L} "
          f"initial and after 1,000 merges, BPE and WordPiece; weights "
          f"scaled by 2^26 into the wide domain; the grouped kernels "
          f"checked {notes['grouped_checks']} times over the 8 tables in "
          f"one launch and {notes['one_table_checks']} times over one "
          f"table), caps that overflowed on {notes['overflowed_caps']} "
          f"states and on some shards only on {notes['mixed_caps']}, "
          f"the mesh of 1's table of {big[0].shape[0]} entries "
          f"({notes['mesh1']['clusters']} clusters) checked "
          f"{notes['mesh1_checks']} times alone and twice in one launch, "
          f"{n_back_to_back} compactions back to back ({len(sets)} table "
          f"sets, 4 caps; {flags[0]} without and {flags[1]} with overflow) "
          f"all equal, and {len(CERT_CASES)} hand-made certificates (proven "
          f"{notes['proven']}, refused {notes['refused']} in all; each "
          f"state's and case's certificate by the check launcher and "
          f"inside K2's dense launch, both equal to certificate_ref); at the "
          f"corpus's BPE state after 1,000 merges (shard 0: {n_live0} live "
          f"of T = {T}; K.D = {M} candidates, cap {cap}): "
          + ", ".join(line(k) for k in (
              "lookup_reduce", "compact_tables", "lookup_one_table",
              "compact_one_table", "pair_stats_runs", "certificate"))
          + "; K2's dense launch over the candidates (BPE; WordPiece after "
          f"1,000 merges): {timing['k2_dense'][0]:.4f} ms without the "
          f"certificate, {timing['k2_dense_cert'][0]:.4f} with it (bound "
          f"{bounds['k2_dense_cert'][0]:.5f}); WordPiece "
          f"{timing['k2_dense_wp'][0]:.4f} and "
          f"{timing['k2_dense_cert_wp'][0]:.4f} (bound "
          f"{bounds['k2_dense_cert_wp'][0]:.5f}); the check launcher "
          f"alone, WordPiece, " + line("certificate_wp")
          + f"; the mesh of 1 ({live_big} live of {big[0].shape[0]}, cap "
          f"{cap_big}): " + line("compact_mesh1")
          + f"; per shard: lookup_reduce "
          f"{timing['lookup_reduce'][0] / D:.5f} ms, compact_tables "
          f"{timing['compact_tables'][0] / D:.5f} ms; launch floor "
          f"{timing['launch_floor'][0]:.4f} ms (one block), "
          f"{timing['launch_floor_cluster'][0]:.4f} ms (the compaction's "
          f"grid, {tset.clusters * D} clusters of 8 x 1,024); "
          f"torch.nonzero's device time "
          f"over the 8 tables' keys "
          f"{library['compact_tables'] or float('nan'):.4f} ms, one table's "
          f"{library['compact_one_table'] or float('nan'):.4f}, the mesh of "
          f"1's {library['compact_mesh1'] or float('nan'):.4f}; "
          f"torch.topk of {ptrain.TOPK} over T "
          f"{timing['topk'][0]:.4f} ms (bound {bounds['topk'][0]:.5f}); at a "
          f"shard's {shard.sym.shape[0]} x {shard.sym.shape[1]} rows K1 "
          f"{timing['shard_pair_stats'][0]:.4f} ms (bound "
          f"{bounds['shard_pair_stats'][0]:.5f}), K3p "
          f"{timing['shard_merge_rows'][0]:.4f} ms (bound "
          f"{bounds['shard_merge_rows'][0]:.5f}; the golden's 1,001st "
          f"merge, {n_changed} slots changed); {smi}")
    return errs, timing, bounds, library, notes


def per_call_ms(fn, restore, n=50):
    """Median device time of ``fn`` over ``n`` calls by CUDA events, each
    call on the state ``restore()`` puts back first (outside the events),
    the calls queued behind a spin of the stream."""
    import torch
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    restore()
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    for a, b in ev:
        restore()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    restore()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def phase13b(dev, rng, arrays, table, golden, smi, reps=200):
    """Phase 13b: the sharded step's grouped kernels, one launch a device:
    K1 over the padded rows of every shard of the device (``pair_rows``,
    which fills one set of tables and empties the other) and K3p over
    the device's block (``apply_merge`` with the ids as arguments, or
    from the record), against their plain versions, exactly: seeded rows
    with runs of a == b and PADs inside, L of 2, 22, 40 and 70, 1 and 8
    shards, an inactive record; three steps of a double buffer whose
    second set starts dirty; the corpus's 8 shards and the mesh of 1
    after the golden's first 1,000 merges (their rows equal the plain
    version's replay) and its 1,001st. Then the times at the corpus's
    8-shard state beside the per-shard launches they replace (8 x
    ``swt_pair_stats``, 8 x ``swt_merge_rows``) and the mesh of 1's.
    Returns (errs, timing, bounds, library, notes)."""
    import torch
    from subword_tokenizers_tpu_torch.ops.merge import (apply_merge,
                                                        apply_merge_ref)
    from subword_tokenizers_tpu_torch.ops.pairstats import (
        EMPTY_KEY, canonical, clean_table, pair_rows, pair_rows_ref)
    from subword_tokenizers_tpu_torch.ops.shard_select import TableSet
    from subword_tokenizers_tpu_torch.parallel import train as ptrain
    from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh
    errs = {"pair_rows": 0, "merge_rows_grouped": 0}
    notes = {"cases": 0, "k1_checks": 0, "k3p_checks": 0, "emptied_sets": 0}

    def err(name, e):
        errs[name] = max(errs[name], e)

    def check_tables(got, sym, wgt, rows):
        want = pair_rows_ref(sym, wgt, rows)
        if len(got) != len(want):
            raise AssertionError(f"pair_rows: {len(got)} tables for "
                                 f"{len(want)} shards")
        for g, w in zip(got, want):
            err("pair_rows", max(max_err(x, y)
                                 for x, y in zip(canonical(*g), w)))
        notes["k1_checks"] += 1

    def check_empty(tables):
        for keys, counts, pos in tables:
            err("pair_rows", int((keys != EMPTY_KEY).sum()
                                 + (counts != 0).sum() + (pos != -1).sum()))
        notes["emptied_sets"] += 1

    def check_merges(sym, merges):
        """K3p on copies of ``sym``, each (a, b, new_id, active) from the
        record and, when active, from the host's ids."""
        for a, b, n, active in merges:
            rec = torch.tensor([a, b, n, 0, active, 0], dtype=torch.int32,
                               device=dev)
            want = apply_merge_ref(sym, rec)
            err("merge_rows_grouped", max_err(apply_merge(sym.clone(), rec),
                                              want))
            if active:
                err("merge_rows_grouped", max_err(
                    apply_merge(sym.clone(), merge=(a, b, n)), want))
            notes["k3p_checks"] += 1

    def merges_of(sym):
        """The most frequent adjacent pair, the most frequent symbol with
        itself, an absent pair, and an inactive record."""
        s = sym.to(torch.int64)
        a, b = s[:, :-1], s[:, 1:]
        ok = (a >= 0) & (b >= 0)
        keys, cnt = torch.unique((a[ok] << 32) | b[ok], return_counts=True)
        top = int(keys[cnt.argmax()]) if keys.numel() else (7 << 32) | 8
        live = sym[sym >= 0]
        mode = int(live.mode().values) if live.numel() else 7
        n = max(int(sym.max()), 9) + 1
        ta, tb = top >> 32, top & 0xFFFFFFFF
        return [(ta, tb, n, 1), (mode, mode, n, 1), (n + 1, n + 2, n, 1),
                (ta, tb, n, 0)]

    # seeded rows: (L, shards, rows a shard, symbols, PADs inside)
    for L, D, rows, n_sym, inner in ((2, 8, 41, 3, False),
                                     (22, 8, 37, 4, True),
                                     (22, 1, 300, 2, True),
                                     (40, 8, 23, 2, True),
                                     (40, 1, 250, 5, False),
                                     (70, 1, 120, 3, True)):
        sym, wgt = padded_random(rng, rows * D, L, n_sym)
        if inner:
            sym[rng.random(sym.shape) < 0.1] = -1
        sym_t, wgt_t = (torch.from_numpy(x).to(dev) for x in (sym, wgt))
        tset = TableSet([clean_table(rows * L, dev) for _ in range(D)],
                        [0] * D)
        check_tables(pair_rows(sym_t, wgt_t, rows, tset), sym_t, wgt_t,
                     rows)
        check_merges(sym_t, merges_of(sym_t))
        notes["cases"] += 1
    # a double buffer over three steps, the second set dirty at first
    sym, wgt = padded_random(rng, 8 * 50, 22, 3)
    sym_t, wgt_t = (torch.from_numpy(x).to(dev) for x in (sym, wgt))
    sets = [[clean_table(50 * 22, dev) for _ in range(8)] for _ in range(2)]
    descs = [TableSet(t, [0] * 8) for t in sets]
    for keys, counts, pos in sets[1]:
        keys.fill_(5)
        counts.fill_(3)
        pos.fill_(2)
    for step in range(3):
        p = step % 2
        check_tables(pair_rows(sym_t, wgt_t, 50, descs[p],
                               clear=descs[1 - p]), sym_t, wgt_t, 50)
        check_empty(sets[1 - p])
        apply_merge(sym_t, merge=merges_of(sym_t)[step % 2][:3])

    # the corpus: 8 shards and the mesh of 1, after the golden's first
    # 1,000 merges (K3p from the host's ids), held against the plain
    # version's replay of the same merges
    bpe = ptrain.shard_corpus(make_data_mesh(8, devices=[dev] * 8),
                              arrays.sym, arrays.freq)
    mesh1 = ptrain.shard_corpus(make_data_mesh(1, devices=[dev]),
                                arrays.sym, arrays.freq)
    replay = mesh1.blocks[0].state.sym.clone()
    t1000 = type(table)(table.strings())
    for sa, sb in golden[:1000]:
        ab = t1000.get(sa), t1000.get(sb), t1000.intern(sa + sb)
        ptrain.sharded_apply_merge(bpe, *ab)
        ptrain.sharded_apply_merge(mesh1, *ab)
        replay = apply_merge_ref(replay, merge=ab)
    err("merge_rows_grouped", max_err(mesh1.blocks[0].state.sym, replay))
    err("merge_rows_grouped", max_err(
        bpe.blocks[0].state.sym[:replay.shape[0]], replay))
    sa, sb = golden[1000]
    m1001 = (t1000.get(sa), t1000.get(sb), t1000.intern(sa + sb))
    for corpus in (bpe, mesh1):
        blk = corpus.blocks[0]
        for _ in range(3):  # the block's own double buffer, three steps
            check_tables(blk.pairs(), blk.state.sym, blk.wgt, blk.rows)
        check_merges(blk.state.sym, [(*m1001, 1), (*m1001, 0)])
    if any(v for k, v in errs.items()):
        raise AssertionError(f"a grouped kernel differs: {errs}")

    # times: one step's K1 and K3p on the one-card mesh of 8, and on the
    # mesh of 1 (the golden's 1,001st merge, the state restored between
    # calls), beside the per-shard launches of the same work
    timing, bounds, library = {}, {}, {}
    blk, blk1 = bpe.blocks[0], mesh1.blocks[0]
    sym8, sym1 = blk.state.sym.clone(), blk1.state.sym.clone()
    timing["pair_rows"] = (
        cuda_ms(blk.pairs, reps, True),
        cuda_ms(lambda: pair_rows_ref(blk.state.sym, blk.wgt, blk.rows), 5))
    # 8 wrapper calls a rep: fewer reps, so that the host queues them
    # all inside the stream's spin
    timing["shard8_pair_stats"] = (
        cuda_ms(lambda: [s.pairs() for s in bpe.shards], max(reps // 8, 1),
                True),
        None)
    timing["pair_rows_mesh1"] = (
        cuda_ms(blk1.pairs, reps, True),
        cuda_ms(lambda: pair_rows_ref(blk1.state.sym, blk1.wgt, blk1.rows),
                5))
    timing["merge_rows_grouped"] = (
        per_call_ms(lambda: apply_merge(blk.state.sym, merge=m1001),
                    lambda: blk.state.sym.copy_(sym8)),
        cuda_ms(lambda: apply_merge_ref(sym8, merge=m1001), 5))
    timing["shard8_merge_rows"] = (
        per_call_ms(lambda: [apply_merge(s.sym, merge=m1001)
                             for s in bpe.shards],
                    lambda: blk.state.sym.copy_(sym8)), None)
    timing["merge_rows_mesh1"] = (
        per_call_ms(lambda: apply_merge(blk1.state.sym, merge=m1001),
                    lambda: blk1.state.sym.copy_(sym1)),
        cuda_ms(lambda: apply_merge_ref(sym1, merge=m1001), 5))
    def k1_bytes(b):
        """What one grouped K1 must move: the rows (4 bytes a slot), the
        rows' weights (8 a row), each distinct pair's entry written once
        (20) and each entry the step before filled emptied (20). The
        kernel empties the whole other set (20 bytes an entry of it): a
        choice of its design, counted apart as ``full_clear``."""
        def live_of(tables):
            return sum(int((t[0] != EMPTY_KEY).sum()) for t in tables)

        prev = live_of(b.pairs())
        tables = b.pairs()  # empties the set the call above filled
        live = live_of(tables)
        T_all = sum(t[0].shape[0] for t in tables)
        valid = int(((b.state.sym[:, :-1] >= 0)
                     & (b.state.sym[:, 1:] >= 0)).sum())
        rows = nbytes(b.state.sym, b.wgt)
        return (rows + 20 * live + 20 * prev,
                rows + 20 * live + 20 * T_all, valid, live, T_all)

    def k3p_bytes(sym0):
        """Every slot read, and the rows the merge changes written."""
        changed = int((apply_merge_ref(sym0, merge=m1001) != sym0).any(1)
                      .sum())
        return nbytes(sym0) + 4 * sym0.shape[1] * changed, changed

    # Operations, counted low: a hash insert per valid pair slot (10), a
    # match test and a place per slot (2), an add per slot (2).
    k1_8, full8, valid8, live8, T8 = k1_bytes(blk)
    k1_1, full1, valid1, live1, T1 = k1_bytes(blk1)
    k3_8, changed8 = k3p_bytes(sym8)
    k3_1, changed1 = k3p_bytes(sym1)
    bounds["pair_rows"] = bound(k1_8, 10 * valid8)
    bounds["pair_rows_mesh1"] = bound(k1_1, 10 * valid1)
    bounds["pair_rows_full_clear"] = bound(full8, 10 * valid8)
    bounds["pair_rows_mesh1_full_clear"] = bound(full1, 10 * valid1)
    bounds["merge_rows_grouped"] = bound(k3_8, 2 * sym8.numel())
    bounds["merge_rows_mesh1"] = bound(k3_1, 2 * sym1.numel())
    notes.update(rows=tuple(blk.state.sym.shape), shard_rows=blk.rows,
                 D=len(bpe.shards), live=live8, T_all=T8, live_mesh1=live1,
                 T_mesh1=T1, changed_rows=changed8,
                 changed_rows_mesh1=changed1)
    torch.cuda.synchronize()

    def line(k):
        plain = timing[k][1]
        return (f"{k} {timing[k][0]:.4f} ms (plain "
                + (f"{plain:.3f}" if plain is not None else "-")
                + (f", bound {bounds[k][0]:.5f}" if k in bounds else "")
                + ")")

    print(f"phase 13b: the grouped K1 (pair_rows) and K3p (apply_merge, "
          f"record and host ids) equal their plain versions exactly on "
          f"{notes['cases']} seeded cases (L 2, 22, 40, 70; 1 and 8 "
          f"shards; PADs inside; a == b runs; inactive records), 3 steps "
          f"of a double buffer ({notes['emptied_sets']} sets emptied, the "
          f"first dirty), the corpus's 8 shards of {blk.rows} x "
          f"{blk.state.sym.shape[1]} and the mesh of 1 after the golden's "
          f"1,000 merges (equal to the plain replay) and its 1,001st "
          f"({notes['k1_checks']} K1 and {notes['k3p_checks']} K3p "
          f"checks); at the 8-shard state ({live8} live of {T8} entries, "
          f"{changed8} rows changed by the merge): "
          + ", ".join(line(k) for k in (
              "pair_rows", "shard8_pair_stats", "merge_rows_grouped",
              "shard8_merge_rows"))
          + f" (K1's bound with the whole other set emptied, as the "
          f"kernel does: {bounds['pair_rows_full_clear'][0]:.5f})"
          + f"; the mesh of 1 ({live1} live of {T1}, {changed1} rows "
          f"changed): " + ", ".join(line(k) for k in (
              "pair_rows_mesh1", "merge_rows_mesh1"))
          + f" (K1 with the full clear: "
          f"{bounds['pair_rows_mesh1_full_clear'][0]:.5f}); {smi}")
    return errs, timing, bounds, library, notes


def poisoned_copy(table, key: int):
    """A copy of a filled PairTable, its claim list and counters included,
    whose every unclaimed entry holds poison: ``key`` with a count of 2^62
    at position 0, which wins any selection that reads it (the caller
    picks a pair of its rarest symbol for WordPiece). K2 in claims mode
    over the copy must give what it gives over the table."""
    import torch
    from subword_tokenizers_tpu_torch.ops.pairstats import PairTable
    cp = PairTable(table.size // 2 + 1, table.keys.device)
    assert cp.size == table.size
    for dst, src in zip((cp.keys, cp.counts, cp.pos, cp.claims, cp.n),
                        (table.keys, table.counts, table.pos, table.claims,
                         table.n)):
        dst.copy_(src)
    cp.fills, cp.dirty = table.fills, True
    claimed = torch.zeros(cp.size, dtype=torch.bool, device=cp.keys.device)
    claimed[table.claimed()] = True
    cp.keys[~claimed] = key
    cp.counts[~claimed] = 1 << 62
    cp.pos[~claimed] = 0
    return cp


def memsets(by_name) -> int:
    """Memset spans in a trace read by :func:`device_trace`."""
    return sum(c for n, (c, _) in by_name.items() if "memset" in n.lower())


def kernel_launches(by_name) -> int:
    """Kernel spans (neither copies nor memsets) in a trace read by
    :func:`device_trace`."""
    return sum(c for n, (c, _) in by_name.items()
               if "memset" not in n.lower() and "memcpy" not in n.lower())


def trace_blocks(dev, flat_bpe, table, arrays_wp, table_wp, max_len,
                 trace_dir, steps=256):
    """A traced block of ``steps`` steps of the flat route (BPE and
    WordPiece) and of the padded route (WordPiece), each a replay of the
    block's CUDA graph: a BlockRunner (ops/train_loop.py) runs a first
    block step by step (K1's tables made, the launchers warm) and a
    second, captured and replayed, before the trace; the traced block is
    the third, one replay. Per route: the kernel launches a step the
    replay adds to the wrappers' counts, the graph launches and the
    kernels the host launched in the trace, the kernels the trace shows
    once a step (those it holds at least ``steps`` / 2 times), the
    memsets and the allocations inside the block. Raises on a memset, and
    unless a flat block is one graph launch of 3 kernels a step with no
    other launch and no allocation. Returns {route: numbers}."""
    import torch
    from subword_tokenizers_tpu_torch.ops import train_loop
    from subword_tokenizers_tpu_torch.ops.flat import build_flat

    def runner(flat, wordpiece):
        arr, tab = (flat_bpe, table) if not wordpiece else (
            build_flat(arrays_wp.sym, arrays_wp.freq), table_wp)
        st = train_loop.FlatState(*(x.copy() for x in arr), dev)
        if not flat:
            st = train_loop.PaddedState.from_flat(st)
        t = type(tab)(tab.strings())
        run = train_loop.BlockRunner(st, t, len(t) + 100 * steps, max_len,
                                     steps, wordpiece, flat, 0, False)
        for slot in (0, 1):  # step by step, then captured and replayed
            run.dispatch(slot)
            run.fetch(slot)
        return run

    traced = {}
    for name, flat, wordpiece in (("flat_bpe", True, False),
                                  ("flat_wp", True, True),
                                  ("padded_wp", False, True)):
        run = runner(flat, wordpiece)
        captures = len(run.graphs)
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        launched = launches_total()
        replays = counter("train.graph_replays")

        def block():
            run.dispatch(0)
            run.fetch(0)

        wall, busy, by_name = device_trace(
            block, os.path.join(trace_dir, f"block_{name}.json"))
        api = dict(TRACE_API)
        run.close()
        step_kernels = {n: c for n, (c, _) in by_name.items()
                        if "memcpy" not in n.lower()
                        and "memset" not in n.lower() and c >= steps // 2}
        allocations = torch.cuda.memory_stats(dev)[
            "allocation.all.allocated"] - allocated
        per_step = (launches_total() - launched) / steps
        traced[name] = dict(
            launches_a_step=per_step, allocations=allocations,
            graph_launches=api.get("graph_launches"),
            host_kernel_launches=api.get("kernel_launches"),
            replays=counter("train.graph_replays") - replays,
            captures=captures,
            memsets=memsets(by_name) if by_name else None,
            traced_step_kernels=step_kernels if by_name else None,
            wall_ms=wall, busy_ms=busy)
        if by_name and traced[name]["memsets"]:
            raise AssertionError(f"the {name} block made "
                                 f"{traced[name]['memsets']} memsets: "
                                 f"{by_name}")
        if traced[name]["replays"] != 1 or captures != 1:
            raise AssertionError(f"the {name} block was not one replay of "
                                 f"the graph captured before: "
                                 f"{traced[name]}")
        if flat and (allocations or per_step != 3 or (by_name and (
                len(step_kernels) != 3 or api.get("graph_launches") != 1
                or api.get("kernel_launches")))):
            raise AssertionError(f"the {name} block: {per_step} launches a "
                                 f"step, {allocations} allocations, trace "
                                 f"API {api}, traced {by_name}")
    return traced


def phase13c(dev, rng, flat_bpe, table, arrays, arrays_wp, table_wp,
             max_len, smi, trace_dir, reps=200):
    """Phase 13c: K4 in rows mode (``symbol_rows``: one launch over a
    device's block of shards, their sum, into one of two outputs while it
    empties the other) and in flat mode (``symbol_freqs``), and the
    single-device K1 (``pair_stats`` into one of two PairTables, the
    launch emptying the entries the other's last fill claimed), against
    their plain versions, exactly: K4 on seeded rows (PADs inside, all-PAD
    rows, ids at and above sym_cap, zero and wide weights, L of 1 to 70,
    a sym_cap of 40,000), the WordPiece corpus's 8-shard block over three
    alternating steps, the mesh of 1, the padded route's whole corpus,
    the flat route's slots and the 8-shard block at a sym_cap of 40,000;
    K1 on five consecutive steps of the flat route with real merges (K2,
    K3) and a shrink after the second, five in skip mode, three of the
    padded route, each table emptied whole. Times: K4 at each of those
    shapes beside its 8 per-shard launches and ``index_add_``; K1 at the
    corpus's initial state, its bound as the function needs and with a
    full clear; WordPiece's scorer with its gathers at a shard's table.
    Then :func:`trace_blocks`: a traced 256-step block of the flat route
    (BPE and WordPiece), each with no memset, 3 kernels a step and no
    allocation inside the block, and of the padded route (WordPiece),
    with no memset. Returns (errs, timing, bounds, library, notes)."""
    import numpy as np
    import torch
    from subword_tokenizers_tpu_torch.ops import train_loop
    from subword_tokenizers_tpu_torch.ops.bitmath import score_bits
    from subword_tokenizers_tpu_torch.ops.flat import WID_PAD, build_flat
    from subword_tokenizers_tpu_torch.ops.pairstats import (
        EMPTY_KEY, TablePair, canonical, pair_stats_ref, symbol_freqs,
        symbol_freqs_ref, symbol_rows, symbol_rows_ref, table_size)
    from subword_tokenizers_tpu_torch.ops.shard_select import LOW32
    from subword_tokenizers_tpu_torch.parallel import train as ptrain
    from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh
    errs = {"symbol_rows": 0, "symbol_freqs_flat": 0, "pair_stats_steps": 0}
    notes = {"k4_cases": 0, "k1_steps": 0, "emptied": 0, "buckets": 0}
    timing, bounds, library = {}, {}, {}
    sym_cap = train_loop.sym_capacity(table_wp, 8000)

    def err(name, e):
        errs[name] = max(errs[name], e)

    def zeros(n):
        return torch.zeros(n, dtype=torch.int64, device=dev)

    def check_rows(sym, wgt, cap):
        """symbol_rows into a zero output while it empties a dirty one;
        its trash bucket against the weights of the slots holding the id
        sym_cap itself, summed apart."""
        out, dirty = zeros(cap + 1), zeros(cap + 1) + 7
        got = symbol_rows(sym, wgt, cap, out, dirty)
        err("symbol_rows", max_err(got, symbol_rows_ref(sym, wgt, cap)))
        bucket = int((wgt[:, None] * (sym == cap)).sum())
        err("symbol_rows", abs(int(got[cap]) - bucket)
            + int((dirty != 0).sum()))
        notes["k4_cases"] += 1
        notes["buckets"] += bucket > 0

    # seeded rows: (rows, L, symbols, sym_cap, weight scale)
    for n, L, n_sym, cap, wscale in ((3000, 22, 40, 30, 1),
                                     (2000, 9, 12, 10, 1),
                                     (2000, 1, 9, 9, 1),
                                     (500, 70, 2, 8, 1 << 40),
                                     (4000, 22, 45000, 40000, 3),
                                     (64, 5, 3, 0, 1)):
        sym, wgt = padded_random(rng, n, L, n_sym, wscale)
        sym[rng.random(sym.shape) < 0.1] = -1        # PADs inside
        sym[rng.random(n) < 0.05] = -1               # all-PAD rows
        wgt[rng.random(n) < 0.05] = 0                # zero weights
        sym_t, wgt_t = (torch.from_numpy(x).to(dev) for x in (sym, wgt))
        check_rows(sym_t, wgt_t, cap)
        # the flat mode over the same slots, a weight a slot
        fs1, w1 = sym_t.reshape(-1), wgt_t.repeat_interleave(L)
        err("symbol_freqs_flat", max_err(symbol_freqs(fs1, w1, cap),
                                         symbol_freqs_ref(fs1, w1, cap)))
    if notes["buckets"] < 2:
        raise AssertionError(f"the seeded rows held the id sym_cap "
                             f"{notes['buckets']} times")
    # the WordPiece corpus: 8 shards of the one-card mesh, three steps of
    # the block's double buffer, each the sum of _local_sym_freq's counts
    wp8 = ptrain.shard_corpus(make_data_mesh(8, devices=[dev] * 8),
                              arrays_wp.sym, arrays_wp.freq)
    mesh1 = ptrain.shard_corpus(make_data_mesh(1, devices=[dev]),
                                arrays_wp.sym, arrays_wp.freq)
    blk, blk1 = wp8.blocks[0], mesh1.blocks[0]
    per_shard = sum(symbol_freqs_ref(s.sym.reshape(-1), s._wgt, sym_cap)
                    for s in wp8.shards)
    prev = None
    for _ in range(3):
        before = counter("launch.symbol_rows")
        got = ptrain.sharded_sym_freq(wp8, sym_cap)
        if counter("launch.symbol_rows") != before + 1:
            raise AssertionError(
                f"sharded_sym_freq launched K4 "
                f"{counter('launch.symbol_rows') - before} times")
        err("symbol_rows", max_err(got, per_shard))
        if prev is not None:
            err("symbol_rows", int((prev != 0).sum()))  # emptied
            notes["emptied"] += 1
        prev = got
        notes["k4_cases"] += 1
    err("symbol_rows", max_err(blk1.state.count_symbols(sym_cap),
                               per_shard))
    padded = train_loop.PaddedState(arrays_wp.sym, arrays_wp.freq, dev)
    for _ in range(2):
        err("symbol_rows", max_err(padded.count_symbols(sym_cap),
                                   per_shard))
    fs_w, _, wgt_w = (torch.from_numpy(x).to(dev) for x in
                      build_flat(arrays_wp.sym, arrays_wp.freq))
    sf_flat = symbol_freqs(fs_w, wgt_w, sym_cap)
    err("symbol_freqs_flat", max_err(sf_flat, symbol_freqs_ref(
        fs_w, wgt_w, sym_cap)) + max_err(sf_flat, per_shard))
    check_rows(blk.state.sym, blk.wgt, 40000)
    notes["k4_cases"] += 4
    if any(errs.values()):
        raise AssertionError(f"K4 differs: {errs}")

    # K4's times: the one-card mesh's block (its double buffer), its 8
    # per-shard launches, index_add_ over the same slots, the mesh of 1,
    # the padded route's whole corpus, the flat route (one output added
    # into again: the same work) and a sym_cap of 40,000
    shard_bufs = [(zeros(sym_cap + 1), zeros(sym_cap + 1)) for _ in wp8.shards]
    flat_out, big = zeros(sym_cap + 1), (zeros(40001), zeros(40001))
    timing["symbol_rows"] = (
        cuda_ms(lambda: blk.state.count_symbols(sym_cap), reps, True),
        cuda_ms(lambda: symbol_rows_ref(blk.state.sym, blk.wgt, sym_cap),
                10))
    timing["symbol_rows_8_launches"] = (
        cuda_ms(lambda: [symbol_rows(s.sym, s.wgt, sym_cap, o, c)
                         for s, (o, c) in zip(wp8.shards, shard_bufs)],
                max(reps // 8, 1), True), None)
    timing["symbol_rows_mesh1"] = (
        cuda_ms(lambda: blk1.state.count_symbols(sym_cap), reps, True),
        None)
    timing["symbol_rows_padded"] = (
        cuda_ms(lambda: padded.count_symbols(sym_cap), reps, True), None)
    timing["symbol_rows_cap40000"] = (
        cuda_ms(lambda: symbol_rows(blk.state.sym, blk.wgt, 40000, *big),
                reps, True), None)
    timing["symbol_freqs_flat"] = (
        cuda_ms(lambda: symbol_freqs(fs_w, wgt_w, sym_cap, flat_out), reps,
                True),
        cuda_ms(lambda: symbol_freqs_ref(fs_w, wgt_w, sym_cap), 10))
    sym_all = blk.state.sym.reshape(-1)
    ok = (sym_all >= 0) & (sym_all <= sym_cap)
    lib_idx = torch.where(ok, sym_all, sym_cap).to(torch.int64)
    lib_w = torch.where(ok, blk.state._wgt, 0)
    err("symbol_rows", max_err(zeros(sym_cap + 1).index_add_(
        0, lib_idx, lib_w), per_shard))
    library["symbol_rows"] = cuda_ms(
        lambda: zeros(sym_cap + 1).index_add_(0, lib_idx, lib_w), reps, True)
    flat_idx = torch.where(fs_w >= 0, fs_w, sym_cap).to(torch.int64)
    library["symbol_freqs_flat"] = cuda_ms(
        lambda: zeros(sym_cap + 1).index_add_(0, flat_idx, wgt_w), reps,
        True)
    # Bytes: the rows (4 a slot), the row weights (8 a row), the output
    # written and the other emptied (8 a bin each); flat: the slots and
    # their weights, the output written. Operations, counted low: an add
    # a slot (2).
    out_bytes = 8 * (sym_cap + 1)
    bounds["symbol_rows"] = bound(nbytes(blk.state.sym, blk.wgt)
                                  + 2 * out_bytes, 2 * sym_all.numel())
    bounds["symbol_rows_mesh1"] = bound(nbytes(blk1.state.sym, blk1.wgt)
                                        + 2 * out_bytes,
                                        2 * blk1.state.sym.numel())
    bounds["symbol_rows_cap40000"] = bound(
        nbytes(blk.state.sym, blk.wgt) + 16 * 40001, 2 * sym_all.numel())
    bounds["symbol_freqs_flat"] = bound(nbytes(fs_w, wgt_w) + out_bytes,
                                        2 * fs_w.numel())

    # K1 on a single device: five consecutive steps of the flat route with
    # real merges, the state's width halved after the second (a dead tail
    # as long as the corpus's slots, cut off: the table filled at the wide
    # width is emptied whole); five in skip mode; three of the padded route
    def tables_of(st):
        return st._tables

    def check_steps(st, t, n_steps, skip=0, shrink_at=None):
        h1, h2, sl, ctrl, pw1, pw2, _ = train_loop.init_tables(
            t, len(t) + n_steps, max_len, dev)
        stats = torch.zeros(2, dtype=torch.int32, device=dev)
        rec = torch.zeros(6, dtype=torch.int32, device=dev)
        for step in range(n_steps):
            if step == shrink_at:
                st.F //= 2
            if skip:
                st.guard(stats[1:])
            got = st.pairs(skip)
            arrays_now = ((st.sym.view(-1), st._wid, st._wgt)
                          if isinstance(st, train_loop.PaddedState)
                          else st.arrays())
            err("pair_stats_steps", max(max_err(x, y) for x, y in zip(
                canonical(*got), pair_stats_ref(*arrays_now, skip))))
            pair = tables_of(st)
            emptied = pair.tables[pair._next]  # the next call fills it
            err("pair_stats_steps", int(
                (emptied.keys != EMPTY_KEY).sum() + (emptied.counts != 0)
                .sum() + (emptied.pos != -1).sum()))
            notes["k1_steps"] += 1
            train_loop.select_unify(*got, h1, h2, sl, ctrl, pw1, pw2,
                                    len(t) + n_steps, rec)
            st.merge(rec, skip)
            if not int(rec[4]):
                raise AssertionError("a K1 check step merged nothing")

    fs, wid, wgt = flat_bpe
    n0 = fs.shape[0]
    wide = (np.concatenate([fs, np.full(n0, -1, np.int32)]),
            np.concatenate([wid, np.full(n0, WID_PAD, np.int32)]),
            np.concatenate([wgt, np.zeros(n0, np.int64)]))
    st = train_loop.FlatState(*wide, dev)
    t_big = table_size(st.F)  # the tables' size, made by the first count
    check_steps(st, type(table)(table.strings()), 5, shrink_at=2)
    if tables_of(st).tables[0].size != t_big or table_size(st.F) >= t_big:
        raise AssertionError("the K1 check's state did not shrink its table")
    check_steps(train_loop.FlatState(*(x.copy() for x in flat_bpe), dev),
                type(table)(table.strings()), 5, skip=12)
    check_steps(train_loop.PaddedState(arrays.sym, arrays.freq, dev),
                type(table)(table.strings()), 3)
    if any(errs.values()):
        raise AssertionError(f"K1 differs on a step: {errs}")

    # K1's time at the corpus's initial state: alternate calls of one
    # pair of tables, each filling one and emptying the other's entries
    fs_t, wid_t, wgt_t = (torch.from_numpy(x).to(dev) for x in flat_bpe)
    k1 = TablePair(n0, dev)
    timing["pair_stats_initial"] = (
        cuda_ms(lambda: k1.pairs(fs_t, wid_t, wgt_t), reps, True),
        cuda_ms(lambda: pair_stats_ref(fs_t, wid_t, wgt_t), 10))
    live = int(pair_stats_ref(fs_t, wid_t, wgt_t)[0].shape[0])
    T0 = table_size(n0)
    valid = int((fs_t >= 0).sum())
    # Bytes: the slots (16 a slot), 20 for each distinct pair's entry
    # written and for each the call before filled, emptied (the same
    # state's pairs); full clear: every entry of the table emptied.
    bounds["pair_stats_initial"] = bound(nbytes(fs_t, wid_t, wgt_t)
                                         + 40 * live, 10 * valid)
    bounds["pair_stats_full_clear"] = bound(
        nbytes(fs_t, wid_t, wgt_t) + 20 * live + 20 * T0, 10 * valid)
    notes.update(k1_live=live, k1_T=T0, k1_slots=n0, sym_cap=sym_cap)

    # WordPiece's scorer alone (swt_score_bits) over a shard's table,
    # the weights gathered before; the sharded step scores inside the
    # nomination (phase 13)
    tables = wp8.pairs()
    sf = ptrain.sharded_sym_freq(wp8, sym_cap)
    keys, counts, _ = tables[0]
    mask = keys != EMPTY_KEY
    k0 = torch.where(mask, keys, 0)
    fa, fb = sf[k0 >> 32], sf[k0 & LOW32]
    timing["wp_score_shard"] = (
        cuda_ms(lambda: score_bits(counts, fa, fb), reps, True), None)
    T_shard = keys.shape[0]
    # Bytes: a count and two weights read, a score written (32 an entry);
    # operations: a division an entry (20).
    bounds["wp_score_shard"] = bound(32 * T_shard, 20 * T_shard)
    notes.update(shard_entries=T_shard, shard_live=int(mask.sum()))
    torch.cuda.synchronize()

    notes["traced"] = trace_blocks(dev, flat_bpe, table, arrays_wp,
                                   table_wp, max_len, trace_dir)

    def line(k, extra=""):
        parts = ([f"plain {timing[k][1]:.3f}"] if timing[k][1] is not None
                 else []) + ([f"bound {bounds[k][0]:.5f}"] if k in bounds
                             else []) + ([extra] if extra else [])
        return f"{k} {timing[k][0]:.4f} ms" + (
            f" ({', '.join(parts)})" if parts else "")

    trace_line = "; ".join(
        f"{k}: one replay ({v['graph_launches']} cudaGraphLaunch, "
        f"{v['host_kernel_launches']} kernels launched by the host), "
        f"{v['launches_a_step']:.3f} launches a step, "
        f"{v['allocations']} allocations in the block's 256 steps, "
        + (f"{v['memsets']} memsets, the trace's kernels once a step "
           f"{sorted(v['traced_step_kernels'].values())}, device busy "
           f"{v['busy_ms']:.3f} of {v['wall_ms']:.1f} ms"
           if v["memsets"] is not None else "memsets and kernels not "
           "measured (the trace holds no device events)")
        for k, v in notes["traced"].items())
    print(f"phase 13c: K4 (symbol_rows, one launch a device; symbol_freqs "
          f"flat) equals its plain version exactly on {notes['k4_cases']} "
          f"cases (seeded rows with PADs, all-PAD rows, ids at and above "
          f"sym_cap (the trash bucket summed apart, non-zero on "
          f"{notes['buckets']}), zero and wide weights, L 1-70, sym_cap 0 "
          f"and 40,000; "
          f"the WordPiece corpus's 8-shard block over 3 alternating steps "
          f"({notes['emptied']} outputs emptied, one launch each), the mesh "
          f"of 1, the padded route, the flat route, sym_cap 40,000); K1 "
          f"(pair_stats, one launch a call) on {notes['k1_steps']} steps "
          f"with real merges (5 consecutive of the flat route, its table "
          f"shrunk from {t_big} entries after the second; 5 in skip mode "
          f"12; 3 padded), each table emptied whole; at the 8-shard "
          f"block ({blk.state.sym.shape[0]} x {blk.state.sym.shape[1]}, "
          f"sym_cap {sym_cap}): " + line(
              "symbol_rows", f"index_add_ {library['symbol_rows']:.4f}")
          + ", " + ", ".join(line(k) for k in (
              "symbol_rows_8_launches", "symbol_rows_mesh1",
              "symbol_rows_padded", "symbol_rows_cap40000"))
          + ", " + line("symbol_freqs_flat", f"index_add_ "
                        f"{library['symbol_freqs_flat']:.4f}")
          + f"; K1 at the initial state ({n0} slots, {live} pairs, T = "
          f"{T0}): " + line("pair_stats_initial", f"with a full clear "
                            f"{bounds['pair_stats_full_clear'][0]:.5f}")
          + f"; WordPiece's scorer alone over a shard's {T_shard} entries "
          f"({notes['shard_live']} live): " + line("wp_score_shard")
          + f"; 256-step blocks traced, each the third of its BlockRunner "
          f"(the first queued step by step, the second captured): "
          f"{trace_line}; {smi}")
    return errs, timing, bounds, library, notes


def sharded_graph_check(tok, what):
    """The graph counts of one sharded train on a one-card mesh
    (``tok._graph_stats``, parallel/train.ShardedTrainer): raises unless
    its first step was queued step by step (at most its three tiers) and
    every tier of a later step, top-K, compact or full, was one graph
    replay, with at most two top-K graphs (one a table set). Returns a
    line of the counts."""
    g = tok._graph_stats
    steps = sum(tok._sel_stats.values())
    if (g["eager_steps"] != 1 or g["replays"] + g["eager_tiers"]
            != g["tiers"] or not 1 <= g["eager_tiers"] <= 3
            or g["graphs"].get("topk", 0) > 2
            or (steps > 1 and not g["replays"])):
        raise AssertionError(f"{what}: {steps} steps, graph counts {g}")
    return (f"{g['replays']} replays of {g['captures']} graphs "
            f"{g['graphs']}, {g['eager_steps']} step queued step by step")


def sharded_tiers_check(name, tok, what):
    """Raises unless a sharded train to 8,000 on the whole corpus settled
    its steps in the tiers the step-by-step route counts: BPE's
    ``SHARDED_BPE_TIERS``, every WordPiece step proven."""
    n_merges = len(tok.merges_list if name == "NaiveBPE" else tok._merge_log)
    tiers = SHARDED_BPE_TIERS if name == "NaiveBPE" else {
        "proven": n_merges, "compact": 0, "full": 0}
    if tok._sel_stats != tiers or tok._topk_fallbacks != tiers[
            "compact"] + tiers["full"]:
        raise AssertionError(f"{what}: tiers {tok._sel_stats}, expected "
                             f"{tiers}")


def sharded_launch_check(name, tok, counts, what):
    """Raises unless a sharded train's launches (``counts``, read_counts
    of the run) are one grouped launch a step on a one-card mesh: K1, the
    nomination and a lookup every step, the certificate inside K2's
    launch every step, a compaction every step the certificate did not
    settle, K3p every merge; the per-shard K1 only in the full tier; no
    torch.topk, no scorer and no certificate launch. Returns the
    kernel-wrapper calls."""
    steps = sum(tok._sel_stats.values())
    merges = len(tok.merges_list if name == "NaiveBPE" else tok._merge_log)
    want = {"pair_rows": steps, "nominate_tables": steps,
            "lookup_reduce": steps, "certificate": steps,
            "certificate_launcher": 0,
            "compact_tables": tok._topk_fallbacks, "merge_rows": merges,
            "pair_stats": tok._sel_stats["full"],
            "symbol_rows": steps if name == "NaiveWP" else 0,
            "symbol_freqs": 0, "wp_score": 0}
    # every wrapper's calls: a step the certificate settles makes 5
    # (K1, the nomination, the lookup, K2 with the certificate, K3p)
    # and a WordPiece step 6 (K4 too), the last step no K3p; a
    # fallback step 3 more (the compaction, K1's runs mode, K2), a
    # full-tier step 2 more (K1, K2)
    want["calls"] = ((6 if name == "NaiveWP" else 5) * steps
                     - (steps - merges) + 3 * tok._topk_fallbacks
                     + 2 * tok._sel_stats["full"])
    got = dict(counts, calls=wrapper_calls(counts))
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"{what}: {steps} steps, {merges} merges and "
                             f"{tok._topk_fallbacks} fallbacks, but "
                             f"launches {got}")
    return got["calls"]


def step_collectives(tok, wordpiece):
    """The collectives a train on a process-group mesh issues: a step's
    top-K tier gathers the candidates and the K-th rows and reduces the
    counts and positions, a compact tier gathers the runs' keys, counts
    and positions and reduces the overflow flag, a full tier gathers the
    rows, a WordPiece step reduces K4's weights in its first tier, and
    the end of the train gathers the final rows once."""
    steps = sum(tok._sel_stats.values())
    full = tok._sel_stats["full"]
    forced = getattr(tok, "_force_tier", None)
    compact = tok._topk_fallbacks if forced is None else \
        steps if forced == "compact" else 0
    topk = 0 if forced else steps
    return {"all_gather": 2 * topk + 3 * compact + full + 1,
            "all_reduce": 2 * topk + compact + (steps if wordpiece else 0)}


def phase14(dev, corpus, check_train, check_wp_train, lists, wp_merges,
            wp_vocab, expect, expect_enc, smi, trace_dir, max_vocab=8000,
            small_vocab=1000, trace_vocab=2000):
    """Phase 14: this slice's main path on the card, an 8-shard mesh on
    one device: NaiveBPE and NaiveWP trained on all of ``corpus`` to
    ``max_vocab`` (cold and warm, each equal to the golden, the tier
    counts, the shard kernels' launches), the forced tiers and a mesh of
    1 to ``small_vocab``,
    FastWP's sharded encode and the other three encoders under the mesh
    against the JAX digests, and the idle share of one warm sharded
    train to ``trace_vocab`` (a trace of a whole run to 8,000 holds
    millions of kernels). Returns {path: launches}."""
    import torch
    from subword_tokenizers_tpu_torch import FastBPE, FastWP, NaiveBPE, \
        NaiveWP
    from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh
    mesh = make_data_mesh(8, devices=[dev] * 8)
    kernels = shard_kernels()
    must = {"NaiveBPE": ("pair_rows", "nominate_tables", "lookup_reduce",
                         "certificate", "compact_tables", "pair_stats_runs",
                         "select_unify", "merge_rows"),
            "NaiveWP": ("pair_rows", "nominate_tables", "lookup_reduce",
                        "certificate", "select_unify", "merge_rows",
                        "symbol_rows")}
    checks = {"NaiveBPE": check_train, "NaiveWP": check_wp_train}
    models = {"NaiveBPE": NaiveBPE, "NaiveWP": NaiveWP}
    by_path, lines = {}, []
    for name, cls in models.items():
        walls, graph_lines = [], []
        for run in range(2):  # cold, warm
            before = read_counts(kernels)
            tok = cls(mesh=mesh, device=dev)
            t0 = time.perf_counter()
            tok.train(corpus, max_vocab)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts = counts_since(kernels, before)
            checks[name](tok, f"{name} mesh of 8 run {run}")
            if max_vocab == 8000:
                sharded_tiers_check(name, tok, f"{name} run {run}")
            graph_lines.append(sharded_graph_check(
                tok, f"{name} mesh of 8 run {run}"))
        missing = [k for k in must[name] if not counts[k]]
        if missing:
            raise AssertionError(f"{name} under the mesh launched no "
                                 f"{missing}: {counts}")
        steps = sum(tok._sel_stats.values())
        calls = sharded_launch_check(name, tok, counts, name)
        by_path[f"{name}_mesh8"] = {k: v for k, v in counts.items() if v}
        lines.append(f"{name} cold {walls[0]:.3f} s, warm {walls[1]:.3f} s, "
                     f"graphs cold {graph_lines[0]}, warm {graph_lines[1]}, "
                     f"tiers {tok._sel_stats} ({tok._topk_fallbacks} "
                     f"fallbacks; 1 K1, 1 nomination and 1 lookup launch a "
                     f"step, the certificate in 1 K2 launch a step, 1 "
                     f"compaction launch a fallback step, 1 K3p "
                     f"launch a merge, 1 K4 a WordPiece step, no per-shard "
                     f"K1, no scorer and no certificate launch), "
                     f"{calls} kernel-wrapper calls in {steps} steps "
                     f"({calls / steps:.3f} a step), warm launches "
                     f"{by_path[name + '_mesh8']}")
    print(f"phase 14: NaiveBPE and NaiveWP(mesh=make_data_mesh(8, "
          f"devices=['{dev}'] * 8)).train of all {len(corpus)} sentences to "
          f"{max_vocab} equal the JAX goldens: " + "; ".join(lines)
          + f"; {smi}")

    # the forced tiers and a mesh of 1, to 1,000
    tier_lines = []
    for name, cls in models.items():
        for tier in ("compact", "full", None):
            m = mesh if tier else make_data_mesh(1, devices=[dev])
            tok = cls(mesh=m, device=dev)
            tok._force_tier = tier
            before = read_counts(kernels)
            t0 = time.perf_counter()
            tok.train(corpus, small_vocab)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = counts_since(kernels, before)
            got = tok.merges_list if name == "NaiveBPE" else tok._merge_log
            want = (lists["golden"] if name == "NaiveBPE"
                    else wp_merges)[:len(got)]
            if got != want or len(tok.vocab) != small_vocab:
                raise AssertionError(f"{name} tier {tier}: the merges differ "
                                     "from the golden's prefix")
            st = tok._sel_stats
            steps = sum(st.values())
            if tier and (st["proven"] or not st[tier]
                         or (tier == "full" and st["compact"])):
                raise AssertionError(f"{name} tier {tier}: {st}")
            # the forced full tier: one step queued step by step, then one
            # replay a step
            if tier == "full" and (tok._graph_stats["replays"] != steps - 1
                                   or tok._graph_stats["graphs"].keys()
                                   != {"full"}):
                raise AssertionError(f"{name} tier full: {steps} steps, "
                                     f"graph counts {tok._graph_stats}")
            # the forced full tier counts the gathered rows only
            if (counts["pair_rows"], counts["pair_stats"],
                    counts["merge_rows"], counts["nominate_tables"]) != (
                    0 if tier == "full" else steps, st["full"],
                    len(got), 0 if tier else steps):
                raise AssertionError(f"{name} tier {tier}: {st}, "
                                     f"launches {counts}")
            graphs = sharded_graph_check(tok, f"{name} tier {tier}")
            tier_lines.append(f"{name} {tier or 'mesh of 1'} {wall:.3f} s "
                              f"{st}, {graphs}")
    print(f"phase 14b: to {small_vocab}, each equal to the golden's "
          "prefix, tiers asserted: " + "; ".join(tier_lines) + f"; {smi}")

    # FastWP's sharded encode and the other encoders under the mesh
    with open(os.path.join(GOLDEN, "port_t85k_fastwp_vocab.json"),
              encoding="utf-8") as f:
        fast_vocab = json.load(f)
    enc = {"FastWP": (load(FastWP(mesh=mesh, device=dev), "vocab.json",
                           fast_vocab), expect),
           "FastBPE": (load(FastBPE(mesh=mesh, device=dev), "merges.json",
                            lists["golden"]), expect_enc["FastBPE_golden"]),
           "NaiveBPE": (load(NaiveBPE(mesh=mesh, device=dev), "merges.json",
                             lists["golden"]),
                        expect_enc["NaiveBPE_golden"]),
           "NaiveWP": (load(NaiveWP(mesh=mesh, device=dev), "vocab.json",
                            wp_vocab), expect_enc["NaiveWP_golden"])}
    enc_lines = []
    for name, (tok, want) in enc.items():
        walls = []
        for run in range(2):
            before = read_counts(kernels)
            t0 = time.perf_counter()
            out = tok.tokenize_batch(corpus)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if digest(out) != want["full_sha256"]:
                raise AssertionError(f"{name} under the mesh: the output "
                                     "differs from the JAX package's")
        counts = {k: v for k, v in counts_since(kernels, before).items()
                  if v}
        # FastWP: one fused launch a shard, nothing else
        if name == "FastWP" and counts != {"wp_e2e_scan_compact": 8}:
            raise AssertionError(f"FastWP under the mesh: {counts}")
        by_path[f"{name}_mesh8_encode"] = counts
        enc_lines.append(f"{name} cold {walls[0] * 1e3:.3f} ms, warm "
                         f"{walls[1] * 1e3:.3f} ms, launches {counts}")
    out = None
    print("phase 14c: tokenize_batch of the whole corpus under the mesh "
          "equals the JAX digests: " + "; ".join(enc_lines) + f"; {smi}")

    traced, marks = [], []

    def traced_train():
        marks.append(read_counts(kernels))
        traced.append(NaiveBPE(mesh=mesh, device=dev))
        traced[-1].train(corpus, trace_vocab)

    # once untraced, then traced
    wall, busy, by_name = device_trace(
        traced_train, os.path.join(trace_dir, "mesh_train_trace.json"),
        warmup=True)
    spans14 = shard_spans(by_name, marks[-1], traced[-1], kernels,
                          "phase 14d")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    grouped = {k: [sum(c for n, (c, _) in by_name.items() if k in n),
                   sum(ms for n, (_, ms) in by_name.items() if k in n)]
               for k in ("pair_rows_kernel", "nominate_kernel",
                         "lookup_reduce_kernel", "compact_tables_kernel",
                         "merge_rows_kernel")}
    if by_name and not all(c for c, _ in grouped.values()):
        raise AssertionError(f"the trace shows no grouped kernel: {grouped}")
    # the merge takes its ids as arguments: no host-to-device copy a
    # step, so the train's copies are its set-up's, a few whatever the
    # number of merges
    h2d = sum(c for n, (c, _) in by_name.items() if "HtoD" in n)
    if by_name and h2d > H2D_SETUP_MAX:
        raise AssertionError(f"{h2d} host-to-device copies for "
                             f"{grouped['merge_rows_kernel'][0]} merges "
                             f"(set-up makes at most {H2D_SETUP_MAX})")
    # no memset and no library top-k: the nomination is the port's
    # kernel, one launch a step
    n_memsets = memsets(by_name)
    topk_kernels = {n: c for n, (c, _) in by_name.items()
                    if any(w in n.lower() for w in TOPK_KERNEL_WORDS)}
    steps = sum(traced[-1]._sel_stats.values())
    # the certificate runs inside K2: no launch of its own
    cert_kernels = sum(c for n, (c, _) in by_name.items()
                       if "certificate_kernel" in n)
    if by_name and (n_memsets or topk_kernels or cert_kernels
                    or grouped["nominate_kernel"][0] != steps):
        raise AssertionError(f"the traced train made {n_memsets} memsets, "
                             f"top-k kernels {topk_kernels}, "
                             f"{cert_kernels} certificate_kernel launches, "
                             f"{grouped['nominate_kernel'][0]} nominations "
                             f"in {steps} steps")
    dev_line = ("not measured (the trace holds no device events)"
                if not by_name else
                f"device busy {busy:.3f} ms of {wall:.1f} ms (idle share "
                f"{1 - busy / wall:.4f}); "
                + "; ".join(f"{n} x{c} {ms:.3f} ms" for n, (c, ms) in top)
                + "; the grouped kernels: " + "; ".join(
                    f"{n} x{c} {ms:.3f} ms" for n, (c, ms) in grouped.items())
                + f"; host-to-device copies in the whole train (set-up "
                  f"included) {h2d}; memsets {n_memsets}, top-k library "
                  f"kernels {len(topk_kernels)}, certificate_kernel "
                  f"launches {cert_kernels}, nomination launches "
                  f"{grouped['nominate_kernel'][0]} in {steps} steps; "
                  f"kernel spans equal to the launch counters {spans14}; "
                  + trace_graph_line(by_name) + "; "
                  + sharded_graph_check(traced[-1], "phase 14d"))
    print(f"phase 14d: one warm NaiveBPE train to {trace_vocab} on the mesh "
          f"of 8 under torch.profiler (after an untraced one): {dev_line}; "
          f"{smi}")
    return by_path


def shard_spans(by_name, before, tok, kernels, what):
    """The sharded step's launches in one traced train, measured: raises
    unless each kernel of ``SHARD_TRACE_KERNELS`` ran as many times in the
    trace (its kernel spans) as its wrapper's counter counted since
    ``before`` (read_counts as the traced train started), replays
    included, and unless the trace's graph launches are the train's
    replays. Returns {name: spans}."""
    if not by_name:
        raise AssertionError(f"{what}: the trace holds no device events, "
                             f"so the launches are not measured")
    now = counts_since(kernels, before)
    counted = {k: now[k] for k, _ in SHARD_TRACE_KERNELS}
    spans = {k: sum(c for n, (c, _) in by_name.items() if part in n)
             for k, part in SHARD_TRACE_KERNELS}
    replays = tok._graph_stats["replays"]
    if counted != spans or TRACE_API.get("graph_launches") != replays:
        raise AssertionError(f"{what}: launches counted {counted}, kernel "
                             f"spans in the trace {spans}; graph launches "
                             f"{TRACE_API.get('graph_launches')} for "
                             f"{replays} replays")
    return spans


def held_tensors(obj, seen=None, out=None):
    """The tensors ``obj`` holds in its attributes, lists, tuples and
    dicts, recursively over the port's objects."""
    import torch
    seen = set() if seen is None else seen
    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
        return out
    if id(obj) in seen or obj is None or isinstance(
            obj, (int, float, str, bool, torch.device)):
        return out
    seen.add(id(obj))
    if isinstance(obj, (list, tuple)):
        items = obj
    elif isinstance(obj, dict):
        items = obj.values()
    elif type(obj).__module__.startswith("subword_tokenizers_tpu_torch"):
        items = vars(obj).values()
    else:
        return out
    for v in items:
        held_tensors(v, seen, out)
    return out


def phase14e(dev, arrays, table, golden, smi, reps=50, meshes=None,
             what="phase 14e"):
    """Phase 14e: a captured top-K tier and a captured compact tier of
    the sharded step (parallel/train.ShardedTrainer), on each of
    ``meshes`` ((label, mesh); by default the one-card meshes of 8 and 1)
    at the corpus's BPE state after the golden's first 1,000 merges,
    each replayed ``reps`` times from copies of that state
    (every tensor the trainer holds and its host values restored, but
    the TableSets' descriptors, whose epoch and look-back words go on as
    a run's do): every replay's records, its K1 tables, its runs and its
    runs table equal those of the same tiers queued step by step from
    that state, and every compact replay advances the compaction's epoch
    word by one (a replay that took a stale epoch, parity or buffer of its
    capture would differ). Also a replayed tier's host and device time.
    Returns {label: notes}."""
    import torch
    from subword_tokenizers_tpu_torch.ops.pairstats import canonical
    from subword_tokenizers_tpu_torch.parallel import train as ptrain
    from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh
    if meshes is None:
        meshes = [(f"mesh of {n}", make_data_mesh(n, devices=[dev] * n))
                  for n in (8, 1)]
    out, lines = {}, []
    for label, mesh in meshes:
        tr = ptrain.ShardedTrainer(mesh, arrays.sym, arrays.freq)
        if not tr.graphed:
            raise AssertionError(f"{what}, {label}: the trainer does not "
                                 f"graph its tiers")
        t = type(table)(table.strings())
        for sa, sb in golden[:1000]:
            tr.merge(t.get(sa), t.get(sb), t.intern(sa + sb))
        tr.select()  # the run's first step, step by step
        tr._prepare("compact")
        with torch.cuda.device(dev):
            tr._queue("compact", False)  # its launchers warmed
        torch.cuda.synchronize()
        blk = tr.corpus.blocks[0]
        descs = {ts.desc.data_ptr() for ts in blk.sets}
        kept = [x for x in held_tensors(tr)
                if x.data_ptr() not in descs and x.device.type == "cuda"]
        initial = [x.clone() for x in kept]
        slots, tables = tr._host_values()
        host0 = [getattr(o, a) for o, a in slots]
        fills0 = [x.fills for x in tables]

        def restore():
            for x, x0 in zip(kept, initial):
                x.copy_(x0)
            for (o, a), v in zip(slots, host0):
                setattr(o, a, v)
            for x, f in zip(tables, fills0):
                x.fills = f

        def outputs():
            """Both table sets, the runs and the runs tables, each table
            and each shard's runs in canonical form (K1's hash tables
            place keys by atomics, so their layouts, and the runs' table
            order, differ between runs of one step)."""
            pair = tr.corpus._runs_tables
            cap = min(tr.run_cap, tr.corpus.n_local_pairs)
            rk, rc, rp, ovf = tr.corpus.run_buffers(0, cap)
            got = [x for ts in blk.sets for tab in ts.tables
                   for x in canonical(*tab)]
            for i in range(len(blk.shards)):
                seg = slice(i * cap, (i + 1) * cap)
                got += canonical(rk[seg], rc[seg], rp[seg])
            got.append(ovf.clone())
            for p in (() if pair is None else pair.tables):
                got += canonical(p.keys, p.counts, p.pos)
            return got

        def step(run):
            """The top-K tier then the compact tier, each by ``run``;
            their records and the outputs."""
            recs = []
            for tier, head in (("topk", True), ("compact", False)):
                run(tier, head)
                recs.append(tr._fetch())
            torch.cuda.synchronize()
            return recs, outputs()

        def queued(tier, head):
            with torch.cuda.device(dev):
                tr._queue(tier, head)

        restore()
        want_recs, want = step(queued)
        bad, host_ms, dev_ms = [], {"topk": [], "compact": []}, \
            {"topk": [], "compact": []}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def replayed(tier, head):
            epoch = [ts.epoch for ts in blk.sets]
            torch.cuda.synchronize()
            start.record()
            t0 = time.perf_counter()
            tr._replay(tier, head)
            host_ms[tier].append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            dev_ms[tier].append(start.elapsed_time(end))
            moved = [ts.epoch - e for ts, e in zip(blk.sets, epoch)]
            if sorted(moved) != ([0, 1] if tier == "compact" else [0, 0]):
                bad.append((tier, "epoch", moved))

        for r in range(reps):
            restore()
            recs, got = step(replayed)
            diff = [j for j, (g, w) in enumerate(zip(got, want))
                    if not torch.equal(g, w)]
            if recs != want_recs or diff:
                bad.append((r, recs, diff[:6]))
        graphs = len(tr.graphs)
        tr.close()
        if bad or graphs != 2 or not want_recs[0][4]:
            raise AssertionError(f"{what}, {label}: replays {bad} differ "
                                 f"from the tiers queued step by step "
                                 f"({want_recs}), or {graphs} graphs")
        med = {k: sorted(v)[len(v) // 2] for k, v in host_ms.items()}
        dmed = {k: sorted(v)[len(v) // 2] for k, v in dev_ms.items()}
        out[label] = {"host_ms": med, "device_ms": dmed,
                      "proven": want_recs[0][5], "exact": want_recs[1][5]}
        lines.append(f"{label}: records {want_recs} (top-K, compact), "
                     f"a replay's host time median top-K "
                     f"{med['topk']:.3f} ms, compact {med['compact']:.3f} "
                     f"ms (max {max(host_ms['topk']):.3f}, "
                     f"{max(host_ms['compact']):.3f}; the first replays "
                     f"include their captures), device time (CUDA events "
                     f"around the replay) median top-K {dmed['topk']:.4f} "
                     f"ms, compact {dmed['compact']:.4f} ms")
    print(f"{what}: a top-K and a compact tier captured once each and "
          f"replayed {reps} times from copies of one state (the BPE state "
          f"after 1,000 golden merges): every replay's records, K1 tables, "
          f"runs and runs tables equal the tiers queued step by step, each "
          f"compact replay advanced the epoch word by one; "
          + "; ".join(lines) + f"; {smi}")
    return out


def collective_spans(by_name) -> int:
    """The device work of ``torch.distributed`` collectives in a trace
    (``by_name`` of :func:`device_trace`): NCCL's kernels and the
    device-to-device copies (NCCL's one-rank path copies a gather's input
    into its output and runs nothing for an in-place reduction)."""
    return sum(c for n, (c, _) in by_name.items()
               if "nccl" in n.lower() or "DtoD" in n)


def phase15(dev, corpus, anchor, checks, arrays, table, golden, smi,
            trace_dir, max_vocab=8000, trace_vocab=2000, reps=50,
            kind="cuda"):
    """Phase 15: the process-group route with NCCL at world size 1 (NCCL
    takes one rank per GPU): a TCP store on localhost, an 8-shard
    process-group mesh on the card. NaiveBPE and NaiveWP on all of
    ``corpus`` to ``max_vocab``, cold and warm, each equal to its golden
    (``checks``: the models' golden checks; BPE's first merges the
    reference ``anchor``), each tier after a run's first step one graph
    replay holding the tier's collectives (``sharded_graph_check``), the
    tiers, the launches and the collectives counted as phase 14 counts
    them; the coordinator and ``fetch_global``; (15c) a warm BPE train to
    ``trace_vocab`` traced after an untraced one: each kernel's spans
    equal to its counter, the graph launches to the replays, and the
    collectives' device work (:func:`collective_spans`, a gather's and a
    reduction's measured first) to the collectives counted, the graphs'
    included; (15d) phase 14e on this mesh. Returns the launches of the
    warm runs. (``kind`` "cpu" takes gloo, for a rehearsal on the CPU.)"""
    import socket
    import torch
    import torch.distributed as dist
    from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP
    from subword_tokenizers_tpu_torch.parallel import distributed
    from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    kernels = shard_kernels()
    distributed.initialize(f"localhost:{port}", num_processes=1,
                           process_id=0, device=kind)
    models = {"NaiveBPE": NaiveBPE, "NaiveWP": NaiveWP}
    try:
        assert dist.get_backend() == ("nccl" if kind == "cuda" else "gloo")
        assert distributed.is_coordinator()
        assert distributed.process_count() == 1
        nccl = ".".join(map(str, torch.cuda.nccl.version())) \
            if kind == "cuda" else "none (gloo)"
        mesh = make_data_mesh(8, devices=[dev] * 8)
        assert mesh.group and mesh.size == 8
        by_path, lines = {}, []
        for name, cls in models.items():
            walls, graph_lines = [], []
            for run in range(2):  # cold, warm
                what = f"phase 15 {name} run {run}"
                before = read_counts(kernels)
                issued = dict(mesh.collectives)
                tok = cls(mesh=mesh, device=dev)
                t0 = time.perf_counter()
                tok.train(corpus, max_vocab)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                counts = counts_since(kernels, before)
                checks[name](tok, what)
                if name == "NaiveBPE" and tok.merges_list[:len(
                        anchor)] != anchor:
                    raise AssertionError(f"{what}: the first merges differ "
                                         f"from the reference anchor")
                if max_vocab == 8000:
                    sharded_tiers_check(name, tok, what)
                graph_lines.append(sharded_graph_check(tok, what))
                calls = sharded_launch_check(name, tok, counts, what)
                got = {k: mesh.collectives[k] - n for k, n in issued.items()}
                want = step_collectives(tok, name == "NaiveWP")
                if got != want:
                    raise AssertionError(f"{what}: collectives {got}, "
                                         f"expected {want}")
            steps = sum(tok._sel_stats.values())
            by_path[f"{name}_nccl8"] = {k: v for k, v in counts.items() if v}
            lines.append(f"{name} cold {walls[0]:.3f} s, warm {walls[1]:.3f} "
                         f"s ({walls[1] / steps * 1e3:.3f} ms a step), graphs "
                         f"cold {graph_lines[0]}, warm {graph_lines[1]}, "
                         f"tiers {tok._sel_stats}, collectives {got}, "
                         f"{calls} kernel-wrapper calls, warm launches "
                         f"{by_path[name + '_nccl8']}")
        rows = [torch.full((2, 3), i, device=dev) for i in range(8)]
        fetched = distributed.fetch_global(rows, mesh)
        assert fetched[:, 0].tolist() == [i for i in range(8)
                                          for _ in range(2)]
        print(f"phase 15: torch.distributed NCCL {nccl} at world size 1 "
              f"(TCP store on localhost), a process-group mesh of 8 shards "
              f"on the card, each tier after a run's first step one graph "
              f"replay with its collectives: NaiveBPE and NaiveWP to "
              f"{max_vocab} equal the goldens (BPE's first {len(anchor)} "
              f"merges the reference anchor): " + "; ".join(lines)
              + f"; is_coordinator, process_count 1 and fetch_global "
              f"checked; {smi}")

        # 15c: the collectives' device work, a gather's and a reduction's
        # measured alone, then a traced train
        part = torch.arange(2048, dtype=torch.int64, device=dev)
        out = torch.empty_like(part)
        per = {}
        for k, fn in (("all_gather", lambda: mesh.gather([part], out=out)),
                      ("all_reduce", lambda: mesh.sum([part]))):

            def calls(fn=fn):
                # device_trace counts the device events from the host's
                # start of the call on: a copy queued in its first
                # microseconds can be stamped before it, so the host
                # pauses before it queues the collectives
                time.sleep(0.01)
                for _ in range(16):
                    fn()

            n0 = mesh.collectives[k]
            _, _, by_name = device_trace(
                calls, os.path.join(trace_dir, f"nccl_{k}.json"),
                warmup=True)
            # the warm-up call's and the traced call's
            per[k] = collective_spans(by_name) / (
                (mesh.collectives[k] - n0) / 2)
        traced, marks = [], []

        def traced_train():
            marks.append((read_counts(kernels), dict(mesh.collectives)))
            traced.append(NaiveBPE(mesh=mesh, device=dev))
            traced[-1].train(corpus, trace_vocab)

        wall, busy, by_name = device_trace(
            traced_train, os.path.join(trace_dir, "nccl_train_trace.json"),
            warmup=True)
        spans = shard_spans(by_name, marks[-1][0], traced[-1], kernels,
                            "phase 15c")
        issued = {k: mesh.collectives[k] - n for k, n in marks[-1][1].items()}
        want = sum(per[k] * n for k, n in issued.items())
        got = collective_spans(by_name)
        if got != want:
            raise AssertionError(f"phase 15c: the collectives' device work "
                                 f"{got} spans, expected {want} for "
                                 f"{issued} at {per} a collective")
        print(f"phase 15c: one warm NaiveBPE train to {trace_vocab} on the "
              f"NCCL mesh under torch.profiler (after an untraced one): "
              f"device busy {busy:.3f} ms of {wall:.1f} ms (idle share "
              f"{1 - busy / wall:.4f}); kernel spans equal to the launch "
              f"counters {spans}; " + trace_graph_line(by_name) + "; "
              + sharded_graph_check(traced[-1], "phase 15c")
              + f"; collectives {issued}, their device work {got} spans "
              f"(measured alone: {per['all_gather']:g} a gather, "
              f"{per['all_reduce']:g} a reduction at world size 1); {smi}")

        # 15d: captured tiers replayed from copies of one state
        phase14e(dev, arrays, table, golden, smi, reps=reps,
                 meshes=[("the NCCL mesh of 8", mesh)], what="phase 15d")
    finally:
        dist.destroy_process_group()
    return by_path


def phase16(dev, scan_args, scan_params, smi, seed=SEED):
    """Phase 16: the gather probe (``tools/gather_probe.py``). Its
    ``main`` runs on the card with the launch counts zeroed just before;
    then its three kernels (``gather_take2d``, ``gather_loop`` global and
    shared) against their plain versions on the card, exactly, on the
    probe's inputs from three seeds and on int32 edge cases; their times
    by CUDA events, the marginal time of one dependent iteration of each
    loop mode (the slope from 128 to 1,152 iterations), their byte
    bounds and the loops' latency bound (128 iterations at that slope);
    and kernel 1's slowest row on the corpus (``scan_args`` at
    ``scan_params``: its count of steps, found by the plain scan) times
    each mode's iteration. Returns (errs, timing, bounds, library,
    launches, notes)."""
    import contextlib
    import io
    import numpy as np
    import torch
    from subword_tokenizers_tpu_torch.ops.wp_encode_e2e import \
        wp_e2e_scan_ref
    from subword_tokenizers_tpu_torch.tools import gather_probe as gp
    names = ("gather_take2d", "gather_loop", "gather_loop_shared")
    before = {k: counter("launch." + k) for k in (
        "gather_take2d", "gather_loop", "gather_loop.shared")}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = gp.main(["--seed", str(seed)], device=dev)
    got = {k: counter("launch." + k) - n for k, n in before.items()}
    launches = {"gather_take2d": got["gather_take2d"],
                "gather_loop": got["gather_loop"] - got["gather_loop.shared"],
                "gather_loop_shared": got["gather_loop.shared"]}
    if not all(launches.values()):
        raise AssertionError(f"the probe launched no kernel: {launches}")
    if not all(res[k]["correct"] for k in ("take2d", "loop_global",
                                           "loop_shared")):
        raise AssertionError(f"the probe's main found a difference:\n"
                             f"{buf.getvalue()}")

    errs = dict.fromkeys(names, 0)
    n_cases = 0

    def check_loop(tab, idx, iters):
        nonlocal n_cases
        want = gp.gather_loop_ref(tab, idx, iters)
        for shared, key in ((False, "gather_loop"),
                            (True, "gather_loop_shared")):
            errs[key] = max(errs[key], max_err(
                gp.gather_loop(tab, idx, iters, shared), want))
        n_cases += 1

    for s in (seed, 1, 2):
        tab, idx, col = (torch.from_numpy(a).to(dev)
                         for a in gp.take_inputs(s))
        errs["gather_take2d"] = max(errs["gather_take2d"], max_err(
            gp.gather_take2d(tab, idx, col),
            gp.gather_take2d_ref(tab, idx, col)))
        check_loop(*(torch.from_numpy(a).to(dev) for a in gp.loop_inputs(s)),
                   gp.LOOP_ITERS)
    # int32 edges: indices outside the table; full-range values through
    # the run-time divisor (N = 97) and the compile-time one (N = 50,000)
    rng = np.random.default_rng(seed)
    edge = torch.tensor([-1, 4096, 0, 2 ** 31 - 1], dtype=torch.int32,
                        device=dev)
    errs["gather_take2d"] = max(errs["gather_take2d"], max_err(
        gp.gather_take2d(tab, edge, edge.flip(0).clamp(max=127)),
        gp.gather_take2d_ref(tab, edge, edge.flip(0).clamp(max=127))))
    for N in (97, gp.LOOP_N_TAB):
        full = (torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=n,
                                              dtype=np.int32)).to(dev)
                for n in (N, 3000))
        check_loop(*full, 40)
    if any(errs.values()):
        raise AssertionError(f"a probe kernel differs: {errs}")

    tab, idx, col = (torch.from_numpy(a).to(dev)
                     for a in gp.take_inputs(seed))
    ltab, lidx = (torch.from_numpy(a).to(dev) for a in gp.loop_inputs(seed))
    idx64, col64 = idx.long(), col.long()
    long_iters = 9 * gp.LOOP_ITERS
    timing = {"gather_take2d": (
        cuda_ms(lambda: gp.gather_take2d(tab, idx, col), 200, True),
        cuda_ms(lambda: gp.gather_take2d_ref(tab, idx, col), 20))}
    per_iter = {}
    for key, shared in (("gather_loop", False),
                        ("gather_loop_shared", True)):
        timing[key] = (
            cuda_ms(lambda: gp.gather_loop(ltab, lidx, shared=shared), 200,
                    True),
            cuda_ms(lambda: gp.gather_loop_ref(ltab, lidx), 3))
        t_long = cuda_ms(lambda: gp.gather_loop(ltab, lidx, long_iters,
                                                shared), 50, True)
        per_iter[key] = (t_long - timing[key][0]) / (long_iters
                                                     - gp.LOOP_ITERS)
    library = {"gather_take2d": cuda_ms(lambda: tab[idx64, col64], 200,
                                        True)}
    # Bytes: the indices read and the output written once, and one
    # 4-byte entry of the table per gather, never more than the whole
    # table. Operations, counted low: a gather; for the loop, two adds
    # and two remainders an iteration.
    n_take, n_lane = idx.shape[0], lidx.shape[0]
    n_visit = n_lane * gp.LOOP_ITERS
    loop_bound = bound(nbytes(lidx) * 2 + visited(n_visit, 4, ltab),
                       4 * n_visit)
    bounds = {"gather_take2d": bound(nbytes(idx, col) + 4 * n_take
                                     + visited(n_take, 4, tab), n_take),
              "gather_loop": loop_bound, "gather_loop_shared": loop_bound}
    latency = {k: gp.LOOP_ITERS * per_iter[k] for k in per_iter}

    # kernel 1's slowest row: the fewest steps after which no row runs
    cap, max_steps, unk_ovf = scan_params
    lo, hi = 0, int(max_steps)
    while lo < hi:
        mid = (lo + hi) // 2
        stuck = wp_e2e_scan_ref(*scan_args, cap, mid, unk_ovf)[3]
        if bool(stuck.any()):
            lo = mid + 1
        else:
            hi = mid
    k1_steps = lo
    k1_latency = {k: k1_steps * per_iter[k] for k in per_iter}
    notes = {"per_iter_ms": per_iter, "latency_bound_ms": latency,
             "k1_steps": k1_steps, "k1_latency_ms": k1_latency,
             "cases": n_cases, "probe_main": res}
    torch.cuda.synchronize()
    print(f"phase 16: the gather probe's main on the card (launches "
          f"{launches}): " + "; ".join(ln.rsplit(" (", 1)[0] for ln in
                                       buf.getvalue().splitlines())
          + f"; the three kernels equal their plain versions exactly on "
          f"{n_cases} loop cases and 4 take cases (3 seeds, int32 edges); "
          f"take2d {timing['gather_take2d'][0] * 1e3:.3f} us (plain "
          f"{timing['gather_take2d'][1] * 1e3:.3f}, tab[idx, col] "
          f"{library['gather_take2d'] * 1e3:.3f}, bound "
          f"{bounds['gather_take2d'][0] * 1e3:.4f}); " + "; ".join(
              f"{k} {timing[k][0] * 1e3:.3f} us a call (plain "
              f"{timing[k][1]:.3f} ms), {per_iter[k] * 1e6:.2f} ns a "
              f"dependent iteration (marginal), latency bound "
              f"{latency[k] * 1e3:.3f} us, byte bound "
              f"{bounds[k][0] * 1e3:.4f} us" for k in per_iter)
          + f"; kernel 1's slowest row on the corpus takes {k1_steps} steps: "
          + ", ".join(f"{k1_latency[k] * 1e3:.3f} us at the {k} rate"
                      for k in per_iter) + f"; {smi}")
    return errs, timing, bounds, library, launches, notes


def cli_kernels():
    """{name: its launch counter's name in the port's profiler} of the
    encode and training kernels of slices 1-4, which the CLI's steps
    launch: FastWP's fused scan, kernel 2, K1-K5 and K6's fused form."""
    return {k: "launch." + k for k in (
        "wp_e2e_scan_compact", "compact_ids", "pair_stats", "select_unify",
        "merge_apply", "symbol_freqs", "bpe_encode", "wp_match_compact")}


CLI_MODELS = ("NaiveBPE", "FastBPE", "NaiveWordPiece", "FastWordPiece")
# The kernels each step of phase 17 must launch.
CLI_MUST = {
    "train": ("pair_stats", "select_unify", "merge_apply", "symbol_freqs"),
    "tokenize": ("wp_e2e_scan_compact", "compact_ids", "bpe_encode",
                 "wp_match_compact"),
    "benchmark": ("wp_e2e_scan_compact", "compact_ids", "bpe_encode",
                  "wp_match_compact"),
}


def phase17(dev, corpus, golden, wp_golden, want_sha, fast_vocab, smi,
            max_vocab=8000, n_compare=2000):
    """Phase 17: the CLI (``python3 -m subword_tokenizers_tpu_torch.cli``,
    its ``main`` on ``dev``) at full width, in a temporary working
    directory: the four models trained on all of ``corpus`` to
    ``max_vocab`` and saved (BPE's merges equal to ``golden``,
    WordPiece's vocab to ``wp_golden``); then, with FastWordPiece's
    resources replaced by ``fast_vocab``, the whole corpus tokenized from
    the file (each model's token lists' sha256 equal to ``want_sha``),
    the pretrained benchmark of the whole corpus, and ``--compare`` on
    its first ``n_compare`` sentences, whose report must equal the CPU
    path's. Each step's stdout is captured, its wall and launches
    printed. Returns {step: launches}."""
    import contextlib
    import io
    import torch
    from subword_tokenizers_tpu_torch import cli
    kernels = cli_kernels()
    models = list(CLI_MODELS)
    lines, by_step = [], {}
    cwd = os.getcwd()

    def step(name, argv, device=dev):
        before = read_counts(kernels)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv, device=device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in counts_since(kernels, before).items()
                  if v}
        if device is dev:
            missing = [k for k in CLI_MUST.get(name, ())
                       if not counts.get(k)]
            if missing:
                raise AssertionError(f"CLI step {name} launched no "
                                     f"{missing}: {counts}")
            by_step[name] = counts
        return buf.getvalue(), wall, counts

    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            with open("corpus.json", "w", encoding="utf-8") as f:
                json.dump(corpus, f, ensure_ascii=False)
            with open("head.json", "w", encoding="utf-8") as f:
                json.dump(corpus[:n_compare], f, ensure_ascii=False)
            out, wall, counts = step("train", [
                "--model", *models, "--train", "corpus.json", "--max_vocab",
                str(max_vocab), "--save", "p17"])
            res = os.path.join("resources", "p17")
            for m in models:
                is_bpe = m.endswith("BPE")
                with open(os.path.join(res, m, "merges.json" if is_bpe
                                       else "vocab.json"),
                          encoding="utf-8") as f:
                    saved = json.load(f)
                if (saved != [list(p) for p in golden] if is_bpe
                        else sorted(saved) != wp_golden):
                    raise AssertionError(f"CLI --train: {m}'s saved "
                                         "resources differ from the golden")
            lines.append(f"--train {wall:.3f} s (resources equal the "
                         f"goldens), launches {counts}")

            with open(os.path.join(res, "FastWordPiece", "vocab.json"), "w",
                      encoding="utf-8") as f:
                json.dump(fast_vocab, f, ensure_ascii=False)
            out, wall, counts = step("tokenize", [
                "--model", *models, "--pretrained", "p17", "--tokenize",
                "corpus.json"])
            n_lines = out.count("\n")
            with open("corpus.tokens.json", encoding="utf-8") as f:
                toks = json.load(f)
            bad = [m for m in models if digest(toks[m]) != want_sha[m]]
            if bad or list(toks) != models:
                raise AssertionError(f"CLI --tokenize: {bad} differ from "
                                     "the JAX digests")
            toks = out = None
            lines.append(f"--tokenize {wall:.3f} s ({n_lines} lines "
                         f"printed; four digests equal), launches {counts}")

            out, wall, counts = step("benchmark", [
                "--model", *models, "--pretrained", "p17", "--benchmark",
                "corpus.json"])
            report = [ln.split()[-2] if ln.startswith("Throughput:")
                      else ln.split()[-1] if ln.startswith("Total time:")
                      else ln.split()[-2]
                      for ln in out.splitlines() if ln.startswith((
                          "=== Tokenization Metrics for", "Throughput:",
                          "Total time:"))]
            if len(report) != 3 * len(models):
                raise AssertionError(f"CLI --benchmark report:\n{out}")
            lines.append(f"--benchmark {wall:.3f} s (batch time and "
                         "throughput the report prints: " + "; ".join(
                             f"{n} {t}, {r} tokens/s" for n, t, r in zip(
                                 *(iter(report),) * 3))
                         + f"), launches {counts}")

            argv = ["--model", *models, "--pretrained", "p17",
                    "--benchmark", "head.json", "--compare"]
            out, wall, counts = step("compare", argv)
            cpu_out, cpu_wall, _ = step("compare", argv, device="cpu")
            if out != cpu_out or "Token Sequence Equivalence" not in out:
                raise AssertionError("CLI --compare: the card's report "
                                     "differs from the CPU path's")
            rates = [" ".join(ln.split()) for ln in out.splitlines()
                     if "match rate" in ln]
            lines.append(f"--compare on {n_compare} sentences {wall:.3f} s, "
                         f"equal to the CPU path's ({cpu_wall:.3f} s): "
                         + "; ".join(rates))
        finally:
            os.chdir(cwd)
    launched = set().union(*by_step.values())
    missing = [k for k in kernels if k not in launched]
    if missing:
        raise AssertionError(f"phase 17 launched no {missing}")
    print(f"phase 17: the CLI at full width ({', '.join(models)}; all "
          f"{len(corpus)} sentences, vocab {max_vocab}): "
          + "; ".join(lines) + f"; {smi}")
    return by_step


def main() -> int:
    import numpy as np
    import torch

    # ---- phase 0: the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"phase 0: {kind}; python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    sys.path.insert(0, ROOT)
    from subword_tokenizers_tpu_torch import FastWP
    from subword_tokenizers_tpu_torch._native import binding
    from subword_tokenizers_tpu_torch.benchmarks import profiling
    from subword_tokenizers_tpu_torch.frontend.charclass import PUNC_PY, WS_PY
    from subword_tokenizers_tpu_torch.ops import _cuda
    from subword_tokenizers_tpu_torch.ops.fetch import (compact_ids,
                                                        compact_ids_ref)
    from subword_tokenizers_tpu_torch.ops.wp_encode import pack_words
    from subword_tokenizers_tpu_torch.ops.wp_encode_e2e import (
        node_records, route_params, tile_layout, wp_e2e_scan,
        wp_e2e_scan_compact, wp_e2e_scan_compact_ref, wp_e2e_scan_ref)
    dev = torch.device(DEVICE)

    # ---- phase 1: builds
    t0 = time.perf_counter()
    binding.load()
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    _cuda.lib()
    t_cuda = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _cuda.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 1: native front end {t_native:.2f} s, CUDA kernels "
          f"{t_cuda:.2f} s (sm_90a); ptxas: {' | '.join(ptxas)}")

    # ---- phase 2: each kernel against its plain version, on the card
    scan_kernels = {k: "launch." + k for k in (
        "wp_e2e_scan", "compact_ids", "wp_e2e_scan_compact")}
    errs = dict.fromkeys(scan_kernels, 0)
    n_cases = 0
    flag_rows = np.zeros(4, dtype=np.int64)

    def check(chars, slen, tables, roots, cap, max_steps, unk_ovf):
        """Kernel 1's rows form, kernel 2 over its rows and the fused
        launch, each against the plain versions on the same inputs."""
        nonlocal n_cases
        goto, fail, pops_off, pops_flat, sharp = tables
        args = (chars, slen, goto, fail, pops_off, pops_flat,
                roots["root_p"], roots["root_sharp"], roots["unk_id"],
                sharp)
        kw = dict(cap=cap, max_steps=max_steps, unk_ovf=unk_ovf,
                  rec=node_records(fail, pops_off, pops_flat))
        got = wp_e2e_scan(*args, **kw)
        want = wp_e2e_scan_ref(*args, cap, max_steps, unk_ovf)
        for g, w in zip(got, want):
            errs["wp_e2e_scan"] = max(errs["wp_e2e_scan"], max_err(g, w))
        ids_r, head_r = compact_ids_ref(*want)
        want_ids = emitted(ids_r, head_r, want[1], cap)
        for name, (ids, head) in (
                ("compact_ids", compact_ids(*got)),
                ("wp_e2e_scan_compact", wp_e2e_scan_compact(*args, **kw))):
            errs[name] = max(errs[name], max_err(head, head_r),
                             max_err(emitted(ids, head, want[1], cap),
                                     want_ids))
        flags = head_r[chars.shape[0] + 1:].cpu().numpy()
        for b in range(4):
            flag_rows[b] += int((flags >> b & 1).sum())
        n_cases += 1
        return got, want, ids_r, head_r

    def u16_words(words):
        return ((words & 0x1FFF) | ((words >> 9) & 0xE000)).astype(
            np.uint16).view(np.int16)

    rng = np.random.default_rng(SEED)
    for k in range(6):
        words, slen, tables, roots = random_case(
            rng, S=2048, W=24, n_nodes=96, A=40,
            max_pops=11 if k < 2 else 3, hang_sharp=k % 2 == 1)
        tables = [torch.from_numpy(t).to(dev) for t in tables]
        slen_d = torch.from_numpy(slen).to(dev)
        for chars in (torch.from_numpy(words).to(dev),
                      torch.from_numpy(u16_words(words)).to(dev)):
            for general in (False, True):
                check(chars, slen_d, tables, roots,
                      *route_params(chars.shape[1], general))
        if k < 2:  # batches across the tiles' edges (128 and 256 rows)
            chars = torch.from_numpy(u16_words(words)).to(dev)
            for R in TILE_EDGE_ROWS:
                check(chars[:R], slen_d[:R], tables, roots,
                      *route_params(24, k == 1))
    # rows staged 96 and 32 a block, and rows too wide to stage in
    # shared memory (staged in device memory)
    stage_rows = {}
    for W in STAGE_WIDTHS:
        words, slen, tables, roots = random_case(
            rng, S=100, W=W, n_nodes=96, A=40, max_pops=6,
            hang_sharp=False)
        tables = [torch.from_numpy(t).to(dev) for t in tables]
        slen_d = torch.from_numpy(slen).to(dev)
        for chars in (torch.from_numpy(words).to(dev),
                      torch.from_numpy(u16_words(words)).to(dev)):
            cap = route_params(W, False)[0]
            stage_rows[f"{W}x{chars.element_size()}"] = tile_layout(
                W, cap, chars.element_size())[0]
            check(chars, slen_d, tables, roots, *route_params(W, False))
    assert 0 in stage_rows.values() and 96 in stage_rows.values(), \
        stage_rows
    if not all(flag_rows):
        raise AssertionError(f"random cases left a flag unset: {flag_rows}")
    # kernel 2 alone across its tiles of 256 rows, overflowing rows on
    # both sides of a boundary, flags given and absent
    for R in TILE_EDGE_ROWS + (5000,):
        out2d = torch.from_numpy(rng.integers(
            -3, 5000, size=(R, 9)).astype(np.int32)).to(dev)
        n_np = rng.integers(0, 10, size=R).astype(np.int32)
        n_np[[r for r in (254, 255, 256, 257, R - 1) if r < R]] = 14
        out_n = torch.from_numpy(n_np).to(dev)
        bits = [torch.from_numpy(rng.random(R) < 0.2).to(dev)
                for _ in range(3)]
        for flags in (bits, [None, bits[1], None]):
            ids, head = compact_ids(out2d, out_n, *flags)
            ids_r, head_r = compact_ids_ref(out2d, out_n, *flags)
            errs["compact_ids"] = max(
                errs["compact_ids"], max_err(head, head_r),
                max_err(emitted(ids, head, out_n, 9),
                        emitted(ids_r, head_r, out_n, 9)))
            n_cases += 1

    # the general-pops route on a real trie: max_pops = 11
    gen = FastWP(device=dev)
    gen.vocab = {"a", "##a", "a" * 12 + "z", "!"}
    gen._build_e2e()
    st = gen._device_state()
    assert st.max_pops == 11, st.max_pops
    alphabet = np.array([ord(c) for c in "aaaaz! "], dtype=np.uint32)
    cps = alphabet[rng.integers(0, alphabet.size, size=(512, 40))]
    cps[:, -1] = 32
    slen = rng.integers(1, 40, size=512).astype(np.int32)
    chars = pack_words(*(torch.from_numpy(a).to(dev) for a in
                         (st.alpha[cps], WS_PY[cps], PUNC_PY[cps])))
    gen_tables = [st.goto, st.fail, st.pops_off, st.pops_flat, st.sharp]
    gen_args = (chars, torch.from_numpy(slen).to(dev), st.goto, st.fail,
                st.pops_off, st.pops_flat, st.root_p, st.root_sharp,
                st.unk_id, st.sharp)
    gen_out = check(chars, gen_args[1], gen_tables,
                    dict(root_p=st.root_p, root_sharp=st.root_sharp,
                         unk_id=st.unk_id),
                    *route_params(40, general=True))[0]

    # the main path's shapes: the corpus's unique chunks
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        corpus = json.load(f)
    with open(os.path.join(ROOT, "tests", "golden",
                           "port_t85k_fastwp_vocab.json"),
              encoding="utf-8") as f:
        vocab = json.load(f)
    with open(os.path.join(ROOT, "tests", "golden",
                           "port_t85k_fastwp_expect.json"),
              encoding="utf-8") as f:
        expect = json.load(f)
    tok = FastWP(device=dev)
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(vocab, f, ensure_ascii=False)
        tok.load_resources(d, strict=True)
    st = tok._device_state()
    _, _, uniq_buf, uniq_off, uniq_len = binding.encode_prep(corpus)
    Lc = -(-(int(uniq_len.max()) + 2) // 8) * 8
    mat16 = binding.pack_u16_rows(uniq_buf, uniq_off, uniq_len, Lc, st.alpha)
    assert mat16.shape == (expect["unique_chunks"], 32), mat16.shape
    chars = torch.from_numpy(mat16.view(np.int16)).to(dev)
    slen_d = torch.from_numpy((uniq_len + 1).astype(np.int32)).to(dev)
    tables = [st.goto, st.fail, st.pops_off, st.pops_flat, st.sharp]
    roots = dict(root_p=st.root_p, root_sharp=st.root_sharp,
                 unk_id=st.unk_id)
    params = route_params(Lc, general=False)
    got, want, ids, head = check(chars, slen_d, tables, roots, *params)
    R = mat16.shape[0]
    total = int(head[R])
    assert total == int(want[1].sum()) and total > 0, total
    assert not bool(head[R + 1:].any()), "real chunks raised a flag"
    assert not any(errs.values()), errs
    scan_args = (chars, slen_d, st.goto, st.fail, st.pops_off,
                 st.pops_flat, st.root_p, st.root_sharp, st.unk_id, st.sharp)
    scan_kw = dict(cap=params[0], max_steps=params[1], unk_ovf=params[2],
                   rec=st.rec)
    timing = {
        "wp_e2e_scan_compact": (
            cuda_ms(lambda: wp_e2e_scan_compact(*scan_args, **scan_kw), 200,
                    True),
            cuda_ms(lambda: wp_e2e_scan_compact_ref(*scan_args, *params),
                    3)),
        "wp_e2e_scan": (
            cuda_ms(lambda: wp_e2e_scan(*scan_args, **scan_kw), 200, True),
            cuda_ms(lambda: wp_e2e_scan_ref(*scan_args, *params), 3)),
        "compact_ids": (
            cuda_ms(lambda: compact_ids(*got), 200, True),
            cuda_ms(lambda: compact_ids_ref(*got), 20)),
    }
    gen_params = route_params(40, general=True)
    gen_kw = dict(cap=gen_params[0], max_steps=gen_params[1],
                  unk_ovf=gen_params[2], rec=gen._device_state().rec)
    timing["wp_e2e_general"] = (
        cuda_ms(lambda: wp_e2e_scan(*gen_args, **gen_kw), 50, True),
        cuda_ms(lambda: wp_e2e_scan_ref(*gen_args, *gen_params), 3))
    # kernel 2's library yardstick: the stream alone (no offsets, no
    # flags), one masked_select over the rows' emitted prefixes
    cols = torch.arange(params[0], device=dev)[None, :]
    library = {"compact_ids": cuda_ms(
        lambda: torch.masked_select(got[0], cols < got[1][:, None]), 200,
        True)}
    # Operations, counted low: a trie step per character (4 integer
    # operations); an add per row and a copy per emitted id. Bytes: of the
    # trie, one goto entry per character; a stream's tokens once each.
    n_chars = int(slen_d.sum())
    n_gen = int(gen_args[1].sum())
    head_bytes = 4 * (2 * R + 1)
    bounds = {
        "wp_e2e_scan": bound(nbytes(chars, slen_d, *got)
                             + visited(n_chars, 4, st.goto), 4 * n_chars),
        "wp_e2e_general": bound(nbytes(gen_args[0], gen_args[1], *gen_out)
                                + visited(n_gen, 4, gen_args[2]),
                                4 * n_gen),
        "wp_e2e_scan_compact": bound(
            nbytes(chars, slen_d) + visited(n_chars, 4, st.goto)
            + 4 * total + head_bytes, 4 * n_chars + 2 * (R + total)),
        "compact_ids": bound(nbytes(got[1], *got[2:]) + 8 * total
                             + head_bytes, 2 * (R + total)),
    }
    torch.cuda.synchronize()
    print(f"phase 2: kernels equal their plain versions exactly on "
          f"{n_cases} cases (rows flagged ovf/stuck/crash/##: "
          f"{flag_rows.tolist()}; batches of {TILE_EDGE_ROWS} rows; rows "
          f"a block by width x word bytes {stage_rows}); at {R} x {Lc}: "
          f"the fused scan {timing['wp_e2e_scan_compact'][0]:.4f} ms "
          f"(plain {timing['wp_e2e_scan_compact'][1]:.3f}, bound "
          f"{bounds['wp_e2e_scan_compact'][0]:.4f}), the rows form "
          f"{timing['wp_e2e_scan'][0]:.4f} ms (plain "
          f"{timing['wp_e2e_scan'][1]:.3f}), kernel 2 "
          f"{timing['compact_ids'][0]:.4f} ms (plain "
          f"{timing['compact_ids'][1]:.3f}, masked_select "
          f"{library['compact_ids']:.4f}, bound "
          f"{bounds['compact_ids'][0]:.4f}); the general-pops route at "
          f"512 x 40: {timing['wp_e2e_general'][0]:.4f} ms (plain "
          f"{timing['wp_e2e_general'][1]:.3f} ms); {smi}")

    # ---- phase 3: the main path
    n_bytes = sum(len(s.encode("utf-8")) for s in corpus)
    # each call: one fused launch, no rows form, no kernel 2
    per_call = {"wp_e2e_scan_compact": 1, "wp_e2e_scan": 0,
                "compact_ids": 0}
    first = read_counts(scan_kernels)
    # run 0 is cold, runs 1-3 warm, run 4 warm with the phase profiler on
    walls = []
    for run in range(5):
        profiling.enable(run == 4)
        reset_spans()
        out = None
        before = read_counts(scan_kernels)
        t0 = time.perf_counter()
        out = tok.tokenize_batch(corpus)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = counts_since(scan_kernels, before)
        if counts != per_call:
            raise AssertionError(f"run {run} launched {counts}, not "
                                 f"{per_call}")
        if digest(out) != expect["full_sha256"]:
            raise AssertionError(f"run {run}: output differs from the JAX "
                                 "package's")
    phase_ms = span_ms(profiling.report())
    profiling.enable(False)
    warm = sorted(walls[1:4])[1]
    launches = counts_since(scan_kernels, first)
    n_tokens = sum(map(len, out))
    assert n_tokens == expect["full_tokens"], n_tokens
    # the front end these calls ran: built from the port's own sources
    so_path = binding.load()._name
    if os.path.dirname(so_path) != os.path.join(
            ROOT, "subword_tokenizers_tpu_torch", "_native", "build"):
        raise AssertionError(f"phase 3: the front end came from {so_path}")
    print(f"phase 3: tokenize_batch of {len(corpus)} sentences "
          f"({n_bytes} bytes, {n_tokens} tokens) equals the JAX sha256; "
          f"front end {so_path}; "
          f"launches {launches} ({per_call} a call); cold "
          f"{walls[0]*1e3:.3f} ms, warm "
          f"{[round(w * 1e3, 3) for w in walls[1:4]]} ms, median "
          f"{warm*1e3:.3f} ms = {n_bytes/warm/1e6:.3f} MB/s; "
          f"profiled {walls[4]*1e3:.3f} ms, phases (ms) "
          f"{json.dumps(phase_ms)}; {smi}")

    streamed = list(tok.tokenize_stream(iter(corpus), batch_sentences=8192))
    assert streamed == out, "tokenize_stream differs from one batch"
    small = rng.integers(0, len(corpus), size=64)
    for n in (1, 7, 64):
        batch = [corpus[i] for i in small[:n]]
        assert tok.tokenize_batch(batch) == [tok.tokenize(s) for s in batch]
    print("phase 3b: tokenize_stream (11 blocks of <= 8192) equals the "
          "batch; batches of 1, 7 and 64 equal the host tokenize")

    out = None
    wall, busy, by_name = device_trace(
        lambda: tok.tokenize_batch(corpus),
        os.path.join(ROOT, "chiprun_out", "chip_smoke_trace.json"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    n_kernels, n_memsets = kernel_launches(by_name), memsets(by_name)
    if by_name and (n_kernels != 1 or n_memsets or not any(
            "scan_compact_kernel" in n for n in by_name)):
        raise AssertionError(f"the traced call made {n_kernels} kernel "
                             f"launches and {n_memsets} memsets: {by_name}")
    dev_line = ("not measured (the trace holds no device events)"
                if not by_name else
                f"device busy {busy:.3f} ms of {wall:.1f} ms "
                f"(idle share {1 - busy / wall:.4f}); {n_kernels} kernel "
                f"launch, {n_memsets} memsets; "
                + "; ".join(f"{n} x{c} {ms:.4f} ms" for n, (c, ms) in top))
    print(f"phase 3c: one warm tokenize_batch under torch.profiler: "
          f"{dev_line}; {smi}")

    # the whole-sentence route (a vocab token holds a space): the rows
    # form and kernel 2, against the CPU path
    ws = {"a b", "a", "b", "##a", "##b", "##c", "!", "c"}
    ws_tok = {d: FastWP(device=d) for d in (dev, "cpu")}
    for t in ws_tok.values():
        t.vocab = set(ws)
        t._build_e2e()
    # each sentence ends in punctuation: a match of "a b" then never eats
    # the trailing space (the reference would crash there)
    ws_batch = ["".join(rng.choice(list("ab c"), size=rng.integers(0, 30)))
                + "!" for _ in range(3000)]
    ws_want = ws_tok["cpu"].tokenize_batch(ws_batch)
    before = read_counts(scan_kernels)
    if ws_tok[dev].tokenize_batch(ws_batch) != ws_want:
        raise AssertionError("the whole-sentence route differs from the "
                             "CPU path")
    ws_launches = counts_since(scan_kernels, before)
    if ws_launches != {"wp_e2e_scan": 1, "compact_ids": 1,
                       "wp_e2e_scan_compact": 0}:
        raise AssertionError(f"the whole-sentence route launched "
                             f"{ws_launches}")
    print(f"phase 3d: the whole-sentence route ({len(ws_batch)} sentences) "
          f"equals the CPU path; launches {ws_launches}")

    # ---- phase 4: an input on which the reference hangs
    hang = FastWP(device=dev)
    hang.vocab = {"a"}
    hang._build_e2e()
    try:
        hang.tokenize_batch(["a ¤ a"])
    except RuntimeError as e:
        assert "makes no progress" in str(e), e
        print(f"phase 4: the hang input raised on the card: {e}")
    else:
        raise AssertionError("the hang input did not raise")

    # ---- phase 5: the BPE training kernels against their plain versions
    from subword_tokenizers_tpu_torch import NaiveBPE
    from subword_tokenizers_tpu_torch.core.corpus import (build_bpe_corpus,
                                                          unique_words)
    from subword_tokenizers_tpu_torch.core.symbols import SymbolTable
    from subword_tokenizers_tpu_torch.frontend.pretokenize import \
        pretokenize_batch
    from subword_tokenizers_tpu_torch.ops import train_loop
    from subword_tokenizers_tpu_torch.ops.flat import (MergeScratch,
                                                       build_flat,
                                                       merge_apply,
                                                       merge_apply_ref)
    from subword_tokenizers_tpu_torch.ops.pairstats import (TablePair,
                                                            canonical,
                                                            pair_stats_ref)
    from subword_tokenizers_tpu_torch.ops.train_loop import (
        init_tables, select_scratch, select_unify, select_unify_ref,
        str_hashes)
    bpe_kernels = ("pair_stats", "select_unify", "merge_apply")
    errs.update({k: 0 for k in bpe_kernels})
    # K2's checks: claims mode and dense mode on each state, and claims
    # mode on a copy whose unclaimed entries hold poison
    k2_checks = {"claims": 0, "dense": 0, "poisoned": 0, "poison_read": 0}
    k2_scratch = select_scratch(dev)

    def err_all(got, want):
        return max(max_err(g, w) for g, w in zip(got, want))

    def hash_tables(strings, sym_cap, max_len):
        """(h1, h2, slen, pw1, pw2) on the card for a list of symbol
        strings (repeats allowed: several ids with one hash)."""
        h = np.zeros((3, sym_cap), dtype=np.int64)
        for i, s in enumerate(strings):
            h[0, i], h[1, i] = str_hashes(s)
            h[2, i] = len(s)
        pw = train_loop.pow_tables(max_len + 4)
        return [torch.from_numpy(x).to(dev) for x in (*h, *pw)]

    def check_k2(tab, claims, st, pw1, pw2, max_vocab, *args):
        """K2 over the claims of the table the loop's TablePair filled,
        over every entry, and over the claims of a copy whose unclaimed
        entries hold poison, each against the plain version on ``tab``;
        returns the worst difference and the kernel's record."""
        st_r = [x.clone() for x in st]
        rec_r = torch.zeros(6, dtype=torch.int32, device=dev)
        select_unify_ref(*tab, *st_r, pw1, pw2, max_vocab, rec_r, *args)
        T = tab[0].shape[0]
        r = 1  # the poison's pair (r, r): for WordPiece the rarest symbol
        if len(args) > 2:
            sf = args[2]
            r = int(torch.where(sf > 0, sf, sf.max() + 1)[:-1].argmin())
        poison = poisoned_copy(claims, (r << 32) | r)
        worst, rec0 = 0, None
        for mode, c, t in (("claims", claims, tab), ("dense", None, tab),
                           ("poisoned", poison, poison.view(T)),
                           ("poison_read", None, poison.view(T))):
            got = [x.clone() for x in st]
            rec = torch.zeros(6, dtype=torch.int32, device=dev)
            select_unify(*t, *got, pw1, pw2, max_vocab, rec, *args,
                         claims=c, scratch=k2_scratch)
            if mode == "poison_read":  # the poison wins when it is read
                if rec.tolist()[:2] != [r, r]:
                    worst = max(worst, 1)
            else:
                worst = max(worst, err_all([*got, rec], [*st_r, rec_r]))
            k2_checks[mode] += 1
            rec0 = rec if rec0 is None else rec0
        return worst, rec0

    def check_k3(fs, wid, wgt, rows, sf=None):
        """K3 with a MergeScratch and a second buffer kept across the
        calls (each row merged twice) against its plain version; the
        worst difference, the carried weights included."""
        sc = MergeScratch(fs.shape[0], dev)
        out = tuple(torch.empty_like(x) for x in (fs, wid, wgt))
        worst = 0
        for row in rows:
            for _ in range(2):
                rec = torch.tensor(row, dtype=torch.int32, device=dev)
                rec_r = rec.clone()
                s_k = None if sf is None else sf.clone()
                s_r = None if sf is None else sf.clone()
                got = merge_apply(fs, wid, wgt, rec, out=out, sym_freq=s_k,
                                  scratch=sc)
                want = merge_apply_ref(fs, wid, wgt, rec_r, sym_freq=s_r)
                worst = max(worst, err_all([*got, rec], [*want, rec_r]))
                if sf is not None:
                    worst = max(worst, max_err(s_k, s_r),
                                max_err(s_k, symbol_freqs_ref(
                                    got[0], got[2], sf.shape[0] - 1)))
        return worst

    def check_bpe(fs, wid, wgt, strings, max_vocab, max_len, pair=None):
        """K1 into a TablePair (``pair``: the training loop's own), K2
        (both modes, each over the table's claims, over every entry and
        over a poisoned copy's claims) and K3 (the winner, a self-merge,
        an inactive step) against their plain versions on one state."""
        if pair is None:
            pair = TablePair(fs.shape[0], dev)
        tab = pair.pairs(fs, wid, wgt)
        errs["pair_stats"] = max(errs["pair_stats"], err_all(
            canonical(*tab), pair_stats_ref(fs, wid, wgt)))
        n = len(strings)
        h1, h2, sl, pw1, pw2 = hash_tables(strings, max_vocab + 8, max_len)
        recs = []
        for host_ids in (False, True):
            st = [h1.clone(), h2.clone(), sl.clone(),
                  torch.tensor([n, n, 1], dtype=torch.int32, device=dev)]
            e, rec = check_k2(tab, pair.claims(), st, pw1, pw2, max_vocab,
                              host_ids)
            errs["select_unify"] = max(errs["select_unify"], e)
            recs.append(rec)
        a, b = recs[0].tolist()[:2]
        self_pair = int(fs[(fs >= 0)].mode().values)
        errs["merge_apply"] = max(errs["merge_apply"], check_k3(
            fs, wid, wgt, (recs[0].tolist(), [self_pair, self_pair, n, 0, 1,
                                              0], [a, b, n, 0, 0, 0])))
        return recs[0]

    n_bpe_cases = 0
    for k, (unit, holes, wscale, n_sym) in enumerate(
            [(False, False, 1, 6), (True, False, 1, 6),
             (False, True, 1, 6), (False, False, (1 << 28) + 9871, 6),
             (False, False, 1, 2), (True, False, 1 << 42, 3)]):
        fs, wid, wgt = (torch.from_numpy(x).to(dev) for x in
                        bpe_random_state(rng, 4000, 12, n_sym, wscale,
                                         unit, holes))
        strings = [chr(ord("a") + i) for i in range(n_sym)]
        rec = check_bpe(fs, wid, wgt, strings, 100, 12)
        # forced hits: the winner's string present at two ids
        a, b = rec.tolist()[:2]
        merged = strings[a] + strings[b]
        check_bpe(fs, wid, wgt, strings + [merged, "zz", merged], 100, 12)
        n_bpe_cases += 2

    words, freq, _ = unique_words(pretokenize_batch(corpus))
    table = SymbolTable()
    arrays = build_bpe_corpus(words, freq, table)
    max_len = arrays.sym.shape[1]
    flat0 = build_flat(arrays.sym, arrays.freq)
    F0 = flat0[0].shape[0]
    n_slots = int((flat0[0] >= 0).sum())
    fs, wid, wgt = (torch.from_numpy(x).to(dev) for x in flat0)
    check_bpe(fs, wid, wgt, table.strings(), 8000, max_len)
    # the state after 1,000 merges, from the kernel path, counted into the
    # loop's own tables: its width halved after the third block (the
    # shrink reads the records a block late, two blocks being in flight)
    state = train_loop.FlatState(*flat0, dev)
    t1000 = SymbolTable(table.strings())
    train_loop.run_fused(state, t1000, len(table) + 1000, max_len,
                         lambda *m: None)
    assert len(t1000) == len(table) + 1000, len(t1000)
    if state.F != F0 // 2:
        raise AssertionError(f"the BPE state did not shrink once by 1,000 "
                             f"merges: F = {state.F}")
    check_bpe(*state.arrays(), t1000.strings(), 8000, max_len,
              state._tables)
    n_bpe_cases += 2
    bpe_shrunk = state, t1000
    if any(errs[k] for k in bpe_kernels):
        raise AssertionError(f"a BPE kernel differs: {errs}")

    # times at the initial state; K1 into one of two tables on alternate
    # calls, as the training loop makes them
    k1 = TablePair(F0, dev)
    h1, h2, sl, ctrl, pw1, pw2, _ = init_tables(table, 8000, max_len, dev)
    rec = torch.zeros(6, dtype=torch.int32, device=dev)
    k2_pair = TablePair(F0, dev)  # K2 reads the claims of its fill
    tab = k2_pair.pairs(fs, wid, wgt)
    claims0 = k2_pair.claims()
    tab_ref = pair_stats_ref(fs, wid, wgt)
    select_unify(*tab, h1, h2, sl, ctrl, pw1, pw2, 8000, rec)
    out = tuple(torch.empty_like(x) for x in (fs, wid, wgt))
    k3_scratch = MergeScratch(F0, dev)
    timing["pair_stats"] = (
        cuda_ms(lambda: k1.pairs(fs, wid, wgt), 200, True),
        cuda_ms(lambda: pair_stats_ref(fs, wid, wgt), 10))
    timing["select_unify"] = (
        cuda_ms(lambda: select_unify(*tab, h1, h2, sl, ctrl, pw1, pw2,
                                     8000, rec, claims=claims0,
                                     scratch=k2_scratch), 200, True),
        cuda_ms(lambda: select_unify_ref(*tab_ref, h1, h2, sl, ctrl, pw1,
                                         pw2, 8000, rec), 10))
    timing["select_unify_dense"] = (
        cuda_ms(lambda: select_unify(*tab, h1, h2, sl, ctrl, pw1, pw2,
                                     8000, rec, scratch=k2_scratch), 200,
                True), None)
    timing["merge_apply"] = (
        cuda_ms(lambda: merge_apply(fs, wid, wgt, rec, out=out,
                                    scratch=k3_scratch), 200, True),
        cuda_ms(lambda: merge_apply_ref(fs, wid, wgt, rec), 10))
    n_pairs0 = int(tab_ref[0].shape[0])
    n_sym0 = int(ctrl[0])
    # Operations, counted low: a hash insert per live slot (10), a compare
    # per entry read (4), a merge test and a move per slot (6).
    # K1's bytes: the slots, 20 for each distinct pair's entry written and
    # for each entry the call before filled (the same pairs), emptied.
    # K2's bytes, as the function needs them: each live entry through the
    # claim list (a claim, a key, a count, a position: 24), the 8-byte h1
    # of each id below n_sym for the unify, the control words and the
    # record (of the other hash and power tables it reads a few entries);
    # select_unify_dense: every entry of the table instead of the live
    # ones (the earlier design's read). K3's: every slot read and written.
    bounds["pair_stats"] = bound(nbytes(fs, wid, wgt)
                                 + 40 * n_pairs0, 10 * n_slots)
    bounds["select_unify"] = bound(24 * n_pairs0 + 8 * n_sym0
                                   + nbytes(ctrl, rec), 4 * n_pairs0)
    bounds["select_unify_dense"] = bound(nbytes(*tab, ctrl, rec)
                                         + 8 * n_sym0, 4 * tab[0].shape[0])
    bounds["merge_apply"] = bound(2 * nbytes(fs, wid, wgt) + nbytes(rec),
                                  6 * F0)
    torch.cuda.synchronize()
    print(f"phase 5: BPE kernels equal their plain versions exactly on "
          f"{n_bpe_cases} states (6 random x 2 symbol tables, the 85k "
          f"initial state, after 1,000 merges at F = {state.F}); K2 over "
          f"the claims of the loop's tables {k2_checks['claims']} times, "
          f"over every entry {k2_checks['dense']}, over a copy whose "
          f"unclaimed entries hold poison {k2_checks['poisoned']}; at "
          f"{n_slots} slots (F = {F0}, {n_pairs0} pairs of T = "
          f"{tab[0].shape[0]}): " + ", ".join(
              f"{k} {timing[k][0]:.4f} ms (plain {timing[k][1]:.3f} ms, "
              f"bound {bounds[k][0]:.5f})" for k in bpe_kernels)
          + f", select_unify over every entry "
          f"{timing['select_unify_dense'][0]:.4f} ms (bound "
          f"{bounds['select_unify_dense'][0]:.5f}); {smi}")

    # ---- phase 6: the BPE training path, the whole corpus to 8,000
    golden_dir = os.path.join(ROOT, "tests", "golden")
    with open(os.path.join(golden_dir, "port_t85k_v8000_bpe_merges.json"),
              encoding="utf-8") as f:
        golden = [tuple(p) for p in json.load(f)]
    with open(os.path.join(golden_dir, "t85k_v578_merges.json"),
              encoding="utf-8") as f:
        anchor = [tuple(p) for p in json.load(f)]
    assert golden[:len(anchor)] == anchor

    def check_train(tok, what):
        if tok.merges_list != golden or len(tok.vocab) != 8000:
            bad = next((i for i, (g, w) in enumerate(
                zip(tok.merges_list, golden)) if g != w),
                min(len(tok.merges_list), len(golden)))
            raise AssertionError(
                f"{what}: {len(tok.merges_list)} merges, first difference "
                f"from the JAX golden at merge {bad}")
        rebuilt = ["".join(syms) for syms, _ in tok.corpus_as_symbols]
        if rebuilt != words or [f for _, f in tok.corpus_as_symbols] != \
                freq.tolist():
            raise AssertionError(f"{what}: corpus_as_symbols is wrong")

    base6 = {k: counter("launch." + k) for k in bpe_kernels}
    g6 = graph_counts()
    # run 0 is cold (the process's first training), runs 1-2 warm, run 3
    # warm with the phase profiler on
    train_walls = []
    for run in range(4):
        profiling.enable(run == 3)
        reset_spans()
        tok = NaiveBPE(device=dev)
        t0 = time.perf_counter()
        tok.train(corpus, 8000)
        torch.cuda.synchronize()
        train_walls.append(time.perf_counter() - t0)
        check_train(tok, f"run {run}")
    train_phase_ms = span_ms(profiling.report())
    profiling.enable(False)
    launches.update({k: counter("launch." + k) - n
                     for k, n in base6.items()})
    if not all(launches[k] for k in bpe_kernels):
        raise AssertionError(f"a BPE kernel was not launched: {launches}")
    # each block, queued or replayed, runs 256 steps of K1, K2 and K3:
    # the counters count the replays' kernels
    blocks6, graphs6 = graph_check(g6, 4, "phase 6")
    if any(launches[k] != 256 * blocks6 for k in bpe_kernels):
        raise AssertionError(f"phase 6: launches {launches} for {blocks6} "
                             f"blocks of 256 steps")
    print(f"phase 6: NaiveBPE(device='cuda').train of all {len(corpus)} "
          f"sentences ({len(words)} word types, {n_slots} slots) to 8000: "
          f"{len(golden)} merges equal the JAX golden (first "
          f"{len(anchor)} = the reference anchor); {graphs6}; launches "
          f"(256 a block of each) "
          f"{ {k: launches[k] for k in bpe_kernels} }; cold "
          f"{train_walls[0]:.3f} s, warm {train_walls[1]:.3f} / "
          f"{train_walls[2]:.3f} s; profiled {train_walls[3]:.3f} s, phases "
          f"(ms) {json.dumps(train_phase_ms)}; {smi}")

    fn, marks = traced_train(lambda: NaiveBPE(device=dev).train(corpus,
                                                                8000))
    with tempfile.TemporaryDirectory() as d:
        wall, busy, by_name = device_trace(
            fn, os.path.join(d, "train_trace.json"), warmup=True)
    before, g6c = marks[-1]
    blocks6c, graphs6c = graph_check(g6c, 1, "phase 6c")
    traced6 = traced_launches(by_name, before, dict.fromkeys(
        bpe_kernels, 256), blocks6c, "phase 6c")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    dev_line = (f"device busy {busy:.3f} ms of {wall:.1f} ms "
                f"(idle share {1 - busy / wall:.4f}); "
                + "; ".join(f"{n} x{c} {ms:.3f} ms" for n, (c, ms) in top)
                + "; " + trace_graph_line(by_name))
    print(f"phase 6c: one warm train under torch.profiler: {graphs6c}; "
          f"kernel spans in the trace {traced6}, equal to the launches "
          f"the counters counted in this train and to 256 a block; "
          f"{dev_line}; {smi}")

    # ---- phase 6b: the other training routes
    g6b = graph_counts()
    with tempfile.TemporaryDirectory() as d:
        part = NaiveBPE(device=dev)
        part.train(corpus, 1400, checkpoint_dir=d, checkpoint_every=500)
        assert part.merges_list == golden[:len(part.merges_list)]
        resumed = NaiveBPE(device=dev)
        resumed.train(corpus, 8000, checkpoint_dir=d, resume=True)
        check_train(resumed, "resumed run")
    per_step = NaiveBPE(device=dev)
    per_step._force_per_step = True
    per_step.train(corpus, 578)
    assert per_step.merges_list == anchor, "per-step path left the anchor"
    small = corpus[:500]
    plain = NaiveBPE(device=dev)
    plain.train(small, 300)
    real_hashes, real_run = train_loop.str_hashes, train_loop.run_fused
    raised = []

    def spy(*args, **kwargs):
        try:
            return real_run(*args, **kwargs)
        except train_loop.HashCollision as e:
            raised.append(e)
            raise

    try:
        train_loop.str_hashes = lambda s: (0, 0)
        train_loop.run_fused = spy
        forced = NaiveBPE(device=dev)
        forced.train(small, 300)
    finally:
        train_loop.str_hashes, train_loop.run_fused = real_hashes, real_run
    assert len(raised) == 1, "the forced collision did not fall back"
    assert (forced.merges_list, forced.corpus_as_symbols) == \
        (plain.merges_list, plain.corpus_as_symbols)
    # run_fused four times: the checkpointed run, the resumed one, the
    # plain one and the one that raised (the per-step path runs none)
    _, graphs6b = graph_check(g6b, 4, "phase 6b")
    print(f"phase 6b: a checkpoint at {len(part.merges_list)} merges "
          f"resumed to 8000 equals the golden; the per-step path to 578 "
          f"equals the reference anchor; a forced hash collision on 500 "
          f"sentences fell back and equals the fused run "
          f"({len(plain.merges_list)} merges), raised once the block in "
          f"flight had run; {graphs6b}")

    # ---- phase 6d: one captured block replayed from a copy of the
    # initial state
    replay_check(dev, arrays, table, arrays.sym.shape[1], smi)

    # ---- phase 7: the WordPiece training kernels against their plain
    # versions
    from subword_tokenizers_tpu_torch import NaiveWP
    from subword_tokenizers_tpu_torch.core.corpus import build_wp_corpus
    from subword_tokenizers_tpu_torch.ops.bitmath import (score_bits,
                                                          score_bits_ref)
    from subword_tokenizers_tpu_torch.ops.pairstats import (
        EMPTY_KEY, symbol_freqs, symbol_freqs_ref)
    wp_kernels = ("symbol_freqs", "wp_score", "select_unify_wp",
                  "merge_apply_wp")
    errs.update({k: 0 for k in wp_kernels})

    # the scorer: weights of every bit length up to 52 (d up to 2^104),
    # counts up to the smaller weight, and the edge families
    n = 1 << 20
    fa = rng.integers(1, 1 << 52, size=n) >> rng.integers(0, 52, size=n)
    fb = rng.integers(1, 1 << 52, size=n) >> rng.integers(0, 52, size=n)
    cs = np.minimum(rng.integers(1, 1 << 53, size=n)
                    >> rng.integers(0, 53, size=n), np.minimum(fa, fb))
    top = (1 << 52) - 1
    edge = [(c, 1 << i, 1 << j) for i in range(52) for j in range(0, 52, 5)
            for c in (1, 3, (1 << 33) - 1)]
    edge += [(c, c * (1 << k) + dl, 1 << j) for k in range(2, 40)
             for c in (3, 5, 101, 2049) for dl in (-1, 0, 1)
             for j in (0, 13, 51) if c * (1 << k) + dl < (1 << 52)]
    edge += [((1 << 53) - 1 - i, top - i, top - 2 * i) for i in range(64)]
    edge += [(0, 0, 0), (1, top, top), (top, 1, 1)]
    cs, fa, fb = (np.concatenate([x, np.array(e, dtype=np.int64)])
                  for x, e in zip((cs, fa, fb), zip(*edge)))
    n_wide = int(sum(int(a) * int(b) >= (1 << 53) for a, b in
                     zip(fa.tolist(), fb.tolist())))
    c_d, fa_d, fb_d = (torch.from_numpy(x).to(dev) for x in (cs, fa, fb))
    errs["wp_score"] = max_err(score_bits(c_d, fa_d, fb_d),
                               score_bits_ref(c_d, fa_d, fb_d))
    n_score = int(cs.shape[0])

    def check_wp(fs, wid, wgt, strings, max_len, sf=None, pair=None,
                 narrow=True):
        """K4, K1 into a TablePair (``pair``: the training loop's own) +
        K2's WordPiece mode (both modes, each over the claims, every entry
        and a poisoned copy's claims; with ``narrow`` scores also the
        tournament) and K3 with the weights (the winner, a self-merge, an
        inactive step) against their plain versions on one state. ``sf``:
        the weights the run carried, which must equal K4's recount."""
        cap = 8008 if sf is None else sf.shape[0] - 1
        sf_k4 = symbol_freqs(fs, wgt, cap)
        errs["symbol_freqs"] = max(errs["symbol_freqs"], max_err(
            sf_k4, symbol_freqs_ref(fs, wgt, cap)))
        if sf is not None:
            errs["merge_apply_wp"] = max(errs["merge_apply_wp"],
                                         max_err(sf, sf_k4))
        if pair is None:
            pair = TablePair(fs.shape[0], dev)
        tab = pair.pairs(fs, wid, wgt)
        n = len(strings)
        h1, h2, sl, pw1, pw2 = hash_tables(strings, cap, max_len)
        sharp = str_hashes("##")
        recs = []
        redo = torch.zeros(1, dtype=torch.int32, device=dev)
        for host_ids in (False, True):
            for tour in (False, True) if narrow else (False,):
                st = [h1.clone(), h2.clone(), sl.clone(),
                      torch.tensor([n, n, 1], dtype=torch.int32, device=dev)]
                e, rec = check_k2(tab, pair.claims(), st, pw1, pw2, 8000,
                                  host_ids, True, sf_k4, sharp, tour, redo)
                errs["select_unify_wp"] = max(errs["select_unify_wp"], e)
                recs.append(rec)
        a, b = recs[0].tolist()[:2]
        self_pair = int(fs[(fs >= 0)].mode().values)
        errs["merge_apply_wp"] = max(errs["merge_apply_wp"], check_k3(
            fs, wid, wgt, (recs[0].tolist(), [self_pair, self_pair, n, 0, 1,
                                              0], [a, b, n, 0, 0, 0]),
            sf_k4))
        return recs[0]

    table_wp = SymbolTable()
    arrays_wp = build_wp_corpus(words, freq, table_wp)
    flat_wp = build_flat(arrays_wp.sym, arrays_wp.freq)
    assert flat_wp[0].shape[0] == F0
    fs, wid, wgt = (torch.from_numpy(x).to(dev) for x in flat_wp)
    check_wp(fs, wid, wgt, table_wp.strings(), max_len)
    # weights scaled into the wide score domain (6,006,645 occurrences
    # times 2^28 + 9871 is about 2^50.5; fa * fb passes 2^53)
    wide_scale = (1 << 28) + 9871
    check_wp(fs, wid, wgt * wide_scale, table_wp.strings(), max_len,
             narrow=False)
    sf_wide = symbol_freqs(fs, wgt * wide_scale, 8008)
    assert int(sf_wide.max()) ** 2 >= 1 << 53
    # the state after 1,000 merges, from the kernel path, with the
    # weights it carried
    state = train_loop.FlatState(*flat_wp, dev)
    t1000 = SymbolTable(table_wp.strings())
    train_loop.run_fused(state, t1000, len(table_wp) + 1000, max_len,
                         lambda *m: None, wordpiece=True)
    assert len(t1000) == len(table_wp) + 1000, len(t1000)
    check_wp(*state.arrays(), t1000.strings(), max_len, state.sym_freq,
             state._tables)
    F_wp1000 = state.F
    # K2's WordPiece mode and K3 with weights at the shrunk width: the BPE
    # state after 1,000 merges (F = F0 / 2), its tables the loop's
    check_wp(*bpe_shrunk[0].arrays(), bpe_shrunk[1].strings(), max_len,
             pair=bpe_shrunk[0]._tables)
    n_wp_cases = 4
    # a near tie: c1/(A q) and c2/(A p) with c1 p - c2 q = 1, a relative
    # gap of about 2^-51; the larger double wins, and on a tie the first
    # position
    q, p = (1 << 26) - 1, (1 << 26) - 3
    c1 = (1 << 25) - 1
    c2 = (c1 * p - 1) // q
    A = (1 << 20) + 7
    sf_b = torch.tensor([1, A, p, q, 1], dtype=torch.int64, device=dev)
    s1, s2 = c1 / (A * q), c2 / (A * p)
    assert s1 != s2
    for pos1, pos2 in ((5, 9), (9, 5)):
        tab = (torch.tensor([(1 << 32) | 3, EMPTY_KEY, (1 << 32) | 2,
                             EMPTY_KEY], dtype=torch.int64, device=dev),
               torch.tensor([c1, 0, c2, 0], dtype=torch.int64, device=dev),
               torch.tensor([pos1, 0, pos2, 0], dtype=torch.int32,
                            device=dev))
        z = torch.zeros(1, dtype=torch.int64, device=dev)
        rec = torch.zeros(6, dtype=torch.int32, device=dev)
        rec_r = rec.clone()
        args = (z, z, z, torch.zeros(3, dtype=torch.int32, device=dev), z,
                z, 0)
        select_unify(*tab, *args, rec, True, True, sf_b)
        select_unify_ref(*tab, *args, rec_r, True, True, sf_b)
        errs["select_unify_wp"] = max(errs["select_unify_wp"],
                                      max_err(rec, rec_r))
        want_b = 3 if (s1 > s2 or (s1 == s2 and pos1 < pos2)) else 2
        assert rec.tolist()[:2] == [1, want_b], rec.tolist()
        n_wp_cases += 1
    if any(errs[k] for k in wp_kernels):
        raise AssertionError(f"a WordPiece kernel differs: {errs}")

    # times at the initial state
    cap = 8008
    sf0 = symbol_freqs(fs, wgt, cap)
    k2_pair = TablePair(F0, dev)
    tab = k2_pair.pairs(fs, wid, wgt)
    claims0 = k2_pair.claims()
    tab_ref = pair_stats_ref(fs, wid, wgt)
    h1, h2, sl, ctrl, pw1, pw2, sharp = init_tables(table_wp, 8000, max_len,
                                                    dev)
    rec = torch.zeros(6, dtype=torch.int32, device=dev)
    select_unify(*tab, h1, h2, sl, ctrl, pw1, pw2, 8000, rec, False, True,
                 sf0, sharp)
    out = tuple(torch.empty_like(x) for x in (fs, wid, wgt))
    k3_scratch_wp = MergeScratch(F0, dev)
    sf_t = sf0.clone()
    sc = tuple(x[:F0].clone() for x in (c_d, fa_d, fb_d))
    sc_narrow = tuple(torch.from_numpy(x).to(dev) for x in (
        rng.integers(1, 1 << 20, size=F0), rng.integers(1, 1 << 26, size=F0),
        rng.integers(1, 1 << 26, size=F0)))
    sf_out = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    timing["symbol_freqs"] = (  # one output added into again: same work
        cuda_ms(lambda: symbol_freqs(fs, wgt, cap, sf_out), 200, True),
        cuda_ms(lambda: symbol_freqs_ref(fs, wgt, cap), 10))
    timing["wp_score"] = (
        cuda_ms(lambda: score_bits(*sc_narrow), 200, True),
        cuda_ms(lambda: score_bits_ref(*sc_narrow), 10))
    timing["wp_score_mixed"] = (
        cuda_ms(lambda: score_bits(*sc), 200, True),
        cuda_ms(lambda: score_bits_ref(*sc), 1))
    timing["select_unify_wp"] = (
        cuda_ms(lambda: select_unify(*tab, h1, h2, sl, ctrl, pw1, pw2, 8000,
                                     rec, False, True, sf0, sharp,
                                     claims=claims0, scratch=k2_scratch),
                200, True),
        cuda_ms(lambda: select_unify_ref(*tab_ref, h1, h2, sl, ctrl, pw1,
                                         pw2, 8000, rec, False, True, sf0,
                                         sharp), 10))
    timing["select_unify_wp_dense"] = (
        cuda_ms(lambda: select_unify(*tab, h1, h2, sl, ctrl, pw1, pw2, 8000,
                                     rec, False, True, sf0, sharp,
                                     scratch=k2_scratch), 200, True), None)
    timing["merge_apply_wp"] = (
        cuda_ms(lambda: merge_apply(fs, wid, wgt, rec, out=out,
                                    sym_freq=sf_t, scratch=k3_scratch_wp),
                200, True),
        cuda_ms(lambda: merge_apply_ref(fs, wid, wgt, rec, sym_freq=sf_t),
                10))
    # One PyTorch call computes K4's function: index_add_ of the weights
    # at the symbol ids (padding slots sent to the trash bucket first).
    sf_index = torch.where(fs >= 0, fs, cap).to(torch.int64)
    library["symbol_freqs"] = cuda_ms(
        lambda: torch.zeros(cap + 1, dtype=torch.int64,
                            device=dev).index_add_(0, sf_index, wgt), 200,
        True)
    assert max_err(torch.zeros(cap + 1, dtype=torch.int64, device=dev)
                   .index_add_(0, sf_index, wgt), sf0) == 0
    # Operations, counted low: an add per slot (2); one correctly
    # rounded division per score (20); K2's and K3's as in phase 5, K2's
    # bytes with two gathered weights a live entry (16) more.
    n_pairs_wp = int(tab_ref[0].shape[0])
    n_sym_wp = int(ctrl[0])
    bounds["symbol_freqs"] = bound(nbytes(fs, wgt, sf0), 2 * F0)
    bounds["wp_score"] = bound(nbytes(*sc_narrow) + 8 * F0, 20 * F0)
    bounds["select_unify_wp"] = bound(
        40 * n_pairs_wp + 8 * n_sym_wp + nbytes(ctrl, rec),
        (4 + 20) * n_pairs_wp)
    bounds["select_unify_wp_dense"] = bound(
        nbytes(*tab, ctrl, rec) + 16 * n_pairs_wp + 8 * n_sym_wp,
        (4 + 20) * n_pairs_wp)
    bounds["merge_apply_wp"] = bound(
        2 * nbytes(fs, wid, wgt) + nbytes(rec, sf_t), 6 * F0)
    torch.cuda.synchronize()
    print(f"phase 7: WordPiece kernels equal their plain versions exactly: "
          f"the scorer on {n_score} cases ({n_wide} wide, d up to 2^104), "
          f"K4, K2's WordPiece mode (exact and tournament, each over the "
          f"claims of the loop's tables, every entry and a poisoned copy's "
          f"claims) and K3 with the weights on {n_wp_cases} states (the 85k "
          f"initial state, its weights times 2^28 + 9871, after 1,000 "
          f"merges at F = {F_wp1000}, the BPE state shrunk to F = "
          f"{bpe_shrunk[0].F}, a near tie of gap 2^-51 in both orders); K2 "
          f"checks in phases 5 and 7 over the claims "
          f"{k2_checks['claims']}, every entry "
          f"{k2_checks['dense']}, poisoned {k2_checks['poisoned']} (the "
          f"poison won each of {k2_checks['poison_read']} dense reads); at "
          f"{n_slots} slots (F = {F0}, {n_pairs_wp} pairs): " + ", ".join(
              f"{k} {timing[k][0]:.4f} ms (plain {timing[k][1]:.3f} ms, "
              f"bound {bounds[k][0]:.5f})"
              for k in ("symbol_freqs", "select_unify_wp",
                        "merge_apply_wp"))
          + f", select_unify_wp over every entry "
            f"{timing['select_unify_wp_dense'][0]:.4f} ms"
          + f"; scorer on {F0} narrow cases {timing['wp_score'][0]:.3f} ms "
          f"(plain {timing['wp_score'][1]:.3f} ms), on {F0} of the mixed "
          f"cases {timing['wp_score_mixed'][0]:.3f} ms (plain "
          f"{timing['wp_score_mixed'][1]:.3f} ms); {smi}")

    # ---- phase 8: the WordPiece training path, the whole corpus to 8,000
    with open(os.path.join(golden_dir, "port_t85k_v8000_wp_vocab.json"),
              encoding="utf-8") as f:
        golden_wp = json.load(f)
    wp_merges = [tuple(m) for m in golden_wp["merges"]]
    wp_vocab = golden_wp["vocab"]
    n_alpha = len(wp_vocab) - len(wp_merges)
    assert n_alpha == len(table_wp), (n_alpha, len(table_wp))

    def check_wp_train(tok, what, n_merges=None):
        want = wp_merges[:n_merges]
        if tok._merge_log != want or (n_merges is None and sorted(
                tok.vocab) != wp_vocab):
            bad = next((i for i, (g, w) in enumerate(
                zip(tok._merge_log, want)) if g != w),
                min(len(tok._merge_log), len(want)))
            raise AssertionError(
                f"{what}: {len(tok._merge_log)} merges, first difference "
                f"from the JAX golden at merge {bad}")
        rebuilt = [syms[0] + "".join(s[2:] for s in syms[1:])
                   for syms, _ in tok.corpus_as_symbols]
        if rebuilt != words or [f for _, f in tok.corpus_as_symbols] != \
                freq.tolist():
            raise AssertionError(f"{what}: corpus_as_symbols is wrong")

    states = []
    real_state = train_loop.FlatState

    class KeptState(real_state):
        """FlatState that keeps each instance, to read the carried
        weights after a run."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            states.append(self)

    wp_counters = {"pair_stats": "launch.pair_stats",
                   "select_unify": "launch.select_unify.wp",
                   "merge_apply": "launch.merge_apply.wp",
                   "symbol_freqs": "launch.symbol_freqs",
                   "select_unify_all": "launch.select_unify"}
    base8 = {k: counter(n) for k, n in wp_counters.items()}
    g8 = graph_counts()
    # run 0 is cold (the process's first WordPiece training), runs 1-2
    # warm, run 3 warm with the phase profiler on
    wp_walls = []
    try:
        train_loop.FlatState = KeptState
        for run in range(4):
            profiling.enable(run == 3)
            reset_spans()
            tok = NaiveWP(device=dev)
            t0 = time.perf_counter()
            tok.train(corpus, 8000)
            torch.cuda.synchronize()
            wp_walls.append(time.perf_counter() - t0)
            check_wp_train(tok, f"WordPiece run {run}")
    finally:
        train_loop.FlatState = real_state
    wp_phase_ms = span_ms(profiling.report())
    profiling.enable(False)
    wp_launches = {k: counter(n) - base8[k] for k, n in wp_counters.items()}
    all_k2 = wp_launches.pop("select_unify_all")
    if not all(wp_launches.values()) or \
            all_k2 != wp_launches["select_unify"]:
        raise AssertionError(f"a WordPiece kernel was not launched: "
                             f"{wp_launches}")
    blocks8, graphs8 = graph_check(g8, 4, "phase 8")
    if wp_launches != {"pair_stats": 256 * blocks8,
                       "select_unify": 256 * blocks8,
                       "merge_apply": 256 * blocks8, "symbol_freqs": 4}:
        raise AssertionError(f"phase 8: launches {wp_launches} for "
                             f"{blocks8} blocks of 256 steps in 4 runs")
    st = states[-1]
    fs_end, _, wgt_end = st.arrays()
    cap = st.sym_freq.shape[0] - 1
    recount = symbol_freqs(fs_end, wgt_end, cap)
    errs["merge_apply_wp"] = max(errs["merge_apply_wp"], max_err(
        st.sym_freq, recount), max_err(st.sym_freq, symbol_freqs_ref(
            fs_end, wgt_end, cap)))
    if errs["merge_apply_wp"]:
        raise AssertionError("the carried weights differ from a recount")
    print(f"phase 8: NaiveWP(device='cuda').train of all {len(corpus)} "
          f"sentences ({len(words)} word types, {n_slots} slots, "
          f"{len(table_wp)} initial symbols) to 8000: {len(wp_merges)} "
          f"merges and the vocab equal the JAX golden, corpus_as_symbols "
          f"rebuilds the words, the carried weights equal a recount; "
          f"{graphs8}; launches (256 a block, K4 one a run) {wp_launches}; "
          f"cold {wp_walls[0]:.3f} s, warm "
          f"{wp_walls[1]:.3f} / {wp_walls[2]:.3f} s; profiled "
          f"{wp_walls[3]:.3f} s, phases (ms) {json.dumps(wp_phase_ms)}; "
          f"{smi}")

    fn, marks = traced_train(lambda: NaiveWP(device=dev).train(corpus,
                                                               8000))
    with tempfile.TemporaryDirectory() as d:
        wall, busy, by_name = device_trace(
            fn, os.path.join(d, "wp_train_trace.json"), warmup=True)
    before, g8c = marks[-1]
    blocks8c, graphs8c = graph_check(g8c, 1, "phase 8c")
    traced8 = traced_launches(by_name, before, dict.fromkeys(
        ("pair_stats", "select_unify", "merge_apply"), 256), blocks8c,
        "phase 8c")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    dev_line = (f"device busy {busy:.3f} ms of {wall:.1f} ms "
                f"(idle share {1 - busy / wall:.4f}); "
                + "; ".join(f"{n} x{c} {ms:.3f} ms" for n, (c, ms) in top)
                + "; " + trace_graph_line(by_name))
    print(f"phase 8c: one warm WordPiece train under torch.profiler: "
          f"{graphs8c}; kernel spans in the trace {traced8}, equal to the "
          f"launches the counters counted in this train and to 256 a "
          f"block; {dev_line}; {smi}")

    # ---- phase 8b: the other WordPiece routes
    g8b = graph_counts()
    with tempfile.TemporaryDirectory() as d:
        part = NaiveWP(device=dev)
        part.train(corpus, n_alpha + 1400, checkpoint_dir=d,
                   checkpoint_every=500)
        check_wp_train(part, "checkpointed run", 1400)
        resumed = NaiveWP(device=dev)
        resumed.train(corpus, 8000, checkpoint_dir=d, resume=True)
        check_wp_train(resumed, "resumed run")
    per_step = NaiveWP(device=dev)
    per_step._force_per_step = True
    per_step.train(corpus, n_alpha + 1000)
    check_wp_train(per_step, "per-step run", 1000)
    small = corpus[:500]
    plain = NaiveWP(device=dev)
    plain.train(small, 300)
    real_hashes, real_run = train_loop.str_hashes, train_loop.run_fused
    raised = []

    def spy(*args, **kwargs):
        try:
            return real_run(*args, **kwargs)
        except train_loop.HashCollision as e:
            raised.append(e)
            raise

    try:
        train_loop.str_hashes = lambda s: (0, 0)
        train_loop.run_fused = spy
        forced = NaiveWP(device=dev)
        forced.train(small, 300)
    finally:
        train_loop.str_hashes, train_loop.run_fused = real_hashes, real_run
    assert len(raised) == 1, "the forced collision did not fall back"
    assert (forced._merge_log, forced.vocab, forced.corpus_as_symbols) == \
        (plain._merge_log, plain.vocab, plain.corpus_as_symbols)
    fast = FastWP(device=dev)
    fast.train(corpus, 8000)
    check_wp_train(fast, "FastWP run")
    # run_fused five times: checkpointed, resumed, plain, raised, FastWP
    _, graphs8b = graph_check(g8b, 5, "phase 8b")
    loaded = FastWP(device=dev)
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(wp_vocab, f, ensure_ascii=False)
        loaded.load_resources(d, strict=True)
    encoded = fast.tokenize_batch(corpus)
    if digest(encoded) != digest(loaded.tokenize_batch(corpus)):
        raise AssertionError("FastWP after train encodes differently from "
                             "the golden vocab")
    print(f"phase 8b: a checkpoint at 1400 merges resumed to 8000 equals "
          f"the golden; the per-step path to 1000 merges equals its "
          f"prefix; a forced hash collision on 500 sentences fell back and "
          f"equals the fused run ({len(plain._merge_log)} merges); "
          f"FastWP.train then tokenize_batch ({sum(map(len, encoded))} "
          f"tokens) equals a FastWP loading the golden vocab; {graphs8b}")

    # ---- phase 9: the encode kernels against their plain versions
    from subword_tokenizers_tpu_torch import FastBPE
    from subword_tokenizers_tpu_torch.models.trie import MatchTrie
    from subword_tokenizers_tpu_torch.ops.bpe_encode import (
        bpe_encode, bpe_encode_ref, bpe_encode_trips, build_rank_hash)
    from subword_tokenizers_tpu_torch.ops.wp_encode import (
        match_jumps, match_params, match_records, wp_match_compact,
        wp_match_compact_ref, wp_match_encode, wp_match_encode_ref,
        wp_match_steps)
    errs.update(bpe_encode=0, wp_match_encode=0, wp_match_compact=0)
    flags9 = np.zeros(4, dtype=np.int64)  # rows: merged, unk, ovf, empty
    n_bpe9 = n_wp9 = 0

    def check_bpe9(sym, hk, hr, ho, max_probe):
        nonlocal n_bpe9
        for monotone in (True, False):
            got = bpe_encode(sym, hk, hr, ho, monotone, max_probe)
            want = bpe_encode_ref(sym, hk, hr, ho, monotone, max_probe)
            errs["bpe_encode"] = max(errs["bpe_encode"], err_all(got, want))
            flags9[0] += int((got[1] < (sym >= 0).sum(1)).sum())
            n_bpe9 += 1

    def check_wp9(words9, wlen9, trie):
        """Kernel 6's rows form and fused form against their plain
        versions on one batch, the step records and '#' jumps built on
        the card."""
        nonlocal n_wp9
        goto9, acc9 = (torch.from_numpy(a).to(dev)
                       for a in (trie.goto, trie.accept))
        hash9 = int(trie.alpha[ord("#")])
        args = (words9, wlen9, goto9, acc9, hash9)
        tables9 = dict(rec=match_records(goto9, acc9),
                       jumps=match_jumps(goto9, acc9, hash9))
        got = wp_match_encode(*args, **tables9)
        want = wp_match_encode_ref(*args)
        errs["wp_match_encode"] = max(errs["wp_match_encode"],
                                      err_all(got, want))
        ids9, head9 = wp_match_compact(*args, **tables9)
        ids_r, head_r = wp_match_compact_ref(*args)
        cap9 = match_params(words9.shape[1])[0]
        errs["wp_match_compact"] = max(
            errs["wp_match_compact"], max_err(head9, head_r),
            max_err(emitted(ids9, head9, want[1], cap9),
                    emitted(ids_r, head_r, want[1], cap9)))
        flags9[1:] += [int(want[2].sum()), int(want[3].sum()),
                       int((wlen9 == 0).sum())]
        n_wp9 += 1
        return got

    def match_trie(vocab):
        out_t = SymbolTable()
        out_t.intern("[UNK]")
        return MatchTrie.build(sorted(vocab), out_t)

    # every path of K5: the row in registers (1, 2 and 4 columns a
    # lane), in shared memory (up to 12,288 columns) and in place in the
    # output (wider); and long self-pair runs
    widths9, bad9 = [], 0
    for W9, L9, n_sym9, n_m9 in [(4000, 12, 5, 30), (3000, 33, 4, 60),
                                 (512, 1, 3, 4), (4000, 24, 9, 200),
                                 (2000, 2, 3, 6), (2000, 31, 4, 40),
                                 (2000, 32, 4, 40), (1500, 64, 3, 40),
                                 (1500, 65, 3, 40), (800, 128, 3, 30),
                                 (400, 129, 3, 30), (64, 2000, 2, 12),
                                 (8, 13000, 2, 8)]:
        sym9, ent9 = bpe_random_case(rng, W9, L9, n_sym9, n_m9)
        hk9, hr9, ho9, mp9 = build_rank_hash(ent9)
        args9 = [torch.from_numpy(a).to(dev) for a in (sym9, hk9, hr9, ho9)]
        check_bpe9(*args9, mp9)
        widths9.append(L9)
        # the kernel's own layout check: an id below -1, a PAD before an
        # id in one chunk of 32 and across chunks; each call raises, and
        # the next good call is exact again
        lens9 = (sym9 >= 0).sum(1)
        full9 = int(np.argmax(lens9))
        bads = [(L9 // 2, L9 // 2 + 1, -2), (0, 1, -1)]
        if L9 > 33:
            bads.append((10, 32, -1))  # the rest of chunk 0, ids after
        for c9, e9, v9 in bads:
            if lens9[full9] < 2:
                break
            bad = args9[0].clone()
            bad[full9, c9:e9] = v9
            try:
                bpe_encode(bad, *args9[1:], bool(c9 % 2), mp9)
            except ValueError as e:
                assert "PAD before an id" in str(e), e
                bad9 += 1
            else:
                raise AssertionError(f"K5 took a bad row at L = {L9}: "
                                     f"columns {c9}:{e9} set to {v9}")
            check_bpe9(*args9, mp9)
    for W9, L9 in [(3000, 40), (2000, 70), (500, 130), (100, 1000)]:
        sym9, ent9 = self_pair_case(rng, W9, L9)
        hk9, hr9, ho9, mp9 = build_rank_hash(ent9)
        check_bpe9(*(torch.from_numpy(a).to(dev)
                     for a in (sym9, hk9, hr9, ho9)), mp9)
        widths9.append(L9)
    def wp_rows9(trie, words_r, L):
        return (torch.from_numpy(a).to(dev) for a in match_rows(
            trie.alpha, trie.n_alpha, words_r, L))

    for alpha9, n_tok9, L9 in [("abc", 12, 8), ("abcd", 40, 16),
                               ("ab#", 15, 9), ("a#", 6, 33),
                               ("abcdefgh", 120, 24)]:
        vocab9, words_r = wp_random_case(rng, 3000, L9, alpha9, n_tok9)
        trie9 = match_trie(vocab9)
        check_wp9(*wp_rows9(trie9, words_r, L9), trie9)
    # kernel 6's tiles of 128 words: batches at their edges; words staged
    # 96 and 32 a block, and words too wide to stage in shared memory
    vocab9, words_r = wp_random_case(rng, 3 * 128 + 7, 12, "abcd", 30)
    trie9 = match_trie(vocab9)
    for W9 in (1, 127, 128, 129, 257, 3 * 128 + 7):
        check_wp9(*wp_rows9(trie9, words_r[:W9], 16), trie9)
    stage9 = {}
    for W9, L9 in ((300, 200), (100, 700), (64, 1000)):
        vocab9, words_r = wp_random_case(rng, W9, L9, "abcd", 40)
        words_r[0] = "abcd" * (L9 // 4)
        trie9 = match_trie(vocab9)
        stage9[L9] = tile_layout(L9, L9 + 4, 4)[0]
        check_wp9(*wp_rows9(trie9, words_r, L9), trie9)
    assert list(stage9.values()) == [96, 32, 0], stage9
    # words that run to the step cap: "#" and "##" without "##a" restart
    # a word from "a" forever in cycles of three steps, two of them the
    # '#' jump, so the cap falls inside the jump for some words
    trie9 = match_trie({"a", "b", "#", "##", "ab"})
    words_r = ["".join(rng.choice(list("ab"), size=int(n)))
               for n in rng.integers(0, 9, size=3000)]
    w9, l9 = wp_rows9(trie9, words_r, 8)
    check_wp9(w9, l9, trie9)
    cap_steps9, _ = wp_match_steps(
        w9, l9, *(torch.from_numpy(a).to(dev)
                  for a in (trie9.goto, trie9.accept)),
        int(trie9.alpha[ord("#")]))
    n_capped9 = int((cap_steps9 == match_params(8)[1]).sum())
    assert 0 < n_capped9 < 3000, n_capped9
    # '#' without '##': the word ends exactly at the cap of 16 pending
    # '#' with a token of 16 '#', and overflows with 17; "q" is [UNK]
    for tail in (16, 17):
        trie9 = match_trie({"a", "#", "#" * tail + "b"})
        got9 = check_wp9(*(torch.from_numpy(a).to(dev) for a in match_rows(
            trie9.alpha, trie9.n_alpha, ["ab", "q"], 16)), trie9)
        assert got9[3].tolist() == [tail == 17, False], got9[3]
        assert got9[2].tolist() == [False, True], got9[2]

    # the main path's shapes: the corpus's word types
    lists = merge_lists()
    enc = {}
    for order in ("golden", "shuffled"):
        tok9 = load(NaiveBPE(device=dev), "merges.json", lists[order])
        st9 = tok9._device_tables()
        sym_w = torch.from_numpy(tok9._encode_inputs(words, st9.table)).to(
            dev)
        check_bpe9(sym_w, st9.hkeys, st9.hrank, st9.hout, st9.max_probe)
        enc[order] = (sym_w, st9)
    wp_tok = load(NaiveWP(device=dev), "vocab.json", wp_vocab)
    trie_w, _, wmat_w, wlen_w = wp_tok._match_inputs(words)
    wmat_w, wlen_w = (torch.from_numpy(a).to(dev) for a in (wmat_w, wlen_w))
    got_w = check_wp9(wmat_w, wlen_w, trie_w)
    if errs["bpe_encode"] or errs["wp_match_encode"] or \
            errs["wp_match_compact"]:
        raise AssertionError(f"an encode kernel differs: {errs}")
    if not flags9.all():
        raise AssertionError(f"phase 9 left a case unmet: {flags9}")

    sym_w, st9 = enc["golden"]
    W_w, L_w = sym_w.shape
    bpe_args = (sym_w, st9.hkeys, st9.hrank, st9.hout)
    mst = wp_tok._match_device()
    wp_args = (wmat_w, wlen_w, mst.goto, mst.accept, mst.hash_aid)
    wp_tables = dict(rec=mst.rec, jumps=mst.jumps)
    k5_out = (torch.empty_like(sym_w),
              torch.empty(W_w, dtype=torch.int32, device=dev))
    k5_flag = torch.zeros(1, dtype=torch.int32, device=dev)

    def k5_alone(monotone):
        # K5 as the wrapper launches it, without the wrapper's read-back
        # of the layout flag (the rows are good, so the flag stays 0)
        _cuda.launch("swt_bpe_encode", sym_w.data_ptr(), W_w, L_w,
                     st9.hkeys.data_ptr(), st9.hrank.data_ptr(),
                     st9.hout.data_ptr(), st9.hkeys.shape[0], int(monotone),
                     st9.max_probe, k5_out[0].data_ptr(),
                     k5_out[1].data_ptr(), k5_flag.data_ptr(), 1)

    trips9 = {}
    for monotone, key in ((True, "bpe_encode"), (False, "bpe_encode_greedy")):
        k5_alone(monotone)
        if err_all(k5_out, bpe_encode(*bpe_args, monotone, st9.max_probe)) \
                or int(k5_flag.item()):
            raise AssertionError("K5 launched alone differs from its wrapper")
        # each word's trips: the slowest word's are the chain of dependent
        # probes that bounds the kernel by latency, their sum the warps'
        # work
        t9 = bpe_encode_trips(*bpe_args, monotone, st9.max_probe)
        trips9[key] = {"max": int(t9.max()), "total": int(t9.sum())}
        timing[key] = (
            cuda_ms(lambda: k5_alone(monotone), 100, True),
            cuda_ms(lambda: bpe_encode_ref(*bpe_args, monotone,
                                           st9.max_probe), 3),
            cuda_ms(lambda: bpe_encode(*bpe_args, monotone, st9.max_probe),
                    20))
    timing["wp_match_encode"] = (
        cuda_ms(lambda: wp_match_encode(*wp_args, **wp_tables), 100, True),
        cuda_ms(lambda: wp_match_encode_ref(*wp_args), 3))
    timing["wp_match_compact"] = (
        cuda_ms(lambda: wp_match_compact(*wp_args, **wp_tables), 100, True),
        cuda_ms(lambda: wp_match_compact_ref(*wp_args), 3))
    # each word's steps as the JAX program counts them, and those the
    # '#' jumps take in one move: the slowest word's other steps are the
    # kernel's chain of dependent gathers
    steps_w, hashed_w = wp_match_steps(*wp_args)
    walk_w = steps_w - hashed_w
    steps9 = {"max": int(steps_w.max()), "total": int(steps_w.sum()),
              "walk_max": int(walk_w.max()), "walk_total": int(walk_w.sum())}
    # the slowest word alone, one block: its chain of dependent gathers
    # through the records as they sit in the caches, the launch hidden
    slow9 = int(walk_w.argmax())
    slow_args = (wmat_w[slow9:slow9 + 1], wlen_w[slow9:slow9 + 1],
                 *wp_args[2:])
    timing["wp_match_slowest"] = cuda_ms(
        lambda: wp_match_compact(*slow_args, **wp_tables), 100, True)
    # Operations, counted low: a probe of 8 integer operations per pair a
    # word starts with and two per merge after (each merge removes a
    # symbol); a trie step of 4 per character. Bytes, of the tables: a
    # hash key per probe; a goto and an accept entry per character.
    merged_w, out_n_w = bpe_encode(*bpe_args, True, st9.max_probe)
    wl = (sym_w >= 0).sum(1)
    n_probes = int((wl - 1).clamp(min=0).sum() + 2 * (wl - out_n_w).sum())
    bounds["bpe_encode"] = bound(
        nbytes(sym_w, merged_w, out_n_w) + visited(n_probes, 8, st9.hkeys),
        8 * n_probes)
    n_chars = int(wlen_w.sum())
    bounds["wp_match_encode"] = bound(
        nbytes(wmat_w, wlen_w, *got_w) + visited(n_chars, 8, mst.rec),
        4 * n_chars)
    total_w = int(got_w[1].sum())
    bounds["wp_match_compact"] = bound(
        nbytes(wmat_w, wlen_w) + visited(n_chars, 8, mst.rec) + 4 * total_w
        + 4 * (2 * W_w + 1), 4 * n_chars + 2 * (W_w + total_w))
    torch.cuda.synchronize()
    print(f"phase 9: encode kernels equal their plain versions exactly: "
          f"the BPE merge loop on {n_bpe9} cases (greedy and monotone: "
          f"random rows and self-pair runs at widths {widths9}, each "
          f"random width again after each of {bad9} bad layouts the kernel "
          f"refused, the {W_w} word types with the trained and the "
          f"shuffled merges; the word types' trips, the slowest word's and "
          f"in all, {trips9}), the WordPiece match, rows and fused forms, "
          f"on {n_wp9} cases (5 random vocabs, the '#' cap at 16 and 17, "
          f"batches of 1-391 words across the tiles' edges, words staged "
          f"a block by width {stage9}, {n_capped9} of 3000 words at the "
          f"step cap, the word types with the trained vocab); rows "
          f"merged/unk/ovf/empty {flags9.tolist()}; at "
          f"{W_w} x {L_w}: bpe_encode monotone "
          f"{timing['bpe_encode'][0]:.4f} ms (plain "
          f"{timing['bpe_encode'][1]:.3f}, the wrapper with its layout "
          f"flag's read-back {timing['bpe_encode'][2]:.4f}), greedy "
          f"{timing['bpe_encode_greedy'][0]:.4f} ms (plain "
          f"{timing['bpe_encode_greedy'][1]:.3f}, wrapper "
          f"{timing['bpe_encode_greedy'][2]:.4f}), bound "
          f"{bounds['bpe_encode'][0]:.4f} ms ({bounds['bpe_encode'][1]}); "
          f"wp_match_compact {timing['wp_match_compact'][0]:.4f} ms "
          f"(plain {timing['wp_match_compact'][1]:.3f}), bound "
          f"{bounds['wp_match_compact'][0]:.4f} ms "
          f"({bounds['wp_match_compact'][1]}), the slowest word alone "
          f"{timing['wp_match_slowest']:.4f} ms, the rows form "
          f"wp_match_encode {timing['wp_match_encode'][0]:.4f} ms (plain "
          f"{timing['wp_match_encode'][1]:.3f}), bound "
          f"{bounds['wp_match_encode'][0]:.4f} ms "
          f"({bounds['wp_match_encode'][1]}); the word types' steps "
          f"(slowest word, all words; walk: without the '#' jumps) "
          f"{steps9}; {smi}")

    # ---- phase 10: the encode path, the whole corpus, three encoders
    with open(os.path.join(ROOT, "tests", "golden",
                           "port_t85k_encode_expect.json"),
              encoding="utf-8") as f:
        expect_enc = json.load(f)
    encoders = {
        "FastBPE": load(FastBPE(device=dev), "merges.json",
                        lists["golden"]),
        "NaiveBPE": load(NaiveBPE(device=dev), "merges.json",
                         lists["golden"]),
        "NaiveWP": load(NaiveWP(device=dev), "vocab.json", wp_vocab)}
    enc_lines = []
    enc_kernels = {k: "launch." + k for k in (
        "bpe_encode", "wp_match_encode", "wp_match_compact", "compact_ids")}
    # each call's launches: the BPE encoders' K5 and kernel 2, NaiveWP's
    # fused kernel 6, once each (ENCODE_KERNELS)
    per_call = {name: {k: int(k in own[0]) for k in enc_kernels}
                for name, own in ENCODE_KERNELS.items()}
    enc_launches = {name: dict.fromkeys(per_call[name], 0)
                    for name in encoders}
    for name, tok in encoders.items():
        want = expect_enc[f"{name}_golden"]
        walls = []
        # run 0 is cold (tables built and moved), runs 1-3 warm, run 4
        # warm with the phase profiler on
        for run in range(5):
            profiling.enable(run == 4)
            reset_spans()
            out = None
            before = read_counts(enc_kernels)
            t0 = time.perf_counter()
            out = tok.tokenize_batch(corpus)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts = counts_since(enc_kernels, before)
            if counts != per_call[name]:
                raise AssertionError(f"{name} run {run} launched {counts}, "
                                     f"not {per_call[name]}")
            for k, n in counts.items():
                enc_launches[name][k] += n
            if digest(out) != want["full_sha256"]:
                raise AssertionError(f"{name} run {run}: output differs "
                                     "from the JAX package's")
        phases = span_ms(profiling.report())
        profiling.enable(False)
        n_tok = sum(map(len, out))
        assert n_tok == want["full_tokens"], (name, n_tok)
        enc_lines.append(
            f"{name} {n_tok} tokens: cold {walls[0] * 1e3:.3f} ms, warm "
            f"{[round(w * 1e3, 3) for w in walls[1:4]]} ms (median "
            f"{sorted(walls[1:4])[1] * 1e3:.3f} = "
            f"{n_bytes / sorted(walls[1:4])[1] / 1e6:.3f} MB/s), "
            f"profiled {walls[4] * 1e3:.3f} ms, phases (ms) "
            f"{json.dumps(phases)}")
    out = None
    print(f"phase 10: tokenize_batch of all {len(corpus)} sentences "
          f"({n_bytes} bytes) equals the JAX digests; launches of each "
          f"encoder's five calls, counted per call {enc_launches}; "
          + "; ".join(enc_lines) + f"; {smi}")
    # A short traced call came back without its kernels on the card,
    # even traced alone three times: trace after a warm-up step, and
    # again, up to three times, until the encoder's own kernel is there;
    # a trace without it fails the phase.
    for name, tok in encoders.items():
        own = ENCODE_KERNELS[name][1]
        for attempt in range(1, 4):
            with tempfile.TemporaryDirectory() as d:
                wall, busy, by_name = device_trace(
                    lambda: tok.tokenize_batch(corpus),
                    os.path.join(d, "encode_trace.json"), warmup=True)
            if any(k in n for n in by_name for k in own):
                break
        else:
            raise AssertionError(f"phase 10c: none of three traces of "
                                 f"{name} holds {own}: {by_name}")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        print(f"phase 10c: one warm {name}.tokenize_batch under "
              f"torch.profiler (trace {attempt} of up to 3): device busy "
              f"{busy:.3f} ms of {wall:.1f} ms (idle share "
              f"{1 - busy / wall:.4f}); "
              + "; ".join(f"{n} x{c} {ms:.4f} ms" for n, (c, ms) in top)
              + f"; {smi}")

    # ---- phase 10b: the other encode routes
    for name in ("FastBPE", "NaiveBPE"):
        tok = load(encoders[name].__class__(device=dev), "merges.json",
                   lists["shuffled"])
        out = tok.tokenize_batch(corpus)
        if digest(out) != expect_enc[f"{name}_shuffled"]["full_sha256"]:
            raise AssertionError(f"{name} with the shuffled merges differs "
                                 "from the JAX package's")
    n_small = expect_enc["small_n"]
    dup = load(NaiveBPE(device=dev), "merges.json", lists["duplicated"])
    k5 = counter("launch.bpe_encode")
    out = dup.tokenize_batch(corpus[:n_small])
    assert counter("launch.bpe_encode") == k5, "the host route launched K5"
    if digest(out) != expect_enc["NaiveBPE_duplicated"]["small_sha256"]:
        raise AssertionError("NaiveBPE with a duplicated merge differs")
    small = rng.integers(0, len(corpus), size=64)
    for name, tok in encoders.items():
        streamed = list(tok.tokenize_stream(iter(corpus[:20000]),
                                            batch_sentences=8192))
        assert streamed == tok.tokenize_batch(corpus[:20000]), name
        for n in (1, 7, 64):
            batch = [corpus[i] for i in small[:n]]
            assert tok.tokenize_batch(batch) == \
                [tok.tokenize(s) for s in batch], name
    hang_wp = NaiveWP(device=dev)
    hang_wp.vocab = {"a", "b", "#"}
    try:
        hang_wp.tokenize_batch(["a", "ab"])
    except RuntimeError as e:
        assert "wp_match_encode overflow" in str(e), e
    else:
        raise AssertionError("the WordPiece overflow input did not raise")
    out = None
    print(f"phase 10b: the shuffled merges (FastBPE and NaiveBPE, whole "
          f"corpus) equal the JAX digests; NaiveBPE with a duplicated "
          f"merge on {n_small} sentences took the host route (no K5 "
          f"launch) and equals its digest; tokenize_stream of 20000 "
          f"sentences (blocks of 8192) equals the batch and batches of 1, "
          f"7 and 64 equal the host tokenize, for all three; the "
          f"WordPiece overflow input raised on the card")

    # ---- phase 11: this slice's kernels against their plain versions
    errs11, timing11, bounds11, notes11 = phase11(
        dev, rng, flat0, table, flat_wp, table_wp, arrays.sym, max_len, smi)
    errs.update(errs11)
    timing.update(timing11)
    bounds.update(bounds11)

    # ---- phase 12: the routes of run_fused, the whole corpus to 8,000
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(GOLDEN, "port_t85k_skip_overflows.json"),
                  encoding="utf-8") as f:
            overflows = json.load(f)
        by_route, notes12c = phase12(dev, corpus, check_train,
                                     check_wp_train, smi, d,
                                     overflows=overflows)

    # ---- phase 13: the shard kernels against their plain versions
    with tempfile.TemporaryDirectory() as d:
        errs13, timing13, bounds13, library13, notes13 = phase13(
            dev, rng, arrays, table, arrays_wp, table_wp, golden, wp_merges,
            smi, d)
    errs.update(errs13)
    timing.update(timing13)
    bounds.update(bounds13)
    library.update(library13)
    # ---- phase 13b: the grouped K1 and K3p against their plain versions
    errs13b, timing13b, bounds13b, library13b, notes13b = phase13b(
        dev, rng, arrays, table, golden, smi)
    errs.update(errs13b)
    timing.update(timing13b)
    bounds.update(bounds13b)
    library.update(library13b)
    # ---- phase 13c: K4 grouped and flat, the single-device K1, the scorer
    with tempfile.TemporaryDirectory() as d:
        errs13c, timing13c, bounds13c, library13c, notes13c = phase13c(
            dev, rng, flat0, table, arrays, arrays_wp, table_wp, max_len,
            smi, d)
    errs.update(errs13c)
    timing.update(timing13c)
    bounds.update(bounds13c)
    library.update(library13c)

    # ---- phase 14: the sharded main path, an 8-shard mesh on the card
    with tempfile.TemporaryDirectory() as d:
        by_mesh = phase14(dev, corpus, check_train, check_wp_train, lists,
                          wp_merges, wp_vocab, expect, expect_enc, smi, d)
    # ---- phase 14e: captured tiers replayed from copies of one state
    phase14e(dev, arrays, table, golden, smi)

    # ---- phase 15: torch.distributed, NCCL at world size 1
    with tempfile.TemporaryDirectory() as d:
        by_group = phase15(dev, corpus, anchor,
                           {"NaiveBPE": check_train,
                            "NaiveWP": check_wp_train},
                           arrays, table, golden, smi, d)

    # ---- phase 16: the gather probe (the TPU probe's port)
    (errs16, timing16, bounds16, library16, probe_launches,
     notes16) = phase16(dev, scan_args, params, smi)
    gather_ms = notes16["per_iter_ms"]["gather_loop"]
    print(f"phase 16b: kernel 6's latency bound at the gather_loop rate "
          f"({gather_ms * 1e6:.2f} ns a dependent gather): the slowest "
          f"word's {steps9['walk_max']} steps besides its '#' jumps, "
          f"{steps9['walk_max'] * gather_ms * 1e3:.3f} us ({steps9['max']} "
          f"steps with them, {steps9['max'] * gather_ms * 1e3:.3f} us), "
          f"against the fused launch's "
          f"{timing['wp_match_compact'][0] * 1e3:.3f} us and the slowest "
          f"word's alone {timing['wp_match_slowest'] * 1e3:.3f} us; {smi}")
    errs.update(errs16)
    timing.update(timing16)
    bounds.update(bounds16)
    library.update(library16)

    # ---- phase 17: the CLI at full width
    want_sha = {
        "NaiveBPE": expect_enc["NaiveBPE_golden"]["full_sha256"],
        "FastBPE": expect_enc["FastBPE_golden"]["full_sha256"],
        "NaiveWordPiece": expect_enc["NaiveWP_golden"]["full_sha256"],
        "FastWordPiece": expect["full_sha256"]}
    with open(os.path.join(GOLDEN, "port_t85k_fastwp_vocab.json"),
              encoding="utf-8") as f:
        fast_vocab = json.load(f)
    by_cli = phase17(dev, corpus, golden, wp_vocab, want_sha, fast_vocab,
                     smi)

    # the main path's launches (phase 3); the rows form's and kernel 2's
    # on FastWP's whole-sentence route (phase 3d)
    launches.update(wp_e2e_scan=ws_launches["wp_e2e_scan"],
                    compact_ids=ws_launches["compact_ids"])
    k1_latency = notes16["k1_steps"] * notes16["per_iter_ms"]["gather_loop"]
    record = {"kernels": [
        {"name": "wp_e2e_scan_compact", "route": "cuda",
         "source": "subword_tokenizers_tpu_torch/csrc/wp_e2e_scan.cu",
         "replaces": "subword_tokenizers_tpu/ops/wp_encode_e2e.py:236",
         "launches": launches["wp_e2e_scan_compact"],
         "max_abs_err": errs["wp_e2e_scan_compact"],
         "ms": timing["wp_e2e_scan_compact"][0],
         "plain_ms": timing["wp_e2e_scan_compact"][1],
         "latency_bound_ms": k1_latency,
         "latency_note": "the slowest row's steps x one dependent gather "
                         "through L1/L2 (phase 16's gather_loop, per "
                         "iteration)",
         "note": "kernel 1's walk with kernel 2's tile epilogue in one "
                 "launch (swt_wp_e2e_scan_compact_u16)"},
        {"name": "wp_e2e_scan", "route": "cuda",
         "source": "subword_tokenizers_tpu_torch/csrc/wp_e2e_scan.cu",
         "replaces": "subword_tokenizers_tpu/ops/wp_encode_e2e.py:109",
         "launches": launches["wp_e2e_scan"],
         "max_abs_err": errs["wp_e2e_scan"],
         "ms": timing["wp_e2e_scan"][0],
         "plain_ms": timing["wp_e2e_scan"][1],
         "latency_bound_ms": k1_latency,
         "note": "the rows form; launches: FastWP's whole-sentence route "
                 "(phase 3d), as the main path makes none"},
        {"name": "compact_ids", "route": "cuda",
         "source": "subword_tokenizers_tpu_torch/csrc/compact.cu",
         "replaces": "subword_tokenizers_tpu/ops/fetch.py:31",
         "launches": launches["compact_ids"],
         "max_abs_err": errs["compact_ids"],
         "ms": timing["compact_ids"][0],
         "plain_ms": timing["compact_ids"][1],
         "library_note": "masked_select over the rows' emitted prefixes: "
                         "the stream alone, no offsets, total or flags"},
    ] + [
        {"name": k, "route": "cuda",
         "source": f"subword_tokenizers_tpu_torch/csrc/{k}.cu",
         "replaces": replaces, "launches": launches[k],
         "max_abs_err": errs[k], "ms": timing[k][0],
         "plain_ms": timing[k][1]}
        for k, replaces in (
            ("pair_stats", "subword_tokenizers_tpu/ops/flat.py:65"),
            ("select_unify", "subword_tokenizers_tpu/ops/train_loop.py:68"),
            ("merge_apply", "subword_tokenizers_tpu/ops/flat.py:204"))]}
    # the WordPiece path (phase 8) through K1-K3, and its two new kernels
    by_name = {k["name"]: k for k in record["kernels"]}
    by_name["pair_stats"]["wp_launches"] = wp_launches["pair_stats"]
    for k, replaces in (
            ("select_unify", "subword_tokenizers_tpu/ops/pairstats.py:240"),
            ("merge_apply", "subword_tokenizers_tpu/ops/train_loop.py:264")):
        by_name[k].update(
            wp_mode=f"WordPiece mode, replaces {replaces}",
            wp_launches=wp_launches[k], wp_max_abs_err=errs[f"{k}_wp"],
            wp_ms=timing[f"{k}_wp"][0], wp_plain_ms=timing[f"{k}_wp"][1])
    # the launches of phases 6 and 8 count the replays' kernels; their
    # traced trains (6c, 8c) measured them: each kernel's spans equal its
    # counter's launches in that train
    for k in ("pair_stats", "select_unify", "merge_apply"):
        by_name[k].update(traced_launches=traced6[k],
                          wp_traced_launches=traced8[k])
    # K2's one launch over the claims of K1's fill (the main path) and over
    # every entry; K3's one launch with the state's scratch (phases 5, 7)
    by_name["select_unify"].update(
        also_replaces="subword_tokenizers_tpu/ops/pairstats.py:147",
        note="ms: one launch over the claim list of the table K1 filled "
             "at the corpus's initial state (its counter read on the "
             "card); dense_ms: over every entry of the same table (the "
             "sharded top-K tier's gathered candidates take that mode)",
        bound_note="bytes: each live entry through the claim list (24), "
                   "WordPiece's two weights of it (16), the h1 of each id "
                   "below n_sym (8), the control words and the record; "
                   "dense_bound_ms: every entry of the table instead",
        dense_ms=timing["select_unify_dense"][0],
        dense_bound_ms=bounds["select_unify_dense"][0],
        wp_dense_ms=timing["select_unify_wp_dense"][0],
        wp_dense_bound_ms=bounds["select_unify_wp_dense"][0],
        checks=dict(k2_checks))
    by_name["merge_apply"].update(
        also_replaces="subword_tokenizers_tpu/ops/flat.py:84",
        note="ms: one launch (tiles of 2,048 slots, a look-back over the "
             "state's MergeScratch) into the state's second buffer at the "
             "corpus's initial state",
        bound_note="bytes: every slot read once and written once (16 a "
                   "slot each way), the record")
    record["kernels"] += [
        {"name": "symbol_freqs", "route": "cuda",
         "source": "subword_tokenizers_tpu_torch/csrc/symbol_freqs.cu",
         "replaces": "subword_tokenizers_tpu/ops/pairstats.py:201",
         "launches": wp_launches["symbol_freqs"],
         "max_abs_err": errs["symbol_freqs"],
         "ms": timing["symbol_freqs"][0],
         "plain_ms": timing["symbol_freqs"][1]},
        {"name": "wp_score", "route": "cuda",
         "source": "subword_tokenizers_tpu_torch/csrc/select_unify.cu",
         "replaces": "subword_tokenizers_tpu/ops/pairstats.py:211",
         "launches": wp_launches["select_unify"],
         "note": "a __device__ scorer run inside each WordPiece-mode "
                 "select_unify launch (those are its launches); its own "
                 "launcher swt_score_bits serves the checks and the times",
         "max_abs_err": errs["wp_score"], "ms": timing["wp_score"][0],
         "plain_ms": timing["wp_score"][1]}]
    # the general-pops route (phase 2) and the encode path of phase 10
    by_name["wp_e2e_scan"].update(
        general_ms=timing["wp_e2e_general"][0],
        general_plain_ms=timing["wp_e2e_general"][1],
        general_bound_ms=bounds["wp_e2e_general"][0],
        general_bound_by=bounds["wp_e2e_general"][1])
    # each encode path's launches (phase 3d: FastWP's whole-sentence
    # route; phase 10: the others)
    by_path = {"FastWP_sentences": {"compact_ids": launches["compact_ids"]},
               **enc_launches}
    for k in ("compact_ids", "bpe_encode", "wp_match_encode",
              "wp_match_compact"):
        launches[k] = sum(p.get(k, 0) for p in by_path.values())
    by_name["compact_ids"]["launches"] = launches["compact_ids"]
    by_name["compact_ids"]["launches_by_path"] = {
        p: c["compact_ids"] for p, c in by_path.items()}
    record["kernels"] += [
        {"name": "bpe_encode", "route": "cuda",
         "source": "subword_tokenizers_tpu_torch/csrc/bpe_encode.cu",
         "replaces": "subword_tokenizers_tpu/ops/bpe_encode.py:119",
         "launches": launches["bpe_encode"],
         "launches_by_path": {p: enc_launches[p]["bpe_encode"]
                              for p in ("FastBPE", "NaiveBPE")},
         "max_abs_err": errs["bpe_encode"], "ms": timing["bpe_encode"][0],
         "plain_ms": timing["bpe_encode"][1],
         "wrapper_ms": timing["bpe_encode"][2],
         "greedy_ms": timing["bpe_encode_greedy"][0],
         "greedy_plain_ms": timing["bpe_encode_greedy"][1],
         "greedy_wrapper_ms": timing["bpe_encode_greedy"][2],
         "trips": trips9,
         "latency_bound_ms": {
             k: n["max"] * notes16["per_iter_ms"]["gather_loop"]
             for k, n in trips9.items()},
         "latency_note": "the slowest word's trips (monotone under "
                         "bpe_encode, greedy under bpe_encode_greedy; "
                         "total: every word's) x one dependent gather "
                         "through L1/L2 (phase 16's gather_loop, per "
                         "iteration)",
         "note": "ms: the kernel launched alone, back to back (a warp a "
                 "word); wrapper_ms: the wrapper, with the read-back of "
                 "the layout flag the kernel sets on a bad row"},
        {"name": "wp_match_compact", "route": "cuda",
         "source": "subword_tokenizers_tpu_torch/csrc/wp_match.cu",
         "replaces": "subword_tokenizers_tpu/ops/wp_encode.py:279",
         "launches": launches["wp_match_compact"],
         "launches_by_path": {"NaiveWP":
                              enc_launches["NaiveWP"]["wp_match_compact"]},
         "max_abs_err": errs["wp_match_compact"],
         "ms": timing["wp_match_compact"][0],
         "plain_ms": timing["wp_match_compact"][1],
         "steps": steps9,
         "slowest_word_ms": timing["wp_match_slowest"],
         "latency_bound_ms": steps9["walk_max"]
         * notes16["per_iter_ms"]["gather_loop"],
         "latency_note": "the slowest word's steps less those its '#' "
                         "jumps take (walk_max) x one dependent gather "
                         "through L1/L2 (phase 16's gather_loop, per "
                         "iteration)",
         "note": "ms: kernel 6 with kernel 2's tile epilogue in one launch "
                 "(swt_wp_match_compact), back to back; rows_form: its "
                 "rows form (swt_wp_match, the counterpart of "
                 "subword_tokenizers_tpu/ops/wp_encode.py:47), which no "
                 "encode path launches; phase 9 holds it against its "
                 "plain version",
         "rows_form": {
             "name": "wp_match_encode", "launches": launches[
                 "wp_match_encode"],
             "max_abs_err": errs["wp_match_encode"],
             "ms": timing["wp_match_encode"][0],
             "plain_ms": timing["wp_match_encode"][1],
             "bound_ms": bounds["wp_match_encode"][0],
             "bound_by": bounds["wp_match_encode"][1]}}]
    # the routes of phase 12: each new kernel's launches by route
    def routes_of(key):
        return {r: c[key] for r, c in by_route.items() if c[key]}

    by_name["pair_stats"].update(
        padded_launches=sum(by_route[r]["pair_stats"]
                            for r in ("bpe_padded", "wp_padded")),
        padded_max_abs_err=errs["pair_stats_rows"])
    new_kernels = (
        ("pair_stats_skip", "pair_stats.cu",
         "subword_tokenizers_tpu/ops/flat.py:148"),
        ("skip_guard", "merge_apply.cu",
         "subword_tokenizers_tpu/ops/flat.py:94"),
        ("merge_skip", "merge_apply.cu",
         "subword_tokenizers_tpu/ops/flat.py:168"),
        ("merge_rows", "merge_rows.cu",
         "subword_tokenizers_tpu/ops/merge.py:19"),
        ("select_unify_tournament", "select_unify.cu",
         "subword_tokenizers_tpu/ops/wp_tournament.py:93"))
    for k, src, replaces in new_kernels:
        paths = routes_of(k)
        record["kernels"].append(
            {"name": k, "route": "cuda",
             "source": f"subword_tokenizers_tpu_torch/csrc/{src}",
             "replaces": replaces, "launches": sum(paths.values()),
             "launches_by_path": paths, "max_abs_err": errs[k],
             "ms": timing[k][0], "plain_ms": timing[k][1]})
    by_name = {k["name"]: k for k in record["kernels"]}
    by_name["skip_guard"].update(
        note="ms: one launch with the gate closed (the usual step: each "
             "block reads the gate word merge_skip wrote and returns); "
             "fired_ms: the gate open, the state compacted in place "
             "(merge_tiles_kernel<true>, a state with 70-slot gaps at "
             "window 2)",
        bound_note="bytes: the gate word (closed); every slot read and "
                   "written (fired)",
        fired_ms=timing["skip_guard_fired"][0],
        fired_plain_ms=timing["skip_guard_fired"][1],
        fired_bound_ms=bounds["skip_guard_fired"][0],
        overflow_compactions=routes_of("overflow_compactions"),
        traced_skip_train=notes12c)
    by_name["select_unify_tournament"].update(
        risky_redos=routes_of("risky_redos") or {"wp_tournament": 0},
        exact_wp_ms=timing["select_unify_exact_wp"][0])
    by_name["merge_skip"].update(
        note="ms: one launch over the 85k state after 1,000 skip-mode "
             "merges with no match left (as most of a step's tiles are), "
             "the overflow test and the gate word included; merging_ms: "
             "the record's pairs merged (the state restored between "
             "calls)",
        bound_note="bytes: fs and wid read (8 a slot), the record, the "
                   "weight and gate words written; merging: the changed "
                   "words and the matches' weights besides",
        merging_ms=timing["merge_skip_merging"][0],
        merging_plain_ms=timing["merge_skip_merging"][1],
        merging_bound_ms=bounds["merge_skip_merging"][0],
        merging_changed=notes11["merge_skip_changed"])
    by_name["merge_rows"]["note"] = (
        "ms: a pass with no match left over the rows, each read and "
        "rewritten (the timed record's pairs merge on its first call)")
    # the sharded main path (phase 14) and the process group (phase 15)
    def mesh_of(key):
        return {p: c[key] for p, c in by_mesh.items() if c.get(key)}

    for k, src, replaces in (
            ("nominate_tables", "nominate.cu",
             "subword_tokenizers_tpu/parallel/train.py:249"),
            ("lookup_reduce", "shard_select.cu",
             "subword_tokenizers_tpu/parallel/train.py:105"),
            ("compact_tables", "shard_select.cu",
             "subword_tokenizers_tpu/ops/pairstats.py:162"),
            ("pair_stats_runs", "pair_stats.cu",
             "subword_tokenizers_tpu/parallel/train.py:199"),
            ("certificate", "certificate.cuh",
             "subword_tokenizers_tpu/parallel/train.py:287"),
            ("pair_rows", "pair_stats.cu",
             "subword_tokenizers_tpu/parallel/train.py:78")):
        paths = {p: n for p, n in mesh_of(k).items()
                 if not p.endswith("_encode")}
        record["kernels"].append(
            {"name": k, "route": "cuda",
             "source": f"subword_tokenizers_tpu_torch/csrc/{src}",
             "replaces": replaces, "launches": sum(paths.values()),
             "launches_by_path": {**paths, **{
                 p: c.get(k, 0) for p, c in by_group.items()}},
             "max_abs_err": errs[k], "ms": timing[k][0],
             "plain_ms": timing[k][1]})
    by_name = {k["name"]: k for k in record["kernels"]}
    for k, one in (("lookup_reduce", "lookup_one_table"),
                   ("compact_tables", "compact_one_table")):
        by_name[k].update(
            note=f"ms: one launch over the {notes13['D']} tables of the "
                 f"one-card mesh (per_shard_ms: ms / {notes13['D']}); "
                 f"one_table_ms: one launch over one table (its TableSet "
                 f"built once)",
            per_shard_ms=timing[k][0] / notes13["D"],
            one_table_ms=timing[one][0], one_table_plain_ms=timing[one][1],
            one_table_bound_ms=bounds[one][0],
            launch_floor_ms=notes13["launch_floor_ms"],
            launch_floor_cluster_ms=notes13["launch_floor_cluster_ms"])
    by_name["compact_tables"].update(
        library_note="library_ms: the device time of torch.nonzero(keys != "
                     "EMPTY_KEY) over the 8 tables' keys concatenated (the "
                     "ranks only), from a trace of 50 calls; "
                     "one_table_library_ms over one table's",
        one_table_library_ms=library["compact_one_table"],
        mesh1={**notes13["mesh1"], "ms": timing["compact_mesh1"][0],
               "plain_ms": timing["compact_mesh1"][1],
               "bound_ms": bounds["compact_mesh1"][0],
               "library_ms": library["compact_mesh1"],
               "note": "compact_table of the mesh of 1's one table"},
        bound_note="bytes: every key (8), the count and position of each "
                   "live entry of rank < cap (12), each output slot (20)")
    by_name["merge_rows"]["shard_note"] = (
        "shard_ms: K3p's device time of the golden's 1,001st merge on "
        "shard 0 of 8 (the state before it restored between calls); its "
        "bound reads every slot and writes the changed ones")
    by_name["compact_tables"]["back_to_back"] = {
        "calls": notes13["back_to_back"],
        "without_and_with_overflow": notes13["back_to_back_flags"],
        "wrong": notes13["back_to_back_wrong"]}
    for k in ("pair_stats", "merge_rows"):
        by_name[k].update(shard_ms=timing[f"shard_{k}"][0],
                          shard_bound_ms=bounds[f"shard_{k}"][0],
                          shard_rows=notes13["rows"])
    by_name["certificate"].update(
        note="also replaces the WordPiece certificate at "
             "subword_tokenizers_tpu/parallel/train.py:336-365 and "
             ":383-400. Device functions run inside K2's dense launch "
             "(select_unify.cu, its last block): launches are the K2 "
             "launches that ran them on the main path (no launch of its "
             "own); ms: its check launcher alone (shard_select.cu "
             "certificate_kernel) at the corpus's 8-shard BPE state after "
             "1,000 merges; k2_dense_ms / k2_dense_cert_ms: K2's dense "
             "launch over the same candidates without and with it; wp_*: "
             "the WordPiece state after 1,000 merges",
        launcher_source="subword_tokenizers_tpu_torch/csrc/shard_select.cu",
        k2_dense_ms=timing["k2_dense"][0],
        k2_dense_cert_ms=timing["k2_dense_cert"][0],
        k2_dense_bound_ms=bounds["k2_dense"][0],
        k2_dense_cert_bound_ms=bounds["k2_dense_cert"][0],
        wp_ms=timing["certificate_wp"][0],
        wp_plain_ms=timing["certificate_wp"][1],
        wp_k2_dense_ms=timing["k2_dense_wp"][0],
        wp_k2_dense_cert_ms=timing["k2_dense_cert_wp"][0],
        wp_k2_dense_cert_bound_ms=bounds["k2_dense_cert_wp"][0],
        max_abs_err=max(errs["certificate"], errs["certificate_fused"]),
        fused_max_abs_err=errs["certificate_fused"])
    # the nomination (phase 13): BPE, WordPiece and the mesh of 1
    by_name["nominate_tables"].update(
        also_replaces="subword_tokenizers_tpu/parallel/train.py:298",
        note=f"ms: one launch over the 8 tables of the one-card mesh at "
             f"the corpus's BPE state after 1,000 merges, k = 256 "
             f"({notes13['nominate_tables_live']} live of "
             f"{notes13['nominate_tables_T']}); library_ms: 8 torch.topk "
             f"of 256 over the same shards' metrics, one a shard, as the "
             f"tier called them before; wp_*: the WordPiece state after "
             f"1,000 merges, the scores computed in the kernel; mesh1_*: "
             f"the mesh of 1's table",
        bound_note="bytes: every key (8), the count of each live entry "
                   "(8) and, for WordPiece, its two symbol weights (16), "
                   "the outputs (8 (k + 3) a shard)",
        wp_ms=timing["nominate_tables_wp"][0],
        wp_plain_ms=timing["nominate_tables_wp"][1],
        wp_bound_ms=bounds["nominate_tables_wp"][0],
        wp_library_ms=library["nominate_tables_wp"],
        mesh1_ms=timing["nominate_mesh1"][0],
        mesh1_plain_ms=timing["nominate_mesh1"][1],
        mesh1_bound_ms=bounds["nominate_mesh1"][0],
        mesh1_library_ms=library["nominate_mesh1"],
        library_one_shard_ms=timing["topk"][0],
        ptxas=notes13["nominate_ptxas"])
    # the grouped K1 and K3p of the sharded step (phase 13b)
    by_name["pair_rows"].update(
        also_replaces="subword_tokenizers_tpu/ops/pairstats.py:92",
        note=f"ms: one launch over the {notes13b['D']} shards of the "
             f"one-card mesh ({notes13b['shard_rows']} x "
             f"{notes13b['rows'][1]} rows each) at the golden's 1,001st "
             f"step, filling one set of tables and emptying the other; "
             f"shard8_pair_stats_ms: the per-shard launches it replaces "
             f"(8 x swt_pair_stats, a launch each)",
        bound_note="bytes: the rows, the rows' weights, 20 bytes for each "
                   "live entry written and for each entry the step before "
                   "filled, emptied; full_clear_bound_ms: the same with "
                   "every entry of the other set emptied, as the kernel "
                   "does",
        full_clear_bound_ms=bounds["pair_rows_full_clear"][0],
        mesh1_full_clear_bound_ms=bounds["pair_rows_mesh1_full_clear"][0],
        shard8_pair_stats_ms=timing["shard8_pair_stats"][0],
        mesh1_ms=timing["pair_rows_mesh1"][0],
        mesh1_plain_ms=timing["pair_rows_mesh1"][1],
        mesh1_bound_ms=bounds["pair_rows_mesh1"][0],
        live=notes13b["live"], entries=notes13b["T_all"])
    merge_paths = {**routes_of("merge_rows"),
                   **{p: n for p, n in mesh_of("merge_rows").items()
                      if not p.endswith("_encode")}}
    by_name["merge_rows"].update(
        launches=sum(merge_paths.values()), launches_by_path=merge_paths,
        max_abs_err=max(errs["merge_rows"], errs["merge_rows_grouped"]),
        ms=timing["merge_rows_grouped"][0],
        plain_ms=timing["merge_rows_grouped"][1],
        note=f"ms: one launch over the {notes13b['D']} shards of the "
             f"one-card mesh with the golden's 1,001st merge as host ids "
             f"({notes13b['changed_rows']} rows changed; the state "
             f"restored between calls); shard8_merge_rows_ms: 8 launches, "
             f"one a shard; padded_ms: a pass with no match left over the "
             f"whole corpus (the padded route's shape)",
        shard8_merge_rows_ms=timing["shard8_merge_rows"][0],
        mesh1_ms=timing["merge_rows_mesh1"][0],
        mesh1_plain_ms=timing["merge_rows_mesh1"][1],
        mesh1_bound_ms=bounds["merge_rows_mesh1"][0],
        padded_ms=timing["merge_rows"][0],
        padded_plain_ms=timing["merge_rows"][1],
        padded_bound_ms=bounds["merge_rows"][0])
    bounds["merge_rows"] = bounds["merge_rows_grouped"]
    # K4 (phase 13c): the flat route's one launch a run, and the grouped
    # rows mode of the padded route and the sharded WordPiece step
    by_name["symbol_freqs"].update(
        flat_ms=timing["symbol_freqs_flat"][0],
        flat_plain_ms=timing["symbol_freqs_flat"][1],
        flat_bound_ms=bounds["symbol_freqs_flat"][0],
        flat_library_ms=library["symbol_freqs_flat"],
        flat_max_abs_err=errs["symbol_freqs_flat"],
        flat_note="flat_*: the WordPiece corpus's flat slots at sym_cap "
                  f"{notes13c.get('sym_cap', 'of the run')}, phase 13c")
    rows_paths = {**{p: n for p, n in mesh_of("symbol_rows").items()
                     if not p.endswith("_encode")},
                  **routes_of("symbol_rows")}
    record["kernels"].append(
        {"name": "symbol_rows", "route": "cuda",
         "source": "subword_tokenizers_tpu_torch/csrc/symbol_freqs.cu",
         "replaces": "subword_tokenizers_tpu/parallel/train.py:97",
         "also_replaces": "subword_tokenizers_tpu/ops/train_loop.py:152",
         "launches": sum(rows_paths.values()),
         "launches_by_path": rows_paths,
         "max_abs_err": errs["symbol_rows"],
         "ms": timing["symbol_rows"][0],
         "plain_ms": timing["symbol_rows"][1],
         "note": "ms: one launch over the one-card mesh's 8 WordPiece "
                 "shards (their sum), filling one output and emptying the "
                 "other; shard8_ms: 8 launches of it, one a shard, as the "
                 "step made before; library_ms: index_add_ of the "
                 "per-slot weights over the same slots",
         "shard8_ms": timing["symbol_rows_8_launches"][0],
         "mesh1_ms": timing["symbol_rows_mesh1"][0],
         "mesh1_bound_ms": bounds["symbol_rows_mesh1"][0],
         "padded_ms": timing["symbol_rows_padded"][0],
         "cap40000_ms": timing["symbol_rows_cap40000"][0],
         "cap40000_bound_ms": bounds["symbol_rows_cap40000"][0],
         "bound_note": "bytes: the rows (4 a slot), the row weights (8 a "
                       "row), the output written and the other emptied (8 "
                       "a bin each)"})
    by_name = {k["name"]: k for k in record["kernels"]}
    # the single-device K1 (phase 13c): one launch a call, no memset
    by_name["pair_stats"].update(
        steps_max_abs_err=errs["pair_stats_steps"],
        steps_checked=notes13c["k1_steps"],
        initial_ms=timing["pair_stats_initial"][0],
        initial_bound_ms=bounds["pair_stats_initial"][0],
        full_clear_bound_ms=bounds["pair_stats_full_clear"][0],
        bound_note="bytes: the slots (16 a slot), 20 for each distinct "
                   "pair's entry written and 20 for each the call before "
                   "filled, emptied; full_clear_bound_ms: every entry of "
                   "the table emptied instead (as three memsets would)",
        traced_blocks=notes13c["traced"])
    by_name["wp_score"].update(
        shard_ms=timing["wp_score_shard"][0],
        shard_bound_ms=bounds["wp_score_shard"][0],
        shard_entries=notes13c["shard_entries"],
        shard_note="shard_ms: swt_score_bits alone over one shard's table "
                   "of the one-card mesh of 8 (WordPiece, initial state), "
                   "the weights gathered before; the sharded step scores "
                   "inside the nomination, so mesh_launches is empty")
    # the gather probe (phase 16): launches of its main on the card
    for k, replaces in (("gather_take2d", "tools/pallas_probe.py:35"),
                        ("gather_loop", "tools/pallas_probe.py:74"),
                        ("gather_loop_shared", "tools/pallas_probe.py:74")):
        entry = {"name": k, "route": "cuda",
                 "source": "subword_tokenizers_tpu_torch/csrc/"
                           "gather_probe.cu",
                 "replaces": replaces, "launches": probe_launches[k],
                 "max_abs_err": errs[k], "ms": timing[k][0],
                 "plain_ms": timing[k][1]}
        if k != "gather_take2d":
            entry.update(
                per_iter_ms=notes16["per_iter_ms"][k],
                latency_bound_ms=notes16["latency_bound_ms"][k],
                latency_note="128 dependent iterations at the marginal "
                             "time of one (the slope from 128 to 1,152 "
                             "iterations)",
                k1_steps=notes16["k1_steps"],
                k1_latency_ms=notes16["k1_latency_ms"][k])
        record["kernels"].append(entry)
    by_name = {k["name"]: k for k in record["kernels"]}
    # the CLI's steps (phase 17)
    for k in cli_kernels():
        by_name[k]["cli_launches"] = {s: c[k] for s, c in by_cli.items()
                                      if c.get(k)}
    for k in ("pair_stats", "select_unify", "merge_rows", "symbol_freqs",
              "wp_score", "wp_e2e_scan", "compact_ids",
              "wp_e2e_scan_compact"):
        by_name[k]["mesh_launches"] = mesh_of(k)
    no_library = {
        "wp_e2e_scan": "no PyTorch call walks a trie",
        "wp_e2e_scan_compact": "no PyTorch call walks a trie",
        "pair_stats": "no one call builds the weighted pair table",
        "select_unify": "no one call selects and unifies by string hash",
        "merge_apply": "no one call merges pairs with the parity rule",
        "wp_score": "no one call gives the exact double of c / (fa * fb)",
        "bpe_encode": "no PyTorch call runs a per-row merge loop",
        "pair_stats_skip": "no one call builds the weighted pair table",
        "skip_guard": "no one call tests the window and compacts",
        "merge_skip": "no one call merges pairs with the parity rule",
        "merge_rows": "no one call merges pairs with the parity rule",
        "select_unify_tournament": "no one call selects and unifies by "
                                   "string hash",
        "wp_match_compact": "no PyTorch call walks a trie",
        "lookup_reduce": "no PyTorch call probes a hash table",
        "pair_rows": "no one call builds each shard's weighted pair table",
        "pair_stats_runs": "no one call sums counts and takes least "
                           "positions by key",
        "certificate": "no one call computes the certificate",
        "gather_loop": "no PyTorch call runs a chain of dependent gathers",
        "gather_loop_shared": "no PyTorch call runs a chain of dependent "
                              "gathers"}
    for k in record["kernels"]:
        name = k["name"]
        k["bound_ms"], k["bound_by"] = bounds[name]
        k["library_ms"] = library.get(name)
        if name in no_library:
            k["library_note"] = no_library[name]
        if f"{name}_wp" in bounds:
            k["wp_bound_ms"], k["wp_bound_by"] = bounds[f"{name}_wp"]
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
