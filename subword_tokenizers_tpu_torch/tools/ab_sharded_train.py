"""Paired timing of two checkouts of the repo on one NVIDIA GPU, each run
in a process of its own in the order parent, change, change, parent.

    python3 -m subword_tokenizers_tpu_torch.tools.ab_sharded_train \\
        PARENT_DIR CHANGE_DIR [compact] [kernels] [topk] [encode] [fastwp] \
        [match] [single] [skip] [block] [sharded] [NaiveBPE] [NaiveWP]

- ``NaiveBPE`` / ``NaiveWP``: the model under the one-card mesh
  ``make_data_mesh(8, devices=["cuda:0"] * 8)``, trained on all of
  ``data/train-85k.json`` to 8,000 and checked against the JAX goldens
  (a warm-up train to 300, then the timed train; about 65 s a run).
- ``sharded``: ``NaiveBPE`` and then ``NaiveWP`` under that mesh in one
  process, each after a warm-up train to 300, trained to 8,000 and
  checked against the JAX goldens: each wall, its wall a step (steps
  being the tiers' count), and where the checkout graphs the sharded
  step (parallel/train.ShardedTrainer's ``graph_stats``) its captures,
  replays, capture time and steps queued step by step (20-40 s a run).
  Give the mode three times for six pairs.
- ``compact``: one step's table compaction, as the checkout's compact
  tier calls it (one ``compact_tables`` a device with the device's
  ``TableSet`` and output buffers, or ``compact_table`` a shard), at
  the BPE state after the golden's first 1,000 merges, on that mesh of
  8 and on the mesh of 1 (one table of 2^20 entries), each at its
  tier's cap: the mean time a call on the device's clock over 200
  calls queued back to back (10-25 s a run).
- ``kernels``: the sharded step's K1 and K3p as the checkout's step calls
  them, on the mesh of 8 from the BPE state after the golden's first
  1,000 merges: 200 steps of K1 followed by the golden's next merge (a
  real merge every step), their device span by CUDA events and their
  host wall; then K1 alone, 25 calls queued back to back; then a
  WordPiece step's symbol weights (K4, ``sharded_sym_freq``) as the
  checkout's step calls them over the same 8 shards, 25 calls queued
  back to back for the device time and 200 for the host's time a call
  (10-20 s a run).
- ``topk``: the top-K tier (``sharded_select_topk``: the nomination, the
  lookup, K2 and the certificate) as the checkout's step calls it, on
  the mesh of 8 at the BPE and the WordPiece state after each golden's
  first 1,000 merges: the device time a call over 200 calls queued back
  to back, and the host's time a call over 200 calls; then, over the
  same candidates, K2's selection alone (``select_host_ids``) and the
  certificate's launcher alone (``shard_select.certificate``), 200
  calls each queued back to back (10-20 s a run).
- ``encode``: K5, ``bpe_encode`` over the corpus's 22,971 word types with
  the golden merges, monotone and greedy: the wrapper's wall a call
  (it waits for its answer) over 50 calls, and the device time a call of
  the kernels whose names hold "encode", from a ``torch.profiler`` trace
  of 20 calls (10-20 s a run).
- ``fastwp``: FastWP's batched encode of all of ``data/train-85k.json``
  with the 8,043-token vocab (``tests/golden/port_t85k_fastwp_vocab.json``,
  checked against ``port_t85k_fastwp_expect.json``): six warm
  ``tokenize_batch`` walls after a warm-up call, then the device time a
  call of the scan and compaction kernels (names holding "scan" or
  "scatter": kernel 1 and kernel 2's two passes, or the fused launch)
  and their launches and memsets a call, from a ``torch.profiler`` trace
  of 5 calls; then, at the corpus's unique chunks, 200 calls of each
  kernel queued back to back: kernel 1's rows form at the route's step
  cap and at 0 steps (all it does besides the walk), kernel 2 over its
  rows and the fused launch where the checkout has one (about 20 s a
  run).
- ``match``: NaiveWP's batched encode of all of ``data/train-85k.json``
  with the 8,000-token golden vocab (checked against
  ``port_t85k_encode_expect.json``): six warm ``tokenize_batch`` walls
  after a warm-up call, then the device time a call of the kernels whose
  names hold "match" or "compact" (kernel 6 and kernel 2, or the fused
  launch) and their launches and memsets a call, from a
  ``torch.profiler`` trace of 5 calls; then, at the corpus's 22,971 word
  types, 200 calls of each kernel queued back to back: kernel 6's rows
  form, kernel 2 over its rows and the fused launch where the checkout
  has one (about 20 s a run).
- ``single``: ``NaiveBPE`` and then ``NaiveWP(device="cuda")`` on one
  device (the default flat route), each trained on all of
  ``data/train-85k.json`` to 8,000 and checked against the JAX goldens,
  after a warm-up train to 300 (about 20 s a run).

- ``skip``: single-device ``NaiveBPE`` and then ``NaiveWP`` trained on
  all of ``data/train-85k.json`` to 8,000 with ``SWT_SKIP_COMPACT=12``
  (deferred compaction), then both again on the default flat route in
  the same process, each after a warm-up train to 300 and checked
  against the JAX goldens; then one ``NaiveBPE`` skip-route train under
  ``torch.profiler``: the device time and launches of the skip route's
  guard and K3 kernels (the kernels of either design, by name), the
  kernel launches and the memsets of the whole train (about 35 s a run).

- ``block``: single-device ``NaiveBPE`` and ``NaiveWP`` trained on all
  of ``data/train-85k.json`` to 8,000 on the default flat route, then
  both with ``SWT_SKIP_COMPACT=12``, each after a warm-up train to 300
  and checked against the JAX goldens; where the checkout runs its
  blocks as CUDA graph replays (ops/train_loop.BlockRunner), also the
  captures, replays and capture time of the timed trains (about 25 s a
  run). Give the mode three times for six pairs.

Each checkout builds its own kernels. Prints one JSON line a run, a line
with all of them and the card's name and power limit, then for each mode
the median and the range of each time over each side's runs.
"""
import json
import os
import subprocess
import sys
import time

TRAIN = r'''
import json, os, sys, time
import torch
sys.path.insert(0, os.getcwd())
from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.ops import _cuda
from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh
corpus = json.load(open("data/train-85k.json", encoding="utf-8"))
MODEL = sys.argv[1]
if MODEL == "NaiveBPE":
    cls = NaiveBPE
    golden = [tuple(p) for p in json.load(open(
        "tests/golden/port_t85k_v8000_bpe_merges.json", encoding="utf-8"))]
else:
    cls = NaiveWP
    golden = [tuple(p) for p in json.load(open(
        "tests/golden/port_t85k_v8000_wp_vocab.json",
        encoding="utf-8"))["merges"]]
dev = torch.device("cuda:0")
_cuda.lib()
mesh = make_data_mesh(8, devices=[dev] * 8)
cls(mesh=mesh, device=dev).train(corpus, 300)  # warm-up
tok = cls(mesh=mesh, device=dev)
t0 = time.perf_counter()
tok.train(corpus, 8000)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
got = tok.merges_list if MODEL == "NaiveBPE" else tok._merge_log
assert got == golden
out = {"wall": wall, "tiers": tok._sel_stats}
g = getattr(tok, "_graph_stats", None)
if g is not None:
    out.update(captures=g["captures"], replays=g["replays"],
               capture_s=g["capture_s"], eager_steps=g["eager_steps"])
print(json.dumps(out))
'''

COMPACT = r'''
import json, os, sys
import torch
sys.path.insert(0, os.getcwd())
from subword_tokenizers_tpu_torch.core.corpus import (build_bpe_corpus,
                                                      unique_words)
from subword_tokenizers_tpu_torch.core.symbols import SymbolTable
from subword_tokenizers_tpu_torch.frontend.pretokenize import \
    pretokenize_batch
from subword_tokenizers_tpu_torch.ops import _cuda, shard_select
from subword_tokenizers_tpu_torch.parallel import train as ptrain
from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh
corpus = json.load(open("data/train-85k.json", encoding="utf-8"))
golden = [tuple(p) for p in json.load(open(
    "tests/golden/port_t85k_v8000_bpe_merges.json", encoding="utf-8"))]
dev = torch.device("cuda:0")
_cuda.lib()
words, freq, _ = unique_words(pretokenize_batch(corpus))
table = SymbolTable()
arrays = build_bpe_corpus(words, freq, table)


def state(n_dev):
    sc = ptrain.shard_corpus(make_data_mesh(n_dev, devices=[dev] * n_dev),
                             arrays.sym, arrays.freq)
    t = SymbolTable(table.strings())
    for sa, sb in golden[:1000]:
        ptrain.sharded_apply_merge(sc, t.get(sa), t.get(sb),
                                   t.intern(sa + sb))
    cap = min(ptrain.run_gather_cap(sc.n_local_pairs), sc.n_local_pairs)
    if hasattr(sc, "blocks"):  # K1 one launch a device
        return sc, sc.pairs(), cap
    return sc, [s.pairs() for s in sc.shards], cap


def ms(fn, reps=200):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # queue the calls ahead of the stream
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def step(sc, tables, cap):
    """One step's compaction as the checkout's compact tier calls it."""
    if hasattr(sc, "blocks"):  # the block's own set
        out, ts = sc.run_buffers(0, cap), sc.blocks[0].table_set(tables)
        return lambda: shard_select.compact_tables(tables, sc.bases, cap,
                                                   out=out, tset=ts)
    if hasattr(sc, "table_set"):  # one launch a device
        out, ts = sc.run_buffers(0, cap), sc.table_set(0, tables)
        return lambda: shard_select.compact_tables(tables, sc.bases, cap,
                                                   out=out, tset=ts)
    return lambda: [shard_select.compact_table(t, cap, b)
                    for t, b in zip(tables, sc.bases)]


sc8, tables8, cap8 = state(8)
sc1, tables1, cap1 = state(1)
print(json.dumps({
    "mesh8_step_ms": ms(step(sc8, tables8, cap8)), "mesh8_cap": cap8,
    "mesh8_T": tables8[0][0].shape[0],
    "mesh1_step_ms": ms(step(sc1, tables1, cap1)), "mesh1_cap": cap1,
    "mesh1_T": tables1[0][0].shape[0],
    "mesh1_live": int((tables1[0][0] != -1).sum())}))
'''


KERNELS = r'''
import json, os, sys, time
import torch
sys.path.insert(0, os.getcwd())
from subword_tokenizers_tpu_torch.core.corpus import (build_bpe_corpus,
                                                      unique_words)
from subword_tokenizers_tpu_torch.core.symbols import SymbolTable
from subword_tokenizers_tpu_torch.frontend.pretokenize import \
    pretokenize_batch
from subword_tokenizers_tpu_torch.ops import _cuda
from subword_tokenizers_tpu_torch.parallel import train as ptrain
from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh
corpus = json.load(open("data/train-85k.json", encoding="utf-8"))
golden = [tuple(p) for p in json.load(open(
    "tests/golden/port_t85k_v8000_bpe_merges.json", encoding="utf-8"))]
dev = torch.device("cuda:0")
_cuda.lib()
words, freq, _ = unique_words(pretokenize_batch(corpus))
table = SymbolTable()
arrays = build_bpe_corpus(words, freq, table)
sc = ptrain.shard_corpus(make_data_mesh(8, devices=[dev] * 8), arrays.sym,
                         arrays.freq)
t = SymbolTable(table.strings())
ids = [(t.get(sa), t.get(sb), t.intern(sa + sb)) for sa, sb in golden[:1200]]
for m in ids[:1000]:
    ptrain.sharded_apply_merge(sc, *m)


def k1():
    """One step's K1 as the checkout calls it."""
    if hasattr(sc, "pairs"):  # one launch a device
        return sc.pairs()
    return [s.pairs() for s in sc.shards]


k1()
torch.cuda.synchronize()
start = torch.cuda.Event(enable_timing=True)
end = torch.cuda.Event(enable_timing=True)
t0 = time.perf_counter()
start.record()
for m in ids[1000:]:
    k1()
    ptrain.sharded_apply_merge(sc, *m)
end.record()
torch.cuda.synchronize()
wall = time.perf_counter() - t0
step_device = start.elapsed_time(end) / 200
k1()
torch.cuda.synchronize()
torch.cuda._sleep(100_000_000)  # queue the calls ahead of the stream
start.record()
for _ in range(25):  # up to 8 wrapper calls each, all inside the spin
    k1()
end.record()
torch.cuda.synchronize()
k1_ms = start.elapsed_time(end) / 25
# WordPiece's symbol weights a step, as the checkout's step counts them
sym_cap = max(8000, len(table)) + 8
ptrain.sharded_sym_freq(sc, sym_cap)
torch.cuda.synchronize()
torch.cuda._sleep(100_000_000)
start.record()
for _ in range(25):
    ptrain.sharded_sym_freq(sc, sym_cap)
end.record()
torch.cuda.synchronize()
k4_ms = start.elapsed_time(end) / 25
t0 = time.perf_counter()
for _ in range(200):
    ptrain.sharded_sym_freq(sc, sym_cap)
k4_host = (time.perf_counter() - t0) * 1e3 / 200
torch.cuda.synchronize()
print(json.dumps({"step_device_ms": step_device,
                  "step_host_ms": wall * 1e3 / 200,
                  "k1_ms": k1_ms, "k4_ms": k4_ms, "k4_host_ms": k4_host}))
'''

TOPK = r'''
import json, os, sys, time
import torch
sys.path.insert(0, os.getcwd())
from subword_tokenizers_tpu_torch.core.corpus import (build_bpe_corpus,
                                                      build_wp_corpus,
                                                      unique_words)
from subword_tokenizers_tpu_torch.core.symbols import SymbolTable
from subword_tokenizers_tpu_torch.frontend.pretokenize import \
    pretokenize_batch
from subword_tokenizers_tpu_torch.ops import _cuda
from subword_tokenizers_tpu_torch.ops.shard_select import (
    certificate, lookup_reduce, nominate_tables)
from subword_tokenizers_tpu_torch.ops.train_loop import select_host_ids
from subword_tokenizers_tpu_torch.parallel import train as ptrain
from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh
corpus = json.load(open("data/train-85k.json", encoding="utf-8"))
bpe = [tuple(p) for p in json.load(open(
    "tests/golden/port_t85k_v8000_bpe_merges.json", encoding="utf-8"))]
wp = [tuple(p) for p in json.load(open(
    "tests/golden/port_t85k_v8000_wp_vocab.json",
    encoding="utf-8"))["merges"]]
dev = torch.device("cuda:0")
_cuda.lib()
words, freq, _ = unique_words(pretokenize_batch(corpus))
mesh = make_data_mesh(8, devices=[dev] * 8)
out = {}


def device_ms(fn, reps=200):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # queue the calls ahead of the stream
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


for name, build, golden, join in (
        ("bpe", build_bpe_corpus, bpe, lambda a, b: a + b),
        ("wp", build_wp_corpus, wp, lambda a, b: a + b[2:])):
    table = SymbolTable()
    arrays = build(words, freq, table)
    sc = ptrain.shard_corpus(mesh, arrays.sym, arrays.freq)
    for sa, sb in golden[:1000]:
        ptrain.sharded_apply_merge(sc, table.get(sa), table.get(sb),
                                   table.intern(join(sa, sb)))
    sf = (ptrain.sharded_sym_freq(sc, max(8000, len(table)) + 8).clone()
          if name == "wp" else None)
    tables = sc.pairs()
    rec = torch.zeros(6, dtype=torch.int32, device=dev)

    def fn():
        ptrain.sharded_select_topk(sc, tables, rec, sf)

    out[name + "_device_ms"] = device_ms(fn)
    t0 = time.perf_counter()
    for _ in range(200):
        fn()
    out[name + "_host_ms"] = (time.perf_counter() - t0) * 1e3 / 200
    torch.cuda.synchronize()
    out[name + "_rec"] = rec.tolist()
    cand, kth = nominate_tables(tables, ptrain.TOPK, sf)
    g_cnt, g_pos = lookup_reduce(cand, tables, sc.bases)
    r2 = torch.zeros(6, dtype=torch.int32, device=dev)
    out[name + "_k2_ms"] = device_ms(
        lambda: select_host_ids(cand, g_cnt, g_pos, r2, sf,
                                scratch=sc.k2_scratch))
    out[name + "_cert_launcher_ms"] = device_ms(
        lambda: certificate(kth, cand, g_cnt, r2, sf))
print(json.dumps(out))
'''

ENCODE = r'''
import json, os, sys, time
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, os.getcwd())
from subword_tokenizers_tpu_torch import NaiveBPE
from subword_tokenizers_tpu_torch.core.corpus import unique_words
from subword_tokenizers_tpu_torch.frontend.pretokenize import \
    pretokenize_batch
from subword_tokenizers_tpu_torch.ops import _cuda
from subword_tokenizers_tpu_torch.ops.bpe_encode import bpe_encode
corpus = json.load(open("data/train-85k.json", encoding="utf-8"))
merges = [tuple(p) for p in json.load(open(
    "tests/golden/port_t85k_v8000_bpe_merges.json", encoding="utf-8"))]
dev = torch.device("cuda:0")
_cuda.lib()
words, _, _ = unique_words(pretokenize_batch(corpus))
tok = NaiveBPE(device=dev)
tok.merges_list = merges
st = tok._device_tables()
sym = torch.from_numpy(tok._encode_inputs(words, st.table)).to(dev)
out = {"W": sym.shape[0], "L": sym.shape[1]}
for mode, monotone in (("monotone", True), ("greedy", False)):
    args = (sym, st.hkeys, st.hrank, st.hout, monotone, st.max_probe)
    res = bpe_encode(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        bpe_encode(*args)
    torch.cuda.synchronize()
    out[mode + "_wrapper_ms"] = (time.perf_counter() - t0) * 1e3 / 50
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            bpe_encode(*args)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if "encode" in e.key]
    out[mode + "_kernel_ms"] = sum(
        getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
        for e in kern) / 1e3 / 20
    out[mode + "_kernels"] = [e.key[:60] for e in kern]
    out[mode + "_out_n_sum"] = int(res[1].sum())
print(json.dumps(out))
'''

FASTWP = r'''
import hashlib, json, os, sys, tempfile, time
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, os.getcwd())
from subword_tokenizers_tpu_torch import FastWP
from subword_tokenizers_tpu_torch.ops import _cuda
corpus = json.load(open("data/train-85k.json", encoding="utf-8"))
vocab = json.load(open("tests/golden/port_t85k_fastwp_vocab.json",
                       encoding="utf-8"))
expect = json.load(open("tests/golden/port_t85k_fastwp_expect.json",
                        encoding="utf-8"))
dev = torch.device("cuda:0")
_cuda.lib()
tok = FastWP(device=dev)
with tempfile.TemporaryDirectory() as d:
    with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    tok.load_resources(d, strict=True)
res = tok.tokenize_batch(corpus)  # warm-up
sha = hashlib.sha256(json.dumps(res, ensure_ascii=False).encode("utf-8"))
assert sha.hexdigest() == expect["full_sha256"]
walls = []
for _ in range(6):
    t0 = time.perf_counter()
    tok.tokenize_batch(corpus)
    torch.cuda.synchronize()
    walls.append((time.perf_counter() - t0) * 1e3)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(5):
        tok.tokenize_batch(corpus)
    torch.cuda.synchronize()
ev = prof.key_averages()
kern = [e for e in ev if "scan" in e.key or "scatter" in e.key]
out = {"walls_ms": walls, "median_wall_ms": sorted(walls)[3],
       "kernel_ms": sum(
           getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
           for e in kern) / 1e3 / 5,
       "kernel_launches": sum(e.count for e in kern) / 5,
       "memsets": sum(e.count for e in ev if "memset" in e.key.lower()) / 5,
       "kernels": [e.key[:60] for e in kern]}
# the kernels alone at the corpus's unique chunks, 200 calls queued back
# to back: the rows form at the route's step cap and at a cap of 0 steps
# (what the kernel does besides the walk: the parent's zero-fill), kernel
# 2 over its rows, and the fused launch where the checkout has it
import numpy as np
from chip_smoke import cuda_ms
from subword_tokenizers_tpu_torch._native import binding
from subword_tokenizers_tpu_torch.ops import wp_encode_e2e as e2e
from subword_tokenizers_tpu_torch.ops.fetch import compact_ids
st = tok._device_state()
_, _, buf, off, ln = binding.encode_prep(corpus)
Lc = -(-(int(ln.max()) + 2) // 8) * 8
m16 = binding.pack_u16_rows(buf, off, ln, Lc, st.alpha)
args = (torch.from_numpy(m16.view("int16")).to(dev),
        torch.from_numpy((ln + 1).astype("int32")).to(dev), st.goto,
        st.fail, st.pops_off, st.pops_flat, st.root_p, st.root_sharp,
        st.unk_id, st.sharp)
cap, steps, unk = e2e.route_params(Lc, general=False)
kw = {"rec": st.rec} if hasattr(st, "rec") else {}
out["rows_ms"] = cuda_ms(lambda: e2e.wp_e2e_scan(*args, cap, steps, unk,
                                                 **kw), 200, True)
out["rows_0_steps_ms"] = cuda_ms(
    lambda: e2e.wp_e2e_scan(*args, cap, 0, unk, **kw), 200, True)
rows = e2e.wp_e2e_scan(*args, cap, steps, unk, **kw)
out["compact_ms"] = cuda_ms(lambda: compact_ids(*rows), 200, True)
if hasattr(e2e, "wp_e2e_scan_compact"):
    out["fused_ms"] = cuda_ms(lambda: e2e.wp_e2e_scan_compact(
        *args, cap, steps, unk, **kw), 200, True)
    out["fused_0_steps_ms"] = cuda_ms(lambda: e2e.wp_e2e_scan_compact(
        *args, cap, 0, unk, **kw), 200, True)
print(json.dumps(out))
'''

MATCH = r'''
import hashlib, json, os, sys, time
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, os.getcwd())
from chip_smoke import cuda_ms
from subword_tokenizers_tpu_torch import NaiveWP
from subword_tokenizers_tpu_torch.core.corpus import unique_words
from subword_tokenizers_tpu_torch.ops import _cuda
from subword_tokenizers_tpu_torch.ops import wp_encode as we
from subword_tokenizers_tpu_torch.ops.fetch import compact_ids
corpus = json.load(open("data/train-85k.json", encoding="utf-8"))
vocab = json.load(open("tests/golden/port_t85k_v8000_wp_vocab.json",
                       encoding="utf-8"))["vocab"]
expect = json.load(open("tests/golden/port_t85k_encode_expect.json",
                        encoding="utf-8"))["NaiveWP_golden"]
dev = torch.device("cuda:0")
_cuda.lib()
tok = NaiveWP(device=dev)
tok.vocab = set(vocab)
res = tok.tokenize_batch(corpus)  # warm-up
sha = hashlib.sha256(json.dumps(res, ensure_ascii=False).encode("utf-8"))
assert sha.hexdigest() == expect["full_sha256"]
walls = []
for _ in range(6):
    t0 = time.perf_counter()
    tok.tokenize_batch(corpus)
    torch.cuda.synchronize()
    walls.append((time.perf_counter() - t0) * 1e3)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(5):
        tok.tokenize_batch(corpus)
    torch.cuda.synchronize()
ev = prof.key_averages()
kern = [e for e in ev if "match" in e.key or "compact" in e.key]
out = {"walls_ms": walls, "median_wall_ms": sorted(walls)[3],
       "kernel_ms": sum(
           getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
           for e in kern) / 1e3 / 5,
       "kernel_launches": sum(e.count for e in kern) / 5,
       "memsets": sum(e.count for e in ev if "memset" in e.key.lower()) / 5,
       "kernels": [e.key[:60] for e in kern]}
# the kernels alone at the corpus's word types, 200 calls queued back to
# back: kernel 6's rows form, kernel 2 over its rows, and the fused launch
# where the checkout has it
words = unique_words(tok.preprocessing_batch(corpus))[0]
trie, _, wmat, wlen = tok._match_inputs(words)
st = tok._match_device()
args = (torch.from_numpy(wmat).to(dev), torch.from_numpy(wlen).to(dev),
        st.goto, st.accept, int(trie.alpha[ord("#")]))
kw = {"rec": st.rec, "jumps": st.jumps} if hasattr(st, "rec") else {}
out["rows_ms"] = cuda_ms(lambda: we.wp_match_encode(*args, **kw), 200,
                         True)
rows = we.wp_match_encode(*args, **kw)
out["compact_ms"] = cuda_ms(lambda: compact_ids(rows[0], rows[1], rows[3]),
                            200, True)
if hasattr(we, "wp_match_compact"):
    out["fused_ms"] = cuda_ms(lambda: we.wp_match_compact(*args, **kw),
                              200, True)
print(json.dumps(out))
'''

SINGLE = r'''
import json, os, sys, time
import torch
sys.path.insert(0, os.getcwd())
from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.ops import _cuda
corpus = json.load(open("data/train-85k.json", encoding="utf-8"))
bpe = [tuple(p) for p in json.load(open(
    "tests/golden/port_t85k_v8000_bpe_merges.json", encoding="utf-8"))]
wp = [tuple(p) for p in json.load(open(
    "tests/golden/port_t85k_v8000_wp_vocab.json",
    encoding="utf-8"))["merges"]]
dev = torch.device("cuda:0")
_cuda.lib()
out = {}
for name, cls, golden in (("NaiveBPE", NaiveBPE, bpe),
                          ("NaiveWP", NaiveWP, wp)):
    cls(device=dev).train(corpus, 300)  # warm-up
    tok = cls(device=dev)
    t0 = time.perf_counter()
    tok.train(corpus, 8000)
    torch.cuda.synchronize()
    out[name] = time.perf_counter() - t0
    got = tok.merges_list if name == "NaiveBPE" else tok._merge_log
    assert got == golden, name
print(json.dumps(out))
'''

SKIP = r'''
import json, os, sys, time
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, os.getcwd())
from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.ops import _cuda
corpus = json.load(open("data/train-85k.json", encoding="utf-8"))
bpe = [tuple(p) for p in json.load(open(
    "tests/golden/port_t85k_v8000_bpe_merges.json", encoding="utf-8"))]
wp = [tuple(p) for p in json.load(open(
    "tests/golden/port_t85k_v8000_wp_vocab.json",
    encoding="utf-8"))["merges"]]
dev = torch.device("cuda:0")
_cuda.lib()
out = {}
for route, skip in (("skip12", "12"), ("flat", None)):
    if skip is None:
        os.environ.pop("SWT_SKIP_COMPACT", None)
    else:
        os.environ["SWT_SKIP_COMPACT"] = skip
    for name, cls, golden in (("NaiveBPE", NaiveBPE, bpe),
                              ("NaiveWP", NaiveWP, wp)):
        cls(device=dev).train(corpus, 300)  # warm-up
        tok = cls(device=dev)
        t0 = time.perf_counter()
        tok.train(corpus, 8000)
        torch.cuda.synchronize()
        out[f"{name}_{route}"] = time.perf_counter() - t0
        got = tok.merges_list if name == "NaiveBPE" else tok._merge_log
        assert got == golden, (name, route)
# the skip route's guard and K3 kernels, either design's, over one train
os.environ["SWT_SKIP_COMPACT"] = "12"
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    NaiveBPE(device=dev).train(corpus, 8000)
    torch.cuda.synchronize()
ev = prof.key_averages()
NAMES = ("skip_check_kernel(", "mark_kernel(", "scan_kernel(",
         "scatter_kernel(", "copy_kernel(", "mark_skip_kernel(",
         "apply_skip_kernel(", "merge_skip_kernel(",
         "merge_tiles_kernel<true>(")


def dev_ms(e):
    return getattr(e, "device_time_total",
                   getattr(e, "cuda_time_total", 0)) / 1e3


kern = {n[:-1]: e for e in ev for n in NAMES if "::" + n in e.key}
out["skip_kernels_ms"] = sum(dev_ms(e) for e in kern.values())
out["skip_kernels"] = {n: [e.count, dev_ms(e)] for n, e in kern.items()}
out["kernel_launches"] = sum(e.count for e in ev
                             if "memcpy" not in e.key.lower()
                             and "memset" not in e.key.lower())
out["memsets"] = sum(e.count for e in ev if "memset" in e.key.lower())
print(json.dumps(out))
'''

BLOCK = r'''
import json, os, sys, time
import torch
sys.path.insert(0, os.getcwd())
from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.ops import _cuda, train_loop
corpus = json.load(open("data/train-85k.json", encoding="utf-8"))
bpe = [tuple(p) for p in json.load(open(
    "tests/golden/port_t85k_v8000_bpe_merges.json", encoding="utf-8"))]
wp = [tuple(p) for p in json.load(open(
    "tests/golden/port_t85k_v8000_wp_vocab.json",
    encoding="utf-8"))["merges"]]
dev = torch.device("cuda:0")
_cuda.lib()
runner = getattr(train_loop, "BlockRunner", None)
out = {}
for route, skip in (("flat", None), ("skip12", "12")):
    if skip is None:
        os.environ.pop("SWT_SKIP_COMPACT", None)
    else:
        os.environ["SWT_SKIP_COMPACT"] = skip
    for name, cls, golden in (("NaiveBPE", NaiveBPE, bpe),
                              ("NaiveWP", NaiveWP, wp)):
        cls(device=dev).train(corpus, 300)  # warm-up
        before = None if runner is None else (
            runner.captures, runner.replays, runner.capture_s)
        tok = cls(device=dev)
        t0 = time.perf_counter()
        tok.train(corpus, 8000)
        torch.cuda.synchronize()
        out[f"{name}_{route}"] = time.perf_counter() - t0
        got = tok.merges_list if name == "NaiveBPE" else tok._merge_log
        assert got == golden, (name, route)
        if runner is not None:
            out[f"{name}_{route}_graphs"] = [
                runner.captures - before[0], runner.replays - before[1],
                runner.capture_s - before[2]]
print(json.dumps(out))
'''


SHARDED = r'''
import json, os, sys, time
import torch
sys.path.insert(0, os.getcwd())
from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.ops import _cuda
from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh
corpus = json.load(open("data/train-85k.json", encoding="utf-8"))
bpe = [tuple(p) for p in json.load(open(
    "tests/golden/port_t85k_v8000_bpe_merges.json", encoding="utf-8"))]
wp = [tuple(p) for p in json.load(open(
    "tests/golden/port_t85k_v8000_wp_vocab.json",
    encoding="utf-8"))["merges"]]
dev = torch.device("cuda:0")
_cuda.lib()
mesh = make_data_mesh(8, devices=[dev] * 8)
out = {}
for name, cls, golden in (("NaiveBPE", NaiveBPE, bpe),
                          ("NaiveWP", NaiveWP, wp)):
    cls(mesh=mesh, device=dev).train(corpus, 300)  # warm-up
    tok = cls(mesh=mesh, device=dev)
    t0 = time.perf_counter()
    tok.train(corpus, 8000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = tok.merges_list if name == "NaiveBPE" else tok._merge_log
    assert got == golden, name
    out[name] = wall
    out[f"{name}_step_ms"] = wall * 1e3 / sum(tok._sel_stats.values())
    out[f"{name}_tiers"] = tok._sel_stats
    g = getattr(tok, "_graph_stats", None)
    if g is not None:
        for k in ("captures", "replays", "capture_s", "eager_steps"):
            out[f"{name}_{k}"] = g[k]
print(json.dumps(out))
'''


def summary(res):
    """{mode: {side: {key: [median, min, max, n]}}} of every time a run
    printed (numbers only)."""
    import statistics
    out = {}
    for r in res:
        side = out.setdefault(r["mode"], {}).setdefault(r["name"], {})
        for k, v in r.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool) \
                    and k != "process_s":
                side.setdefault(k, []).append(v)
    return {m: {n: {k: [statistics.median(v), min(v), max(v), len(v)]
                    for k, v in side.items()} for n, side in sides.items()}
            for m, sides in out.items()}


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = argv[0], argv[1]
    modes = argv[2:] or ["NaiveBPE"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    res = []
    for mode in modes:
        args = ([COMPACT] if mode == "compact" else
                [KERNELS] if mode == "kernels" else
                [TOPK] if mode == "topk" else
                [ENCODE] if mode == "encode" else
                [FASTWP] if mode == "fastwp" else
                [MATCH] if mode == "match" else
                [SINGLE] if mode == "single" else
                [SKIP] if mode == "skip" else
                [BLOCK] if mode == "block" else
                [SHARDED] if mode == "sharded" else [TRAIN, mode])
        for name, d in (("parent", parent), ("change", change),
                        ("change", change), ("parent", parent)):
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-c", *args], cwd=d,
                                 capture_output=True, text=True)
            if out.returncode:
                print(f"{mode} {name} failed:\n{out.stderr[-3000:]}",
                      flush=True)
                return 1
            r = json.loads(out.stdout.strip().splitlines()[-1])
            r.update(name=name, mode=mode, dir=os.path.abspath(d),
                     process_s=time.perf_counter() - t0)
            res.append(r)
            print(json.dumps(r), flush=True)
    print("AB", json.dumps(res), smi, flush=True)
    print("SUMMARY", json.dumps(summary(res)), smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
