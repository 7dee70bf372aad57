"""The sharded step's trainer (parallel/train.ShardedTrainer) on a mesh of
8 CPU shards, on the kernels' plain versions, against the JAX package's
sharded train on slices of ``data/train-85k.json``.

On the card each tier a step tries after the run's first step is one
replay of a CUDA graph, captured once for each key of host values, on a
mesh with no process group and on one under NCCL; only the card runs
graphs. The process-group route runs here under gloo at world size 1. Here the trainer runs two ways: step by step, as
every CPU run does, and with ``graphed`` set and a stand-in for
``torch.cuda.CUDAGraph`` whose capture runs the tier once and whose
every later replay runs it again from the host values of its key, so
the trainer's bookkeeping (keys, the host values a replay moves, the
compactions and collectives a graph holds, the release at the end) runs
here. A spy on the launch wrappers and the mesh's collectives shows that
every step of one key passes the same scalars and the same buffers as
that key's first step, so a graph of the first replays the others. The compaction's epoch is a word of its
TableSet on the device; its plain version writes the words as the
kernel does, across the restart of the epochs.

Every comparison is exact: merges, vocab, ``corpus_as_symbols``, the
tier counts, the checkpoints, the descriptor's words."""
import contextlib
import functools
import json
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from subword_tokenizers_tpu import NaiveBPE as JaxNaiveBPE
from subword_tokenizers_tpu import NaiveWP as JaxNaiveWP
from subword_tokenizers_tpu.parallel import train as jtrain
from subword_tokenizers_tpu.parallel.mesh import make_data_mesh as jax_mesh
from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.ops import train_loop
from subword_tokenizers_tpu_torch.ops.pairstats import EMPTY_KEY
from subword_tokenizers_tpu_torch.ops.shard_select import (
    EPOCH_MAX, K_INCLUSIVE, ROUND_SPAN, TableSet, compact_tables,
    compact_tables_ref)
from subword_tokenizers_tpu_torch.parallel import distributed
from subword_tokenizers_tpu_torch.parallel import train as ptrain
from subword_tokenizers_tpu_torch.parallel.mesh import DataMesh, make_data_mesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CLASSES = {NaiveBPE: JaxNaiveBPE, NaiveWP: JaxNaiveWP}


@pytest.fixture(scope="module")
def corpus():
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def mesh8():
    return make_data_mesh(8, devices=["cpu"] * 8)


@pytest.fixture
def gloo():
    """A gloo process group of this process alone (world size 1), for
    the test; its mesh of 8 CPU shards is a process-group mesh."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    distributed.initialize(f"localhost:{port}", num_processes=1,
                           process_id=0, device="cpu")
    try:
        mesh = make_data_mesh(8, devices=["cpu"] * 8)
        assert mesh.group and mesh.backend == "gloo" and mesh.world == 1
        yield mesh
    finally:
        dist.destroy_process_group()


def mesh_for(route, request):
    """The mesh of 8 CPU shards of a route: no process group, or gloo."""
    return request.getfixturevalue("gloo" if route == "gloo" else "mesh8")


def merges(tok):
    return tok.merges_list if hasattr(tok, "merges_list") else tok._merge_log


def jax_train(cls, text, vocab, tier=None, **kw):
    tok = JAX_CLASSES[cls](mesh=jax_mesh(8))
    if tier:
        tok._force_tier = tier
    tok.train(text, vocab, **kw)
    return tok


def assert_same(port, jax_tok):
    assert merges(port) == merges(jax_tok)
    assert port.vocab == jax_tok.vocab
    assert port.corpus_as_symbols == jax_tok.corpus_as_symbols
    assert port._sel_stats == jax_tok._sel_stats
    assert port._topk_fallbacks == jax_tok._topk_fallbacks


class StandInGraph:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU, where the plain
    versions run at once: the capture runs the tier once (as the real
    capture's replay right after it would), and each later replay runs it
    again from the host values the key holds, then puts back the host
    values, fill counts, compaction counts and the mesh's collective
    counts, which the trainer moves itself after a replay, as after a
    real one."""

    capturing = None
    made = []

    def __init__(self):
        self.tier = None  # (trainer, tier, head), noted by the capture
        self.fresh = True
        self.released = False
        StandInGraph.made.append(self)

    def capture_begin(self, capture_error_mode=None):
        StandInGraph.capturing = self

    def capture_end(self):
        StandInGraph.capturing = None

    def replay(self):
        if self.fresh:
            self.fresh = False
            return
        trainer, tier, head = self.tier
        slots, tables = trainer._host_values()
        saved = [getattr(o, a) for o, a in slots]
        fills = [t.fills for t in tables]
        sets = trainer.corpus.blocks[0].sets
        calls = [s.calls for s in sets]
        issued = dict(trainer.corpus.mesh.collectives)
        trainer._queue(tier, head)
        trainer.corpus.mesh.collectives.update(issued)
        for (o, a), v in zip(slots, saved):
            setattr(o, a, v)
        for t, n in zip(tables, fills):
            t.fills = n
        for s, n in zip(sets, calls):
            s.calls = n

    def reset(self):
        self.released = True


class _NoStream:
    def synchronize(self):
        pass


@pytest.fixture
def tiers(monkeypatch):
    """Every tier the trainers run: (step, tier, queued step by step)."""
    seen = []
    real = ptrain.ShardedTrainer._tier

    def tier(self, name, head, eager):
        seen.append((self.steps, name, eager))
        return real(self, name, head, eager)

    monkeypatch.setattr(ptrain.ShardedTrainer, "_tier", tier)
    return seen


GRAPHED = [True]  # whether the graphs fixture graphs the next trainers
GATES = []  # the trainers' own graphed gates, before the fixture's


@pytest.fixture
def graphs(monkeypatch, tiers):
    """The trainers graphed, with StandInGraph for the card's graphs
    (while ``GRAPHED[0]``)."""
    StandInGraph.made = []
    GRAPHED[0] = True
    GATES.clear()
    real_init = ptrain.ShardedTrainer.__init__

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        GATES.append(self.graphed)
        self.graphed = GRAPHED[0]

    real_queue = ptrain.ShardedTrainer._queue

    def queue(self, tier, head):
        if StandInGraph.capturing is not None:
            StandInGraph.capturing.tier = (self, tier, head)
        return real_queue(self, tier, head)

    monkeypatch.setattr(ptrain.ShardedTrainer, "__init__", init)
    monkeypatch.setattr(ptrain.ShardedTrainer, "_queue", queue)
    monkeypatch.setattr(ptrain, "_allocations", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: _NoStream())
    return tiers


def check_graphs(tok, tiers):
    """One step queued step by step, then one replay for each tier a
    later step tried (top-K, compact or full), at most two graphs for
    each tier and first-tier flag (the table set's parity on the CPU,
    whose trainer has no runs tables), all released at the end. The
    CPU's own gate graphs nothing."""
    st = tok._graph_stats
    first = [t for t in tiers if t[0] == 1]
    later = [t for t in tiers if t[0] > 1]
    assert all(eager for _, _, eager in first)
    assert not any(eager for _, _, eager in later)
    assert st["replays"] == len(later)
    assert st["tiers"] == len(tiers) and st["eager_tiers"] == len(first)
    assert st["eager_steps"] == 1
    assert GATES and not any(GATES)
    assert st["captures"] == sum(st["graphs"].values()) == len(
        StandInGraph.made)
    assert all(n <= 4 for n in st["graphs"].values())
    assert all(g.released for g in StandInGraph.made)


def expected_collectives(tiers, wordpiece):
    """The collectives a process-group run issues for the tiers it ran:
    the top-K tier gathers the candidates and the K-th rows and reduces
    the counts and positions, the compact tier gathers the runs' keys,
    counts and positions and reduces the overflow flag, the full tier
    gathers the rows, and a WordPiece step reduces K4's weights in its
    first tier; the end of the train gathers the final rows once
    (``fetch_global``)."""
    n = {t: sum(1 for _, name, _ in tiers if name == t)
         for t in ("topk", "compact", "full")}
    steps = len({s for s, _, _ in tiers})
    return {"all_gather": 2 * n["topk"] + 3 * n["compact"] + n["full"] + 1,
            "all_reduce": 2 * n["topk"] + n["compact"]
            + (steps if wordpiece else 0)}


@pytest.mark.parametrize("route", ["steps", "graphed", "gloo"])
@pytest.mark.parametrize("cls,vocab", [(NaiveBPE, 600), (NaiveWP, 700)])
def test_trainer_equals_jax(cls, vocab, route, corpus, request):
    """Train-85k[:300] on 8 shards, step by step, graphed, and graphed on
    a gloo process-group mesh at world size 1 (its collectives counted,
    replays included), against the JAX package's sharded train: the same
    merges, vocab, final symbols and tier counts (BPE falls back to the
    compact tier on most steps past the first few hundred)."""
    mesh = mesh_for(route, request)
    seen = request.getfixturevalue("tiers" if route == "steps"
                                   else "graphs")
    port = cls(mesh=mesh, device="cpu")
    port.train(corpus[:300], vocab)
    assert_same(port, jax_train(cls, corpus[:300], vocab))
    assert len(merges(port)) > 400
    if cls is NaiveBPE:
        assert port._sel_stats["compact"] > 100
    if route == "steps":
        assert port._graph_stats["replays"] == 0
        assert port._graph_stats["eager_steps"] == len(
            {s for s, _, _ in seen})
    else:
        check_graphs(port, seen)
        assert port._graph_stats["replays"] >= len(merges(port)) - 1
    want = expected_collectives(seen, cls is NaiveWP) if mesh.group else {
        "all_gather": 0, "all_reduce": 0}
    assert mesh.collectives == want


@pytest.mark.parametrize("cls", [NaiveBPE, NaiveWP])
@pytest.mark.parametrize("tier", ["compact", "full"])
def test_forced_tiers_graphed(cls, tier, corpus, mesh8, graphs):
    """The forced tier is the step's one graph: K4, K1 and the compaction,
    or K4, the gathered rows' K1 and K2; the JAX package's train forced
    to the same tier is the reference."""
    port = cls(mesh=mesh8, device="cpu")
    port._force_tier = tier
    port.train(corpus[:40], 140)
    assert_same(port, jax_train(cls, corpus[:40], 140, tier))
    assert port._sel_stats[tier] == sum(port._sel_stats.values()) > 30
    check_graphs(port, graphs)
    assert set(port._graph_stats["graphs"]) == {tier}
    assert {name for _, name, _ in graphs} == {tier}


def test_overflowing_cap_takes_the_full_tier(corpus, mesh8, graphs,
                                             monkeypatch):
    """A distinct-run cap of 4 overflows the compact tier on most steps:
    the full tier is replayed after the compact tier's replay, with the
    step's tables and weights as the replays left them."""
    monkeypatch.setattr(ptrain, "run_gather_cap", lambda n: 4)
    monkeypatch.setattr(jtrain, "run_gather_cap", lambda n: 4)
    port = NaiveBPE(mesh=mesh8, device="cpu")
    port.train(corpus[:100], 300)
    jax_tok = jax_train(NaiveBPE, corpus[:100], 300)
    assert_same(port, jax_tok)
    assert port._sel_stats["full"] > 100 and port._sel_stats["proven"] > 100
    check_graphs(port, graphs)
    assert set(port._graph_stats["graphs"]) == {"topk", "compact", "full"}


@pytest.mark.parametrize("cls", [NaiveBPE, NaiveWP])
@pytest.mark.parametrize("stop", ["max_vocab", "no_pair"])
def test_stops_graphed(cls, stop, corpus, mesh8, graphs):
    """A stop at ``max_vocab`` (the vocab exactly that size) and one where
    no pair is left (the last step's tiers find none)."""
    text, vocab = ((corpus[:20], 150) if stop == "max_vocab"
                   else (["aab abab aab ba", "abba baab"], 500))
    port = cls(mesh=mesh8, device="cpu")
    port.train(text, vocab)
    assert_same(port, jax_train(cls, text, vocab))
    if stop == "max_vocab":
        assert len(port.vocab) == vocab
    else:
        assert len(port.vocab) < vocab
        assert sum(port._sel_stats.values()) == len(merges(port)) + 1
    check_graphs(port, graphs)


@pytest.mark.parametrize("cls", [NaiveBPE, NaiveWP])
def test_resume_and_checkpoints_graphed(cls, corpus, mesh8, graphs,
                                        tmp_path, monkeypatch):
    """Checkpoints every 30 merges at the same merge counts graphed as
    step by step; a run resumed from the graphed run's checkpoint ends
    where the JAX package's uninterrupted sharded run does."""
    text = corpus[:80]
    saves = []
    name = "save_resources" if cls is NaiveBPE else "_save_checkpoint"
    real = getattr(cls, name)

    @functools.wraps(real)
    def save(self, *args):
        saves.append(len(merges(self)))
        return real(self, *args)

    monkeypatch.setattr(cls, name, save)
    part = cls(mesh=mesh8, device="cpu")
    part.train(text, 140, checkpoint_dir=str(tmp_path / "g"),
               checkpoint_every=30)
    assert part._graph_stats["replays"] > 0
    graphed_saves, saves[:] = saves[:], []
    GRAPHED[0] = False
    steps = cls(mesh=mesh8, device="cpu")
    steps.train(text, 140, checkpoint_dir=str(tmp_path / "s"),
                checkpoint_every=30)
    assert steps._graph_stats["replays"] == 0
    assert graphed_saves == saves and len(saves) >= 3
    assert merges(part) == merges(steps)
    GRAPHED[0] = True
    resumed = cls(mesh=mesh8, device="cpu")
    resumed.train(text, 200, checkpoint_dir=str(tmp_path / "g"),
                  resume=True)
    whole = jax_train(cls, text, 200)
    assert merges(resumed) == merges(whole)
    assert resumed.vocab == whole.vocab
    assert resumed.corpus_as_symbols == whole.corpus_as_symbols
    assert resumed._graph_stats["replays"] > 0


def _tables(rng, sizes, fill):
    """K1-like CPU tables: a fraction ``fill`` of entries live, with
    random keys, counts and positions."""
    out = []
    for T in sizes:
        keys = torch.full((T,), EMPTY_KEY, dtype=torch.int64)
        counts = torch.zeros(T, dtype=torch.int64)
        pos = torch.full((T,), -1, dtype=torch.int32)
        live = rng.random(T) < fill
        n = int(live.sum())
        keys[torch.from_numpy(live)] = torch.from_numpy(
            rng.integers(0, 1 << 40, size=n))
        counts[torch.from_numpy(live)] = torch.from_numpy(
            rng.integers(1, 1000, size=n))
        pos[torch.from_numpy(live)] = torch.from_numpy(
            rng.integers(0, 1 << 20, size=n).astype(np.int32))
        out.append((keys, counts, pos))
    return out


def test_compaction_epoch_across_the_restart():
    """The compaction's epoch is the TableSet's epoch word: with it and
    the host's count of calls set 4 below EPOCH_MAX, 10 compactions
    (three tables, one of three clusters) cross the restart of the
    epochs. Each call's runs equal the plain version's without the set;
    after each, the epoch word is one past the last (1 after the
    restart), each cluster's status word is inclusive with the epoch and
    the table's live entries up to its end, the flags are the tables'
    overflows, and the ticket and counters are 0."""
    rng = np.random.default_rng(18)
    sizes = (8192, 2 * ROUND_SPAN + 4096, 1024)
    tables = _tables(rng, sizes, 0.3)
    bases = [0, 1 << 22, 1 << 23]
    tset = TableSet(tables, bases)
    assert tset.clusters == 3
    start = EPOCH_MAX - 4
    tset.desc[tset.EPOCH] = start
    tset.calls = start
    epochs = []
    for i in range(10):
        cap = (4096, 64)[i % 2]
        got = compact_tables(tables, bases, cap, tset=tset)
        want = compact_tables_ref(tables, bases, cap)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        epochs.append(tset.epoch)
        d = tset.desc
        D = len(tables)
        assert not d[6 * D:6 * D + 1 + D].any()  # the ticket, counters
        status = tset.status.view(D, tset.clusters)
        for j, (keys, _, _) in enumerate(tables):
            live = keys != EMPTY_KEY
            assert int(d[6 * j + 5]) == int(int(live.sum()) > cap)
            T = keys.shape[0]
            n_c = -(-T // ROUND_SPAN)
            for c in range(tset.clusters):
                w = int(status[j, c]) & ((1 << 64) - 1)
                if c >= n_c:
                    assert w == 0
                    continue
                n = int(live[:min((c + 1) * ROUND_SPAN, T)].sum())
                assert w == K_INCLUSIVE | tset.epoch << 32 | n
        assert d[:6 * D:6].tolist() == [t[0].data_ptr() for t in tables]
    assert epochs == [EPOCH_MAX - 3, EPOCH_MAX - 2, EPOCH_MAX - 1,
                      EPOCH_MAX, 1, 2, 3, 4, 5, 6]
    assert tset.calls == 6


def test_compaction_epoch_room_before_a_capture(monkeypatch):
    """The restart zeroes the status words and the epoch word before the
    call that would pass EPOCH_MAX; inside a capture it raises instead,
    so the trainer makes room before each capture."""
    tables = _tables(np.random.default_rng(5), (4096,), 0.5)
    tset = TableSet(tables, [0])
    tset.calls = EPOCH_MAX
    tset.desc[tset.EPOCH] = EPOCH_MAX

    class OnTheCard:  # a descriptor on the card, as the capture sees it
        device = torch.device("cuda", 0)

    desc, tset.desc = tset.desc, OnTheCard()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="restart inside a capture"):
        tset.room(1)
    tset.desc = desc
    monkeypatch.undo()
    tset.room(1)
    assert tset.calls == 0 and tset.epoch == 0
    compact_tables(tables, [0], 16, tset=tset)
    assert tset.epoch == 1 and tset.calls == 1


# ---- the spy: every step of one key passes what its first step passed

def _held(obj, seen, out):
    """The tensors ``obj`` holds in its attributes, lists, tuples and
    dicts, recursively over the port's objects (not the tensors'
    own)."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
        return
    if id(obj) in seen or obj is None or isinstance(
            obj, (int, float, str, bool, np.ndarray, torch.device)):
        return
    seen.add(id(obj))
    if isinstance(obj, (list, tuple)):
        items = obj
    elif isinstance(obj, dict):
        items = obj.values()
    elif type(obj).__module__.startswith("subword_tokenizers_tpu_torch"):
        items = vars(obj).values()
    else:
        return
    for v in items:
        _held(v, seen, out)


class _Spy:
    """Each spied call's arguments: a Python scalar as it is, a tuple or
    list item by item, any other object by type and identity, a tensor
    by its address; once the run is over a tensor the trainer held at
    the start of every tier from a given one on (``holdings[since:]``:
    a key's buffers are made by its first tier) is kept by its address
    and any other is "made" (a plain version's output, which on the card
    is one of the trainer's buffers). Every tensor seen is kept alive, so
    no address is reused during the run."""

    def __init__(self):
        self.held = []
        self.holdings = []

    def arg(self, v):
        if isinstance(v, torch.Tensor):
            self.held.append(v)
            return ("tensor", v.untyped_storage().data_ptr(), v.data_ptr(),
                    tuple(v.shape))
        if isinstance(v, (tuple, list)):
            return tuple(self.arg(x) for x in v)
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        return (type(v).__name__, id(v))

    def args(self, args, kwargs):
        return tuple((name, self.arg(v)) for name, v in
                     [(None, a) for a in args] + sorted(kwargs.items()))

    def holding(self, trainer):
        ts = []
        _held(trainer, set(), ts)
        self.held += ts
        self.holdings.append({t.untyped_storage().data_ptr() for t in ts})

    def final(self, rec, since):
        if isinstance(rec, tuple) and rec and rec[0] == "tensor":
            later = self.holdings[since:]
            return ("at", rec[2], rec[3]) if later and all(
                rec[1] in h for h in later) else "made"
        if isinstance(rec, tuple):
            return tuple(self.final(x, since) for x in rec)
        return rec


SPIED = {ptrain: ("pair_rows", "nominate_tables", "lookup_reduce",
                  "compact_tables", "select_host_ids", "pair_stats_runs"),
         train_loop: ("symbol_rows", "pair_stats"),
         DataMesh: ("gather", "_reduce")}


@pytest.mark.parametrize("model,tier,route", [
    ("bpe", None, "local"), ("wp", None, "local"), ("wp", "compact", "local"),
    ("bpe", None, "gloo"), ("wp", "full", "gloo")])
def test_every_step_of_one_key_passes_the_same_arguments(
        monkeypatch, corpus, model, tier, route, request):
    """Every launch wrapper a tier calls and the mesh's collectives,
    spied, on a run step by step: each tier of one key
    (:meth:`ShardedTrainer._key`) passes identical scalars and tensors at
    identical addresses as that key's first tier (no host epoch, parity
    or counter that a replayed graph would repeat stale, and no buffer
    made or picked anew). On the gloo process-group mesh every gather
    writes into an output the corpus keeps (a reduction is in place on
    its part: on the CPU a plain version's output)."""
    spy = _Spy()
    calls, reals = [], {}
    for module, names in SPIED.items():
        for name in names:
            real = reals[name] = getattr(module, name)

            @functools.wraps(real)
            def wrapped(*args, _name=name, _real=real, **kwargs):
                calls.append((_name, spy.args(args, kwargs)))
                return _real(*args, **kwargs)

            monkeypatch.setattr(module, name, wrapped)
    by_tier = []
    real_tier = ptrain.ShardedTrainer._tier

    def tier_spy(self, name, head, eager):
        spy.holding(self)
        key = self._key(name, head)
        start = len(calls)
        got = real_tier(self, name, head, eager)
        by_tier.append((self.steps, key, calls[start:], len(spy.holdings)))
        return got

    monkeypatch.setattr(ptrain.ShardedTrainer, "_tier", tier_spy)
    cls = NaiveBPE if model == "bpe" else NaiveWP
    port = cls(mesh=mesh_for(route, request), device="cpu")
    port._force_tier = tier
    port.train(corpus[:200], 420 if model == "bpe" else 480)
    first, compared, since = {}, 0, {}
    for step, key, c, n in by_tier:
        c = spy.final(tuple(c), since.setdefault(key, n))
        names = {n for n, _ in c}
        assert "select_host_ids" in names
        if key in first:
            assert c == first[key], (step, key)
            compared += 1
        first.setdefault(key, c)
    assert compared > 100 and len(first) >= 2
    # the record and the tables of the block's two sets are passed by
    # their addresses
    held = {a[1] for c in first.values() for _, args in c for _, a in args
            if isinstance(a, tuple) and a and a[0] == "at"}
    assert len(held) >= 2
    heads = {k[1] for k in first}
    if tier:
        assert heads == {True}
    if model == "bpe":
        assert {k[0] for k in first} == {"topk", "compact"}
    names = [n for c in first.values() for n, _ in c]
    assert "gather" in names and "_reduce" in names
    # every launch wrapper a tier calls counts its captured launches at
    # each replay
    launched = {train_loop.select_unify if n == "select_host_ids" else
                reals[n] for n in names if n not in ("gather", "_reduce")}
    assert launched <= set(ptrain._STEP_WRAPPERS)
    if route == "gloo":
        outs = [dict(args)["out"] for c in first.values() for n, args in c
                if n == "gather"]
        assert outs and all(o[0] == "at" for o in outs), outs
