"""The port's training driver (ops/train_loop.py ``run_fused`` over a
``BlockRunner``) against the JAX package's ``run_fused``, on the
kernels' plain versions: two blocks in flight, the shrink decided from
the newest records read (a block late, as JAX's host sees them), the
block in flight drained and never read once the run stops. On the card
each block after a run's first is a CUDA graph replay, which only the
card runs; here the same driver steps each block through the plain
versions, and a spy on the wrappers' arguments stands in for replay
safety: every block of one width passes the same scalars, and the same
addresses of the buffers the run keeps, at every step, so a graph of
one replays the others. K3's epochs and the skip
route's gate are device words (ops/flat.MergeScratch), and the plain
versions that follow them stay equal to JAX's ``flat_apply``,
``flat_skip_apply`` and ``compact_flat`` across the epochs' restart.

Every comparison is exact: merges, vocab, the callbacks' calls and step
counts, the widths of the dispatched blocks, and states."""
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subword_tokenizers_tpu.core.corpus import build_bpe_corpus as jbpe
from subword_tokenizers_tpu.core.corpus import build_wp_corpus as jwp
from subword_tokenizers_tpu.core.symbols import SymbolTable as JTable
from subword_tokenizers_tpu.ops import flat as jflat
from subword_tokenizers_tpu.ops import train_loop as jtl
from subword_tokenizers_tpu_torch import NaiveBPE
from subword_tokenizers_tpu_torch.benchmarks import profiling
from subword_tokenizers_tpu_torch.core.corpus import (build_bpe_corpus,
                                                      build_wp_corpus,
                                                      unique_words)
from subword_tokenizers_tpu_torch.core.symbols import SymbolTable
from subword_tokenizers_tpu_torch.ops import flat, train_loop
from subword_tokenizers_tpu_torch.ops.flat import (EPOCH, EPOCH_MAX, GATE,
                                                   N_LIVE, TILE, WID_PAD,
                                                   MergeScratch, build_flat)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A shrink floor low enough that the slices below halve their width
# between blocks (the trainers' floor is 8,192), in both packages.
FLAT_MIN = 256


def _words(n_sentences):
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        corpus = json.load(f)[:n_sentences]
    return unique_words(NaiveBPE(device="cpu").preprocessing_batch(corpus))[:2]


TINY = ["the cat sat on the mat", "aaaa aaa aa a", "banana bandana",
        "mississippi miss sip"]


def _run_both(monkeypatch, words, freq, wordpiece, route, K, vocab_add,
              tournament=False):
    """The port's and JAX's run_fused from one word list, each recording
    its merges, the callbacks' step counts and the width of every block
    it dispatches. Returns ({...}, {...}) of the two."""
    monkeypatch.setattr(jtl, "_FLAT_MIN", FLAT_MIN)
    monkeypatch.setattr(train_loop, "_FLAT_MIN", FLAT_MIN)
    monkeypatch.setenv("SWT_WP_TOURNAMENT", "1" if tournament else "0")
    flat_route = route != "padded"
    skip = int(route[4:]) if route.startswith("skip") else 0
    out = []
    for side in ("port", "jax"):
        rec = {"merges": [], "progress": [], "ckpt": [], "widths": []}
        on_merge = (lambda sa, sb, m, r=rec: r["merges"].append((sa, sb, m)))
        if side == "port":
            table = SymbolTable()
            arrays = (build_wp_corpus if wordpiece else build_bpe_corpus)(
                words, freq, table)
            state = train_loop.FlatState(*build_flat(arrays.sym,
                                                     arrays.freq), "cpu")
            real = train_loop.BlockRunner.dispatch

            def dispatch(self, slot, r=rec, real=real):
                r["widths"].append(getattr(self.state, "F", -1))
                return real(self, slot)

            monkeypatch.setattr(train_loop.BlockRunner, "dispatch", dispatch)
            final = train_loop.run_fused(
                state, table, len(table) + vocab_add, arrays.sym.shape[1],
                on_merge, K=K, checkpoint_cb=rec["ckpt"].append,
                progress_cb=rec["progress"].append, wordpiece=wordpiece,
                flat=flat_route, skip=skip)
            monkeypatch.setattr(train_loop.BlockRunner, "dispatch", real)
        else:
            table = JTable()
            arrays = (jwp if wordpiece else jbpe)(words, freq, table)
            name = "flat_train_steps" if flat_route else "train_steps"
            real = getattr(jtl, name)

            def steps(*args, r=rec, real=real, **kwargs):
                r["widths"].append(int(args[0].shape[0]) if flat_route
                                   else -1)
                return real(*args, **kwargs)

            monkeypatch.setattr(jtl, name, steps)
            final = jtl.run_fused(
                jnp.asarray(arrays.sym), jnp.asarray(arrays.freq), table,
                len(table) + vocab_add, False, wordpiece, on_merge, K=K,
                checkpoint_cb=rec["ckpt"].append,
                progress_cb=rec["progress"].append, flat=flat_route,
                skip=skip)
            monkeypatch.setattr(jtl, name, real)
        rec["vocab"] = sorted(table.strings())
        rec["final"] = np.asarray(final)
        out.append(rec)
    return out


def _same(port, jax_side):
    assert port["merges"] == jax_side["merges"]
    assert port["vocab"] == jax_side["vocab"]
    assert port["progress"] == jax_side["progress"]
    assert port["ckpt"] == jax_side["ckpt"]
    assert port["widths"] == jax_side["widths"]
    assert np.array_equal(port["final"], jax_side["final"])


# (model, route, K): every route of run_fused, BPE and WordPiece, K = 4
# and 8; the slice runs 70 merges, so many blocks, a shrink and a drain
ROUTES = [("bpe", "flat", 4), ("wp", "flat", 8), ("bpe", "skip1", 8),
          ("wp", "skip1", 4), ("bpe", "skip2", 4), ("wp", "skip2", 8),
          ("bpe", "skip12", 8), ("wp", "skip12", 4), ("bpe", "padded", 8),
          ("wp", "padded", 4), ("wp", "tournament", 4),
          ("wp", "tournament", 8)]


@pytest.mark.parametrize("model,route,K", ROUTES)
def test_run_fused_matches_jax(monkeypatch, model, route, K):
    """The same merges, vocab, final state, on_merge calls, progress and
    checkpoint step counts and dispatched widths (the lagged shrink, two
    blocks in flight, the drain) as the JAX package's run_fused."""
    words, freq = _words(15)
    port, jax_side = _run_both(
        monkeypatch, words, freq, model == "wp",
        "flat" if route == "tournament" else route, K, 70,
        tournament=route == "tournament")
    _same(port, jax_side)
    assert len(port["merges"]) == 70
    widths = port["widths"]
    if route != "padded":
        assert widths[0] > widths[-1] >= FLAT_MIN  # it shrank
    # one block past the last one read: the drain
    assert len(widths) == -(-70 // K) + 1


@pytest.mark.parametrize("stop", ["first_block", "block_end", "inside",
                                  "exhausted"])
@pytest.mark.parametrize("route", ["flat", "skip2"])
def test_stops_match_jax(monkeypatch, stop, route):
    """A stop at the first block (max_vocab reached in it), exactly at a
    block's end, inside a block, and a corpus that runs out of pairs
    inside a block: the callbacks and the drained block as JAX's."""
    K = 8
    words, freq = _words(40) if stop != "exhausted" else unique_words(
        NaiveBPE(device="cpu").preprocessing_batch(TINY))[:2]
    add = {"first_block": 3, "block_end": 3 * K, "inside": 2 * K + 5,
           "exhausted": 10_000}[stop]
    port, jax_side = _run_both(monkeypatch, words, freq, False, route, K,
                               add)
    _same(port, jax_side)
    n = len(port["merges"])
    if stop == "exhausted":
        assert 0 < n < add and n % K
    else:
        assert n == add
    assert port["progress"] == [min(K, n - i) for i in range(0, n, K)]
    # the blocks that merged, then the one in flight, drained
    assert len(port["widths"]) == -(-n // K) + 1


def test_block_records_and_stats_rows():
    """A BlockRunner's records: K step rows, the closing compaction's row
    (the skip route's live slots), and the run's counts in row K + 1; on
    the CPU every block is queued step by step and no graph is made."""
    words, freq = _words(40)
    table = SymbolTable()
    arrays = build_bpe_corpus(words, freq, table)
    state = train_loop.FlatState(*build_flat(arrays.sym, arrays.freq),
                                 "cpu")
    eager = profiling.counter("train.eager_blocks")
    captures = profiling.counter("train.graph_captures")
    run = train_loop.BlockRunner(state, table, len(table) + 100,
                                 arrays.sym.shape[1], 4, False, True, 2,
                                 False)
    assert run.graphs is None and run.recs.shape == (6, 6)
    assert run.stats.data_ptr() == run.recs[5].data_ptr()
    run.dispatch(0)
    run.dispatch(1)
    first, second = run.fetch(0), run.fetch(1)
    assert first[:4, 4].all() and second[:4, 4].all()
    live = int((state.arrays()[0] >= 0).sum())
    assert second[4, N_LIVE] == live and second[4, 4] == 0
    assert profiling.counter("train.eager_blocks") == eager + 2
    assert profiling.counter("train.graph_captures") == captures
    run.close()


def _tensors(v):
    """The tensors in ``v``: itself, or those of a list or tuple's items."""
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (list, tuple)):
        return [t for x in v for t in _tensors(x)]
    return []


def _reachable(*objs):
    """The tensors objects hold in their attributes, directly or in lists
    and tuples (the runner's, the state's, the scratch's)."""
    return [t for obj in objs for v in vars(obj).values()
            for t in _tensors(v)]


class _Spy:
    """Each spied call's arguments as the spy keeps them: a Python scalar
    as it is, a tuple item by item, any other object by type and
    identity, and a tensor by its address, of which the storage is
    classified once the run is over. Every tensor seen is kept alive, so
    no address is reused during the run."""

    def __init__(self):
        self.held = []
        self.persistent = None  # storages the runner held at every block

    def arg(self, v):
        if isinstance(v, torch.Tensor):
            self.held.append(v)
            return ("tensor", v.untyped_storage().data_ptr(), v.data_ptr())
        if isinstance(v, tuple):
            return tuple(self.arg(x) for x in v)
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        return (type(v).__name__, id(v))

    def args(self, args, kwargs):
        return tuple((name, self.arg(v)) for name, v in
                     [(None, a) for a in args] + sorted(kwargs.items()))

    def holding(self, runner):
        """Note the storages ``runner`` and its state hold now."""
        ts = _reachable(runner, runner.state, *(
            [runner.state.scratch] if hasattr(runner.state, "scratch")
            else []))
        self.held += ts
        now = {t.untyped_storage().data_ptr() for t in ts}
        self.persistent = now if self.persistent is None else \
            self.persistent & now

    def final(self, rec):
        """A recorded argument with each tensor as the launch takes it: a
        buffer the run keeps (the state's two buffers, the records, the
        scratch, the hash tables, WordPiece's weights) by its address,
        and a tensor made in the block by a plain version (K1's table,
        K4's count; on the card one of two buffers chosen by the parity
        that ``state.host_key()`` holds) as such."""
        if isinstance(rec, tuple) and rec and rec[0] == "tensor":
            return ("at", rec[2]) if rec[1] in self.persistent else "made"
        if isinstance(rec, tuple):
            return tuple(self.final(x) for x in rec)
        return rec


SPIED = ("merge_apply", "merge_skip", "skip_guard", "select_unify",
         "pair_stats", "symbol_rows", "apply_merge")


@pytest.mark.parametrize("model,route", [("bpe", "flat"),
                                         ("wp", "skip12"),
                                         ("bpe", "skip2"),
                                         ("wp", "padded"),
                                         ("wp", "tournament")])
def test_consecutive_blocks_pass_the_same_scalars(monkeypatch, model,
                                                  route):
    """Every wrapper a block calls, spied: every block of one width (the
    key of a block's CUDA graph) passes identical scalars, and tensors at
    identical addresses, at each step as the first block of that width
    (no host epoch, gate or counter that a replayed graph would repeat
    stale, and no buffer picked by a parity that moves between blocks)."""
    monkeypatch.setattr(train_loop, "_FLAT_MIN", FLAT_MIN)
    monkeypatch.setenv("SWT_WP_TOURNAMENT",
                       "1" if route == "tournament" else "0")
    spy_log = _Spy()
    calls = []
    for name in SPIED:
        real = getattr(train_loop, name)

        @functools.wraps(real)  # its counters too, which run_fused adds to
        def spy(*args, _name=name, _real=real, **kwargs):
            calls.append((_name, spy_log.args(args, kwargs)))
            return _real(*args, **kwargs)

        monkeypatch.setattr(train_loop, name, spy)
    blocks = []
    real_dispatch = train_loop.BlockRunner.dispatch

    def dispatch(self, slot):
        spy_log.holding(self)
        start = len(calls)
        real_dispatch(self, slot)
        blocks.append((getattr(self.state, "F", -1), calls[start:]))

    monkeypatch.setattr(train_loop.BlockRunner, "dispatch", dispatch)
    words, freq = _words(15)
    table = SymbolTable()
    wordpiece = model == "wp"
    arrays = (build_wp_corpus if wordpiece else build_bpe_corpus)(
        words, freq, table)
    state = train_loop.FlatState(*build_flat(arrays.sym, arrays.freq), "cpu")
    train_loop.run_fused(state, table, len(table) + 60, arrays.sym.shape[1],
                         lambda *m: None, K=4, wordpiece=wordpiece,
                         flat=route != "padded",
                         skip=int(route[4:]) if route.startswith("skip")
                         else 0)
    blocks = [(F, spy_log.final(tuple(c))) for F, c in blocks]
    first = {}
    compared = 0
    for F, c in blocks:
        assert c and {n for n, _ in c} >= {"select_unify", "pair_stats"}
        if F in first:
            assert c == first[F]
            compared += 1
        first.setdefault(F, c)
    assert compared >= 3
    # the state's buffers and the records are passed by address
    assert any(a[0] == "at" for _, c in blocks for _, args in c
               for _, a in args if isinstance(a, tuple) and a)
    names = {n for _, c in blocks for n, _ in c}
    want = {"flat": {"pair_stats", "select_unify", "merge_apply"},
            "tournament": {"pair_stats", "select_unify", "merge_apply"},
            "skip12": {"pair_stats", "select_unify", "merge_skip",
                       "skip_guard"},
            "skip2": {"pair_stats", "select_unify", "merge_skip",
                      "skip_guard"},
            "padded": {"pair_stats", "select_unify", "symbol_rows",
                       "apply_merge"}}[route]
    assert names == want


def _tile_state(seed, F=3 * TILE + 640):
    """A seeded flat state across K3's tiles with gaps of 70 dead slots at
    the tile edges (a window of 2 overflows there)."""
    rng = np.random.default_rng(seed)
    fs = np.full(F, -1, np.int32)
    wid = np.full(F, WID_PAD, np.int32)
    pos, w = 0, 0
    while pos < F - 20:
        n = int(rng.integers(1, 12))
        fs[pos:pos + n] = rng.integers(0, 3, size=n)
        wid[pos:pos + n] = w
        pos, w = pos + n, w + 1
    dead = np.zeros(F, bool)
    for e in range(TILE, F, TILE):
        dead[e - 70:e] = True
    dead &= fs >= 0
    fs[dead], wid[dead] = -1, WID_PAD
    wgt = np.where(fs >= 0, 1 + wid.astype(np.int64) % 5, 0)
    return fs, wid, wgt


@pytest.mark.parametrize("start", [0, EPOCH_MAX - 3])
def test_device_epochs_across_the_restart_match_jax(start):
    """K3, K3's skip mode and the guard with the epoch word and the host's
    count of calls at ``start``: a skip step, the guard, a compacting
    merge, again and again, through the restart of the epochs before
    EPOCH_MAX. Each state equals JAX's flat_skip_apply, compact_flat (when
    skip_overflow holds) and flat_apply; the epoch word counts the calls
    that ran, the gate opens and closes as JAX's lax.cond decides."""
    fs, wid, wgt = _tile_state(7)
    sc = MergeScratch(fs.shape[0], "cpu")
    sc.words[EPOCH] = start
    sc.calls = start
    cur = [torch.from_numpy(x.copy()) for x in (fs, wid, wgt)]
    new_id = 40
    epoch = start
    restarted = False
    for step in range(6):
        a, b = int(cur[0][cur[0] >= 0][0]), int(cur[0][cur[0] >= 0][1])
        # copies: JAX on the CPU may alias a NumPy array's memory and read
        # it later, and the plain versions change these tensors in place
        j = [jnp.asarray(x.numpy().copy()) for x in cur]
        nsym, nwid = jflat.skip_next(j[0], j[1], 2)
        cpos = jnp.cumsum((j[0] >= 0).astype(jnp.int32)) - 1
        want = jflat.flat_skip_apply(*j, nsym, nwid, cpos, a, b, new_id, 2)
        rec = torch.tensor([a, b, new_id, 0, 1, 0], dtype=torch.int32)
        before = sc.calls
        flat.merge_skip(*cur, rec, 2, scratch=sc)
        restarted |= sc.calls < before
        epoch = 1 if sc.calls < before else epoch + 1
        for g, w in zip(cur, want[:3]):
            assert np.array_equal(g.numpy(), np.asarray(w))
        ovf = bool(jflat.skip_overflow(*(jnp.asarray(x.numpy().copy())
                                         for x in cur[:2]), 2))
        assert sc.epoch == epoch and int(sc.words[0]) == int(want[3])
        assert int(sc.words[GATE]) == epoch << 1 | int(ovf)
        count = torch.zeros(1, dtype=torch.int32)
        comp = jflat.compact_flat(*(jnp.asarray(x.numpy().copy())
                                    for x in cur))
        before = sc.calls
        flat.skip_guard(*cur, count, sc)
        restarted |= sc.calls < before
        if sc.calls < before:
            epoch = 0
        epoch += int(ovf)
        assert int(count) == int(ovf) and sc.epoch == epoch
        if ovf:
            for g, w in zip(cur, comp):
                assert np.array_equal(g.numpy(), np.asarray(w))
            assert int(sc.words[GATE]) == 0
        a, b = int(cur[0][cur[0] >= 0][0]), int(cur[0][cur[0] >= 0][1])
        want = jflat.flat_apply(*(jnp.asarray(x.numpy().copy())
                                  for x in cur), a, b, new_id + 1)
        rec = torch.tensor([a, b, new_id + 1, 0, 1, 0], dtype=torch.int32)
        before = sc.calls
        got = flat.merge_apply(*cur, rec, scratch=sc)
        restarted |= sc.calls < before
        epoch = 1 if sc.calls < before else epoch + 1
        cur = [g.clone() for g in got[:3]]
        for g, w in zip(cur, want[:3]):
            assert np.array_equal(g.numpy(), np.asarray(w))
        assert int(got[3]) == int(want[3]) and sc.epoch == epoch
        assert int(sc.words[GATE]) == 0
        new_id += 2
    assert restarted == (start > 0)
    assert sc.epoch < 20


def test_hash_collision_raises_after_the_block_in_flight(monkeypatch):
    """A record that disagrees with interning raises HashCollision once
    the block in flight has been drained; the merges before it were
    reported, as today."""
    seen = []

    class Colliding(SymbolTable):
        """Interning that disagrees with the device at the sixth merge."""
        armed = False

        def intern(self, s):
            i = super().intern(s)
            return i + 1 if self.armed and len(seen) == 5 else i

    words, freq = _words(40)
    table = Colliding()
    arrays = build_bpe_corpus(words, freq, table)
    state = train_loop.FlatState(*build_flat(arrays.sym, arrays.freq), "cpu")
    table.armed = True
    dispatched, drained = [], []
    real_dispatch = train_loop.BlockRunner.dispatch
    real_drain = train_loop.BlockRunner.drain
    monkeypatch.setattr(train_loop.BlockRunner, "dispatch",
                        lambda self, slot: (dispatched.append(slot),
                                            real_dispatch(self, slot)))
    monkeypatch.setattr(train_loop.BlockRunner, "drain",
                        lambda self: (drained.append(len(dispatched)),
                                      real_drain(self)))
    with pytest.raises(train_loop.HashCollision):
        train_loop.run_fused(state, table, len(table) + 40,
                             arrays.sym.shape[1],
                             lambda *m: seen.append(m), K=4)
    assert len(seen) == 5 and dispatched == [0, 1, 0]
    assert drained and drained[0] == 3
