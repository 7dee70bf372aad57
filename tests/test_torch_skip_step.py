"""A step of the port's skip route (ops/flat.py ``merge_skip`` with its
gate word, ``skip_guard`` and the ``MergeScratch`` they share) against
the JAX package's ``flat_skip_apply``, ``skip_overflow``,
``compact_flat`` and ``flat_train_steps``, on the kernels' plain
versions. Every comparison is exact: states, match weights, carried
symbol weights, gate words, merges and the number of overflow
compactions.

The states are cut at the kernels' tile edges (2,048 slots): self-merge
runs longer than a tile that cross two edges, and gaps wider than the
window right at an edge and inside the 68 slots each tile stages from
its neighbours."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subword_tokenizers_tpu import NaiveBPE as JaxNaiveBPE
from subword_tokenizers_tpu import NaiveWP as JaxNaiveWP
from subword_tokenizers_tpu.ops import flat as jflat
from subword_tokenizers_tpu.ops import train_loop as jtrain_loop
from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.benchmarks import profiling
from subword_tokenizers_tpu_torch.ops import flat, train_loop
from subword_tokenizers_tpu_torch.ops.flat import (EPOCH, EPOCH_MAX, GATE,
                                                   N_LIVE, TILE, WID_PAD,
                                                   MergeScratch)
from subword_tokenizers_tpu_torch.ops.pairstats import pair_stats

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOWS = (1, 2, 12, 64)


def _kill(fs, wid, wgt, dead):
    fs[dead], wid[dead], wgt[dead] = -1, WID_PAD, 0


def tile_state(kind, seed):
    """A seeded flat state (numpy fs, wid, wgt) of three tiles and a
    ragged fourth: ``runs`` holds words of one symbol 3,000 long that
    cross the tile edges at 2,048 and 4,096 (dead slots inside), ``edge``
    gaps of 70 dead slots ending right at each edge and starting right
    after it, ``halo`` gaps of 30 inside the 68 slots before and after
    each edge, ``holes`` a share of dead slots everywhere."""
    rng = np.random.default_rng(seed)
    F = 3 * TILE + 640
    fs = np.full(F, -1, np.int32)
    wid = np.full(F, WID_PAD, np.int32)
    pos, w = 0, 0
    while pos < F - 40:
        if kind == "runs" and w % 3 == 1:
            n, s = 3000, 0
            syms = np.full(n, s, np.int32)
            syms[rng.random(n) < 0.05] = 1  # a few breaks in the run
        else:
            n = int(rng.integers(1, 12))
            syms = rng.integers(0, 3, size=n).astype(np.int32)
        n = min(n, F - 40 - pos)
        fs[pos:pos + n] = syms[:n]
        wid[pos:pos + n] = w
        pos += n
        w += 1
    wgt = np.where(fs >= 0, 1 + wid.astype(np.int64) % 5, 0)
    _kill(fs, wid, wgt, (rng.random(F) < (0.05 if kind == "runs" else 0.3))
          & (fs >= 0))
    for e in (TILE, 2 * TILE, 3 * TILE):
        if kind == "edge":
            _kill(fs, wid, wgt, slice(e - 70, e))
            _kill(fs, wid, wgt, slice(e + 1, e + 71))
        elif kind == "halo":
            _kill(fs, wid, wgt, slice(e - 50, e - 20))
            _kill(fs, wid, wgt, slice(e + 20, e + 50))
    return fs, wid, wgt


KINDS = ("holes", "runs", "edge", "halo")


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _records(fs, wgt, S):
    """(a, b, active) to merge on one state: the most frequent skip
    pair, the most common symbol with itself, and an inactive step."""
    keys, counts, _ = pair_stats(*_t(fs, np.zeros_like(fs), wgt), skip=S)
    top = int(keys[counts.argmax()])
    mode = int(np.bincount(fs[fs >= 0]).argmax())
    return [(top >> 32, top & 0xFFFFFFFF, 1), (mode, mode, 1),
            (top >> 32, top & 0xFFFFFFFF, 0)]


def _jax_step(fs, wid, wgt, a, b, active, new_id, S):
    """JAX's flat_skip_apply, then its skip_overflow of the state it
    leaves: (fs, wid, wgt, n_rep, overflow)."""
    j = [jnp.asarray(x) for x in (fs, wid, wgt)]
    nsym, nwid = jflat.skip_next(j[0], j[1], S)
    cpos = jnp.cumsum((j[0] >= 0).astype(jnp.int32)) - 1
    out = [np.asarray(x) for x in jflat.flat_skip_apply(
        *j, nsym, nwid, cpos, a if active else -3, b if active else -3,
        new_id, S)]
    ovf = bool(jflat.skip_overflow(jnp.asarray(out[0]), jnp.asarray(out[1]),
                                   S))
    return (*out, ovf)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("S", WINDOWS)
def test_merge_gate_and_guard_match_jax(kind, S):
    """Each record on the state: the merge in place, its weight, the
    carried weights and the gate word equal JAX's flat_skip_apply and
    skip_overflow; the guard then compacts exactly when JAX's lax.cond
    would, as compact_flat does, and counts it."""
    fs, wid, wgt = tile_state(kind, seed=S)
    new_id = 40
    sc = MergeScratch(fs.shape[0], "cpu")
    count = torch.zeros(1, dtype=torch.int32)
    fired = epochs = 0
    for a, b, active in _records(fs, wgt, S):
        want = _jax_step(fs, wid, wgt, a, b, active, new_id, S)
        got = _t(fs, wid, wgt)
        rec = torch.tensor([a, b, new_id, 0, active, 0], dtype=torch.int32)
        sf = torch.zeros(64, dtype=torch.int64).index_add_(
            0, torch.from_numpy(np.where(fs >= 0, fs, 63)).long(),
            torch.from_numpy(wgt))
        sf_want = sf.clone()
        n_rep = flat.merge_skip(*got, rec, S, sym_freq=sf, scratch=sc)
        for g, w in zip(got, want[:3]):
            assert np.array_equal(g.numpy(), w)
        assert int(n_rep) == int(want[3])
        if active:
            sf_want[a] -= int(want[3])
            sf_want[b] -= int(want[3])
            sf_want[new_id] += int(want[3])
        assert torch.equal(sf, sf_want)
        epochs += 1  # the device's epoch word, advanced by the merge
        assert sc.epoch == epochs
        assert int(sc.words[GATE]) == sc.epoch << 1 | int(want[4])
        before = int(count)
        flat.skip_guard(*got, count, sc)
        comp = (jflat.compact_flat(*(jnp.asarray(x) for x in want[:3]))
                if want[4] else want[:3])
        for g, w in zip(got, comp):
            assert np.array_equal(g.numpy(), np.asarray(w))
        assert int(count) - before == int(want[4])
        assert not int(sc.words[GATE]) & 1  # closed
        epochs += int(want[4])  # and by the guard when it fired
        assert sc.epoch == epochs
        fired += int(want[4])
    if kind in ("edge", "halo") and S < 20:
        assert fired  # the gaps overflow a narrow window


def test_runs_cross_tile_edges():
    """The self-merge state holds runs of one symbol longer than a tile
    across both edges, and their merge pairs every second slot there as
    JAX does."""
    fs, wid, wgt = tile_state("runs", seed=5)
    for e in (TILE, 2 * TILE):
        seg = fs[e - 40:e + 40]
        assert (seg[seg >= 0] == 0).mean() > 0.8
        assert len(set(wid[e - 40:e + 40][seg >= 0].tolist())) == 1
    got = _t(fs, wid, wgt)
    rec = torch.tensor([0, 0, 40, 0, 1, 0], dtype=torch.int32)
    flat.merge_skip(*got, rec, 12)
    want = _jax_step(fs, wid, wgt, 0, 0, 1, 40, 12)
    assert np.array_equal(got[0].numpy(), want[0])
    assert int((want[0][TILE - 200:TILE + 200] == 40).sum()) > 100


def test_gate_closed_after_block_close():
    """The block's close (a compaction in place, whatever the gate)
    closes the gate of the skip merge before it, so the next block's
    first guard does nothing, as JAX compacts at the block's end and
    tests the next step's dense state; without the close the guard
    fires. The close equals JAX's compact_flat, leaves the state in its
    buffers and its live slots in its record; a compacting merge closes
    the gate too."""
    fs, wid, wgt = tile_state("edge", seed=1)
    idle = torch.zeros(6, dtype=torch.int32)
    counts = []
    for close in (False, True):
        st = train_loop.FlatState(fs.copy(), wid.copy(), wgt.copy(), "cpu")
        st.merge(idle, skip=2)
        assert int(st.scratch.words[GATE]) & 1
        if close:
            rec = torch.zeros(6, dtype=torch.int32)
            bufs = st._cur
            # a copy: JAX on the CPU may alias the array and read it
            # after the close has changed it in place
            want = jflat.compact_flat(*(jnp.asarray(x.numpy().copy())
                                        for x in st.arrays()))
            st.close(rec)
            assert int(st.scratch.words[GATE]) == 0 and st._cur == bufs
            for g, w in zip(st.arrays(), want):
                assert np.array_equal(g.numpy(), np.asarray(w))
            assert int(rec[N_LIVE]) == int((st.arrays()[0] >= 0).sum())
        count = torch.zeros(1, dtype=torch.int32)
        before = st.arrays()[0].clone()
        st.guard(count)
        counts.append(int(count))
        live = before[before >= 0]
        n = live.shape[0]
        assert torch.equal(st.arrays()[0][:n], live)
    assert counts == [1, 0]
    st = train_loop.FlatState(fs.copy(), wid.copy(), wgt.copy(), "cpu")
    st.merge(idle, skip=2)
    st.merge(idle)
    assert int(st.scratch.words[GATE]) == 0


def test_narrower_state_with_the_same_scratch():
    """A state whose width was lowered between blocks (the dead tail cut
    off) keeps its scratch: the merges and gates at the lower width equal
    JAX's; a scratch narrower than the state is refused."""
    fs, wid, wgt = tile_state("holes", seed=2)
    F0 = fs.shape[0] + 3 * TILE
    pad = F0 - fs.shape[0]
    wide = (np.concatenate([fs, np.full(pad, -1, np.int32)]),
            np.concatenate([wid, np.full(pad, WID_PAD, np.int32)]),
            np.concatenate([wgt, np.zeros(pad, np.int64)]))
    st = train_loop.FlatState(*wide, "cpu")
    sc = st.scratch
    assert sc.words.shape[0] == 4 + 2 * -(-F0 // TILE)
    for block in range(3):
        # the tail cut: padding only, as the trainer's halving cuts it
        st.F = (F0, fs.shape[0])[block] if block < 2 else int(
            (st.arrays()[0] >= 0).sum()) + 5
        cur = [x.numpy().copy() for x in st.arrays()]
        for a, b, active in _records(*cur[::2], 12)[:2]:
            want = _jax_step(*cur, a, b, active, 41, 12)
            rec = torch.tensor([a, b, 41, 0, active, 0], dtype=torch.int32)
            st.merge(rec, skip=12)
            cur = [x.numpy().copy() for x in st.arrays()]
            for g, w in zip(cur, want[:3]):
                assert np.array_equal(g, w)
            assert int(sc.words[GATE]) == sc.epoch << 1 | int(want[4])
        count = torch.zeros(1, dtype=torch.int32)
        st.guard(count)
        st.close(torch.zeros(6, dtype=torch.int32))  # the block's close
    with pytest.raises(ValueError, match="scratch for a width below"):
        flat.merge_skip(*_t(*wide), torch.zeros(6, dtype=torch.int32), 12,
                        scratch=MergeScratch(F0 - TILE, "cpu"))


def test_epoch_wrap_keeps_the_gate():
    """Each call's epoch is one past the device's epoch word, 1 ..
    EPOCH_MAX; before the host's count of calls would pass EPOCH_MAX the
    epochs restart: the epoch word and the look-back words are zeroed and
    the gate word is kept, so a guard right after the restart still reads
    the gate of the merge before it (and, having fired, closes it)."""
    fs, wid, wgt = tile_state("edge", seed=3)
    sc = MergeScratch(fs.shape[0], "cpu")
    tiles = -(-fs.shape[0] // TILE)
    assert sc.words.shape == (4 + 2 * tiles,) and sc.epoch == 0
    assert int(sc.words[GATE]) == 0 and sc.calls == 0
    sc.words[EPOCH] = EPOCH_MAX - 1
    sc.calls = EPOCH_MAX - 1
    got = _t(fs, wid, wgt)
    idle = torch.zeros(6, dtype=torch.int32)
    flat.merge_skip(*got, idle, 2, scratch=sc)
    assert sc.epoch == sc.calls == EPOCH_MAX
    assert int(sc.words[GATE]) == EPOCH_MAX << 1 | 1
    sc.words[4:] = 7
    count = torch.zeros(1, dtype=torch.int32)
    flat.skip_guard(*got, count, sc)  # the epochs restart: it takes 1
    assert sc.epoch == sc.calls == 1 and int(count) == 1
    assert sc.words[4:].tolist() == [0] * (2 * tiles)
    assert int(sc.words[GATE]) == 0
    live = fs[fs >= 0]
    assert np.array_equal(got[0][:live.shape[0]].numpy(), live)
    flat.merge_skip(*got, idle, 2, scratch=sc)
    assert sc.epoch == 2 and int(sc.words[GATE]) == 2 << 1
    flat.skip_guard(*got, count, sc)
    assert int(count) == 1 and sc.epoch == 2


@pytest.mark.parametrize("case", ["type", "window", "device", "shape"])
def test_skip_wrappers_refuse_bad_arguments(case):
    fs, wid, wgt = _t(*tile_state("holes", seed=4))
    rec = torch.zeros(6, dtype=torch.int32)
    count = torch.zeros(1, dtype=torch.int32)
    F = fs.shape[0]
    if case == "type":
        words = MergeScratch(F, "cpu").words
        with pytest.raises(TypeError, match="must be a MergeScratch"):
            flat.merge_skip(fs, wid, wgt, rec, 2, scratch=words)
        with pytest.raises(TypeError, match="must be a MergeScratch"):
            flat.skip_guard(fs, wid, wgt, count, words)
    elif case == "window":
        for S in (0, 65):
            with pytest.raises(ValueError, match="window"):
                flat.merge_skip(fs, wid, wgt, rec, S)
        flat.merge_skip(fs, wid, wgt, rec, 64)
    elif case == "device":
        sc = MergeScratch(F, "meta")
        with pytest.raises(ValueError, match="scratch on meta"):
            flat.skip_guard(fs, wid, wgt, count, sc)
    else:
        with pytest.raises(ValueError, match="inconsistent shapes"):
            flat.skip_guard(fs, wid[:-1], wgt, count, MergeScratch(F, "cpu"))


def _corpus():
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        return json.load(f)[:400]


@pytest.mark.parametrize("skip", [2, 12])
@pytest.mark.parametrize("port_cls,jax_cls", [(NaiveBPE, JaxNaiveBPE),
                                              (NaiveWP, JaxNaiveWP)])
def test_train_slice_merges_states_and_overflows_match_jax(
        monkeypatch, port_cls, jax_cls, skip):
    """A train on a train-85k slice: the same merges and final state as
    the JAX package's, and as many overflow compactions as the sum of
    its ``rec["ovf"]`` (flat_train_steps with ``count_ovf=True``)."""
    corpus = _corpus()
    monkeypatch.setenv("SWT_SKIP_COMPACT", str(skip))
    ovf = []
    real = jtrain_loop.flat_train_steps

    def counting(*args, **kwargs):
        carry, recs = real(*args, **{**kwargs, "count_ovf": True})
        recs = dict(recs)
        ovf.append(int(np.asarray(recs.pop("ovf")).sum()))
        return carry, recs

    monkeypatch.setattr(jtrain_loop, "flat_train_steps", counting)
    jax_tok = jax_cls()
    jax_tok.train(corpus, 300)
    fired = profiling.counter("train.overflow_compactions")
    port = port_cls(device="cpu")
    port.train(corpus, 300)
    fired = profiling.counter("train.overflow_compactions") - fired
    log = "merges_list" if port_cls is NaiveBPE else "_merge_log"
    assert getattr(port, log) == getattr(jax_tok, log)
    assert port.vocab == jax_tok.vocab
    assert port.corpus_as_symbols == jax_tok.corpus_as_symbols
    assert ovf and fired == sum(ovf)
    if skip == 2:
        assert fired


def test_ctypes_signatures_match_the_c_entry_points():
    """Every C entry point's ctypes argument types (ops/_cuda.SIGNATURES,
    the stream last) follow its declaration in csrc/*.cu: a pointer for
    each pointer, int64 for int64_t and long long, int otherwise."""
    import ctypes
    import glob
    import re
    from subword_tokenizers_tpu_torch.ops import _cuda
    src = "".join(open(f, encoding="utf-8").read()
                  for f in glob.glob(os.path.join(_cuda.CSRC, "*.cu")))
    for name, argtypes in _cuda.SIGNATURES.items():
        decl = re.search(r"int\s+" + name + r"\s*\(([^)]*)\)", src)
        assert decl, name
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int64
                if "int64_t" in p or "long long" in p else ctypes.c_int
                for p in decl.group(1).split(",")]
        assert argtypes == want, name
