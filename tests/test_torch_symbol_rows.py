"""K4 in rows mode (ops/pairstats.py ``symbol_rows``: the padded rows of a
device's block of shards and the rows' weights, counted in one call, the
sum of the shards' counts) and its callers, on the plain version, against
the JAX package: ``ops/pairstats.symbol_freqs`` over each shard's slots
with the broadcast row weights summed over the shards, as
``parallel/train.py`` ``_local_sym_freq`` forms them under ``psum``.
Then ``sharded_sym_freq``'s one call a mesh group, the double buffer of
outputs (the launch that fills one empties the other) on a CPU emulation
of the launch, the wrapper's checks, and a sharded WordPiece train on a
slice against the JAX package's sharded trainer. Every comparison is
exact."""
import json
import os
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from subword_tokenizers_tpu import NaiveWP as JaxNaiveWP
from subword_tokenizers_tpu.ops import pairstats as jps
from subword_tokenizers_tpu.parallel import train as jtrain
from subword_tokenizers_tpu.parallel.mesh import DATA_AXIS
from subword_tokenizers_tpu.parallel.mesh import make_data_mesh as jax_mesh
from subword_tokenizers_tpu_torch import NaiveWP
from subword_tokenizers_tpu_torch.ops import pairstats, train_loop
from subword_tokenizers_tpu_torch.ops.pairstats import (symbol_freqs,
                                                        symbol_freqs_ref,
                                                        symbol_rows,
                                                        symbol_rows_ref)
from subword_tokenizers_tpu_torch.parallel import train as ptrain
from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rows_case(seed, n=240, L=9, n_sym=30, wscale=1):
    """Seeded padded rows: PADs inside and at the end, all-PAD rows, ids
    up to ``n_sym`` - 1 (some at or above a smaller sym_cap), zero and
    ``wscale``-scaled weights."""
    rng = np.random.default_rng(seed)
    sym = rng.integers(0, n_sym, size=(n, L)).astype(np.int32)
    lens = rng.integers(0, L + 1, size=n)
    sym[np.arange(L)[None, :] >= lens[:, None]] = -1
    sym[rng.random(sym.shape) < 0.1] = -1
    sym[rng.random(n) < 0.1] = -1
    freq = rng.integers(1, 50, size=n).astype(np.int64) * wscale
    freq[rng.random(n) < 0.1] = 0
    return sym, freq


def jax_sum_over_shards(sym, freq, sym_cap, D):
    """Sum over D shards of JAX ``symbol_freqs`` with the row weights
    broadcast to the slots."""
    n, L = sym.shape
    rows = n // D
    out = 0
    for lo in range(0, n, rows):
        s, f = sym[lo:lo + rows], freq[lo:lo + rows]
        out = out + np.asarray(jps.symbol_freqs(
            jnp.asarray(s).reshape(-1),
            jnp.broadcast_to(jnp.asarray(f)[:, None], s.shape).reshape(-1),
            sym_cap))
    return out


def jax_local_sym_freq(sym, freq, sym_cap, D):
    """The JAX package's ``_local_sym_freq`` on a mesh of D (psum'd)."""
    jm = jax_mesh(D)
    jsym, jfreq = jtrain.shard_corpus(jm, sym, freq)

    @partial(shard_map, mesh=jm, in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
             out_specs=P(), check_vma=False)
    def step(sym_l, freq_l):
        return jtrain._local_sym_freq(sym_l, freq_l, sym_cap, jnp.int64)

    return np.asarray(step(jsym, jfreq))


CASES = [dict(seed=1), dict(seed=2, n_sym=4), dict(seed=3, L=1),
         dict(seed=4, L=22, wscale=1 << 40), dict(seed=5, n_sym=41000)]


@pytest.mark.parametrize("D", [1, 3, 8])
@pytest.mark.parametrize("case", CASES)
def test_grouped_plain_equals_sum_over_shards(D, case):
    """The plain version over a block of D shards equals the sum of the
    JAX package's per-shard symbol_freqs in every entry, the trash
    bucket ``sym_cap`` included: PADs and ids above sym_cap drop, and an
    id equal to sym_cap adds its weight into the bucket, as JAX's segment
    sum does (an id a training run never reaches: ``sym_capacity``
    leaves room)."""
    sym, freq = rows_case(**case)
    sym, freq = sym[:sym.shape[0] // D * D], freq[:sym.shape[0] // D * D]
    for sym_cap in ((20, 40_000) if case.get("n_sym") == 41000
                    else (20, 40)):
        got = symbol_rows(torch.from_numpy(sym), torch.from_numpy(freq),
                          sym_cap)
        want = jax_sum_over_shards(sym, freq, sym_cap, D)
        assert got.dtype == torch.int64 and got.shape == (sym_cap + 1,)
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(got.numpy(), symbol_freqs_ref(
            torch.from_numpy(sym).reshape(-1),
            torch.from_numpy(np.repeat(freq, sym.shape[1])),
            sym_cap).numpy())


@pytest.mark.parametrize("D", [1, 3, 8])
def test_sharded_sym_freq_equals_jax_psum(D):
    """``sharded_sym_freq`` on a CPU mesh of D (rows padded to a multiple
    of D with all-PAD, zero-weight rows) equals the JAX package's
    ``_local_sym_freq`` under its psum, at sym_caps 40 and 40,000, in
    every entry, the trash bucket included."""
    sym, freq = rows_case(7, n=203, L=11, n_sym=41000)
    corpus = ptrain.shard_corpus(make_data_mesh(D, devices=["cpu"] * D),
                                 sym, freq)
    for sym_cap in (40, 40_000):
        got = ptrain.sharded_sym_freq(corpus, sym_cap).numpy()
        want = jax_local_sym_freq(sym, freq, sym_cap, D)
        assert np.array_equal(got, want)


@pytest.fixture
def k4_calls(monkeypatch):
    """Each K4 call of the padded states: (rows shape, sym_cap, out,
    clear)."""
    seen = []
    real = train_loop.symbol_rows

    def spy(sym, wgt, sym_cap, out=None, clear=None):
        seen.append((tuple(sym.shape), sym_cap, out, clear))
        return real(sym, wgt, sym_cap, out, clear)

    monkeypatch.setattr(train_loop, "symbol_rows", spy)
    return seen


def test_one_call_per_mesh_group(k4_calls):
    """One K4 call a group a step: one for 8 shards on one device, two
    for two devices of 4 (the mesh sums the two partials)."""
    sym, freq = rows_case(8, n=160)
    one = ptrain.shard_corpus(make_data_mesh(8, devices=["cpu"] * 8), sym,
                              freq)
    ptrain.sharded_sym_freq(one, 40)
    assert [c[:2] for c in k4_calls] == [((160, 9), 40)]
    two = ptrain.shard_corpus(
        make_data_mesh(8, devices=["cpu"] * 4 + ["cpu:0"] * 4), sym, freq)
    assert len(two.blocks) == 2
    got = ptrain.sharded_sym_freq(two, 40)
    assert [c[:2] for c in k4_calls[1:]] == [((80, 9), 40)] * 2
    assert np.array_equal(got.numpy()[:40],
                          jax_sum_over_shards(sym, freq, 40, 8)[:40])


def emulate_k4(sym, wgt, sym_cap, out=None, clear=None):
    """One K4 launch on CPU tensors, as the kernel does it: ``out`` must
    arrive zero; the sums are added into it and ``clear`` is emptied."""
    assert out is not None and clear is not None and out is not clear
    assert int((out != 0).sum()) == 0, "an output arrived with sums"
    clear.zero_()
    out += symbol_rows_ref(sym, wgt, sym_cap)
    return out


def test_double_buffer_alternates(monkeypatch):
    """A block's two outputs alternate as the step calls K4: each call
    fills the one the call before emptied and empties the other, so each
    result equals the plain version and the previous result is zero once
    the next call has run (its readers ran before it)."""
    sym, freq = rows_case(9, n=96)
    corpus = ptrain.shard_corpus(make_data_mesh(4, devices=["cpu"] * 4),
                                 sym, freq)
    (blk,) = corpus.blocks
    blk.state._freqs = [torch.zeros(41, dtype=torch.int64)
                        for _ in range(2)]
    bufs = list(blk.state._freqs)
    calls = []

    def launch(*args):
        calls.append(args)
        return emulate_k4(*args)

    monkeypatch.setattr(train_loop, "symbol_rows", launch)
    want = symbol_rows_ref(torch.from_numpy(sym), torch.from_numpy(freq),
                           40).numpy()
    prev = None
    for step in range(5):
        got = ptrain.sharded_sym_freq(corpus, 40)
        assert got is bufs[step % 2]
        assert np.array_equal(got.numpy(), want)
        if prev is not None:
            assert int((prev != 0).sum()) == 0
        prev = got
    assert len(calls) == 5


def test_padded_state_counts_with_row_weights(k4_calls):
    """The padded route's K4 takes the rows and the rows' weights (8
    bytes a row, not a slot); the state keeps ``sym_freq``."""
    sym, freq = rows_case(10, n=50)
    st = train_loop.PaddedState(sym, freq, "cpu")
    got = st.count_symbols(40)
    assert got is st.sym_freq
    assert k4_calls[0][:2] == ((50, 9), 40)
    assert np.array_equal(got.numpy()[:40],
                          jax_sum_over_shards(sym, freq, 40, 1)[:40])
    assert st.wgt.tolist() == freq.tolist()


def test_wrapper_checks():
    sym, freq = (torch.from_numpy(x) for x in rows_case(11, n=16))
    for bad, err in (
            (lambda: symbol_rows(sym.to(torch.int64), freq, 8), TypeError),
            (lambda: symbol_rows(sym, freq.to(torch.int32), 8), TypeError),
            (lambda: symbol_rows(sym.reshape(-1), freq, 8), TypeError),
            (lambda: symbol_rows(sym, freq[:4], 8), ValueError),
            (lambda: symbol_rows(sym, freq, -1), ValueError),
            (lambda: symbol_rows(sym, freq, 2 ** 31), ValueError),
            (lambda: symbol_rows(sym[:0], freq[:0], 8), ValueError),
            (lambda: symbol_freqs(sym.reshape(-1), freq, 8), ValueError)):
        with pytest.raises(err):
            bad()
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        symbol_rows(sym.to(meta), freq.to(meta), 8)
    before = (symbol_rows.launches, symbol_freqs.launches)
    symbol_rows(sym, freq, 8)
    symbol_freqs(sym.reshape(-1), torch.repeat_interleave(freq, 9), 8)
    assert (symbol_rows.launches, symbol_freqs.launches) == before


@pytest.fixture(scope="module")
def corpus():
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        return json.load(f)


def test_sharded_wordpiece_train_equals_jax(corpus, k4_calls):
    """A sharded WordPiece train on a train-85k slice (8 CPU shards)
    equals the JAX package's sharded trainer, merge for merge and tier
    for tier, with one K4 call a step over the block of 8 shards."""
    mesh = make_data_mesh(8, devices=["cpu"] * 8)
    tok = NaiveWP(mesh=mesh, device="cpu")
    tok.train(corpus[:200], 500)
    want = JaxNaiveWP(mesh=jax_mesh(8))
    want.train(corpus[:200], 500)
    assert tok._merge_log == want._merge_log
    assert sorted(tok.vocab) == sorted(want.vocab)
    assert tok._sel_stats == want._sel_stats
    steps = sum(tok._sel_stats.values())
    assert len(k4_calls) == steps > 100
    n_rows = -(-len(tok.corpus_as_symbols) // 8) * 8
    assert {c[0][0] for c in k4_calls} == {n_rows}
