"""The nomination of the top-K tier (ops/shard_select.py
``nominate_tables``: every shard of a device in one call) on its plain
version, against phase 1 of the JAX package's ``sharded_bpe_select_topk``
and ``sharded_wp_select_topk`` (``parallel/train.py:263-275`` and
``:309-341``): each shard's runs from ``_run_aggregate``, the metric (the
count, or ``wp_score_bits`` over the mesh's symbol weights), and
``jax.lax.top_k``, whose lower index wins a tie, so that equal metrics go
to the lower key. Element for element: every candidate, and every K-th row
whose metric is at least 0. Then a sharded train of each model with
``torch.topk`` and ``score_bits`` made to raise, against the JAX package's
merges; one call a mesh group a step; the wrapper's refusals; and the
kernels' build digest, which must see the scorer's shared header."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subword_tokenizers_tpu import NaiveBPE as JaxNaiveBPE
from subword_tokenizers_tpu import NaiveWP as JaxNaiveWP
from subword_tokenizers_tpu.ops import pairstats as jps
from subword_tokenizers_tpu.parallel.mesh import make_data_mesh as jax_mesh
from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.ops import bitmath
from subword_tokenizers_tpu_torch.ops.pairstats import EMPTY_KEY
from subword_tokenizers_tpu_torch.ops.shard_select import (
    MAX_NOMINATE, TableSet, nominate, nominate_tables, nominate_tables_ref)
from subword_tokenizers_tpu_torch.parallel import train as ptrain
from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh
from test_torch_shard_kernels import random_rows, shards, to_port_key

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def equal_counts_rows(seed, n=192):
    """Rows of two symbols, each pair (a, b) at most once, in shuffled
    order and of one weight: every count of every shard is 3, so only the
    keys decide."""
    rng = np.random.default_rng(seed)
    pairs = np.array([(a, b) for a in range(24) for b in range(24)],
                     dtype=np.int32)
    rng.shuffle(pairs)
    return pairs[:n], np.full(n, 3, dtype=np.int64)


def case_rows(case, seed, D):
    if case == "equal":
        return equal_counts_rows(seed)
    sym, freq = random_rows(seed, n=96, L=8, n_sym=9)
    if case == "empty_shard":  # shard 1 has no pair; with D = 1 the one
        rows = -(-96 // D)     # table is empty
        sym[rows:2 * rows] = -1
        if D == 1:
            sym[:] = -1
    return sym, freq


def hashed(table, seed):
    """The plain table's live entries scattered over a table twice as
    large with EMPTY_KEY between them, as K1's hash table holds them."""
    keys, counts, first = table
    T = 2 * max(keys.shape[0], 1)
    slots = torch.randperm(T, generator=torch.Generator().manual_seed(
        seed))[:keys.shape[0]]
    out = (torch.full((T,), EMPTY_KEY, dtype=torch.int64),
           torch.zeros(T, dtype=torch.int64),
           torch.zeros(T, dtype=torch.int64))
    for o, x in zip(out, (keys, counts, first)):
        o[slots] = x
    return out


def jax_phase1(runs, k, sym_freq=None):
    """Phase 1 of the JAX package's top-K tier on each shard's runs:
    (cand, kth rows (metric, count, key)) in port keys."""
    cands, kths = [], []
    for k_s, _, run_total, is_cand in runs:
        if sym_freq is None:
            metric = jnp.where(is_cand, run_total,
                               jnp.asarray(-1, run_total.dtype))
        else:
            score = jps.wp_score_bits(k_s, run_total, is_cand, sym_freq,
                                      False, False)
            metric = jnp.where(is_cand, score, jnp.int64(-1))
        topv, topi = jax.lax.top_k(metric, k)
        keep = topv > 0 if sym_freq is None else topv >= 0
        cand = np.asarray(jnp.where(keep, k_s[topi], jps._consts(False)[3]))
        cands.append(to_port_key(cand))
        last = int(topi[k - 1])
        kths.append([int(topv[k - 1]), int(run_total[last]),
                     int(to_port_key(int(k_s[last])))])
    return np.concatenate(cands), kths


def jax_sym_freq(corpus, sym_cap):
    """The JAX package's symbol weights over every row of the mesh."""
    rows = np.concatenate([s.sym.numpy() for s in corpus.shards])
    n, L = rows.shape
    return jps.symbol_freqs(
        jnp.asarray(rows).reshape(-1),
        jnp.broadcast_to(jnp.asarray(corpus.freq)[:, None],
                         (n, L)).reshape(-1), sym_cap)


@pytest.mark.parametrize("D", [1, 3, 8])
@pytest.mark.parametrize("topk", [16, 256])
@pytest.mark.parametrize("wordpiece", [False, True])
@pytest.mark.parametrize("case", ["random", "equal", "empty_shard"])
def test_nominate_tables_equals_jax_top_k(D, topk, wordpiece, case):
    sym, freq = case_rows(case, 300 + D, D)
    corpus, tables, runs = shards(sym, freq, D)
    k = min(topk, corpus.n_local_pairs)
    sf = jsf = None
    if wordpiece:
        sym_cap = int(sym.max()) + 9
        sf = ptrain.sharded_sym_freq(corpus, sym_cap)
        jsf = jax_sym_freq(corpus, sym_cap)
        assert np.array_equal(sf.numpy(), np.asarray(jsf))
    want_cand, want_kth = jax_phase1(runs, k, jsf)
    n_live = [int((t[0] != EMPTY_KEY).sum()) for t in tables]
    if case == "empty_shard":
        assert 0 in n_live
    if case == "equal":
        assert all((t[1] == 3).all() for t in tables)
    if topk == 256:  # no shard above k: a shorter one's K-th metric is -1
        assert max(n_live) <= k
    elif max(n_live):  # ties and order decide
        assert max(n_live) > k
    for layout in ("sorted", "hashed"):
        tabs = tables if layout == "sorted" else [
            hashed(t, i) for i, t in enumerate(tables)]
        cand, kth = nominate_tables(tabs, k, sf)
        assert cand.dtype == kth.dtype == torch.int64
        assert cand.shape == (D * k,) and kth.shape == (3 * D,)
        assert np.array_equal(cand.numpy(), want_cand), layout
        rows = kth.view(D, 3).tolist()
        for i, (row, want) in enumerate(zip(rows, want_kth)):
            if want[0] >= 0:
                assert row == want, (layout, i)
            else:  # fewer than k live entries
                assert row == [-1, 0, EMPTY_KEY] and n_live[i] < k
        # the one-table case, shard by shard
        for i, t in enumerate(tabs):
            c1, k1 = nominate(t, k, sf)
            assert torch.equal(c1, cand[i * k:(i + 1) * k])
            assert torch.equal(k1, kth[3 * i:3 * i + 3])


def test_nominate_tables_writes_out():
    sym, freq = random_rows(5, n=64)
    corpus, tables, _ = shards(sym, freq, 4)
    want = nominate_tables_ref(tables, 16)
    out = (torch.full((64,), 7, dtype=torch.int64),
           torch.full((12,), 7, dtype=torch.int64))
    got = nominate_tables(tables, 16, out=out,
                          tset=TableSet(tables, corpus.bases))
    assert got[0] is out[0] and got[1] is out[1]
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.fixture
def no_library_nomination(monkeypatch):
    """``torch.topk`` and the scorer's wrapper raise if called."""
    def refuse(*args, **kwargs):
        raise AssertionError("called on the sharded step")

    monkeypatch.setattr(torch, "topk", refuse)
    monkeypatch.setattr(bitmath, "score_bits", refuse)


@pytest.fixture(scope="module")
def corpus85k():
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        return json.load(f)[:120]


@pytest.mark.parametrize("cls,jcls,vocab", [(NaiveBPE, JaxNaiveBPE, 300),
                                            (NaiveWP, JaxNaiveWP, 320)])
def test_sharded_train_without_topk_or_scorer(cls, jcls, vocab, corpus85k,
                                              no_library_nomination):
    sharded = cls(mesh=make_data_mesh(8, devices=["cpu"] * 8), device="cpu")
    sharded.train(corpus85k, vocab)
    jax_tok = jcls(mesh=jax_mesh(8))
    jax_tok.train(corpus85k, vocab)
    got = sharded.merges_list if cls is NaiveBPE else sharded._merge_log
    want = jax_tok.merges_list if cls is NaiveBPE else jax_tok._merge_log
    assert got == want and len(got) > 100
    assert sharded.vocab == jax_tok.vocab
    assert sharded._sel_stats["proven"] > 0


@pytest.mark.parametrize("cls", [NaiveBPE, NaiveWP])
def test_one_nomination_a_group_a_step(cls, corpus85k, monkeypatch):
    calls = []
    real = ptrain.nominate_tables

    def spy(tables, k, sym_freq=None, tset=None, out=None):
        calls.append((len(tables), k, sym_freq is not None))
        return real(tables, k, sym_freq, tset, out)

    monkeypatch.setattr(ptrain, "nominate_tables", spy)
    mesh = make_data_mesh(8, devices=["cpu"] * 8)
    assert len(mesh.groups) == 1
    tok = cls(mesh=mesh, device="cpu")
    tok.train(corpus85k[:40], 150)
    steps = sum(tok._sel_stats.values())
    assert len(calls) == steps > 20
    assert set(calls) == {(8, ptrain.TOPK, cls is NaiveWP)}


def test_nominate_tables_refusals():
    sym, freq = random_rows(6, n=64)
    corpus, tables, _ = shards(sym, freq, 4)
    for k in (0, -1, MAX_NOMINATE + 1):
        with pytest.raises(ValueError, match="outside 1"):
            nominate_tables(tables, k)
    nominate_tables(tables, MAX_NOMINATE)
    # a TableSet of other tables: another shard's, or fewer tables
    other = TableSet(tables[1:] + tables[:1], corpus.bases)
    with pytest.raises(ValueError, match="TableSet"):
        nominate_tables(tables, 16, tset=other)
    with pytest.raises(ValueError, match="TableSet"):
        nominate_tables(tables, 16, tset=TableSet(tables[:3],
                                                  corpus.bases[:3]))
    # the same tensors in new containers are the same tables
    same = TableSet([list(t) for t in tables], corpus.bases)
    nominate_tables([list(t) for t in tables], 16, tset=same)
    nominate_tables(tables, 16, tset=same)
    meta = [tuple(x.to("meta") for x in t) for t in tables]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        nominate_tables(meta, 16)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        nominate(meta[0], 16)
    with pytest.raises(ValueError):
        nominate_tables([], 16)
    with pytest.raises(ValueError, match="out cand"):
        nominate_tables(tables, 16, out=(torch.empty(5, dtype=torch.int64),
                                         torch.empty(12,
                                                     dtype=torch.int64)))


def test_build_digest_sees_headers(tmp_path, monkeypatch):
    """The kernels' library is named by a hash of the sources and of the
    headers they include (``csrc/score_bits.cuh``): a header edit names a
    new library, so a stale one is never loaded."""
    from subword_tokenizers_tpu_torch.ops import _cuda
    assert os.path.join(_cuda.CSRC, "score_bits.cuh") in _cuda._headers()
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_cuda, "CSRC", str(tmp_path))
    before = _cuda._so_path()
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _cuda._so_path() != before
