"""The sharded step's grouped K1 and K3p (ops/pairstats.py ``pair_rows``,
which counts the padded rows of every shard of one device in one call,
and ops/merge.py ``apply_merge`` over a device's block of shards, its
ids from the host or from the record) on their plain versions, against
the JAX functions they replace, on 8 virtual CPU devices: ``_local_pairs``
followed by ``_run_aggregate`` shard by shard, ``sharded_apply_merge``
and ``ops/merge.apply_merge``. Port keys and positions map to JAX's as
in ``test_torch_shard_kernels.py``. Every comparison is exact. Then the
wrappers' checks, and the calls ``ShardedTrainer`` makes: one grouped K1
a group a step and one grouped K3p a group a merge, with the host's ids.
"""
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from subword_tokenizers_tpu.ops import merge as jmerge
from subword_tokenizers_tpu.ops import pairstats as jps
from subword_tokenizers_tpu.parallel import train as jtrain
from subword_tokenizers_tpu.parallel.mesh import DATA_AXIS
from subword_tokenizers_tpu.parallel.mesh import make_data_mesh as jax_mesh
from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.ops import merge, pairstats, train_loop
from subword_tokenizers_tpu_torch.ops.pairstats import canonical, pair_rows
from subword_tokenizers_tpu_torch.parallel import train as ptrain
from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh
from test_torch_padded_train import random_rows as rows_with_pads
from test_torch_shard_kernels import random_rows, to_port_key

torch.set_num_threads(1)

CORPUS = ["the cat sat on the mat", "aaaa aaa aa a", "banana bandana",
          "a man a plan a canal panama", "mississippi miss sip",
          "the rain in spain stays mainly in the plain"] * 3


def jax_local_runs(sym, freq, D):
    """Per shard of a JAX mesh of D devices, ``_local_pairs`` then
    ``_run_aggregate``: its runs as port (keys, counts, global positions)
    sorted by key."""
    jm = jax_mesh(D)
    jsym, jfreq = jtrain.shard_corpus(jm, sym, freq)

    @partial(shard_map, mesh=jm, in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
             out_specs=(P(DATA_AXIS),) * 4, check_vma=False)
    def step(sym_l, freq_l):
        keys, pos, w = jtrain._local_pairs(sym_l, freq_l)
        return jps._run_aggregate(keys, pos, w, False)

    k_s, p_s, rt, cand = (np.asarray(x).reshape(D, -1)
                          for x in step(jsym, jfreq))
    out = []
    for i in range(D):
        k = to_port_key(k_s[i][cand[i]])
        order = np.argsort(k)
        out.append((k[order], rt[i][cand[i]][order],
                    p_s[i][cand[i]][order]))
    return out


@pytest.mark.parametrize("D", [1, 3, 8])
@pytest.mark.parametrize("L", [1, 2, 22, 40])
def test_grouped_pair_counts_match_jax(D, L):
    """Each shard's table from one grouped call: its pairs, counts and
    first local positions ``row * L + j``, which map to JAX's global
    ``shard * rows * (L - 1) + row * (L - 1) + j``."""
    sym, freq = random_rows(100 + 7 * D + L, n=51, L=L, n_sym=5)
    corpus = ptrain.shard_corpus(make_data_mesh(D, devices=["cpu"] * D),
                                 sym, freq)
    blk = corpus.blocks[0]
    tables = pair_rows(blk.state.sym, blk.wgt, blk.rows)
    assert len(tables) == D and len(corpus.blocks) == 1
    # the block's K1 fills a table set, on the CPU with the plain
    # version's entries: the same pairs in K1's table form
    grouped = corpus.pairs()
    assert blk.table_set(grouped) is blk.filled is blk.sets[0]
    for t, g in zip(tables, grouped):
        assert all(torch.equal(x, y) for x, y in zip(t, canonical(*g)))
    if L == 1:  # no pair slots: JAX's _local_pairs yields no key
        assert all(t[0].numel() == 0 for t in tables)
        return
    Lp, rows = corpus.L, corpus.rows
    for i, ((keys, counts, first), (jk, jc, jp)) in enumerate(
            zip(tables, jax_local_runs(sym, freq, D))):
        assert np.array_equal(keys.numpy(), jk)
        assert np.array_equal(counts.numpy(), jc)
        f = first.numpy()
        assert np.array_equal(i * rows * (L - 1) + (f // Lp) * (L - 1)
                              + f % Lp, jp)


def test_grouped_pair_counts_equal_per_shard_counts():
    """The grouped plain version equals the per-shard K1 of each shard's
    view (the flat layout's ``pair_stats`` over its slots), with PADs
    inside rows and wide weights."""
    sym, freq = rows_with_pads(5, n=96, L=22, n_sym=3, inner_pad=True)
    corpus = ptrain.shard_corpus(make_data_mesh(8, devices=["cpu"] * 8),
                                 sym, freq << 40)
    for t, s in zip(corpus.pairs(), corpus.shards):
        assert all(torch.equal(x, y) for x, y in zip(canonical(*t),
                                                     s.pairs()))


def _merges(sym):
    """The most frequent adjacent pair, the most frequent symbol with
    itself, and an absent pair, each to id 40."""
    pairs = np.stack([sym[:, :-1].ravel(), sym[:, 1:].ravel()], 1)
    pairs = pairs[(pairs >= 0).all(1)]
    vals, cnt = np.unique(pairs, axis=0, return_counts=True)
    a, b = vals[cnt.argmax()].tolist()
    mode = int(np.bincount(sym[sym >= 0]).argmax())
    return [(a, b, 40), (mode, mode, 40), (37, 38, 40)]


@pytest.mark.parametrize("D,L", [(1, 22), (3, 40), (8, 22), (8, 2)])
def test_grouped_merge_matches_jax(D, L):
    """``sharded_apply_merge`` (K3p once a device, the host's ids) against
    the JAX package's ``sharded_apply_merge`` on a mesh of D devices,
    merge after merge, with runs of a == b and PADs inside rows."""
    sym, freq = rows_with_pads(10 + D, n=61, L=L, n_sym=3, inner_pad=True)
    corpus = ptrain.shard_corpus(make_data_mesh(D, devices=["cpu"] * D),
                                 sym, freq)
    jm = jax_mesh(D)
    jsym, _ = jtrain.shard_corpus(jm, sym, freq)
    for a, b, n in _merges(sym) + [(40, 40, 41), (40, 2, 42)]:
        jsym = jtrain.sharded_apply_merge(jm, jsym, a, b, n)
        ptrain.sharded_apply_merge(corpus, a, b, n)
        assert np.array_equal(corpus.host(),
                              np.asarray(jsym)[:sym.shape[0]]), (a, b)


@pytest.mark.parametrize("seed", range(3))
def test_block_merge_matches_jax_apply_merge(seed):
    """K3p over a block of rows: from the host's ids and from the record
    (active and inactive) against ``ops/merge.apply_merge``; the two
    modes agree."""
    sym, _ = rows_with_pads(20 + seed, n=200, L=40, n_sym=2, inner_pad=True)
    for a, b, n in _merges(sym):
        want = np.asarray(jmerge.apply_merge(jnp.asarray(sym), a, b, n))
        host = merge.apply_merge(torch.from_numpy(sym.copy()),
                                 merge=(a, b, n))
        rec = torch.tensor([a, b, n, 0, 1, 0], dtype=torch.int32)
        from_rec = merge.apply_merge(torch.from_numpy(sym.copy()), rec)
        assert np.array_equal(host.numpy(), want), (a, b)
        assert torch.equal(host, from_rec)
        inactive = torch.tensor([a, b, n, 0, 0, 0], dtype=torch.int32)
        got = merge.apply_merge(torch.from_numpy(sym.copy()), inactive)
        assert np.array_equal(got.numpy(), np.asarray(jmerge.apply_merge(
            jnp.asarray(sym), -3, -3, n)))


def test_wrappers_reject_bad_input():
    sym = torch.zeros((8, 4), dtype=torch.int32)
    wgt = torch.ones(8, dtype=torch.int64)
    for bad, err in (
            (lambda: pair_rows(sym.long(), wgt, 4), TypeError),
            (lambda: pair_rows(sym, wgt.int(), 4), TypeError),
            (lambda: pair_rows(sym, wgt[:7], 4), ValueError),
            (lambda: pair_rows(sym, wgt, 3), ValueError),
            (lambda: pair_rows(sym, wgt, 0), ValueError),
            (lambda: pair_rows(sym.t(), wgt[:4], 4), ValueError),
            (lambda: merge.apply_merge(sym), ValueError),
            (lambda: merge.apply_merge(
                sym, torch.zeros(6, dtype=torch.int32), merge=(1, 2, 3)),
             ValueError),
            (lambda: merge.apply_merge(sym, merge=(1, -2, 3)), ValueError),
            (lambda: merge.apply_merge(sym, merge=(1, 2)), ValueError),
            (lambda: merge.apply_merge(sym, merge=(1, 2.0, 3)), TypeError),
            (lambda: merge.apply_merge(sym, torch.zeros(5, dtype=torch.int32)),
             ValueError)):
        with pytest.raises(err):
            bad()
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pair_rows(sym.to(meta), wgt.to(meta), 4)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        merge.apply_merge(sym.to(meta), merge=(1, 2, 3))
    # the plain versions count no launch
    before = (pair_rows.launches, merge.apply_merge.launches)
    pair_rows(sym, wgt, 4)
    merge.apply_merge(sym, merge=(1, 2, 3))
    assert (pair_rows.launches, merge.apply_merge.launches) == before


@pytest.fixture
def calls(monkeypatch):
    """Each call of the grouped K1, K3p, K4 and the per-shard K1 from the
    sharded path: (sym shape, rows, the merge or sym_cap)."""
    seen = {"pair_rows": [], "apply_merge": [], "pair_stats": [],
            "symbol_rows": []}

    def spy(name, real):
        def f(*args, **kw):
            seen[name].append((tuple(args[0].shape),
                               args[2] if name in ("pair_rows",
                                                   "symbol_rows") else
                               kw.get("merge")))
            return real(*args, **kw)
        return f

    monkeypatch.setattr(ptrain, "pair_rows", spy("pair_rows", pair_rows))
    monkeypatch.setattr(ptrain, "apply_merge",
                        spy("apply_merge", merge.apply_merge))
    monkeypatch.setattr(train_loop, "pair_stats",
                        spy("pair_stats", pairstats.pair_stats))
    monkeypatch.setattr(train_loop, "symbol_rows",
                        spy("symbol_rows", pairstats.symbol_rows))
    return seen


@pytest.mark.parametrize("cls", [NaiveBPE, NaiveWP])
def test_trainer_calls_one_grouped_kernel_a_step(cls, calls):
    """Under a mesh of 8 CPU shards (one group), every step counts the
    pairs of all 8 shards in one grouped call (WordPiece's symbol weights
    too: one K4 call over the block a step, none for BPE) and every merge
    is one call over the block with the host's ids, not the record; the
    per-shard K1 runs only in the full tier. The merges equal a
    single-device run."""
    mesh = make_data_mesh(8, devices=["cpu"] * 8)
    tok = cls(mesh=mesh, device="cpu")
    tok.train(CORPUS, 60)
    steps = sum(tok._sel_stats.values())
    log = tok.merges_list if cls is NaiveBPE else tok._merge_log
    assert steps >= len(log) > 10
    n_rows = -(-len(tok.corpus_as_symbols) // 8) * 8
    assert len(calls["pair_rows"]) == steps
    assert {c[1] for c in calls["pair_rows"]} == {n_rows // 8}
    assert {c[0][0] for c in calls["pair_rows"]} == {n_rows}
    assert len(calls["apply_merge"]) == len(log)
    assert all(isinstance(m, tuple) and len(m) == 3
               for _, m in calls["apply_merge"])
    assert len(calls["pair_stats"]) == tok._sel_stats["full"]
    assert len(calls["symbol_rows"]) == (steps if cls is NaiveWP else 0)
    assert {c[0][0] for c in calls["symbol_rows"]} <= {n_rows}
    single = cls(device="cpu")
    single.train(CORPUS, 60)
    assert log == (single.merges_list if cls is NaiveBPE
                   else single._merge_log)


def test_forced_full_tier_counts_the_gathered_rows_only(calls):
    """The forced full tier takes no grouped K1: one per-shard K1 over the
    gathered rows a step."""
    tok = NaiveBPE(mesh=make_data_mesh(8, devices=["cpu"] * 8),
                   device="cpu")
    tok._force_tier = "full"
    tok.train(CORPUS, 40)
    steps = tok._sel_stats["full"]
    assert steps == sum(tok._sel_stats.values()) > 5
    assert not calls["pair_rows"]
    assert len(calls["pair_stats"]) == steps
    assert len(calls["apply_merge"]) == len(tok.merges_list)


def test_mesh_of_one_equals_single_device(calls):
    """The mesh of 1: one shard, one group, the same merges."""
    tok = NaiveBPE(mesh=make_data_mesh(1, devices=["cpu"]), device="cpu")
    tok.train(CORPUS, 60)
    single = NaiveBPE(device="cpu")
    single.train(CORPUS, 60)
    assert tok.merges_list == single.merges_list
    assert tok.corpus_as_symbols == single.corpus_as_symbols
    assert len(calls["pair_rows"]) == sum(tok._sel_stats.values())
    assert {c[1] for c in calls["pair_rows"]} == {
        len(tok.corpus_as_symbols)}


def test_blocks_follow_the_mesh_groups():
    """One block a group of consecutive shards on one device; the shards
    are views of their block, and a merge through the block shows in
    them."""
    sym, freq = random_rows(3, n=40, L=6)
    corpus = ptrain.shard_corpus(make_data_mesh(4, devices=["cpu"] * 4),
                                 sym, freq)
    (blk,) = corpus.blocks
    assert blk.rows == corpus.rows == 10 and len(blk.shards) == 4
    assert corpus.shards == blk.shards
    for i, s in enumerate(corpus.shards):
        assert s.sym.data_ptr() == blk.state.sym[i * 10].data_ptr()
        assert torch.equal(s._wgt.view(10, -1)[:, 0],
                           torch.from_numpy(freq[i * 10:(i + 1) * 10]))
    a, b, n = _merges(sym)[0]
    ptrain.sharded_apply_merge(corpus, a, b, n)
    assert np.array_equal(torch.cat([s.sym for s in corpus.shards]).numpy(),
                          np.asarray(jmerge.apply_merge(jnp.asarray(sym),
                                                        a, b, n)))
