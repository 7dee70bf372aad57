"""The grouped shard kernels' plain versions (ops/shard_select.py:
``lookup_reduce`` and ``compact_tables``, which take every shard of a
device in one call) against the JAX functions they replace, shard by
shard, on 8 virtual CPU devices: the sum of ``_lookup_runs``'s counts and
the minimum of its positions over the shards, and ``compact_cands`` of
each shard concatenated with the OR of their overflow flags; and the
mesh's groups, which finish such partial results across devices. Port
keys and positions map to JAX's as in ``test_torch_shard_kernels.py``.
Every comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subword_tokenizers_tpu.ops import pairstats as jps
from subword_tokenizers_tpu.parallel import train as jtrain
from subword_tokenizers_tpu_torch.ops.pairstats import EMPTY_KEY
from subword_tokenizers_tpu_torch.ops import shard_select
from subword_tokenizers_tpu_torch.ops.shard_select import (
    POS_MAX, ROUND_SPAN, TableSet, compact_table, compact_tables,
    lookup_reduce, lookup_runs)
from subword_tokenizers_tpu_torch.parallel.mesh import DataMesh
from test_torch_shard_kernels import (I64_MAX, SENTINEL, random_rows,
                                      shards, to_jax_key, to_jax_pos)

torch.set_num_threads(1)


def candidates(tables, seed):
    """Every live key of the tables, keys absent from all of them and
    EMPTY_KEY, shuffled by ``seed``."""
    present = torch.unique(torch.cat([t[0] for t in tables]))
    present = present[present != EMPTY_KEY]
    absent = torch.tensor([(99 << 32) | 98, 77, 77 << 32], dtype=torch.int64)
    cand = torch.cat([present, absent,
                      torch.full((4,), EMPTY_KEY, dtype=torch.int64)])
    return cand[torch.randperm(cand.numel(),
                               generator=torch.Generator().manual_seed(seed))]


@pytest.mark.parametrize("seed,D", [(10, 1), (11, 2), (12, 4), (13, 8)])
def test_lookup_reduce_matches_jax(seed, D):
    sym, freq = random_rows(seed, n=120)
    corpus, tables, runs = shards(sym, freq, D)
    cand = candidates(tables, seed)
    jcand = jnp.asarray(to_jax_key(cand.numpy()))
    jcnt, jpos = zip(*(jtrain._lookup_runs(k_s, p_s, rt, jcand,
                                           jnp.int64(SENTINEL),
                                           jnp.int64(I64_MAX))
                       for k_s, p_s, rt, _ in runs))
    cnt, pos = lookup_reduce(cand, tables, corpus.bases)
    assert np.array_equal(cnt.numpy(),
                          np.sum([np.asarray(c) for c in jcnt], axis=0))
    assert np.array_equal(to_jax_pos(pos.numpy(), corpus.L),
                          np.min([np.asarray(p) for p in jpos], axis=0))
    # absent and EMPTY candidates give (0, POS_MAX); every present one a
    # count and a position
    miss = ~torch.isin(cand, torch.cat([t[0] for t in tables])) | \
        (cand == EMPTY_KEY)
    assert (cnt[miss] == 0).all() and (pos[miss] == POS_MAX).all()
    assert (cnt[~miss] > 0).all() and (pos[~miss] < POS_MAX).all()
    # the same as the one-table lookups summed and minimised
    one = [lookup_runs(cand, t, b) for t, b in zip(tables, corpus.bases)]
    assert torch.equal(cnt, torch.stack([c for c, _ in one]).sum(0))
    assert torch.equal(pos, torch.stack([p for _, p in one]).amin(0))


@pytest.mark.parametrize("seed,D", [(20, 1), (21, 2), (22, 4), (24, 8)])
def test_compact_tables_matches_jax(seed, D):
    sym, freq = random_rows(seed, n=120)
    corpus, tables, runs = shards(sym, freq, D)
    n_live = [int((t[0] != EMPTY_KEY).sum()) for t in tables]
    top = sorted(n_live)[-1]
    assert n_live.count(top) == 1, n_live  # the seeds give one largest
    one_over = top - 1 if D == 1 else sorted(n_live)[-2]
    for cap in (1, one_over, top, 4096):
        ck, cc, cp, ovf = compact_tables(tables, corpus.bases, cap)
        assert ck.shape == cc.shape == cp.shape == (D * cap,)
        flags = []
        for i, (table, base, (k_s, p_s, rt, is_cand)) in enumerate(
                zip(tables, corpus.bases, runs)):
            jck, jcp, jcc, jvalid, jovf = (np.asarray(x) for x in
                                           jps.compact_cands(
                                               k_s, p_s, rt, is_cand, cap,
                                               False))
            flags.append(int(jovf))
            part = slice(i * cap, (i + 1) * cap)
            k, c, p = ck[part], cc[part], cp[part]
            live = k != EMPTY_KEY
            assert int(live.sum()) == int(jvalid.sum())
            assert (c[~live] == 0).all() and (p[~live] == POS_MAX).all()
            # shard i's part is the one-table compaction, element for
            # element
            want = compact_table(table, cap, base)
            assert all(torch.equal(x, y) for x, y in
                       zip((k, c, p), want[:3]))
            assert int(want[3][0]) == int(jovf)
            if jovf:
                continue
            got = sorted(zip(to_jax_key(k[live].numpy()).tolist(),
                             c[live].tolist(),
                             to_jax_pos(p[live].numpy(), corpus.L).tolist()))
            assert got == sorted(zip(jck[jvalid].tolist(),
                                     jcc[jvalid].tolist(),
                                     jcp[jvalid].tolist()))
        assert ovf.tolist() == [int(any(flags))]
        if cap == one_over:
            assert sum(flags) == 1, (cap, n_live)


def test_compact_tables_writes_out():
    """``out`` buffers are written in place and returned."""
    sym, freq = random_rows(30, n=64)
    corpus, tables, _ = shards(sym, freq, 4)
    cap = 16
    out = (torch.zeros(4 * cap, dtype=torch.int64),
           torch.zeros(4 * cap, dtype=torch.int64),
           torch.zeros(4 * cap, dtype=torch.int64),
           torch.full((1,), 7, dtype=torch.int32))
    got = compact_tables(tables, corpus.bases, cap, out=out)
    assert all(g is o for g, o in zip(got, out))
    want = compact_tables(tables, corpus.bases, cap)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="out keys"):
        compact_tables(tables, corpus.bases, cap + 1, out=out)


def test_grouped_wrappers_reject_bad_input():
    sym, freq = random_rows(31, n=32)
    corpus, tables, _ = shards(sym, freq, 2)
    cand = torch.tensor([EMPTY_KEY], dtype=torch.int64)
    with pytest.raises(ValueError, match="2 tables, 1 bases"):
        lookup_reduce(cand, tables, corpus.bases[:1])
    with pytest.raises(ValueError, match="base -1"):
        compact_tables(tables, [0, -1], 4)
    with pytest.raises(ValueError, match="cap 0"):
        compact_tables(tables, corpus.bases, 0)
    meta = [tuple(x.to("meta") for x in t) for t in tables]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        lookup_reduce(cand.to("meta"), meta, corpus.bases)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        compact_tables(meta, corpus.bases, 4)


def test_table_set_layout_and_epochs(monkeypatch):
    """A TableSet is the grouped kernels' descriptor: per table its
    pointers, T, base and a flag slot, then the ticket, a cluster counter
    a table, C look-back words a table and the epoch word; the host
    counts its compactions and, before they would take the epoch word
    past EPOCH_MAX, zeroes the look-back words and the epoch word. A block
    of the mesh lends its set only for the tables its K1 filled."""
    def table(T):
        return (torch.full((T,), EMPTY_KEY, dtype=torch.int64),
                torch.zeros(T, dtype=torch.int64),
                torch.zeros(T, dtype=torch.int32))

    small, big = table(8), table(2 * ROUND_SPAN + 1)
    ts = TableSet([small, big], [0, 40])
    assert ts.D == 2 and ts.clusters == 3
    d = ts.desc.tolist()
    assert len(d) == 6 * 2 + 1 + 2 + 2 * 3 + 1 and ts.EPOCH == len(d) - 1
    assert d[:12] == [*(x.data_ptr() for x in small), 8, 0, 0,
                      *(x.data_ptr() for x in big), 2 * ROUND_SPAN + 1, 40, 0]
    assert not any(d[12:]) and ts.epoch == 0 and ts.calls == 0
    assert ts.status.data_ptr() == ts.desc[15].data_ptr()
    assert ts.status.shape == (6,)
    assert ts.holds([small, big], [0, 40])
    assert not ts.holds([small, big], [0, 41])
    assert not ts.holds([big, small], [40, 0])
    monkeypatch.setattr(shard_select, "EPOCH_MAX", 3)
    ts.desc[15:] = 7  # look-back words and epoch word as calls leave them
    for n in (1, 2, 3):
        ts.advance()
        assert ts.calls == n and ts.desc[15:].tolist() == [7] * 7
    ts.advance()
    assert ts.calls == 1
    assert not any(ts.desc[15:].tolist()) and ts.desc[:15].tolist() == d[:15]
    ts.room(2)
    assert ts.calls == 1
    ts.desc[15:] = 7
    ts.room(3)  # 1 + 3 calls would pass EPOCH_MAX
    assert ts.calls == 0 and not any(ts.desc[15:].tolist())

    sym, freq = random_rows(33, n=48)
    corpus, tables, _ = shards(sym, freq, 4)
    one = TableSet(tables, corpus.bases)
    assert one.D == 4 and one.holds(tables, corpus.bases)
    blk = corpus.blocks[0]
    assert blk.table_set(tables) is None  # not the tables of a block's set
    blk.filled = one
    assert blk.table_set(tables) is one
    moved = [tuple(x.clone() for x in t) for t in tables]
    assert blk.table_set(moved) is None and blk.table_set(tables[:3]) is None
    # the wrappers refuse a set of another count of tables
    cand = torch.tensor([EMPTY_KEY], dtype=torch.int64)
    with pytest.raises(ValueError, match="TableSet of 4 tables"):
        compact_tables(tables[:2], corpus.bases[:2], 4, tset=one)
    with pytest.raises(ValueError, match="TableSet of 4 tables"):
        lookup_reduce(cand, tables[:3], corpus.bases[:3], one)
    # given the set, the results are those without it
    got = compact_tables(tables, corpus.bases, 16, tset=one)
    want = compact_tables(tables, corpus.bases, 16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_mesh_groups_finish_partials():
    """Groups are runs of consecutive shards on one device; the
    collectives take one partial a group in place of one tensor a shard,
    and refuse any other count."""
    mesh = DataMesh(["cuda:0", "cuda:0", "cuda:1", "cuda:0"])
    assert [(str(d), a, b) for d, a, b in mesh.groups] == [
        ("cuda:0", 0, 2), ("cuda:1", 2, 3), ("cuda:0", 3, 4)]
    mesh = DataMesh(["cpu"] * 4)
    assert [(str(d), a, b) for d, a, b in mesh.groups] == [("cpu", 0, 4)]
    rng = np.random.default_rng(32)
    parts = [torch.from_numpy(rng.integers(-9, 9, size=5)) for _ in range(4)]
    stacked = torch.stack(parts)
    assert torch.equal(mesh.sum(parts), stacked.sum(0))
    assert torch.equal(mesh.sum([stacked.sum(0)]), stacked.sum(0))
    assert torch.equal(mesh.amin([stacked.amin(0)]), mesh.amin(parts))
    assert torch.equal(mesh.amax(parts), stacked.amax(0))
    assert torch.equal(mesh.gather([torch.cat(parts)]), mesh.gather(parts))
    with pytest.raises(ValueError, match="4 shard tensors or 1 group"):
        mesh.sum(parts[:2])
