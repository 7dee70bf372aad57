"""The per-shard pieces of the port's data-parallel selection
(ops/shard_select.py, K1's runs mode, parallel/train.py) on their plain
versions, against the JAX functions they replace: ``_lookup_runs``,
``compact_cands`` with its overflow flag, ``_run_aggregate`` over the
gathered runs, and the proven flag and winner of
``sharded_{bpe,wp}_select_topk`` on 8 virtual CPU devices. Port keys
``a << 32 | b`` map to JAX's ``a << 21 | b``, and every port position
``row * L + j`` to JAX's ``row * (L - 1) + j``. Every comparison is
exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subword_tokenizers_tpu.ops import pairstats as jps
from subword_tokenizers_tpu.parallel import mesh as jmesh
from subword_tokenizers_tpu.parallel import train as jtrain
from subword_tokenizers_tpu_torch.ops.pairstats import (EMPTY_KEY,
                                                        pair_stats_runs)
from subword_tokenizers_tpu_torch.ops.shard_select import (
    POS_MAX, certificate, compact_table, lookup_runs)
from subword_tokenizers_tpu_torch.parallel import train as ptrain
from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh

torch.set_num_threads(1)

BITS = 21
SENTINEL = 1 << 62
I64_MAX = (1 << 63) - 1


def random_rows(seed, n=96, L=8, n_sym=6, wmax=9):
    """Seeded padded rows (runs of one symbol, lengths 0, 1 and L) and
    their weights."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, size=n)
    lens[:3] = (0, 1, L)
    sym = np.full((n, L), -1, dtype=np.int32)
    for r in range(n):
        s = int(rng.integers(0, n_sym))
        for j in range(int(lens[r])):
            if rng.random() > 0.5:
                s = int(rng.integers(0, n_sym))
            sym[r, j] = s
    return sym, rng.integers(1, wmax + 1, size=n).astype(np.int64)


def to_jax_key(k):
    k = np.asarray(k, dtype=np.int64)
    return np.where(k == EMPTY_KEY, SENTINEL,
                    ((k >> 32) << BITS) | (k & 0xFFFFFFFF))


def to_port_key(k):
    k = np.asarray(k, dtype=np.int64)
    return np.where(k == SENTINEL, EMPTY_KEY,
                    ((k >> BITS) << 32) | (k & ((1 << BITS) - 1)))


def to_jax_pos(p, L):
    p = np.asarray(p, dtype=np.int64)
    return np.where(p == POS_MAX, I64_MAX, (p // L) * (L - 1) + p % L)


def shards(sym, freq, D):
    """(the port's ShardedCorpus on D CPU shards, its K1 tables, and per
    shard the JAX package's sorted runs of the same rows at its global
    positions)."""
    corpus = ptrain.shard_corpus(make_data_mesh(D, devices=["cpu"] * D),
                                 sym, freq)
    tables = [s.pairs() for s in corpus.shards]
    L = corpus.L
    runs = []
    for i, s in enumerate(corpus.shards):
        rows = s.sym.numpy()
        n = rows.shape[0]
        keys, pos = jps.pack_pairs(jnp.asarray(rows), False)
        w = jnp.broadcast_to(jnp.asarray(corpus.freq[i * n:(i + 1) * n])
                             [:, None], (n, L - 1)).reshape(-1)
        runs.append(jps._run_aggregate(keys, pos + i * n * (L - 1), w,
                                       False))
    return corpus, tables, runs


@pytest.mark.parametrize("seed,D", [(0, 4), (1, 8), (2, 2)])
def test_lookup_matches_jax(seed, D):
    sym, freq = random_rows(seed)
    corpus, tables, runs = shards(sym, freq, D)
    present = torch.unique(torch.cat([t[0] for t in tables]))
    absent = torch.tensor([(99 << 32) | 98, (0 << 32) | 77, 77 << 32],
                          dtype=torch.int64)
    cand = torch.cat([present, absent,
                      torch.full((4,), EMPTY_KEY, dtype=torch.int64)])
    cand = cand[torch.randperm(cand.numel(),
                               generator=torch.Generator().manual_seed(seed))]
    for table, base, (k_s, p_s, rt, _) in zip(tables, corpus.bases, runs):
        cnt, pos = lookup_runs(cand, table, base)
        jcnt, jpos = jtrain._lookup_runs(
            k_s, p_s, rt, jnp.asarray(to_jax_key(cand.numpy())),
            jnp.int64(SENTINEL), jnp.int64(I64_MAX))
        assert np.array_equal(cnt.numpy(), np.asarray(jcnt))
        assert np.array_equal(to_jax_pos(pos.numpy(), corpus.L),
                              np.asarray(jpos))
        assert int((cnt > 0).sum()) == int((table[0] != EMPTY_KEY).sum())


@pytest.mark.parametrize("seed,D", [(3, 4), (4, 8)])
def test_compact_matches_jax(seed, D):
    sym, freq = random_rows(seed)
    corpus, tables, runs = shards(sym, freq, D)
    n_live = [int((t[0] != EMPTY_KEY).sum()) for t in tables]
    for cap in (1, max(min(n_live), 1), max(n_live) - 1, max(n_live),
                4096):
        for table, base, (k_s, p_s, rt, is_cand) in zip(
                tables, corpus.bases, runs):
            ck, cc, cp, ovf = compact_table(table, cap, base)
            jck, jcp, jcc, jvalid, jovf = (np.asarray(x) for x in
                                           jps.compact_cands(
                                               k_s, p_s, rt, is_cand, cap,
                                               False))
            jcap = min(cap, k_s.shape[0])
            assert int(ovf[0]) == int(jovf), cap
            live = ck != EMPTY_KEY
            assert int(live.sum()) == int(jvalid.sum())
            assert (cc[~live] == 0).all() and (cp[~live] == POS_MAX).all()
            if jovf:
                continue
            got = sorted(zip(to_jax_key(ck[live].numpy()).tolist(),
                             cc[live].tolist(),
                             to_jax_pos(cp[live].numpy(),
                                        corpus.L).tolist()))
            want = sorted(zip(jck[jvalid].tolist(), jcc[jvalid].tolist(),
                              jcp[jvalid].tolist()))
            assert got == want and len(ck) == cap and len(jck) == jcap


@pytest.mark.parametrize("seed,D", [(5, 8), (6, 4)])
def test_runs_aggregate_matches_jax(seed, D):
    """K1's runs mode over every shard's compacted runs (EMPTY padding
    included) against ``_run_aggregate(gk, gp, gc)``."""
    sym, freq = random_rows(seed)
    corpus, tables, runs = shards(sym, freq, D)
    cap = 64
    parts = [compact_table(t, cap, b) for t, b in zip(tables, corpus.bases)]
    assert not any(int(p[3][0]) for p in parts)
    gk, gc, gp = (torch.cat([p[j] for p in parts]) for j in range(3))
    keys, counts, first = pair_stats_runs(gk, gc, gp)
    jparts = [jps.compact_cands(*r, cap, False) for r in runs]
    K_s, P_s, tot, cand = (np.asarray(x) for x in jps._run_aggregate(
        jnp.concatenate([p[0] for p in jparts]),
        jnp.concatenate([p[1] for p in jparts]),
        jnp.concatenate([p[2] for p in jparts]), False))
    want = sorted(zip(K_s[cand].tolist(), tot[cand].tolist(),
                      P_s[cand].tolist()))
    got = sorted(zip(to_jax_key(keys.numpy()).tolist(), counts.tolist(),
                     to_jax_pos(first.numpy(), corpus.L).tolist()))
    assert got == want
    # the aggregate equals one device's pair table of all the rows
    whole = ptrain.shard_corpus(make_data_mesh(1, devices=["cpu"]), sym,
                                freq).shards[0].pairs()
    assert all(torch.equal(x, y) for x, y in zip((keys, counts, first),
                                                 whole))


def _jax_mesh(D):
    return jmesh.make_data_mesh(D)


def _exact(corpus, sym_freq=None):
    rec = torch.zeros(6, dtype=torch.int32)
    ptrain.sharded_select_full(corpus, rec, sym_freq)
    return rec[:5].tolist()


def _port_topk(corpus, topk, sym_freq=None, wide=False):
    rec = torch.zeros(6, dtype=torch.int32)
    tables = [s.pairs() for s in corpus.shards]
    ptrain.sharded_select_topk(corpus, tables, rec, sym_freq, wide, topk)
    return rec.tolist()


@pytest.mark.parametrize("D,topk", [(8, 4), (8, 16), (2, 256), (4, 64)])
def test_bpe_topk_matches_jax(D, topk):
    proven_seen = set()
    for seed in range(4):
        sym, freq = random_rows(100 + seed, n_sym=5 + seed)
        corpus, _, _ = shards(sym, freq, D)
        a, b, _, _, active, proven = _port_topk(corpus, topk)
        sym_d, freq_d = jtrain.shard_corpus(_jax_mesh(D), sym, freq)
        bk, bc, bf, jproven = jtrain.sharded_bpe_select_topk(
            _jax_mesh(D), sym_d, freq_d, False, topk)
        assert bool(proven) == bool(jproven), seed
        proven_seen.add(bool(proven))
        if proven:
            want = _exact(corpus)
            assert [a, b, active] == [want[0], want[1], want[4]]
            assert int(to_port_key(int(bk))) == (a << 32) | b
    if topk >= 64:
        assert True in proven_seen


def _sym_cap(sym):
    return int(sym.max()) + 9


@pytest.mark.parametrize("D,topk,wide", [(8, 8, False), (4, 256, False),
                                         (8, 32, True)])
def test_wp_topk_matches_jax(D, topk, wide):
    for seed in range(3):
        sym, freq = random_rows(200 + seed, n_sym=6 + 2 * seed,
                                wmax=1 << 18 if wide else 9)
        corpus, _, _ = shards(sym, freq, D)
        sym_cap = _sym_cap(sym)
        sf = ptrain.sharded_sym_freq(corpus, sym_cap)
        a, b, _, _, active, proven = _port_topk(corpus, topk, sf, wide)
        sym_d, freq_d = jtrain.shard_corpus(_jax_mesh(D), sym, freq)
        bk, _, _, bc, jproven = jtrain.sharded_wp_select_topk(
            _jax_mesh(D), sym_d, freq_d, sym_cap, False, topk,
            wide_score=wide)
        assert bool(proven) == bool(jproven), seed
        if proven:
            want = _exact(corpus, sf)
            assert [a, b, active] == [want[0], want[1], want[4]]
            assert int(to_port_key(int(bk))) == (a << 32) | b


def test_wp_topk_unsafe_denominators_veto():
    """Two heavy symbols that appear as one-symbol words of weight 2^32
    (no pairs) and in pairs of weight 1: every K-th and winning
    denominator needs more than 62 bits, so with wide scores every shard
    vetoes, as in the JAX package."""
    rng = np.random.default_rng(7)
    heavy = np.full((16, 4), -1, dtype=np.int32)
    heavy[:, 0] = np.arange(16) % 4
    pairs = rng.integers(0, 4, size=(48, 4)).astype(np.int32)
    sym = np.concatenate([heavy, pairs])
    freq = np.concatenate([np.full(16, 1 << 32), np.ones(48)]).astype(
        np.int64)
    D, topk = 4, 2
    corpus, _, _ = shards(sym, freq, D)
    sf = ptrain.sharded_sym_freq(corpus, _sym_cap(sym))
    *_, proven = _port_topk(corpus, topk, sf, True)
    sym_d, freq_d = jtrain.shard_corpus(_jax_mesh(D), sym, freq)
    *_, jproven = jtrain.sharded_wp_select_topk(
        _jax_mesh(D), sym_d, freq_d, _sym_cap(sym), False, topk,
        wide_score=True)
    assert not proven and not bool(jproven)


def test_topk_all_nominated_is_proven():
    """With K at least every shard's live pairs, every K-th metric is -1
    and the sum of thresholds 0: proven at once, both packages."""
    sym, freq = random_rows(9, n=32, n_sym=3)
    for wp in (False, True):
        corpus, _, _ = shards(sym, freq, 4)
        sf = ptrain.sharded_sym_freq(corpus, _sym_cap(sym)) if wp else None
        *_, proven = _port_topk(corpus, 256, sf)
        assert proven


def _cert(kth, cand, g_cnt, rec, sf=None, wide=False):
    rec = torch.tensor(rec, dtype=torch.int32)
    certificate(torch.tensor(kth, dtype=torch.int64).flatten(),
                torch.tensor(cand, dtype=torch.int64),
                torch.tensor(g_cnt, dtype=torch.int64), rec,
                None if sf is None else torch.tensor(sf, dtype=torch.int64),
                wide)
    return int(rec[5])


def test_certificate_cases():
    """The certificate's arithmetic on hand-made cases, each written out
    with the JAX package's formulas."""
    key = (1 << 32) | 2
    rec = [1, 2, -1, 0, 1, 0]
    # BPE: count 10 against thresholds 4 + 5 and 4 + 6
    assert _cert([[4, 4, 0], [5, 5, 0]], [key], [10], rec) == 1
    assert _cert([[4, 4, 0], [6, 6, 0]], [key], [10], rec) == 0
    assert _cert([[-1, 0, 0], [-1, 0, 0]], [key], [1], rec) == 1  # sum 0
    assert _cert([[-1, 0, 0]], [EMPTY_KEY], [0], [0] * 6) == 1
    # WordPiece over sym_freq: the winner 6 / (3 * 4) = 1/2 scales to
    # 2^35; a K-th entry of 1 / (2 * 2) = 1/4 bounds a shard by 2^34 + 2:
    # one shard leaves room, two reach 2^35 + 4 and the margin refuses
    sf = [0, 3, 4, 2, 2]
    kth1 = [1, 1, (3 << 32) | 4]
    assert _cert([kth1], [key], [6], rec, sf) == 1
    assert _cert([kth1, kth1], [key], [6], rec, sf) == 0
    # the margin: a winner of 1/4 against one K-th entry of 1/4, a tie
    sf2 = [0, 2, 2, 2, 2]
    assert _cert([kth1], [key], [1], rec, sf2) == 0
    # saturation: a K-th count of 2^20 over a symbol of weight 0 bounds
    # the shard by 2^56, past 2^55
    sf3 = [0, 3, 4, 0, 2]
    kth_sat = [1, 1 << 20, (3 << 32) | 4]
    assert _cert([kth_sat, [-1, 0, 0]], [key], [6], rec, sf3) == 0
    assert _cert([[-1, 0, 0]], [key], [6], rec, sf3) == 1
    # wide scores: a K-th denominator of more than 62 bits vetoes; the
    # same numbers without wide scores bound the shard by 2
    big = [0, 3, 4, 1 << 31, 1 << 31]
    assert _cert([kth1], [key], [6], rec, big, wide=True) == 0
    assert _cert([kth1], [key], [6], rec, big, wide=False) == 1
    # a count absent from the candidates (another key) is no winner
    assert _cert([[4, 4, 0]], [(1 << 32) | 3], [10], rec) == 0
