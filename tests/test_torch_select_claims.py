"""K2 (ops/train_loop.py ``select_unify``) in claims mode: it reads only
the entries of a K1 table that the table's last fill claimed (the
``PairTable``'s claim list and the fill's counter), not the whole table.
The kernel runs only on the card; its plain version reads the same
entries. K1's launch is emulated on CPU tables
(``tests/test_torch_flat_k1.emulate``), so the tables are sparse, with
holes where the hash put nothing, and their claim lists are in the
order the emulated inserts claimed them. On seeded states the claims
mode is held against the dense mode over the same table and against the
JAX package's ``_select_and_unify`` (BPE, WordPiece narrow and wide,
the tournament), ``wp_select_core`` and ``_select``: ties broken by
position, an empty claim list, ``host_ids``. The wrappers' new
arguments raise when misused, and whole CPU trains that pass the claims
of their own tables and the loop's scratch equal the JAX package's
merges. Every comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subword_tokenizers_tpu import NaiveBPE as JaxNaiveBPE
from subword_tokenizers_tpu import NaiveWP as JaxNaiveWP
from subword_tokenizers_tpu.ops import flat as jax_flat
from subword_tokenizers_tpu.ops import train_loop as jax_loop
from subword_tokenizers_tpu.ops.pairstats import _select, wp_select_core
from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.core.symbols import SymbolTable
from subword_tokenizers_tpu_torch.ops import train_loop
from subword_tokenizers_tpu_torch.ops.flat import build_flat
from subword_tokenizers_tpu_torch.ops.pairstats import (EMPTY_KEY, PairTable,
                                                        TablePair,
                                                        pair_stats_ref,
                                                        symbol_freqs,
                                                        table_size)
from subword_tokenizers_tpu_torch.ops.train_loop import (SELECT_SCRATCH,
                                                         select_host_ids,
                                                         select_scratch,
                                                         select_unify)
from test_torch_bpe_kernels import random_state
from test_torch_flat_k1 import CORPUS, emulate, launches  # noqa: F401

torch.set_num_threads(1)

JAX_BITS = 21  # the JAX package's i64 key layout: a << 21 | b
SYM_CAP = 40
STATES = [dict(seed=1), dict(seed=2, unit=True), dict(seed=3, holes=True),
          dict(seed=4, wscale=(1 << 28) + 9871),
          dict(seed=5, n_words=40, max_len=22, n_sym=2),
          dict(seed=6, unit=True, n_sym=12)]
# (wordpiece, tournament); the tournament takes narrow scores only
MODES = [(False, False), (True, False), (True, True)]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _filled(fs, wid, wgt):
    """A PairTable filled from the state by the emulated launch (its
    claim list and counter as the kernel leaves them), and its view."""
    table = PairTable(fs.shape[0], "cpu")
    view = emulate("pair_stats", table, None, table_size(fs.shape[0]),
                   pair_stats_ref(*_t(fs, wid, wgt)))
    return table, view


def _wide(fs, wgt):
    return int(wgt[fs >= 0].sum()) >= (1 << 26)


def _strings(n, wordpiece):
    return [("##" if wordpiece else "") + chr(ord("a") + i)
            for i in range(n)]


def _tables(strings, sym_cap):
    h = np.zeros((3, sym_cap), np.int64)
    for i, s in enumerate(strings):
        h[0, i], h[1, i] = jax_loop.str_hashes(s)
        h[2, i] = len(s)
    return h


def _jax_unify(fs, wid, wgt, strings, max_vocab, wordpiece, tournament,
               alive=True):
    """JAX's _select_and_unify over the state: (h1, h2, slen, n_sym,
    vocab, active, a, b, new_id, matched)."""
    n_sym = len(strings)
    sym_cap = max(max_vocab, n_sym) + 8
    h = _tables(strings, sym_cap)
    pw1, pw2 = jax_loop.pow_tables(30)
    sh = jax_loop.str_hashes("##")
    k_s, p_s, rt, ic = jax_flat.flat_aggregate(
        jnp.asarray(fs), jnp.asarray(wid), jnp.asarray(wgt), narrow=False)
    sf = None
    if wordpiece:
        sf = jnp.asarray(symbol_freqs(*_t(fs, wgt), sym_cap).numpy())
    out = jax_loop._select_and_unify(
        k_s, p_s, rt, ic, sf, jnp.asarray(h[0]), jnp.asarray(h[1]),
        jnp.asarray(h[2]), jnp.int32(n_sym), jnp.int32(n_sym),
        jnp.bool_(alive), jnp.asarray(pw1), jnp.asarray(pw2), sh[0], sh[1],
        jnp.int32(max_vocab), False, sym_cap, wordpiece,
        wide_score=wordpiece and _wide(fs, wgt), tournament=tournament)
    h1, h2, sl, n, v, act, a, b, new, mat = (np.asarray(x) for x in out)
    return (h1.tolist(), h2.tolist(), sl.tolist(), int(n), int(v), int(act),
            int(a), int(b), int(new), int(mat))


def _port_unify(fs, wgt, view, strings, max_vocab, wordpiece, tournament,
                claims, alive=True, host_ids=False):
    """The port's select_unify over a table view, with or without its
    claim list; the same tuple as :func:`_jax_unify` (and the redo
    count)."""
    n_sym = len(strings)
    sym_cap = max(max_vocab, n_sym) + 8
    h1, h2, sl = _t(*_tables(strings, sym_cap))
    pw1, pw2 = _t(*jax_loop.pow_tables(30))
    ctrl = torch.tensor([n_sym, n_sym, int(alive)], dtype=torch.int32)
    rec = torch.zeros(6, dtype=torch.int32)
    redo = torch.zeros(1, dtype=torch.int32)
    sf = symbol_freqs(*_t(fs, wgt), sym_cap) if wordpiece else None
    select_unify(*view, h1, h2, sl, ctrl, pw1, pw2, max_vocab, rec,
                 host_ids, wordpiece, sf, jax_loop.str_hashes("##"),
                 tournament, redo, claims=claims,
                 scratch=select_scratch("cpu"))
    a, b, new_id, matched, active, _ = rec.tolist()
    return (h1.tolist(), h2.tolist(), sl.tolist(), int(ctrl[0]),
            int(ctrl[1]), active, a, b, new_id, matched), int(redo)


def _cases():
    for i, cfg in enumerate(STATES):
        for wordpiece, tournament in MODES:
            if tournament and cfg.get("wscale", 1) > 1:
                continue  # wide weights: the tournament cannot take them
            yield pytest.param(cfg, wordpiece, tournament,
                               id=f"s{i}-{'wp' if wordpiece else 'bpe'}"
                                  f"{'-tour' if tournament else ''}")


@pytest.mark.parametrize("cfg,wordpiece,tournament", list(_cases()))
def test_claims_equal_dense_and_jax(cfg, wordpiece, tournament):
    """Claims mode, dense mode over the same sparse table and JAX's
    _select_and_unify agree: the record, the hash tables and ctrl."""
    fs, wid, wgt = random_state(**cfg)
    table, view = _filled(fs, wid, wgt)
    live = int((table.keys != EMPTY_KEY).sum())
    assert 0 < live < table.size // 2  # holes between the entries
    assert table.claimed().tolist() != sorted(table.claimed().tolist())
    strings = _strings(int(fs.max()) + 1, wordpiece)
    want = _jax_unify(fs, wid, wgt, strings, 100, wordpiece, tournament)
    got, redo = _port_unify(fs, wgt, view, strings, 100, wordpiece,
                            tournament, table)
    dense, _ = _port_unify(fs, wgt, view, strings, 100, wordpiece,
                           tournament, None)
    assert got == dense == want
    assert got[5] == 1 and redo in (0, 1)


@pytest.mark.parametrize("wordpiece", [False, True])
@pytest.mark.parametrize("seed", [1, 3, 6])
def test_host_ids_claims_match_jax_selection(seed, wordpiece):
    """host_ids mode over the claims: the winner JAX's _select (BPE) or
    wp_select_core (WordPiece) picks; new_id left to the host."""
    fs, wid, wgt = random_state(seed=seed, holes=seed == 3)
    table, view = _filled(fs, wid, wgt)
    k_s, p_s, rt, ic = jax_flat.flat_aggregate(
        jnp.asarray(fs), jnp.asarray(wid), jnp.asarray(wgt), narrow=False)
    if wordpiece:
        sf = jnp.asarray(symbol_freqs(*_t(fs, wgt), SYM_CAP).numpy())
        key = int(wp_select_core(k_s, p_s, rt, ic, sf, False)[0])
    else:
        key = int(_select(k_s, p_s, rt, ic)[0])
    rec = torch.zeros(6, dtype=torch.int32)
    sym_freq = symbol_freqs(*_t(fs, wgt), SYM_CAP) if wordpiece else None
    select_host_ids(*view, rec, sym_freq, claims=table,
                    scratch=select_scratch("cpu"))
    assert rec.tolist()[:5] == [key >> JAX_BITS,
                                key & ((1 << JAX_BITS) - 1), -1, 0, 1]


def test_ties_go_to_the_least_position_whatever_the_claim_order():
    """Equal counts: the least first position wins, though the claim
    list reads the larger position's entry first."""
    keys = torch.tensor([(1 << 32) | 2, (3 << 32) | 4, (5 << 32) | 6])
    counts = torch.tensor([7, 7, 5])
    first = torch.tensor([40, 9, 1])
    table = PairTable(64, "cpu")
    view = emulate("pair_stats", table, None, table_size(64),
                   (keys, counts, first))
    order = [int(table.keys[i]) for i in table.claimed().tolist()]
    assert order.index(int(keys[0])) < order.index(int(keys[1]))
    for claims in (table, None):
        rec = torch.zeros(6, dtype=torch.int32)
        select_host_ids(*view, rec, claims=claims)
        assert rec.tolist()[:5] == [3, 4, -1, 0, 1]
    # JAX's _select over the same runs
    k_s = jnp.asarray([(1 << JAX_BITS) | 2, (3 << JAX_BITS) | 4,
                       (5 << JAX_BITS) | 6], dtype=jnp.int64)
    key = int(_select(k_s, jnp.asarray([40, 9, 1]), jnp.asarray([7, 7, 5]),
                      jnp.asarray([True, True, True]))[0])
    assert (key >> JAX_BITS, key & ((1 << JAX_BITS) - 1)) == (3, 4)


@pytest.mark.parametrize("wordpiece,tournament", MODES)
def test_empty_claim_list_is_inactive(wordpiece, tournament):
    """A state with no pair: the fill claims nothing, and the step is
    inactive (a = b = 0, nothing appended, ctrl no longer alive), as in
    JAX."""
    sym = np.array([[0, -1], [1, -1], [2, -1]], dtype=np.int32)
    fs, wid, wgt = build_flat(sym, np.array([3, 4, 5]), pad_to=8)
    table, view = _filled(fs, wid, wgt)
    assert table.claimed().numel() == 0
    strings = _strings(3, wordpiece)
    want = _jax_unify(fs, wid, wgt, strings, 100, wordpiece, tournament)
    got, redo = _port_unify(fs, wgt, view, strings, 100, wordpiece,
                            tournament, table)
    assert got == want and got[5:8] == (0, 0, 0) and redo == 0
    got_ids, _ = _port_unify(fs, wgt, view, strings, 100, wordpiece,
                             tournament, table, host_ids=True)
    assert got_ids[5:10] == (0, 0, 0, -1, 0)


def test_claims_argument_checks():
    """The claims must be the PairTable the keys view and must hold a
    fill's count; the scratch must be K2's, on the device."""
    fs, wid, wgt = random_state(seed=1)
    pair = TablePair(fs.shape[0], "cpu")
    T = table_size(fs.shape[0])
    plain = pair_stats_ref(*_t(fs, wid, wgt))
    view = emulate("pair_stats", pair.tables[0], pair.tables[1], T, plain)
    rec = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(TypeError, match="PairTable"):
        select_host_ids(*view, rec, claims=view)
    with pytest.raises(ValueError, match="holds no count"):
        # the other table: never filled, so no counter of a fill
        select_host_ids(*pair.tables[1].view(T), rec,
                        claims=pair.tables[1])
    with pytest.raises(ValueError, match="another table's"):
        select_host_ids(*pair.tables[1].view(T), rec, claims=pair.tables[0])
    # after the next fill the first table is emptied: its claims are gone
    emulate("pair_stats", pair.tables[1], pair.tables[0], T, plain)
    with pytest.raises(ValueError, match="holds no count"):
        select_host_ids(*pair.tables[0].view(T), rec, claims=pair.tables[0])
    select_host_ids(*pair.tables[1].view(T), rec, claims=pair.tables[1])
    assert rec.tolist()[4] == 1
    meta = PairTable(fs.shape[0], "meta")
    with pytest.raises(ValueError, match="claims on meta"):
        select_host_ids(*view, rec, claims=meta)
    for bad, err in ((torch.zeros(SELECT_SCRATCH - 1, dtype=torch.int64),
                      ValueError),
                     (torch.zeros(SELECT_SCRATCH, dtype=torch.int32),
                      TypeError),
                     (torch.zeros(SELECT_SCRATCH, dtype=torch.int64,
                                  device="meta"), ValueError)):
        with pytest.raises(err, match="scratch"):
            select_host_ids(*pair.tables[1].view(T), rec, scratch=bad)
    assert select_scratch("cpu").shape == (SELECT_SCRATCH,)
    assert not select_scratch("cpu").any()


def test_table_pair_reports_the_table_it_filled():
    """TablePair.claims: the table its last call filled, once a fill
    left a count in it; None while the plain version ran instead."""
    fs, wid, wgt = _t(*random_state(seed=2))
    pair = TablePair(fs.shape[0], "cpu")
    assert pair.claims() is None
    pair.pairs(fs, wid, wgt)  # the plain version: the table stays empty
    assert pair.filled is pair.tables[0] and pair.claims() is None


@pytest.mark.parametrize("cls,jcls,tour", [(NaiveBPE, JaxNaiveBPE, "0"),
                                           (NaiveWP, JaxNaiveWP, "0"),
                                           (NaiveWP, JaxNaiveWP, "1")])
def test_trainers_select_over_their_claims(cls, jcls, tour, monkeypatch,
                                           launches):  # noqa: F811
    """The default flat route with K1 emulated on a FlatState's own
    TablePair: every step's K2 reads the claims of the table that step's
    K1 filled, with the run's one scratch, and the merges equal the JAX
    package's (WordPiece also through the tournament)."""
    monkeypatch.setenv("SWT_WP_TOURNAMENT", tour)
    real = train_loop.FlatState

    class Tabled(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._tables = TablePair(self.F, "cpu")

    seen = []
    real_select = train_loop.select_unify

    def spy(keys, *args, claims=None, scratch=None, **kwargs):
        seen.append((claims, scratch, keys.data_ptr()))
        return real_select(keys, *args, claims=claims, scratch=scratch,
                           **kwargs)

    spy.risky_redos = 0  # run_fused adds the run's redos here

    monkeypatch.setattr(train_loop, "FlatState", Tabled)
    monkeypatch.setattr(train_loop, "select_unify", spy)
    tok = cls(device="cpu")
    tok.train(CORPUS, 60)
    want = jcls()
    want.train(CORPUS, 60)
    if cls is NaiveBPE:
        assert tok.merges_list == want.merges_list
    else:
        assert tok._merge_log == want._merge_log
    assert len(seen) == len(launches) >= 10
    for (claims, scratch, ptr), (filled, _) in zip(seen, launches):
        assert claims is filled and ptr == filled.keys.data_ptr()
        assert scratch is seen[0][1] and scratch.shape == (SELECT_SCRATCH,)


def test_padded_and_per_step_routes_pass_claims(monkeypatch, launches):  # noqa: F811,E501
    """The padded route (run_fused(flat=False)) and the exact per-step
    path hand K2 the claims of the table their K1 filled."""
    seen = []
    real_select = train_loop.select_unify

    def spy(*args, claims=None, **kwargs):
        seen.append(claims)
        return real_select(*args, claims=claims, **kwargs)

    spy.risky_redos = 0

    class Tabled(train_loop.PaddedState):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._tables = TablePair(self.sym.numel(), "cpu")

    monkeypatch.setattr(train_loop, "select_unify", spy)
    monkeypatch.setattr(train_loop, "PaddedState", Tabled)
    fs, wid, wgt = random_state(seed=4, n_words=60)
    n = int(fs.max()) + 1
    table = SymbolTable([chr(ord("a") + i) for i in range(n)])
    train_loop.run_fused(train_loop.FlatState(fs, wid, wgt, "cpu"), table,
                         n + 6, 9, lambda *m: None, flat=False)
    assert len(seen) == len(launches) >= 6
    assert all(c is t for c, (t, _) in zip(seen, launches))
    st = train_loop.FlatState(fs, wid, wgt, "cpu")
    st._tables = TablePair(st.F, "cpu")
    rec = torch.zeros(6, dtype=torch.int32)
    table = SymbolTable([chr(ord("a") + i) for i in range(n)])
    assert train_loop.step_host_ids(st, table, rec) is not None
    assert seen[-1] is st._tables.tables[0] is launches[-1][0]


def test_sharded_compact_tier_passes_its_runs_claims(monkeypatch, launches):  # noqa: F811,E501
    """The compact tier's K2 reads the claims of the runs table K1's runs
    mode filled, and all tiers share the corpus's one scratch."""
    from subword_tokenizers_tpu_torch.parallel import train as ptrain
    from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh
    seen = []
    real = ptrain.select_host_ids

    def spy(*args, claims=None, scratch=None, **kwargs):
        seen.append((claims, scratch))
        return real(*args, claims=claims, scratch=scratch, **kwargs)

    monkeypatch.setattr(ptrain, "select_host_ids", spy)
    fs, wid, wgt = random_state(seed=5, n_words=64)
    st = train_loop.FlatState(fs, wid, wgt, "cpu")
    sym = train_loop._flat_to_padded(fs, wid, st.n_words)
    freq = np.array([wgt[fs >= 0][wid[fs >= 0] == w][0]
                     for w in range(st.n_words)], dtype=np.int64)
    corpus = ptrain.shard_corpus(make_data_mesh(2, devices=["cpu"] * 2),
                                 sym, freq)
    corpus._runs_tables = TablePair(4096, "cpu")
    rec = torch.zeros(6, dtype=torch.int32)
    tables = corpus.pairs()
    ptrain.sharded_select_topk(corpus, tables, rec)
    ptrain.sharded_select_compact(corpus, tables, rec, 1024)
    compact = rec.tolist()
    assert seen[0][0] is None  # the gathered candidates: dense
    assert seen[1][0] is corpus._runs_tables.filled is not None
    assert all(s is corpus.k2_scratch for _, s in seen)
    # the same winner as the full tier over every row
    ptrain.sharded_select_full(corpus, rec)
    assert rec.tolist()[:5] == compact[:5]
