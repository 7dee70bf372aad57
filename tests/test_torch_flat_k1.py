"""The single-device K1 (ops/pairstats.py ``pair_stats``) with its double
buffer of tables: each call fills one :class:`PairTable` and, in the same
launch, empties the entries the other's last fill claimed (no memset).

The kernel runs only on the card, so its launch is emulated here on CPU
tables exactly as the wrapper describes it to the kernel
(``_launch_tables``: the table to fill and its two counters, the claims
and counter of the table to empty): the claimed entries of the other
table are emptied, the fill's spare counter is zeroed, and the plain
version's pairs are inserted with the kernel's hash and probe, each
claim appended. The routes' states (``FlatState`` across a shrink and in
skip mode, ``PaddedState``, the compact tier's runs) then run several
steps with real merges, and every step's table is held against the
plain version and the JAX package's ``flat_aggregate`` /
``pack_pairs`` + ``_run_aggregate``; every emptied table must be empty
over its whole buffer. Every comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subword_tokenizers_tpu import NaiveBPE as JaxNaiveBPE
from subword_tokenizers_tpu import NaiveWP as JaxNaiveWP
from subword_tokenizers_tpu.ops import flat as jax_flat
from subword_tokenizers_tpu.ops import pairstats as jps
from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.core.symbols import SymbolTable
from subword_tokenizers_tpu_torch.ops import flat, pairstats, train_loop
from subword_tokenizers_tpu_torch.ops.pairstats import (EMPTY_KEY, PairTable,
                                                        TablePair, canonical,
                                                        pair_stats_ref,
                                                        pair_stats_runs_ref,
                                                        table_size)
from test_torch_bpe_kernels import random_state
from test_torch_padded_train import random_rows

torch.set_num_threads(1)

BITS = 21  # the JAX package's i64 key layout: a << 21 | b
CORPUS = ["the cat sat on the mat", "aaaa aaa aa a", "banana bandana",
          "a man a plan a canal panama", "mississippi miss sip",
          "the rain in spain stays mainly in the plain"] * 3


def _mix64(x):
    """The kernel's splitmix64 finaliser over uint64."""
    x = x ^ (x >> np.uint64(33))
    x = x * np.uint64(0xff51afd7ed558ccd)
    x = x ^ (x >> np.uint64(33))
    x = x * np.uint64(0xc4ceb9fe1a85ec53)
    return x ^ (x >> np.uint64(33))


def _is_empty(t: PairTable) -> bool:
    return bool((t.keys == EMPTY_KEY).all() and (t.counts == 0).all()
                and (t.pos == -1).all())


def emulate(name, table, clear, T, plain):
    """One launch of the kernel on CPU tables, from the arguments the
    wrapper gives it; returns what the wrapper returns."""
    dev = table.keys.device
    args = pairstats._launch_tables(name, table, clear, T, dev)
    n = table.n.numpy()
    n_fill = (args[5] - table.n.data_ptr()) // 4
    n_next = (args[6] - table.n.data_ptr()) // 4
    if args[7] is not None:  # empty the entries the other's fill claimed
        c = (args[11] - clear.n.data_ptr()) // 4
        idx = clear.claims[:int(clear.n[c])].long()
        clear.keys[idx] = EMPTY_KEY
        clear.counts[idx] = 0
        clear.pos[idx] = -1
    n[n_next] = 0
    assert _is_empty(table), "a table to fill arrived with entries"
    keys, counts, first = plain
    K, C, P = table.keys.numpy(), table.counts.numpy(), table.pos.numpy()
    claims = table.claims.numpy()
    with np.errstate(over="ignore"):
        hashes = _mix64(keys.numpy().view(np.uint64)) & np.uint64(T - 1)
    for k, cnt, p, h in zip(keys.tolist(), counts.tolist(), first.tolist(),
                            hashes.tolist()):
        while K[h] != EMPTY_KEY:
            h = (h + 1) & (T - 1)
        K[h], C[h], P[h] = k, cnt, p
        claims[n[n_fill]] = h
        n[n_fill] += 1
    pairstats._mark(table, clear)
    return table.view(T)


def fake_pair_stats(fs, wid, wgt, table=None, skip=0, clear=None):
    if table is None:
        table = PairTable(fs.shape[0], fs.device)
    return emulate("pair_stats", table, clear, table_size(fs.shape[0]),
                   pair_stats_ref(fs, wid, wgt, skip))


def fake_pair_stats_runs(rk, rc, rp, table=None, clear=None):
    if table is None:
        table = PairTable(rk.shape[0] + 1, rk.device)
    return emulate("pair_stats_runs", table, clear,
                   table_size(rk.shape[0] + 1),
                   pair_stats_runs_ref(rk, rc, rp))


@pytest.fixture
def launches(monkeypatch):
    """The emulated launches, in order: (table filled, table emptied)."""
    seen = []

    def k1(fs, wid, wgt, table=None, skip=0, clear=None):
        seen.append((table, clear))
        return fake_pair_stats(fs, wid, wgt, table, skip, clear)

    def runs(rk, rc, rp, table=None, clear=None):
        seen.append((table, clear))
        return fake_pair_stats_runs(rk, rc, rp, table, clear)

    monkeypatch.setattr(pairstats, "pair_stats", k1)
    monkeypatch.setattr(pairstats, "pair_stats_runs", runs)
    return seen


def jax_flat_runs(fs, wid, wgt):
    """JAX's flat_aggregate as port (keys, counts, first), sorted."""
    k_s, p_s, rt, cand = (np.asarray(x) for x in jax_flat.flat_aggregate(
        jnp.asarray(fs), jnp.asarray(wid), jnp.asarray(wgt), narrow=False))
    k, c, p = k_s[cand], rt[cand], p_s[cand]
    k = ((k >> BITS) << 32) | (k & ((1 << BITS) - 1))
    order = np.argsort(k)
    return k[order], c[order], p[order]


def _merge_steps(st, table, n_steps, skip=0, shrink_at=None, check=None):
    """``n_steps`` steps of K1, K2 and K3 on ``st`` as run_fused queues
    them; ``check(st, got, skip)`` after each K1."""
    max_vocab = len(table) + n_steps
    h1, h2, sl, ctrl, pw1, pw2, _ = train_loop.init_tables(
        table, max_vocab, 64, "cpu")
    stats = torch.zeros(2, dtype=torch.int32)
    rec = torch.zeros(6, dtype=torch.int32)
    merged = 0
    for step in range(n_steps):
        if step == shrink_at:
            st.F //= 2
        if skip:
            st.guard(stats[1:])
        got = st.pairs(skip)
        check(st, got, skip)
        train_loop.select_unify(*got, h1, h2, sl, ctrl, pw1, pw2, max_vocab,
                                rec)
        st.merge(rec, skip)
        merged += int(rec[4])
    return merged


def _check_alternation(pair: TablePair, got, plain):
    """The table just filled holds ``plain`` in its first T entries; the
    other is empty over its whole buffer; the next call fills it."""
    filled = pair.tables[1 - pair._next]
    emptied = pair.tables[pair._next]
    assert filled.dirty and not emptied.dirty
    assert got[0].data_ptr() == filled.keys.data_ptr()
    assert _is_empty(emptied)
    for g, w in zip(canonical(*got), plain):
        assert g.tolist() == w.tolist()
    live = int((filled.keys != EMPTY_KEY).sum())
    assert live == int(filled.n[(filled.fills - 1) % 2]) == plain[0].numel()


def _symbols(n):
    return SymbolTable([chr(ord("a") + i) for i in range(n)])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_flat_route_alternates_and_shrinks(seed, launches):
    """Five consecutive steps of the flat route with real merges, the
    width halved after the second: each step's table equals the plain
    version and JAX's flat_aggregate, the tables alternate, and the table
    filled at the wide width is emptied whole (its claims index the whole
    buffer, beyond the narrower table)."""
    fs, wid, wgt = random_state(seed, n_words=150, n_sym=6)
    n0 = fs.shape[0]
    wide = (np.concatenate([fs, np.full(n0, -1, np.int32)]),
            np.concatenate([wid, np.full(n0, flat.WID_PAD, np.int32)]),
            np.concatenate([wgt, np.zeros(n0, np.int64)]))
    st = train_loop.FlatState(*wide, "cpu")
    st._tables = TablePair(st.F, "cpu")
    T_wide = table_size(st.F)

    def check(st, got, skip):
        arrays = st.arrays()
        plain = pair_stats_ref(*arrays, skip)
        _check_alternation(st._tables, got, plain)
        jk, jc, jp = jax_flat_runs(*(a.numpy() for a in arrays))
        assert plain[0].tolist() == jk.tolist()
        assert plain[1].tolist() == jc.tolist()
        assert plain[2].tolist() == jp.tolist()

    assert _merge_steps(st, _symbols(6), 5, shrink_at=2, check=check) == 5
    assert table_size(st.F) == T_wide // 2
    # the two tables took turns, each emptying the other's last fill
    assert [id(t) for t, _ in launches] == [id(st._tables.tables[i % 2])
                                            for i in range(5)]
    assert all(c is st._tables.tables[(i + 1) % 2]
               for i, (_, c) in enumerate(launches))
    assert [t.fills for t in st._tables.tables] == [3, 2]


def test_skip_mode_steps(launches):
    """Five steps in skip mode (window 3): dead slots stay in place, each
    step's table equals the plain version's, and the tables alternate."""
    fs, wid, wgt = random_state(7, n_words=120, holes=True)
    st = train_loop.FlatState(fs, wid, wgt, "cpu")
    st._tables = TablePair(st.F, "cpu")

    def check(st, got, skip):
        _check_alternation(st._tables, got,
                           pair_stats_ref(*st.arrays(), skip))

    assert _merge_steps(st, _symbols(6), 5, skip=3, check=check) == 5
    assert len(launches) == 5


def test_padded_route_steps(launches):
    """Three steps of the padded layout, its rows as flat slots: each
    table equals JAX's pack_pairs + _run_aggregate (positions row * L + j
    against row * (L - 1) + j) and the tables alternate."""
    sym, freq = random_rows(5, n=200, L=8, inner_pad=True)
    st = train_loop.PaddedState(sym, freq, "cpu")
    st._tables = TablePair(st.sym.numel(), "cpu")
    L = sym.shape[1]

    def check(st, got, skip):
        plain = pair_stats_ref(st.sym.view(-1), st._wid, st._wgt)
        _check_alternation(st._tables, got, plain)
        n = st.sym.shape[0]
        keys, pos = jps.pack_pairs(jnp.asarray(st.sym.numpy()), False)
        w = jnp.broadcast_to(jnp.asarray(freq)[:, None],
                             (n, L - 1)).reshape(-1)
        k_s, p_s, rt, cand = (np.asarray(x) for x in
                              jps._run_aggregate(keys, pos, w, False))
        k = k_s[cand]
        k = ((k >> BITS) << 32) | (k & ((1 << BITS) - 1))
        order = np.argsort(k)
        f = plain[2].numpy()
        assert plain[0].tolist() == k[order].tolist()
        assert plain[1].tolist() == rt[cand][order].tolist()
        assert ((f // L) * (L - 1) + f % L).tolist() == \
            p_s[cand][order].tolist()

    assert _merge_steps(st, _symbols(4), 3, check=check) == 3


def test_runs_mode_alternates(launches):
    """K1's runs mode (the compact tier's re-aggregation) through a
    TablePair: each call equals the plain version and empties the other
    table."""
    rng = np.random.default_rng(3)
    pair = TablePair(600, "cpu")
    for _ in range(4):
        rk = torch.from_numpy(rng.integers(0, 40, size=512).astype(
            np.int64) << 32 | 5)
        rk[rng.random(512) < 0.2] = EMPTY_KEY
        rc = torch.from_numpy(rng.integers(0, 9, size=512).astype(np.int64))
        rp = torch.from_numpy(rng.integers(0, 1 << 20, size=512).astype(
            np.int64))
        got = pair.runs(rk, rc, rp)
        _check_alternation(pair, got, pair_stats_runs_ref(rk, rc, rp))
    assert len(launches) == 4


@pytest.mark.parametrize("cls,jcls", [(NaiveBPE, JaxNaiveBPE),
                                      (NaiveWP, JaxNaiveWP)])
def test_trainer_with_emulated_tables_equals_jax(cls, jcls, monkeypatch,
                                                 launches):
    """The default flat route with every K1 call emulated on a FlatState's
    own TablePair (one launch a step, alternating) gives the JAX
    package's merges."""
    real = train_loop.FlatState

    class Tabled(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._tables = TablePair(self.F, "cpu")

    monkeypatch.setattr(train_loop, "FlatState", Tabled)
    tok = cls(device="cpu")
    tok.train(CORPUS, 60)
    want = jcls()
    want.train(CORPUS, 60)
    if cls is NaiveBPE:
        assert tok.merges_list == want.merges_list
    else:
        assert tok._merge_log == want._merge_log
    assert len(launches) >= 10
    assert all(c is not None and c is not t for t, c in launches)


def test_launch_checks():
    """The wrapper's table checks: a PairTable (not alloc-style tuples),
    empty on entry, large enough, another table to empty."""
    t, other = PairTable(100, "cpu"), PairTable(100, "cpu")
    T = table_size(100)
    with pytest.raises(TypeError, match="PairTable"):
        pairstats._launch_tables("pair_stats", t.view(T), None, T,
                                 torch.device("cpu"))
    with pytest.raises(TypeError, match="clear"):
        pairstats._launch_tables("pair_stats", t, other.view(T), T,
                                 torch.device("cpu"))
    with pytest.raises(ValueError, match="another"):
        pairstats._launch_tables("pair_stats", t, t, T, torch.device("cpu"))
    with pytest.raises(ValueError, match="<"):
        pairstats._launch_tables("pair_stats", t, None, 2 * T,
                                 torch.device("cpu"))
    # the counters: fill j counts in n[j % 2] and zeroes the other; an
    # empty reads the counter of the table's last fill, and nothing is
    # emptied of a table that holds no count
    n0 = t.n.data_ptr()
    args = pairstats._launch_tables("pair_stats", t, other, T,
                                    torch.device("cpu"))
    assert (args[5] - n0, args[6] - n0) == (0, 4)
    assert args[7:] == (None,) * 5
    pairstats._mark(t, other)
    with pytest.raises(ValueError, match="holds a count"):
        pairstats._launch_tables("pair_stats", t, None, T,
                                 torch.device("cpu"))
    args = pairstats._launch_tables("pair_stats", other, t, T,
                                    torch.device("cpu"))
    assert args[7:11] == t.ptrs and args[11] == n0
    pairstats._mark(other, t)
    args = pairstats._launch_tables("pair_stats", t, other, T,
                                    torch.device("cpu"))
    assert (args[5] - n0, args[6] - n0) == (4, 0)
    assert args[11] == other.n.data_ptr()
    # on the CPU the wrapper runs the plain version, whatever the table
    fs, wid, wgt = (torch.from_numpy(x) for x in random_state(1))
    got = pairstats.pair_stats(fs, wid, wgt, table=(1, 2, 3))
    assert all(g.tolist() == w.tolist()
               for g, w in zip(got, pair_stats_ref(fs, wid, wgt)))
