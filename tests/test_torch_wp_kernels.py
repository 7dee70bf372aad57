"""The plain PyTorch versions of the port's WordPiece training kernels
(K2 ``select_unify`` in WordPiece mode, K3 ``merge_apply`` carrying
``sym_freq``, K4 ``symbol_freqs``) against the JAX package's functions
(``wp_select_core``, ``_select_and_unify(wordpiece=True)``,
``symbol_freqs``, the carried update of ``flat_train_steps``) on the same
seeded inputs. Every comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subword_tokenizers_tpu.core.corpus import build_wp_corpus as \
    jax_build_wp_corpus
from subword_tokenizers_tpu.core.symbols import SymbolTable as JaxTable
from subword_tokenizers_tpu.ops import flat as jax_flat
from subword_tokenizers_tpu.ops import train_loop as jax_loop
from subword_tokenizers_tpu.ops.pairstats import symbol_freqs as \
    jax_symbol_freqs
from subword_tokenizers_tpu.ops.pairstats import wp_select_core
from subword_tokenizers_tpu_torch.core.corpus import build_wp_corpus
from subword_tokenizers_tpu_torch.core.symbols import SymbolTable
from subword_tokenizers_tpu_torch.ops import flat, train_loop
from subword_tokenizers_tpu_torch.ops.bitmath import score_bits
from subword_tokenizers_tpu_torch.ops.flat import merge_apply
from subword_tokenizers_tpu_torch.ops.pairstats import (EMPTY_KEY,
                                                        pair_stats_ref,
                                                        symbol_freqs)
from subword_tokenizers_tpu_torch.ops.train_loop import (select_unify,
                                                         select_unify_ref)

torch.set_num_threads(1)

JAX_BITS = 21  # the JAX package's i64 key layout: a << 21 | b
SYM_CAP = 40


def random_state(seed, n_words=120, max_len=9, n_sym=6, wscale=1,
                 unit=False):
    """A seeded flat state (numpy fs, wid, wgt) with word boundaries, tail
    padding and runs of equal symbols. ``unit`` makes every weight
    ``wscale``, so exact score ties are decided by first position."""
    rng = np.random.default_rng(seed)
    sym = np.full((n_words, max_len), -1, dtype=np.int32)
    for w in range(n_words):
        n = int(rng.integers(1, max_len + 1))
        s = int(rng.integers(0, n_sym))
        for j in range(n):
            if rng.random() > 0.45:
                s = int(rng.integers(0, n_sym))
            sym[w, j] = s
    freq = (np.ones(n_words, np.int64) if unit
            else rng.integers(1, 50, size=n_words)) * wscale
    return flat.build_flat(sym, freq, pad_to=64)


STATES = [dict(seed=1), dict(seed=2, unit=True),
          dict(seed=3, wscale=(1 << 28) + 9871),
          dict(seed=4, n_words=40, max_len=22, n_sym=2),
          dict(seed=5, unit=True, wscale=(1 << 28) + 9871, n_sym=3),
          dict(seed=6, n_sym=12, wscale=1 << 20)]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _wide(fs, wgt):
    """The JAX model's switch to the wide scorer: 2**26 occurrences."""
    return int(wgt[fs >= 0].sum()) >= (1 << 26)


def _jax_winner(fs, wid, wgt):
    k_s, p_s, run_total, is_cand = jax_flat.flat_aggregate(
        jnp.asarray(fs), jnp.asarray(wid), jnp.asarray(wgt), narrow=False)
    sf = jax_symbol_freqs(jnp.asarray(fs), jnp.asarray(wgt), SYM_CAP)
    return [int(x) for x in wp_select_core(
        k_s, p_s, run_total, is_cand, sf, False, None, _wide(fs, wgt))]


def _port_winner(fs, wid, wgt):
    """K1, K4 and K2's WordPiece selection (host_ids mode): (a, b, count,
    first, score bits)."""
    keys, counts, first = pair_stats_ref(*_t(fs, wid, wgt))
    sf = symbol_freqs(*_t(fs, wgt), SYM_CAP)
    rec = torch.zeros(6, dtype=torch.int32)
    z = torch.zeros(1, dtype=torch.int64)
    select_unify(keys, counts, first, z, z, z,
                 torch.zeros(3, dtype=torch.int32), z, z, 0, rec,
                 host_ids=True, wordpiece=True, sym_freq=sf)
    a, b, new_id, matched, active, _ = rec.tolist()
    assert active == 1 and (new_id, matched) == (-1, 0)
    at = keys.tolist().index((a << 32) | b)
    bits = score_bits(counts[at:at + 1], sf[a:a + 1], sf[b:b + 1])
    return a, b, int(counts[at]), int(first[at]), int(bits)


@pytest.mark.parametrize("cfg", STATES)
def test_symbol_freqs_match_jax(cfg):
    fs, wid, wgt = random_state(**cfg)
    want = np.asarray(jax_symbol_freqs(jnp.asarray(fs), jnp.asarray(wgt),
                                       SYM_CAP))
    got = symbol_freqs(*_t(fs, wgt), SYM_CAP)
    assert got.dtype == torch.int64 and got.tolist() == want.tolist()
    assert int(got[SYM_CAP]) == 0


@pytest.mark.parametrize("cfg", STATES)
def test_wp_selection_matches_wp_select_core(cfg):
    fs, wid, wgt = random_state(**cfg)
    bk, bb, bf, bc = _jax_winner(fs, wid, wgt)
    a, b, count, first, bits = _port_winner(fs, wid, wgt)
    assert (a, b) == (bk >> JAX_BITS, bk & ((1 << JAX_BITS) - 1))
    assert (bits, first, count) == (bb, bf, bc)


def test_wide_states_reach_the_wide_scorer():
    fs, _, wgt = random_state(**STATES[2])
    sf = symbol_freqs(*_t(fs, wgt), SYM_CAP)
    assert _wide(fs, wgt) and int(sf.max()) ** 2 >= 1 << 53


def _table(entries, sym_freq):
    """A K1-style table from (a, b, count, pos) rows, with empty entries
    between them, and JAX's aggregated arrays for the same pairs."""
    T = 2 * len(entries) + 2
    keys = torch.full((T,), EMPTY_KEY, dtype=torch.int64)
    counts = torch.zeros(T, dtype=torch.int64)
    pos = torch.zeros(T, dtype=torch.int32)
    for i, (a, b, c, p) in enumerate(entries):
        keys[2 * i + 1], counts[2 * i + 1], pos[2 * i + 1] = \
            (a << 32) | b, c, p
    F = len(entries) + 2
    k_s = np.full(F, 1 << 62, dtype=np.int64)
    p_s = np.full(F, np.iinfo(np.int64).max, dtype=np.int64)
    rt = np.zeros(F, dtype=np.int64)
    ic = np.zeros(F, dtype=bool)
    for i, (a, b, c, p) in enumerate(entries):
        k_s[i], p_s[i], rt[i], ic[i] = (a << JAX_BITS) | b, p, c, True
    sf = jnp.asarray(np.asarray(sym_freq, dtype=np.int64))
    jax_args = (jnp.asarray(k_s), jnp.asarray(p_s), jnp.asarray(rt),
                jnp.asarray(ic), sf)
    return (keys, counts, pos), jax_args


def _select_table(tab, sym_freq):
    rec = torch.zeros(6, dtype=torch.int32)
    z = torch.zeros(1, dtype=torch.int64)
    select_unify_ref(*tab, z, z, z, torch.zeros(3, dtype=torch.int32), z, z,
                     0, rec, host_ids=True, wordpiece=True,
                     sym_freq=torch.tensor(sym_freq, dtype=torch.int64))
    return rec.tolist()[:2]


def test_bezout_near_tie():
    """Two scores c1/(A q) and c2/(A p) whose cross products differ by
    one (relative gap about 2**-51): the exact doubles decide, as in the
    JAX package's exact path, whichever position comes first."""
    q, p = (1 << 26) - 1, (1 << 26) - 3
    c1 = (1 << 25) - 1
    c2 = (c1 * p - 1) // q
    assert c2 * q == c1 * p - 1
    A = (1 << 20) + 7
    sym_freq = [1, A, p, q, 1]
    for pos1, pos2 in ((5, 9), (9, 5)):
        tab, jax_args = _table([(1, 3, c1, pos1), (1, 2, c2, pos2)],
                               sym_freq)
        bk = int(wp_select_core(*jax_args, False)[0])
        assert _select_table(tab, sym_freq) == \
            [bk >> JAX_BITS, bk & ((1 << JAX_BITS) - 1)]
    s1, s2 = (c1 / (A * q), c2 / (A * p))
    assert s1 != s2 and abs(s1 - s2) / s1 < 2 ** -50


def test_exact_score_tie_goes_to_first_position():
    """6/(12*18) == 6/(18*12): equal doubles, the earlier pair wins."""
    sym_freq = [1, 12, 18, 18, 12]
    tab, jax_args = _table([(1, 2, 6, 11), (3, 4, 6, 3)], sym_freq)
    bk = int(wp_select_core(*jax_args, False)[0])
    assert _select_table(tab, sym_freq) == [3, 4] == \
        [bk >> JAX_BITS, bk & ((1 << JAX_BITS) - 1)]


def _wp_strings(n):
    """Symbol strings for random states, where any symbol may stand
    right of a pair: all continuations ("##" + a letter), as every right
    part of a WordPiece pair is."""
    return ["##" + chr(ord("a") + i) for i in range(n)]


def _unify_case(strings, fs, wid, wgt, max_vocab, n_sym, sharp=None):
    """The port's select_unify_ref and JAX's _select_and_unify in
    WordPiece mode on one state and symbol table; both outcomes as plain
    tuples, and the merged string's host hashes."""
    sym_cap = max(max_vocab, n_sym) + 8
    h = np.zeros((3, sym_cap), np.int64)
    for i, s in enumerate(strings[:n_sym]):
        h[0, i], h[1, i] = jax_loop.str_hashes(s)
        h[2, i] = len(s)
    pw1, pw2 = jax_loop.pow_tables(12)
    sh = jax_loop.str_hashes("##") if sharp is None else sharp
    k_s, p_s, run_total, is_cand = jax_flat.flat_aggregate(
        jnp.asarray(fs), jnp.asarray(wid), jnp.asarray(wgt), narrow=False)
    sf = np.zeros(sym_cap + 1, np.int64)
    sf[:SYM_CAP + 1] = np.asarray(jax_symbol_freqs(
        jnp.asarray(fs), jnp.asarray(wgt), SYM_CAP))
    out = jax_loop._select_and_unify(
        k_s, p_s, run_total, is_cand, jnp.asarray(sf), jnp.asarray(h[0]),
        jnp.asarray(h[1]), jnp.asarray(h[2]), jnp.int32(n_sym),
        jnp.int32(n_sym), jnp.bool_(True), jnp.asarray(pw1),
        jnp.asarray(pw2), sh[0], sh[1], jnp.int32(max_vocab), False,
        sym_cap, True, wide_score=_wide(fs, wgt))
    jh1, jh2, jsl, jn, jv, jact, ja, jb, jnew, jmat = (np.asarray(x)
                                                       for x in out)
    want = (jh1.tolist(), jh2.tolist(), jsl.tolist(), int(jn), int(jv),
            int(jact), int(ja), int(jb), int(jnew), int(jmat))

    th1, th2, tsl, tpw1, tpw2 = _t(*h, pw1, pw2)
    ctrl = torch.tensor([n_sym, n_sym, 1], dtype=torch.int32)
    rec = torch.zeros(6, dtype=torch.int32)
    keys, counts, first = pair_stats_ref(*_t(fs, wid, wgt))
    select_unify(keys, counts, first, th1, th2, tsl, ctrl, tpw1, tpw2,
                 max_vocab, rec, wordpiece=True,
                 sym_freq=torch.from_numpy(sf), sharp=sh)
    a, b, new_id, matched, active, _ = rec.tolist()
    got = (th1.tolist(), th2.tolist(), tsl.tolist(), int(ctrl[0]),
           int(ctrl[1]), active, a, b, new_id, matched)
    return got, want


@pytest.mark.parametrize("cfg", STATES[:4])
def test_wp_unify_miss_matches_jax(cfg):
    fs, wid, wgt = random_state(**cfg)
    strings = _wp_strings(int(fs.max()) + 1)
    got, want = _unify_case(strings, fs, wid, wgt, 100, len(strings))
    assert got == want
    n = len(strings)
    a, b = got[6], got[7]
    assert got[9] == 0 and got[3] == n + 1  # appended
    merged = strings[a] + strings[b][2:]
    assert (got[0][n], got[1][n], got[2][n]) == (
        *train_loop.str_hashes(merged), len(merged))


def test_wp_unify_hits_the_stripped_string():
    """The merged string a + b[2:] already present, twice: the hit takes
    the largest id, as JAX does; a + b (not stripped) is a decoy."""
    fs, wid, wgt = random_state(seed=1)
    strings = _wp_strings(int(fs.max()) + 1)
    a, b = _port_winner(fs, wid, wgt)[:2]
    merged = strings[a] + strings[b][2:]
    table = strings + [merged, strings[a] + strings[b], merged, "q"]
    got, want = _unify_case(table, fs, wid, wgt, 100, len(table))
    assert got == want
    assert got[9] == 1 and got[8] == len(strings) + 2
    assert got[3] == len(table)


def test_sharp_strip_with_negative_difference():
    """h[b] - h("##") B^k taken below zero before the reduction: C's %
    would leave it negative, JAX's and Python's do not. Forced with
    sharp hashes above b's."""
    fs, wid, wgt = random_state(seed=2, unit=True)
    strings = _wp_strings(int(fs.max()) + 1)
    a, b = _port_winner(fs, wid, wgt)[:2]
    hb = jax_loop.str_hashes(strings[b])
    pw1, pw2 = jax_loop.pow_tables(12)
    k = len(strings[b]) - 2
    M = jax_loop.MOD
    # sharp * B^k = M - 1 (mod M) in both bases: the difference is
    # h[b] - (M - 1) < 0
    sharp = tuple((M - 1) * pow(int(pw[k]), -1, M) % M for pw in (pw1, pw2))
    assert all(hb[j] - sharp[j] * int((pw1, pw2)[j][k]) % M < 0
               for j in range(2))
    got, want = _unify_case(strings, fs, wid, wgt, 100, len(strings),
                            sharp=sharp)
    assert got == want
    n = len(strings)
    assert all(0 <= x < jax_loop.MOD for x in (got[0][n], got[1][n]))


def test_real_sharp_strip_equals_host_hashes():
    """With the real hashes of "##", the device-side merged hash of a
    WordPiece pair equals str_hashes(sa + sb[2:]) on the host, for
    continuation parts of several lengths."""
    table = SymbolTable()
    c = build_wp_corpus(["żółw", "abcdef", "ab", "##x"],
                        np.array([3, 2, 5, 1]), table)
    strings = table.strings() + ["##bcd", "żó", "##óło"]
    h = np.array([train_loop.str_hashes(s) for s in strings]).T
    pw1, pw2 = train_loop.pow_tables(8)
    sh = train_loop.str_hashes("##")
    M = train_loop.MOD
    for sa in strings:
        for sb in strings:
            if not sb.startswith("##"):
                continue
            ia, ib = strings.index(sa), strings.index(sb)
            k = max(len(sb) - 2, 0)
            hb = [(h[j, ib] - sh[j] * int((pw1, pw2)[j][k])) % M
                  for j in range(2)]
            m = tuple((int(h[j, ia]) * int((pw1, pw2)[j][k]) % M + hb[j])
                      % M for j in range(2))
            assert m == train_loop.str_hashes(sa + sb[2:]), (sa, sb)
    assert c.sym.shape == (4, 6)


@pytest.mark.parametrize("cfg", [STATES[0], STATES[3], STATES[4]])
def test_carried_weights_equal_a_recount(cfg):
    """50 exact per-step merges (K1, K2 WordPiece selection, host ids, K3
    with sym_freq): after each, the carried table equals a fresh
    symbol_freqs, and the JAX package's update from flat_apply's n_rep
    gives it too. Self-merges occur among them."""
    fs, wid, wgt = random_state(**cfg)
    state = train_loop.FlatState(fs, wid, wgt, "cpu")
    state.count_symbols(SYM_CAP + 60)
    n0 = int(fs.max()) + 1
    table = SymbolTable(_wp_strings(n0))
    rec = torch.zeros(6, dtype=torch.int32)
    jax_sf = jnp.asarray(state.sym_freq.numpy().copy())
    self_merges = 0
    for step in range(50):
        jfs, jwid, jwgt = (jnp.asarray(x.numpy().copy())
                           for x in state.arrays())
        got = train_loop.step_host_ids(state, table, rec, wordpiece=True)
        if got is None:
            break
        a, b, new_id = rec.tolist()[:3]
        self_merges += a == b
        n_rep = jax_flat.flat_apply(jfs, jwid, jwgt, a, b, new_id)[3]
        jax_sf = jax_sf.at[a].add(-n_rep).at[b].add(-n_rep) \
                       .at[new_id].add(n_rep)
        fs_now, _, wgt_now = state.arrays()
        fresh = symbol_freqs(fs_now, wgt_now, SYM_CAP + 60)
        assert state.sym_freq.tolist() == fresh.tolist(), step
        assert state.sym_freq.tolist() == np.asarray(jax_sf).tolist()
    assert step >= 20
    if cfg is STATES[3]:
        assert self_merges > 0


def test_self_merge_subtracts_twice():
    sym = np.array([[0, 0, 0, -1], [0, 0, 0, 0], [1, 0, 0, -1]],
                   dtype=np.int32)
    fs, wid, wgt = flat.build_flat(sym, np.array([1, 2, 3]), pad_to=8)
    sf = symbol_freqs(*_t(fs, wgt), 8)
    assert sf.tolist()[:2] == [1 * 3 + 2 * 4 + 3 * 2, 3]
    rec = torch.tensor([0, 0, 5, 0, 1, 0], dtype=torch.int32)
    nfs, _, nwgt, n_rep = merge_apply(*_t(fs, wid, wgt), rec, sym_freq=sf)
    assert int(n_rep) == 1 + 2 * 2 + 3
    assert sf.tolist() == symbol_freqs(nfs, nwgt, 8).tolist()
    assert sf.tolist()[:2] == [17 - 2 * 8, 3] and int(sf[5]) == 8
    # an inactive step leaves the table alone
    before = sf.clone()
    inactive = torch.tensor([1, 0, 9, 0, 0, 0], dtype=torch.int32)
    merge_apply(*_t(fs, wid, wgt), inactive, sym_freq=sf)
    assert sf.tolist() == before.tolist()


def test_build_wp_corpus_matches_jax():
    words = ["żółw", "ab", "a", "abcab", "##"]
    freq = np.array([3, 1, 4, 1, 5])
    t, jt = SymbolTable(), JaxTable()
    c = build_wp_corpus(words, freq, t)
    jc = jax_build_wp_corpus(words, freq, jt)
    assert np.array_equal(c.sym, jc.sym) and t.strings() == jt.strings()
    assert t.strings()[:4] == ["ż", "##ó", "##ł", "##w"]
    assert np.array_equal(c.freq, jc.freq) and c.words == jc.words


def test_wrappers_check_wordpiece_arguments():
    fs, wid, wgt = _t(*random_state(seed=1))
    keys, counts, first = pair_stats_ref(fs, wid, wgt)
    z = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="needs sym_freq"):
        select_unify(keys, counts, first, z, z, z,
                     torch.zeros(3, dtype=torch.int32), z, z, 0,
                     torch.zeros(6, dtype=torch.int32), host_ids=True,
                     wordpiece=True)
    with pytest.raises(ValueError, match="no kernel"):
        symbol_freqs(fs.to("meta"), wgt.to("meta"), 8)
    with pytest.raises(TypeError):
        symbol_freqs(fs, wgt.to(torch.int32), 8)
    with pytest.raises(TypeError):
        merge_apply(fs, wid, wgt, torch.zeros(6, dtype=torch.int32),
                    sym_freq=torch.zeros(8, dtype=torch.int32))
