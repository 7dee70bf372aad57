"""The plain PyTorch versions of the port's BPE training kernels (K1
``pair_stats``, K2 ``select_unify``, K3 ``merge_apply``) and its front
end, against the JAX package's functions on the same seeded inputs.
Every comparison is exact."""
import collections
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subword_tokenizers_tpu.core.corpus import build_bpe_corpus as \
    jax_build_bpe_corpus
from subword_tokenizers_tpu.core.corpus import unique_words as \
    jax_unique_words
from subword_tokenizers_tpu.core.symbols import SymbolTable as JaxTable
from subword_tokenizers_tpu.frontend import pretokenize as jax_pretok
from subword_tokenizers_tpu.ops import flat as jax_flat
from subword_tokenizers_tpu.ops import train_loop as jax_loop
from subword_tokenizers_tpu.ops.pairstats import _select
from subword_tokenizers_tpu_torch.core.corpus import (build_bpe_corpus,
                                                      unique_words)
from subword_tokenizers_tpu_torch.core.symbols import SymbolTable
from subword_tokenizers_tpu_torch.frontend import pretokenize
from subword_tokenizers_tpu_torch.ops import flat, pairstats, train_loop
from subword_tokenizers_tpu_torch.ops.flat import (N_LIVE, merge_apply,
                                                   merge_apply_ref)
from subword_tokenizers_tpu_torch.ops.pairstats import (canonical,
                                                        pair_stats,
                                                        pair_stats_ref)
from subword_tokenizers_tpu_torch.ops.train_loop import (select_unify,
                                                         select_unify_ref)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BITS = 21  # the JAX package's i64 key layout: a << 21 | b


def random_state(seed, n_words=120, max_len=9, n_sym=6, wscale=1,
                 holes=False, unit=False):
    """A seeded flat state (numpy fs, wid, wgt) with word boundaries, tail
    padding and runs of equal symbols of odd and even length. ``unit``
    makes every weight ``wscale`` (ties decided by first position only);
    ``holes`` kills some slots inside the state, as a deferred
    compaction leaves them."""
    rng = np.random.default_rng(seed)
    L = max_len
    sym = np.full((n_words, L), -1, dtype=np.int32)
    for w in range(n_words):
        n = int(rng.integers(1, L + 1))
        s = int(rng.integers(0, n_sym))
        for j in range(n):
            if rng.random() > 0.45:
                s = int(rng.integers(0, n_sym))
            sym[w, j] = s
    freq = (np.ones(n_words, np.int64) if unit
            else rng.integers(1, 50, size=n_words)) * wscale
    fs, wid, wgt = flat.build_flat(sym, freq, pad_to=64)
    if holes:
        dead = (rng.random(fs.shape[0]) < 0.08) & (fs >= 0)
        fs[dead] = -1
        wid[dead] = flat.WID_PAD
        wgt[dead] = 0
    return fs, wid, wgt


STATES = [dict(seed=1), dict(seed=2, unit=True), dict(seed=3, holes=True),
          dict(seed=4, wscale=(1 << 28) + 9871),
          dict(seed=5, n_words=40, max_len=22, n_sym=2),
          dict(seed=6, unit=True, wscale=1 << 42, n_sym=3)]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _counter(fs, wid, wgt):
    counts, first = collections.Counter(), {}
    for i in range(len(fs) - 1):
        if fs[i] >= 0 and fs[i + 1] >= 0 and wid[i] == wid[i + 1]:
            key = (int(fs[i]) << 32) | int(fs[i + 1])
            counts[key] += int(wgt[i])
            first.setdefault(key, i)
    return counts, first


def _winner(fs, wid, wgt):
    """The port's winner: K1 and K2's selection (host_ids mode)."""
    keys, counts, first = pair_stats(*_t(fs, wid, wgt))
    rec = torch.zeros(6, dtype=torch.int32)
    z = torch.zeros(1, dtype=torch.int64)
    select_unify(keys, counts, first, z, z, z,
                 torch.zeros(3, dtype=torch.int32), z, z, 0, rec,
                 host_ids=True)
    return (keys, counts, first), rec


def test_build_flat_matches_jax():
    rng = np.random.default_rng(11)
    sym = np.where(rng.random((50, 7)) < 0.3, -1,
                   rng.integers(0, 9, size=(50, 7))).astype(np.int32)
    sym = np.sort(sym, axis=1)[:, ::-1].copy()  # live prefix, pad suffix
    freq = rng.integers(1, 1 << 40, size=50)
    want = jax_flat.build_flat(sym, freq)
    got = flat.build_flat(sym, freq)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("cfg", STATES)
def test_pair_stats_and_selection_match_jax(cfg):
    fs, wid, wgt = random_state(**cfg)
    (keys, counts, first), rec = _winner(fs, wid, wgt)
    # the full table against a Counter oracle
    want_c, want_f = _counter(fs, wid, wgt)
    assert keys.tolist() == sorted(want_c)
    assert counts.tolist() == [want_c[k] for k in sorted(want_c)]
    assert first.tolist() == [want_f[k] for k in sorted(want_c)]
    # the winner against JAX's flat_aggregate + _select
    k_s, p_s, run_total, is_cand = jax_flat.flat_aggregate(
        jnp.asarray(fs), jnp.asarray(wid), jnp.asarray(wgt), narrow=False)
    best_key, best_count, best_first = (int(x) for x in _select(
        k_s, p_s, run_total, is_cand))
    a, b, new_id, matched, active, _ = rec.tolist()
    assert active == 1 and (new_id, matched) == (-1, 0)
    assert (a, b) == (best_key >> JAX_BITS,
                      best_key & ((1 << JAX_BITS) - 1))
    at = keys.tolist().index((a << 32) | b)
    assert (int(counts[at]), int(first[at])) == (best_count, best_first)


def test_tie_decided_by_first_position():
    # (c, d) and (a, b) both count 2; (c, d) is seen first.
    sym = np.array([[2, 3, -1], [0, 1, -1], [2, 3, 0], [4, 0, 1]],
                   dtype=np.int32)
    fs, wid, wgt = flat.build_flat(sym, np.ones(4, np.int64), pad_to=8)
    _, rec = _winner(fs, wid, wgt)
    assert rec.tolist()[:2] == [2, 3]


def test_empty_table_is_inactive():
    fs, wid, wgt = flat.build_flat(np.array([[0, -1], [1, -1]], np.int32),
                                   np.ones(2, np.int64), pad_to=8)
    (keys, _, _), rec = _winner(fs, wid, wgt)
    assert keys.numel() == 0 and rec.tolist()[:5] == [0, 0, -1, 0, 0]


def _merge_cases(fs, wid, wgt):
    """(a, b) pairs to merge: the winner, the best self-pair, an absent
    pair."""
    (keys, counts, _), rec = _winner(fs, wid, wgt)
    cases = [tuple(rec.tolist()[:2])]
    ks = keys.tolist()
    selfs = [(k >> 32, c) for k, c in zip(ks, counts.tolist())
             if k >> 32 == k & 0xFFFFFFFF]
    if selfs:
        s = max(selfs, key=lambda t: t[1])[0]
        cases.append((s, s))
    cases.append((int(fs.max()) + 1, 0))
    return cases


@pytest.mark.parametrize("cfg", STATES)
def test_merge_apply_matches_jax_flat_apply(cfg):
    fs, wid, wgt = random_state(**cfg)
    new_id = int(fs.max()) + 7
    for a, b in _merge_cases(fs, wid, wgt):
        want = jax_flat.flat_apply(jnp.asarray(fs), jnp.asarray(wid),
                                   jnp.asarray(wgt), a, b, new_id)
        rec = torch.tensor([a, b, new_id, 0, 1, 0], dtype=torch.int32)
        got = merge_apply(*_t(fs, wid, wgt), rec)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), (a, b)
        assert int(rec[N_LIVE]) == int((np.asarray(want[0]) >= 0).sum())


def test_merge_apply_self_runs():
    """Runs of odd and even length within and across words: aaa|aaa,
    aaaa, a a."""
    sym = np.array([[0, 0, 0, -1], [0, 0, 0, -1], [0, 0, 0, 0],
                    [0, 1, 0, 0]], dtype=np.int32)
    fs, wid, wgt = flat.build_flat(sym, np.array([1, 2, 3, 4]), pad_to=8)
    rec = torch.tensor([0, 0, 5, 0, 1, 0], dtype=torch.int32)
    got = merge_apply(*_t(fs, wid, wgt), rec)
    want = jax_flat.flat_apply(jnp.asarray(fs), jnp.asarray(wid),
                               jnp.asarray(wgt), 0, 0, 5)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    nfs, nwid, _, n_rep = got
    assert nfs.tolist()[:9] == [5, 0, 5, 0, 5, 5, 0, 1, 5]
    assert nwid.tolist()[:9] == [0, 0, 1, 1, 2, 2, 3, 3, 3]
    assert int(n_rep) == 1 + 2 + 3 * 2 + 4


@pytest.mark.parametrize("cfg", STATES[:3])
def test_inactive_step_changes_nothing(cfg):
    fs, wid, wgt = random_state(**cfg)
    a, b = _winner(fs, wid, wgt)[1].tolist()[:2]
    for rec in (torch.tensor([a, b, 99, 0, 0, 0], dtype=torch.int32),
                torch.tensor([-3, -3, 99, 0, 1, 0], dtype=torch.int32)):
        want = jax_flat.flat_apply(jnp.asarray(fs), jnp.asarray(wid),
                                   jnp.asarray(wgt), -3, -3, 99)
        got = merge_apply_ref(*_t(fs, wid, wgt), rec)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
        assert int(got[3]) == 0
    if not cfg.get("holes"):  # a compacted state comes back unchanged
        assert np.array_equal(got[0].numpy(), fs)


def _unify_case(strings, fs, wid, wgt, max_vocab, n_sym, alive=True):
    """Run the port's select_unify_ref and JAX's _select_and_unify on one
    state and symbol table; return both outcomes as plain tuples."""
    sym_cap = max(max_vocab, n_sym) + 8
    h1 = np.zeros(sym_cap, np.int64)
    h2 = np.zeros(sym_cap, np.int64)
    sl = np.zeros(sym_cap, np.int64)
    for i, s in enumerate(strings[:n_sym]):
        h1[i], h2[i] = jax_loop.str_hashes(s)
        sl[i] = len(s)
    pw1, pw2 = jax_loop.pow_tables(12)
    sh1, sh2 = jax_loop.str_hashes("##")
    k_s, p_s, run_total, is_cand = jax_flat.flat_aggregate(
        jnp.asarray(fs), jnp.asarray(wid), jnp.asarray(wgt), narrow=False)
    out = jax_loop._select_and_unify(
        k_s, p_s, run_total, is_cand, None, jnp.asarray(h1),
        jnp.asarray(h2), jnp.asarray(sl), jnp.int32(n_sym),
        jnp.int32(n_sym), jnp.bool_(alive), jnp.asarray(pw1),
        jnp.asarray(pw2), sh1, sh2, jnp.int32(max_vocab), False, sym_cap,
        False)
    jh1, jh2, jsl, jn, jv, jact, ja, jb, jnew, jmat = (np.asarray(x)
                                                       for x in out)
    want = (jh1.tolist(), jh2.tolist(), jsl.tolist(), int(jn), int(jv),
            int(jact), int(ja), int(jb), int(jnew), int(jmat))

    th1, th2, tsl, tpw1, tpw2 = _t(h1, h2, sl, pw1, pw2)
    ctrl = torch.tensor([n_sym, n_sym, int(alive)], dtype=torch.int32)
    rec = torch.zeros(6, dtype=torch.int32)
    keys, counts, first = pair_stats_ref(*_t(fs, wid, wgt))
    select_unify_ref(keys, counts, first, th1, th2, tsl, ctrl, tpw1, tpw2,
                     max_vocab, rec)
    a, b, new_id, matched, active, _ = rec.tolist()
    got = (th1.tolist(), th2.tolist(), tsl.tolist(), int(ctrl[0]),
           int(ctrl[1]), active, a, b, new_id, matched)
    assert int(ctrl[2]) == int(alive and active)
    return got, want


def _strings_for(fs):
    """Symbol strings: ids 0..n-1 are single letters."""
    return [chr(ord("a") + i) for i in range(int(fs.max()) + 1)]


@pytest.mark.parametrize("cfg", STATES[:4])
def test_select_unify_miss_matches_jax(cfg):
    fs, wid, wgt = random_state(**cfg)
    strings = _strings_for(fs)
    got, want = _unify_case(strings, fs, wid, wgt, 100, len(strings))
    assert got == want
    assert got[9] == 0 and got[3] == len(strings) + 1  # appended


def test_select_unify_hits_take_largest_id():
    fs, wid, wgt = random_state(seed=1)
    strings = _strings_for(fs)
    a, b = _winner(fs, wid, wgt)[1].tolist()[:2]
    merged = strings[a] + strings[b]
    # the merged string already present once, and then twice
    for extra in ([merged, "zz"], [merged, "zz", merged, "q"]):
        table = strings + extra
        got, want = _unify_case(table, fs, wid, wgt, 100, len(table))
        assert got == want
        assert got[9] == 1 and got[8] == max(
            i for i, s in enumerate(table) if s == merged)
        assert got[3] == len(table)  # no growth on a hit


@pytest.mark.parametrize("room,alive", [(1, True), (0, True), (5, False)])
def test_select_unify_stop_conditions(room, alive):
    """vocab_size = max_vocab - 1 merges; = max_vocab and alive = False
    do not."""
    fs, wid, wgt = random_state(seed=2)
    strings = _strings_for(fs)
    n = len(strings)
    got, want = _unify_case(strings, fs, wid, wgt, n + room, n, alive)
    assert got == want
    assert got[5] == int(room == 1)


def test_hashes_match_jax():
    for s in ["", "a", "ab", "rze", "żółć", "##x", "a" * 40, "\U0001F600q"]:
        assert train_loop.str_hashes(s) == jax_loop.str_hashes(s)
    for g, w in zip(train_loop.pow_tables(30), jax_loop.pow_tables(30)):
        assert np.array_equal(g, w)
    assert (train_loop.MOD, train_loop.HASH_B1, train_loop.HASH_B2) == (
        jax_loop.MOD, jax_loop.HASH_B1, jax_loop.HASH_B2)


def test_flat_to_padded_matches_jax():
    fs, wid, _ = random_state(seed=3, holes=True)
    n = int(wid[fs >= 0].max()) + 1
    assert np.array_equal(train_loop._flat_to_padded(fs, wid, n),
                          jax_loop._flat_to_padded(fs, wid, n))


def test_canonical_form_of_a_table():
    keys = torch.tensor([-1, 7, -1, 3], dtype=torch.int64)
    counts = torch.tensor([0, 5, 0, 9], dtype=torch.int64)
    pos = torch.tensor([-1, 4, -1, 1], dtype=torch.int32)
    k, c, p = canonical(keys, counts, pos)
    assert (k.tolist(), c.tolist(), p.tolist()) == ([3, 7], [9, 5], [1, 4])
    assert pairstats.table_size(188_416) == 1 << 19
    assert pairstats.table_size(2) == 2


def test_wrappers_refuse_other_devices():
    fs, wid, wgt = (t.to("meta") for t in _t(*random_state(seed=1)))
    with pytest.raises(ValueError, match="no kernel"):
        pair_stats(fs, wid, wgt)
    with pytest.raises(ValueError, match="no kernel"):
        merge_apply(fs, wid, wgt, torch.zeros(6, dtype=torch.int32,
                                              device="meta"))
    with pytest.raises(TypeError):
        pair_stats(*_t(*random_state(seed=1))[:2],
                   torch.zeros(1, dtype=torch.int32))


CORPUS = ["Litwo! Ojczyzno moja! ty jesteś jak zdrowie.",
          "Ile cię trzeba cenić, ten tylko się dowie,",
          "  İstanbul ΣΑΣ,  foo—bar　x\t", "", "aaa aab abab banana!"]


def test_front_end_matches_jax():
    for s in CORPUS:
        assert pretokenize.pre_tokenize_str(s) == \
            jax_pretok.pre_tokenize_str(s)
    for corpus in (CORPUS, CORPUS[:2], []):
        got = pretokenize.pretokenize_batch(corpus)
        want = jax_pretok.pretokenize_batch(corpus)
        for f in ("cps", "word_start", "word_end", "sent_id",
                  "sent_cp_off"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        words, freq, inv = unique_words(got)
        jwords, jfreq, jinv = jax_unique_words(want)
        assert words == jwords and np.array_equal(freq, jfreq)
        assert np.array_equal(inv, jinv)
        if words:
            t, jt = SymbolTable(), JaxTable()
            c = build_bpe_corpus(words, freq, t)
            jc = jax_build_bpe_corpus(jwords, jfreq, jt)
            assert np.array_equal(c.sym, jc.sym)
            assert t.strings() == jt.strings() and len(t) == len(jt)
            assert t.get(words[0][0]) == jt.get(words[0][0])
            assert "\x00" not in t and t.get("\x00") is None
