"""The port's deferred compaction (``SWT_SKIP_COMPACT``, ops/flat.py skip
mode) against the JAX package's ``skip_next``, ``skip_overflow``,
``flat_skip_aggregate``, ``flat_skip_apply`` and its training route, on
the kernels' plain versions. Every comparison is exact: the pair tables
through ``canonical``, with the port's raw slot positions mapped to the
JAX package's compacted ones, and training's merges, vocab and
``corpus_as_symbols``."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subword_tokenizers_tpu import NaiveBPE as JaxNaiveBPE
from subword_tokenizers_tpu import NaiveWP as JaxNaiveWP
from subword_tokenizers_tpu.ops import flat as jflat
from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.ops import flat, train_loop
from subword_tokenizers_tpu_torch.ops.pairstats import pair_stats

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BITS = 21  # the JAX package's wide pair keys: a << 21 | b


def random_state(seed, n_words=300, max_len=10, n_sym=4, holes=0.3,
                 gaps=0):
    """A seeded flat state (numpy fs, wid, wgt): runs of equal symbols,
    dead slots inside words (a share ``holes`` of the live ones), and
    ``gaps`` stretches of 12 dead slots, which overflow small windows."""
    rng = np.random.default_rng(seed)
    sym = np.full((n_words, max_len), -1, dtype=np.int32)
    for w in range(n_words):
        s = int(rng.integers(0, n_sym))
        for j in range(int(rng.integers(1, max_len + 1))):
            if rng.random() > 0.5:
                s = int(rng.integers(0, n_sym))
            sym[w, j] = s
    freq = rng.integers(1, 9, size=n_words)
    fs, wid, wgt = flat.build_flat(sym, freq, pad_to=64)
    dead = (rng.random(fs.shape[0]) < holes) & (fs >= 0)
    for g in rng.integers(0, int((fs >= 0).sum()) - 20, size=gaps):
        dead[g:g + 12] |= fs[g:g + 12] >= 0
    fs[dead], wid[dead], wgt[dead] = -1, flat.WID_PAD, 0
    return fs, wid, wgt


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


CASES = [(seed, S, gaps) for seed, S in ((0, 2), (1, 3), (2, 8))
         for gaps in (0, 3)]


@pytest.mark.parametrize("seed,S,gaps", CASES)
def test_skip_next_and_overflow_match_jax(seed, S, gaps):
    fs, wid, wgt = random_state(seed, gaps=gaps)
    nsym, nwid = flat.skip_next(*_t(fs, wid), S)
    jsym, jwid = jflat.skip_next(*_j(fs, wid), S)
    assert np.array_equal(nsym.numpy(), np.asarray(jsym))
    assert np.array_equal(nwid.numpy(), np.asarray(jwid))
    got = flat.skip_overflow(*_t(fs, wid), S)
    assert got == bool(jflat.skip_overflow(*_j(fs, wid), S))
    if gaps:
        assert got


def _jax_table(fs, wid, wgt, S):
    """flat_skip_aggregate's runs as (keys a << 32 | b, counts, first
    compacted position), sorted by key."""
    j = _j(fs, wid, wgt)
    nsym, nwid = jflat.skip_next(j[0], j[1], S)
    cpos = jnp.cumsum((j[0] >= 0).astype(jnp.int32)) - 1
    k_s, p_s, rt, cand = (np.asarray(x) for x in jflat.flat_skip_aggregate(
        *j, nsym, nwid, cpos, narrow=False))
    k, c, p = k_s[cand], rt[cand], p_s[cand]
    keys = ((k >> BITS) << 32) | (k & ((1 << BITS) - 1))
    order = np.argsort(keys)
    return keys[order], c[order], p[order]


@pytest.mark.parametrize("seed,S,gaps", CASES)
def test_skip_pair_table_matches_jax(seed, S, gaps):
    """K1's skip mode (plain version): the same pairs and counts, and
    raw first positions that map to JAX's compacted ones."""
    fs, wid, wgt = random_state(seed, gaps=gaps)
    keys, counts, first = pair_stats(*_t(fs, wid, wgt), skip=S)
    cpos = np.cumsum(fs >= 0) - 1
    jk, jc, jp = _jax_table(fs, wid, wgt, S)
    assert np.array_equal(keys.numpy(), jk)
    assert np.array_equal(counts.numpy(), jc)
    assert np.array_equal(cpos[first.numpy()], jp)
    # raw positions order the pairs as the compacted ones do
    assert np.array_equal(np.argsort(first.numpy(), kind="stable"),
                          np.argsort(jp, kind="stable"))


def _records(fs, wgt, S):
    """(a, b) to merge on one state: the most frequent skip pair, the
    most common symbol with itself, and an inactive step."""
    keys, counts, _ = pair_stats(*_t(fs, np.zeros_like(fs), wgt), skip=S)
    top = int(keys[counts.argmax()])
    mode = int(np.bincount(fs[fs >= 0]).argmax())
    return [(top >> 32, top & 0xFFFFFFFF, 1), (mode, mode, 1),
            (top >> 32, top & 0xFFFFFFFF, 0)]


@pytest.mark.parametrize("seed,S,gaps", CASES)
def test_merge_skip_matches_jax(seed, S, gaps):
    """K3's skip mode (plain version) against flat_skip_apply: the state
    in place, n_rep and the carried weights, for a pair, a self-merge
    through dead slots and an inactive step."""
    fs, wid, wgt = random_state(seed, gaps=gaps)
    new_id = 40
    for a, b, active in _records(fs, wgt, S):
        j = _j(fs, wid, wgt)
        nsym, nwid = jflat.skip_next(j[0], j[1], S)
        cpos = jnp.cumsum((j[0] >= 0).astype(jnp.int32)) - 1
        want = [np.asarray(x) for x in jflat.flat_skip_apply(
            *j, nsym, nwid, cpos, a if active else -3, b if active else -3,
            new_id, S)]
        t_fs, t_wid, t_wgt = _t(fs, wid, wgt)
        rec = torch.tensor([a, b, new_id, 0, active, 0], dtype=torch.int32)
        sf = torch.zeros(64, dtype=torch.int64)
        sf.index_add_(0, torch.from_numpy(np.where(fs >= 0, fs, 63)),
                      torch.from_numpy(wgt))
        sf_before = sf.clone()
        flat.merge_skip(t_fs, t_wid, t_wgt, rec, S, sym_freq=sf)
        for got, w in zip((t_fs, t_wid, t_wgt), want[:3]):
            assert np.array_equal(got.numpy(), w)
        n_rep = int(want[3])
        if active:
            assert n_rep > 0
            sf_before[a] -= n_rep
            sf_before[b] -= n_rep
            sf_before[new_id] += n_rep
        assert torch.equal(sf, sf_before)
        recount = torch.zeros(64, dtype=torch.int64).index_add_(
            0, torch.where(t_fs >= 0, t_fs, 63).long(), t_wgt)
        assert torch.equal(sf[:63], recount[:63])


@pytest.mark.parametrize("seed,S,gaps", CASES)
def test_skip_guard_is_the_jax_cond(seed, S, gaps):
    """The overflow guard compacts exactly when skip_overflow holds, as
    compact_flat does inside the JAX package's lax.cond, and counts it;
    the test is the gate an inactive skip merge leaves on the state."""
    fs, wid, wgt = random_state(seed, gaps=gaps)
    arrays = _t(fs, wid, wgt)
    count = torch.zeros(1, dtype=torch.int32)
    sc = flat.MergeScratch(fs.shape[0], "cpu")
    flat.merge_skip(*arrays, torch.zeros(6, dtype=torch.int32), S,
                    scratch=sc)
    flat.skip_guard(*arrays, count, sc)
    ovf = bool(jflat.skip_overflow(*_j(fs, wid), S))
    want = jflat.compact_flat(*_j(fs, wid, wgt)) if ovf else (fs, wid, wgt)
    for got, w in zip(arrays, want):
        assert np.array_equal(got.numpy(), np.asarray(w))
    assert int(count) == int(ovf)
    if gaps:
        assert ovf


def _train(cls, corpus, max_vocab, skip, monkeypatch):
    if skip is None:
        monkeypatch.delenv("SWT_SKIP_COMPACT", raising=False)
    else:
        monkeypatch.setenv("SWT_SKIP_COMPACT", str(skip))
    tok = cls(device="cpu") if cls in (NaiveBPE, NaiveWP) else cls()
    tok.train(corpus, max_vocab)
    return tok


def _same(port, jax_tok):
    log = "merges_list" if hasattr(jax_tok, "merges_list") else "_merge_log"
    assert getattr(port, log) == getattr(jax_tok, log)
    assert port.vocab == jax_tok.vocab
    assert port.corpus_as_symbols == jax_tok.corpus_as_symbols


PATHOLOGICAL = [
    "aaaaaaaaaaaaaaaaaaaaaa",
    "abababababababab ababab",
    "aaa aab aba abb baa bab bba bbb",
    "zzzz zzzz zzzzz zzzzzz zzz",
    "the quick brown fox jumps over the lazy dog",
    "aaaa " * 12,
    "xy" * 11,
]
TIE_HEAVY = ["ab ba ab ba abab baba aaaa bbbb"] * 3


@pytest.mark.parametrize("skip", [2, 3, 8])
@pytest.mark.parametrize("port_cls,jax_cls", [(NaiveBPE, JaxNaiveBPE),
                                              (NaiveWP, JaxNaiveWP)])
def test_pathological_training_matches_jax(monkeypatch, port_cls, jax_cls,
                                           skip):
    counts = flat.skip_guard.overflow_compactions
    port = _train(port_cls, PATHOLOGICAL, 40, skip, monkeypatch)
    _same(port, _train(jax_cls, PATHOLOGICAL, 40, skip, monkeypatch))
    if skip == 2:
        assert flat.skip_guard.overflow_compactions > counts


@pytest.mark.parametrize("port_cls,jax_cls", [(NaiveBPE, JaxNaiveBPE),
                                              (NaiveWP, JaxNaiveWP)])
def test_train_85k_slice_matches_jax(monkeypatch, port_cls, jax_cls):
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        corpus = json.load(f)[:500]
    port = _train(port_cls, corpus, 300, 3, monkeypatch)
    _same(port, _train(jax_cls, corpus, 300, 3, monkeypatch))
    assert port.vocab == _train(port_cls, corpus, 300, None,
                                monkeypatch).vocab


def _fuzz_corpus(trial):
    rng = np.random.default_rng(100 + trial)
    return [" ".join("".join(rng.choice(list("abcd"),
                                        size=rng.integers(1, 12)))
                     for _ in range(rng.integers(3, 25)))
            for _ in range(rng.integers(2, 8))]


@pytest.mark.parametrize("trial", range(3))
def test_fuzz_and_tie_heavy_training_match_jax(monkeypatch, trial):
    corpus = TIE_HEAVY if trial == 0 else _fuzz_corpus(trial)
    for port_cls, jax_cls in ((NaiveBPE, JaxNaiveBPE),
                              (NaiveWP, JaxNaiveWP)):
        port = _train(port_cls, corpus, 50, 2, monkeypatch)
        _same(port, _train(jax_cls, corpus, 50, 2, monkeypatch))


def test_small_blocks_shrink_and_default_window(monkeypatch):
    """Blocks of 8 steps with the state halved between them, at the JAX
    package's default window of 12, equal the compacting route."""
    import functools
    ref = _train(NaiveBPE, PATHOLOGICAL, 40, 0, monkeypatch)
    monkeypatch.setattr(train_loop, "run_fused",
                        functools.partial(train_loop.run_fused, K=8))
    monkeypatch.setattr(train_loop, "_FLAT_MIN", 64)
    widths = set()
    real = train_loop.pair_stats
    monkeypatch.setattr(train_loop, "pair_stats", lambda fs, *a, **k: (
        widths.add((fs.shape[0], k.get("skip"))), real(fs, *a, **k))[1])
    got = _train(NaiveBPE, PATHOLOGICAL, 40, 12, monkeypatch)
    assert {w for w, s in widths if s == 12} >= {1024, 512}
    assert (got.merges_list, got.corpus_as_symbols) == \
        (ref.merges_list, ref.corpus_as_symbols)


def test_bad_and_oversized_windows(monkeypatch):
    """A value that is not an integer raises the JAX package's text in
    both packages; an oversized window is clamped (to 64, below the
    width) and changes nothing."""
    corpus = ["aaa aab abab banana!", "ab ab cd cd"]
    msgs = []
    for cls in (NaiveBPE, JaxNaiveBPE):
        monkeypatch.setenv("SWT_SKIP_COMPACT", "bogus")
        with pytest.raises(ValueError, match="SWT_SKIP_COMPACT") as e:
            (cls(device="cpu") if cls is NaiveBPE else cls()).train(
                corpus, 40)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    big = _train(NaiveBPE, corpus, 40, 99999, monkeypatch)
    _same(big, _train(JaxNaiveBPE, corpus, 40, 99999, monkeypatch))
    assert big.merges_list == _train(NaiveBPE, corpus, 40, 0,
                                     monkeypatch).merges_list
