"""The port's padded-layout training route (``run_fused(flat=False)``:
ops/train_loop.PaddedState, K3p in ops/merge.py) against the JAX
package's ``apply_merge``, ``pack_pairs`` + ``_run_aggregate``,
``symbol_freqs`` and its padded ``train_steps`` loop, on the kernels'
plain versions. Every comparison is exact."""
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subword_tokenizers_tpu import NaiveBPE as JaxNaiveBPE
from subword_tokenizers_tpu import NaiveWP as JaxNaiveWP
from subword_tokenizers_tpu.ops import merge as jmerge
from subword_tokenizers_tpu.ops import pairstats as jpairstats
from subword_tokenizers_tpu.ops import train_loop as jtrain_loop
from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.ops import merge, train_loop
from subword_tokenizers_tpu_torch.ops.flat import build_flat
from subword_tokenizers_tpu_torch.ops.pairstats import pair_stats

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BITS = 21


def random_rows(seed, n=400, L=9, n_sym=4, inner_pad=False):
    """Seeded padded rows: runs of equal symbols, rows of length 0, 1 and
    L, PAD at the end (and inside, with ``inner_pad``)."""
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
    if inner_pad:
        sym[(rng.random(sym.shape) < 0.1)] = -1
    return sym, rng.integers(1, 9, size=n).astype(np.int64)


@pytest.mark.parametrize("seed,inner_pad", [(0, False), (1, False),
                                            (2, True), (3, True)])
def test_apply_merge_matches_jax(seed, inner_pad):
    """K3p's plain version, in place, for the most common adjacent pair,
    a self-merge, an absent pair and an inactive step."""
    sym, _ = random_rows(seed, inner_pad=inner_pad)
    pairs = np.stack([sym[:, :-1].ravel(), sym[:, 1:].ravel()], 1)
    pairs = pairs[(pairs >= 0).all(1)]
    vals, cnt = np.unique(pairs, axis=0, return_counts=True)
    a, b = vals[cnt.argmax()].tolist()
    mode = int(np.bincount(sym[sym >= 0]).argmax())
    for a_, b_, active in ((a, b, 1), (mode, mode, 1), (7, 8, 1),
                           (a, b, 0)):
        want = np.asarray(jmerge.apply_merge(
            jnp.asarray(sym), a_ if active else -3, b_ if active else -3,
            40))
        got = torch.from_numpy(sym.copy())
        rec = torch.tensor([a_, b_, 40, 0, active, 0], dtype=torch.int32)
        assert merge.apply_merge(got, rec) is got
        assert np.array_equal(got.numpy(), want), (a_, b_, active)


def _jax_runs(sym, freq):
    """pack_pairs + _run_aggregate as (keys a << 32 | b, counts, first
    positions row * (L - 1) + j), sorted by key."""
    n, L = sym.shape
    keys, pos = jpairstats.pack_pairs(jnp.asarray(sym), False)
    w = jnp.broadcast_to(jnp.asarray(freq)[:, None], (n, L - 1)).reshape(-1)
    k_s, p_s, rt, cand = (np.asarray(x) for x in
                          jpairstats._run_aggregate(keys, pos, w, False))
    k, c, p = k_s[cand], rt[cand], p_s[cand]
    order = np.argsort(((k >> BITS) << 32) | (k & ((1 << BITS) - 1)))
    return (((k >> BITS) << 32) | (k & ((1 << BITS) - 1)))[order], \
        c[order], p[order]


@pytest.mark.parametrize("seed", range(3))
def test_padded_pair_table_and_weights_match_jax(seed):
    """K1 and K4 over the rows seen as flat slots: the same pairs, counts
    and per-symbol weights, and positions row * L + j that map to JAX's
    row * (L - 1) + j."""
    sym, freq = random_rows(seed)
    n, L = sym.shape
    st = train_loop.PaddedState(sym, freq, "cpu")
    keys, counts, first = st.pairs()
    jk, jc, jp = _jax_runs(sym, freq)
    assert np.array_equal(keys.numpy(), jk)
    assert np.array_equal(counts.numpy(), jc)
    f = first.numpy()
    assert np.array_equal((f // L) * (L - 1) + f % L, jp)
    got = st.count_symbols(16)  # K4 over the rows and the row weights
    want = jpairstats.symbol_freqs(
        jnp.asarray(sym).reshape(-1),
        jnp.broadcast_to(jnp.asarray(freq)[:, None], (n, L)).reshape(-1), 16)
    assert got is st.sym_freq
    assert np.array_equal(st.sym_freq.numpy(), np.asarray(want))


def test_padded_state_from_flat_round_trip():
    sym, freq = random_rows(4)
    sym = sym[(sym >= 0).any(1)]  # word types have at least one symbol
    freq = freq[:sym.shape[0]]
    st = train_loop.FlatState(*build_flat(sym, freq), "cpu")
    padded = train_loop.PaddedState.from_flat(st)
    assert np.array_equal(padded.padded(), sym)
    assert np.array_equal(padded._wgt.numpy().reshape(sym.shape)[:, 0], freq)
    assert np.array_equal(st.padded(), sym)


def _train(port_cls, jax_cls, corpus, max_vocab, monkeypatch):
    """Both packages' trainers through run_fused(flat=False)."""
    monkeypatch.setattr(train_loop, "run_fused", functools.partial(
        train_loop.run_fused, flat=False))
    monkeypatch.setattr(jtrain_loop, "run_fused", functools.partial(
        jtrain_loop.run_fused, flat=False))
    port = port_cls(device="cpu")
    port.train(corpus, max_vocab)
    jax_tok = jax_cls()
    jax_tok.train(corpus, max_vocab)
    log = "merges_list" if port_cls is NaiveBPE else "_merge_log"
    assert getattr(port, log) == getattr(jax_tok, log)
    assert port.vocab == jax_tok.vocab
    assert port.corpus_as_symbols == jax_tok.corpus_as_symbols
    return port


def _flat(cls, corpus, max_vocab):
    tok = cls(device="cpu")
    tok.train(corpus, max_vocab)
    return tok


@pytest.mark.parametrize("port_cls,jax_cls", [(NaiveBPE, JaxNaiveBPE),
                                              (NaiveWP, JaxNaiveWP)])
def test_train_85k_slice_matches_jax(monkeypatch, port_cls, jax_cls):
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        corpus = json.load(f)[:500]
    port = _train(port_cls, jax_cls, corpus, 300, monkeypatch)
    assert port.vocab == _flat(port_cls, corpus, 300).vocab
    assert len(port.vocab) == 300


PATHOLOGICAL = ["aaaaaaaaaaaaaaaaaaaaaa", "abababab ababab",
                "aaa aab aba abb baa bab bba bbb", "xy" * 11]
TIES = ["zy xw vu ts rq po nm lk ji hg fe dc ba"]


@pytest.mark.parametrize("corpus,max_vocab", [
    (PATHOLOGICAL, 40), (TIES, 40),
    (["ab ba ab ba abab baba aaaa bbbb"] * 3, 25),
])
def test_pathological_and_tie_heavy_match_jax(monkeypatch, corpus,
                                              max_vocab):
    for port_cls, jax_cls in ((NaiveBPE, JaxNaiveBPE),
                              (NaiveWP, JaxNaiveWP)):
        _train(port_cls, jax_cls, corpus, max_vocab, monkeypatch)


def test_rows_of_width_one(monkeypatch):
    """Words of one symbol only: a [n, 1] tensor, which the JAX package's
    padded loop cannot take (it has no pair slots); the port pads it to
    two columns and equals the JAX flat route."""
    corpus = ["a", "b a c"]
    monkeypatch.setattr(train_loop, "run_fused", functools.partial(
        train_loop.run_fused, flat=False))
    for port_cls, jax_cls in ((NaiveBPE, JaxNaiveBPE),
                              (NaiveWP, JaxNaiveWP)):
        port = port_cls(device="cpu")
        port.train(corpus, 10)
        jax_tok = jax_cls()
        jax_tok.train(corpus, 10)
        assert port.vocab == jax_tok.vocab
        assert port.corpus_as_symbols == jax_tok.corpus_as_symbols


@pytest.mark.parametrize("trial", range(3))
def test_fuzz_corpora_match_jax(monkeypatch, trial):
    rng = np.random.default_rng(7 + trial)
    corpus = [" ".join("".join(rng.choice(list("abcdefgh"),
                                          size=rng.integers(1, 9)))
                       for _ in range(rng.integers(3, 30)))
              for _ in range(rng.integers(2, 10))]
    for port_cls, jax_cls in ((NaiveBPE, JaxNaiveBPE),
                              (NaiveWP, JaxNaiveWP)):
        _train(port_cls, jax_cls, corpus, 64, monkeypatch)


def test_padded_route_ignores_the_window(monkeypatch):
    """The padded loop has no skip mode: a window set for the flat
    route changes nothing there, as in the JAX package."""
    monkeypatch.setenv("SWT_SKIP_COMPACT", "4")
    port = _train(NaiveBPE, JaxNaiveBPE, PATHOLOGICAL, 40, monkeypatch)
    seen = []
    real = train_loop.pair_stats
    monkeypatch.setattr(train_loop, "pair_stats", lambda *a, **k: (
        seen.append(k.get("skip", 0)), real(*a, **k))[1])
    NaiveBPE(device="cpu").train(PATHOLOGICAL, 40)
    assert seen and not any(seen)
    assert port.merges_list


def test_new_wrappers_raise_off_the_cpu_and_cuda():
    """Each new wrapper runs its plain version only for CPU tensors and
    raises for a device with no kernel."""
    from subword_tokenizers_tpu_torch.ops import flat
    meta = torch.device("meta")
    fs = torch.zeros(64, dtype=torch.int32, device=meta)
    wgt = torch.zeros(64, dtype=torch.int64, device=meta)
    rec = torch.zeros(6, dtype=torch.int32, device=meta)
    count = torch.zeros(1, dtype=torch.int32, device=meta)
    calls = [
        lambda: merge.apply_merge(fs.view(8, 8), rec),
        lambda: flat.merge_skip(fs, fs, wgt, rec, 4),
        lambda: flat.skip_guard(fs, fs, wgt, count,
                                flat.MergeScratch(64, meta)),
        lambda: pair_stats(fs, fs, wgt, skip=4),
        lambda: train_loop.select_unify(
            wgt, wgt, fs, wgt, wgt, wgt, rec[:3], wgt, wgt, 10, rec,
            wordpiece=True, sym_freq=wgt, tournament=True, redo=count),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()
