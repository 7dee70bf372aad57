"""The port's WordPiece tournament (``SWT_WP_TOURNAMENT=1``:
ops/wp_tournament.py, K2's tournament mode) against the JAX package's
``mul_53x53``, ``wp_tournament_select`` (with its ``risky`` flag) and its
training route, on the kernels' plain versions; and the knob's checks.
Every comparison is exact."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subword_tokenizers_tpu import NaiveBPE as JaxNaiveBPE
from subword_tokenizers_tpu import NaiveWP as JaxNaiveWP
from subword_tokenizers_tpu.models import wordpiece as jax_wp_mod
from subword_tokenizers_tpu.ops import bitmath as jbitmath
from subword_tokenizers_tpu.ops import pairstats as jpairstats
from subword_tokenizers_tpu.ops.wp_tournament import \
    wp_tournament_select as jax_tournament
from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.benchmarks import profiling
from subword_tokenizers_tpu_torch.models import wordpiece as wp_mod
from subword_tokenizers_tpu_torch.ops import bitmath, train_loop
from subword_tokenizers_tpu_torch.ops.pairstats import EMPTY_KEY
from subword_tokenizers_tpu_torch.ops.wp_tournament import \
    wp_tournament_select

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_, BITS, _, SENTINEL, VMAX = jpairstats._consts(True)


def test_mul_53x53_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 53, size=4096) >> rng.integers(0, 53, 4096)
    b = rng.integers(0, 1 << 53, size=4096) >> rng.integers(0, 53, 4096)
    a[:3] = (1 << 53) - 1
    b[:3] = ((1 << 53) - 1, 1, 0)
    got = bitmath.mul_53x53(torch.from_numpy(a), torch.from_numpy(b))
    want = jbitmath.mul_53x53(jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    hi, lo = (g.numpy().tolist() for g in got)
    assert [h * 2 ** 53 + l for h, l in zip(hi, lo)] == \
        [int(x) * int(y) for x, y in zip(a, b)]


def _both(entries, sym_freq, F=8):
    """The JAX tournament and the port's on one table of F lanes whose
    first lanes hold ``entries`` = [(a, b, count, position)]: (JAX's
    (key, bits, pos, count, risky) with the key in the port's packing,
    the port's)."""
    k_s = np.full(F, SENTINEL, dtype=np.int32)
    p_s = np.full(F, VMAX, dtype=np.int32)
    rt = np.zeros(F, dtype=np.int32)
    ic = np.zeros(F, dtype=bool)
    keys = np.full(F, EMPTY_KEY, dtype=np.int64)
    for i, (a, b, c, p) in enumerate(entries):
        k_s[i], p_s[i], rt[i], ic[i] = (a << BITS) | b, p, c, True
        keys[i] = (a << 32) | b
    sf = np.asarray(sym_freq, dtype=np.int64)
    jk, jb, jp, jc, jr = (int(x) for x in jax_tournament(
        *(jnp.asarray(x) for x in (k_s, p_s, rt, ic, sf)), True))
    if jk != SENTINEL:
        jk = ((jk >> BITS) << 32) | (jk & ((1 << BITS) - 1))
    port = wp_tournament_select(
        torch.from_numpy(keys), torch.from_numpy(rt.astype(np.int64)),
        torch.from_numpy(p_s), torch.from_numpy(sf))
    return (jk, jb, jp, jc, bool(jr)), port


# The cases of the JAX package's tests/test_tournament.py:67-139.
Q, P = (1 << 26) - 1, (1 << 26) - 3
C1 = (1 << 25) - 1
C2 = (C1 * P - 1) // Q  # C1 * P - C2 * Q == 1: a relative gap near 2**-51
A = (1 << 20) + 7
NEAR_TIE = ([(1, 3, C1, 5), (1, 2, C2, 9)], [1, A, P, Q, 1])
CLEAR = ([(1, 2, 7, 4), (2, 3, 5, 2)], [1, 10, 20, 30, 1])
EXACT_TIE = ([(1, 2, 6, 11), (3, 4, 6, 3)], [1, 12, 18, 18, 12])


@pytest.mark.parametrize("case,risky", [(NEAR_TIE, True), (CLEAR, False),
                                        (EXACT_TIE, False)])
def test_jax_cases(case, risky):
    want, got = _both(*case)
    assert got == want
    assert got[4] is risky
    if case is EXACT_TIE:
        assert got[2] == 3 and got[0] == (3 << 32) | 4


@pytest.mark.parametrize("seed", range(4))
def test_random_tables_match_jax(seed):
    """Random tables of 1-200 entries whose weights come from a few
    values (exact ties), half of them holding the near tie above as
    their two best entries: the same winner and the same flag as JAX's
    tree, lane for lane."""
    rng = np.random.default_rng(seed)
    flags = 0
    for trial in range(40):
        sf = rng.choice([1 << 18, 3 << 17, 1 << 19], size=30)
        sf[:4] = (1, A, P, Q)
        near = trial % 2 == 0
        entries = [(1, 3, C1, 0), (1, 2, C2, 0)] if near else []
        seen = {(1, 3), (1, 2)}
        n = int(rng.integers(1, 200))
        while len(entries) < n:
            a, b = (int(x) for x in rng.integers(4, 30, size=2))
            if (a, b) not in seen:
                seen.add((a, b))
                entries.append((a, b, int(rng.integers(1, 5)), 0))
        order = rng.permutation(len(entries))
        entries = [(a, b, c, 3 * i + 1)
                   for i, (a, b, c, _) in enumerate(entries[j]
                                                    for j in order)]
        want, got = _both(entries, sf, F=256)
        assert got == want
        assert got[4] is near
        flags += got[4]
    assert flags == 20


def _tables(sym_freq):
    return (torch.zeros(64, dtype=torch.int64),) * 3 + (
        torch.tensor([len(sym_freq), len(sym_freq), 1], dtype=torch.int32),
        torch.ones(4, dtype=torch.int64), torch.ones(4, dtype=torch.int64))


@pytest.mark.parametrize("case", [NEAR_TIE, CLEAR, EXACT_TIE])
def test_select_unify_tournament_equals_exact(case):
    """K2's tournament mode (plain version) writes the exact mode's
    record, and counts a redo on the near tie only."""
    entries, sf = case
    keys = torch.tensor([(a << 32) | b for a, b, _, _ in entries])
    counts = torch.tensor([c for _, _, c, _ in entries])
    pos = torch.tensor([p for _, _, _, p in entries], dtype=torch.int32)
    sym_freq = torch.tensor(sf, dtype=torch.int64)
    recs = []
    redo = torch.zeros(1, dtype=torch.int32)
    for tournament in (False, True):
        rec = torch.zeros(6, dtype=torch.int32)
        train_loop.select_unify(keys, counts, pos, *_tables(sf), 100, rec,
                                wordpiece=True, sym_freq=sym_freq,
                                tournament=tournament,
                                redo=redo if tournament else None)
        recs.append(rec.tolist())
    assert recs[0] == recs[1] and recs[0][4] == 1
    assert int(redo) == int(case is NEAR_TIE)
    with pytest.raises(ValueError, match="tournament"):
        train_loop.select_unify(keys, counts, pos, *_tables(sf), 100, rec,
                                sym_freq=sym_freq, tournament=True,
                                redo=redo)


def _train(cls, corpus, max_vocab, flag, monkeypatch):
    monkeypatch.setenv("SWT_WP_TOURNAMENT", flag)
    tok = cls(device="cpu") if cls is NaiveWP else cls()
    tok.train(corpus, max_vocab)
    return tok


def _same(port, jax_tok):
    assert port._merge_log == jax_tok._merge_log
    assert port.vocab == jax_tok.vocab
    assert port.corpus_as_symbols == jax_tok.corpus_as_symbols


PATHOLOGICAL = ["aaaaaaaaaaaaaaaaaaaaaa", "abababab ababab",
                "aaa aab aba abb baa bab bba bbb", "xy" * 11]
TIES = ["zy xw vu ts rq po nm lk ji hg fe dc ba"]


@pytest.mark.parametrize("corpus", [PATHOLOGICAL, TIES])
def test_pathological_training_matches_jax(monkeypatch, corpus):
    launches = profiling.counter("launch.select_unify.tournament")
    port = _train(NaiveWP, corpus, 40, "1", monkeypatch)
    _same(port, _train(JaxNaiveWP, corpus, 40, "1", monkeypatch))
    assert port._merge_log
    # the CPU runs the plain version: no kernel launch is counted
    assert profiling.counter("launch.select_unify.tournament") == launches


def test_train_85k_slice_matches_jax(monkeypatch):
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        corpus = json.load(f)[:500]
    port = _train(NaiveWP, corpus, 300, "1", monkeypatch)
    _same(port, _train(JaxNaiveWP, corpus, 300, "1", monkeypatch))
    assert port.vocab == _train(NaiveWP, corpus, 300, "0",
                                monkeypatch).vocab


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_corpora_match_jax(monkeypatch, trial):
    """The fuzz corpora of the JAX package's tournament tests (seed 7)."""
    rng = np.random.default_rng(7)
    for _ in range(trial + 1):
        corpus = [" ".join(
            "".join(rng.choice(list("abcdefgh"), size=rng.integers(1, 9)))
            for _ in range(rng.integers(3, 30)))
            for _ in range(rng.integers(2, 10))]
    _same(_train(NaiveWP, corpus, 64, "1", monkeypatch),
          _train(JaxNaiveWP, corpus, 64, "1", monkeypatch))


def test_bad_values_raise_jax_text(monkeypatch):
    """A bad value raises the JAX package's text; the port checks it
    before any gate, so a BPE run raises too (the JAX package ignores
    the variable there)."""
    monkeypatch.setenv("SWT_WP_TOURNAMENT", "bogus")
    msgs = []
    for tok in (NaiveWP(device="cpu"), JaxNaiveWP(), NaiveBPE(device="cpu")):
        with pytest.raises(ValueError, match="SWT_WP_TOURNAMENT") as e:
            tok.train(["ab ab"], 30)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == msgs[2]
    JaxNaiveBPE().train(["ab ab"], 30)


def test_forced_on_wide_scores_raises(monkeypatch):
    """Past 2**26 symbol occurrences the scores are wide and the
    tournament cannot take them: a forced "1" raises (the JAX package
    ignores it); "0" trains as JAX does."""
    words, base = ["abcab", "bca", "cab", "aab"], [31, 17, 13, 11]
    freq = np.asarray(base, dtype=np.int64) * ((1 << 28) + 9871)

    def fake_unique_words(wb):
        return list(words), freq, np.zeros(1, dtype=np.int32)

    monkeypatch.setattr(wp_mod, "train_words",
                        lambda tok, corpus: fake_unique_words(None)[:2])
    monkeypatch.setattr(jax_wp_mod, "unique_words", fake_unique_words)
    with pytest.raises(ValueError, match="narrow score domain"):
        _train(NaiveWP, [""], 20, "1", monkeypatch)
    _same(_train(NaiveWP, [""], 20, "0", monkeypatch),
          _train(JaxNaiveWP, [""], 20, "0", monkeypatch))


def test_new_modules_import_no_jax():
    code = (
        "import os, sys\n"
        "from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP\n"
        "from subword_tokenizers_tpu_torch.ops import merge, wp_tournament\n"
        "os.environ['SWT_SKIP_COMPACT'] = '2'\n"
        "os.environ['SWT_WP_TOURNAMENT'] = '1'\n"
        "NaiveBPE(device='cpu').train(['aab abab aab'], 8)\n"
        "NaiveWP(device='cpu').train(['aab abab aab'], 8)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'subword_tokenizers_tpu.')) or m == "
        "'subword_tokenizers_tpu']\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
