"""The top-K tier's certificate inside K2's launch (ops/train_loop.
select_host_ids with ``kth``; on the card ``csrc/certificate.cuh`` in K2's
last block) on the CPU, where the wrapper runs the plain selection and
then ``certificate_ref``.

- ``select_host_ids`` with the shards' K-th rows equals
  ``select_host_ids`` followed by ``certificate_ref``, in all six words of
  the record, on the hand-made cases and on random BPE and WordPiece
  states of 8 CPU shards, with wide scores and with saturated terms;
- a Python model of the kernel's arithmetic (the winner's count carried
  by the reduction, 128-bit sums, the shortened division) equals
  ``certificate_ref`` on the same cases, and its division equals
  ``(c << 36) // d`` with the 2^55 saturation on edge values;
- the sharded step no longer calls the standalone certificate.
Every comparison is exact."""
import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import CERT_CASES, padded_random
from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.ops import shard_select, train_loop
from subword_tokenizers_tpu_torch.ops.bitmath import score_bits_ref
from subword_tokenizers_tpu_torch.ops.pairstats import EMPTY_KEY
from subword_tokenizers_tpu_torch.ops.shard_select import (
    LOW32, SAT, SCALE_BITS, certificate_ref, lookup_reduce, nominate_tables)
from subword_tokenizers_tpu_torch.ops.train_loop import select_host_ids
from subword_tokenizers_tpu_torch.parallel import train as ptrain
from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M64 = (1 << 64) - 1
M128 = (1 << 128) - 1


def model_quotient(c: int, d: int, saturate: bool) -> int:
    """``scaled_quotient`` of csrc/certificate.cuh in 64-bit words:
    floor((c << 36) / d) for c < 2^63 and 1 <= d < 2^63; with
    ``saturate``, 2^55 once the quotient is known to reach it (the
    64-bit path returns it whole: the caller saturates)."""
    if c >> (64 - SCALE_BITS) == 0:
        return ((c << SCALE_BITS) & M64) // d
    q1 = c // d
    if saturate and q1 >> (55 - SCALE_BITS):
        return SAT
    r = c - q1 * d
    if r >> (64 - SCALE_BITS) == 0:
        f = (r << SCALE_BITS) // d
    else:
        f = 0
        for _ in range(SCALE_BITS):
            r = (r << 1) & M64
            ge = r >= d
            r -= d if ge else 0
            f = (f << 1) | ge
    return ((q1 >> (64 - SCALE_BITS)) << 64) | ((q1 << SCALE_BITS) & M64) | f


def _int64(x: int) -> int:
    x &= M64
    return x - (1 << 64) if x >> 63 else x


def _denominator(fa, fb, wide):
    unsafe = wide and (max(fa, 1).bit_length() + max(fb, 1).bit_length()
                       > 62)
    if unsafe:
        fa = fb = 1
    prod = _int64(fa * fb)
    return (prod if prod > 1 else 1), unsafe


def model_fused(keys, counts, pos, kth, sym_freq=None, wide=False) -> int:
    """K2's host_ids selection with the certificate as the kernel runs
    it: the winner (metric, then position) carrying its entry's count, a
    warp's 128-bit sum of the shards' terms, then the proven flag."""
    wp = sym_freq is not None
    sf = sym_freq.tolist() if wp else None
    live = keys != EMPTY_KEY
    metric = counts
    if wp:
        k0 = torch.where(live, keys, 0)
        metric = score_bits_ref(counts, sym_freq[k0 >> 32],
                                sym_freq[k0 & LOW32])
    best = None
    for k, m, c, p in zip(keys.tolist(), metric.tolist(), counts.tolist(),
                          pos.tolist()):
        if k != EMPTY_KEY and (best is None or (m, -p) > (best[0], -best[1])):
            best = (m, p, k, c)
    active = best is not None and best[0] > 0
    key = best[2] if active else 0
    cnt = best[3] if active and best[3] > 0 else -1
    total, veto = 0, False
    for m, c, k in kth.view(-1, 3).tolist():
        if not wp:
            total += max(m, 0)
            continue
        if m < 0:
            continue
        d, unsafe = _denominator(sf[k >> 32], sf[k & LOW32], wide)
        q = model_quotient(1 if unsafe else max(c, 0), d, True)
        t = SAT if q >= SAT else min(q + (q >> 50) + 2, SAT)
        total = (total + t) & M128
        veto = veto or t == SAT or unsafe
    if total == 0:
        return 1
    if not wp:
        return int(cnt > total)
    d, unsafe = _denominator(sf[key >> 32], sf[key & LOW32], wide)
    lhs = model_quotient(max(cnt, 0), d, False)
    return int(lhs > total + (total >> 50) + 2 and not veto and not unsafe)


def check(keys, counts, pos, kth, rec0, sf=None, wide=False):
    """The fused call against the selection then certificate_ref, and the
    kernel's model against both; returns the proven flag."""
    got, want = rec0.clone(), rec0.clone()
    select_host_ids(keys, counts, pos, got, sf, kth=kth, wide_score=wide)
    select_host_ids(keys, counts, pos, want, sf)
    certificate_ref(kth, keys, counts, want, sf, wide)
    assert got.tolist() == want.tolist()
    assert model_fused(keys, counts, pos, kth, sf, wide) == int(want[5])
    return int(want[5])


EDGES = [
    (0, 1), (1, 1), ((1 << 28) - 1, 1), (1 << 28, 1), ((1 << 63) - 1, 1),
    ((1 << 63) - 1, (1 << 63) - 1), ((1 << 63) - 1, (1 << 63) - 2),
    ((1 << 62) + 5, (1 << 62) + 3), (1 << 62, 3), (12345, (1 << 63) - 1),
    # quotients either side of 2^55: c = d 2^19 - 1, d 2^19, d 2^19 + 1
    *[(d * (1 << 19) + e, d) for d in (1, 3, (1 << 40) + 7, (1 << 44) - 1)
      for e in (-1, 0, 1)],
    # c % d either side of 2^28 (the low bits' 64-bit path)
    ((1 << 30) + (1 << 28) - 1, 1 << 30), ((1 << 30) + (1 << 28), 1 << 30),
    ((1 << 60) + (1 << 59), (1 << 60) - 1),
]


def _check_division(c, d):
    q = (c << SCALE_BITS) // d
    assert model_quotient(c, d, False) == q
    s = model_quotient(c, d, True)
    assert s == q if q < SAT else SAT <= s <= q


@pytest.mark.parametrize("c,d", EDGES)
def test_model_division_equals_python(c, d):
    _check_division(c, d)


def test_model_division_random():
    rng = np.random.default_rng(13)
    for _ in range(3000):
        _check_division(int(rng.integers(0, 1 << int(rng.integers(1, 64)))),
                        max(1, int(rng.integers(
                            0, 1 << int(rng.integers(1, 64))))))


# the hand-made certificates of tests/test_torch_shard_kernels.py (and
# chip_smoke.CERT_CASES), each with the winner (1, 2) among its candidates
_KEY = (1 << 32) | 2
_KTH1 = [1, 1, (3 << 32) | 4]
HAND = list(CERT_CASES) + [
    ([[-1, 0, 0]], [EMPTY_KEY], [0], None, False),
    ([_KTH1], [_KEY], [1], [0, 2, 2, 2, 2], False),
    ([[1, 1 << 20, (3 << 32) | 4], [-1, 0, 0]], [_KEY], [6],
     [0, 3, 4, 0, 2], False),
    ([[-1, 0, 0]], [_KEY], [6], [0, 3, 4, 0, 2], False),
    ([[4, 4, 0]], [(1 << 32) | 3], [10], None, False),
    # sums past 2^64: BPE K-th counts near 2^63 on several shards
    ([[(1 << 63) - 1, 0, 0]] * 3, [_KEY], [(1 << 63) - 1], None, False),
    ([[(1 << 62), 0, 0], [-1, 0, 0]], [_KEY], [(1 << 62) + 1], None,
     False),
]


@pytest.mark.parametrize("case", range(len(HAND)))
def test_hand_made_cases(case):
    kth, cand, cnt, sf, wide = HAND[case]
    cand = torch.tensor(cand, dtype=torch.int64)
    pos = torch.arange(cand.shape[0], dtype=torch.int32)
    check(cand, torch.tensor(cnt, dtype=torch.int64), pos,
          torch.tensor(kth, dtype=torch.int64).flatten(),
          torch.zeros(6, dtype=torch.int32),
          None if sf is None else torch.tensor(sf, dtype=torch.int64),
          wide)


def _topk_inputs(corpus, k, sf=None):
    """The top-K tier's candidates, their summed counts and least
    positions, and the shards' K-th rows, as sharded_select_topk builds
    them."""
    tables = corpus.pairs()
    cand, kth = nominate_tables(tables, k, sf)
    g_cnt, g_pos = lookup_reduce(cand, tables, corpus.bases)
    return cand, g_cnt, g_pos, kth


@pytest.mark.parametrize("seed,wordpiece,wide,k", [
    (0, False, False, 4), (1, False, False, 16), (2, False, False, 256),
    (3, True, False, 4), (4, True, False, 64), (5, True, True, 8),
    (6, True, True, 256)])
def test_random_states(seed, wordpiece, wide, k):
    """Seeded 8-shard states: each step of a few merges, the fused call
    against the selection then certificate_ref (the weights scaled into
    the wide score domain with ``wide``)."""
    rng = np.random.default_rng(seed)
    sym, freq = padded_random(rng, 300, 9, 6 + seed,
                              1 << 26 if wide else 1)
    corpus = ptrain.shard_corpus(make_data_mesh(8, devices=["cpu"] * 8),
                                 sym, freq)
    proven = set()
    for step in range(4):
        sf = ptrain.sharded_sym_freq(corpus, int(sym.max()) + 40) \
            if wordpiece else None
        cand, g_cnt, g_pos, kth = _topk_inputs(corpus, k, sf)
        rec = torch.zeros(6, dtype=torch.int32)
        proven.add(check(cand, g_cnt, g_pos, kth, rec, sf, wide))
        select_host_ids(cand, g_cnt, g_pos, rec, sf)
        a, b, _, _, active, _ = rec.tolist()
        if not active:
            break
        ptrain.sharded_apply_merge(corpus, a, b, int(sym.max()) + 1 + step)
    assert proven


@pytest.mark.parametrize("seed", range(4))
def test_random_rows_saturate(seed):
    """Random K-th rows and candidates over weights that saturate terms
    (weights 0 and 1 under large counts), veto by wide denominators
    (weights to 2^45), and BPE sums past 2^64: the fused call,
    certificate_ref and the model agree. Counts stay below 2^50 where
    they are scored (the scorer's domain), weights below 2^31 without
    wide scores (so fa * fb fits in int64, as the callers keep it)."""
    rng = np.random.default_rng(50 + seed)
    n_sym = 12

    def weights(top):
        return torch.from_numpy(np.where(
            rng.random(n_sym) < 0.3, rng.integers(0, 2, n_sym),
            rng.integers(1, 1 << int(rng.integers(2, top)), n_sym)))

    for trial in range(40):
        D = int(rng.integers(1, 70))
        kth = np.empty((D, 3), dtype=np.int64)
        kth[:, 0] = np.where(rng.random(D) < 0.2, -1,
                             rng.integers(0, 1 << 62, D))
        kth[:, 1] = rng.integers(0, 1 << int(rng.integers(1, 62)), D)
        kth[:, 2] = (rng.integers(0, n_sym, D) << 32) | rng.integers(
            0, n_sym, D)
        M = int(rng.integers(1, 40))
        cand = (rng.integers(0, n_sym, M) << 32) | rng.integers(0, n_sym, M)
        cand[rng.random(M) < 0.1] = EMPTY_KEY
        g_cnt = rng.integers(0, 1 << int(rng.integers(1, 50)), M)
        # one count a key, as the lookup gives every copy of a key
        _, first = np.unique(cand, return_inverse=True)
        g_cnt = g_cnt[np.unique(first, return_index=True)[1]][first]
        pos = rng.permutation(M).astype(np.int32)
        args = [torch.from_numpy(x) for x in (cand, g_cnt, pos)]
        kth_t = torch.from_numpy(kth.reshape(-1))
        check(*args, kth_t, torch.zeros(6, dtype=torch.int32))
        check(*args, kth_t, torch.zeros(6, dtype=torch.int32), weights(31))
        for top in (31, 46):
            check(*args, kth_t, torch.zeros(6, dtype=torch.int32),
                  weights(top), True)


def test_wrapper_checks():
    keys = torch.tensor([_KEY], dtype=torch.int64)
    counts = torch.tensor([3], dtype=torch.int64)
    pos = torch.zeros(1, dtype=torch.int32)
    rec = torch.zeros(6, dtype=torch.int32)
    kth = torch.tensor([1, 1, 0], dtype=torch.int64)
    with pytest.raises(ValueError, match="3 a shard"):
        select_host_ids(keys, counts, pos, rec, kth=kth[:2])
    with pytest.raises(TypeError):
        select_host_ids(keys, counts, pos, rec, kth=kth.to(torch.int32))
    with pytest.raises(ValueError, match="host_ids mode"):
        e = torch.zeros(1, dtype=torch.int64)
        train_loop.select_unify(keys, counts, pos, e, e, e,
                                torch.zeros(3, dtype=torch.int32), e, e, 9,
                                rec, kth=kth)
    with pytest.raises(ValueError, match="host_ids mode"):
        select_host_ids(keys, counts, pos, rec, kth=kth,
                        claims=train_loop.TablePair(8, "cpu").tables[0])


@pytest.fixture(scope="module")
def corpus():
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        return json.load(f)


@pytest.mark.parametrize("cls", [NaiveBPE, NaiveWP])
def test_sharded_train_runs_the_certificate_in_k2(corpus, monkeypatch, cls):
    """A sharded train's top-K steps run the certificate in the selection
    call (certificate_ref after the plain selection on the CPU), never
    the standalone one, and train as one device does."""
    def refuse(*args, **kwargs):
        raise AssertionError("the standalone certificate ran")

    calls = [0]
    real = train_loop.certificate_ref

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(shard_select, "certificate", refuse)
    monkeypatch.setattr(train_loop, "certificate_ref", counted)
    part = corpus[:150]
    tok = cls(mesh=make_data_mesh(8, devices=["cpu"] * 8), device="cpu")
    tok.train(part, 320)
    steps = tok._sel_stats["proven"] + tok._topk_fallbacks
    assert calls[0] == steps and tok._sel_stats["proven"] > 0
    one = cls(device="cpu")
    one.train(part, 320)
    if cls is NaiveBPE:
        assert tok.merges_list == one.merges_list
    else:
        assert tok._merge_log == one._merge_log
