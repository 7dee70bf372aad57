"""The port's exact WordPiece scorer (``ops/bitmath.score_bits``, plain
version) against the JAX package's integer dividers (``div_double_bits``,
``div_double_bits_wide`` with ``mul_53x53``) and against CPython's
``c / (fa * fb)``. Every comparison is exact: the scores are the bits of
correctly rounded doubles."""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subword_tokenizers_tpu.models.wordpiece import MAX_TOKENS_WP as JAX_MAX
from subword_tokenizers_tpu.ops.bitmath import (div_double_bits,
                                                div_double_bits_wide,
                                                mul_53x53)
from subword_tokenizers_tpu_torch.models.wordpiece import MAX_TOKENS_WP
from subword_tokenizers_tpu_torch.ops import bitmath
from subword_tokenizers_tpu_torch.ops.bitmath import score_bits

torch.set_num_threads(1)


def _cpython(cs, fas, fbs):
    return [struct.unpack("<q", struct.pack("<d", max(c, 1) / (
        max(a, 1) * max(b, 1))))[0] for c, a, b in zip(cs, fas, fbs)]


def _jax(cs, fas, fbs):
    """The JAX package's scorer as ``wp_score_bits`` calls it: the narrow
    divider where ``fa * fb < 2**53`` and ``c < 2**33`` (its domain), the
    wide one elsewhere."""
    c = np.maximum(np.asarray(cs, dtype=np.int64), 1)
    fa = np.maximum(np.asarray(fas, dtype=np.int64), 1)
    fb = np.maximum(np.asarray(fbs, dtype=np.int64), 1)
    narrow = np.array([int(a) * int(b) < (1 << 53) and int(x) < (1 << 33)
                       for x, a, b in zip(c, fa, fb)], dtype=bool)
    d_hi, d_lo = mul_53x53(jnp.asarray(fa), jnp.asarray(fb))
    wide = np.asarray(div_double_bits_wide(jnp.asarray(c), d_hi, d_lo))
    d = np.where(narrow, fa * np.where(narrow, fb, 1), 1)
    near = np.asarray(div_double_bits(jnp.asarray(c), jnp.asarray(d)))
    return np.where(narrow, near, wide).tolist()


def _port(cs, fas, fbs):
    t = [torch.tensor(x, dtype=torch.int64) for x in (cs, fas, fbs)]
    return score_bits(*t).tolist()


def _check(cs, fas, fbs):
    got = _port(cs, fas, fbs)
    assert got == _cpython(cs, fas, fbs)
    assert got == _jax(cs, fas, fbs)


def test_random_narrow():
    rng = np.random.default_rng(3)
    c = rng.integers(1, 1 << 33, size=20000)
    fa = rng.integers(1, 1 << 26, size=20000)
    fb = rng.integers(1, 1 << 26, size=20000)
    assert bitmath.is_narrow(torch.from_numpy(fa),
                             torch.from_numpy(fb)).all()
    _check(c.tolist(), fa.tolist(), fb.tolist())


def test_dense_small_and_clamped():
    """Every (c, fa, fb) below 12, zeros included: arguments below 1 are
    raised to 1, as the JAX scorer does."""
    g = np.stack(np.meshgrid(*[np.arange(0, 12)] * 3)).reshape(3, -1)
    _check(*(x.tolist() for x in g))


def test_midpoint_neighbourhoods():
    """Quotients next to a rounding midpoint, narrow and wide: d = (c 2^k
    + delta) 2^j, whose mantissa rounds as c / (c 2^k + delta) does, and
    the near-midpoint cases of the JAX package's bitmath tests."""
    cs, fas, fbs = [], [], []
    for k in range(2, 40):
        for c in (3, 5, 101, (1 << 11) + 1):
            for delta in (-1, 0, 1):
                fa = c * (1 << k) + delta
                if not 1 <= fa < (1 << 52):
                    continue
                for j in (0, 13, 51):
                    cs.append(c)
                    fas.append(fa)
                    fbs.append(1 << j)
    m = (1 << 53) + 1
    for j in (10, 20, 40):
        cs.append(m >> 21)
        fas.append(1 << j)
        fbs.append(1)
    cs += [3, 5, (1 << 33) - 1]
    fas += [1 << 51, 1 << 26, 1 << 17]
    fbs += [2, 1 << 26, 1 << 17]
    _check(cs, fas, fbs)


def test_powers_of_two():
    """Power-of-two denominators: the sticky bit degenerates to the
    guard bit, in both domains."""
    rng = np.random.default_rng(9)
    c = rng.integers(1, 1 << 33, size=5000).tolist()
    i = rng.integers(0, 52, size=5000).tolist()
    j = rng.integers(0, 52, size=5000).tolist()
    _check(c, [1 << x for x in i], [1 << y for y in j])
    cs, fas, fbs = [], [], []
    for k in range(0, 52):
        for c in (1, 3, (1 << min(k + 1, 52)) - 1):
            cs.append(c)
            fas.append(1 << k)
            fbs.append(1 << (51 - k // 2))
    _check(cs, fas, fbs)


def _small_factor(d):
    """(fa, fb) with fa * fb == d and both < 2**52, from a factor below
    2**14; None if there is none."""
    for f in range(1, 1 << 14):
        if d % f == 0 and d // f < (1 << 52) and f < (1 << 52):
            return f, d // f
    return None


def test_wide_boundary_and_adversarial():
    """The wide-domain cases of the JAX package's bitmath tests, with
    each denominator split into two symbol weights below 2**52."""
    cs, fas, fbs = [], [], []
    for d in [(1 << 53) - 1, 1 << 53, (1 << 53) + 1, (1 << 54) - 1,
              ((1 << 52) - 1) ** 2, ((1 << 52) - 1) * ((1 << 52) - 3)]:
        if d == ((1 << 52) - 1) ** 2:
            fa, fb = (1 << 52) - 1, (1 << 52) - 1
        elif d == ((1 << 52) - 1) * ((1 << 52) - 3):
            fa, fb = (1 << 52) - 1, (1 << 52) - 3
        else:
            fa, fb = _small_factor(d)
        for c in [1, 2, 3, (1 << 52) - 1]:
            cs.append(min(c, d))
            fas.append(fa)
            fbs.append(fb)
    for k in range(1, 104):
        for c in (1, 3, (1 << min(k, 52)) - 1 or 1):
            cs.append(min(c, 1 << k))
            fas.append(1 << min(k, 51))
            fbs.append(1 << (k - min(k, 51)))
    for k in range(2, 54):
        for c in (3, 5, 101, (1 << 40) + 1):
            for delta in (-1, 0, 1):
                d = c * (1 << k) + delta
                split = _small_factor(d) if d >= (1 << 52) else (d, 1)
                if split is None:
                    continue
                cs.append(c)
                fas.append(split[0])
                fbs.append(split[1])
    for d in (1, 7, (1 << 52) - 3):  # c == d: exactly 1.0
        cs.append(d)
        fas.append(d)
        fbs.append(1)
    assert len(cs) > 500
    _check(cs, fas, fbs)


def test_random_wide():
    """Weights of every bit length up to 52, counts up to the smaller
    weight, as the JAX package's wide test draws them."""
    rng = np.random.default_rng(17)
    cs, fas, fbs = [], [], []
    for _ in range(4000):
        fa = int(rng.integers(1, 1 << int(rng.integers(1, 53))))
        fb = int(rng.integers(1, 1 << int(rng.integers(1, 53))))
        cs.append(int(rng.integers(1, min(fa, fb) + 1)))
        fas.append(fa)
        fbs.append(fb)
    assert not bitmath.is_narrow(torch.tensor(fas),
                                 torch.tensor(fbs)).all()
    _check(cs, fas, fbs)


def test_weights_near_2_52():
    """fa, fb just below 2**52 and counts just below 2**53: the domain's
    corner, where fa * fb reaches 2**104."""
    top = 1 << 52
    rng = np.random.default_rng(29)
    fas = [top - 1 - int(x) for x in rng.integers(0, 1 << 20, size=500)]
    fbs = [top - 1 - int(x) for x in rng.integers(0, 1 << 40, size=500)]
    cs = [(1 << 53) - 1 - int(x) for x in rng.integers(0, 1 << 30, size=500)]
    _check(cs, fas, fbs)
    _check([(1 << 53) - 1, 1, top - 1], [top - 1, top - 1, 1],
           [top - 1, 1, top - 1])


def test_narrow_test_exact_at_the_boundary():
    """``is_narrow`` splits at fa * fb = 2**53 exactly, without overflow."""
    fa = torch.tensor([1 << 26, 1 << 27, (1 << 53) - 1, 1 << 51, 3, 3,
                       (1 << 52) - 1], dtype=torch.int64)
    fb = torch.tensor([1 << 27, 1 << 26, 1, 4, 3002399751580330,
                       3002399751580331, (1 << 52) - 1], dtype=torch.int64)
    want = [int(a) * int(b) < (1 << 53) for a, b in zip(fa.tolist(),
                                                         fb.tolist())]
    assert bitmath.is_narrow(fa, fb).tolist() == want
    assert want == [False, False, True, False, True, False, False]


def test_scores_sort_like_values():
    rng = np.random.default_rng(5)
    c = rng.integers(1, 1 << 20, size=1000).tolist()
    fa = rng.integers(1, 1 << 30, size=1000).tolist()
    fb = rng.integers(1, 1 << 30, size=1000).tolist()
    bits = np.array(_port(c, fa, fb))
    vals = np.array([x / (y * z) for x, y, z in zip(c, fa, fb)])
    assert np.array_equal(np.argsort(bits, kind="stable"),
                          np.argsort(vals, kind="stable"))


def test_domain_constants_match_jax():
    assert MAX_TOKENS_WP == JAX_MAX == 1 << 52


def test_wrapper_checks():
    z = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="no kernel"):
        score_bits(*(x.to("meta") for x in (z, z, z)))
    with pytest.raises(TypeError):
        score_bits(z.to(torch.int32), z, z)
    with pytest.raises(ValueError, match="inconsistent"):
        score_bits(z, z[:2], z)
    assert score_bits(z[:0], z[:0], z[:0]).tolist() == []
