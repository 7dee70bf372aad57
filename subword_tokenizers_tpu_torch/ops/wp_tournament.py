"""WordPiece selection by tournament: exact comparisons, no division.

The JAX package's ``ops/wp_tournament.py`` finds the pair of largest
score ``c / (fa * fb)`` by a halving tree over the pair table, comparing
``c1 / d1`` with ``c2 / d2`` by the exact 128-bit products ``c1 * d2``
and ``c2 * d1`` (:func:`~.bitmath.mul_53x53`); equal rationals go by the
least position. A comparison whose relative gap is in (0, 2**-50] sets a
sticky ``risky`` flag: two distinct rationals round to one double only
within 2**-52, so without the flag the tree's winner is the exact-double
winner, and with it the caller redoes the step on the exact scores.

:func:`wp_tournament_select` repeats JAX's tree lane for lane (the table
padded with neutral lanes to a power of two, each round the first half
against the second), so its flag equals JAX's on the same table. It is
the plain version of K2's tournament mode (``csrc/select_unify.cu``,
ops/train_loop.select_unify), whose tree differs but whose winner, and
whose flag on a near tie of the two best entries, do not.

Domain: narrow scores only, every ``fa * fb < 2**52`` and count below
2**26 (fewer than 2**26 symbol occurrences).
"""
from __future__ import annotations

import torch

from .bitmath import mul_53x53, score_bits_ref
from .pairstats import EMPTY_KEY

NO_POS = 2 ** 31 - 1  # a neutral lane's position (the kernel's are int32)


def _cmp128(a_hi, a_lo, b_hi, b_lo):
    """(greater, equal) of two base-2**53 limb pairs."""
    eq_hi = a_hi == b_hi
    return (a_hi > b_hi) | (eq_hi & (a_lo > b_lo)), eq_hi & (a_lo == b_lo)


def _combine(x, y):
    """One round: the winner of each pair of lanes, as JAX's _combine."""
    cx, dx, px, kx, fx = x
    cy, dy, py, ky, fy = y
    u_hi, u_lo = mul_53x53(cx, dy)
    v_hi, v_lo = mul_53x53(cy, dx)
    greater, equal = _cmp128(u_hi, u_lo, v_hi, v_lo)
    m_hi = torch.where(greater, u_hi, v_hi)
    m_lo = torch.where(greater, u_lo, v_lo)
    s_lo = torch.where(greater, v_lo, u_lo)
    lo = m_lo - s_lo
    borrow = (lo < 0).to(torch.int64)
    d_lo = lo + (borrow << 53)
    d_hi = m_hi - torch.where(greater, v_hi, u_hi) - borrow
    t_hi = m_hi >> 50
    t_lo = ((m_hi & ((1 << 50) - 1)) << 3) | (m_lo >> 50)
    t_gt, t_eq = _cmp128(t_hi, t_lo, d_hi, d_lo)
    near = (t_gt | t_eq) & ~equal
    take_x = greater | (equal & (px <= py))
    return (torch.where(take_x, cx, cy), torch.where(take_x, dx, dy),
            torch.where(take_x, px, py), torch.where(take_x, kx, ky),
            fx | fy | near)


def wp_tournament_select(keys, counts, pos, sym_freq):
    """JAX's tournament over a pair table (keys ``a << 32 | b`` int64,
    ``EMPTY_KEY`` when empty; int64 counts; int32 or int64 positions) in
    the table's order, with the per-symbol weights ``sym_freq``.

    Returns (key, score bits, position, count, risky) as Python values;
    the key is ``EMPTY_KEY`` and the count 0 when the table holds no
    pair. With ``risky`` the winner may differ from the exact-double one.
    """
    live = keys != EMPTY_KEY
    k = torch.where(live, keys, 0)
    fa = sym_freq[k >> 32].clamp(min=1)
    fb = sym_freq[k & 0xFFFFFFFF].clamp(min=1)
    state = [torch.where(live, counts, 0), torch.where(live, fa * fb, 1),
             torch.where(live, pos.to(torch.int64), NO_POS),
             torch.where(live, keys, EMPTY_KEY),
             torch.zeros_like(live)]
    n = 1
    while n < keys.shape[0]:
        n *= 2
    pad = n - keys.shape[0]
    if pad:
        fills = (0, 1, NO_POS, EMPTY_KEY, False)
        state = [torch.cat([v, torch.full((pad,), f, dtype=v.dtype,
                                          device=v.device)])
                 for v, f in zip(state, fills)]
    while n > 1:
        h = n // 2
        state = list(_combine([v[:h] for v in state],
                              [v[h:n] for v in state]))
        n = h
    c, d, p, key, risky = (v[0] for v in state)
    bits = score_bits_ref(c.clamp(min=1).view(1), d.view(1),
                          torch.ones_like(d).view(1))
    return int(key), int(bits[0]), int(p), int(c), bool(risky)
