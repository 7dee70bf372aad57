"""Exact WordPiece scores: the IEEE-754 bits of ``c / (fa * fb)``.

The reference scores a pair ``count / (freq_a * freq_b)`` in Python
(CPython's ``int / int``, correctly rounded at any operand size), and
its tie-break is reached only on exact equality of those doubles. So
the port selects on the bits of the correctly rounded double, viewed as
int64; for positive doubles they sort like the values.

The JAX package computes the bits by integer long division (its
``ops/bitmath.py``: ``div_double_bits`` for denominators below 2^53,
``div_double_bits_wide`` with ``mul_53x53`` above), because its TPU's
emulated f64 divide is not correctly rounded. Here:

- narrow entries (``fa * fb < 2**53``): both operands are exact doubles
  and IEEE division rounds correctly, so ``c.double() / d.double()`` is
  the answer (the kernel uses ``__ddiv_rn``);
- wide entries (``fa * fb >= 2**53``, which needs at least 2**26 symbol
  occurrences): CPython's ``int / int`` element by element in the plain
  version, a 128-bit restoring division with a round-half-even tail in
  the kernel.

Domain: ``c < 2**53`` and ``fa, fb < 2**52`` (``MAX_TOKENS_WP``).
Arguments below 1 are raised to 1, as the JAX scorer does.

:func:`mul_53x53` is the JAX package's exact 128-bit product, for the
tournament's plain version (ops/wp_tournament.py).

The kernel's scorer is a ``__device__`` function of
``csrc/select_unify.cu``, inlined into K2's WordPiece mode;
:func:`score_bits` launches it on its own for the checks.
"""
from __future__ import annotations

import struct

import torch

from ..benchmarks import profiling
from . import check_tensor

NARROW = 1 << 53
MASK53 = (1 << 53) - 1


def is_narrow(fa, fb):
    """``fa * fb < 2**53`` elementwise, without overflow (positive
    int64)."""
    return fa <= (NARROW - 1) // fb


def score_bits_ref(c, fa, fb):
    """Plain PyTorch version of :func:`score_bits`."""
    c, fa, fb = (x.clamp(min=1) for x in (c, fa, fb))
    narrow = is_narrow(fa, fb)
    d = torch.where(narrow, fa * fb, 1)
    out = (c.double() / d.double()).view(torch.int64)
    wide = torch.nonzero(~narrow).flatten().tolist()
    if wide:
        cs, fas, fbs = (x[wide].tolist() for x in (c, fa, fb))
        out[wide] = torch.tensor(
            [struct.unpack("<q", struct.pack("<d", x / (y * z)))[0]
             for x, y, z in zip(cs, fas, fbs)], dtype=torch.int64,
            device=out.device)
    return out


def score_bits(c, fa, fb):
    """int64 bits of the correctly rounded double
    ``max(c, 1) / (max(fa, 1) * max(fb, 1))``, elementwise over three
    int64 vectors of one length.

    Launches the kernel's scorer for CUDA tensors, runs the PyTorch
    version for CPU tensors, and raises for any other device.
    """
    dev = c.device
    for name, t in (("c", c), ("fa", fa), ("fb", fb)):
        check_tensor(name, t, (torch.int64,), 1, dev)
    n = c.shape[0]
    if fa.shape[0] != n or fb.shape[0] != n:
        raise ValueError("score_bits: inconsistent shapes")
    if dev.type == "cpu":
        return score_bits_ref(c, fa, fb)
    if dev.type != "cuda":
        raise ValueError(f"score_bits: no kernel for device {dev}")
    out = torch.empty_like(c)
    if n == 0:
        return out
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_score_bits", c.data_ptr(), fa.data_ptr(),
                     fb.data_ptr(), n, out.data_ptr())
    profiling.count("launch.score_bits")
    return out


def mul_53x53(a, b):
    """Exact product of two int64 tensors of values below 2**53, as
    base-2**53 limbs ``(hi, lo)``: ``a * b == hi * 2**53 + lo``, ``0 <= lo
    < 2**53`` (the JAX package's ``mul_53x53``; every intermediate stays
    below 2**63)."""
    a1, a0 = a >> 27, a & ((1 << 27) - 1)
    b1, b0 = b >> 27, b & ((1 << 27) - 1)
    hl = a1 * b0 + a0 * b1
    lo_raw = a0 * b0 + ((hl & ((1 << 26) - 1)) << 27)
    hi = ((a1 * b1) << 1) + (hl >> 26) + (lo_raw >> 53)
    return hi, lo_raw & MASK53
