"""Unicode character classes of the front end and the FastWP scanner.

The tables are this package's ``frontend/unicode_tables.npz``, a copy of
the JAX package's (made by ``tools/gen_unicode_tables.py``).
Each is a flat array indexed by codepoint:

- ``WS_HF``         — Rust ``char::is_whitespace`` (Unicode White_Space),
                      the whitespace of the BERT pre-tokenizer.
- ``PUNCT_HF``      — the BERT pre-tokenizer's punctuation: ASCII
                      punctuation or Unicode general category P*.
- ``WS_PY``         — Python ``str.isspace``.
- ``ALNUM_PY``      — Python ``str.isalnum``.
- ``PUNC_PY``       — FastWP's ``ispunc``: neither alnum nor space.
- ``LOWER``         — ``str.lower`` for every codepoint whose lowercase
                      is one codepoint and needs no context.
- ``LOWER_SPECIAL`` — the two that do not: U+0130 and U+03A3.
"""
from __future__ import annotations

import os

import numpy as np

TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "unicode_tables.npz")

_N = 0x110000


def _load():
    with np.load(TABLE_PATH) as z:
        n = int(z["n_codepoints"])
        assert n == _N, f"table codepoint space {n} != {_N}"
        ws_hf = np.unpackbits(z["ws_hf"])[:n].astype(bool)
        punct_hf = np.unpackbits(z["punct_hf"])[:n].astype(bool)
        ws_py = np.unpackbits(z["ws_py"])[:n].astype(bool)
        alnum_py = np.unpackbits(z["alnum_py"])[:n].astype(bool)
        lower = (z["lower_delta"].astype(np.int32)
                 + np.arange(n, dtype=np.int32)).astype(np.uint32)
        lower_special = np.unpackbits(z["lower_special"])[:n].astype(bool)
    return ws_hf, punct_hf, ws_py, alnum_py, lower, lower_special


WS_HF, PUNCT_HF, WS_PY, ALNUM_PY, LOWER, LOWER_SPECIAL = _load()
PUNC_PY = ~(ALNUM_PY | WS_PY)


def codepoints(text: str) -> np.ndarray:
    """Codepoint array (uint32) of ``text``."""
    return np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32)


def to_text(cps: np.ndarray) -> str:
    """The string of a codepoint array."""
    return cps.astype("<u4").tobytes().decode("utf-32-le")


def lower_codepoints(text: str):
    """``str.lower()`` of ``text`` as a codepoint array, or None when
    ``text`` holds U+0130 or U+03A3, which the table cannot lower."""
    cps = codepoints(text)
    if cps.size and LOWER_SPECIAL[cps].any():
        return None
    return LOWER[cps]
