"""Unicode character classes of the FastWP end-to-end scanner.

The tables are read by path from the JAX package's data file
``subword_tokenizers_tpu/frontend/unicode_tables.npz`` (made by
``tools/gen_unicode_tables.py``); nothing of that package is imported.
Each is a flat array indexed by codepoint:

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

TABLE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "subword_tokenizers_tpu", "frontend", "unicode_tables.npz")

_N = 0x110000


def _load():
    with np.load(TABLE_PATH) as z:
        n = int(z["n_codepoints"])
        assert n == _N, f"table codepoint space {n} != {_N}"
        ws_py = np.unpackbits(z["ws_py"])[:n].astype(bool)
        alnum_py = np.unpackbits(z["alnum_py"])[:n].astype(bool)
        lower = (z["lower_delta"].astype(np.int32)
                 + np.arange(n, dtype=np.int32)).astype(np.uint32)
        lower_special = np.unpackbits(z["lower_special"])[:n].astype(bool)
    return ws_py, alnum_py, lower, lower_special


WS_PY, ALNUM_PY, LOWER, LOWER_SPECIAL = _load()
PUNC_PY = ~(ALNUM_PY | WS_PY)


def codepoints(text: str) -> np.ndarray:
    """Codepoint array (uint32) of ``text``."""
    return np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32)


def lower_codepoints(text: str):
    """``str.lower()`` of ``text`` as a codepoint array, or None when
    ``text`` holds U+0130 or U+03A3, which the table cannot lower."""
    cps = codepoints(text)
    if cps.size and LOWER_SPECIAL[cps].any():
        return None
    return LOWER[cps]
