"""Small host-side utilities: the best-effort detokenizer of the JAX
package's ``utils.py`` and a progress writer for training."""
from __future__ import annotations

import re
import sys
import time
from typing import List

# Best-effort detokenizer. Whitespace is not recoverable from a token
# stream; this is the reference's punctuation handling, the same three
# patterns as the JAX package's.
_JOIN_SHARP = re.compile(r"\s##(\S)")
_LEFT_PUNCT = re.compile(r"\s(\.|,|\)|\]|\\|’|-|\'|\\|/)")
_RIGHT_PUNCT = re.compile(r"(\(|\[|\\|’|-|\'|\\|/)\s")


def recover_sentence(tokens: List[str]) -> str:
    """Join tokens into a readable sentence (not a faithful inverse)."""
    out = " ".join(tokens)
    out = _JOIN_SHARP.sub(r"\g<1>", out)
    out = _LEFT_PUNCT.sub(r"\g<1>", out)
    out = _RIGHT_PUNCT.sub(r"\g<1>", out)
    return out


class Progress:
    """A count of done steps over ``total``, written to stderr as
    ``desc: n/total`` on one line that is rewritten at most every
    ``EVERY`` seconds, and ended by :meth:`close`. It stands in for a
    tqdm bar, which the port does not depend on."""

    EVERY = 0.5

    def __init__(self, total: int, desc: str) -> None:
        self.total = total
        self.desc = desc
        self.n = 0
        self._last = float("-inf")

    def update(self, n: int = 1) -> None:
        self.n += n
        now = time.monotonic()
        if now - self._last >= self.EVERY:
            self._last = now
            self._write("\r")

    def close(self) -> None:
        self._write("\r")
        sys.stderr.write("\n")
        sys.stderr.flush()

    def _write(self, lead: str) -> None:
        sys.stderr.write(f"{lead}{self.desc}: {self.n}/{self.total}")
        sys.stderr.flush()
