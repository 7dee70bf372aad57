"""Deterministic string <-> id interning: ids are assigned in
first-intern order, so the trie's output ids follow the order in which
its build meets the tokens, and the BPE trainer's ids follow its merges.
Interning by string is what makes two merges that spell the same string
one symbol, as the reference's set-of-strings vocabulary does."""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional


class SymbolTable:
    """Append-only intern table mapping strings to dense ids."""

    __slots__ = ("_ids", "_strings")

    def __init__(self, strings: Optional[Iterable[str]] = None) -> None:
        self._ids: Dict[str, int] = {}
        self._strings: List[str] = []
        for s in strings or ():
            self.intern(s)

    def intern(self, s: str) -> int:
        """Return the id of ``s``, assigning the next id if unseen."""
        sid = self._ids.get(s)
        if sid is None:
            sid = len(self._strings)
            self._ids[s] = sid
            self._strings.append(s)
        return sid

    def get(self, s: str) -> Optional[int]:
        return self._ids.get(s)

    def __contains__(self, s: str) -> bool:
        return s in self._ids

    def __len__(self) -> int:
        return len(self._strings)

    def string(self, sid: int) -> str:
        return self._strings[sid]

    def strings(self) -> List[str]:
        return list(self._strings)
