"""Deterministic string <-> id interning: ids are assigned in
first-intern order, so the trie's output ids follow the order in which
its build meets the tokens."""
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

    def string(self, sid: int) -> str:
        return self._strings[sid]

    def strings(self) -> List[str]:
        return list(self._strings)
