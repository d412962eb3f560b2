"""VarName: symbol + optional indexing, mirroring DynamicPPL's VarName.

Each model-parameter tilde site is identified at run time by a VarName
holding the user-facing symbol (e.g. ``"w"``) plus indexing info for array
element sites written in loops (e.g. ``"x[3]"``). ``typify`` groups element
sites of the same symbol into one stacked, concretely-typed array.
"""
from __future__ import annotations

import re
from typing import Optional, Tuple

# symbols may be dotted: compositional models (``submodel``) prefix the
# inner model's site names with "<name>." (paper §5 future work)
_INDEXED = re.compile(
    r"^([A-Za-z_][A-Za-z0-9_.]*)\[([0-9]+(?:\s*,\s*[0-9]+)*)\]$")


class VarName:
    __slots__ = ("sym", "index")

    def __init__(self, sym: str, index: Optional[Tuple[int, ...]] = None):
        self.sym = sym
        self.index = tuple(index) if index is not None else None

    @classmethod
    def parse(cls, name: str) -> "VarName":
        m = _INDEXED.match(name)
        if m:
            idx = tuple(int(p) for p in m.group(2).split(","))
            return cls(m.group(1), idx)
        return cls(name)

    @property
    def indexed(self) -> bool:
        return self.index is not None

    def __str__(self) -> str:
        if self.index is None:
            return self.sym
        return f"{self.sym}[{','.join(map(str, self.index))}]"

    def __repr__(self) -> str:
        return f"VarName({self!s})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, VarName)
            and self.sym == other.sym
            and self.index == other.index
        )

    def __hash__(self) -> int:
        return hash((self.sym, self.index))
