"""Tags, versions, configurations — the paper's §II model objects.

A *tag* is ``(ts, wid)`` ordered lexicographically (timestamp, writer id) —
ARES's operation-ordering token, which CoARES reuses as the coverable
*version* of the object (§IV: "we use tags to denote the version").
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

Tag = tuple[int, str]
TAG0: Tag = (0, "")

P, F = "P", "F"  # configuration status: proposed / finalized


def next_tag(t: Tag, wid: str) -> Tag:
    """Alg 1:18 — new version from the discovered maximum."""
    return (t[0] + 1, wid)


@dataclass(frozen=True)
class Config:
    """A configuration c ∈ C (§II): server set + DAP choice (+ EC params).

    ``dap``: "abd" | "ec" | "ec_opt". For EC DAPs, ``k`` data fragments out
    of ``n = len(servers)`` coded fragments, and ``delta`` = max concurrent
    put-data operations (List length bound δ+1, Alg 5).
    """

    cfg_id: str
    servers: tuple[str, ...]
    dap: str = "abd"
    k: int = 1
    delta: int = 8

    @property
    def n(self) -> int:
        return len(self.servers)

    def quorum(self) -> int:
        """ABD: majority ⌊n/2⌋+1. EC: ⌈(n+k)/2⌉ (paper §VII-A)."""
        if self.dap == "abd":
            return self.n // 2 + 1
        return -((self.n + self.k) // -2)  # ceil

    def majority(self) -> int:
        return self.n // 2 + 1

    def frag_index(self, sid: str) -> int:
        return self.servers.index(sid)

    def wire_size(self) -> int:
        return 16 + sum(len(s) for s in self.servers)


@dataclass
class CSeqEntry:
    config: Config
    status: str  # P | F


@dataclass
class OpRecord:
    """History record for the linearizability / coverability checkers."""

    kind: str            # "read" | "write" | "recon"
    obj: str
    client: str
    start: float
    end: float
    tag: Optional[Tag] = None
    flag: Optional[str] = None   # chg | unchg (writes)
    value_digest: Optional[int] = None
    extra: dict = field(default_factory=dict)


def digest(value: Any) -> int:
    if value is None:
        return 0
    if isinstance(value, (bytes, bytearray)):
        return hash(bytes(value))
    return hash(value)
