# ported from tidb_tpu/planner/bindinfo.py @ 6233200
"""SQL plan management: plan bindings (pkg/bindinfo analog).

A binding maps a NORMALIZED statement digest to a hinted variant of the
same statement.  At plan time, a statement with no hints of its own that
matches a binding digest inherits the binding's optimizer hints — the
production mechanism for pinning a plan without editing application SQL
(bindinfo/binding.go, bind_record.go).  Bindings live per Domain
(GLOBAL) or per Session (SESSION); session bindings shadow global ones.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

from ..utils.stmtsummary import normalize_sql


@dataclass
class Binding:
    digest: str          # normalized original statement
    original_sql: str
    bind_sql: str        # the hinted statement
    hints: list = field(default_factory=list)   # parsed [(NAME, [args])]
    status: str = "enabled"


class BindManager:
    """Digest-keyed binding store (bindinfo.BindHandle analog)."""

    def __init__(self):
        self._bindings: dict[str, Binding] = {}
        self._lock = threading.Lock()

    def create(self, original_sql: str, bind_sql: str, hints: list) -> Binding:
        b = Binding(normalize_sql(original_sql), original_sql, bind_sql,
                    hints)
        with self._lock:
            self._bindings[b.digest] = b
        return b

    def drop(self, original_sql: str) -> bool:
        d = normalize_sql(original_sql)
        with self._lock:
            return self._bindings.pop(d, None) is not None

    def match(self, sql: str) -> Optional[Binding]:
        if not self._bindings:
            # no binding to match: skip the digest, which every
            # statement would otherwise pay twice (session and global)
            return None
        with self._lock:
            b = self._bindings.get(normalize_sql(sql))
        return b if b is not None and b.status == "enabled" else None

    def rows(self) -> list[tuple]:
        with self._lock:
            return [(b.original_sql, b.bind_sql, b.status)
                    for b in self._bindings.values()]


__all__ = ["Binding", "BindManager"]
