# ported from tidb_tpu/utils/memory.py @ 9d319cb
"""Memory governance: hierarchical tracker + action-on-exceed chain.

Reference analog: pkg/util/memory — Tracker (tracker.go:77) forms a tree
(statement -> operator), consumption propagates to the root where the
query quota (tidb_mem_quota_query) lives; on exceed the ActionOnExceed
chain (action.go:30) fires: softer actions first (spill to disk), then
cancel (the "Out Of Memory Quota!" error).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

_TRACK_MU = threading.RLock()


class MemoryExceededError(RuntimeError):
    """executor.ErrMemoryExceedForQuery analog."""

    def __init__(self, label: str, quota: int):
        super().__init__(
            f"Out Of Memory Quota! quota={quota} bytes, tracker={label}")


class Tracker:
    def __init__(self, label: str, limit: int = -1,
                 parent: Optional["Tracker"] = None):
        self.label = label
        self.limit = limit            # -1 = unlimited
        self.parent = parent
        self.consumed = 0
        self.max_consumed = 0
        self.actions = []             # softest first; last should cancel

    def attach_child(self, label: str) -> "Tracker":
        return Tracker(label, parent=self)

    def consume(self, n: int):
        # parallel host operators charge from worker threads (P10): the
        # shared counter update takes the module lock
        with _TRACK_MU:
            t = self
            while t is not None:
                t.consumed += n
                t.max_consumed = max(t.max_consumed, t.consumed)
                if 0 <= t.limit < t.consumed and n > 0:
                    t._on_exceed()
                t = t.parent

    def release(self, n: int):
        self.consume(-n)

    def _on_exceed(self):
        # softer actions first; any progress (e.g. a spill was triggered)
        # lets execution continue — the freed memory shows up via
        # release().  Only when no action can help does the query die.
        for action in self.actions:
            if action.act(self):
                return
        raise MemoryExceededError(self.label, self.limit)


class SpillDiskAction:
    """Asks registered spillable operators to move data to disk; succeeds
    if any of them frees memory (chunk/row_container.go:397 analog)."""

    def __init__(self):
        self._spillables = []

    def register(self, spillable):
        self._spillables.append(spillable)

    def act(self, tracker: Tracker) -> bool:
        progressed = False
        for sp in self._spillables:
            if sp.offer_spill():
                progressed = True
        return progressed


def sysvar_bool(v, default: bool = True) -> bool:
    """MySQL boolean sysvar forms: ON/OFF/TRUE/FALSE/1/0 (any case)."""
    if v is None:
        return default
    if isinstance(v, str):
        return v.strip().upper() in ("1", "ON", "TRUE", "YES")
    return bool(int(v))


def nbytes_of(columns) -> int:
    """Approximate bytes held by a list of chunk Columns."""
    total = 0
    for c in columns:
        total += c.data.nbytes + c.validity.nbytes
    return total
