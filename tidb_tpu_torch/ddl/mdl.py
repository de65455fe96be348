# ported from tidb_tpu/ddl/mdl.py @ 3951242
"""Metadata locks: online DDL vs open transactions.

Reference analog: pkg/ddl/mdl/ (+ the design doc
docs/design/2021-09-22-data-consistency.md): a transaction that has USED
a table under schema version V holds a metadata lock on it; a DDL state
transition publishing version V+1 must wait until every transaction
still on a version < V+1 for that table drains (commits or rolls back)
before running the next transition — the F1 "wait for all nodes to ack
the new version" step.  The commit-time schema validation
(kv.go:533 SchemaVar analog in session._finish_txn) remains the backstop
for the wait-timeout path.
"""

from __future__ import annotations

import threading
import time


class MDLRegistry:
    """table_id -> {txn_token: schema_ver held}.  Tokens are the session
    txn objects; a token registers the version it FIRST saw (re-acquire
    keeps the oldest), and releases all its tables at txn end."""

    def __init__(self):
        self._cv = threading.Condition()
        self._holders: dict[int, dict[object, int]] = {}

    def acquire(self, table_id: int, token: object, ver: int) -> None:
        with self._cv:
            h = self._holders.setdefault(table_id, {})
            if token not in h or h[token] > ver:
                h[token] = ver

    def release_all(self, token: object) -> None:
        with self._cv:
            changed = False
            for h in self._holders.values():
                if h.pop(token, None) is not None:
                    changed = True
            if changed:
                self._cv.notify_all()

    def evict_below(self, table_id: int, ver: int) -> int:
        """Drop holders stuck below `ver` after a drain timeout: they are
        doomed to abort at commit (>=2-version gap), so later transitions
        must not re-wait on them.  Returns how many were evicted."""
        with self._cv:
            h = self._holders.get(table_id, {})
            stale = [t for t, v in h.items() if v < ver]
            for t in stale:
                del h[t]
            if stale:
                self._cv.notify_all()
            return len(stale)

    def holders_below(self, table_id: int, ver: int) -> int:
        with self._cv:
            h = self._holders.get(table_id, {})
            return sum(1 for v in h.values() if v < ver)

    def wait_drain(self, table_id: int, below_ver: int,
                   timeout_s: float = 10.0) -> bool:
        """Block until no txn holds `table_id` at a version < below_ver.
        Returns False on timeout (caller proceeds; the commit-time
        validation aborts any straggler instead)."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while True:
                h = self._holders.get(table_id, {})
                if not any(v < below_ver for v in h.values()):
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)


__all__ = ["MDLRegistry"]
