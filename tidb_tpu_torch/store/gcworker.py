# ported from tidb_tpu/store/gcworker.py @ 3951242
"""MVCC garbage collection worker.

Reference analog: pkg/store/gcworker (GCWorker gc_worker.go:68) — a
leader-elected background loop computes a safepoint (now - gc_life_time)
and asks the store to drop versions below it.  The native engine's
timestamps are logical (TSO counter), so the worker samples (wall
clock, ts) pairs each run and resolves the safepoint to the newest
sampled ts older than the life window.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional


class GCWorker:
    def __init__(self, kv, life_seconds: float = 600.0):
        self.kv = kv
        self.life_seconds = life_seconds
        self._samples: deque[tuple[float, int]] = deque(maxlen=512)
        self.last_safepoint = 0
        self.total_dropped = 0

    def run_once(self, now: Optional[float] = None) -> int:
        """One GC round: sample the TSO, resolve + apply the safepoint."""
        now = time.time() if now is None else now
        self._samples.append((now, self.kv.alloc_ts()))
        safepoint = 0
        for wall, ts in self._samples:
            if now - wall >= self.life_seconds:
                safepoint = max(safepoint, ts)
        if safepoint <= self.last_safepoint:
            return 0
        dropped = self.kv.gc(safepoint)
        self.last_safepoint = safepoint
        self.total_dropped += dropped
        return dropped


__all__ = ["GCWorker"]
