# ported from tidb_tpu/obs/recorder.py @ df101aa
"""copscope flight recorder: bounded ring of completed query traces.

Reference analog: TiDB's continuous-profiling/Top-SQL direction — keep
enough recent per-query evidence in memory that the question "what did
that slow/failed statement actually spend its time on?" is answerable
AFTER the fact, without re-running anything.

Retention contract (tested):

- Interesting traces are ALWAYS admitted: any trace flagged ``failed``,
  ``degraded``, ``quarantined``, ``retried`` or ``slow`` (slower than
  ``tidb_tpu_slow_threshold_ms``).
- Ordinary traces are SAMPLED 1-in-``sample_every`` so the ring keeps
  a background rhythm without interesting traces being washed out by
  a flood of fast OKs.
- The ring is provably bounded: one deque(maxlen=capacity) holds
  everything — admission decides what enters, the ring bounds what
  stays.  No unbounded always-keep side list.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from .trace import SpanTree

DEFAULT_CAPACITY = 256
DEFAULT_SAMPLE_EVERY = 16

# flags that force admission regardless of the sampling cadence
KEEP_FLAGS = frozenset(
    {"failed", "degraded", "quarantined", "retried", "slow"})


class FlightRecorder:
    """Bounded ring of completed statement traces (``SpanTree``)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 sample_every: int = DEFAULT_SAMPLE_EVERY):
        self.capacity = max(int(capacity), 1)
        self.sample_every = max(int(sample_every), 1)
        self._ring: deque = deque(maxlen=self.capacity)
        self._mu = threading.Lock()
        self._seen = 0           # completed traces offered (lifetime)
        self.recorded = 0        # admitted to the ring (lifetime)
        self.sampled_out = 0     # ordinary traces the cadence skipped

    def record(self, tree: SpanTree) -> bool:
        """Offer one completed trace; True = admitted to the ring."""
        with self._mu:
            self._seen += 1
            keep = bool(tree.flags & KEEP_FLAGS) \
                or (self._seen % self.sample_every) == 1 \
                or self.sample_every == 1
            if not keep:
                self.sampled_out += 1
                return False
            self.recorded += 1
            self._ring.append(tree)
            return True

    def get(self, trace_id: str) -> Optional[SpanTree]:
        with self._mu:
            for tree in reversed(self._ring):
                if tree.trace_id == trace_id:
                    return tree
        return None

    def index(self) -> list[dict]:
        """Newest-first trace summaries — the ``/trace`` listing."""
        with self._mu:
            trees = list(self._ring)
        return [{
            "trace_id": t.trace_id,
            "conn_id": t.conn_id,
            "sql": t.sql[:200],
            "start_ts": t.wall_start,
            "latency_ms": round(t.latency_ms, 3),
            "flags": sorted(t.flags),
            "spans": len(t.spans),
        } for t in reversed(trees)]

    def stats(self) -> dict:
        with self._mu:
            return {"capacity": self.capacity,
                    "sample_every": self.sample_every,
                    "size": len(self._ring),
                    "seen": self._seen,
                    "recorded": self.recorded,
                    "sampled_out": self.sampled_out}

    def clear(self) -> None:
        with self._mu:
            self._ring.clear()

    def __len__(self) -> int:
        with self._mu:
            return len(self._ring)


__all__ = ["FlightRecorder", "KEEP_FLAGS", "DEFAULT_CAPACITY",
           "DEFAULT_SAMPLE_EVERY"]
