# ported from tidb_tpu/rc/runaway.py @ 02e96d8
"""Runaway watch: queue+execution wall-time budget per resource group.

Reference analog: pkg/resourcegroup/runaway — a QUERY_LIMIT
(EXEC_ELAPSED = '...', ACTION = ...) marks statements exceeding the
budget as runaway.  Upgrades over the pre-rc watch:

- the watched time is QUEUE + EXECUTION wall time: a statement that
  spent its life throttled in the admission queue counts (the budget is
  a user-visible latency promise, not a CPU meter);
- three actions: KILL raises, COOLDOWN demotes the charge (the
  statement pays double), SWITCH_GROUP(<name>) re-prices the statement
  against the target group — its device debit moves buckets, so a
  runaway analytics query spends the batch group's RUs, not the
  interactive group's;
- every decision appends to a bounded ring of runaway records surfaced
  on /resource (the reference's mysql.tidb_runaway_queries table).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

RUNAWAY_RING_CAP = 256

RUNAWAY_ACTIONS = ("kill", "cooldown", "switch_group")


class RunawayError(RuntimeError):
    """Statement exceeded the group's EXEC_ELAPSED budget with
    ACTION=KILL (runaway detector).  TiDB error space 8253
    (ErrResourceGroupQueryRunawayInterrupted)."""

    errno = 8253


@dataclass(frozen=True)
class RunawayRecord:
    ts: float            # wall-clock seconds (time.time)
    group: str
    action: str          # kill | cooldown | switch_group
    target: str          # SWITCH_GROUP destination ('' otherwise)
    sql: str             # statement text sample (truncated)
    elapsed_s: float     # queue + execution wall time
    sched_wait_s: float  # the queue share of elapsed_s

    def as_dict(self) -> dict:
        return {"ts": self.ts, "group": self.group, "action": self.action,
                "target": self.target, "sql": self.sql,
                "elapsed_s": round(self.elapsed_s, 4),
                "sched_wait_s": round(self.sched_wait_s, 4)}


class RunawayRing:
    """Bounded, thread-safe ring of runaway decisions (newest last)."""

    def __init__(self, cap: int = RUNAWAY_RING_CAP):
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=cap)
        self.total = 0

    def add(self, group: str, action: str, target: str, sql: str,
            elapsed_s: float, sched_wait_s: float) -> RunawayRecord:
        rec = RunawayRecord(time.time(), group, action, target or "",
                            sql[:256], elapsed_s, sched_wait_s)
        with self._mu:
            self._ring.append(rec)
            self.total += 1
        from ..utils.metrics import global_registry
        global_registry().counter(
            "tidb_tpu_rc_runaway_total",
            "runaway statements detected", labels=("action",)).inc(
                action=action)
        return rec

    def records(self, n: int = 32) -> list:
        with self._mu:
            return [r.as_dict() for r in list(self._ring)[-n:]]


def is_runaway(group, elapsed_s: float) -> bool:
    """Does ``elapsed_s`` of queue+execution wall time bust the group's
    EXEC_ELAPSED budget?"""
    return bool(group.exec_elapsed_sec
                and elapsed_s > group.exec_elapsed_sec)


__all__ = ["RunawayError", "RunawayRecord", "RunawayRing", "is_runaway",
           "RUNAWAY_ACTIONS", "RUNAWAY_RING_CAP"]
