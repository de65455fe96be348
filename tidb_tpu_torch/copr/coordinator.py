# ported from tidb_tpu/copr/coordinator.py @ 9d319cb
"""Per-query coordinator: in-flight fragment registry + cross-connection
cancellation.

Reference analog: pkg/executor/mppcoordmanager (per-query registry of
dispatched MPP tasks, cancel fan-out) + the KILL path
(server/conn.go killConn -> executor interruption).  Execution here is
cooperative: every dispatch loop, retry/backoff iteration, streamed
batch, and host chunk boundary calls ``check_killed()``; KILL QUERY sets
the target session's kill event and the victim raises
``QueryInterrupted`` at its next checkpoint (MySQL error 1317 semantics).
"""

from __future__ import annotations

import contextvars
import threading
import time
from typing import Optional

# the ACTIVE statement's kill event — set by the session around each
# statement; travels into worker threads via contextvars.copy_context
KILL_EVENT: contextvars.ContextVar = contextvars.ContextVar(
    "kill_event", default=None)

# the active statement's coordinator handle (fragment registry)
QUERY_HANDLE: contextvars.ContextVar = contextvars.ContextVar(
    "query_handle", default=None)


class QueryInterrupted(RuntimeError):
    def __init__(self):
        super().__init__("Query execution was interrupted")


def check_killed() -> None:
    """Cancellation point: cheap enough for per-chunk/per-dispatch use."""
    ev = KILL_EVENT.get()
    if ev is not None and ev.is_set():
        raise QueryInterrupted()


class QueryHandle:
    """One statement's registration: live fragments for observability,
    plus device-scheduler accounting (queue wait / coalesced launches)
    surfaced in EXPLAIN ANALYZE as `schedWait` and in the statement
    summary."""

    __slots__ = ("conn_id", "sql", "started", "fragments", "_mu",
                 "sched_wait_ns", "sched_tasks", "sched_coalesced",
                 "sched_fused", "sched_rus", "sched_retried", "degraded",
                 "compile_ns", "compile_misses",
                 "hbm_predicted", "hbm_measured")

    def __init__(self, conn_id: int, sql: str):
        self.conn_id = conn_id
        self.sql = sql
        self.started = time.time()
        self.fragments: list = []
        self._mu = threading.Lock()
        self.sched_wait_ns = 0     # admission-queue wait, all cop tasks
        self.sched_tasks = 0       # device launches admitted
        self.sched_coalesced = 0   # tasks that rode a shared launch
        self.sched_fused = 0       # tasks served by a cross-query
                                   # fused launch (EXPLAIN `fused`)
        self.sched_rus = 0.0       # priced RUs debited for this
                                   # statement's device work (rc/)
        self.sched_retried = 0     # transient-failure re-launches the
                                   # drain spent on this statement's
                                   # tasks (EXPLAIN `retried`)
        self.degraded = 0          # cop dispatches served by the host
                                   # oracle after a launch quarantine
        self.compile_ns = 0        # program resolve/compile time this
                                   # statement's launches paid (copforge
                                   # compile cache; the compile_wait_ms
                                   # split out of schedWait)
        self.compile_misses = 0    # launches that compiled (vs warm hit)
        self.hbm_predicted = 0     # summed admission HBM predictions of
                                   # this statement's cop tasks (copgauge)
        self.hbm_measured = 0      # summed measured launch peaks (0 =
                                   # backend reported none / ledger off)

    def note_fragment(self, desc: str) -> None:
        with self._mu:
            self.fragments.append((desc, time.time()))

    def note_sched(self, wait_ns: int, coalesced: int,
                   fused: int = 0, rus: float = 0.0,
                   retried: int = 0, compile_ns: int = 0,
                   compile_miss: bool = False,
                   hbm_predicted: int = 0,
                   hbm_measured: int = 0) -> None:
        """Call seam contract (audited): ``fused`` is the
        MEMBER COUNT of the launch that served this task (scheduler
        ``_serve_fused`` sets ``task.fused = len(programs)``), so any
        real fusion — 2 members included — satisfies ``fused > 1`` and
        counts the task once.  The scheduler must set ``task.fused`` /
        ``task.coalesced`` BEFORE ``task.finish()``: this method runs
        on the waiter thread right after ``wait()`` returns, and a
        post-finish assignment raced it (the historical undercount).
        ``sched_tasks``/``sched_fused`` flow unchanged into EXPLAIN
        ANALYZE (``tasks:``/``fused:``) and statements_summary
        (Sum_sched_tasks/Sum_fused) so the two surfaces agree."""
        with self._mu:
            self.sched_wait_ns += int(wait_ns)
            self.sched_tasks += 1
            if coalesced > 1:
                self.sched_coalesced += 1
            if fused > 1:
                self.sched_fused += 1
            self.sched_rus += float(rus)
            self.sched_retried += int(retried)
            self.compile_ns += int(compile_ns)
            if compile_miss:
                self.compile_misses += 1
            self.hbm_predicted += int(hbm_predicted)
            self.hbm_measured += int(hbm_measured)

    def note_degraded(self) -> None:
        with self._mu:
            self.degraded += 1


class Coordinator:
    """Domain-wide registry of running statements (mppcoordmanager)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._active: dict[int, QueryHandle] = {}

    def begin(self, conn_id: int, sql: str) -> QueryHandle:
        h = QueryHandle(conn_id, sql)
        with self._mu:
            self._active[conn_id] = h
        return h

    def end(self, conn_id: int) -> None:
        with self._mu:
            self._active.pop(conn_id, None)

    def get(self, conn_id: int) -> Optional[QueryHandle]:
        with self._mu:
            return self._active.get(conn_id)

    def snapshot(self) -> list:
        with self._mu:
            return [(h.conn_id, h.sql, h.started, list(h.fragments))
                    for h in self._active.values()]


__all__ = ["Coordinator", "QueryHandle", "QueryInterrupted",
           "KILL_EVENT", "QUERY_HANDLE", "check_killed"]
