# ported from tidb_tpu/utils/stmtsummary.py @ df101aa
"""Statement summary + slow query log.

Reference analog: pkg/util/stmtsummary (per-digest aggregated workload
stats behind information_schema.statements_summary) and the slow-query
log (executor/adapter_slow_log.go, slow_query.go).  Digest = the SQL text
with literals normalized out, like pkg/parser/digester.go.
"""

from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass, field

_NUM = re.compile(r"\b\d+(?:\.\d+)?\b")
_WS = re.compile(r"\s+")
_IN_LIST = re.compile(r"\(\s*\?(?:\s*,\s*\?)+\s*\)")


def _strip_strings_and_comments(sql: str) -> str:
    """One left-to-right pass replacing string literals with ? and
    removing comments — regex passes cannot order these correctly (a
    quote inside a comment, or comment markers inside a string, corrupt
    each other's extents)."""
    out = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c in "'\"":
            q = c
            i += 1
            while i < n:
                if sql[i] == "\\":
                    i += 2
                    continue
                if sql[i] == q:
                    if i + 1 < n and sql[i + 1] == q:   # '' escape
                        i += 2
                        continue
                    i += 1
                    break
                i += 1
            out.append("?")
            continue
        if (sql.startswith("--", i)
                and (i + 2 >= n or sql[i + 2].isspace())) or c == "#":
            # MySQL: '--' starts a comment only when followed by
            # whitespace — 'a--1' is subtraction, not a comment
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            out.append(" ")
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            i = n if j < 0 else j + 2
            out.append(" ")
            continue
        out.append(c)
        i += 1
    return "".join(out)


def normalize_sql(sql: str) -> str:
    """Literal-free normalized form (digester.go analog).  Comments —
    including /*+ hint */ blocks — do not participate in the digest, so a
    hinted statement matches its unhinted original (bindinfo contract)."""
    s = _strip_strings_and_comments(sql)
    s = _NUM.sub("?", s)
    s = _WS.sub(" ", s).strip().lower()
    s = _IN_LIST.sub("(...)", s)   # collapse IN/VALUES lists
    return s


@dataclass
class StmtStats:
    digest: str
    sample_sql: str
    exec_count: int = 0
    sum_latency_ns: int = 0
    max_latency_ns: int = 0
    sum_rows: int = 0
    first_seen: float = 0.0
    last_seen: float = 0.0
    # Top-SQL attribution (pkg/util/topsql): CPU time + plan digest so
    # the hottest (sql, plan) pairs rank by actual processor cost
    sum_cpu_ns: int = 0
    plan_digest: str = ""
    sample_plan: str = ""
    # device-scheduler admission wait (sched/): how long this digest's
    # cop tasks queued before launching
    sum_sched_wait_ns: int = 0
    # priced request units this digest's device work debited (rc/):
    # fused launches attribute per member, shared scan priced once
    sum_rus: float = 0.0
    # program resolve/compile time the digest's launches paid (copforge
    # compile cache): the compile_wait_ms split out of schedWait, so a
    # cache win shows up as Avg_compile_ms -> ~0 while Avg_sched_wait_ms
    # keeps the queueing story
    sum_compile_ns: int = 0
    # copscope: device tasks this digest admitted and how many of them
    # rode a cross-query fused launch — surfaced next to the wait/RU
    # columns so EXPLAIN ANALYZE and statements_summary tell one story
    sum_sched_tasks: int = 0
    sum_fused: int = 0

    @property
    def avg_latency_ms(self) -> float:
        return self.sum_latency_ns / max(self.exec_count, 1) / 1e6

    @property
    def avg_sched_wait_ms(self) -> float:
        return self.sum_sched_wait_ns / max(self.exec_count, 1) / 1e6

    @property
    def avg_ru(self) -> float:
        return self.sum_rus / max(self.exec_count, 1)

    @property
    def avg_compile_ms(self) -> float:
        return self.sum_compile_ns / max(self.exec_count, 1) / 1e6


@dataclass
class SlowQuery:
    sql: str
    latency_ms: float
    ts: float
    rows: int
    # copscope: per-entry evidence — where the latency went
    # (admission wait, compile), what it cost (RUs), whether it was
    # retried, and the flight-recorder trace id so the slow-log line
    # links straight to its span tree at /trace/<id>
    sched_wait_ms: float = 0.0
    compile_ms: float = 0.0
    ru: float = 0.0
    retried: int = 0
    trace_id: str = ""


class StmtSummary:
    """Per-Domain workload summary + slow log ring.

    ``slow_threshold_ms`` is live state plumbed from the
    ``tidb_tpu_slow_threshold_ms`` sysvar (session -> Domain) — the
    constructor default only seeds it."""

    DEFAULT_SLOW_THRESHOLD_MS = 300.0

    def __init__(self, slow_threshold_ms: float = DEFAULT_SLOW_THRESHOLD_MS,
                 max_slow: int = 256):
        self._stats: dict[str, StmtStats] = {}
        self._slow: list[SlowQuery] = []
        self._lock = threading.Lock()
        self.slow_threshold_ms = slow_threshold_ms
        self.max_slow = max_slow

    def record(self, sql: str, latency_ns: int, rows: int,
               cpu_ns: int = 0, plan_text: str = "",
               sched_wait_ns: int = 0, rus: float = 0.0,
               compile_ns: int = 0, sched_tasks: int = 0,
               fused: int = 0, retried: int = 0,
               trace_id: str = "") -> bool:
        """Returns True when the statement crossed the slow threshold
        (the caller flags its trace ``slow`` for the flight recorder)."""
        digest = normalize_sql(sql)
        now = time.time()
        with self._lock:
            st = self._stats.get(digest)
            if st is None:
                st = StmtStats(digest, sql, first_seen=now)
                self._stats[digest] = st
            st.exec_count += 1
            st.sum_latency_ns += latency_ns
            st.max_latency_ns = max(st.max_latency_ns, latency_ns)
            st.sum_rows += rows
            st.last_seen = now
            st.sum_cpu_ns += int(cpu_ns)
            st.sum_sched_wait_ns += int(sched_wait_ns)
            st.sum_rus += float(rus)
            st.sum_compile_ns += int(compile_ns)
            st.sum_sched_tasks += int(sched_tasks)
            st.sum_fused += int(fused)
            if plan_text:
                import hashlib
                st.plan_digest = hashlib.sha256(
                    plan_text.encode()).hexdigest()[:16]
                st.sample_plan = plan_text
            slow = latency_ns / 1e6 >= self.slow_threshold_ms
            if slow:
                self._slow.append(SlowQuery(
                    sql, latency_ns / 1e6, now, rows,
                    sched_wait_ms=sched_wait_ns / 1e6,
                    compile_ms=compile_ns / 1e6, ru=float(rus),
                    retried=int(retried), trace_id=trace_id))
                if len(self._slow) > self.max_slow:
                    self._slow.pop(0)
            return slow

    def summary_rows(self) -> list[tuple]:
        with self._lock:
            return [(s.digest, s.exec_count, round(s.avg_latency_ms, 3),
                     round(s.max_latency_ns / 1e6, 3), s.sum_rows,
                     s.sample_sql, round(s.avg_sched_wait_ms, 3),
                     round(s.avg_compile_ms, 3), s.sum_sched_tasks,
                     s.sum_fused, round(s.avg_ru, 2))
                    for s in sorted(self._stats.values(),
                                    key=lambda x: -x.sum_latency_ns)]

    def top_sql_rows(self, n: int = 30) -> list[tuple]:
        """Top statements by CPU time (util/topsql reporter analog):
        (sql_digest, plan_digest, cpu_ms, exec_count, avg_latency_ms,
        sample_sql, sample_plan)."""
        with self._lock:
            ranked = sorted(self._stats.values(),
                            key=lambda x: -(x.sum_cpu_ns
                                            or x.sum_latency_ns))[:n]
            return [(s.digest, s.plan_digest,
                     round((s.sum_cpu_ns or s.sum_latency_ns) / 1e6, 3),
                     s.exec_count, round(s.avg_latency_ms, 3),
                     s.sample_sql, s.sample_plan)
                    for s in ranked]

    def slow_rows(self) -> list[tuple]:
        with self._lock:
            return [(q.sql, round(q.latency_ms, 3), q.rows,
                     round(q.sched_wait_ms, 3), round(q.compile_ms, 3),
                     round(q.ru, 2), q.retried, q.trace_id)
                    for q in self._slow]
