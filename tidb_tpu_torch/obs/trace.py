# ported from tidb_tpu/obs/trace.py @ df101aa
"""copscope trace core: cross-thread trace propagation + per-statement
span trees.

Reference analog: pkg/util/tracing's StartRegionEx regions rendered by
the TRACE statement (executor/trace.go), grown to the Canopy/Dapper
shape the async stack needs — the statement path crosses seven thread
seams (admission queue, rc throttle, fusion window, copforge compile,
supervised launch, transfer, host merge) so the depth-counter Tracer of
``utils/tracing`` cannot attribute them.  Here every span carries an
EXPLICIT parent id and the per-statement tree is lock-protected, so the
scheduler drain, copforge resolve, and client transfer seams record
real spans from their own threads and the session renderer stitches one
tree.

Propagation is contextvar + task-stamp:

- ``TRACE_CTX`` holds the session-side ``TraceCtx`` (tree + current
  span id); ``span(name)`` nests under it within one thread.
- ``CopTask`` captures ``current()`` at construction (same discipline
  as ``SCHED_GROUP``/``KILL_EVENT``), so the drain thread can record
  spans under the submitting statement's dispatch span via
  ``ctx.add(...)`` — no contextvar crosses the thread boundary.

Recording is deliberately cheap (one tuple append under the tree lock;
``add`` is the only hot-path entry) so tracing can stay on in
production — ``chip_smoke.py``'s observability phase measures it on
the card (a warm Q6 with ``tidb_tpu_trace`` on and off).
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from contextlib import contextmanager
from typing import Optional

# the active statement's TraceCtx; None = tracing off / no statement
TRACE_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "trace_ctx", default=None)

_TRACE_SEQ = itertools.count(1)


def new_trace_id(conn_id: int = 0) -> str:
    """Process-unique trace id: conn + monotonic sequence (readable in
    logs, stable enough for the flight-recorder index)."""
    return f"{conn_id:x}-{next(_TRACE_SEQ):06x}"


class Span:
    """One completed (or open) region.  ``parent_id`` is explicit —
    depth is DERIVED at render time, never tracked by a counter, so
    spans recorded out of order from other threads still nest right."""

    __slots__ = ("span_id", "parent_id", "name", "start_ns", "end_ns",
                 "thread", "attrs")

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 start_ns: int, end_ns: int = 0,
                 thread: str = "", attrs: Optional[dict] = None):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.thread = thread
        self.attrs = attrs or {}

    @property
    def duration_us(self) -> float:
        return (self.end_ns - self.start_ns) / 1e3


class SpanTree:
    """Lock-protected per-statement span collector.

    Every mutation takes ``_mu``; renders snapshot under it.  Span ids
    are tree-local ints; parent links make the tree — the session's
    root span is the statement, client dispatch spans hang under it,
    and scheduler-thread spans hang under the dispatch span whose
    ``TraceCtx`` rode the CopTask."""

    def __init__(self, trace_id: str = "", sql: str = "", conn_id: int = 0):
        self.trace_id = trace_id or new_trace_id(conn_id)
        self.sql = sql
        self.conn_id = conn_id
        self.t0 = time.perf_counter_ns()
        self.wall_start = time.time()
        self.latency_ms = 0.0
        self.flags: set = set()       # failed/degraded/quarantined/
                                      # retried/slow — recorder retention
        self.spans: list[Span] = []
        self._mu = threading.Lock()
        self._next = 0

    # ---- recording (any thread) ---------------------------------- #

    def add(self, name: str, start_ns: int, end_ns: int,
            parent_id: Optional[int] = None, **attrs) -> int:
        """Record one COMPLETED span — the cross-thread hot path (the
        drain records post-measurement, pre-``finish``, so a waiter
        rendering the tree always sees its scheduler spans)."""
        with self._mu:
            sid = self._next = self._next + 1
            self.spans.append(Span(
                sid, parent_id, name, start_ns, end_ns,
                thread=threading.current_thread().name, attrs=attrs))
            return sid

    def add_batch(self, items: list) -> list[int]:
        """Record several completed spans in ONE lock acquisition —
        the drain's per-launch recording path (queue + launch +
        compile + fusion per task would otherwise take the lock four
        times at the scheduler's serialization point).

        ``items``: ``(name, start_ns, end_ns, parent, attrs)`` tuples;
        ``parent`` is a span id, None, or ``("rel", i)`` referring to
        the i-th span OF THIS BATCH (the launch->compile nesting)."""
        thread = threading.current_thread().name
        out: list[int] = []
        with self._mu:
            for name, start_ns, end_ns, parent, attrs in items:
                if isinstance(parent, tuple):
                    parent = out[parent[1]]
                sid = self._next = self._next + 1
                self.spans.append(Span(sid, parent, name, start_ns,
                                       end_ns, thread=thread,
                                       attrs=attrs))
                out.append(sid)
        return out

    def begin(self, name: str, parent_id: Optional[int] = None,
              **attrs) -> int:
        return self.add(name, time.perf_counter_ns(), 0,
                        parent_id, **attrs)

    def end(self, span_id: int, **attrs) -> None:
        now = time.perf_counter_ns()
        with self._mu:
            for sp in reversed(self.spans):
                if sp.span_id == span_id:
                    sp.end_ns = now
                    if attrs:
                        sp.attrs.update(attrs)
                    return

    def flag(self, *names: str) -> None:
        with self._mu:
            self.flags.update(names)

    def annotate(self, span_id: int, **attrs) -> None:
        with self._mu:
            for sp in reversed(self.spans):
                if sp.span_id == span_id:
                    sp.attrs.update(attrs)
                    return

    # ---- rendering ------------------------------------------------ #

    def _snapshot(self) -> list[Span]:
        with self._mu:
            return list(self.spans)

    def ordered(self) -> list[tuple[Span, int]]:
        """(span, depth) depth-first, children ordered by start time —
        the TRACE result-set order.  Orphan parents (span recorded
        before its parent — impossible today, defensive) render at
        root depth rather than vanish."""
        spans = self._snapshot()
        ids = {sp.span_id for sp in spans}
        kids: dict = {}
        roots: list = []
        for sp in spans:
            if sp.parent_id is not None and sp.parent_id in ids:
                kids.setdefault(sp.parent_id, []).append(sp)
            else:
                roots.append(sp)
        out: list = []

        def walk(sp: Span, depth: int) -> None:
            out.append((sp, depth))
            for ch in sorted(kids.get(sp.span_id, ()),
                             key=lambda s: (s.start_ns, s.span_id)):
                walk(ch, depth + 1)

        for sp in sorted(roots, key=lambda s: (s.start_ns, s.span_id)):
            walk(sp, 0)
        return out

    def rows(self) -> list[tuple]:
        """TRACE renderer rows: (indented name [attrs], start_us_rel,
        duration_us)."""
        out = []
        for sp, depth in self.ordered():
            end = sp.end_ns or sp.start_ns
            label = "  " * depth + sp.name
            if sp.attrs:
                kv = ", ".join(f"{k}={_fmt(v)}"
                               for k, v in sorted(sp.attrs.items()))
                label += f" {{{kv}}}"
            out.append((label,
                        round((sp.start_ns - self.t0) / 1e3, 1),
                        round((end - sp.start_ns) / 1e3, 1)))
        return out

    def to_dict(self) -> dict:
        """Flight-recorder / ``/trace/<id>`` JSON shape."""
        return {
            "trace_id": self.trace_id,
            "conn_id": self.conn_id,
            "sql": self.sql,
            "start_ts": self.wall_start,
            "latency_ms": round(self.latency_ms, 3),
            "flags": sorted(self.flags),
            "spans": [{
                "id": sp.span_id, "parent": sp.parent_id,
                "name": sp.name, "thread": sp.thread,
                "start_us": round((sp.start_ns - self.t0) / 1e3, 1),
                "duration_us": round(
                    ((sp.end_ns or sp.start_ns) - sp.start_ns) / 1e3, 1),
                "attrs": {k: _json_safe(v)
                          for k, v in sorted(sp.attrs.items())},
            } for sp, _d in self.ordered()],
        }

    def chrome_trace(self) -> dict:
        """Chrome trace-event / Perfetto JSON (``?fmt=chrome``): one
        complete ("ph": "X") event per span, tids = recording threads
        so the cross-thread seams are visible as separate tracks."""
        tids: dict = {}
        events = []
        for sp, _d in self.ordered():
            tid = tids.setdefault(sp.thread, len(tids) + 1)
            end = sp.end_ns or sp.start_ns
            events.append({
                "name": sp.name, "ph": "X", "pid": 1, "tid": tid,
                "ts": round((sp.start_ns - self.t0) / 1e3, 3),
                "dur": round((end - sp.start_ns) / 1e3, 3),
                "cat": sp.name.split(".", 1)[0],
                "args": {k: _json_safe(v)
                         for k, v in sorted(sp.attrs.items())},
            })
        meta = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                 "args": {"name": thread}}
                for thread, tid in sorted(tids.items(), key=lambda kv: kv[1])]
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms",
                "otherData": {"trace_id": self.trace_id, "sql": self.sql}}


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.3f}"
    return str(v)


def _json_safe(v):
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    return str(v)


class TraceCtx:
    """Propagation unit: (tree, parent span id).  Stamped onto CopTask
    at submit; the drain records under ``span_id`` from its own thread.
    The trace id lives on the tree — one per statement."""

    __slots__ = ("tree", "span_id")

    def __init__(self, tree: SpanTree, span_id: Optional[int] = None):
        self.tree = tree
        self.span_id = span_id

    @property
    def trace_id(self) -> str:
        return self.tree.trace_id

    def add(self, name: str, start_ns: int, end_ns: int, **attrs) -> int:
        """Record a completed child span from ANY thread."""
        return self.tree.add(name, start_ns, end_ns,
                             parent_id=self.span_id, **attrs)

    def child(self, span_id: int) -> "TraceCtx":
        return TraceCtx(self.tree, span_id)


def current() -> Optional[TraceCtx]:
    """The calling thread's active trace context (None = untraced)."""
    return TRACE_CTX.get()


@contextmanager
def span(name: str, **attrs):
    """Session-side nested region: opens a child span under the active
    context and re-points ``TRACE_CTX`` at it for the dynamic extent,
    so tasks submitted inside hang under THIS span.  A no-op (yields
    None) when tracing is off — callers never branch."""
    ctx = TRACE_CTX.get()
    if ctx is None:
        yield None
        return
    t0 = time.perf_counter_ns()
    sid = ctx.tree.add(name, t0, 0, parent_id=ctx.span_id, **attrs)
    sub = TraceCtx(ctx.tree, sid)
    tok = TRACE_CTX.set(sub)
    try:
        yield sub
    finally:
        TRACE_CTX.reset(tok)
        ctx.tree.end(sid)


def flag(*names: str) -> None:
    """Mark the active trace (quarantined/degraded/...); no-op when
    untraced."""
    ctx = TRACE_CTX.get()
    if ctx is not None:
        ctx.tree.flag(*names)


def annotate(**attrs) -> None:
    """Attach attrs to the active span; no-op when untraced."""
    ctx = TRACE_CTX.get()
    if ctx is not None and ctx.span_id is not None:
        ctx.tree.annotate(ctx.span_id, **attrs)


__all__ = ["Span", "SpanTree", "TraceCtx", "TRACE_CTX", "current",
           "span", "flag", "annotate", "new_trace_id"]
