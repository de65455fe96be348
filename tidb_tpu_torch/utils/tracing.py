# ported from tidb_tpu/utils/tracing.py @ df101aa
"""Intra-statement tracing: named regions -> span tree.

Reference analog: pkg/util/tracing (StartRegionEx wrapping opentracing
spans at every major phase — session.go:2114, adapter, copr) and the
TRACE statement renderer (executor/trace.go).

Since copscope this module is a compatibility shim over
``tidb_tpu_torch.obs``: the old depth-counter model is gone — regions carry
EXPLICIT parent span ids on a lock-protected ``obs.SpanTree``, and
``region`` re-points ``obs.TRACE_CTX`` for its dynamic extent so device
work dispatched inside (scheduler drain, copforge resolve, transfer)
records real spans into the same tree from other threads.  The old
surface (``Tracer.region`` / ``Tracer.spans`` with ``.depth`` /
``Tracer.rows``) keeps working.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

from ..obs.trace import TRACE_CTX, SpanTree, TraceCtx


@dataclass
class Span:
    """Back-compat render view (the live spans are ``obs.Span``)."""

    name: str
    start_ns: int
    end_ns: int = 0
    depth: int = 0

    @property
    def duration_us(self) -> float:
        return (self.end_ns - self.start_ns) / 1e3


class Tracer:
    """Per-statement span collector over an ``obs.SpanTree``.

    Regions nest via explicit parent ids (cross-thread safe); the
    legacy depth-counter API is preserved as a derived view."""

    def __init__(self, tree: SpanTree | None = None):
        self.tree = tree or SpanTree()
        self._t0 = self.tree.t0

    @contextmanager
    def region(self, name: str, **attrs):
        """Open a child region under the innermost active region and
        bind it as the thread's active trace context, so any device
        work dispatched inside stitches under it."""
        ctx = TRACE_CTX.get()
        parent = ctx.span_id if ctx is not None \
            and ctx.tree is self.tree else None
        sid = self.tree.begin(name, parent_id=parent, **attrs)
        tok = TRACE_CTX.set(TraceCtx(self.tree, sid))
        try:
            yield sid
        finally:
            TRACE_CTX.reset(tok)
            self.tree.end(sid)

    @property
    def spans(self) -> list[Span]:
        """Depth-annotated spans in tree (render) order — the legacy
        shape tests and embedders consume."""
        return [Span(sp.name, sp.start_ns, sp.end_ns, depth)
                for sp, depth in self.tree.ordered()]

    def rows(self) -> list[tuple]:
        """(span, start_us_rel, duration_us) rows, indented by depth."""
        return self.tree.rows()


__all__ = ["Span", "Tracer"]
