# ported from tidb_tpu/utils/execdetails.py @ df101aa
"""Per-operator runtime statistics for EXPLAIN ANALYZE.

Reference analog: pkg/util/execdetails RuntimeStatsColl — every executor
records wall time + produced rows; cop tasks additionally record device
dispatch details (select_result.go:605 updateCopRuntimeStats).  Here the
collection is a tree-walk wrapper around PhysOp.execute: child calls go
through instance attribute lookup, so binding a timing closure on each
node intercepts the whole Volcano tree without touching operator code.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class OpStats:
    op_id: int
    label: str
    time_ns: int = 0        # inclusive wall time (children included)
    rows: int = 0
    loops: int = 0
    # free-form execution detail an operator annotates itself with (e.g.
    # CopTask's `schedWait: ...` — the cop-task execution-info analog of
    # the reference's copr_cache/scan_detail strings)
    detail: str = ""

    @property
    def time_ms(self) -> float:
        return self.time_ns / 1e6


@dataclass
class RuntimeStatsColl:
    stats: dict = field(default_factory=dict)   # op_id -> OpStats

    def get(self, op_id: int) -> OpStats:
        return self.stats.get(op_id)


def instrument_tree(root, coll: RuntimeStatsColl) -> None:
    """Assign op ids depth-first and wrap each node's execute with a
    timing/row-counting closure (instance-level override)."""
    next_id = [0]

    def visit(op):
        op_id = next_id[0]
        next_id[0] += 1
        op._rt_id = op_id
        st = OpStats(op_id, op.describe())
        coll.stats[op_id] = st
        orig = op.execute     # bound method (class-level)

        def timed(ctx, _orig=orig, _st=st, _op=op):
            t0 = time.perf_counter_ns()
            chunk = _orig(ctx)
            _st.time_ns += time.perf_counter_ns() - t0
            _st.loops += 1
            _st.rows += chunk.num_rows
            d = getattr(_op, "_rt_detail", "")
            if d:
                _st.detail = d
            return chunk

        op.execute = timed
        for c in getattr(op, "children", []):
            visit(c)

    visit(root)


def explain_analyze_text(root, coll: RuntimeStatsColl) -> list[tuple]:
    """(operator, actRows, time, loops) rows in plan-tree order."""
    out = []

    def visit(op, depth):
        st = coll.get(getattr(op, "_rt_id", -1))
        pad = "  " * depth
        if st is None:
            out.append((pad + op.describe(), None, None, None))
        else:
            # re-describe at RENDER time: execution may have annotated the
            # operator (cop-cache hit, runtime join strategy, ...)
            label = pad + op.describe()
            if st.detail:
                label += f" [{st.detail}]"
            out.append((label, st.rows, f"{st.time_ms:.3f}ms", st.loops))
        for c in getattr(op, "children", []):
            visit(c, depth + 1)

    visit(root, 0)
    return out
