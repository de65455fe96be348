# ported from tidb_tpu/planner/cascades/__init__.py @ 1da0078
"""Cascades-style memo optimizer.

Reference analog: pkg/planner/cascades/ (cascades.go, the memo package
pkg/planner/memo/group.go, and the property-driven cost search of
core/optimizer.go:1080 physicalOptimize / core/find_best_task.go).

The pipeline stays shared with the heuristic path (the reference's
cascades likewise shares the normalize-rule list, core/optimizer.go:80-85):
constant folding, predicate pushdown, column pruning and index-path
selection run first; this package then

  1. builds a **memo** of groups/group-expressions from the logical tree
     (`memo.py`),
  2. **explores** alternatives — DP join-order enumeration over each
     maximal inner-join group, TopN-through-outer-join pushdown
     (`search.py` transformation rules),
  3. **implements** each group under a required *order property*,
     costing physical alternatives (hash vs merge vs index-lookup join,
     sort enforcer vs order-providing child) with the stats-fed model in
     `cost.py`, and
  4. **extracts** the winning tree back to ordinary logical operators —
     join-method annotations ride `LogicalJoin.hint_method`, satisfied
     sorts are dropped, ordered TopN becomes Limit — so the existing
     device/host lowering (`executor/plan.py to_physical`) stays the
     single code generator.

Enabled per-session via `tidb_enable_cascades_planner` (the reference's
sysvar of the same name).  Any failure falls back to the greedy
join-reorder path, so the flag can never break a query.
"""

from __future__ import annotations


def cascades_optimize(plan, stats_handle):
    """Memo search over `plan`; falls back to greedy reorder on any error."""
    from ..join_reorder import reorder_joins
    try:
        from .search import search
        return search(plan, stats_handle)
    except Exception:
        return reorder_joins(plan, stats_handle)


__all__ = ["cascades_optimize"]
