# ported from tidb_tpu/planner/join_reorder.py @ e08c981
"""Cost-based greedy join reorder.

The port has no statistics yet (ROADMAP.md, Queue 1 item 5): it plans
as the JAX package plans over tables that were never ANALYZEd, where
``stats_handle.get(table)`` is None and every estimate is the row count
times the pseudo selectivities (planner/cardinality.py).  The port
passes ``stats_handle=None``, which gives the same estimates.

Reference analog: pkg/planner/core/rule/rule_join_reorder.go — the greedy
variant: flatten a maximal inner/cross join tree into a join group, start
from the smallest (post-filter) relation, and repeatedly attach the
relation that minimizes the estimated intermediate result, using table
stats (row counts, per-column NDV) from the ANALYZE subsystem.

The reordered tree is left-deep with a restoring Projection on top so
parent operators keep seeing the original column order.  Left/semi/anti
joins are reorder barriers (they keep their sides, which reorder
internally).
"""

from __future__ import annotations

from typing import Optional

from ..expr.ir import ColumnRef, Expr, Func, referenced_columns
from .cardinality import est_scan_rows
from .logical import (DataSource, LogicalJoin, LogicalPlan,
                      LogicalProjection, LogicalSelection, Schema)
from .optimize import _remap, _subst, map_refs

# joins whose group exceeds this leaf count keep parse order (the
# reference switches from DP to greedy at a threshold; we are greedy-only
# and cap purely defensively)
MAX_GROUP = 12

DEFAULT_ROWS = 1000.0          # leaf estimate without stats


def reorder_joins(plan: LogicalPlan, stats_handle) -> LogicalPlan:
    """Recursively reorder every maximal inner-join group in the plan."""
    if isinstance(plan, LogicalJoin) and plan.kind in ("inner", "cross"):
        return _reorder_group(plan, stats_handle)
    for i, c in enumerate(plan.children):
        plan.children[i] = reorder_joins(c, stats_handle)
    if hasattr(plan, "child"):
        plan.child = plan.children[0]
    if isinstance(plan, LogicalJoin):
        plan.left, plan.right = plan.children
    return plan


# ------------------------------------------------------------------ #

def _flatten(p: LogicalPlan, leaves: list, conds: list, offset: int) -> int:
    """Flatten an inner/cross join tree.  Returns the column count of p.
    conds collect as (expr-over-original-global-order)."""
    if isinstance(p, LogicalJoin) and p.kind in ("inner", "cross"):
        n_left = _flatten(p.left, leaves, conds, offset)
        n_right = _flatten(p.right, leaves, conds, offset + n_left)
        for li, ri in p.eq_keys:
            l = p.left.schema.ref(li)
            r = p.right.schema.ref(ri)
            conds.append(Func(
                l.dtype, "eq",
                (ColumnRef(l.dtype, li + offset, l.name),
                 ColumnRef(r.dtype, ri + offset + n_left, r.name))))
        for c in p.other_conds:
            conds.append(_remap(c, offset))
        return n_left + n_right
    leaves.append((offset, p))
    return len(p.schema)


def _leaf_rows(leaf: LogicalPlan, stats_handle) -> float:
    """Estimated post-filter cardinality of a join-group leaf."""
    conds: list = []
    cur = leaf
    while isinstance(cur, (LogicalSelection, LogicalProjection)):
        if isinstance(cur, LogicalSelection):
            conds += list(cur.conditions)
        else:
            # rebase collected conditions through the projection so they
            # reference DataSource columns (matches _col_ndv's walk)
            try:
                conds = [_subst(c, cur.exprs) for c in conds]
            except IndexError:
                return DEFAULT_ROWS
        cur = cur.children[0]
    if isinstance(cur, DataSource):
        st = stats_handle.get(cur.table) if stats_handle is not None else None
        try:
            return max(est_scan_rows(st, conds, cur), 1.0)
        except Exception:
            return max(float(cur.table.num_rows), 1.0)
    n = getattr(getattr(cur, "table", None), "num_rows", None)
    return float(n) if n else DEFAULT_ROWS


def _col_ndv(leaf: LogicalPlan, local_ci: int, stats_handle,
             fallback: float) -> float:
    """NDV of a leaf's output column (for eq-join size estimation)."""
    cur = leaf
    ci = local_ci
    while isinstance(cur, (LogicalSelection, LogicalProjection)):
        if isinstance(cur, LogicalProjection):
            e = cur.exprs[ci]
            if not isinstance(e, ColumnRef):
                return fallback
            ci = e.index
        cur = cur.children[0]
    if isinstance(cur, DataSource) and stats_handle is not None:
        st = stats_handle.get(cur.table)
        if st is not None and ci < len(cur.col_offsets):
            name = cur.schema.cols[ci].name
            cs = st.col(name)
            if cs is not None and cs.ndv > 0:
                return float(cs.ndv)
    return fallback


def _refs_leaves(e: Expr, spans: list) -> set:
    """Which leaves (by position in spans) an expr references."""
    out = set()
    for r in referenced_columns(e):
        for i, (lo, hi) in enumerate(spans):
            if lo <= r < hi:
                out.add(i)
                break
    return out


def _reorder_inside_leaves(p: LogicalPlan, stats_handle) -> None:
    """Oversized group: keep its order but still reorder nested join
    groups hiding inside the group's leaves (e.g. under outer joins)."""
    if isinstance(p, LogicalJoin) and p.kind in ("inner", "cross"):
        _reorder_inside_leaves(p.left, stats_handle)
        _reorder_inside_leaves(p.right, stats_handle)
        return
    for i, c in enumerate(p.children):
        p.children[i] = reorder_joins(c, stats_handle)
    if hasattr(p, "child"):
        p.child = p.children[0]
    if isinstance(p, LogicalJoin):
        p.left, p.right = p.children


def _reorder_group(root: LogicalJoin, stats_handle) -> LogicalPlan:
    leaves_off: list = []
    conds: list = []
    total_cols = _flatten(root, leaves_off, conds, 0)
    leaves = [l for _, l in leaves_off]
    spans = [(off, off + len(l.schema)) for off, l in leaves_off]
    if not (2 <= len(leaves) <= MAX_GROUP):
        _reorder_inside_leaves(root, stats_handle)
        return root
    # reorder each leaf's own interior first
    leaves = [reorder_joins(l, stats_handle) for l in leaves]

    rows = [_leaf_rows(l, stats_handle) for l in leaves]
    cond_leafsets = [_refs_leaves(c, spans) for c in conds]

    def eq_edge(placed: set, cand: int):
        """eq conds joining the placed set to candidate `cand`; returns
        the max NDV across candidate-side key columns (join fanout)."""
        best = None
        for c, ls in zip(conds, cond_leafsets):
            if not (isinstance(c, Func) and c.op == "eq"):
                continue
            if cand not in ls or not (ls - {cand}) <= placed or len(ls) != 2:
                continue
            for r in referenced_columns(c):
                lo, hi = spans[cand]
                if lo <= r < hi:
                    ndv = _col_ndv(leaves[cand], r - lo, stats_handle,
                                   rows[cand])
                    best = ndv if best is None else max(best, ndv)
        return best

    # greedy: smallest leaf first, then minimize the running estimate.
    # LEADING(t, ...) pins the hinted table as the greedy start.
    order = None
    lead = getattr(root, "hint_leading", None)
    if lead:
        from .logical import find_datasource
        for t in lead:
            hit = next((i for i, l in enumerate(leaves)
                        if find_datasource(l, t) is not None), None)
            if hit is not None:
                order = [hit]
                break
    if order is None:
        order = [min(range(len(leaves)), key=lambda i: rows[i])]
    cur_rows = rows[order[0]]
    remaining = set(range(len(leaves))) - set(order)
    while remaining:
        # connected candidates (an eq edge to the placed set) strictly
        # before cross products — a cheap cross of two filtered tiny
        # tables must not beat joining along the graph (the reference's
        # greedy walks join edges; cartesian only when disconnected)
        best_i, best_est = None, None
        best_cross_i, best_cross_est = None, None
        for i in sorted(remaining):
            ndv = eq_edge(set(order), i)
            if ndv is not None:
                est = cur_rows * rows[i] / max(ndv, 1.0)
                if best_est is None or est < best_est:
                    best_i, best_est = i, est
            else:
                est = cur_rows * rows[i]
                if best_cross_est is None or est < best_cross_est:
                    best_cross_i, best_cross_est = i, est
        if best_i is None:            # disconnected: cross join
            best_i, best_est = best_cross_i, best_cross_est
        order.append(best_i)
        remaining.discard(best_i)
        cur_rows = max(best_est, 1.0)

    # rebuild in greedy order.  Physical orientation: both the broadcast
    # lookup join and the host hash join BUILD on the right, so each join
    # keeps its larger input on the left (probe) — the accumulated small
    # intermediate becomes the build side under a big probe table.
    placed = {order[0]}
    cur: LogicalPlan = leaves[order[0]]
    cur_origin = list(range(*spans[order[0]]))   # original global indexes
    cur_est = rows[order[0]]
    used = [False] * len(conds)
    for i in order[1:]:
        nxt = leaves[i]
        nxt_origin = list(range(*spans[i]))
        swap = rows[i] > cur_est        # bigger side probes (left)
        if swap:
            left, right = nxt, cur
            origin = nxt_origin + cur_origin
        else:
            left, right = cur, nxt
            origin = cur_origin + nxt_origin
        remap = {orig: newi for newi, orig in enumerate(origin)}
        n_left = len(left.schema)
        eq_keys: list = []
        others: list = []
        for j, (c, ls) in enumerate(zip(conds, cond_leafsets)):
            if used[j] or not ls <= placed | {i}:
                continue
            used[j] = True
            c2 = map_refs(c, remap)
            k = _as_local_eq(c2, n_left, len(right.schema))
            if k is not None:
                eq_keys.append(k)
            else:
                others.append(c2)
        placed.add(i)
        cur = LogicalJoin(
            "inner" if (eq_keys or others) else "cross", left, right,
            eq_keys=eq_keys, other_conds=others,
            schema=Schema(list(left.schema.cols) + list(right.schema.cols)))
        cur_origin = origin
        ndv = eq_edge(placed - {i}, i)
        cur_est = (cur_est * rows[i] / max(ndv, 1.0) if ndv is not None
                   else cur_est * rows[i])
    final_map = {orig: newi for newi, orig in enumerate(cur_origin)}
    # any condition not placed (shouldn't happen) goes above
    rest = [map_refs(c, final_map)
            for j, c in enumerate(conds) if not used[j]]
    if rest:
        cur = LogicalSelection(cur, rest)
    if cur_origin == list(range(total_cols)) and order == sorted(order):
        return cur       # layout unchanged; no restore needed
    # restore the original column order for parents
    refs = [cur.schema.ref(final_map[r]) for r in range(total_cols)]
    return LogicalProjection(cur, refs, Schema(list(root.schema.cols)))


def _as_local_eq(e: Expr, n_left: int, n_right: int):
    if (isinstance(e, Func) and e.op == "eq"
            and isinstance(e.args[0], ColumnRef)
            and isinstance(e.args[1], ColumnRef)):
        a, b = e.args[0].index, e.args[1].index
        if a < n_left <= b < n_left + n_right:
            return (a, b - n_left)
        if b < n_left <= a < n_left + n_right:
            return (b, a - n_left)
    return None


__all__ = ["reorder_joins"]
