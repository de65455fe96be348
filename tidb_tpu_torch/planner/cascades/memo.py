# ported from tidb_tpu/planner/cascades/memo.py @ 1da0078
"""Memo: groups of logically-equivalent plan expressions.

Reference analog: pkg/planner/memo/group.go + group_expr.go.  A Group is
an equivalence class of logical subtrees sharing one output schema and
one cardinality estimate; a GroupExpr is one operator whose children are
groups.  Expressions are deduplicated by fingerprint so the DP join-order
rule's rebuilt trees share leaf groups with the original tree instead of
duplicating them (the memo's whole point).

Column references are positional in this framework, so alternative join
orders carry their own restoring Projection (exactly like
join_reorder.py's rebuild) — that keeps every expression in a group
schema-identical, which is what makes the groups true equivalence
classes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ...expr.ir import ColumnRef
from ..logical import (DataSource, LogicalAggregate, LogicalApply,
                       LogicalCTEScan, LogicalExpand, LogicalJoin,
                       LogicalLimit, LogicalPlan, LogicalProjection,
                       LogicalSelection, LogicalSetOp, LogicalSort,
                       LogicalTopN, LogicalWindow)


@dataclass
class GroupExpr:
    node: LogicalPlan              # payload; its .children are IGNORED
    child_ids: tuple               # group ids, in child order
    fingerprint: tuple = None


@dataclass
class Group:
    gid: int
    exprs: list = field(default_factory=list)
    schema: object = None
    rows: float = 1000.0           # cardinality estimate (logical property)
    # physical memo: prop key -> Winner (search.py)
    best: dict = field(default_factory=dict)


class Memo:
    def __init__(self):
        self.groups: list[Group] = []
        self._fp_to_group: dict = {}    # expr fingerprint -> gid

    def group(self, gid: int) -> Group:
        return self.groups[gid]

    def new_group(self, schema, rows: float) -> Group:
        g = Group(len(self.groups), schema=schema, rows=rows)
        self.groups.append(g)
        return g

    def insert_expr(self, node: LogicalPlan, child_ids: tuple,
                    group: Optional[Group], rows: float) -> int:
        """Insert one expression; dedup by fingerprint.  Returns the gid
        it landed in (an existing group on a fingerprint hit)."""
        fp = node_fingerprint(node, child_ids)
        hit = self._fp_to_group.get(fp)
        if hit is not None:
            if group is not None and hit != group.gid:
                # the same expression appearing in two groups would merge
                # them in a full cascades engine; alternatives here are
                # only ever inserted into the group they were derived
                # from, so just keep the first placement
                return hit
            return hit
        if group is None:
            group = self.new_group(node.schema, rows)
        group.exprs.append(GroupExpr(node, child_ids, fp))
        self._fp_to_group[fp] = group.gid
        return group.gid

    def insert_tree(self, plan: LogicalPlan, stats_handle,
                    into: Optional[Group] = None) -> int:
        """Recursively insert a logical tree, returning its root gid."""
        child_ids = tuple(self.insert_tree(c, stats_handle)
                          for c in getattr(plan, "children", [])
                          if c is not None)
        rows = estimate_rows(plan, [self.groups[i].rows for i in child_ids],
                             stats_handle)
        return self.insert_expr(plan, child_ids, into, rows)


# ------------------------------------------------------------------ #
# fingerprints

def _exprs_fp(exprs) -> tuple:
    return tuple(str(e) for e in exprs)


def node_fingerprint(n: LogicalPlan, child_ids: tuple) -> tuple:
    t = type(n).__name__
    if isinstance(n, DataSource):
        key = (n.alias.lower(), id(n.table), tuple(n.col_offsets or ()),
               str(getattr(n, "as_of_ts", None)))
    elif isinstance(n, LogicalSelection):
        key = _exprs_fp(n.conditions)
    elif isinstance(n, LogicalProjection):
        key = _exprs_fp(n.exprs)
    elif isinstance(n, LogicalAggregate):
        key = (_exprs_fp(n.group_exprs),
               tuple((a.func.value, str(a.arg), a.distinct) for a in n.aggs))
    elif isinstance(n, LogicalJoin):
        key = (n.kind, tuple(n.eq_keys), _exprs_fp(n.other_conds),
               n.null_aware)
    elif isinstance(n, (LogicalSort, LogicalTopN)):
        key = (tuple((str(e), d) for e, d in n.keys),
               getattr(n, "limit", None), getattr(n, "offset", 0))
    elif isinstance(n, LogicalLimit):
        key = (n.limit, n.offset)
    elif isinstance(n, LogicalSetOp):
        key = (n.kind, n.all)
    elif isinstance(n, LogicalExpand):
        key = (_exprs_fp(n.keys or ()), n.levels)
    elif isinstance(n, LogicalWindow):
        key = tuple((w.func, _exprs_fp(w.args), _exprs_fp(w.partition),
                     tuple((str(e), d) for e, d in w.order), str(w.frame))
                    for w in n.items)
    else:
        # LogicalApply / CTEScan / index nodes: identity (no dedup) —
        # they carry engine handles that positional fingerprints can't
        # capture safely
        key = (id(n),)
    return (t, key, child_ids)


# ------------------------------------------------------------------ #
# cardinality (logical property; reference pkg/planner/cardinality)

def _ds_of_chain(n):
    """DataSource at the bottom of a Selection/Projection chain, if any."""
    cur = n
    while isinstance(cur, (LogicalSelection, LogicalProjection)):
        cur = cur.children[0]
    return cur if isinstance(cur, DataSource) else None


def estimate_rows(n: LogicalPlan, child_rows: list, stats_handle) -> float:
    from ..cardinality import conds_selectivity
    if isinstance(n, DataSource):
        return max(float(getattr(n.table, "num_rows", 0) or 0), 1.0)
    if isinstance(n, LogicalSelection):
        base = child_rows[0] if child_rows else 1.0
        ds = _ds_of_chain(n.children[0])
        if ds is not None and stats_handle is not None:
            st = stats_handle.get(ds.table)
            try:
                return max(base * conds_selectivity(st, n.conditions, ds),
                           1.0)
            except Exception:
                pass
        return max(base * (0.8 ** len(n.conditions)), 1.0)
    if isinstance(n, LogicalJoin):
        l = child_rows[0] if child_rows else 1.0
        r = child_rows[1] if len(child_rows) > 1 else 1.0
        if n.kind in ("semi", "anti"):
            return max(l * 0.5, 1.0)
        if not n.eq_keys:
            return max(l * r, 1.0)
        ndv = max(join_key_ndv(n, stats_handle), 1.0)
        out = l * r / ndv
        if n.kind == "left":
            out = max(out, l)
        elif n.kind == "right":
            out = max(out, r)
        return max(out, 1.0)
    if isinstance(n, LogicalAggregate):
        if not n.group_exprs:
            return 1.0
        base = child_rows[0] if child_rows else 1.0
        ndv = group_ndv(n, stats_handle)
        return max(min(ndv if ndv is not None else base ** 0.75, base), 1.0)
    if isinstance(n, (LogicalTopN, LogicalLimit)):
        base = child_rows[0] if child_rows else 1.0
        return max(min(base, float(n.limit + n.offset)), 1.0)
    if isinstance(n, LogicalSetOp):
        return max(sum(child_rows), 1.0)
    if isinstance(n, LogicalExpand):
        return max((child_rows[0] if child_rows else 1.0) * n.levels, 1.0)
    if isinstance(n, LogicalCTEScan):
        return 1000.0
    return max(child_rows[0] if child_rows else 1000.0, 1.0)


def join_key_ndv(n: LogicalJoin, stats_handle) -> float:
    """Max key-column NDV across both sides (join_reorder's fanout rule)."""
    from ..join_reorder import _col_ndv
    best = 1.0
    for li, ri in n.eq_keys:
        for side, ci in ((n.children[0], li), (n.children[1], ri)):
            rows = getattr(getattr(side, "table", None), "num_rows", None)
            fb = float(rows) if rows else 1000.0
            try:
                best = max(best, _col_ndv(side, ci, stats_handle, fb))
            except Exception:
                pass
    return best


def group_ndv(n: LogicalAggregate, stats_handle) -> Optional[float]:
    """Product of group-key NDVs when every key is a stats-backed column."""
    ds = _ds_of_chain(n.children[0])
    if ds is None or stats_handle is None:
        return None
    st = stats_handle.get(ds.table)
    if st is None:
        return None
    total = 1.0
    for e in n.group_exprs:
        if not isinstance(e, ColumnRef):
            return None
        cs = st.col(ds.schema.cols[e.index].name) \
            if e.index < len(ds.schema.cols) else None
        if cs is None or cs.ndv <= 0:
            return None
        total *= float(cs.ndv)
    return total


__all__ = ["Memo", "Group", "GroupExpr", "node_fingerprint",
           "estimate_rows"]
