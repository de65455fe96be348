# ported from tidb_tpu/planner/rules.py @ 9d319cb
"""Standalone logical rewrite rules beyond the core optimize_plan pipeline.

Reference analogs from the 27-rule list (core/optimizer.go:87-115):
  * eliminate_max_min       — rule_max_min_eliminate.go: a bare MAX/MIN
    over an indexed column becomes TopN(1) over an index-ordered walk,
    turning a full scan into an index seek.
  * eliminate_aggregation   — rule_aggregation_elimination.go: GROUP BY
    covering the table's primary key makes every group one row; the agg
    collapses to a projection.
  * rewrite_skew_distinct   — rule_aggregation_skew_distinctagg.go: a
    grouped DISTINCT aggregate splits into a dedup pre-aggregate on
    (keys, d) and a plain final aggregate — here it doubles as the path
    that keeps DISTINCT work on the device (the inner agg is a plain
    multi-key group-by the fused engine handles), gated by
    tidb_opt_skew_distinct_agg exactly like the reference.
"""

from __future__ import annotations

from typing import Optional

from ..copr.dag import AggFunc
from ..expr import builders as B
from ..expr.ir import ColumnRef
from ..types import dtypes as dt
from .logical import (AggItem, DataSource, LogicalAggregate, LogicalPlan,
                      LogicalProjection, LogicalSelection, LogicalTopN,
                      Schema, SchemaCol)


def _recurse(plan: LogicalPlan, fn) -> LogicalPlan:
    for i, c in enumerate(plan.children):
        plan.children[i] = fn(c)
    if hasattr(plan, "child"):
        plan.child = plan.children[0]
    if len(plan.children) == 2 and hasattr(plan, "left"):
        plan.left, plan.right = plan.children
    return plan


def _chain_ds(n) -> Optional[DataSource]:
    cur = n
    while isinstance(cur, LogicalSelection):
        cur = cur.children[0]
    return cur if isinstance(cur, DataSource) else None


# ------------------------------------------------------------------ #
# MAX/MIN elimination

def eliminate_max_min(plan: LogicalPlan) -> LogicalPlan:
    """MAX(c)/MIN(c) with no GROUP BY over an index-led column: rewrite
    the input to TopN(1) ordered by c so the physical planner's
    index-ordered walk (executor/plan.py _try_index_ordered_topn) serves
    it with an early-stop seek instead of a full scan."""
    plan = _recurse(plan, eliminate_max_min)
    if not isinstance(plan, LogicalAggregate) or plan.group_exprs \
            or len(plan.aggs) != 1:
        return plan
    item = plan.aggs[0]
    if item.func not in (AggFunc.MAX, AggFunc.MIN) \
            or not isinstance(item.arg, ColumnRef):
        return plan
    ds = _chain_ds(plan.children[0])
    if ds is None or getattr(ds.table, "kv", None) is None \
            or getattr(ds.table, "partition", None) is not None \
            or getattr(ds, "as_of_ts", None) is not None \
            or getattr(ds.table, "is_memtable", False):
        return plan
    ci = item.arg.index
    if ci >= len(ds.col_offsets):
        return plan
    col_name = ds.table.col_names[ds.col_offsets[ci]].lower()
    if not any(ix.state == "public" and ix.columns[0].lower() == col_name
               for ix in getattr(ds.table, "indexes", [])):
        return plan
    child = plan.children[0]
    if item.arg.dtype.nullable:
        # MAX/MIN skip NULLs; the ordered walk must too
        # (rule_max_min_eliminate.go injects the same IsNotNull)
        child = LogicalSelection(
            child, [B.logic("not", B.is_null(child.schema.ref(ci)))])
    topn = LogicalTopN(child,
                       [(child.schema.ref(ci), item.func is AggFunc.MAX)],
                       1)
    plan.children[0] = topn
    plan.child = topn
    return plan


# ------------------------------------------------------------------ #
# aggregation elimination over unique keys

_SCALARIZABLE = (AggFunc.COUNT, AggFunc.SUM, AggFunc.MIN, AggFunc.MAX,
                 AggFunc.FIRST, AggFunc.ANY_VALUE)


def eliminate_aggregation(plan: LogicalPlan) -> LogicalPlan:
    """GROUP BY covering the child table's primary key: every group is a
    single row, so aggregates evaluate row-wise and the whole operator
    becomes a Projection (rule_aggregation_elimination.go)."""
    plan = _recurse(plan, eliminate_aggregation)
    if not isinstance(plan, LogicalAggregate) or not plan.group_exprs:
        return plan
    ds = _chain_ds(plan.children[0])
    if ds is None:
        return plan
    pk = [c.lower() for c in getattr(ds.table, "primary_key", [])]
    if not pk:
        return plan
    key_cols = set()
    for e in plan.group_exprs:
        if isinstance(e, ColumnRef) and e.index < len(ds.col_offsets):
            key_cols.add(ds.table.col_names[ds.col_offsets[e.index]]
                         .lower())
    if not set(pk) <= key_cols:
        return plan
    if not all(a.func in _SCALARIZABLE
               and (a.arg is not None or a.func is AggFunc.COUNT)
               for a in plan.aggs):
        return plan
    exprs = list(plan.group_exprs)
    for a in plan.aggs:
        if a.arg is None:                     # COUNT(*)
            exprs.append(B.lit(1, a.out_dtype))
        elif a.func is AggFunc.COUNT:
            exprs.append(B.if_(B.is_null(a.arg),
                               B.lit(0, a.out_dtype),
                               B.lit(1, a.out_dtype)))
        else:
            exprs.append(B.cast(a.arg, a.out_dtype))
    return LogicalProjection(plan.children[0], exprs,
                             Schema(list(plan.schema.cols)))


# ------------------------------------------------------------------ #
# skew-distinct two-stage split

def rewrite_skew_distinct(plan: LogicalPlan) -> LogicalPlan:
    plan = _recurse(plan, rewrite_skew_distinct)
    if not isinstance(plan, LogicalAggregate) or not plan.group_exprs:
        return plan
    dist = [a for a in plan.aggs if a.distinct]
    if not dist:
        return plan
    # all DISTINCT aggs must be COUNT/SUM over one shared argument
    d_arg = dist[0].arg
    if d_arg is None:
        return plan
    for a in dist:
        if a.func not in (AggFunc.COUNT, AggFunc.SUM) or a.arg is None \
                or str(a.arg) != str(d_arg):
            return plan
    plain = [a for a in plan.aggs if not a.distinct]
    if not all(a.func in (AggFunc.COUNT, AggFunc.SUM, AggFunc.MIN,
                          AggFunc.MAX) for a in plain):
        return plan

    child = plan.children[0]
    ng = len(plan.group_exprs)
    # inner: dedup pre-aggregate over (group keys, d)
    inner_groups = list(plan.group_exprs) + [d_arg]
    inner_items = [AggItem(a.func, a.arg, False, a.out_dtype)
                   for a in plain]
    inner_cols = ([SchemaCol(c.name, c.dtype)
                   for c in plan.schema.cols[:ng]]
                  + [SchemaCol("_sdr_d", d_arg.dtype)]
                  + [SchemaCol(f"_sdr_a{i}", a.out_dtype)
                     for i, a in enumerate(plain)])
    inner = LogicalAggregate(child, inner_groups, inner_items,
                             Schema(inner_cols))
    # outer: original keys; DISTINCT aggs read the d key column, plain
    # aggs merge their partials (COUNT merges via SUM)
    outer_groups = [ColumnRef(c.dtype, i, c.name)
                    for i, c in enumerate(inner_cols[:ng])]
    d_ref = ColumnRef(d_arg.dtype, ng, "_sdr_d")
    outer_aggs = []
    pi = 0
    for a in plan.aggs:
        if a.distinct:
            outer_aggs.append(AggItem(a.func, d_ref, False, a.out_dtype))
        else:
            ref = ColumnRef(a.out_dtype, ng + 1 + pi, f"_sdr_a{pi}")
            merge = (AggFunc.SUM if a.func is AggFunc.COUNT else a.func)
            outer_aggs.append(AggItem(merge, ref, False, a.out_dtype))
            pi += 1
    # outer schema must present aggs in the ORIGINAL order
    return LogicalAggregate(inner, outer_groups, outer_aggs,
                            Schema(list(plan.schema.cols)))


__all__ = ["eliminate_max_min", "eliminate_aggregation",
           "rewrite_skew_distinct"]
