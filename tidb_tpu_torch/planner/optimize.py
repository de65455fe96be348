# ported from tidb_tpu/planner/optimize.py @ 9d319cb
"""Logical optimization rules.

Reference analog: the fixed-order rewrite list of
pkg/planner/core/optimizer.go:87 (optRuleList) — the TPU build keeps the
rules that matter for the pushdown architecture:

1. predicate pushdown (PPDSolver analog): selections sink below projections
   and into join sides; equi-conditions become hash-join keys
2. constant folding
3. column pruning (ColumnPruner analog): DataSources scan only needed
   columns — critical on TPU where every column is HBM traffic
"""

from __future__ import annotations

import numpy as np

from ..expr.host_eval import eval_expr
from ..expr.ir import clone_func, ColumnRef, Const, Expr, Func, referenced_columns
from ..types import dtypes as dt
from .build import _split_cnf
from .logical import (DataSource, LogicalAggregate, LogicalJoin, LogicalLimit,
                      LogicalPlan, LogicalProjection, LogicalSelection,
                      LogicalSort, LogicalTopN, Schema, SchemaCol)


# --------------------------------------------------------------------- #
# constant folding
# --------------------------------------------------------------------- #

def _fold_expr(e: Expr) -> Expr:
    if isinstance(e, Func):
        args = tuple(_fold_expr(a) for a in e.args)
        e = clone_func(e, args)
        if args and all(isinstance(a, Const) and not isinstance(a.value, np.ndarray)
                        for a in args) and e.op not in (
                            "dict_lut", "dict_map",
                            # side-effecting/per-row: folding would advance
                            # a sequence (or freeze a per-row value) at
                            # plan time
                            "seq_next", "seq_last", "seq_set"):
            try:
                v, m = eval_expr(np, e, [])
            except Exception:
                return e
            if m is not True and not bool(np.all(m)):
                return Const(dt.null_type(), None)
            val = v.item() if hasattr(v, "item") else v
            if isinstance(val, bool):
                val = int(val)
            return Const(e.dtype, val)
    return e


def _map_exprs(p: LogicalPlan, fn) -> None:
    if isinstance(p, LogicalSelection):
        p.conditions = [fn(c) for c in p.conditions]
    elif isinstance(p, LogicalProjection):
        p.exprs = [fn(e) for e in p.exprs]
    elif isinstance(p, LogicalAggregate):
        p.group_exprs = [fn(g) for g in p.group_exprs]
        for a in p.aggs:
            if a.arg is not None:
                a.arg = fn(a.arg)
    elif isinstance(p, LogicalJoin):
        p.other_conds = [fn(c) for c in p.other_conds]
    elif isinstance(p, (LogicalSort, LogicalTopN)):
        p.keys = [(fn(e), d) for e, d in p.keys]


def fold_constants(p: LogicalPlan) -> LogicalPlan:
    for c in p.children:
        fold_constants(c)
    fn = lambda e: _extract_or_common(_fold_expr(e))
    _map_exprs(p, fn)
    # factor extraction can surface new conjuncts: re-split CNF lists
    if isinstance(p, LogicalSelection):
        p.conditions = [c2 for c in p.conditions for c2 in _split_cnf(c)]
    elif isinstance(p, LogicalJoin):
        p.other_conds = [c2 for c in p.other_conds for c2 in _split_cnf(c)]
    return p


def _extract_or_common(e: Expr) -> Expr:
    """(A AND B) OR (A AND C) -> A AND (B OR C) — extractCommonFactors
    analog (expression/util.go); distributivity holds in Kleene 3VL.
    Without this, Q19-style DNF predicates hide their equi-join keys from
    predicate pushdown."""
    if not (isinstance(e, Func) and e.op == "or"):
        if isinstance(e, Func):
            return clone_func(e,
                        tuple(_extract_or_common(a) for a in e.args))
        return e
    branches = _split_dnf(e)
    conj = [_split_cnf(b) for b in branches]
    common = [c for c in conj[0] if all(c in cs for cs in conj[1:])]
    if not common:
        return e
    residuals = []
    for cs in conj:
        rest = [c for c in cs if c not in common]
        if not rest:
            return _and_all(common)   # one branch fully covered => OR true
        residuals.append(_and_all(rest))
    out = residuals[0]
    from ..expr import builders as B
    for r in residuals[1:]:
        out = B.logic("or", out, r)
    return _and_all(common + [out])


def _split_dnf(e: Expr) -> list[Expr]:
    if isinstance(e, Func) and e.op == "or":
        return _split_dnf(e.args[0]) + _split_dnf(e.args[1])
    return [e]


def _and_all(conds: list[Expr]) -> Expr:
    from ..expr import builders as B
    out = conds[0]
    for c in conds[1:]:
        out = B.logic("and", out, c)
    return out


# --------------------------------------------------------------------- #
# predicate pushdown
# --------------------------------------------------------------------- #

def _subst(e: Expr, exprs: list[Expr]) -> Expr:
    """Replace ColumnRef i with exprs[i] (pushing through a projection)."""
    if isinstance(e, ColumnRef):
        return exprs[e.index]
    if isinstance(e, Func):
        return clone_func(e, (_subst(a, exprs) for a in e.args))
    return e


def _remap(e: Expr, offset: int) -> Expr:
    if isinstance(e, ColumnRef):
        return ColumnRef(e.dtype, e.index + offset, e.name)
    if isinstance(e, Func):
        return clone_func(e, (_remap(a, offset) for a in e.args))
    return e


def push_predicates(p: LogicalPlan, pending: list[Expr] | None = None) -> LogicalPlan:
    """Sink `pending` conditions (over p's schema) as deep as possible."""
    pending = pending or []

    if isinstance(p, LogicalSelection):
        return push_predicates(p.child, pending + list(p.conditions))

    if isinstance(p, LogicalProjection):
        pushable, stay = [], []
        for c in pending:
            # only push through simple column/deterministic exprs
            try:
                pushable.append(_subst(c, p.exprs))
            except IndexError:
                stay.append(c)
        p.child = push_predicates(p.child, pushable)
        p.children = [p.child]
        return _wrap(p, stay)

    if isinstance(p, LogicalJoin):
        n_left = len(p.left.schema)
        if p.kind in ("semi", "anti"):
            # join schema == left schema: pending conds push into the left
            # child.  Right-only residuals sink into the right child (they
            # only restrict the match set — safe for both semi and anti);
            # left-referencing residuals must stay as match conditions
            # (pushing them would wrongly drop/keep anti rows).
            own_keys, own_res, right_conds = [], [], []
            for c in p.other_conds:
                k = _as_eq_key(c, n_left)
                if k is not None:
                    own_keys.append(k)
                    continue
                refs = referenced_columns(c)
                if refs and min(refs) >= n_left:
                    right_conds.append(_remap(c, -n_left))
                else:
                    own_res.append(c)
            p.eq_keys = p.eq_keys + own_keys
            p.other_conds = own_res
            p.left = push_predicates(p.left, pending)
            p.right = push_predicates(p.right, right_conds)
            p.children = [p.left, p.right]
            return p
        if p.kind in ("inner", "cross"):
            left_conds, right_conds, eq_keys, residue = [], [], [], []
            for c in pending + p.other_conds:
                refs = referenced_columns(c)
                if refs and max(refs) < n_left:
                    left_conds.append(c)
                elif refs and min(refs) >= n_left:
                    right_conds.append(c)
                else:
                    k = _as_eq_key(c, n_left)
                    if k is not None:
                        eq_keys.append(k)
                    else:
                        residue.append(c)
            p.other_conds = residue
            p.eq_keys = p.eq_keys + eq_keys
            if p.eq_keys and p.kind == "cross":
                p.kind = "inner"
            p.left = push_predicates(p.left, left_conds)
            p.right = push_predicates(p.right,
                                      [_remap(c, -n_left) for c in right_conds])
            p.children = [p.left, p.right]
            return p
        # outer joins: extract equi keys from the ON conds, push nothing
        # through (null-extension changes filter semantics); pending stays
        # above as a post-join filter
        own_keys, own_res = [], []
        for c in p.other_conds:
            k = _as_eq_key(c, n_left)
            (own_keys.append(k) if k is not None else own_res.append(c))
        p.eq_keys = p.eq_keys + own_keys
        p.other_conds = own_res
        p.left = push_predicates(p.left)
        p.right = push_predicates(p.right)
        p.children = [p.left, p.right]
        return _wrap(p, pending)

    from .logical import LogicalApply
    if isinstance(p, LogicalApply):
        # Apply appends subquery columns AFTER the child's schema:
        # conditions that only touch child columns sink below (they don't
        # observe apply outputs), the rest stay above.  Without this, a
        # WHERE mixing one correlated predicate with ordinary join
        # predicates left the Apply sitting on the raw cross join
        # (rule_decorrelate + PPD ordering in the reference).
        n_child = len(p.child.schema)
        sink, stay = [], []
        for c in pending:
            refs = referenced_columns(c)
            (sink.append(c) if not refs or max(refs) < n_child
             else stay.append(c))
        p.child = push_predicates(p.child, sink)
        p.children = [p.child]
        return _wrap(p, stay)

    if isinstance(p, (LogicalSort, LogicalLimit, LogicalTopN, LogicalAggregate)):
        if isinstance(p, LogicalAggregate):
            # conditions over group cols could sink; keep above for now
            p.child = push_predicates(p.child)
            p.children = [p.child]
            return _wrap(p, pending)
        child = p.children[0]
        if isinstance(p, (LogicalLimit,)):
            # pushing filters below LIMIT changes semantics; keep above
            p.child = push_predicates(child)
            p.children = [p.child]
            return _wrap(p, pending)
        p.child = push_predicates(child, pending)
        p.children = [p.child]
        return p

    # leaves (DataSource, DualSource, subquery roots) and barrier nodes
    # (LogicalExpand): keep .child in sync with children[] so later passes
    # reading either see the same tree
    for i, c in enumerate(p.children):
        p.children[i] = push_predicates(c)
        if getattr(p, "child", None) is c:
            p.child = p.children[i]
    return _wrap(p, pending)


def _wrap(p: LogicalPlan, conds: list[Expr]) -> LogicalPlan:
    conds = [c for c in conds if not _is_true_const(c)]
    if not conds:
        return p
    return LogicalSelection(p, conds)


def _is_true_const(e: Expr) -> bool:
    return isinstance(e, Const) and e.value is not None \
        and not isinstance(e.value, np.ndarray) and bool(e.value)


def _as_eq_key(e: Expr, n_left: int):
    if (isinstance(e, Func) and e.op == "eq"
            and isinstance(e.args[0], ColumnRef)
            and isinstance(e.args[1], ColumnRef)):
        a, b = e.args[0].index, e.args[1].index
        if a < n_left <= b:
            return (a, b - n_left)
        if b < n_left <= a:
            return (b, a - n_left)
    return None


# --------------------------------------------------------------------- #
# column pruning
# --------------------------------------------------------------------- #

def prune_columns(p: LogicalPlan, needed: set[int] | None = None) -> LogicalPlan:
    """Rewrite DataSources to scan only referenced columns; remap refs."""
    if needed is None:
        needed = set(range(len(p.schema)))

    if isinstance(p, DataSource):
        keep = sorted(needed) or [0]   # keep at least one col for row counts
        mapping = {old: new for new, old in enumerate(keep)}
        p.col_offsets = [p.col_offsets[i] for i in keep]
        p.schema = Schema([p.schema.cols[i] for i in keep])
        return p, mapping

    if isinstance(p, LogicalProjection):
        # keep at least one expr: a zero-column chunk loses its row count
        # (EXISTS subqueries project constants nobody references)
        keep = sorted(needed) or [0]
        p.exprs = [p.exprs[i] for i in keep]
        p.schema = Schema([p.schema.cols[i] for i in keep])
        child_needed = set()
        for e in p.exprs:
            child_needed |= referenced_columns(e)
        _, cmap = _prune_child(p, 0, child_needed)
        p.exprs = [map_refs(e, cmap) for e in p.exprs]
        return p, {old: new for new, old in enumerate(keep)}

    if isinstance(p, LogicalSelection):
        child_needed = set(needed)
        for c in p.conditions:
            child_needed |= referenced_columns(c)
        _, cmap = _prune_child(p, 0, child_needed)
        p.conditions = [map_refs(c, cmap) for c in p.conditions]
        p.schema = p.child.schema
        return p, {old: cmap[old] for old in needed}

    if isinstance(p, LogicalAggregate):
        # aggregate output schema is compact already (groups + aggs)
        child_needed = set()
        for g in p.group_exprs:
            child_needed |= referenced_columns(g)
        for a in p.aggs:
            if a.arg is not None:
                child_needed |= referenced_columns(a.arg)
        _, cmap = _prune_child(p, 0, child_needed)
        p.group_exprs = [map_refs(g, cmap) for g in p.group_exprs]
        for a in p.aggs:
            if a.arg is not None:
                a.arg = map_refs(a.arg, cmap)
        return p, {i: i for i in needed}

    if isinstance(p, LogicalJoin):
        n_left = len(p.left.schema)
        child_needed = set(needed)
        for c in p.other_conds:
            child_needed |= referenced_columns(c)
        for l, r in p.eq_keys:
            child_needed.add(l)
            child_needed.add(r + n_left)
        lneed = {i for i in child_needed if i < n_left}
        rneed = {i - n_left for i in child_needed if i >= n_left}
        p.left, lmap = prune_columns(p.left, lneed)
        p.right, rmap = prune_columns(p.right, rneed)
        p.children = [p.left, p.right]
        new_n_left = len(p.left.schema)
        full = {}
        for old in sorted(child_needed):
            if old < n_left:
                full[old] = lmap[old]
            else:
                full[old] = rmap[old - n_left] + new_n_left
        p.eq_keys = [(lmap[l], rmap[r]) for l, r in p.eq_keys]
        p.other_conds = [map_refs(c, full) for c in p.other_conds]
        if p.kind in ("semi", "anti"):
            p.schema = Schema(list(p.left.schema.cols))
        else:
            p.schema = Schema(list(p.left.schema.cols)
                              + list(p.right.schema.cols))
        return p, {old: full[old] for old in needed}

    if isinstance(p, (LogicalSort, LogicalTopN)):
        child_needed = set(needed)
        for e, _ in p.keys:
            child_needed |= referenced_columns(e)
        _, cmap = _prune_child(p, 0, child_needed)
        p.keys = [(map_refs(e, cmap), d) for e, d in p.keys]
        p.schema = p.child.schema
        return p, {old: cmap[old] for old in needed}

    if isinstance(p, LogicalLimit):
        _, cmap = _prune_child(p, 0, set(needed))
        p.schema = p.child.schema
        return p, {old: cmap[old] for old in needed}

    from .logical import LogicalExpand
    if isinstance(p, LogicalExpand):
        # appended key/gid columns stay; prune only the passthrough child
        # columns (plus whatever the rollup keys reference)
        n_child = len(p.child.schema)
        child_needed = {i for i in needed if i < n_child}
        for k in p.keys:
            child_needed |= referenced_columns(k)
        _, cmap = _prune_child(p, 0, child_needed)
        p.keys = [map_refs(k, cmap) for k in p.keys]
        new_n_child = len(p.child.schema)
        tail = p.schema.cols[n_child:]       # key cols + gid
        p.schema = Schema(list(p.child.schema.cols) + list(tail))
        full = {}
        for old in needed:
            full[old] = cmap[old] if old < n_child \
                else new_n_child + (old - n_child)
        return p, full

    # DualSource etc.
    return p, {i: i for i in needed}


def _prune_child(p, i, needed):
    child, cmap = prune_columns(p.children[i], needed)
    p.children[i] = child
    if hasattr(p, "child"):
        p.child = child
    return child, cmap


def map_refs(e: Expr, mapping: dict[int, int]) -> Expr:
    if isinstance(e, ColumnRef):
        return ColumnRef(e.dtype, mapping[e.index], e.name)
    if isinstance(e, Func):
        return clone_func(e, (map_refs(a, mapping) for a in e.args))
    return e


def optimize_plan(plan: LogicalPlan) -> LogicalPlan:
    plan = fold_constants(plan)
    plan = push_predicates(plan)
    plan, _ = prune_columns(plan)
    from .rules import eliminate_aggregation, eliminate_max_min
    plan = eliminate_aggregation(plan)
    plan = eliminate_max_min(plan)
    return plan


__all__ = ["optimize_plan", "fold_constants", "push_predicates",
           "prune_columns", "map_refs"]
