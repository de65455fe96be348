# ported from tidb_tpu/planner/cascades/search.py @ 1da0078
"""Memo exploration + property-driven implementation + extraction.

Reference analog: pkg/planner/cascades/cascades.go (the two-phase
explore/implement loop) and core/find_best_task.go (required physical
property = sort order; enforcers).  Properties here are orderings —
tuples of (column index into the group schema, desc) — the same prop the
reference threads as property.PhysicalProperty.SortItems.

Transformation rules (explore):
  * DP join-order enumeration over every maximal inner-join group
    (DPsub over connected subsets, rule_join_reorder.go's DP variant);
    oversized groups keep the greedy order from join_reorder.py.
  * TopN pushdown through the outer side of LEFT/RIGHT joins
    (rule_topn_push_down.go).

Implementation rules (per group expression):
  * Join: hash/broadcast default, sort-merge (provides left-key order —
    HostMergeJoin's documented contract), index-lookup (INL) when the
    inner side is an indexed Selection chain.
  * Sort: materialize, or vanish when a child impl provides the order.
  * TopN: heap, or degenerate to Limit over an order-providing child.
  * Everything else: passthrough (order-preserving ops forward the
    required prop to their child; barriers reset it to empty).

The winning tree extracts back to logical operators: join methods become
`hint_method` annotations (which `executor/plan.py` honors and which
disable device fusion for that join, keeping the order contract sound),
satisfied Sorts disappear, ordered TopN becomes Limit.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

from ...expr.ir import ColumnRef, Func, referenced_columns
from ..join_reorder import (_as_local_eq, _col_ndv, _flatten, _leaf_rows,
                            _refs_leaves, _reorder_group)
from ..logical import (DataSource, LogicalAggregate, LogicalExpand,
                       LogicalJoin, LogicalLimit, LogicalPlan,
                       LogicalProjection, LogicalSelection, LogicalSetOp,
                       LogicalSort, LogicalTopN, LogicalWindow, Schema)
from ..optimize import map_refs
from . import cost as C
from .memo import Memo, estimate_rows

DP_MAX_LEAVES = 8       # DPsub beyond this is 3^n; fall back to greedy


# ------------------------------------------------------------------ #
# entry point

def search(plan: LogicalPlan, stats_handle) -> LogicalPlan:
    memo = Memo()
    node_gid: dict = {}
    root = _insert(memo, plan, stats_handle, node_gid)
    _explore_joins(memo, plan, stats_handle, node_gid)
    _explore_topn(memo, stats_handle)
    s = _Search(memo, stats_handle)
    s.best(root, ())
    return s.extract(root, ())


def _insert(memo: Memo, plan: LogicalPlan, stats_handle,
            node_gid: dict) -> int:
    child_ids = tuple(_insert(memo, c, stats_handle, node_gid)
                      for c in getattr(plan, "children", [])
                      if c is not None)
    rows = estimate_rows(plan, [memo.group(i).rows for i in child_ids],
                         stats_handle)
    gid = memo.insert_expr(plan, child_ids, None, rows)
    node_gid[id(plan)] = gid
    return gid


# ------------------------------------------------------------------ #
# exploration: DP join order

def _explore_joins(memo, plan, stats_handle, node_gid,
                   parent_inner=False) -> None:
    is_inner = isinstance(plan, LogicalJoin) and plan.kind in ("inner",
                                                               "cross")
    if is_inner and not parent_inner:
        alt = _dp_join_alternative(plan, stats_handle)
        if alt is not None and id(plan) in node_gid:
            memo.insert_tree(alt, stats_handle,
                             into=memo.group(node_gid[id(plan)]))
    for c in getattr(plan, "children", []):
        if c is not None:
            _explore_joins(memo, c, stats_handle, node_gid, is_inner)


def _dp_join_alternative(root: LogicalJoin, stats_handle):
    if getattr(root, "hint_leading", None) or getattr(root, "hint_method",
                                                     ""):
        # user hints pin the order/method: the greedy rebuild honors
        # LEADING and preserves leaf markers; DP would discard them
        return _reorder_group(copy.copy(root), stats_handle)
    leaves_off: list = []
    conds: list = []
    total_cols = _flatten(root, leaves_off, conds, 0)
    leaves = [l for _, l in leaves_off]
    spans = [(off, off + len(l.schema)) for off, l in leaves_off]
    n = len(leaves)
    if n < 2:
        return None
    if n > DP_MAX_LEAVES:
        # greedy fallback produces one alternative tree (shares leaves)
        return _reorder_group(copy.copy(root), stats_handle)
    rows = [_leaf_rows(l, stats_handle) for l in leaves]
    cond_sets = [_refs_leaves(c, spans) for c in conds]

    def _eq_ndv(j: int) -> Optional[float]:
        c = conds[j]
        if not (isinstance(c, Func) and c.op == "eq"
                and len(cond_sets[j]) == 2):
            return None
        best = 1.0
        for r in referenced_columns(c):
            for i, (lo, hi) in enumerate(spans):
                if lo <= r < hi:
                    best = max(best, _col_ndv(leaves[i], r - lo,
                                              stats_handle, rows[i]))
        return best

    ndvs = [_eq_ndv(j) for j in range(len(conds))]
    eq_sel = [1.0 / max(v, 1.0) if v is not None else None for v in ndvs]

    full = (1 << n) - 1
    r_cache: dict = {}

    def R(S: int) -> float:
        got = r_cache.get(S)
        if got is not None:
            return got
        v = 1.0
        for i in range(n):
            if S >> i & 1:
                v *= rows[i]
        for j, ls in enumerate(cond_sets):
            if eq_sel[j] is not None and all(S >> i & 1 for i in ls):
                v *= eq_sel[j]
        v = max(v, 1.0)
        r_cache[S] = v
        return v

    def _connected(S1: int, S2: int) -> bool:
        for j, ls in enumerate(cond_sets):
            if len(ls) < 2:
                continue
            m = 0
            for i in ls:
                m |= 1 << i
            if m & S1 and m & S2 and not m & ~(S1 | S2):
                return True
        return False

    # DPsub: dp[S] = (cost, winning split S1)
    dp: dict = {1 << i: (0.0, 0) for i in range(n)}
    for S in range(1, full + 1):
        if S in dp or bin(S).count("1") < 2:
            continue
        low = S & -S
        best_c, best_s1 = None, None
        S1 = (S - 1) & S
        while S1:
            S2 = S ^ S1
            if S1 & low and S1 in dp and S2 in dp:
                # build() probes with the bigger side; cost the same
                # orientation the rebuild will actually emit
                join_c = min(C.hash_join_cost(R(S1), R(S2), R(S)),
                             C.hash_join_cost(R(S2), R(S1), R(S)))
                if not _connected(S1, S2):
                    join_c *= 4.0        # cartesian discouragement
                c = dp[S1][0] + dp[S2][0] + join_c
                if best_c is None or c < best_c:
                    best_c, best_s1 = c, S1
            S1 = (S1 - 1) & S
        dp[S] = (best_c, best_s1)

    used = [False] * len(conds)

    def build(S: int):
        if bin(S).count("1") == 1:
            i = S.bit_length() - 1
            return leaves[i], list(range(*spans[i]))
        S1 = dp[S][1]
        S2 = S ^ S1
        if R(S2) > R(S1):          # bigger side probes (left)
            S1, S2 = S2, S1
        left, lorig = build(S1)
        right, rorig = build(S2)
        origin = lorig + rorig
        remap = {orig: newi for newi, orig in enumerate(origin)}
        here = set(i for i in range(n) if S >> i & 1)
        eq_keys, others = [], []
        for j, (c, ls) in enumerate(zip(conds, cond_sets)):
            if used[j] or not ls <= here:
                continue
            used[j] = True
            c2 = map_refs(c, remap)
            k = _as_local_eq(c2, len(left.schema), len(right.schema))
            if k is not None:
                eq_keys.append(k)
            else:
                others.append(c2)
        node = LogicalJoin(
            "inner" if (eq_keys or others) else "cross", left, right,
            eq_keys=eq_keys, other_conds=others,
            schema=Schema(list(left.schema.cols) + list(right.schema.cols)))
        return node, origin

    tree, origin = build(full)
    rest_map = {orig: newi for newi, orig in enumerate(origin)}
    unplaced = [map_refs(c, rest_map)
                for j, c in enumerate(conds) if not used[j]]
    if unplaced:
        tree = LogicalSelection(tree, unplaced)
    if origin == list(range(total_cols)):
        return tree
    refs = [tree.schema.ref(rest_map[r]) for r in range(total_cols)]
    return LogicalProjection(tree, refs, Schema(list(root.schema.cols)))


# ------------------------------------------------------------------ #
# exploration: TopN through outer join (rule_topn_push_down.go)

def _explore_topn(memo: Memo, stats_handle) -> None:
    for g in list(memo.groups):
        for expr in list(g.exprs):
            n = expr.node
            if not isinstance(n, LogicalTopN) or not expr.child_ids \
                    or not n.keys:
                continue
            # see through a Projection chain, remapping the sort keys
            keys = list(n.keys)
            cur = memo.group(expr.child_ids[0])
            projs: list = []
            ok = True
            while ok and cur.exprs:
                e0 = cur.exprs[0]
                if not isinstance(e0.node, LogicalProjection) \
                        or not e0.child_ids:
                    break
                mapped = []
                for k, d in keys:
                    src = (e0.node.exprs[k.index]
                           if isinstance(k, ColumnRef)
                           and k.index < len(e0.node.exprs) else None)
                    if not isinstance(src, ColumnRef):
                        ok = False
                        break
                    mapped.append((ColumnRef(src.dtype, src.index,
                                             src.name), d))
                if ok:
                    keys = mapped
                    projs.append(e0)
                    cur = memo.group(e0.child_ids[0])
            if not ok:
                continue
            for jexpr in list(cur.exprs):
                j = jexpr.node
                if not isinstance(j, LogicalJoin) or j.kind not in (
                        "left", "right") or len(jexpr.child_ids) != 2:
                    continue
                _push_topn_through(memo, g, n, keys, projs, cur, jexpr)


def _push_topn_through(memo, topn_group, topn, keys, projs, join_group,
                       jexpr) -> None:
    j = jexpr.node
    lg, rg = (memo.group(i) for i in jexpr.child_ids)
    n_left = len(lg.schema)
    outer = 0 if j.kind == "left" else 1
    lo = 0 if outer == 0 else n_left
    hi = n_left if outer == 0 else n_left + len(rg.schema)
    side_keys = []
    for e, desc in keys:
        if not isinstance(e, ColumnRef) or not lo <= e.index < hi:
            return
        side_keys.append((ColumnRef(e.dtype, e.index - lo, e.name), desc))
    side_g = lg if outer == 0 else rg
    side_node = side_g.exprs[0].node
    inner_topn = LogicalTopN(side_node, side_keys,
                             topn.limit + topn.offset, 0)
    gid = memo.insert_expr(
        inner_topn, (side_g.gid,),
        None, min(side_g.rows, float(topn.limit + topn.offset)))
    j2 = copy.copy(j)
    child_ids = ((gid, rg.gid) if outer == 0 else (lg.gid, gid))
    # the outer side shrank to ≤ limit+offset rows; scale the join (and
    # the projections above, which preserve row count) accordingly
    frac = min(1.0, float(topn.limit + topn.offset)
               / max(side_g.rows, 1.0))
    new_rows = max(join_group.rows * frac, 1.0)
    gid = memo.insert_expr(j2, child_ids, None, new_rows)
    for pexpr in reversed(projs):
        gid = memo.insert_expr(copy.copy(pexpr.node), (gid,), None,
                               new_rows)
    memo.insert_expr(copy.copy(topn), (gid,), topn_group,
                     topn_group.rows)


# ------------------------------------------------------------------ #
# implementation

@dataclass
class Winner:
    cost: float
    expr: object = None            # GroupExpr; None => group-level enforcer
    child_props: tuple = ()
    provides: tuple = ()
    method: str = ""               # join: '' | 'merge' | 'inl'
    transform: str = ""            # '' | 'drop_sort' | 'topn_limit'
    enforce: tuple = ()            # wrap a Sort with this prop on top
    skip_cost: tuple = ()          # child slots costed out-of-band (INL)


def _satisfies(provides: tuple, prop: tuple) -> bool:
    return len(provides) >= len(prop) and provides[:len(prop)] == prop


def _prop_of_keys(keys, width: int) -> Optional[tuple]:
    out = []
    for e, desc in keys:
        if not isinstance(e, ColumnRef) or e.index >= width:
            return None
        out.append((e.index, bool(desc)))
    return tuple(out)


class _Search:
    def __init__(self, memo: Memo, stats_handle):
        self.memo = memo
        self.stats = stats_handle

    def best(self, gid: int, prop: tuple) -> Winner:
        g = self.memo.group(gid)
        got = g.best.get(prop)
        if got is not None:
            return got
        cands: list[Winner] = []
        for expr in g.exprs:
            cands.extend(self._alternatives(g, expr, prop))
        if prop:
            base = self.best(gid, ())
            cands.append(Winner(base.cost + C.sort_cost(g.rows),
                                enforce=prop, provides=prop))
        if not cands:
            raise RuntimeError(f"no implementation for group {gid}")
        w = min(cands, key=lambda c: c.cost)
        g.best[prop] = w
        return w

    # ------------------------------------------------------------- #

    def _child_total(self, expr, child_props, skip=()) -> float:
        return sum(self.best(cid, cp).cost
                   for i, (cid, cp) in enumerate(zip(expr.child_ids,
                                                     child_props))
                   if i not in skip)

    def _alternatives(self, g, expr, prop) -> list:
        n = expr.node
        memo = self.memo
        ch_rows = [memo.group(c).rows for c in expr.child_ids]
        out = []

        def add(local, child_props, provides, **kw):
            if not _satisfies(provides, prop):
                return
            total = local + self._child_total(expr, child_props,
                                              kw.get("skip_cost", ()))
            out.append(Winner(total, expr, tuple(child_props),
                              tuple(provides), **kw))

        if isinstance(n, LogicalJoin):
            self._join_alts(g, expr, prop, ch_rows, add)
        elif isinstance(n, LogicalSort):
            kp = _prop_of_keys(n.keys, len(g.schema))
            provides = kp or ()
            add(C.sort_cost(ch_rows[0]), ((),), provides)
            if kp is not None:
                add(0.0, (kp,), kp, transform="drop_sort")
        elif isinstance(n, LogicalTopN):
            k = float(n.limit + n.offset)
            kp = _prop_of_keys(n.keys, len(g.schema))
            add(C.topn_cost(ch_rows[0], k), ((),), kp or ())
            if kp is not None:
                add(k * 0.2, (kp,), kp, transform="topn_limit")
        elif isinstance(n, LogicalLimit):
            add(float(n.limit + n.offset) * 0.1, (prop,), prop)
        elif isinstance(n, LogicalSelection):
            add(ch_rows[0] * 0.2 * max(len(n.conditions), 1), (prop,), prop)
        elif isinstance(n, LogicalProjection):
            mapped = self._remap_prop_through_proj(n, prop)
            if mapped is not None:
                add(ch_rows[0] * 0.3, (mapped,), prop)
            else:
                add(ch_rows[0] * 0.3, ((),), ())
        elif isinstance(n, LogicalAggregate):
            add(C.agg_cost(ch_rows[0] if ch_rows else 1.0, g.rows),
                tuple(() for _ in expr.child_ids), ())
        elif isinstance(n, DataSource):
            from ...executor.plan import _scan_device_ok
            dev = (not getattr(n.table, "is_memtable", False)
                   and _scan_device_ok(n))
            add(C.scan_cost(g.rows, dev), (), ())
        else:
            # barriers: Window/SetOp/Expand/Apply/CTE/index nodes
            add(g.rows * C.HOST_ROW,
                tuple(() for _ in expr.child_ids), ())
        return out

    def _remap_prop_through_proj(self, n: LogicalProjection,
                                 prop: tuple) -> Optional[tuple]:
        out = []
        for i, desc in prop:
            if i >= len(n.exprs) or not isinstance(n.exprs[i], ColumnRef):
                return None
            out.append((n.exprs[i].index, desc))
        return tuple(out)

    # ------------------------------------------------------------- #

    def _join_alts(self, g, expr, prop, ch_rows, add) -> None:
        n: LogicalJoin = expr.node
        l_rows = ch_rows[0] if ch_rows else 1.0
        r_rows = ch_rows[1] if len(ch_rows) > 1 else 1.0
        nochild = tuple(() for _ in expr.child_ids)
        from ...executor.plan import _join_method_hint
        if _join_method_hint(n):
            # a user hint (node-level or a leaf USE-style marker) pins the
            # method: cost as the default and leave method empty so the
            # extracted copy never stamps over the hint at lowering
            add(C.hash_join_cost(l_rows, r_rows, g.rows), nochild, ())
            return
        # default: host hash / device broadcast (lowering decides)
        add(C.hash_join_cost(l_rows, r_rows, g.rows), nochild, ())
        # sort-merge: provides left-eq-key ascending prefix over numeric
        # keys (HostMergeJoin's key-ordered-output contract).  Order is
        # promised only for INNER joins: an outer join's unmatched NULL
        # keys sort by their encoding, which need not match SQL
        # NULLS-FIRST; string keys order by dictionary rank — excluded
        # to keep the contract exact.
        if (n.eq_keys and not n.null_aware and n.kind in ("inner", "left")
                and len(expr.child_ids) == 2):
            provides = []
            if n.kind == "inner":
                lsch = self.memo.group(expr.child_ids[0]).schema
                for li, _ri in n.eq_keys:
                    if li < len(lsch) \
                            and not lsch.cols[li].dtype.is_string:
                        provides.append((li, False))
                    else:
                        break
            add(C.merge_join_cost(l_rows, r_rows, g.rows), nochild,
                tuple(provides), method="merge")
        # index-lookup (INL): inner side must be a Selection chain over an
        # indexed DataSource; inner scan cost replaced by per-probe lookups
        inner = self._inl_inner(expr, n)
        if inner is not None:
            inner_rows = float(getattr(inner.table, "num_rows", 0) or 1)
            add(C.inl_join_cost(l_rows, inner_rows, g.rows), nochild, (),
                method="inl", skip_cost=(1,))

    def _inl_inner(self, expr, n: LogicalJoin):
        """Mirror executor/plan.py _try_inl_join's structural checks for
        the (outer=left, inner=right) orientation the bare hint takes."""
        from ...utils.collate import is_binary
        if n.kind not in ("inner", "left", "semi", "anti") \
                or len(n.eq_keys) != 1 \
                or (n.kind == "anti" and n.null_aware) \
                or len(expr.child_ids) != 2:
            return None
        li, ri = n.eq_keys[0]
        gid = expr.child_ids[1]
        while True:
            ge = self.memo.group(gid).exprs[0]
            node = ge.node
            if isinstance(node, LogicalSelection):
                gid = ge.child_ids[0]
                continue
            break
        if not isinstance(node, DataSource) \
                or getattr(node.table, "kv", None) is None \
                or getattr(node.table, "is_memtable", False):
            return None
        lsch = self.memo.group(expr.child_ids[0]).schema
        rsch = self.memo.group(expr.child_ids[1]).schema
        if li >= len(lsch) or ri >= len(rsch):
            return None
        ot, it = lsch.cols[li].dtype, rsch.cols[ri].dtype
        if ot.kind != it.kind or ot.scale != it.scale:
            return None
        if it.is_string and not is_binary(it.collation):
            return None
        key_name = rsch.cols[ri].name.lower()
        ix = next((x for x in getattr(node.table, "indexes", [])
                   if x.state == "public"
                   and x.columns[0].lower() == key_name), None)
        return node if ix is not None else None

    # ------------------------------------------------------------- #
    # extraction

    def extract(self, gid: int, prop: tuple) -> LogicalPlan:
        g = self.memo.group(gid)
        w = g.best[prop]
        if w.expr is None:                      # group-level sort enforcer
            child = self.extract(gid, ())
            keys = [(child.schema.ref(i), desc) for i, desc in w.enforce]
            return LogicalSort(child, keys)
        children = [self.extract(cid, cp)
                    for cid, cp in zip(w.expr.child_ids, w.child_props)]
        n = w.expr.node
        if w.transform == "drop_sort":
            return children[0]
        if w.transform == "topn_limit":
            return LogicalLimit(children[0], n.limit, n.offset)
        node = copy.copy(n)
        node.children = children
        if hasattr(node, "child"):
            node.child = children[0] if children else None
        if isinstance(node, LogicalJoin):
            node.left, node.right = children
            if w.method:
                node.hint_method = w.method
        if isinstance(node, LogicalSetOp):
            node.left, node.right = children
        if isinstance(node, LogicalSelection) and children:
            # Selection shares its child's schema object
            node.schema = children[0].schema
        return node


__all__ = ["search", "Winner"]
