# ported from tidb_tpu/planner/ranger.py @ 9d319cb
"""Predicate -> index range extraction + index-path plan rewrite.

Reference analog: pkg/util/ranger (predicates on index prefixes ->
[start,end) key ranges) and the point-get fast path
(executor/point_get.go, adapter.go:339).  Round-1 scope: equality-prefix
access — an index is usable when the WHERE conjuncts pin a prefix of its
columns with constants; a full pin of a unique index becomes a PointGet,
any other prefix becomes an IndexLookUp range scan.  Inequality ranges on
the first unpinned column extend the scan bounds.  Everything else stays
on the columnar TPU scan path (which is the right default for analytic
predicates — the index path exists for OLTP-selective queries).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..expr.ir import ColumnRef, Const, Expr, Func
from ..types import dtypes as dt
from .. import STATS, unported
from .logical import (DataSource, LogicalPlan, LogicalSelection, Schema,
                      SchemaCol)

K = dt.TypeKind

_CMP_OPS = {"eq", "lt", "le", "gt", "ge"}


@dataclass
class IndexAccess:
    """A chosen index access path."""
    index: object                       # catalog.IndexInfo
    eq_values: list = field(default_factory=list)   # python values, prefix
    # optional range on the first unpinned column: (low, low_incl, high,
    # high_incl) — None bound = unbounded
    range_col: Optional[str] = None
    low: object = None
    low_incl: bool = True
    high: object = None
    high_incl: bool = True
    residual: list = field(default_factory=list)    # unconsumed conditions
    is_point: bool = False              # full unique prefix => <=1 row


def _const_for(col_type: dt.DataType, c: Const):
    """Const IR value -> python value encodable for this column, or None
    if the types don't line up (None = index unusable for this conjunct,
    always safe).  Must mirror the scan path's const coercions
    (expr/compile.py) or the index would return different rows — decimal
    consts carry SCALED ints at the const's own scale, so every cross-type
    pairing rescales explicitly."""
    from ..types import decimal as dec
    if col_type.is_string:
        from ..utils.collate import is_binary
        if not is_binary(col_type.collation):
            # ci collation: index keys are binary-exact bytes, a binary
            # point/range scan would miss case variants — keep the
            # predicate as a residual filter instead
            return None
    v = c.value
    if v is None:
        return None
    k = col_type.kind
    ck = c.dtype.kind
    if ck == K.DECIMAL and isinstance(v, int):
        # v is scaled by 10^c.dtype.scale
        fs = c.dtype.scale
        if k == K.DECIMAL:
            ts = col_type.scale
            if ts >= fs:
                return v * dec.pow10(ts - fs)
            div = dec.pow10(fs - ts)
            return v // div if v % div == 0 else None
        if k in (K.INT64, K.UINT64):
            div = dec.pow10(fs)
            return v // div if v % div == 0 else None
        if k == K.FLOAT64:
            return v / dec.pow10(fs)
        return None
    if k in (K.INT64, K.UINT64):
        if isinstance(v, (int, bool)):
            return int(v)
        if isinstance(v, float):
            return int(v) if v == int(v) else None
        return None
    if k == K.FLOAT64:
        return float(v) if isinstance(v, (int, float)) else None
    if k == K.FLOAT32:
        return None       # float32 storage rounding vs f64 consts: unsafe
    if k == K.DECIMAL:
        if isinstance(v, int):      # integer literal
            return v * dec.pow10(col_type.scale)
        return None
    if k in (K.DATE, K.DATETIME):
        return int(v) if ck == k and isinstance(v, int) else None
    if k == K.STRING:
        return str(v) if isinstance(v, str) else None
    return None


def _cmp_parts(cond: Expr):
    """cond as (op, col_index, const) with the column on the left, or
    None."""
    if not (isinstance(cond, Func) and cond.op in _CMP_OPS):
        return None
    a, b = cond.args
    flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}
    if isinstance(a, ColumnRef) and isinstance(b, Const):
        return cond.op, a.index, b
    if isinstance(b, ColumnRef) and isinstance(a, Const):
        return flip[cond.op], b.index, a
    return None


def match_index(conditions: list[Expr], ds: DataSource,
                index) -> Optional[IndexAccess]:
    """Try to serve `conditions` (CNF over ds.schema) with `index`."""
    tbl = ds.table
    name_of = {i: c.name.lower() for i, c in enumerate(ds.schema.cols)}
    # collect eq and range conds per column name
    eqs: dict[str, object] = {}
    ranges: dict[str, list] = {}
    consumed: dict[int, str] = {}       # condition position -> col name
    for pos, cond in enumerate(conditions):
        p = _cmp_parts(cond)
        if p is None:
            continue
        op, ci, cst = p
        col = name_of[ci]
        col_type = tbl.col_types[tbl.col_names.index(ds.schema.cols[ci].name)]
        v = _const_for(col_type, cst)
        if v is None:
            continue
        if op == "eq" and col not in eqs:
            eqs[col] = v
            consumed[pos] = col
        elif op != "eq":
            ranges.setdefault(col, []).append((op, v, pos))

    prefix = []
    for col in index.columns:
        cl = col.lower()
        if cl in eqs:
            prefix.append(eqs[cl])
        else:
            break
    if not prefix:
        return None
    acc = IndexAccess(index, prefix)
    used_cols = {c.lower() for c in index.columns[:len(prefix)]}
    acc.is_point = index.unique and len(prefix) == len(index.columns)

    # range on the next index column
    if len(prefix) < len(index.columns):
        nxt = index.columns[len(prefix)].lower()
        for op, v, pos in ranges.get(nxt, []):
            if op in ("gt", "ge"):
                if acc.low is None or v > acc.low:
                    acc.low, acc.low_incl = v, op == "ge"
            else:
                if acc.high is None or v < acc.high:
                    acc.high, acc.high_incl = v, op == "le"
        if acc.low is not None or acc.high is not None:
            acc.range_col = nxt

    # residual = everything except consumed eq conds on used columns
    # (range conds stay as residuals — cheap to re-check, keeps bounds
    # logic simple and NULL-safe)
    acc.residual = [c for pos, c in enumerate(conditions)
                    if not (pos in consumed and consumed[pos] in used_cols)]
    return acc


def choose_index(conditions: list[Expr], ds: DataSource,
                 stats=None) -> Optional[IndexAccess]:
    """Pick the best access path.  Without stats: point gets beat longer
    prefixes beat shorter ones (the reference's heuristic).  With stats
    (post-ANALYZE): cost-based — index double-read (seek + per-row random
    fetch, plan_cost_ver2's scan+net factors) vs full vectorized device
    scan; skip the index when the predicate isn't selective enough."""
    tbl = ds.table
    if getattr(tbl, "kv", None) is None:
        return None
    use = getattr(ds, "hint_use", None)
    ignore = getattr(ds, "hint_ignore", None) or []
    best: Optional[IndexAccess] = None
    for ix in getattr(tbl, "indexes", []):
        if ix.state != "public":
            continue
        if ix.name.lower() in ignore:
            continue
        if use is not None and ix.name.lower() not in use:
            continue
        acc = match_index(conditions, ds, ix)
        if acc is None:
            continue
        if best is None or _score(acc) > _score(best):
            best = acc
    if best is None or best.is_point or stats is None:
        return best
    if use is not None:
        return best       # USE_INDEX forces the path past the cost model
    cost_idx = _index_cost(best, ds, stats)
    cost_scan = tbl.num_rows * SCAN_ROW_COST
    return best if cost_idx < cost_scan else None


# cost factors (plan_cost_ver2 analog, calibrated for the TPU split:
# device scans stream whole columns through XLA, index lookups do
# host-side KV seeks + row decodes)
SCAN_ROW_COST = 1.0
IDX_LOOKUP_ROW_COST = 20.0
IDX_SEEK_COST = 30.0


def _index_cost(acc: IndexAccess, ds: DataSource, stats) -> float:
    raise unported("the cost of an index path from statistics", STATS)

    tbl = ds.table
    n = tbl.num_rows
    sel = 1.0
    name_to_schema = {c.name.lower(): i for i, c in enumerate(ds.schema.cols)}
    # selectivity of the consumed prefix eq conds + range cond, from stats
    for col, v in zip(acc.index.columns, acc.eq_values):
        ci = name_to_schema.get(col.lower())
        if ci is None:
            continue
        ref = ds.schema.ref(ci)
        sel *= cond_selectivity(stats, Func(ref.dtype, "eq",
                                            (ref, Const(ref.dtype, v))), ds)
    if acc.range_col is not None:
        ci = name_to_schema.get(acc.range_col)
        if ci is not None:
            ref = ds.schema.ref(ci)
            if acc.low is not None:
                sel *= cond_selectivity(
                    stats, Func(ref.dtype, "ge" if acc.low_incl else "gt",
                                (ref, Const(ref.dtype, acc.low))), ds)
            if acc.high is not None:
                sel *= cond_selectivity(
                    stats, Func(ref.dtype, "le" if acc.high_incl else "lt",
                                (ref, Const(ref.dtype, acc.high))), ds)
    est_rows = max(n * sel, 1.0)
    return IDX_SEEK_COST + est_rows * IDX_LOOKUP_ROW_COST


def _score(acc: IndexAccess) -> tuple:
    return (acc.is_point, len(acc.eq_values), acc.range_col is not None)


# ------------------------------------------------------------------ #
# plan rewrite
# ------------------------------------------------------------------ #

@dataclass
class LogicalIndexMerge(LogicalPlan):
    """Union of several index accesses serving one OR predicate
    (index_merge_reader.go)."""
    ds: DataSource = None
    accesses: list = None
    conditions: list = None          # the whole disjunction (re-filter)
    schema: Schema = None

    def __post_init__(self):
        self.children = []
        if self.schema is None:
            self.schema = self.ds.schema


@dataclass
class LogicalIndexScan(LogicalPlan):
    """Index-served scan of a KV table (IndexLookUp / PointGet analog)."""
    ds: DataSource
    access: IndexAccess
    schema: Schema = None

    def __post_init__(self):
        self.children = []
        if self.schema is None:
            self.schema = self.ds.schema


def apply_index_paths(p: LogicalPlan, stats_handle=None) -> LogicalPlan:
    """Replace Selection-over-DataSource with an index access when the
    predicates pin an index prefix (run after optimize_plan so predicate
    pushdown has collected conditions at the scan).  stats_handle, when
    given, enables the cost-based index-vs-scan decision."""
    for i, c in enumerate(p.children):
        nc = apply_index_paths(c, stats_handle)
        p.children[i] = nc
        if getattr(p, "child", None) is c:
            p.child = nc
        if getattr(p, "left", None) is c:
            p.left = nc
        if getattr(p, "right", None) is c:
            p.right = nc
    if isinstance(p, LogicalSelection) and isinstance(p.child, DataSource):
        if getattr(p.child, "as_of_ts", None) is not None:
            return p     # stale reads go through the historical snapshot
        stats = (stats_handle.get(p.child.table)
                 if stats_handle is not None else None)
        acc = choose_index(p.conditions, p.child, stats)
        if acc is not None:
            scan = LogicalIndexScan(p.child, acc)
            if acc.residual:
                return LogicalSelection(scan, acc.residual)
            return scan
        im = _try_index_merge(p, stats)
        if im is not None:
            return im
    return p


def _flatten_or(e: Expr) -> list:
    if isinstance(e, Func) and e.op == "or":
        out = []
        for a in e.args:
            out.extend(_flatten_or(a))
        return out
    return [e]


def _split_and(e: Expr) -> list:
    if isinstance(e, Func) and e.op == "and":
        out = []
        for a in e.args:
            out.extend(_split_and(a))
        return out
    return [e]


def _try_index_merge(p: LogicalSelection, stats):
    """UNION-type IndexMerge (executor/index_merge_reader.go): a single
    top-level OR whose every disjunct pins SOME index becomes a union of
    index accesses; rows fetched by the handle union are re-filtered by
    the whole disjunction, so over-approximating accesses stay sound."""
    if len(p.conditions) != 1:
        return None
    disjuncts = _flatten_or(p.conditions[0])
    if len(disjuncts) < 2:
        return None
    accesses = []
    for d in disjuncts:
        acc = choose_index(_split_and(d), p.child, stats)
        if acc is None:
            return None          # one unindexed disjunct = full scan wins
        accesses.append(acc)
    return LogicalIndexMerge(p.child, accesses, list(p.conditions))


__all__ = ["IndexAccess", "match_index", "choose_index", "LogicalIndexScan",
           "LogicalIndexMerge",
           "apply_index_paths"]
