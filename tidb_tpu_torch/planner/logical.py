# ported from tidb_tpu/planner/logical.py @ 9d319cb
"""Logical plan operators.

Reference analog: pkg/planner/core logical operators (LogicalSelection,
LogicalProjection, LogicalAggregation, LogicalJoin, LogicalSort, ...).
Schemas are ordered lists of named, typed output columns; expression IR
ColumnRefs index into the child's schema by position, exactly like the
reference's column offsets.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..copr.dag import AggFunc
from ..expr.ir import ColumnRef, Expr
from ..types import dtypes as dt


@dataclass
class SchemaCol:
    name: str                      # output name
    dtype: dt.DataType
    qualifier: Optional[str] = None  # table alias for resolution


@dataclass
class Schema:
    cols: list[SchemaCol] = field(default_factory=list)

    def __len__(self):
        return len(self.cols)

    def find(self, name: str, qualifier: Optional[str] = None) -> list[int]:
        name = name.lower()
        out = []
        for i, c in enumerate(self.cols):
            if c.name.lower() != name:
                continue
            if qualifier is not None and (c.qualifier or "").lower() != qualifier.lower():
                continue
            out.append(i)
        return out

    def ref(self, i: int) -> ColumnRef:
        c = self.cols[i]
        return ColumnRef(c.dtype, i, c.name)

    def names(self) -> list[str]:
        return [c.name for c in self.cols]


class LogicalPlan:
    schema: Schema
    children: list["LogicalPlan"]


@dataclass
class DataSource(LogicalPlan):
    """Scan of one stored table (reference: logical DataSource)."""
    table: object                  # session.catalog.TableInfo
    alias: str
    schema: Schema = None
    col_offsets: list[int] = None  # into the table's stored columns
    hint_use: list = None          # USE_INDEX(t, ix...) index names
    hint_ignore: list = None       # IGNORE_INDEX(t, ix...)
    as_of_ts: object = None        # stale read: resolved MVCC read ts
    # join-method hint naming this table ('' | 'hash' | 'merge' | 'inl');
    # carried on the LEAF so join-reorder rebuilds don't lose it
    hint_join: str = ""

    def __post_init__(self):
        self.children = []


@dataclass
class LogicalSelection(LogicalPlan):
    child: LogicalPlan
    conditions: list[Expr]

    def __post_init__(self):
        self.schema = self.child.schema
        self.children = [self.child]


@dataclass
class LogicalProjection(LogicalPlan):
    child: LogicalPlan
    exprs: list[Expr]
    schema: Schema = None

    def __post_init__(self):
        self.children = [self.child]


@dataclass
class AggItem:
    func: AggFunc
    arg: Optional[Expr]
    distinct: bool
    out_dtype: dt.DataType


@dataclass
class LogicalAggregate(LogicalPlan):
    child: LogicalPlan
    group_exprs: list[Expr]
    aggs: list[AggItem]
    schema: Schema = None          # group cols then agg cols

    def __post_init__(self):
        self.children = [self.child]


@dataclass
class LogicalExpand(LogicalPlan):
    """Grouping-sets row replication for GROUP BY ... WITH ROLLUP.

    Reference analog: the logical Expand operator
    (pkg/planner/core/operator/logicalop/logical_expand.go:32) executed by
    the engine at unistore/cophandler/mpp.go:638.  Level l of `levels`
    replicates every input row keeping the first len(keys)-l rollup keys
    (the rolled ones become NULL).  Output schema: child columns ++ one
    nullable column per rollup key ++ gid (bigint, = the row's level l),
    so GROUPING() can distinguish rolled NULLs from natural NULLs.
    """
    child: LogicalPlan
    keys: list = None          # rollup key exprs over child schema
    levels: int = 0            # len(keys) + 1 for ROLLUP
    schema: Schema = None

    def __post_init__(self):
        self.children = [self.child]


@dataclass
class LogicalJoin(LogicalPlan):
    kind: str          # 'inner' | 'left' | 'right' | 'cross' | 'semi' | 'anti'
    left: LogicalPlan = None
    right: LogicalPlan = None
    # equi-join keys as (left_index, right_index) into child schemas
    eq_keys: list[tuple[int, int]] = field(default_factory=list)
    # residual conditions over the concatenated schema
    other_conds: list[Expr] = field(default_factory=list)
    schema: Schema = None
    # NOT IN semantics (null-aware anti join, rule_decorrelate.go analog):
    # any NULL build key empties the result; NULL probe keys never pass
    null_aware: bool = False
    # optimizer-hint join method: '' | 'hash' | 'merge' | 'inl'
    hint_method: str = ""
    hint_leading: list = None      # LEADING(t1, t2, ...) table order

    def __post_init__(self):
        self.children = [self.left, self.right]


@dataclass
class LogicalApply(LogicalPlan):
    """Correlated scalar subqueries (reference: LogicalApply +
    rule_decorrelate fallback; P8 parallel apply).  Appends one column
    per subquery to the child's schema; each subquery re-evaluates per
    DISTINCT combination of the outer values it references (the apply
    cache, executor/join/apply_cache.go analog)."""
    child: LogicalPlan = None
    # [(sub_ast, out_dtype, name)] — outer refs bind by name at exec time
    subqueries: list = field(default_factory=list)
    catalog: object = None
    default_db: str = ""
    schema: Schema = None

    def __post_init__(self):
        self.children = [self.child]


@dataclass
class LogicalSort(LogicalPlan):
    child: LogicalPlan
    keys: list[tuple[Expr, bool]]  # (expr over child schema, desc)

    def __post_init__(self):
        self.schema = self.child.schema
        self.children = [self.child]


@dataclass
class LogicalLimit(LogicalPlan):
    child: LogicalPlan
    limit: int
    offset: int = 0

    def __post_init__(self):
        self.schema = self.child.schema
        self.children = [self.child]


@dataclass
class LogicalTopN(LogicalPlan):
    child: LogicalPlan
    keys: list[tuple[Expr, bool]]
    limit: int
    offset: int = 0

    def __post_init__(self):
        self.schema = self.child.schema
        self.children = [self.child]


@dataclass
class LogicalSetOp(LogicalPlan):
    """UNION / EXCEPT / INTERSECT (reference: LogicalUnionAll + the set-op
    rewrites in logical_plan_builder.go buildSetOpr)."""
    kind: str                      # 'union' | 'except' | 'intersect'
    all: bool = False
    left: LogicalPlan = None
    right: LogicalPlan = None
    schema: Schema = None          # unified output (left names, joined types)

    def __post_init__(self):
        self.children = [self.left, self.right]


@dataclass
class WindowItem:
    """One window function call bound to its OVER spec (reference:
    planner/core WindowFuncDesc + WindowFrame)."""
    func: str                      # row_number|rank|dense_rank|ntile|lag|...
    args: list                     # [Expr] over the window child's schema
    partition: list = field(default_factory=list)    # [Expr]
    order: list = field(default_factory=list)        # [(Expr, desc)]
    frame: Optional[tuple] = None  # parsed frame or None (default frame)
    out_dtype: dt.DataType = None


@dataclass
class LogicalWindow(LogicalPlan):
    """Window functions over child rows; output schema = child columns then
    one column per item, in the child's row order (reference:
    LogicalWindow, executor/window.go)."""
    child: LogicalPlan
    items: list[WindowItem] = field(default_factory=list)
    schema: Schema = None

    def __post_init__(self):
        self.children = [self.child]


class CTEStorage:
    """Shared state of one CTE (reference: util/cteutil.Storage).

    Non-recursive CTEs are inlined at build time and never use this.  A
    recursive CTE materializes here: `seed_logical` + `rec_logicals` are
    lowered lazily by the physical planner; the executor iterates
    seed -> recursive parts (which read `working`) until fixpoint, capping
    at `max_depth` (cte_max_recursion_depth analog, executor/cte.go)."""

    def __init__(self, name: str, distinct: bool, max_depth: int = 1000):
        self.name = name
        self.distinct = distinct
        self.max_depth = max_depth
        self.schema: Schema = None
        self.seed_logical: LogicalPlan = None
        self.rec_logicals: list[LogicalPlan] = []
        self.seed_phys = None
        self.rec_phys: list = []
        self.working = None        # ResultChunk: rows of the last iteration
        self.result = None         # ResultChunk: full materialized result


@dataclass
class LogicalCTEScan(LogicalPlan):
    """Scan of a recursive CTE: the working table inside the recursive
    part, or the materialized result outside it."""
    storage: CTEStorage
    role: str                      # 'working' | 'result'
    schema: Schema = None

    def __post_init__(self):
        self.children = []


def walk_plan(p: LogicalPlan):
    """Preorder walk over a logical plan tree."""
    yield p
    for c in getattr(p, "children", []):
        if c is not None:
            yield from walk_plan(c)


def find_datasource(p: LogicalPlan, name: str):
    """DataSource with the given alias (case-insensitive), or None — the
    one shared alias-resolution walk (hints, LEADING, join-method)."""
    low = name.lower()
    for n in walk_plan(p):
        if isinstance(n, DataSource) and n.alias.lower() == low:
            return n
    return None


def explain_logical(p: LogicalPlan, indent: int = 0) -> str:
    pad = "  " * indent
    name = type(p).__name__
    extra = ""
    if isinstance(p, LogicalSelection):
        extra = " " + ", ".join(map(str, p.conditions))
    elif isinstance(p, LogicalProjection):
        extra = " " + ", ".join(map(str, p.exprs))
    elif isinstance(p, LogicalAggregate):
        extra = (" group=[" + ", ".join(map(str, p.group_exprs)) + "] aggs=["
                 + ", ".join(f"{a.func.value}({a.arg})" for a in p.aggs) + "]")
    elif isinstance(p, DataSource):
        extra = f" table={p.alias}"
    elif isinstance(p, LogicalJoin):
        extra = f" {p.kind} keys={p.eq_keys}"
    out = [pad + name + extra]
    for c in getattr(p, "children", []):
        out.append(explain_logical(c, indent + 1))
    return "\n".join(out)


__all__ = [
    "SchemaCol", "Schema", "LogicalPlan", "DataSource", "LogicalSelection",
    "LogicalProjection", "AggItem", "LogicalAggregate", "LogicalJoin",
    "LogicalSort", "LogicalLimit", "LogicalTopN", "LogicalSetOp",
    "WindowItem", "LogicalWindow", "CTEStorage", "LogicalCTEScan",
    "explain_logical",
]
