# ported from tidb_tpu/sql/ast.py @ 9d319cb
"""Untyped SQL AST.

Reference analog: pkg/parser/ast (StmtNode/ExprNode hierarchy).  The planner
(planner/build.py) resolves names and types, turning these into the typed
expression IR (expr/ir.py) — same two-stage design as the reference's
ast.ExprNode -> expression.Expression conversion.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence


class Node:
    pass


# ---------------- expressions ---------------- #

@dataclass
class Ident(Node):
    parts: tuple[str, ...]          # (col,) or (table, col) or (db, table, col)


@dataclass
class SysVar(Node):
    """@@[scope.]sysvar or @uservar in expression position."""
    name: str
    scope: str = ""                 # "" | "session" | "global"
    user: bool = False


@dataclass
class Star(Node):
    table: Optional[str] = None     # t.* support


@dataclass
class Lit(Node):
    value: Any                      # python value
    kind: str                       # 'int' | 'decimal' | 'float' | 'str' | 'null' | 'bool' | 'date' | 'datetime' | 'interval'
    unit: Optional[str] = None      # interval unit


@dataclass
class Unary(Node):
    op: str                         # '-' | 'NOT' | '+' | '~'
    arg: Node = None


@dataclass
class Binary(Node):
    op: str                         # '+','-','*','/','DIV','%','=','<>','<','<=','>','>=','AND','OR','XOR'
    left: Node = None
    right: Node = None


@dataclass
class WindowSpec(Node):
    """OVER (...) clause (reference: ast.WindowSpec, pkg/parser)."""
    partition_by: list[Node] = field(default_factory=list)
    order_by: list[tuple[Node, bool]] = field(default_factory=list)
    # frame: None | ('rows', (lo_kind, lo_n), (hi_kind, hi_n)) with kinds
    # 'unbounded_preceding' | 'preceding' | 'current' | 'following' |
    # 'unbounded_following'
    frame: Optional[tuple] = None


@dataclass
class FuncCall(Node):
    name: str                       # uppercased
    args: list[Node] = field(default_factory=list)
    distinct: bool = False          # COUNT(DISTINCT x)
    over: Optional[WindowSpec] = None  # window function call


@dataclass
class CaseExpr(Node):
    operand: Optional[Node]
    branches: list[tuple[Node, Node]] = field(default_factory=list)
    else_: Optional[Node] = None


@dataclass
class InExpr(Node):
    target: Node
    items: list[Node] = field(default_factory=list)
    negated: bool = False


@dataclass
class BetweenExpr(Node):
    target: Node
    low: Node = None
    high: Node = None
    negated: bool = False


@dataclass
class LikeExpr(Node):
    target: Node
    pattern: Node = None
    negated: bool = False


@dataclass
class IsNullExpr(Node):
    target: Node
    negated: bool = False


@dataclass
class CastExpr(Node):
    arg: Node
    type_name: str                  # 'SIGNED','UNSIGNED','DOUBLE','DECIMAL(p,s)','CHAR','DATE','DATETIME'
    prec: int = -1
    scale: int = -1


@dataclass
class SubqueryExpr(Node):
    select: "SelectStmt" = None
    # scalar subquery / IN (subquery) contexts resolved by planner


@dataclass
class ExistsExpr(Node):
    select: "SelectStmt" = None
    negated: bool = False


# ---------------- table refs ---------------- #

@dataclass
class TableName(Node):
    name: str
    db: Optional[str] = None
    alias: Optional[str] = None
    # stale read: AS OF TIMESTAMP <literal> (sessiontxn/staleread) —
    # an int literal is a raw logical ts, a string parses as a datetime
    as_of: Optional[object] = None
    # table-factor index hints: [('use'|'ignore'|'force', [names])]
    index_hints: list = field(default_factory=list)


@dataclass
class SubqueryRef(Node):
    select: "SelectStmt" = None
    alias: str = ""


@dataclass
class Join(Node):
    kind: str                       # 'inner' | 'left' | 'right' | 'cross'
    left: Node = None
    right: Node = None
    on: Optional[Node] = None
    using: Optional[list[str]] = None


# ---------------- statements ---------------- #

@dataclass
class SelectItem(Node):
    expr: Node
    alias: Optional[str] = None


@dataclass
class SelectStmt(Node):
    items: list[SelectItem] = field(default_factory=list)
    from_: Optional[Node] = None
    where: Optional[Node] = None
    group_by: list[Node] = field(default_factory=list)
    rollup: bool = False            # GROUP BY ... WITH ROLLUP
    having: Optional[Node] = None
    order_by: list[tuple[Node, bool]] = field(default_factory=list)  # (expr, desc)
    limit: Optional[int] = None
    offset: Optional[int] = None
    distinct: bool = False
    ctes: list["CTE"] = field(default_factory=list)
    recursive: bool = False         # WITH RECURSIVE
    hints: list[tuple] = field(default_factory=list)  # [(NAME, [args])]
    for_update: bool = False        # SELECT ... FOR UPDATE locking read


@dataclass
class SetOpStmt(Node):
    """UNION / EXCEPT / INTERSECT of two queries (reference:
    ast.SetOprStmt).  Chains are left-deep trees of SetOpStmt."""
    kind: str                       # 'union' | 'except' | 'intersect'
    all: bool = False               # UNION ALL vs DISTINCT
    left: Node = None               # SelectStmt | SetOpStmt
    right: Node = None
    order_by: list[tuple[Node, bool]] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    ctes: list["CTE"] = field(default_factory=list)
    recursive: bool = False


@dataclass
class CTE(Node):
    """One WITH-list element (reference: ast.CommonTableExpression)."""
    name: str
    columns: list[str] = field(default_factory=list)
    select: Node = None             # SelectStmt | SetOpStmt


@dataclass
class ColumnDef(Node):
    name: str
    type_name: str                  # normalized, e.g. 'BIGINT','DECIMAL','VARCHAR'
    prec: int = -1
    scale: int = -1
    not_null: bool = False
    primary_key: bool = False
    default: Optional[Node] = None
    auto_increment: bool = False
    collation: str = ""             # COLLATE clause ('' = table/charset default)
    members: tuple = ()             # ENUM('a','b') / SET(...) member list
    references: Optional[tuple] = None  # (ref_table, ref_col, on_delete)
    generated: Optional[Node] = None    # [GENERATED ALWAYS] AS (expr)
    generated_stored: bool = False      # STORED vs VIRTUAL


@dataclass
class TTLOption(Node):
    """TTL = col + INTERVAL n unit (reference: ast.TableOption TTL)."""
    column: str = ""
    interval_sec: int = 0
    enable: bool = True


@dataclass
class CreateTable(Node):
    name: str
    db: Optional[str] = None         # CREATE TABLE db.name
    columns: list[ColumnDef] = field(default_factory=list)
    primary_key: list[str] = field(default_factory=list)
    if_not_exists: bool = False
    # inline index defs: (name_or_None, [cols], unique)
    indexes: list[tuple] = field(default_factory=list)
    ttl: Optional[TTLOption] = None
    partition: Optional[PartitionSpec] = None
    foreign_keys: list = field(default_factory=list)  # [ForeignKeyDef]
    temporary: bool = False          # CREATE TEMPORARY TABLE (session-scoped)


@dataclass
class CreateSequence(Node):
    """Reference analog: pkg/ddl/sequence.go + parser sequence options."""
    name: str
    start: int = 1
    increment: int = 1
    min_value: Optional[int] = None
    max_value: Optional[int] = None
    cache: int = 1000
    cycle: bool = False
    if_not_exists: bool = False


@dataclass
class DropSequence(Node):
    name: str
    if_exists: bool = False


@dataclass
class CreateIndex(Node):
    name: str
    table: str
    db: Optional[str] = None
    columns: list[str] = field(default_factory=list)
    unique: bool = False
    if_not_exists: bool = False


@dataclass
class DropIndex(Node):
    name: str
    table: str
    db: Optional[str] = None
    if_exists: bool = False


@dataclass
class AlterTable(Node):
    """Round-1 actions: ('add_index', name, cols, unique) |
    ('drop_index', name) | ('add_column', ColumnDef) |
    ('drop_column', name)."""
    table: str
    db: Optional[str] = None
    actions: list[tuple] = field(default_factory=list)


@dataclass
class PartitionSpec:
    """PARTITION BY clause (reference: parser.y PartitionOpt; model
    meta/model PartitionInfo).  kind 'range': parts = [(name, upper-bound
    int | None for MAXVALUE)], ordered ascending.  kind 'hash': num
    partitions named p0..p{n-1}."""
    kind: str                      # 'range' | 'hash'
    column: str
    parts: list = field(default_factory=list)
    num: int = 0


@dataclass
class ForeignKeyDef:
    """FOREIGN KEY (col) REFERENCES parent(col) [ON DELETE action]
    (parser.y ReferenceDef analog; model meta/model FKInfo)."""
    name: str
    column: str
    ref_table: str
    ref_column: str
    on_delete: str = "restrict"    # restrict | cascade


@dataclass
class CreateView(Node):
    """CREATE [OR REPLACE] VIEW name [(cols)] AS select (parser.y
    CreateViewStmt analog); the select is kept as SQL text and re-planned
    at every expansion, so schema changes flow through."""
    name: str
    columns: list = field(default_factory=list)
    select_sql: str = ""
    or_replace: bool = False


@dataclass
class PlanReplayerDump(Node):
    """PLAN REPLAYER DUMP EXPLAIN <sql> (executor/plan_replayer.go):
    bundle plan + schema + stats + sysvars into a zip for offline
    reproduction."""
    sql: str = ""


@dataclass
class DropView(Node):
    names: list = field(default_factory=list)
    if_exists: bool = False


@dataclass
class DropTable(Node):
    # (db | None, name) tuples — tuples, not dotted strings, so backtick
    # identifiers containing dots round-trip
    names: list[tuple] = field(default_factory=list)
    if_exists: bool = False
    temporary: bool = False      # DROP TEMPORARY TABLE: temp scope ONLY


@dataclass
class CreateDatabase(Node):
    name: str = ""
    if_not_exists: bool = False


@dataclass
class DropDatabase(Node):
    name: str = ""
    if_exists: bool = False


@dataclass
class UseDatabase(Node):
    name: str = ""


@dataclass
class Insert(Node):
    table: str = ""
    db: Optional[str] = None
    columns: list[str] = field(default_factory=list)
    rows: list[list[Node]] = field(default_factory=list)
    select: Optional[SelectStmt] = None
    replace: bool = False           # REPLACE INTO: delete conflicts first
    ignore: bool = False            # INSERT IGNORE: skip dup-key rows
    # ON DUPLICATE KEY UPDATE assignments [(col, expr)] — expr may use
    # VALUES(col) to reference the proposed row (executor/insert.go upsert)
    on_dup: list = field(default_factory=list)


@dataclass
class LoadData(Node):
    """LOAD DATA INFILE (executor/load_data.go analog)."""
    path: str = ""
    table: str = ""
    columns: list[str] = field(default_factory=list)
    field_sep: str = "\t"
    enclosed: str = ""
    line_sep: str = "\n"
    ignore_lines: int = 0
    replace: bool = False
    ignore: bool = False            # IGNORE keyword: skip dup-key rows


@dataclass
class Update(Node):
    table: str = ""
    db: Optional[str] = None
    assignments: list[tuple[str, Node]] = field(default_factory=list)
    where: Optional[Node] = None
    order_by: list = field(default_factory=list)   # [(expr, desc)]
    limit: Optional[int] = None


@dataclass
class Delete(Node):
    table: str = ""
    db: Optional[str] = None
    where: Optional[Node] = None
    order_by: list = field(default_factory=list)   # [(expr, desc)]
    limit: Optional[int] = None


@dataclass
class Explain(Node):
    stmt: Node = None
    analyze: bool = False


@dataclass
class TraceStmt(Node):
    stmt: Node = None


@dataclass
class ShowStmt(Node):
    kind: str = ""                  # 'tables' | 'databases' | 'variables' | 'columns'
    target: Optional[str] = None
    like: Optional[str] = None      # SHOW ... LIKE 'pattern' filter


@dataclass
class SetStmt(Node):
    scope: str = "session"
    assignments: list[tuple[str, Node]] = field(default_factory=list)
    # SET @name = expr (user-defined variables, reference: ast.VariableAssignment IsSystem=false)
    user_vars: list[tuple[str, Node]] = field(default_factory=list)


@dataclass
class PrepareStmt(Node):
    """PREPARE name FROM 'sql' (reference: ast.PrepareStmt)."""
    name: str = ""
    sql: str = ""


@dataclass
class ExecutePrepared(Node):
    """EXECUTE name [USING @a, @b] (reference: ast.ExecuteStmt)."""
    name: str = ""
    using: list[str] = field(default_factory=list)


@dataclass
class DeallocateStmt(Node):
    name: str = ""


@dataclass
class TxnStmt(Node):
    kind: str = ""                  # 'begin' | 'commit' | 'rollback'
    mode: str = ""                  # begin only: '' | 'pessimistic' | 'optimistic'


@dataclass
class AnalyzeTable(Node):
    name: str = ""
    columns: list = field(default_factory=list)   # ANALYZE ... COLUMNS c,...
    predicate_columns: bool = False               # ... PREDICATE COLUMNS
    sample_rate: Optional[float] = None           # WITH r SAMPLERATE


@dataclass
class TruncateTable(Node):
    name: str = ""


# ---------------- users & privileges (reference: ast/misc.go
# CreateUserStmt/GrantStmt, pkg/privilege) ---------------- #

@dataclass
class UserSpec(Node):
    user: str = ""
    host: str = "%"


@dataclass
class CreateUser(Node):
    users: list[tuple[UserSpec, Optional[str]]] = field(default_factory=list)
    if_not_exists: bool = False     # (spec, password)


@dataclass
class AlterUser(Node):
    users: list[tuple[UserSpec, Optional[str]]] = field(default_factory=list)


@dataclass
class DropUser(Node):
    users: list[UserSpec] = field(default_factory=list)
    if_exists: bool = False


@dataclass
class GrantStmt(Node):
    privs: list[str] = field(default_factory=list)  # 'SELECT'... | 'ALL'
    db: str = "*"
    table: str = "*"
    users: list[UserSpec] = field(default_factory=list)


@dataclass
class RevokeStmt(Node):
    privs: list[str] = field(default_factory=list)
    db: str = "*"
    table: str = "*"
    users: list[UserSpec] = field(default_factory=list)


@dataclass
class KillStmt(Node):
    conn_id: int
    query_only: bool = True      # KILL QUERY vs KILL CONNECTION


@dataclass
class FlushStmt(Node):
    what: str = "privileges"


@dataclass
class AdminStmt(Node):
    """ADMIN SHOW DDL JOBS | ADMIN CHECK TABLE t | ADMIN RECOMMEND INDEX
    (reference: ast.AdminStmt)."""
    kind: str = ""      # 'show ddl jobs' | 'check table' | 'recommend index'
    target: Optional[str] = None


@dataclass
class CreateBinding(Node):
    """CREATE [GLOBAL|SESSION] BINDING FOR <stmt> USING <hinted stmt>."""
    scope: str = "global"
    original_sql: str = ""
    bind_sql: str = ""


@dataclass
class DropBinding(Node):
    scope: str = "global"
    original_sql: str = ""


@dataclass
class CreateResourceGroup(Node):
    """CREATE/ALTER RESOURCE GROUP (pkg/resourcegroup meta).  None =
    option not named in the statement (ALTER merges, CREATE defaults)."""
    name: str = ""
    ru_per_sec: Optional[int] = None
    burstable: Optional[bool] = None
    exec_elapsed_sec: Optional[float] = None
    action: Optional[str] = None   # kill | cooldown | switch_group
    switch_target: Optional[str] = None  # SWITCH_GROUP(<name>) target
    priority: Optional[str] = None  # low | medium | high (sched weight)
    if_not_exists: bool = False
    replace: bool = False          # ALTER form


@dataclass
class DropResourceGroup(Node):
    name: str = ""
    if_exists: bool = False


@dataclass
class SetResourceGroup(Node):
    name: str = ""


@dataclass
class SplitTable(Node):
    """SPLIT TABLE t REGIONS n (region-split analog: re-shard the scan
    fan-out)."""
    table: str = ""
    regions: int = 0


__all__ = [n for n in dir() if n[0].isupper()]
