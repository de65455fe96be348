# ported from tidb_tpu/session/session.py @ 9d319cb
"""Session: statement lifecycle.

Reference analog: pkg/session (session.ExecuteStmt, session.go:2112) —
parse -> plan -> execute, returning a RecordSet.  The Domain analog
(shared catalog + devices + cop client per process) is
session.session.Domain.

The port's session is the SELECT path of the JAX package's: ``SELECT``,
``EXPLAIN`` (not ``EXPLAIN ANALYZE``), ``SET`` of session, global and
user variables, and ``USE``.  Its ``_plan_select`` is the JAX package's
without the plan cache, plan bindings, cascades, the inline
auto-analyze and the analysis gates, and with its greedy join reorder
run without statistics; so its plans are the JAX package's plans with
``tidb_enable_auto_analyze = 0``.  Joins run: the broadcast join fused
into the probe table's device program, the repartition join over the
logical devices, and the host hash and merge joins and subquery apply.
A physical plan that holds an operator of a later slice (rollup, a
window, a set operation, an index read or a memtable) raises
``NotImplementedError`` naming its ROADMAP.md item, as does every other
statement kind.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from .. import (CONTROL, EXCHANGE, HOST_OPS, HOST_SURFACE, PLAN_CACHE,
                PLANNER, ROLLUP, STATS, STORE, unported)
from ..copr import dag as D
from ..copr.coordinator import KILL_EVENT, QUERY_HANDLE, Coordinator
from ..executor import physical as P
from ..executor.plan import to_physical
from ..planner.join_reorder import reorder_joins
from ..planner.build import (PLAN_TAINTS, SESSION_INFO, SUBQUERY_EXECUTOR,
                             PlanError, build_query)
from ..planner.optimize import optimize_plan
from ..planner.ranger import apply_index_paths
from ..sql import ast as A
from ..sql.parser import parse_sql
from ..store.client import CopClient
from .catalog import Catalog, CatalogError
from .sysvars import REGISTRY, SysVarError, defaults, validate_set


@dataclass
class ResultSet:
    """RecordSet analog: column names + decoded python rows."""
    names: list[str] = field(default_factory=list)
    rows: list[tuple] = field(default_factory=list)
    affected: int = 0
    # column dtypes when known (SELECT paths) — the wire protocol layer
    # maps these to MySQL column types; None entries mean "infer"
    dtypes: Optional[list] = None
    last_insert_id: int = 0

    def scalar(self):
        return self.rows[0][0] if self.rows else None


class Domain:
    """Per-process state (pkg/domain analog): catalog + the port's
    ``CopClient`` + sysvars + the query coordinator.

    ``device`` and ``n_devices`` go to ``CopClient``: the default is one
    ``cuda:0`` and raises without a GPU; tests pass ``device="cpu"``.
    The JAX package's Domain also holds the KV store, meta, DXF, DDL,
    statistics, bindings and background workers; the port's has none of
    them yet (ROADMAP.md, Queue 1)."""

    def __init__(self, device="cuda", n_devices: int = 1):
        self.catalog = Catalog()
        self.catalog.domain = self          # memtable binding (infoschema)
        self.client = CopClient(device, n_devices)
        self.coordinator = Coordinator()    # mppcoordmanager analog
        self.sysvars: dict[str, Any] = defaults()
        # statistics arrive with slice 9: the port plans as the JAX
        # package does with auto-analyze off, and says so
        self.sysvars["tidb_enable_auto_analyze"] = 0
        self._next_conn_id = 0

    def register_session(self, sess) -> int:
        self._next_conn_id += 1
        return self._next_conn_id


# statement kinds of later slices, by the ROADMAP.md item that ports them
_UNPORTED_STMTS = {
    "Insert": STORE, "LoadData": STORE, "Update": STORE, "Delete": STORE,
    "CreateTable": STORE, "DropTable": STORE, "CreateIndex": STORE,
    "DropIndex": STORE, "AlterTable": STORE, "TruncateTable": STORE,
    "CreateDatabase": STORE, "DropDatabase": STORE, "CreateView": STORE,
    "DropView": STORE, "CreateSequence": STORE, "DropSequence": STORE,
    "TxnStmt": STORE, "SplitTable": STORE,
    "AnalyzeTable": STATS,
    "PrepareStmt": PLAN_CACHE, "ExecutePrepared": PLAN_CACHE,
    "DeallocateStmt": PLAN_CACHE, "CreateBinding": PLAN_CACHE,
    "DropBinding": PLAN_CACHE,
    "TraceStmt": CONTROL, "PlanReplayerDump": CONTROL,
    "CreateResourceGroup": CONTROL, "DropResourceGroup": CONTROL,
    "SetResourceGroup": CONTROL,
}

# physical operators of later slices, by the ROADMAP.md item that ports
# them; every other operator of executor/physical.py runs
_UNPORTED_OPS = {
    "HostIndexLookupJoin": STORE,
    "HostExpandExec": ROLLUP,
    "CopWindowExec": EXCHANGE, "HostWindow": EXCHANGE,
    "HostSetOp": HOST_OPS, "CTEScanExec": HOST_OPS,
    "HostTableScanExec": HOST_OPS,
    "IndexLookUpExec": STORE, "IndexMergeExec": STORE,
    "MemTableExec": HOST_SURFACE,
}


def check_ported(phys: P.PhysOp) -> None:
    """Raise ``NotImplementedError`` naming its ROADMAP.md item for the
    first operator of ``phys`` that the port does not run yet: one of
    ``_UNPORTED_OPS``, or a cop task whose DAG holds a rollup node."""
    stack = [phys]
    while stack:
        op = stack.pop()
        name = type(op).__name__
        if name in _UNPORTED_OPS:
            raise unported(f"the {name} operator", _UNPORTED_OPS[name])
        if isinstance(op, P.CopTaskExec):
            node = op.dag
            while node is not None:
                if isinstance(node, D.Expand):
                    raise unported("the rollup Expand node", ROLLUP)
                node = getattr(node, "child", None)
        stack.extend(getattr(op, "children", ()) or ())


class Session:
    """``timings`` holds the wall-clock seconds of the last SELECT or
    EXPLAIN by phase: ``parse``, ``plan`` (build, optimize and the
    physical plan), then for a SELECT ``execute`` (the executor tree,
    the client's work included; its own split is
    ``domain.client.timings``) and ``decode`` (the result's columns into
    python rows)."""

    def __init__(self, domain: Optional[Domain] = None, db: str = "test",
                 user: str = "root"):
        self.domain = domain or Domain()
        self.conn_id = self.domain.register_session(self)
        self.db = db
        self.user = user
        self.vars: dict[str, Any] = {}
        self.user_vars: dict[str, Any] = {}      # SET @x = ...
        self.timings: dict = {}
        self._kill_event = threading.Event()   # statement start clears

    # ------------------------------------------------------------- #

    def execute(self, sql: str) -> ResultSet:
        t0 = time.perf_counter()
        stmts = parse_sql(sql)
        parse_s = (time.perf_counter() - t0) / max(len(stmts), 1)
        out = ResultSet()
        for stmt in stmts:
            span = getattr(stmt, "text_span", None)
            text = sql[span[0]:span[1]].strip() if span else sql
            self.timings = {"parse": parse_s}
            self._kill_event.clear()
            handle = self.domain.coordinator.begin(self.conn_id, text)
            ktok = KILL_EVENT.set(self._kill_event)
            htok = QUERY_HANDLE.set(handle)

            def _getvar(name, scope=""):
                if scope == "global":
                    return self.domain.sysvars.get(name)
                merged = {**self.domain.sysvars, **self.vars}
                if name in merged:
                    return merged[name]
                ent = REGISTRY.get(name)
                return ent.default if ent is not None else None

            stok = SESSION_INFO.set({
                "db": self.db, "user": self.user,
                "conn_id": self.conn_id,
                "last_insert_id": 0,
                "row_count": getattr(self, "_row_count", -1),
                "found_rows": getattr(self, "_found_rows", 0),
                "getvar": _getvar,
                "getuservar":
                    lambda name, _s="": self.user_vars.get(name)})
            try:
                out = self._dispatch_stmt(stmt)
            finally:
                SESSION_INFO.reset(stok)
                QUERY_HANDLE.reset(htok)
                KILL_EVENT.reset(ktok)
                self.domain.coordinator.end(self.conn_id)
            # ROW_COUNT()/FOUND_ROWS() state (executor/adapter.go
            # affectedRows analogs)
            if out.names:
                self._found_rows = len(out.rows)
                self._row_count = -1
            else:
                self._row_count = out.affected
        return out

    def must_query(self, sql: str) -> list[tuple]:
        """testkit MustQuery analog."""
        return self.execute(sql).rows

    # ------------------------------------------------------------- #

    def _dispatch_stmt(self, stmt: A.Node) -> ResultSet:
        if isinstance(stmt, (A.SelectStmt, A.SetOpStmt)):
            return self._exec_select(stmt)
        if isinstance(stmt, A.Explain):
            return self._exec_explain(stmt)
        if isinstance(stmt, A.UseDatabase):
            from ..infoschema import is_system_db
            if stmt.name not in self.domain.catalog.databases \
                    and not is_system_db(stmt.name):
                raise CatalogError(f"unknown database {stmt.name!r}")
            self.db = stmt.name
            return ResultSet()
        if isinstance(stmt, A.SetStmt):
            return self._exec_set(stmt)
        name = type(stmt).__name__
        raise unported(f"the {name} statement",
                       _UNPORTED_STMTS.get(name, HOST_SURFACE))

    def _exec_set(self, stmt: A.SetStmt) -> ResultSet:
        for name, val in stmt.assignments:
            # full expression eval: SET x = -1 / DEFAULT / 2*1024 all
            # work (reference: variable assignment evals an expression)
            v = (val.value if isinstance(val, A.Lit)
                 else self._eval_scalar(val))
            try:
                v = validate_set(name.lower(), v, scope=stmt.scope)
            except SysVarError as e:
                raise PlanError(str(e))
            if name.lower() == "tidb_enable_auto_analyze" and v:
                raise unported("auto-analyze (statistics)", STATS)
            if stmt.scope == "global":
                self.domain.sysvars[name.lower()] = v
            else:
                self.vars[name.lower()] = v
        for name, val in stmt.user_vars:
            self.user_vars[name.lower()] = self._eval_scalar(val)
        return ResultSet()

    def _eval_scalar(self, expr: A.Node):
        """Evaluate a scalar expression (SET @x = ...)."""
        if isinstance(expr, A.Lit):
            if expr.kind in ("int", "bool"):
                return int(expr.value)
            if expr.kind == "float":
                return float(expr.value)
            if expr.kind == "decimal":
                return str(expr.value)
            return expr.value
        sel = A.SelectStmt(items=[A.SelectItem(expr)])
        return self._exec_select(sel).scalar()

    # ------------------------------------------------------------- #

    def _plan_select(self, stmt):
        """Build, optimize and bind the physical plan of a SELECT: the
        JAX package's ``_plan_select`` without the plan cache, bindings,
        auto-analyze and analysis gates, its join reorder without
        statistics."""
        t0 = time.perf_counter()
        if getattr(stmt, "hints", None):
            raise unported("optimizer hints and plan bindings", PLAN_CACHE)
        if getattr(stmt, "for_update", False):
            raise unported("SELECT ... FOR UPDATE", STORE)
        merged = {**self.domain.sysvars, **self.vars}
        if _flag_on(merged, "tidb_enable_cascades_planner", default=False):
            raise unported("the cascades planner", PLANNER)
        # uncorrelated scalar subqueries evaluate eagerly at plan time
        # (EvalSubqueryFirstRow analog)
        ran_subquery: list = []
        token = SUBQUERY_EXECUTOR.set(
            lambda ast: self._eval_scalar_subquery(ast, ran_subquery))
        token2 = PLAN_TAINTS.set(ran_subquery)
        try:
            built = build_query(stmt, self.domain.catalog, self.db)
        finally:
            SUBQUERY_EXECUTOR.reset(token)
            PLAN_TAINTS.reset(token2)
        plan = optimize_plan(built.plan)
        if _flag_on(merged, "tidb_opt_skew_distinct_agg", default=False):
            from ..planner.rules import rewrite_skew_distinct
            plan = rewrite_skew_distinct(plan)
        # the greedy join reorder without statistics: the JAX package's
        # over tables never ANALYZEd (its handle's get gives None)
        plan = reorder_joins(plan, None)
        phys = self._to_physical(apply_index_paths(plan))
        self.timings["plan"] = time.perf_counter() - t0
        return built, phys

    def _to_physical(self, plan) -> P.PhysOp:
        """The physical plan, its cop tasks naming the client's device;
        raises for an operator of a later slice (``check_ported``)."""
        tok = P.COP_DEVICE.set(self.domain.client.devices[0].type)
        try:
            phys = to_physical(plan)
        finally:
            P.COP_DEVICE.reset(tok)
        check_ported(phys)
        return phys

    def _eval_scalar_subquery(self, sub_ast, ran: list):
        """Plan + execute an uncorrelated scalar subquery and fold its
        result to a Const (reference: EvalSubqueryFirstRow,
        planner/core/expression_rewriter.go)."""
        from ..expr import builders as B
        from ..expr.ir import Const
        ran.append(True)
        built = build_query(sub_ast, self.domain.catalog, self.db)
        if len(built.plan.schema) != 1:
            raise PlanError("scalar subquery must return one column")
        phys = self._to_physical(apply_index_paths(optimize_plan(built.plan)))
        chunk = phys.execute(self._exec_ctx())
        if chunk.num_rows > 1:
            raise PlanError("scalar subquery returned more than one row")
        if chunk.num_rows == 0:
            return B.lit(None)
        col = chunk.columns[0]
        if not col.validity[0]:
            return B.lit(None)
        if col.dtype.is_string:
            # decode to a plain string literal so downstream lowering maps
            # it into the OUTER table's dictionary space
            return Const(col.dtype.with_nullable(False), col.to_python()[0])
        v = col.data[0]
        v = v.item() if hasattr(v, "item") else v
        return Const(col.dtype.with_nullable(False), v)

    def _exec_ctx(self) -> P.ExecContext:
        """Statement-scoped execution context with a fresh memory tracker
        rooted at tidb_mem_quota_query (util/memory Tracker analog).  The
        JAX package's engine knobs (scheduler, result cache, faults, ...)
        tune parts of its client the port's does not have yet."""
        from ..utils.memory import Tracker
        merged = {**self.domain.sysvars, **self.vars}
        quota = int(merged.get("tidb_mem_quota_query", 1 << 30))
        if quota <= 0:
            quota = -1       # TiDB semantics: 0/negative = unlimited
        return P.ExecContext(self.domain.client, merged,
                             mem_tracker=Tracker("query", quota))

    def _exec_select(self, stmt) -> ResultSet:
        built, phys = self._plan_select(stmt)
        t0 = time.perf_counter()
        chunk = phys.execute(self._exec_ctx())
        t1 = time.perf_counter()
        n_out = len(built.output_names)
        cols = chunk.columns[:n_out]  # trim hidden ORDER BY columns
        rows = list(zip(*[c.to_python() for c in cols])) if cols else []
        self.timings["execute"] = t1 - t0
        self.timings["decode"] = time.perf_counter() - t1
        return ResultSet(built.output_names, rows,
                         dtypes=[c.dtype for c in cols])

    def _exec_explain(self, stmt: A.Explain) -> ResultSet:
        if not isinstance(stmt.stmt, (A.SelectStmt, A.SetOpStmt)):
            raise PlanError("EXPLAIN supports SELECT only")
        if stmt.analyze:
            raise unported("EXPLAIN ANALYZE (runtime statistics)", CONTROL)
        _built, phys = self._plan_select(stmt.stmt)
        rows = [(line,) for line in phys.explain().split("\n")]
        return ResultSet(["plan"], rows)


def _flag_on(merged: dict, name: str, default: bool = True) -> bool:
    """Boolean sysvar semantics tolerant of ON/OFF/1/0/None values."""
    v = merged.get(name)
    if v is None:
        return default
    try:
        return int(v) != 0
    except (TypeError, ValueError):
        return str(v).strip().lower() in ("on", "true", "1", "yes")


__all__ = ["Session", "Domain", "ResultSet", "check_ported"]
