# ported from tidb_tpu/session/session.py @ 3951242
# (windows, ANALYZE, auto-analyze and SHOW from the same file @ 6298005)
# (privileges, KILL, the plan cache, bindings and PREPARE from the same
# file @ 6233200)
# (the resource-group statements and the statement's resource-group
# charge from the same file @ f4efee1)
"""Session: statement lifecycle.

Reference analog: pkg/session (session.ExecuteStmt, session.go:2112) —
parse -> plan -> execute, returning a RecordSet.  The Domain analog
(shared catalog + row store + devices + cop client per process) is
session.session.Domain.

The port's session runs the JAX package's statements but those of later
slices: ``SELECT`` (with ``FOR UPDATE``), ``EXPLAIN`` and ``EXPLAIN ANALYZE``
(utils/execdetails), ``TRACE``, ``PLAN REPLAYER DUMP``, ``SET`` and
``USE``; the write statements over the port's
own KV row store (``INSERT`` with ``ON DUPLICATE KEY UPDATE``,
``REPLACE`` and ``IGNORE``, ``LOAD DATA``, ``UPDATE`` and ``DELETE``
with ``ORDER BY``/``LIMIT`` and the foreign-key actions); transactions
(``BEGIN``/``COMMIT``/``ROLLBACK``, optimistic and pessimistic, with a
savepoint a statement); and the DDL (``CREATE``/``DROP``
``TABLE``/``DATABASE``, ``TRUNCATE``, ``ALTER TABLE``, online ``CREATE
INDEX``/``DROP INDEX`` through the DDL owner) with ``ADMIN CHECK
TABLE``; views, sequences (``NEXTVAL``/``LASTVAL``/``SETVAL`` through
the host evaluator), ``SPLIT TABLE`` and partitioned tables (pruned at
plan time, planner/partition_prune.py); in a SELECT, ``WITH ROLLUP``,
``UNION``/``INTERSECT``/``EXCEPT``, CTEs and window functions;
``ANALYZE TABLE`` (the statistics kernel on the card, stats/) and the
``SHOW`` kinds ``CREATE TABLE``, ``TABLES``, ``DATABASES``,
``COLUMNS``, ``INDEX``, ``STATS_META``, ``STATS_HISTOGRAMS``,
``STATS_TOPN``, ``COLLATION``, ``CHARSET``, ``VARIABLES``, ``GRANTS``,
``PROCESSLIST``, ``BINDINGS``, ``STATEMENTS_SUMMARY``, ``SLOW_QUERIES``
and ``STATUS``; users and grants (``CREATE``/``ALTER``/
``DROP USER``, ``GRANT``, ``REVOKE``, ``FLUSH``, each statement checked
against the privilege manager), ``KILL``, ``PREPARE``/``EXECUTE``/
``DEALLOCATE``, optimizer hints and ``CREATE``/``DROP BINDING``.  Its
``_plan_select`` is the JAX package's, the plan cache, the plan-time
gates and the cascades planner (``tidb_enable_cascades_planner``,
``planner/cascades/``) included: the inline auto-analyze,
the join reorder, the index paths and the high-NDV strategy choice read
the domain's statistics.  The port's ``Domain`` starts with
``tidb_enable_auto_analyze = 0`` (the JAX package's default is 1), and
its background stats load runs only with it on, so a session that never
runs ANALYZE plans as the JAX package's does with auto-analyze off.  Every statement
is observed as the JAX package's is: with ``tidb_tpu_trace`` on (the
default) ``execute`` roots a span tree at ``session.ExecuteStmt`` and
binds ``obs.trace.TRACE_CTX`` for it, so the client's and the
scheduler drain's spans stitch under it; at the statement's end the
tree is flagged (``degraded``, ``retried``, ``failed``, ``slow``), the
domain's ``stmt_summary`` records the statement (its latency, rows, CPU
time, plan digest and the scheduler's columns from the QueryHandle)
and its ``flight_recorder`` offers the tree.  The memtables of
``information_schema`` and ``performance_schema`` answer, as does
``ADMIN RECOMMEND INDEX`` (planner/advisor over the statement summary).
The resource-group statements (``CREATE``/``ALTER``/``DROP RESOURCE
GROUP``, ``SET RESOURCE GROUP``) manage the domain's groups (rc/), and
each statement is charged to its group at its end, under the runaway
watch (``_charge_resource_group``).  The SHOW kinds of later slices
raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from .. import HOST_SURFACE, unported
from ..copr.coordinator import KILL_EVENT, QUERY_HANDLE, Coordinator
from ..executor import physical as P
from ..executor.plan import STATS_HANDLE, to_physical
from ..obs import trace as _obs_trace
from ..planner.join_reorder import reorder_joins
from ..planner.build import (PLAN_TAINTS, SEQUENCE_RESOLVER, SESSION_INFO,
                             SUBQUERY_EXECUTOR, PlanError, build_query)
from ..planner.optimize import optimize_plan
from ..sched.task import SCHED_GROUP
from ..planner.ranger import apply_index_paths
from ..sql import ast as A
from ..sql.parser import parse_sql
from ..store.client import CopClient
from ..store.kv import KVError
from ..types import dtypes as dt
from .catalog import (TEMP_TABLES, Catalog, CatalogError, TableInfo,
                      plainify, type_from_sql)
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



def _knob(merged: dict, name: str):
    """A sysvar's value, or None when unset or empty."""
    v = merged.get(name)
    return None if v is None or v == "" else v


def _apply_sched_knobs(client, merged: dict) -> None:
    """The device scheduler's, resource control's, calibration's, memory
    ledger's, topology view's and program cache's sysvars onto the
    client, as the JAX package's session applies them (-1 = keep the
    engine default)."""
    v = _knob(merged, "tidb_tpu_sched_queue_depth")
    if v is not None and int(v) >= 0:
        client.sched_queue_depth = int(v)       # 0 bypasses admission
    v = _knob(merged, "tidb_tpu_sched_max_coalesce")
    if v is not None and int(v) > 0:
        client.sched_max_coalesce = int(v)
    v = _knob(merged, "tidb_tpu_sched_fusion")
    if v is not None:
        client.sched_fusion = bool(int(v))
    v = _knob(merged, "tidb_tpu_sched_window_us")
    if v is not None and int(v) >= -1:
        client.sched_window_us = int(v)
    v = _knob(merged, "tidb_tpu_sched_hbm_budget")
    if v is not None and int(v) >= -1:
        client.sched_hbm_budget = int(v)
    v = _knob(merged, "tidb_tpu_rc_enable")
    if v is not None:
        client.rc_enable = bool(int(v))
    v = _knob(merged, "tidb_tpu_rc_overdraft_ru")
    if v is not None and int(v) >= 0:
        client.rc_overdraft = float(v)
    v = _knob(merged, "tidb_tpu_cost_calibration")
    if v is not None:
        client.calibration = bool(int(v))
    v = _knob(merged, "tidb_tpu_hbm_ledger")
    if v is not None:
        client.hbm_ledger = bool(int(v))
    # shardflow topology view (parallel/topology): declared host
    # factorization for per-link transfer classification; -1/unset
    # derives it from the devices
    v = _knob(merged, "tidb_tpu_topology_hosts")
    if v is not None:
        from ..parallel.topology import set_host_view
        set_host_view(None if int(v) <= 0 else int(v))
    from ..compilecache import configure as cc_configure
    from ..compilecache import maybe_warm_start
    v11 = _knob(merged, "tidb_tpu_compile_cache")
    v12 = _knob(merged, "tidb_tpu_compile_cache_dir")
    v13 = _knob(merged, "tidb_tpu_compile_warm_pool")
    cc_configure(
        enable=None if v11 is None else bool(int(v11)),
        cache_dir=None if v12 is None else str(v12),
        pool_bytes=None if v13 is None or int(v13) < 0 else int(v13))
    maybe_warm_start(client)


class Domain:
    """Per-process state (pkg/domain analog): catalog + the native KV row
    store + the port's ``CopClient`` + statistics + sysvars + the
    metadata locks, the AUTO_INCREMENT service, the online-DDL owner and
    the query coordinator.

    ``device`` and ``n_devices`` go to ``CopClient``: the default is one
    ``cuda:0`` and raises without a GPU; tests pass ``device="cpu"``.
    ``data_dir`` makes the store durable (a WAL-backed engine and the
    catalog on KV, so schema and rows survive a new ``Domain`` over the
    same directory); ``sync`` fdatasyncs every commit record.  ``stats``
    holds the tables' statistics, built on the client's first device.
    ``privileges`` holds users and grants, ``plan_cache`` the instance
    plan cache, ``bindings`` the GLOBAL plan bindings; the watch plane
    (``watch``) carries ``SET GLOBAL`` and the grant tables, persisted
    in a durable store so both survive a reopen.  ``register_session``
    keeps a weak registry of the sessions for ``SHOW PROCESSLIST`` and
    ``KILL``.  ``resource_groups`` holds the resource groups (``default``,
    unlimited, and those the resource-group statements make), whose live
    object each statement binds for the device scheduler
    (``sched.SCHED_GROUP``).
    ``stmt_summary`` holds the statement summary and the slow log,
    ``flight_recorder`` the statements' span trees.  ``pd`` holds the
    Domain's coordinator on the coordination plane (pd/) once
    ``tidb_tpu_pd = 1``: Domains in one process, or server processes
    with one ``tidb_tpu_pd_dir``, then share one RU budget, program
    claims, quarantine tombstones and calibration.  ``start_background``
    starts the background workers on the timer framework (GC, TTL,
    auto-analyze, the workload repository: ``timers``, stopped by
    ``close``); ``dxf`` is the distributed task framework's manager.
    Registered extensions (``extension``) boot with the Domain.  The
    JAX package's Domain also takes a tenant keyspace; the port's does
    not."""

    def __init__(self, device="cuda", n_devices: int = 1,
                 data_dir: Optional[str] = None, sync: bool = False):
        from ..store.kv import KVStore
        self.catalog = Catalog()
        self.catalog.domain = self          # memtable binding (infoschema)
        self.client = CopClient(device, n_devices)
        if data_dir is not None:
            # durable mode: WAL-backed native engine + catalog-on-KV, so
            # data, schema, and DDL-job state all survive restart
            import os as _os
            _os.makedirs(data_dir, exist_ok=True)
            self.kv = KVStore(path=_os.path.join(data_dir, "kv"),
                              sync=sync)
            from .meta import attach
            self.meta = attach(self.catalog, self.kv)
            self.meta.load_catalog(self.catalog)
            # resume table-id allocation above every persisted table so a
            # new table never reuses a live (or dropped) key range
            max_id = 100
            for tables in self.catalog.databases.values():
                for t in tables.values():
                    max_id = max(max_id, t.table_id)
            max_id = max(max_id, self.meta.load_max_dropped_id())
            self._next_table_id = max_id
        else:
            self.kv = KVStore()              # native C++ MVCC store
            self.meta = None
            self._next_table_id = 100
        self.schema_version = 1                # bumped per DDL transition
        from ..ddl.mdl import MDLRegistry
        self.mdl = MDLRegistry()               # pkg/ddl/mdl analog
        self.coordinator = Coordinator()       # mppcoordmanager analog
        from ..rc.controller import ResourceGroupManager
        self.resource_groups = ResourceGroupManager()
        self._ddl = None
        self._ddl_mu = threading.Lock()
        # leaf lock for the domain's id allocators (table ids, conn
        # ids): CREATE TABLE and new connections arrive on concurrent
        # statement threads, and a bare += there loses allocations
        self._id_mu = threading.Lock()
        self._next_conn_id = 0
        self.sysvars: dict[str, Any] = defaults()
        # the globals a SET GLOBAL gave a value (this process's, a
        # reloaded one's or another process's): the knobs the port's
        # client takes only when asked (tidb_tpu_sched_host_fallback)
        self.sysvars_set: set[str] = set()
        from ..stats.handle import StatsHandle
        # per-table statistics (ANALYZE), built on the client's card
        self.stats = StatsHandle(self.client.devices[0])
        # the JAX package's default is 1; the port starts with the
        # inline auto-analyze off, so a session that never runs ANALYZE
        # or sets it on plans as over tables never analyzed
        self.sysvars["tidb_enable_auto_analyze"] = 0
        from ..privilege import PrivilegeManager
        self.privileges = PrivilegeManager()   # pkg/privilege Handle analog
        # etcd-style watch plane (domain.go GlobalVarsWatcher analog):
        # durable domains persist channel logs in the shared KV so other
        # processes on the same store observe SET GLOBAL / GRANT without
        # polling system tables; in-memory domains deliver in-process
        from ..utils.watch import WatchHub
        self.watch = WatchHub(self.kv if data_dir is not None else None)
        self.watch.subscribe("sysvar", self._on_sysvar_event)
        self.watch.subscribe("privilege", self._on_privilege_event)
        from ..planner.plan_cache import PlanCache
        self.plan_cache = PlanCache()          # instance plan cache
        from ..utils.stmtsummary import StmtSummary
        self.stmt_summary = StmtSummary()   # util/stmtsummary analog
        # copscope flight recorder (obs/): bounded ring of completed
        # statement traces — failed/degraded/quarantined/slow always
        # kept, the rest sampled; served at /trace on the StatusServer
        from ..obs import FlightRecorder
        self.flight_recorder = FlightRecorder()
        from ..planner.bindinfo import BindManager
        self.bindings = BindManager()          # GLOBAL plan bindings
        self._sessions = None                  # WeakValueDictionary, lazy
        self._load_global_sysvars()      # durable SET GLOBALs survive restart
        self._on_privilege_event({})     # durable users/grants reload
        from .autoid import AutoIDService
        self.autoid = AutoIDService(self.kv)  # pkg/autoid_service analog
        for _tables in self.catalog.databases.values():
            for _t in _tables.values():       # durable-load rebind
                _t._autoid = self.autoid
        # coplace coordination plane (pd/): the Domain's PdCoordinator
        # slot — attached by pd.configure_domain when tidb_tpu_pd = 1
        # (this Domain then models ONE server process of the fleet)
        self.pd = None
        self.timers = None               # start_background's framework
        from ..extension import registry as _ext_registry
        _ext_registry.setup_domain(self)   # pkg/extension bootstrap point
        # workload repository (util/workloadrepo): periodic snapshots of
        # the statement summary, queryable via
        # information_schema.workload_repo_statements
        self.workload_repo: list = []

    # ---------------- watch plane (etcd-channel analogs) ---------------- #

    _GVAR_PREFIX = b"m\x00gvar\x00"
    _PRIV_KEY = b"m\x00privsnap"

    def set_global_sysvar(self, name: str, value) -> None:
        """SET GLOBAL: apply locally, persist (durable mode), and
        broadcast on the sysvar watch channel."""
        self.sysvars[name] = value
        self.sysvars_set.add(name)
        if self.meta is not None:
            import json as _json
            txn = self.kv.begin()
            txn.put(self._GVAR_PREFIX + name.encode(),
                    _json.dumps(value, default=str).encode())
            txn.commit()
        self.watch.notify("sysvar", {"name": name, "value": value})

    def _load_global_sysvars(self) -> None:
        if self.meta is None:
            return
        import json as _json
        pre = self._GVAR_PREFIX
        for k, v in self.kv.scan(pre, pre + b"\xff", self.kv.alloc_ts()):
            try:
                name = k[len(pre):].decode()
                self.sysvars[name] = _json.loads(v)
                self.sysvars_set.add(name)
            except ValueError:
                pass

    def _on_sysvar_event(self, p: dict) -> None:
        name = p.get("name")
        if name:
            self.sysvars[name] = p.get("value")
            self.sysvars_set.add(name)

    def broadcast_privileges(self) -> None:
        """After GRANT/REVOKE/CREATE USER...: persist the privilege
        snapshot and nudge the watch channel (privilege cache
        invalidation, privileges.Handle update channel analog)."""
        if self.meta is not None:
            txn = self.kv.begin()
            txn.put(self._PRIV_KEY, self.privileges.snapshot().encode())
            txn.commit()
        self.watch.notify("privilege", {})

    def _on_privilege_event(self, p: dict) -> None:
        if self.meta is None:
            return
        blob = self.kv.get(self._PRIV_KEY, self.kv.alloc_ts())
        if blob:
            try:
                self.privileges.load_snapshot(blob.decode())
            except ValueError:
                pass

    @property
    def ddl(self):
        """Lazily-started online-DDL owner (pkg/ddl analog)."""
        if self._ddl is None:
            with self._ddl_mu:
                if self._ddl is None:
                    from ..ddl import DDLExecutor
                    self._ddl = DDLExecutor(self)
        return self._ddl

    @property
    def dxf(self):
        """Lazily-created distributed task framework manager
        (pkg/disttask analog)."""
        m = getattr(self, "_dxf", None)
        if m is None:
            from ..dxf.tasks import manager_for
            m = self._dxf = manager_for(self)
        return m

    def start_background(self):
        """Start the domain's background workers (domain.go:146 Init
        analog): GC, TTL, auto-analyze on the timer framework."""
        if self.timers is not None:
            return self.timers
        from ..store.gcworker import GCWorker
        from ..timer import TimerFramework
        from ..ttl import run_ttl_sweep
        life = float(self.sysvars.get("tidb_gc_life_time_sec", 600))
        self.gc_worker = GCWorker(self.kv, life)
        self.timers = TimerFramework()
        self.timers.register(
            "gc", float(self.sysvars.get("tidb_gc_run_interval_sec", 60)),
            self.gc_worker.run_once)
        self.timers.register(
            "ttl", float(self.sysvars.get("tidb_ttl_job_interval_sec", 60)),
            lambda: run_ttl_sweep(self))
        self.timers.register("auto-analyze", 30.0, self._auto_analyze_sweep)
        self.timers.register("workload-repo", 60.0,
                             self.snapshot_workload_repo)
        self.timers.start()
        return self.timers

    def snapshot_workload_repo(self):
        """Workload repository sweep (pkg/util/workloadrepo): persist a
        timestamped snapshot of the statement summary so workload history
        survives summary eviction; bounded ring."""
        now = time.time()
        for row in self.stmt_summary.summary_rows():
            self.workload_repo.append((now,) + tuple(row[:5]))
        if len(self.workload_repo) > 50_000:
            del self.workload_repo[:25_000]

    def _auto_analyze_sweep(self):
        """Background auto-analyze (handle/autoanalyze.go worker), gated
        as the inline one and the stats load are: the port's Domain
        starts with ``tidb_enable_auto_analyze = 0``."""
        if not _flag_on(self.sysvars, "tidb_enable_auto_analyze"):
            return
        for db, tables in list(self.catalog.databases.items()):
            for tbl in list(tables.values()):
                if self.stats.needs_auto_analyze(tbl):
                    self.stats.analyze_table(tbl)

    def close(self):
        if self.timers is not None:
            self.timers.close()
        if self._ddl is not None:
            self._ddl.close()

    def alloc_table_id(self) -> int:
        with self._id_mu:
            self._next_table_id += 1
            return self._next_table_id

    def query_metrics(self):
        """Cached (counter, histogram) pair for the statement hot path."""
        m = getattr(self, "_query_metrics", None)
        if m is None:
            from ..utils.metrics import global_registry
            reg = global_registry()
            m = self._query_metrics = (
                reg.counter("tidb_tpu_query_total", "statements executed",
                            labels=("type",)),
                reg.histogram("tidb_tpu_query_duration_seconds",
                              "statement latency"))
        return m

    def register_session(self, sess) -> int:
        """Connection registry for SHOW PROCESSLIST (server's
        SessionManager analog)."""
        import weakref
        with self._id_mu:
            if self._sessions is None:
                self._sessions = weakref.WeakValueDictionary()
            self._next_conn_id += 1
            self._sessions[self._next_conn_id] = sess
            return self._next_conn_id

    def sessions(self):
        with self._id_mu:
            if self._sessions is None:
                return []
            return sorted(self._sessions.items())


class Session:
    """``timings`` holds the wall-clock seconds of the last SELECT or
    EXPLAIN by phase: ``parse``, ``plan`` (build, optimize and the
    physical plan, or the plan cache's lookup on a hit), then for a
    SELECT ``execute`` (the executor tree, the client's work included;
    its own split is ``domain.client.timings``) and ``decode`` (the
    result's columns into python rows).

    A text SELECT's plan is cached in ``domain.plan_cache``, keyed on its
    text (``tidb_enable_plan_cache``, on by default); ``bindings`` holds
    the SESSION plan bindings, ``prepared`` the ``PREPARE``d
    statements."""

    def __init__(self, domain: Optional[Domain] = None, db: str = "test",
                 user: str = "root"):
        self.domain = domain or Domain()
        self.conn_id = self.domain.register_session(self)
        self.db = db
        self.user = user
        self.vars: dict[str, Any] = {}
        self.user_vars: dict[str, Any] = {}      # SET @x = ...
        from ..planner.bindinfo import BindManager
        self.bindings = BindManager()            # SESSION plan bindings
        self.prepared: dict[str, tuple[str, int]] = {}  # name -> (sql, n_params)
        self._cur_sql: Optional[str] = None      # text of the running stmt
        self._last_plan_text = ""                # Top-SQL plan digest
        self.timings: dict = {}
        self.txn = None              # active explicit transaction
        self._txn_tables: set = set()
        self.last_insert_id = 0
        # session-scoped temporary tables: (db, name) -> TableInfo;
        # installed as a catalog overlay per statement (catalog.TEMP_TABLES)
        self.temp_tables: dict = {}
        self._kill_event = threading.Event()   # statement start clears

    def close(self) -> None:
        """Drop session state that outlives no session: temporary tables
        (their KV rows truncate so the shared store does not leak)."""
        for t in list(self.temp_tables.values()):
            try:
                t.truncate()
            except Exception:
                pass
        self.temp_tables.clear()

    # ------------------------------------------------------------- #

    def execute(self, sql: str) -> ResultSet:
        from ..plugin import registry as _plugins
        qcnt, qdur = self.domain.query_metrics()
        t0 = time.perf_counter()
        stmts = parse_sql(sql)
        parse_s = (time.perf_counter() - t0) / max(len(stmts), 1)
        out = ResultSet()
        for stmt in stmts:
            t0 = time.perf_counter_ns()
            span = getattr(stmt, "text_span", None)
            text = sql[span[0]:span[1]].strip() if span else sql
            self.timings = {"parse": parse_s}
            self._cur_sql = text
            # plan bindings: a matching digest donates its hints
            # (bindinfo BindHandle match; session shadows global).
            # EXPLAIN shows the bound plan too.
            target, btext = stmt, text
            if isinstance(stmt, (A.Explain, A.TraceStmt)):
                target = stmt.stmt
                import re as _re
                btext = _re.sub(r"(?is)^\s*(explain(\s+analyze)?|trace)\s+",
                                "", text)
            if isinstance(target, A.SelectStmt) and not target.hints:
                b = (self.bindings.match(btext)
                     or self.domain.bindings.match(btext))
                if b is not None:
                    target.hints = list(b.hints)
                    # bound statements bypass the plan cache: a cached
                    # unhinted plan must not shadow the binding (and
                    # vice versa after DROP BINDING)
                    self._cur_sql = None
            _plugins.fire("on_stmt_begin", self, text)
            cpu0 = time.thread_time_ns()    # Top-SQL CPU attribution
            self._last_plan_text = ""
            self._kill_event.clear()
            handle = self.domain.coordinator.begin(self.conn_id, text)
            ktok = KILL_EVENT.set(self._kill_event)
            htok = QUERY_HANDLE.set(handle)
            # tag device cop tasks with the statement's resource group so
            # the admission scheduler orders them weighted-fair and can
            # enforce the group's RU bucket at the drain (rc/)
            gname = self.vars.get("tidb_resource_group") or \
                self.domain.sysvars.get("tidb_resource_group", "default")
            grp = self.domain.resource_groups.get(gname)
            gtok = SCHED_GROUP.set(
                (gname, grp.sched_weight if grp is not None else 8.0, grp))

            def _getvar(name, scope=""):
                if scope == "global":
                    return self.domain.sysvars.get(name)
                merged = {**self.domain.sysvars, **self.vars}
                if name in merged:
                    return merged[name]
                ent = REGISTRY.get(name)
                return ent.default if ent is not None else None

            # copscope statement trace (obs/): one span tree per
            # statement, rooted here; the TraceCtx contextvar carries it
            # into every dispatch so scheduler threads stitch their
            # spans under it.  Off (tidb_tpu_trace=0) = no tree, no
            # contextvar, zero recording anywhere.
            merged_obs = {**self.domain.sysvars, **self.vars}
            trace_tree = None
            trace_root = None
            obs_tok = None
            if _flag_on(merged_obs, "tidb_tpu_trace", True):
                trace_tree = _obs_trace.SpanTree(sql=text,
                                                 conn_id=self.conn_id)
                trace_root = trace_tree.begin("session.ExecuteStmt")
                obs_tok = _obs_trace.TRACE_CTX.set(
                    _obs_trace.TraceCtx(trace_tree, trace_root))
            stok = SESSION_INFO.set({
                "db": self.db, "user": self.user,
                "conn_id": self.conn_id,
                "last_insert_id": self.last_insert_id,
                "row_count": getattr(self, "_row_count", -1),
                "found_rows": getattr(self, "_found_rows", 0),
                "getvar": _getvar,
                "getuservar":
                    lambda name, _s="": self.user_vars.get(name)})
            qtok = SEQUENCE_RESOLVER.set(
                lambda nm: self.domain.catalog.get_sequence(self.db, nm))
            ttok = TEMP_TABLES.set(self.temp_tables)
            try:
                out = self._exec_stmt(stmt)
            except Exception as e:
                qcnt.inc(type="error")
                _plugins.fire("on_stmt_end", self, text, str(e),
                              (time.perf_counter_ns() - t0) / 1e9, 0)
                raise
            finally:
                TEMP_TABLES.reset(ttok)
                SEQUENCE_RESOLVER.reset(qtok)
                SESSION_INFO.reset(stok)
                SCHED_GROUP.reset(gtok)
                QUERY_HANDLE.reset(htok)
                KILL_EVENT.reset(ktok)
                if obs_tok is not None:
                    _obs_trace.TRACE_CTX.reset(obs_tok)
                    trace_tree.end(trace_root)
                    trace_tree.latency_ms = \
                        (time.perf_counter_ns() - t0) / 1e6
                    if handle.degraded:
                        trace_tree.flag("degraded")
                    if handle.sched_retried:
                        trace_tree.flag("retried")
                    if sys.exc_info()[0] is not None:
                        # failed statements ALWAYS reach the recorder —
                        # the success path records after the slow-log
                        # verdict below
                        trace_tree.flag("failed")
                        self.domain.flight_recorder.record(trace_tree)
                self.domain.coordinator.end(self.conn_id)
                self._cur_sql = None
            dt_ns = time.perf_counter_ns() - t0
            qcnt.inc(type=type(stmt).__name__)
            qdur.observe(dt_ns / 1e9)
            # slow-log threshold is live sysvar state (session scope
            # shadows global), plumbed session -> Domain on each record
            try:
                self.domain.stmt_summary.slow_threshold_ms = float(
                    merged_obs.get("tidb_tpu_slow_threshold_ms", 300)
                    or 0)
                self.domain.flight_recorder.sample_every = max(int(
                    merged_obs.get("tidb_tpu_trace_sample", 16) or 16),
                    1)
            except (TypeError, ValueError):
                pass
            was_slow = self.domain.stmt_summary.record(
                text, dt_ns, len(out.rows),
                cpu_ns=time.thread_time_ns() - cpu0,
                plan_text=self._last_plan_text,
                sched_wait_ns=handle.sched_wait_ns,
                rus=handle.sched_rus,
                compile_ns=handle.compile_ns,
                sched_tasks=handle.sched_tasks,
                fused=handle.sched_fused,
                retried=handle.sched_retried,
                trace_id=trace_tree.trace_id
                if trace_tree is not None else "")
            if trace_tree is not None:
                if was_slow:
                    trace_tree.flag("slow")
                self.domain.flight_recorder.record(trace_tree)
            try:
                # runaway KILL must fire before the success audit hook:
                # a killed statement is an error to the client
                self._charge_resource_group(stmt, out, dt_ns / 1e9,
                                            handle)
            except Exception as e:
                _plugins.fire("on_stmt_end", self, text, str(e),
                              dt_ns / 1e9, 0)
                raise
            _plugins.fire("on_stmt_end", self, text, None, dt_ns / 1e9,
                          len(out.rows) + out.affected)
            # ROW_COUNT()/FOUND_ROWS() state (executor/adapter.go
            # affectedRows analogs)
            if out.names:
                self._found_rows = len(out.rows)
                self._row_count = -1
            else:
                self._row_count = out.affected
        return out

    def _charge_resource_group(self, stmt, out: ResultSet,
                               elapsed_sec: float, handle=None) -> None:
        """Statement-boundary resource accounting (rc/controller).
        Device work was priced from its LaunchCost and debited at the
        scheduler drain BEFORE launching (handle.sched_rus reports it);
        host-only statements still charge the row-count RU here.  The
        runaway watch covers queue+execution wall time with actions
        KILL / COOLDOWN / SWITCH_GROUP.  ACTION=KILL only raises for
        statements that did not mutate data: the watch runs
        post-execution, and killing an already-committed DML would
        report failure for persisted writes (the reference aborts
        mid-execution; read-only raise is the safe analog)."""
        gname = self.vars.get("tidb_resource_group") or \
            self.domain.sysvars.get("tidb_resource_group", "default")
        group = self.domain.resource_groups.get(gname)
        if group is None or (group.ru_per_sec <= 0
                             and not group.exec_elapsed_sec):
            return
        from ..rc.controller import charge_statement
        from ..rc.runaway import RunawayError
        rc_on = bool(int(self.domain.sysvars.get(
            "tidb_tpu_rc_enable", 1) or 0))
        device_rus = handle.sched_rus if (
            handle is not None and rc_on) else 0.0
        sched_wait = (handle.sched_wait_ns / 1e9
                      if handle is not None else 0.0)
        try:
            charge_statement(group, len(out.rows) + out.affected,
                             elapsed_sec, sched_wait_sec=sched_wait,
                             device_rus=device_rus,
                             manager=self.domain.resource_groups,
                             sql=handle.sql if handle is not None else "")
        except RunawayError:
            if out.affected:
                return           # counted as runaway, writes stand
            raise

    def must_query(self, sql: str) -> list[tuple]:
        """testkit MustQuery analog."""
        return self.execute(sql).rows

    # ------------------------------------------------------------- #

    # statements that implicitly commit an open transaction first
    _IMPLICIT_COMMIT = ("CreateTable", "DropTable", "CreateIndex",
                        "DropIndex", "AlterTable", "TruncateTable",
                        "CreateDatabase", "DropDatabase", "CreateUser",
                        "AlterUser", "DropUser", "GrantStmt", "RevokeStmt")

    _DDL_STMTS = ("CreateTable", "DropTable", "CreateIndex", "DropIndex",
                  "AlterTable", "TruncateTable", "CreateDatabase",
                  "DropDatabase", "CreateSequence", "DropSequence",
                  "CreateView", "DropView")

    def _exec_stmt(self, stmt: A.Node) -> ResultSet:
        self._check_privileges(stmt)
        if (self.txn is not None
                and type(stmt).__name__ in self._IMPLICIT_COMMIT):
            # MySQL semantics: DDL implicitly commits the open transaction
            self._finish_txn(commit=True)
        if type(stmt).__name__ in self._DDL_STMTS:
            # schema plugin kind (plugin/spi.go SchemaManifest
            # OnSchemaChange): fire only AFTER the DDL succeeded, with
            # the statement's resolved database
            from ..plugin import registry as _plugins
            out = self._dispatch_stmt(stmt)
            if isinstance(stmt, (A.CreateDatabase, A.DropDatabase)):
                ev_dbs = [stmt.name]        # the db IS the target
            elif isinstance(stmt, A.DropTable) and stmt.names:
                # one event per distinct database a multi-table DROP
                # touches, so per-schema plugins observe every change
                ev_dbs = list(dict.fromkeys(
                    db or self.db for db, _nm in stmt.names))
            else:
                ev_dbs = [getattr(stmt, "db", None) or self.db]
            for ev_db in ev_dbs:
                _plugins.fire("on_ddl", type(stmt).__name__, ev_db,
                              self._cur_sql or "")
            return out
        return self._dispatch_stmt(stmt)

    def _dispatch_stmt(self, stmt: A.Node) -> ResultSet:
        if isinstance(stmt, (A.CreateUser, A.AlterUser, A.DropUser,
                             A.GrantStmt, A.RevokeStmt, A.FlushStmt)):
            return self._exec_user_admin(stmt)
        if isinstance(stmt, (A.SelectStmt, A.SetOpStmt)):
            return self._exec_select(stmt)
        if isinstance(stmt, A.CreateBinding):
            return self._exec_create_binding(stmt)
        if isinstance(stmt, A.CreateResourceGroup):
            try:
                if stmt.replace:      # ALTER: merge named options only
                    self.domain.resource_groups.alter(
                        stmt.name, stmt.ru_per_sec, stmt.burstable,
                        stmt.exec_elapsed_sec, stmt.action,
                        priority=stmt.priority,
                        switch_target=stmt.switch_target)
                else:
                    self.domain.resource_groups.create(
                        stmt.name, stmt.ru_per_sec, stmt.burstable,
                        stmt.exec_elapsed_sec, stmt.action,
                        if_not_exists=stmt.if_not_exists,
                        priority=stmt.priority,
                        switch_target=stmt.switch_target)
            except ValueError as e:
                raise PlanError(str(e))
            return ResultSet()
        if isinstance(stmt, A.DropResourceGroup):
            try:
                self.domain.resource_groups.drop(stmt.name, stmt.if_exists)
            except ValueError as e:
                raise PlanError(str(e))
            return ResultSet()
        if isinstance(stmt, A.SetResourceGroup):
            if self.domain.resource_groups.get(stmt.name) is None:
                raise PlanError(f"unknown resource group {stmt.name!r}")
            self.vars["tidb_resource_group"] = stmt.name
            return ResultSet()
        if isinstance(stmt, A.DropBinding):
            mgr = (self.domain.bindings if stmt.scope == "global"
                   else self.bindings)
            return ResultSet(affected=int(mgr.drop(stmt.original_sql)))
        if isinstance(stmt, A.KillStmt):
            return self._exec_kill(stmt)
        if isinstance(stmt, A.PrepareStmt):
            from ..sql.bind import count_placeholders, strip_placeholders
            parse_sql(strip_placeholders(stmt.sql))  # validate syntax now
            self.prepared[stmt.name] = (stmt.sql,
                                        count_placeholders(stmt.sql))
            return ResultSet()
        if isinstance(stmt, A.ExecutePrepared):
            return self._exec_prepared(stmt)
        if isinstance(stmt, A.DeallocateStmt):
            if stmt.name not in self.prepared:
                raise PlanError(f"unknown prepared statement {stmt.name!r}")
            del self.prepared[stmt.name]
            return ResultSet()
        if isinstance(stmt, A.Explain):
            return self._exec_explain(stmt)
        if isinstance(stmt, A.TraceStmt):
            return self._exec_trace(stmt)
        if isinstance(stmt, A.PlanReplayerDump):
            return self._exec_plan_replayer(stmt)
        if isinstance(stmt, A.CreateTable):
            return self._exec_create_table(stmt)
        if isinstance(stmt, A.DropTable):
            return self._exec_drop_table(stmt)
        if isinstance(stmt, A.SplitTable):
            tbl = self.domain.catalog.get_table(
                getattr(stmt, 'db', None) or self.db, stmt.table)
            tbl.split_regions(stmt.regions)
            return ResultSet(affected=stmt.regions)
        if isinstance(stmt, A.CreateSequence):
            from .catalog import SequenceInfo
            seq = SequenceInfo(stmt.name, self.db, start=stmt.start,
                               increment=stmt.increment,
                               min_value=stmt.min_value,
                               max_value=stmt.max_value, cache=stmt.cache,
                               cycle=stmt.cycle, kv=self.domain.kv)
            self.domain.catalog.create_sequence(self.db, seq,
                                                stmt.if_not_exists)
            return ResultSet()
        if isinstance(stmt, A.DropSequence):
            self.domain.catalog.drop_sequence(self.db, stmt.name,
                                              stmt.if_exists)
            return ResultSet()
        if isinstance(stmt, A.CreateView):
            from .catalog import ViewInfo
            self.domain.catalog.create_view(
                self.db, ViewInfo(stmt.name, list(stmt.columns),
                                  stmt.select_sql), stmt.or_replace)
            return ResultSet()
        if isinstance(stmt, A.DropView):
            for n in stmt.names:
                self.domain.catalog.drop_view(self.db, n, stmt.if_exists)
            return ResultSet()
        if isinstance(stmt, A.CreateDatabase):
            self.domain.catalog.create_database(stmt.name, stmt.if_not_exists)
            return ResultSet()
        if isinstance(stmt, A.DropDatabase):
            self.domain.catalog.drop_database(stmt.name, stmt.if_exists)
            return ResultSet()
        if isinstance(stmt, A.UseDatabase):
            from ..infoschema import is_system_db
            if stmt.name not in self.domain.catalog.databases \
                    and not is_system_db(stmt.name):
                raise CatalogError(f"unknown database {stmt.name!r}")
            self.db = stmt.name
            return ResultSet()
        if isinstance(stmt, A.CreateIndex):
            self.domain.catalog.get_table(getattr(stmt, 'db', None) or self.db, stmt.table)  # exist check
            ddl_db = getattr(stmt, 'db', None) or self.db
            tmp = self.temp_tables.get((ddl_db, stmt.table))
            if tmp is not None:
                # session temp tables never reach the (session-agnostic)
                # DDL owner thread: index synchronously, no online ladder
                tmp.create_index(stmt.name, list(stmt.columns),
                                 stmt.unique, stmt.if_not_exists)
                return ResultSet()
            self.domain.ddl.run_job("add index", ddl_db, stmt.table, {
                "name": stmt.name, "columns": list(stmt.columns),
                "unique": stmt.unique, "if_not_exists": stmt.if_not_exists})
            return ResultSet()
        if isinstance(stmt, A.DropIndex):
            self.domain.catalog.get_table(getattr(stmt, 'db', None) or self.db, stmt.table)
            ddl_db = getattr(stmt, 'db', None) or self.db
            tmp = self.temp_tables.get((ddl_db, stmt.table))
            if tmp is not None:
                ix = tmp.index_by_name(stmt.name)
                if ix is not None:
                    tmp.indexes.remove(ix)
                elif not stmt.if_exists:
                    raise CatalogError(f"unknown index {stmt.name!r}")
                return ResultSet()
            self.domain.ddl.run_job("drop index", ddl_db, stmt.table, {
                "name": stmt.name, "if_exists": stmt.if_exists})
            return ResultSet()
        if isinstance(stmt, A.AlterTable):
            return self._exec_alter(stmt)
        if isinstance(stmt, A.Insert):
            return self._dml_atomic(self._exec_insert, stmt)
        if isinstance(stmt, A.LoadData):
            return self._dml_atomic(self._exec_load_data, stmt)
        if isinstance(stmt, A.Update):
            return self._dml_atomic(self._exec_update, stmt)
        if isinstance(stmt, A.Delete):
            return self._dml_atomic(self._exec_delete, stmt)
        if isinstance(stmt, A.TruncateTable):
            n = self.domain.catalog.get_table(self.db, stmt.name).truncate()
            return ResultSet(affected=n)
        if isinstance(stmt, A.ShowStmt):
            return self._exec_show(stmt)
        if isinstance(stmt, A.AnalyzeTable):
            tbl = self.domain.catalog.get_table(self.db, stmt.name)
            self.domain.stats.analyze_table(
                tbl, columns=stmt.columns or None,
                sample_rate=stmt.sample_rate,
                predicate_only=stmt.predicate_columns)
            return ResultSet()
        if isinstance(stmt, A.SetStmt):
            return self._exec_set(stmt)
        if isinstance(stmt, A.TxnStmt):
            return self._exec_txn(stmt)
        if isinstance(stmt, A.AdminStmt):
            return self._exec_admin(stmt)
        raise unported(f"the {type(stmt).__name__} statement",
                       HOST_SURFACE)

    def _exec_drop_table(self, stmt: A.DropTable) -> ResultSet:
        # names are (db|None, name) tuples; session temporary tables
        # shadow permanent ones and drop without touching the shared
        # catalog
        def split(n):
            db, nm = n
            return (db or self.db, nm)

        remaining = []
        for n in stmt.names:
            db, nm = split(n)
            t = self.temp_tables.pop((db, nm), None)
            if t is not None:
                try:
                    t.truncate()
                except Exception:
                    pass
            else:
                remaining.append(n)
        if stmt.temporary:
            # DROP TEMPORARY TABLE must NEVER touch a permanent table
            # (MySQL semantics: unknown temp names are errors unless
            # IF EXISTS)
            if remaining and not stmt.if_exists:
                miss = ".".join(p for p in remaining[0] if p)
                raise CatalogError(
                    f"unknown temporary table {miss!r}")
            return ResultSet()
        # qualified (db, name) pairs: a same-named table in another
        # database must not suppress the FK guard
        dropping = {split(n) for n in remaining}
        for n in remaining:
            db, nm = split(n)
            refs = [
                (t.name, fk.column)
                for t in self.domain.catalog.databases
                .get(db, {}).values()
                for fk in getattr(t, "foreign_keys", [])
                if fk.ref_table == nm and (db, t.name) not in dropping]
            if refs:
                raise CatalogError(
                    f"Cannot drop table {nm!r}: referenced by a "
                    f"foreign key constraint ({refs[0][0]}."
                    f"{refs[0][1]})")
            self.domain.catalog.drop_table(db, nm, stmt.if_exists)
        return ResultSet()

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
            if stmt.scope == "global":
                # persist + broadcast on the watch plane
                self.domain.set_global_sysvar(name.lower(), v)
            else:
                self.vars[name.lower()] = v
        for name, val in stmt.user_vars:
            self.user_vars[name.lower()] = self._eval_scalar(val)
        return ResultSet()

    def _eval_scalar(self, expr: A.Node):
        """Evaluate a scalar expression (SET @x = ...); subqueries inside
        the expression still pass privilege checks."""
        if isinstance(expr, A.Lit):
            return self._literal_value(expr)
        sel = A.SelectStmt(items=[A.SelectItem(expr)])
        self._check_privileges(sel)
        return self._exec_select(sel).scalar()

    # ---------------- privileges ---------------- #

    # statement class -> required privilege on its target tables
    _STMT_PRIVS = {
        "Insert": "INSERT", "Update": "UPDATE", "Delete": "DELETE",
        "TruncateTable": "DROP", "CreateTable": "CREATE",
        "DropTable": "DROP", "CreateIndex": "INDEX", "DropIndex": "INDEX",
        "AlterTable": "ALTER", "CreateDatabase": "CREATE",
        "DropDatabase": "DROP", "AnalyzeTable": "INSERT",
    }

    def _check_privileges(self, stmt: A.Node) -> None:
        """Statement-level privilege verification (reference:
        planner/core/planbuilder.go visitInfo + privilege.Handle
        RequestVerification)."""
        priv = self.domain.privileges
        if isinstance(stmt, (A.SelectStmt, A.SetOpStmt)):
            for db, tbl in self._referenced_tables(stmt):
                priv.require(self.user, "SELECT", db or self.db, tbl)
            return
        if isinstance(stmt, (A.Explain, A.TraceStmt)):
            return self._check_privileges(stmt.stmt)
        if isinstance(stmt, (A.CreateUser, A.AlterUser, A.DropUser)):
            return priv.require(self.user, "CREATE USER")
        if isinstance(stmt, (A.GrantStmt, A.RevokeStmt)):
            # MySQL requires the granter to hold the privileges granted;
            # unqualified table level ('' db) means the current database
            db = "" if stmt.db == "*" else (stmt.db or self.db)
            table = "" if stmt.table == "*" else stmt.table
            for p in stmt.privs:
                priv.require(self.user, p if p != "ALL" else "SUPER",
                             db, table)
            return
        if isinstance(stmt, A.AdminStmt):
            # reference gates ADMIN behind SUPER (planbuilder.go)
            return priv.require(self.user, "SUPER")
        if isinstance(stmt, A.UseDatabase):
            from ..privilege.manager import PrivilegeError
            if not priv.has_db_access(self.user, stmt.name):
                raise PrivilegeError(
                    f"Access denied for user '{self.user}' to database "
                    f"'{stmt.name}'")
            return
        if isinstance(stmt, A.ShowStmt) and stmt.kind == "grants":
            if stmt.target:
                user = stmt.target.partition("@")[0]
                if user != self.user:
                    return priv.require(self.user, "SUPER")
            return
        kind = type(stmt).__name__
        need = self._STMT_PRIVS.get(kind)
        if need is None:
            return
        if isinstance(stmt, A.Insert) and stmt.select is not None:
            self._check_privileges(stmt.select)
        if isinstance(stmt, (A.Update, A.Delete)):
            # reading columns (WHERE clause, or non-literal SET exprs)
            # additionally requires SELECT (planbuilder visitInfo)
            reads = getattr(stmt, "where", None) is not None or any(
                not isinstance(e, A.Lit)
                for _c, e in getattr(stmt, "assignments", ()))
            if reads:
                priv.require(self.user, "SELECT",
                             getattr(stmt, "db", None) or self.db,
                             getattr(stmt, "table", ""))
        target = getattr(stmt, "table", None) or getattr(stmt, "name", "")
        if isinstance(stmt, A.DropTable):
            for db, nm in stmt.names:
                priv.require(self.user, need, db or self.db, nm)
            return
        if isinstance(stmt, (A.CreateDatabase, A.DropDatabase)):
            return priv.require(self.user, need, stmt.name)
        # db-qualified DDL/DML (CREATE INDEX db.t, ALTER TABLE db.t, ...)
        # must check the QUALIFIED database, not the session one
        db = getattr(stmt, "db", None) or self.db
        priv.require(self.user, need, db, target)

    def _referenced_tables(self, node: A.Node) -> list[tuple]:
        """All (db, table) names a query reads — walks FROM clauses,
        joins, subqueries, CTE bodies (skipping CTE self-references)."""
        out: list[tuple] = []
        cte_names: set = set()

        def walk(n):
            if n is None or not isinstance(n, A.Node):
                return
            if isinstance(n, A.TableName):
                if n.name not in cte_names:
                    out.append((n.db, n.name))
                return
            if isinstance(n, A.CTE):
                cte_names.add(n.name)
            # register CTE names BEFORE visiting FROM clauses that
            # reference them (dataclass field order puts from_ first)
            for cte in getattr(n, "ctes", ()):
                walk(cte)
            for f in getattr(n, "__dataclass_fields__", {}):
                if f == "ctes":
                    continue
                v = getattr(n, f, None)
                if isinstance(v, A.Node):
                    walk(v)
                elif isinstance(v, (list, tuple)):
                    for x in v:
                        if isinstance(x, A.Node):
                            walk(x)
                        elif isinstance(x, tuple):
                            for y in x:
                                if isinstance(y, A.Node):
                                    walk(y)
        walk(node)
        return out

    def _exec_user_admin(self, stmt: A.Node) -> ResultSet:
        priv = self.domain.privileges
        if isinstance(stmt, A.CreateUser):
            for spec, pwd in stmt.users:
                priv.create_user(spec.user, spec.host, pwd,
                                 stmt.if_not_exists)
        elif isinstance(stmt, A.AlterUser):
            for spec, pwd in stmt.users:
                priv.alter_user(spec.user, spec.host, pwd)
        elif isinstance(stmt, A.DropUser):
            for spec in stmt.users:
                priv.drop_user(spec.user, spec.host, stmt.if_exists)
        elif isinstance(stmt, A.GrantStmt):
            db = self.db if stmt.db == "" else stmt.db
            for spec in stmt.users:
                priv.grant(stmt.privs, db, stmt.table, spec.user, spec.host)
        elif isinstance(stmt, A.RevokeStmt):
            db = self.db if stmt.db == "" else stmt.db
            for spec in stmt.users:
                priv.revoke(stmt.privs, db, stmt.table, spec.user, spec.host)
        # FLUSH PRIVILEGES: no-op — the manager is authoritative
        if not isinstance(stmt, A.FlushStmt):
            # persist + broadcast the updated grant tables (watch plane)
            self.domain.broadcast_privileges()
        return ResultSet()

    def _exec_kill(self, stmt) -> ResultSet:
        """KILL [QUERY|CONNECTION] <id>: set the victim's kill event;
        its next cancellation checkpoint (a host operator's chunk
        boundary) raises QueryInterrupted — conn.go killConn +
        mppcoordmanager cancel."""
        sessions = dict(self.domain.sessions())
        target = sessions.get(stmt.conn_id)
        if target is None:
            raise PlanError(f"Unknown thread id: {stmt.conn_id}")
        from ..privilege import PrivilegeError
        if target.user != self.user \
                and not self.domain.privileges.check(self.user, "SUPER"):
            raise PrivilegeError(
                "You are not owner of thread "
                f"{stmt.conn_id} (SUPER required)")
        target._kill_event.set()
        return ResultSet()

    def _exec_create_binding(self, stmt: A.CreateBinding) -> ResultSet:
        """CREATE [GLOBAL|SESSION] BINDING: both statements must parse,
        normalize to the same digest, and the bind side must carry hints."""
        from ..utils.stmtsummary import normalize_sql
        orig = parse_sql(stmt.original_sql)
        bind = parse_sql(stmt.bind_sql)
        if len(orig) != 1 or len(bind) != 1 \
                or not isinstance(bind[0], A.SelectStmt):
            raise PlanError("BINDING takes single SELECT statements")
        if normalize_sql(stmt.original_sql) != normalize_sql(stmt.bind_sql):
            raise PlanError(
                "binding statement digest differs from the original")
        if not bind[0].hints:
            raise PlanError("binding statement carries no optimizer hints")
        mgr = (self.domain.bindings if stmt.scope == "global"
               else self.bindings)
        mgr.create(stmt.original_sql, stmt.bind_sql, bind[0].hints)
        return ResultSet()

    def _exec_prepared(self, stmt: A.ExecutePrepared) -> ResultSet:
        from ..sql.bind import bind_placeholders
        ent = self.prepared.get(stmt.name)
        if ent is None:
            raise PlanError(f"unknown prepared statement {stmt.name!r}")
        sql, n_params = ent
        if len(stmt.using) != n_params:
            raise PlanError(
                f"prepared statement {stmt.name!r} needs {n_params} "
                f"parameters, got {len(stmt.using)}")
        params = []
        for uv in stmt.using:
            if uv.lower() not in self.user_vars:
                raise PlanError(f"user variable @{uv} is not set")
            params.append(self.user_vars[uv.lower()])
        return self.execute(bind_placeholders(sql, params))

    # ------------------------------------------------------------- #

    def _plan_select(self, stmt, cache_sql: Optional[str] = None):
        """Build, optimize and bind the physical plan of a SELECT: the
        JAX package's ``_plan_select`` without the background stats load.
        Behind ``tidb_tpu_verify_plan`` (on by default) the plan passes
        the three plan-time gates before any launch: the operator
        contracts (``contracts.verify_plan``), the sharding flow against
        the devices' topology under the declared host view
        (``shardflow.verify_plan_sharding``) and the value ranges over
        the analyzed statistics (``valueflow.verify_plan_values``); a
        violation raises ``PlanContractError``.  With ``cache_sql`` (a
        text statement's own SELECT) and ``tidb_enable_plan_cache`` on,
        the plan comes from, or goes to, the domain's plan cache (a hit
        skips the gates, as it skips planning)."""
        from ..planner.plan_cache import PlanCacheEntry, table_fingerprint
        t0 = time.perf_counter()
        cache = self.domain.plan_cache
        merged = {**self.domain.sysvars, **self.vars}
        use_cache = (cache_sql is not None
                     and _flag_on(merged, "tidb_enable_plan_cache"))
        if use_cache:
            e = cache.get(cache_sql, self.db, merged, self.domain.catalog)
            if e is not None:
                self.timings["plan"] = time.perf_counter() - t0
                return e.built, e.phys
        # uncorrelated scalar subqueries evaluate eagerly at plan time
        # (EvalSubqueryFirstRow analog); plans that did so are not cached
        # since the folded constant goes stale with the data
        ran_subquery: list = []
        token = SUBQUERY_EXECUTOR.set(
            lambda ast: self._eval_scalar_subquery(ast, ran_subquery))
        token2 = PLAN_TAINTS.set(ran_subquery)
        try:
            built = build_query(stmt, self.domain.catalog, self.db)
        finally:
            SUBQUERY_EXECUTOR.reset(token)
            PLAN_TAINTS.reset(token2)
        self._maybe_auto_analyze(built.plan)
        plan = optimize_plan(built.plan)
        self._note_predicate_columns(plan)
        if _flag_on(merged, "tidb_opt_skew_distinct_agg", default=False):
            from ..planner.rules import rewrite_skew_distinct
            plan = rewrite_skew_distinct(plan)
        if _flag_on(merged, "tidb_enable_cascades_planner", default=False):
            from ..planner.cascades import cascades_optimize
            plan = cascades_optimize(plan, self.domain.stats)
        else:
            plan = reorder_joins(plan, self.domain.stats)
        phys = self._to_physical(apply_index_paths(plan, self.domain.stats))
        try:       # Top-SQL plan digest attribution (util/topsql)
            self._last_plan_text = phys.explain()
        except Exception:
            pass
        # static plan-contract gate (analysis/contracts): reject a plan
        # whose operator contracts disagree BEFORE any launch.
        # PlanContractError is a PlanError, so it surfaces like any
        # planner rejection.  tidb_tpu_verify_plan=0 opts out.
        if _flag_on(merged, "tidb_tpu_verify_plan", default=True):
            from ..analysis.contracts import verify_plan
            verify_plan(phys)
            # sharding-flow pass (analysis/shardflow): layouts and
            # collectives of every device program flowed against the
            # devices' typed-link topology (declared host view included)
            # — implicit reshards, unknown axes, coordinator-routed
            # merges, and DCI blow-ups reject HERE, before any launch
            from ..analysis.shardflow import verify_plan_sharding
            verify_plan_sharding(phys, self._topology(merged))
            # value-range pass (analysis/valueflow): every device lane
            # flowed over stats-seeded integer intervals — silent int64
            # wraps, unprovable SUM fences, f32 precision cliffs and
            # div pre-scale escapes reject HERE, before any launch; each
            # verified digest lands in the proof registry the sched
            # admission seam replays
            from ..analysis.valueflow import verify_plan_values
            verify_plan_values(phys, self.domain.stats)
            phys._contract_ok = True
        use_cache = use_cache and not ran_subquery
        if use_cache and _plan_cacheable(phys):
            keys = {}
            for db, name in self._referenced_tables(stmt):
                tdb = db or self.db
                try:
                    tbl = self.domain.catalog.get_table(tdb, name)
                except Exception:
                    continue
                keys[(tdb, name)] = table_fingerprint(tbl)
            cache.put(cache_sql, self.db, merged,
                      PlanCacheEntry(built, phys, keys))
        self.timings["plan"] = time.perf_counter() - t0
        return built, phys

    def _to_physical(self, plan) -> P.PhysOp:
        """The physical plan, its cop tasks naming the client's device."""
        tok = P.COP_DEVICE.set(self.domain.client.devices[0].type)
        tok2 = STATS_HANDLE.set(self.domain.stats)
        try:
            phys = to_physical(plan)
        finally:
            STATS_HANDLE.reset(tok2)
            P.COP_DEVICE.reset(tok)
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
        plan = reorder_joins(optimize_plan(built.plan), self.domain.stats)
        phys = self._to_physical(apply_index_paths(plan, self.domain.stats))
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

    def _maybe_auto_analyze(self, plan):
        """Refresh stale stats before planning (handle/autoanalyze.go
        analog, run inline instead of in a background worker)."""
        merged = {**self.domain.sysvars, **self.vars}
        if not _flag_on(merged, "tidb_enable_auto_analyze"):
            return
        from ..planner.logical import DataSource
        stack, seen = [plan], set()
        while stack:
            p = stack.pop()
            stack.extend(p.children)
            if isinstance(p, DataSource) and id(p.table) not in seen:
                seen.add(id(p.table))
                if self.domain.stats.needs_auto_analyze(p.table):
                    self.domain.stats.analyze_table(p.table)

    def _note_predicate_columns(self, plan) -> None:
        """Track filtered columns for ANALYZE ... PREDICATE COLUMNS
        (column_stats_usage.go analog), and schedule a background
        ANALYZE for a planned-against table with no stats
        (``StatsHandle.request_load``).  The port's Domain starts with
        ``tidb_enable_auto_analyze = 0``; the load runs only with it on,
        so a session that never turns it on plans over the tables it
        analyzed, as before."""
        from ..planner.logical import DataSource, LogicalSelection
        from ..planner.optimize import referenced_columns
        stats = self.domain.stats
        merged = {**self.domain.sysvars, **self.vars}
        load = _flag_on(merged, "tidb_enable_auto_analyze")

        def walk(p):
            if isinstance(p, LogicalSelection) \
                    and isinstance(p.children[0], DataSource):
                ds = p.children[0]
                refs = set()
                for c in p.conditions:
                    refs |= referenced_columns(c)
                names = [ds.schema.cols[i].name for i in refs
                         if i < len(ds.schema.cols)]
                stats.note_predicate_columns(ds.table, names)
            if load and isinstance(p, DataSource) \
                    and not getattr(p.table, "is_memtable", False):
                stats.request_load(p.table)
            for c in getattr(p, "children", []):
                walk(c)

        try:
            walk(plan)
        except Exception:
            pass     # tracking is advisory, never a planning failure

    def _exec_ctx(self) -> P.ExecContext:
        """Statement-scoped execution context with a fresh memory tracker
        rooted at tidb_mem_quota_query (util/memory Tracker analog).  The
        engine knobs of the client ride sysvars, as the JAX package's
        session applies them: the streaming cap, the result cache's
        capacity, the device scheduler's (queue depth, coalescing,
        fusion, window, HBM budget), resource control's, the
        calibration's, the memory ledger's, the host fallback of the
        ladders (once a SET GLOBAL gave it a value), the fault-injection
        spec and the program cache's (then its warm replay, once a
        directory), and the coordination plane's (``tidb_tpu_pd``,
        ``tidb_tpu_pd_dir``): the Domain's coordinator is attached or
        detached and ticked here."""
        from ..utils.memory import Tracker
        merged = {**self.domain.sysvars, **self.vars}
        quota = int(merged.get("tidb_mem_quota_query", 1 << 30))
        if quota <= 0:
            quota = -1       # TiDB semantics: 0/negative = unlimited
        client = self.domain.client
        # engine knobs ride sysvars (the reference's every-perf-knob-is-a-
        # sysvar discipline, vardef/tidb_vars.go)
        v0 = merged.get("tidb_tpu_device_mem_cap")
        cap = -1 if v0 is None or v0 == "" else int(v0)
        if cap >= 0:
            client.device_mem_cap = cap
        v1 = merged.get("tidb_tpu_result_cache_entries")
        rc = -1 if v1 is None or v1 == "" else int(v1)
        if rc >= 0:
            client._result_cache_cap = rc
        # launch supervision (faultline): host-oracle fallback for
        # quarantined digests and unanswered OOMs, and the fault-injection
        # plane spec.  The port's client keeps a statement on the card
        # unless a SET GLOBAL turned the fallback on: the sysvar's
        # default (1, as in the JAX package) does not reach it
        v9 = merged.get("tidb_tpu_sched_host_fallback")
        if v9 is not None and v9 != "" and \
                "tidb_tpu_sched_host_fallback" in self.domain.sysvars_set:
            client.host_fallback = bool(int(v9))
        v10 = merged.get("tidb_tpu_faults")
        if v10 is not None:
            from ..faults import install_spec
            install_spec(str(v10))
        _apply_sched_knobs(client, merged)
        # coplace coordination plane (pd/): attach/detach the Domain's
        # coordinator from the sysvars (the scheduler's hooks read the
        # live coordinators), and tick the statement-driven heartbeat
        # (internally throttled; a degraded store costs one failed
        # grant per tick, never a statement)
        v18 = merged.get("tidb_tpu_pd")
        v19 = merged.get("tidb_tpu_pd_dir")
        pd_on = bool(int(v18)) if v18 is not None and v18 != "" \
            else False
        from ..pd import configure_domain
        coord = configure_domain(
            self.domain, pd_on,
            "" if v19 is None else str(v19))
        if coord is not None:
            coord.tick()
        return P.ExecContext(client, merged,
                             mem_tracker=Tracker("query", quota))

    def _exec_select(self, stmt) -> ResultSet:
        cache_sql = self._cur_sql
        self._cur_sql = None  # inner selects (INSERT..SELECT) don't cache
        if getattr(stmt, "for_update", False):
            self._lock_for_update(stmt)
        built, phys = self._plan_select(stmt, cache_sql)
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
        _built, phys = self._plan_select(stmt.stmt)
        if stmt.analyze:
            # runtime statistics (utils/execdetails): each operator's
            # rows, loops and inclusive wall, and the cop task's
            # scheduler detail; the plan is a fresh one (no cache_sql),
            # so the instrumented operators never reach the plan cache
            from ..utils.execdetails import (RuntimeStatsColl,
                                             explain_analyze_text,
                                             instrument_tree)
            coll = RuntimeStatsColl()
            instrument_tree(phys, coll)
            phys.execute(self._exec_ctx())
            return ResultSet(["operator", "actRows", "time", "loops"],
                             explain_analyze_text(phys, coll))
        rows = [(line,) for line in phys.explain().split("\n")]
        if getattr(phys, "_contract_ok", False):
            # the plan-time gates verified this plan (analysis/
            # contracts, shardflow, valueflow) — surfaced like the
            # reference's EXPLAIN diagnostics footer
            rows.append(("contract: ok",))
            footer = self._cost_footer(phys)
            if footer is not None:
                rows.append((footer,))
                transfer = self._transfer_footer(phys)
                if transfer is not None:
                    rows.append((transfer,))
                calib = self._calibration_footer(phys)
                if calib is not None:
                    rows.append((calib,))
            strat = self._agg_strategy_footer(phys)
            if strat is not None:
                rows.append((strat,))
        return ResultSet(["plan"], rows)

    def _cost_footer(self, phys) -> Optional[str]:
        """EXPLAIN cost footer from the static shape/memory model
        (analysis/copcost): estimated peak device bytes, host<->device
        transfer, and the padded/live ratio of the scan inputs, with the
        buffer-lifetime verdict (analysis/lifetime) of the streamed
        path.  None for host-only plans or shapes the model cannot walk
        — the footer must never break EXPLAIN."""
        try:
            from ..analysis.copcost import format_bytes, plan_cost
            n_dev = len(self.domain.client.devices)
            cost = plan_cost(phys, n_dev)
            if not cost.transfer_bytes:
                return None
            footer = (f"est. device bytes: "
                      f"{format_bytes(cost.peak_hbm_bytes)} peak / "
                      f"{format_bytes(cost.transfer_bytes)} transfer, "
                      f"padding {cost.padding_waste:.1f}x")
            # buffer-lifetime verdict (analysis/lifetime): how many
            # input buffers / bytes a donation-eligible launch releases
            # on the streamed (launch-unique) path
            from ..analysis.lifetime import plan_donation
            bufs, saved = plan_donation(phys, n_dev)
            if bufs:
                footer += (f", donate: {bufs} bufs / "
                           f"{format_bytes(saved)}")
            return footer
        except (AttributeError, TypeError, KeyError, ValueError,
                ImportError):
            return None

    def _topology(self, merged=None):
        """The devices' typed-link topology under the declared host view
        (tidb_tpu_topology_hosts) — the analysis seam the plan-path
        shardflow verification and the EXPLAIN transfer footer share.
        Never launches."""
        from ..parallel.topology import set_host_view, topology_for
        if merged is None:
            merged = {**self.domain.sysvars, **self.vars}
        v = merged.get("tidb_tpu_topology_hosts")
        if v is not None and v != "":
            set_host_view(None if int(v) <= 0 else int(v))
        devices = self.domain.client.devices
        return topology_for(devices, n_devices=len(devices))

    def _transfer_footer(self, phys) -> Optional[str]:
        """EXPLAIN per-link transfer footer (analysis/shardflow):
        ``transfer: X ici / Y dci`` — the plan's statically-classified
        collective bytes under the declared host view
        (tidb_tpu_topology_hosts).  None for plans without collective
        traffic; must never break EXPLAIN."""
        try:
            from ..analysis.copcost import format_bytes
            from ..analysis.shardflow import plan_transfer
            bd = plan_transfer(phys, self._topology())
            if not bd.collective:
                return None
            return (f"transfer: {format_bytes(bd.ici)} ici / "
                    f"{format_bytes(bd.dci)} dci")
        except (AttributeError, TypeError, KeyError, ValueError,
                ImportError):
            return None

    def _calibration_footer(self, phys) -> Optional[str]:
        """EXPLAIN ``cost:`` verdict (analysis/calibrate): ``cost:
        calibrated (err N%)`` when the plan's device program has
        measured corrections, ``cost: static`` otherwise (or when
        tidb_tpu_cost_calibration is off).  None for plans without a
        device dag; must never break EXPLAIN."""
        try:
            from ..copr import dag as Dg
            dag = None
            stack = [phys]
            while stack and dag is None:
                op = stack.pop()
                d = getattr(op, "dag", None)
                if isinstance(d, Dg.CopNode):
                    dag = d
                    break
                for c in getattr(op, "children", []) or []:
                    if c is not None:
                        stack.append(c)
            if dag is None:
                return None
            merged = {**self.domain.sysvars, **self.vars}
            v = merged.get("tidb_tpu_cost_calibration")
            enabled = True if v is None or v == "" else bool(int(v))
            if not enabled:
                return "cost: static"
            from ..analysis.calibrate import correction_store
            from ..analysis.compilekey import stable_digest
            ent = correction_store().get(stable_digest(dag))
            if ent is None or not ent.samples:
                return "cost: static"
            return f"cost: calibrated (err {ent.err * 100:.0f}%)"
        except (AttributeError, TypeError, ValueError, ImportError):
            return None

    def _agg_strategy_footer(self, phys) -> Optional[str]:
        """EXPLAIN ``agg strategy:`` tag: which device group-by strategy
        the pushed aggregation takes, with its capacity knob — dense
        (domain product), sort (regrow capacity), or segment (radix
        bucket space).  None for scalar/host-only plans; must never
        break EXPLAIN."""
        try:
            from ..copr import dag as Dg
            stack = [phys]
            while stack:
                op = stack.pop()
                dag = getattr(op, "dag", None)
                if dag is None:
                    dag = getattr(getattr(op, "spec", None), "top", None)
                if isinstance(dag, Dg.Aggregation) and dag.group_by:
                    if dag.strategy is Dg.GroupStrategy.SCATTER:
                        return (f"agg strategy: scatter "
                                f"({dag.num_buckets} buckets, "
                                f"{Dg.radix_passes(dag.num_buckets)} "
                                "passes)")
                    if dag.strategy is Dg.GroupStrategy.SEGMENT:
                        return (f"agg strategy: segment "
                                f"({dag.num_buckets} buckets)")
                    if dag.strategy is Dg.GroupStrategy.SORT:
                        return (f"agg strategy: sort (capacity "
                                f"{dag.group_capacity or 'auto'})")
                    return (f"agg strategy: dense "
                            f"({dag.num_groups} groups)")
                for c in getattr(op, "children", []) or []:
                    if c is not None:
                        stack.append(c)
        except (AttributeError, TypeError):
            return None
        return None

    def _exec_plan_replayer(self, stmt: A.PlanReplayerDump) -> ResultSet:
        """PLAN REPLAYER DUMP EXPLAIN <sql> (executor/plan_replayer.go):
        writes a zip bundle — sql, plan text, CREATE TABLE statements for
        every referenced table, stats JSON, session/global sysvars,
        engine version — and returns its token filename."""
        import json as _json
        import os
        import tempfile
        import zipfile

        parsed = parse_sql(stmt.sql)[0]
        if not isinstance(parsed, (A.SelectStmt, A.SetOpStmt)):
            raise PlanError("PLAN REPLAYER DUMP supports SELECT only")
        _built, phys = self._plan_select(parsed)
        plan_text = phys.explain()
        tables = []
        for db, name in self._referenced_tables(parsed):
            try:
                tables.append(self.domain.catalog.get_table(
                    db or self.db, name))
            except Exception:
                continue
        stats_blob = {}
        for t in tables:
            st = self.domain.stats.get(t)
            if st is None:
                continue
            stats_blob[t.name] = {
                "count": st.count,
                "modify_count": st.modify_count,
                "columns": {cn: {"ndv": cs.ndv,
                                 "null_count": cs.null_count}
                            for cn, cs in st.cols.items()},
            }
        out_dir = os.path.join(tempfile.gettempdir(), "tidb_tpu_replayer")
        os.makedirs(out_dir, exist_ok=True)
        token = f"replayer_{int(time.time() * 1000):x}.zip"
        path = os.path.join(out_dir, token)
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("sql/sql.sql", stmt.sql)
            z.writestr("plan.txt", plan_text)
            z.writestr("schema/schema.sql", "\n\n".join(
                _render_create_table(t) for t in tables))
            z.writestr("stats.json", _json.dumps(stats_blob, indent=1))
            z.writestr("variables.json", _json.dumps(
                {**self.domain.sysvars, **self.vars}, default=str,
                indent=1))
            z.writestr("meta.txt", "tidb-tpu 0.2.0")
        return ResultSet(["File_token"], [(token,)])

    def _exec_trace(self, stmt: A.TraceStmt) -> ResultSet:
        """TRACE <stmt>: span tree of the statement's phases
        (executor/trace.go analog); the device work dispatched inside
        stitches its client and scheduler spans under ``executor.Run``."""
        from ..utils.tracing import Tracer
        tracer = Tracer()
        with tracer.region("session.ExecuteStmt"):
            if isinstance(stmt.stmt, (A.SelectStmt, A.SetOpStmt)):
                with tracer.region("planner.Optimize"):
                    _built, phys = self._plan_select(stmt.stmt)
                with tracer.region("executor.Run"):
                    phys.execute(self._exec_ctx())
            else:
                with tracer.region("executor.Run"):
                    self._exec_stmt(stmt.stmt)
        return ResultSet(["operation", "startTS_us", "duration_us"],
                         tracer.rows())

    # ---------------- transactions, DDL and DML ---------------- #

    def _exec_txn(self, stmt: A.TxnStmt) -> ResultSet:
        """Explicit transactions over the native MVCC store.

        Round-1 scope: INSERTs inside BEGIN...COMMIT buffer in one
        percolator txn (atomic, conflict-checked 2PC at COMMIT); reads see
        the last committed snapshot (union-scan of own writes comes with
        the distsql-over-KV path); UPDATE/DELETE inside a txn autocommit."""
        if stmt.kind == "begin":
            if self.txn is not None:
                self._finish_txn(commit=True)
            merged = {**self.domain.sysvars, **self.vars}
            mode = stmt.mode or str(merged.get("tidb_txn_mode", "optimistic"))
            self.txn = self.domain.kv.begin(
                pessimistic=(mode == "pessimistic"))
            if self.txn.pessimistic:
                self.txn.lock_wait_ms = int(
                    merged.get("innodb_lock_wait_timeout", 3)) * 1000
            self._txn_tables = set()
            self._txn_table_vers = {}
            self._txn_schema_ver = self.domain.schema_version
        elif stmt.kind == "commit":
            self._finish_txn(commit=True)
        else:  # rollback
            self._finish_txn(commit=False)
        return ResultSet()

    def _finish_txn(self, commit: bool):
        """End the active txn; on commit failure roll back and clear state
        so the session isn't wedged (review finding)."""
        txn, self.txn = self.txn, None
        if txn is None:
            return
        try:
            if not commit:
                txn.rollback()
                self._txn_tables = set()
                return
            # commit-time schema validation, PER WRITTEN TABLE (kv.go:533
            # SchemaVar / domain SchemaValidator): F1 adjacent states are
            # mutually compatible, so ONE version step on a written table
            # is fine (MDL drains before the second step); a >=2 gap
            # means this txn straddled two transitions (MDL timeout path)
            # and could miss index entries -> abort with retry semantics
            stale = [t.name for t, ver in
                     getattr(self, "_txn_table_vers", {}).items()
                     if t.schema_ver > ver + 1]
            if stale:
                txn.rollback()
                self._txn_tables = set()
                raise CatalogError(
                    "Information schema is changed during the execution "
                    f"of the statement (DDL on {', '.join(stale)} ran "
                    "concurrently); transaction rolled back, please retry")
            try:
                txn.commit()
                self._invalidate_txn_tables()
            except Exception:
                txn.rollback()
                self._txn_tables = set()
                raise
        finally:
            self.domain.mdl.release_all(id(txn))
            self._txn_table_vers = {}

    def _invalidate_txn_tables(self):
        for t in self._txn_tables:
            t._invalidate()
        self._txn_tables = set()

    def _txn_note_table(self, tbl) -> None:
        """Record a table the open txn writes: registers the metadata
        lock (pkg/ddl/mdl) at the schema version this txn first saw, so a
        concurrent DDL transition drains this txn before advancing, and
        pins the version for the per-table commit check."""
        self._txn_tables.add(tbl)
        if not hasattr(self, "_txn_table_vers") \
                or self._txn_table_vers is None:
            self._txn_table_vers = {}
        if tbl not in self._txn_table_vers:
            self._txn_table_vers[tbl] = tbl.schema_ver
            self.domain.mdl.acquire(tbl.table_id, id(self.txn),
                                     tbl.schema_ver)

    def _exec_create_table(self, stmt: A.CreateTable) -> ResultSet:
        db = stmt.db or self.db
        names, types = [], []
        auto_inc = None
        for c in stmt.columns:
            names.append(c.name)
            not_null = c.not_null or c.name in stmt.primary_key
            types.append(type_from_sql(c.type_name, c.prec, c.scale, not_null,
                                       c.collation, c.members))
            if c.auto_increment:
                auto_inc = c.name
        tbl = TableInfo(stmt.name, names, types, stmt.primary_key, auto_inc,
                        table_id=self.domain.alloc_table_id(),
                        kv=self.domain.kv,
                        n_shards=int({**self.domain.sysvars, **self.vars}
                                     .get("tidb_tpu_shard_count", 8) or 8))
        tbl._autoid = self.domain.autoid
        if stmt.ttl is not None:
            if stmt.ttl.column not in names:
                raise CatalogError(
                    f"unknown TTL column {stmt.ttl.column!r}")
            t = types[names.index(stmt.ttl.column)]
            if t.kind not in (dt.TypeKind.DATE, dt.TypeKind.DATETIME):
                raise CatalogError("TTL column must be DATE or DATETIME")
            tbl.ttl_col = stmt.ttl.column
            tbl.ttl_interval_sec = stmt.ttl.interval_sec
            tbl.ttl_enable = stmt.ttl.enable
        if stmt.partition is not None:
            pc = stmt.partition.column
            if pc not in names:
                raise CatalogError(f"unknown partition column {pc!r}")
            t = types[names.index(pc)]
            if t.kind not in (dt.TypeKind.INT64, dt.TypeKind.UINT64,
                              dt.TypeKind.DATE, dt.TypeKind.DATETIME):
                raise CatalogError(
                    "partition column must be integer or date typed")
            tbl.partition = stmt.partition
        if stmt.foreign_keys:
            # integer keys only: FK comparison runs over raw int64 column
            # data; date/string values are not canonical at check time
            ok_kinds = (dt.TypeKind.INT64, dt.TypeKind.UINT64)
            for fk in stmt.foreign_keys:
                if fk.column not in names:
                    raise CatalogError(f"unknown FK column {fk.column!r}")
                if types[names.index(fk.column)].kind not in ok_kinds:
                    raise CatalogError(
                        "FOREIGN KEY columns must be integer typed")
                parent = tbl if fk.ref_table == stmt.name else \
                    self.domain.catalog.get_table(db, fk.ref_table)
                if fk.ref_column not in parent.col_names:
                    raise CatalogError(
                        f"unknown referenced column "
                        f"{fk.ref_table}.{fk.ref_column}")
                pk = parent.col_types[
                    parent.col_names.index(fk.ref_column)].kind
                if pk not in ok_kinds:
                    raise CatalogError(
                        "FOREIGN KEY must reference an integer column "
                        f"({fk.ref_table}.{fk.ref_column} is {pk.value})")
            tbl.foreign_keys = list(stmt.foreign_keys)
            cat = self.domain.catalog
            tbl._fk_resolver = (
                lambda nm, _t=tbl, _db=db, _cat=cat:
                _t if nm == _t.name else _cat.get_table(_db, nm))
        gen = [(c.name, c.generated, c.generated_stored)
               for c in stmt.columns if c.generated is not None]
        if gen:
            self._bind_generated_columns(tbl, stmt, gen)
        if stmt.temporary:
            # session-scoped: registered in the session overlay, never in
            # the shared catalog (reference: temptable / local temporary
            # table infoschema overlay)
            key = (db, stmt.name)
            if key in self.temp_tables:
                if stmt.if_not_exists:
                    return ResultSet()
                raise CatalogError(f"table {stmt.name!r} exists")
            self.temp_tables[key] = tbl
            created = tbl
        else:
            self.domain.catalog.create_table(db, tbl,
                                             stmt.if_not_exists)
            created = self.domain.catalog.get_table(db, stmt.name)
        if created is tbl:
            # implicit PRIMARY index gives PK uniqueness + the point-get
            # path (the reference's clustered-handle role, tablecodec)
            if stmt.primary_key:
                tbl.create_index("PRIMARY", list(stmt.primary_key), True)
            for i, (iname, cols, uniq) in enumerate(stmt.indexes):
                tbl.create_index(iname or f"idx_{i+1}_" + "_".join(cols),
                                 cols, uniq)
        return ResultSet()

    def _bind_generated_columns(self, tbl, stmt: A.CreateTable, gen) -> None:
        """Compile generated-column expressions over the table schema and
        attach them for the write paths (reference: table/column.go
        generated column eval; computed at write for STORED and — as a
        simplification — VIRTUAL alike, which is observationally
        equivalent for the deterministic expressions MySQL requires)."""
        from ..planner.build import ExprBuilder
        from ..planner.logical import Schema, SchemaCol
        schema = Schema([SchemaCol(n, t)
                         for n, t in zip(tbl.col_names, tbl.col_types)])
        eb = ExprBuilder(schema)

        def refs(e):
            from ..expr.ir import ColumnRef, Func
            if isinstance(e, ColumnRef):
                yield e
            elif isinstance(e, Func):
                for a in e.args:
                    yield from refs(a)

        compiled = []
        gen_names = {name for name, _a, _s in gen}
        for name, ast_expr, _stored in gen:
            ir = eb.build(ast_expr)
            for r in refs(ir):
                if tbl.col_names[r.index] in gen_names \
                        and tbl.col_names.index(name) <= r.index:
                    raise CatalogError(
                        "generated column may only reference earlier "
                        "generated columns")
                if tbl.auto_inc_col is not None \
                        and tbl.col_names[r.index] == tbl.auto_inc_col:
                    # MySQL ER_GENERATED_COLUMN_REF_AUTO_INC: the value is
                    # allocated after generation would run
                    raise CatalogError(
                        "generated column cannot refer to an "
                        "auto-increment column")
            compiled.append((tbl.col_names.index(name), ir))
        tbl.generated_cols = compiled

    def _exec_alter(self, stmt: A.AlterTable) -> ResultSet:
        tbl = self.domain.catalog.get_table(getattr(stmt, 'db', None) or self.db, stmt.table)
        # session temp tables never reach the DDL owner thread (its
        # catalog lookups cannot see the session overlay)
        ddl_db = getattr(stmt, 'db', None) or self.db
        is_temp = self.temp_tables.get((ddl_db, stmt.table)) is tbl
        for act in stmt.actions:
            if act[0] == "add_index":
                _, iname, cols, uniq = act
                if is_temp:
                    tbl.create_index(iname or "idx_" + "_".join(cols),
                                     list(cols), uniq)
                    continue
                self.domain.ddl.run_job("add index", ddl_db, tbl.name, {
                    "name": iname or "idx_" + "_".join(cols),
                    "columns": list(cols), "unique": uniq})
            elif act[0] == "drop_index":
                if is_temp:
                    ix = tbl.index_by_name(act[1])
                    if ix is None:
                        raise CatalogError(f"unknown index {act[1]!r}")
                    tbl.indexes.remove(ix)
                    continue
                self.domain.ddl.run_job("drop index", ddl_db, tbl.name,
                                        {"name": act[1]})
            elif act[0] == "add_column":
                self._alter_add_column(tbl, act[1])
            elif act[0] == "drop_column":
                self._alter_drop_column(tbl, act[1])
            else:
                raise PlanError(f"unsupported ALTER action {act[0]}")
        tbl._persist_meta()   # catalog-on-KV: column changes survive
        return ResultSet()

    def _alter_add_column(self, tbl, cd) -> None:
        if cd.name in tbl.col_names:
            raise CatalogError(f"column {cd.name!r} already exists")
        t = type_from_sql(cd.type_name, cd.prec, cd.scale, cd.not_null,
                          cd.collation, cd.members)
        default = None
        if cd.default is not None:
            default = self._literal_value(cd.default)
        snap = tbl.snapshot()
        if cd.not_null and default is None and snap.num_rows:
            raise CatalogError(
                f"cannot add NOT NULL column {cd.name!r} without a DEFAULT "
                "to a non-empty table")
        rows = [tuple(plainify(v) for v in r)
                for r in zip(*[c.to_python() for c in snap.columns])] \
            if snap.num_rows else []
        new_rows = [r + (default,) for r in rows]
        self._rewrite_with_schema(tbl, tbl.col_names + [cd.name],
                                  tbl.col_types + [t], new_rows)

    def _alter_drop_column(self, tbl, name: str) -> None:
        if name not in tbl.col_names:
            raise CatalogError(f"unknown column {name!r}")
        for ix in tbl.indexes:
            if name in ix.columns:
                raise CatalogError(
                    f"cannot drop column {name!r}: used by index {ix.name!r}")
        i = tbl.col_names.index(name)
        snap = tbl.snapshot()
        rows = [tuple(plainify(v) for j, v in enumerate(r) if j != i)
                for r in zip(*[c.to_python() for c in snap.columns])] \
            if snap.num_rows else []
        self._rewrite_with_schema(tbl,
                                  [n for n in tbl.col_names if n != name],
                                  [t for j, t in enumerate(tbl.col_types)
                                   if j != i], rows)

    def _rewrite_with_schema(self, tbl, names, types, rows) -> None:
        """Swap in a new column schema + rewritten rows; restore the old
        schema if the rewrite fails so catalog and storage never diverge."""
        old_names, old_types = tbl.col_names, tbl.col_types
        tbl.col_names, tbl.col_types = list(names), list(types)
        try:
            tbl.replace_columns(_rows_to_columns(tbl, rows))
        except Exception:
            tbl.col_names, tbl.col_types = old_names, old_types
            tbl._invalidate()
            raise

    def _exec_insert(self, stmt: A.Insert) -> ResultSet:
        tbl = self.domain.catalog.get_table(getattr(stmt, 'db', None) or self.db, stmt.table)
        if stmt.select is not None:
            res = self._exec_select(stmt.select)
            rows = [tuple(plainify(v) for v in r) for r in res.rows]
        else:
            rows = [tuple(self._literal_value(v) for v in r)
                    for r in stmt.rows]
        gen_names = {tbl.col_names[i]
                     for i, _ in getattr(tbl, "generated_cols", [])}
        if stmt.columns:
            for n in stmt.columns:
                if n in gen_names:
                    raise PlanError(
                        f"The value specified for generated column {n!r} "
                        "in table is not allowed")
            idx = {n: i for i, n in enumerate(stmt.columns)}
            full = []
            for r in rows:
                if len(r) != len(stmt.columns):
                    raise PlanError("column count mismatch")
                full.append(tuple(
                    r[idx[n]] if n in idx else None for n in tbl.col_names))
            rows = full
        elif gen_names:
            # positional inserts must leave generated slots NULL/DEFAULT
            gidx = [i for i, _ in tbl.generated_cols]
            for r in rows:
                for i in gidx:
                    if i < len(r) and r[i] is not None:
                        raise PlanError(
                            "The value specified for generated column "
                            f"{tbl.col_names[i]!r} in table is not allowed")
        if stmt.on_dup:
            write = lambda txn: self._insert_on_dup(tbl, rows,
                                                    stmt.on_dup, txn)
        elif stmt.replace:
            write = lambda txn: tbl.replace_rows(rows, txn=txn)
        elif stmt.ignore:
            write = lambda txn: self._insert_ignore(tbl, rows, txn)
        else:
            write = lambda txn: tbl.insert_rows(rows, txn=txn)
        if self.txn is None:
            n = self._retry_write_conflict(lambda: write(None))
        else:
            n = write(self.txn)
        if self.txn is not None:
            self._txn_note_table(tbl)
        if tbl.auto_inc_col is not None and n:
            # MySQL LAST_INSERT_ID(): first auto-generated id of the last
            # batch; the table counter sits past the batch after insert
            self.last_insert_id = max(int(tbl._auto_inc) - n + 1, 1)
        self.domain.stats.note_modify(tbl, n)
        return ResultSet(affected=n)

    def _dml_atomic(self, handler, stmt) -> ResultSet:
        """MySQL statement atomicity inside an explicit transaction: stage
        the DML against a membuffer savepoint so a mid-statement failure
        (late duplicate key, type error on a later row) unwinds THIS
        statement's writes only, leaving the txn usable (the reference's
        StmtCommit/StmtRollback membuffer staging)."""
        if self.txn is None:
            return handler(stmt)
        sp = self.txn.savepoint()
        try:
            res = handler(stmt)
        except Exception:
            self.txn.rollback_to(sp)
            raise
        self.txn.release_savepoint()
        return res

    def _insert_on_dup(self, tbl, rows, on_dup, txn) -> int:
        """INSERT ... ON DUPLICATE KEY UPDATE (executor/insert.go upsert):
        per row, a conflict on any public unique index turns the insert
        into an update of the EXISTING row; assignment expressions may
        reference existing columns by name and the proposed row via
        VALUES(col).  Affected-rows: 1 per insert, 2 per changing update,
        0 when the update leaves the row identical (MySQL counting)."""
        from .catalog import DuplicateKeyError, canon_write_value
        if tbl.kv is None:
            # conflict probing walks unique-index KV entries; without a
            # KV backing the upsert would silently degrade to a plain
            # insert and surface as a confusing DuplicateKeyError
            raise PlanError("INSERT ... ON DUPLICATE KEY UPDATE requires "
                            "a KV-backed table")
        affected = 0
        ci = {n: i for i, n in enumerate(tbl.col_names)}
        for col, _e in on_dup:
            if col not in ci:
                raise PlanError(f"unknown column {col!r} in ON DUPLICATE "
                                "KEY UPDATE")
        for r in rows:
            proposed = tuple(
                canon_write_value(t, v, n)
                for t, v, n in zip(tbl.col_types, r, tbl.col_names))
            hit = self._find_unique_conflict(tbl, proposed, txn)
            if hit is None:
                affected += tbl.insert_rows([r], txn=txn)
                continue
            handle, existing = hit
            new_row = list(existing)
            for col, expr_ast in on_dup:
                new_row[ci[col]] = self._eval_upsert_expr(
                    expr_ast, tbl, existing, proposed)
            new_row = tuple(plainify(v) for v in new_row)
            if tuple(existing) == new_row:
                continue               # identical: 0 affected
            tbl.update_rows([handle], [tuple(existing)], [new_row],
                            txn=txn)
            affected += 2
        return affected

    def _find_unique_conflict(self, tbl, row, txn):
        """(handle, existing_row) of the first public unique-index
        conflict for a proposed row, or None."""
        from ..store.codec import decode_index_handle, decode_row, record_key
        if tbl.kv is None:
            return None
        reader = txn if txn is not None else tbl.kv
        ts = None if txn is not None else tbl.kv.alloc_ts()
        for ix in tbl.indexes:
            if not ix.unique or ix.state != "public":
                continue
            key, val = tbl._index_entry(ix, row, 0)
            if not val:
                continue               # NULL key parts never conflict
            got = (reader.get(key) if txn is not None
                   else reader.get(key, ts))
            if got is None:
                continue
            h = decode_index_handle(key, got)
            rk = record_key(tbl.table_id, h)
            rv = (reader.get(rk) if txn is not None
                  else reader.get(rk, ts))
            if rv is not None:
                return h, decode_row(rv, tbl.col_types)
        return None

    def _eval_upsert_expr(self, node, tbl, existing, proposed):
        """Evaluate an ON DUPLICATE KEY UPDATE assignment over the
        existing row (idents) and the proposed row (VALUES(col))."""
        ci = {n: i for i, n in enumerate(tbl.col_names)}
        if isinstance(node, A.Lit):
            return self._literal_value(node)
        if isinstance(node, A.Ident):
            name = node.parts[-1].lower()
            if name not in ci:
                raise PlanError(f"unknown column {name!r}")
            return existing[ci[name]]
        if isinstance(node, A.FuncCall) and node.name == "VALUES" \
                and len(node.args) == 1 \
                and isinstance(node.args[0], A.Ident):
            name = node.args[0].parts[-1].lower()
            if name not in ci:
                raise PlanError(f"unknown column {name!r}")
            return proposed[ci[name]]
        if isinstance(node, A.Binary) and node.op in "+-*":
            a = self._eval_upsert_expr(node.left, tbl, existing, proposed)
            b = self._eval_upsert_expr(node.right, tbl, existing, proposed)
            if a is None or b is None:
                return None
            return {"+": a + b, "-": a - b, "*": a * b}[node.op]
        raise PlanError("unsupported ON DUPLICATE KEY UPDATE expression "
                        "(literals, columns, VALUES(col), + - * only)")

    @staticmethod
    def _insert_ignore(tbl, rows, txn) -> int:
        """INSERT IGNORE: duplicate-key rows are skipped, not errors."""
        from .catalog import DuplicateKeyError
        n = 0
        for r in rows:
            try:
                n += tbl.insert_rows([r], txn=txn)
            except DuplicateKeyError:
                pass
        return n

    def _exec_load_data(self, stmt: A.LoadData) -> ResultSet:
        """LOAD DATA INFILE (executor/load_data.go analog): parse the file
        with the FIELDS/LINES options and batch-insert."""
        import csv as _csv
        import io
        tbl = self.domain.catalog.get_table(getattr(stmt, 'db', None) or self.db, stmt.table)
        try:
            with open(stmt.path, "r", newline="") as f:
                text = f.read()
        except OSError as e:
            raise CatalogError(f"cannot read {stmt.path!r}: {e}")
        if stmt.line_sep not in ("\n", "\r\n"):
            text = text.replace(stmt.line_sep, "\n")
        sep = stmt.field_sep or "\t"
        if len(sep) > 1:
            # csv only takes 1-char delimiters: normalize multi-char
            # separators to an unlikely control char first
            text = text.replace(sep, "\x01")
            sep = "\x01"
        reader = _csv.reader(
            io.StringIO(text), delimiter=sep,
            quotechar=(stmt.enclosed or '"')[0])
        names = stmt.columns or tbl.col_names
        idx = {n: i for i, n in enumerate(names)}
        total = 0
        batch: list[tuple] = []
        # one transaction for the WHOLE load: a failure in a late batch
        # must not leave earlier batches committed (statement atomicity;
        # the explicit-txn case is staged by _dml_atomic's savepoint)
        own = self.txn is None
        txn = self.txn or tbl.kv.begin()

        def flush():
            nonlocal total
            if not batch:
                return
            if stmt.replace:
                total += tbl.replace_rows(batch, txn=txn)
            elif stmt.ignore:
                total += self._insert_ignore(tbl, batch, txn)
            else:
                # MySQL: without IGNORE/REPLACE a duplicate key ERRORS
                total += tbl.insert_rows(batch, txn=txn)
            batch.clear()

        try:
            for ln, rec in enumerate(reader):
                if ln < stmt.ignore_lines or not rec:
                    continue
                vals = []
                for cn, ct in zip(tbl.col_names, tbl.col_types):
                    if cn not in idx or idx[cn] >= len(rec):
                        vals.append(None)
                        continue
                    raw = rec[idx[cn]]
                    if raw == "\\N" or (raw == "" and not ct.is_string):
                        vals.append(None)
                    else:
                        vals.append(raw)
                batch.append(tuple(vals))
                if len(batch) >= 4096:
                    flush()
            flush()
            if own:
                txn.commit()
        except Exception:
            if own:
                txn.rollback()
            raise
        finally:
            tbl._invalidate()
        if self.txn is not None:
            self._txn_tables.add(tbl)
        self.domain.stats.note_modify(tbl, total)
        return ResultSet(affected=total)

    def _where_mask(self, tbl: TableInfo, where: Optional[A.Node]) -> np.ndarray:
        """Evaluate WHERE over the table snapshot -> bool mask (NULL=false)."""
        snap = tbl.snapshot()
        return self._where_mask_cols(tbl, snap.columns, snap.dictionaries,
                                     where)

    def _where_mask_cols(self, tbl: TableInfo, columns, dicts,
                         where: Optional[A.Node]) -> np.ndarray:
        """WHERE mask over explicit columns (txn union-scan views pass
        their own overlaid columns here, not the shared snapshot)."""
        n = len(columns[0]) if columns else 0
        if where is None:
            return np.ones(n, bool)
        from ..expr.host_eval import eval_expr
        from ..expr.lower_strings import lower_strings
        from ..planner.build import ExprBuilder
        from ..planner.logical import Schema, SchemaCol
        sch = Schema([SchemaCol(nm, c.dtype)
                      for nm, c in zip(tbl.col_names, columns)])
        ir = ExprBuilder(sch).build(where)
        ir = lower_strings(ir, dicts)
        pairs = [(c.data, (True if c.validity.all() else c.validity))
                 for c in columns]
        v, m = eval_expr(np, ir, pairs)
        v = np.broadcast_to(np.asarray(v), (n,))
        if v.dtype != bool:
            v = v != 0
        if m is not True:
            v = v & np.broadcast_to(np.asarray(m), (n,))
        return v

    def _retry_write_conflict(self, fn, attempts: int = 18):
        """Re-run an autocommit DML on optimistic write conflict / lock
        (session doCommitWithRetry analog, session.go:798): the statement
        recomputes against a fresh snapshot each attempt.  Capped
        exponential backoff: a DDL backfill batch on a loaded host can
        hold its locks for >100ms, which the old 72ms linear budget
        couldn't ride out."""
        import time as _t
        from ..store.kv import KVError
        for a in range(attempts):
            try:
                return fn()
            except KVError as e:
                if e.code not in (1, 2) or a == attempts - 1:
                    raise
                _t.sleep(min(0.002 * (2 ** a), 0.3))

    def _exec_update(self, stmt: A.Update) -> ResultSet:
        return self._retry_write_conflict(lambda: self._do_update(stmt))

    def _txn_row_overlay(self, tbl: TableInfo) -> dict:
        """handle -> decoded row (None = buffered delete) from the active
        txn's membuffer for this table — the UnionScanExec ingredient."""
        from ..store.codec import decode_record_key, decode_row, record_prefix
        out: dict = {}
        if self.txn is None or tbl.kv is None:
            return out
        pre = record_prefix(tbl.table_id)
        for k, v in self.txn.mutations.items():
            if k.startswith(pre):
                h = decode_record_key(k)[1]
                out[h] = None if v is None else tuple(
                    decode_row(v, tbl.col_types))
        return out

    def _update_view(self, tbl: TableInfo):
        """(rows, handles, columns, dicts) the UPDATE statement sees:
        committed snapshot merged with the txn's own buffered mutations
        (union scan), never mutating the shared snapshot cache."""
        snap = tbl.snapshot()
        rows = [list(r) for r in zip(*[c.to_python() for c in snap.columns])] \
            if snap.num_rows else []
        handles = [int(h) for h in (tbl._snapshot_handles
                                    if tbl._snapshot_handles is not None
                                    else range(len(rows)))]
        overlay = self._txn_row_overlay(tbl)
        if not overlay:
            return rows, handles, snap.columns, snap.dictionaries
        merged, mh, seen = [], [], set()
        for h, r in zip(handles, rows):
            seen.add(h)
            if h in overlay:
                if overlay[h] is None:
                    continue              # buffered delete
                merged.append(list(overlay[h]))
            else:
                merged.append(r)
            mh.append(h)
        for h in sorted(set(overlay) - seen):
            if overlay[h] is not None:    # buffered insert
                merged.append(list(overlay[h]))
                mh.append(h)
        cols = _rows_to_columns(tbl, [tuple(plainify(x) for x in r)
                                      for r in merged])
        dicts = {i: c.dictionary for i, c in enumerate(cols)
                 if c.dictionary is not None}
        return merged, mh, cols, dicts

    def _do_update(self, stmt: A.Update) -> ResultSet:
        tbl = self.domain.catalog.get_table(getattr(stmt, 'db', None) or self.db, stmt.table)
        if self.txn is not None and getattr(self.txn, "pessimistic", False) \
                and tbl.kv is not None:
            # pessimistic statement protocol: lock the affected record
            # keys FIRST (blocking conflicting writers), then recompute
            # from a post-lock view so the update applies on top of
            # whatever committed while we waited (no lost updates)
            from ..store.codec import record_key
            locked: set = set()
            for attempt in range(8):
                tbl._invalidate()
                rows0, handles0, cols0, dicts0 = self._update_view(tbl)
                m = self._where_mask_cols(tbl, cols0, dicts0, stmt.where)
                matched = {handles0[i] for i in np.nonzero(m)[0]}
                fresh = matched - locked
                if not fresh:
                    break
                self.txn.lock_keys([record_key(tbl.table_id, h)
                                    for h in sorted(fresh)])
                locked |= fresh
            else:
                raise KVError(0, "pessimistic lock retry limit exceeded "
                                 "(contended WHERE set keeps growing)")
        rows, handles, cols, dicts = self._update_view(tbl)
        mask = self._where_mask_cols(tbl, cols, dicts, stmt.where)
        mask = self._dml_restrict_mask(tbl, mask, stmt.order_by,
                                       stmt.limit, cols=cols, dicts=dicts)
        n_rows = len(rows)
        n_aff = int(mask.sum())
        if n_aff == 0:
            return ResultSet(affected=0)
        from ..expr.host_eval import eval_expr
        from ..expr.lower_strings import lower_strings
        from ..planner.build import ExprBuilder
        from ..planner.logical import Schema, SchemaCol
        sch = Schema([SchemaCol(nm, c.dtype)
                      for nm, c in zip(tbl.col_names, cols)])
        pairs = [(c.data, (True if c.validity.all() else c.validity))
                 for c in cols]
        ci = {n: i for i, n in enumerate(tbl.col_names)}
        midx = np.nonzero(mask)[0]
        old_rows = [tuple(rows[i]) for i in midx]
        for col, expr_ast in stmt.assignments:
            if col not in ci:
                raise PlanError(f"unknown column {col!r}")
            if isinstance(expr_ast, A.Lit):
                val = self._literal_value(expr_ast)
                for i in midx:
                    rows[i][ci[col]] = val
                continue
            ir = lower_strings(ExprBuilder(sch).build(expr_ast), dicts)
            if ir.dtype.is_string:
                raise PlanError("computed string UPDATE not supported yet")
            v, m = eval_expr(np, ir, pairs)
            v = np.broadcast_to(np.asarray(v), (n_rows,))
            for i in midx:
                ok = True if m is True else bool(np.broadcast_to(
                    np.asarray(m), (n_rows,))[i])
                rows[i][ci[col]] = _decode_val(v[i], ir.dtype) if ok else None
        self._fk_parent_update_check(tbl, cols, midx, old_rows, rows)
        if tbl.kv is not None:
            # targeted in-place rewrite through the row store: handles stay
            # stable, and inside a pessimistic txn each record key is
            # locked at DML time (blocking conflicting writers)
            upd_handles = [handles[i] for i in midx]
            updated = [tuple(plainify(x) for x in rows[i]) for i in midx]
            if self.txn is not None:
                tbl.update_rows(upd_handles, old_rows, updated,
                                txn=self.txn)
                self._txn_note_table(tbl)
            else:
                tbl.update_rows(upd_handles, old_rows, updated)
        else:
            new_rows = [tuple(plainify(x) for x in r) for r in rows]
            tbl._fk_check_rows([new_rows[i] for i in midx])
            tbl.replace_columns(_rows_to_columns(tbl, new_rows))
        self.domain.stats.note_modify(tbl, n_aff, delta=0)
        return ResultSet(affected=n_aff)

    def _exec_delete(self, stmt: A.Delete) -> ResultSet:
        return self._retry_write_conflict(lambda: self._do_delete(stmt))

    def _do_delete(self, stmt: A.Delete) -> ResultSet:
        tbl = self.domain.catalog.get_table(getattr(stmt, 'db', None) or self.db, stmt.table)
        if self.txn is not None and tbl.kv is not None:
            self._txn_note_table(tbl)
        if stmt.where is None and stmt.limit is None:
            self._fk_on_delete(tbl, np.ones(tbl.num_rows, bool))
            if self.txn is not None and tbl.kv is not None:
                # DELETE without WHERE is still transactional (TRUNCATE
                # is the implicit-commit one): buffer row deletes
                n = tbl.delete_where(np.zeros(tbl.num_rows, bool),
                                     txn=self.txn)
            else:
                n = tbl.truncate()
            self.domain.stats.note_modify(tbl, n, delta=-n)
            return ResultSet(affected=n)
        if stmt.where is None:
            mask = np.ones(tbl.num_rows, bool)
            mask = self._dml_restrict_mask(tbl, mask, stmt.order_by,
                                           stmt.limit)
            self._fk_on_delete(tbl, mask)
            n = tbl.delete_where(~mask, txn=self.txn)
            self.domain.stats.note_modify(tbl, n, delta=-n)
            return ResultSet(affected=n)
        mask = self._where_mask(tbl, stmt.where)
        mask = self._dml_restrict_mask(tbl, mask, stmt.order_by,
                                       stmt.limit)
        if tbl.kv is not None and self._fk_children(tbl):
            # cascades may reshuffle this table's own snapshot (self-
            # referential FKs): pin the doomed rows by stable handle
            tbl.snapshot()
            del_handles = np.asarray(tbl._snapshot_handles)[mask].tolist()
            self._fk_on_delete(tbl, mask)
            n = tbl.delete_handles(del_handles, txn=self.txn)
        else:
            self._fk_on_delete(tbl, mask)
            n = tbl.delete_where(~mask, txn=self.txn)
        self.domain.stats.note_modify(tbl, n, delta=-n)
        return ResultSet(affected=n)

    def _lock_for_update(self, stmt) -> None:
        """SELECT ... FOR UPDATE: inside an explicit transaction, lock
        the matched rows of a single-table read so conflicting writers
        block until COMMIT (the pessimistic locking-read contract;
        adapter.go handles it via the ForUpdate flag).  Outside a
        transaction the read is a plain snapshot (locks would release
        immediately); multi-table locking reads are not supported."""
        if self.txn is None:
            return
        if not isinstance(stmt.from_, A.TableName):
            return
        try:
            tbl = self.domain.catalog.get_table(
                stmt.from_.db or self.db, stmt.from_.name)
        except Exception:
            return
        if getattr(tbl, "kv", None) is None \
                or getattr(tbl, "is_memtable", False):
            return
        from ..store.codec import record_key
        try:
            mask = self._where_mask(tbl, stmt.where)
        except Exception:
            # predicate not evaluable standalone (subqueries): lock the
            # whole scanned table — conservative, never under-locks
            mask = np.ones(tbl.num_rows, bool)
        tbl.snapshot()
        handles = (np.asarray(tbl._snapshot_handles)[mask]
                   if tbl._snapshot_handles is not None else [])
        if len(handles):
            self.txn.lock_keys(
                [record_key(tbl.table_id, int(h)) for h in handles])

    def _dml_restrict_mask(self, tbl, mask, order_by, limit,
                           cols=None, dicts=None):
        """Apply DML ORDER BY ... LIMIT n: keep only the first n matched
        rows in key order (UpdateExec/DeleteExec with ORDER BY+LIMIT).
        `cols`/`dicts` must be the SAME view the mask was computed over
        (txn membuffer views differ from the snapshot)."""
        if limit is None and not order_by:
            return mask
        idx = np.nonzero(mask)[0]
        if order_by:
            from ..expr.host_eval import eval_expr
            from ..expr.lower_strings import lower_strings
            from ..planner.build import ExprBuilder
            from ..planner.logical import Schema, SchemaCol
            if cols is None:
                snap = tbl.snapshot()
                cols = snap.columns
                dicts = snap.dictionaries
            sch = Schema([SchemaCol(nm, c.dtype)
                          for nm, c in zip(tbl.col_names, cols)])
            pairs = [(c.data, (True if c.validity.all() else c.validity))
                     for c in cols]
            n_all = len(cols[0]) if cols else 0
            keys = []
            for e_ast, desc in reversed(list(order_by)):
                ir = lower_strings(ExprBuilder(sch).build(e_ast),
                                   dicts or {})
                v, valid = eval_expr(np, ir, pairs)
                v = np.broadcast_to(np.asarray(v), (n_all,))[idx]
                if isinstance(valid, np.ndarray):
                    valid = np.broadcast_to(valid, (n_all,))[idx]
                else:
                    valid = np.broadcast_to(np.asarray(bool(valid)),
                                            (len(idx),))
                # Sort on dense ranks, not raw values: negating raw keys
                # wraps uint64 (0 stays 0 → sorts FIRST in DESC) and maps
                # INT64_MIN to itself. Ranks start at 1 so the NULL rank 0
                # sorts first ASC and (after negation) last DESC — MySQL's
                # NULL ordering.
                _, ranks = np.unique(v, return_inverse=True)
                ranks = ranks.astype(np.int64) + 1
                if desc:
                    ranks = -ranks
                keys.append(np.where(valid, ranks, 0))
            idx = idx[np.lexsort(tuple(keys))]
        if limit is not None:
            idx = idx[:limit]
        out = np.zeros(len(mask), bool)
        out[idx] = True
        return out

    def _fk_children(self, tbl):
        return [(t, fk)
                for t in self.domain.catalog.databases
                .get(self.db, {}).values()
                for fk in getattr(t, "foreign_keys", [])
                if fk.ref_table == tbl.name]

    def _fk_on_delete(self, tbl, del_mask, depth: int = 0):
        """RESTRICT rejects the delete while referencing child rows exist;
        CASCADE deletes them first (recursively — FKCascade exec).
        Cascade deletes go by STABLE handles: a sibling/deeper cascade may
        reshuffle a table's snapshot between mask computation and the
        delete, so positional masks cannot be trusted across levels.
        `del_mask` must align with tbl.snapshot() at call time."""
        if depth > 32:
            raise CatalogError("foreign key cascade depth exceeded")
        children = self._fk_children(tbl)
        if not children or not del_mask.any():
            return
        if depth == 0:
            # PRE-CHECK the whole cascade closure read-only first: a
            # RESTRICT violation behind a sibling CASCADE must reject the
            # statement BEFORE any child rows are deleted (MySQL rolls
            # the whole statement back)
            self._fk_check_delete(tbl, del_mask)
        snap = tbl.snapshot()
        excl = set()
        if tbl.kv is not None and tbl._snapshot_handles is not None:
            excl = set(np.asarray(tbl._snapshot_handles)[del_mask]
                       .tolist())
        for child, fk in children:
            pcol = snap.columns[tbl.col_names.index(fk.ref_column)]
            pvals = pcol.data[del_mask & pcol.validity]
            if not len(pvals):
                continue
            csnap = child.snapshot()
            ccol = csnap.columns[child.col_names.index(fk.column)]
            hit = ccol.validity & np.isin(ccol.data, pvals)
            if child is tbl and excl:
                hit = hit & ~np.isin(
                    np.asarray(child._snapshot_handles, dtype=np.int64),
                    np.asarray(sorted(excl), dtype=np.int64))
            if not hit.any():
                continue
            if fk.on_delete == "restrict":
                raise CatalogError(
                    "Cannot delete or update a parent row: a foreign "
                    f"key constraint fails (`{child.name}`.`{fk.column}` "
                    f"REFERENCES `{tbl.name}`.`{fk.ref_column}`)")
            n = int(hit.sum())
            if child.kv is not None:
                child_handles = np.asarray(child._snapshot_handles)[hit]
                self._fk_on_delete(child, hit, depth + 1)
                # cascades ride the SAME txn as the parent delete: a
                # rollback must restore the whole closure together
                child.delete_handles(child_handles.tolist(),
                                     txn=self.txn)
                if self.txn is not None:
                    self._txn_note_table(child)
            else:
                self._fk_on_delete(child, hit, depth + 1)
                child.delete_where(~hit)
            self.domain.stats.note_modify(child, n, delta=-n)

    def _fk_check_delete(self, tbl, del_mask, depth: int = 0):
        """Read-only pass over the cascade closure: raises on the first
        RESTRICT violation without mutating anything."""
        if depth > 32:
            raise CatalogError("foreign key cascade depth exceeded")
        children = self._fk_children(tbl)
        if not children or not del_mask.any():
            return
        snap = tbl.snapshot()
        excl = set()
        if tbl.kv is not None and tbl._snapshot_handles is not None:
            excl = set(np.asarray(tbl._snapshot_handles)[del_mask]
                       .tolist())
        for child, fk in children:
            pcol = snap.columns[tbl.col_names.index(fk.ref_column)]
            pvals = pcol.data[del_mask & pcol.validity]
            if not len(pvals):
                continue
            ccol = child.snapshot().columns[
                child.col_names.index(fk.column)]
            hit = ccol.validity & np.isin(ccol.data, pvals)
            if child is tbl and excl:
                hit = hit & ~np.isin(
                    np.asarray(child._snapshot_handles, dtype=np.int64),
                    np.asarray(sorted(excl), dtype=np.int64))
            if not hit.any():
                continue
            if fk.on_delete == "restrict":
                raise CatalogError(
                    "Cannot delete or update a parent row: a foreign "
                    f"key constraint fails (`{child.name}`.`{fk.column}` "
                    f"REFERENCES `{tbl.name}`.`{fk.ref_column}`)")
            self._fk_check_delete(child, hit, depth + 1)

    def _fk_parent_update_check(self, tbl, cols, midx, old_rows, rows):
        """Changing a referenced key value while child rows point at it is
        rejected (ON UPDATE RESTRICT — the only supported update action)."""
        children = self._fk_children(tbl)
        if not children:
            return
        ci = {n: i for i, n in enumerate(tbl.col_names)}
        for child, fk in children:
            pci = ci[fk.ref_column]
            changed = [int(i) for k, i in enumerate(midx)
                       if old_rows[k][pci] != rows[i][pci]]
            if not changed:
                continue
            pcol = cols[pci]
            sel = np.array(changed, dtype=np.int64)
            pvals = pcol.data[sel][pcol.validity[sel]]
            if not len(pvals):
                continue
            ccol = child.snapshot().columns[
                child.col_names.index(fk.column)]
            if (ccol.validity & np.isin(ccol.data, pvals)).any():
                raise CatalogError(
                    "Cannot delete or update a parent row: a foreign "
                    f"key constraint fails (`{child.name}`.`{fk.column}` "
                    f"REFERENCES `{tbl.name}`.`{fk.ref_column}`)")

    def _exec_show(self, stmt: A.ShowStmt) -> ResultSet:
        cat = self.domain.catalog
        if stmt.kind == "create table":
            tbl = cat.get_table(self.db, stmt.target)
            return ResultSet(["Table", "Create Table"],
                             [(tbl.name, _render_create_table(tbl))])
        if stmt.kind == "bindings":
            rows = []
            if stmt.target in (None, "session"):
                rows += [r + ("session",) for r in self.bindings.rows()]
            if stmt.target in (None, "global"):
                rows += [r + ("global",)
                         for r in self.domain.bindings.rows()]
            return ResultSet(
                ["Original_sql", "Bind_sql", "Status", "Scope"], rows)
        if stmt.kind == "processlist":
            # without PROCESS, only the caller's own sessions are visible
            # (mysql semantics; reference executor/show.go)
            see_all = self.domain.privileges.check(self.user, "PROCESS")
            return ResultSet(
                ["Id", "db", "Command", "State"],
                [(sid, sess.db, "Sleep" if sess is not self else "Query",
                  "autocommit" if sess.txn is None else "in transaction")
                 for sid, sess in self.domain.sessions()
                 if see_all or sess.user == self.user])
        if stmt.kind == "grants":
            if stmt.target:
                user, _, host = stmt.target.partition("@")
            else:
                user, host = self.user, "%"
            return ResultSet([f"Grants for {user}@{host}"],
                             [(g,) for g in
                              self.domain.privileges.show_grants(user, host)])
        if stmt.kind == "tables":
            from ..infoschema import is_system_db, system_tables
            if is_system_db(self.db):
                names = system_tables(self.db)
            else:
                names = sorted(set(cat.databases[self.db])
                               | set(cat.views.get(self.db, {})))
            return ResultSet([f"Tables_in_{self.db}"],
                             [(n,) for n in names])
        if stmt.kind == "databases":
            from ..infoschema import system_databases
            return ResultSet(["Database"],
                             [(n,) for n in sorted(list(cat.databases)
                                                   + system_databases())])
        if stmt.kind == "columns":
            t = cat.get_table(self.db, stmt.target)
            return ResultSet(["Field", "Type", "Null"],
                             [(n, str(ty), "YES" if ty.nullable else "NO")
                              for n, ty in zip(t.col_names, t.col_types)])
        if stmt.kind == "index":
            t = cat.get_table(self.db, stmt.target)
            return ResultSet(
                ["Table", "Key_name", "Non_unique", "Column_name"],
                [(t.name, ix.name, int(not ix.unique), ",".join(ix.columns))
                 for ix in t.indexes])
        if stmt.kind in ("stats_meta", "stats_histograms", "stats_topn"):
            return self._exec_show_stats(stmt.kind)
        if stmt.kind == "collation":
            from ..utils.collate import collation_rows
            rows = collation_rows()     # shared with infoschema
            if stmt.like:
                from ..expr.lower_strings import like_to_regex
                rx = like_to_regex(stmt.like.lower())
                rows = [r for r in rows if rx.match(r[0].lower())]
            return ResultSet(["Collation", "Charset", "Id", "Default",
                              "Compiled", "Sortlen", "Pad_attribute"],
                             rows)
        if stmt.kind == "charset":
            from ..utils.collate import charset_rows
            rows = [(cs, desc, dflt, ml)
                    for cs, dflt, desc, ml in charset_rows()]
            if stmt.like:
                from ..expr.lower_strings import like_to_regex
                rx = like_to_regex(stmt.like.lower())
                rows = [r for r in rows if rx.match(r[0].lower())]
            return ResultSet(["Charset", "Description",
                              "Default collation", "Maxlen"], rows)
        if stmt.kind == "variables":
            from .sysvars import REGISTRY
            vs = {name: ent.default for name, ent in REGISTRY.items()}
            vs.update(self.domain.sysvars)
            vs.update(self.vars)
            rows = sorted((k, "" if v is None else str(v))
                          for k, v in vs.items())
            if stmt.like:
                from ..expr.lower_strings import like_to_regex
                rx = like_to_regex(stmt.like.lower())
                rows = [r for r in rows if rx.match(r[0].lower())]
            return ResultSet(["Variable_name", "Value"], rows)
        if stmt.kind == "statements_summary":
            return ResultSet(
                ["Digest_text", "Exec_count", "Avg_latency_ms",
                 "Max_latency_ms", "Sum_rows", "Sample_sql",
                 "Avg_sched_wait_ms", "Avg_compile_ms",
                 "Sum_sched_tasks", "Sum_fused", "Avg_ru"],
                self.domain.stmt_summary.summary_rows())
        if stmt.kind == "slow_queries":
            return ResultSet(["Query", "Latency_ms", "Rows",
                              "Sched_wait_ms", "Compile_ms", "Ru",
                              "Retried", "Trace_id"],
                             self.domain.stmt_summary.slow_rows())
        if stmt.kind == "status":
            # the JAX package's quirks kept for parity: Uptime reads a
            # Domain._t0 that nothing sets (so it is 0) and Queries a
            # StmtSummary.rows() that does not exist (so it is 0)
            qs = sum(1 for _ in self.domain.sessions())
            rows = [("Threads_connected", str(qs)),
                    ("Uptime", str(int(time.time()
                                       - getattr(self.domain, "_t0",
                                                 time.time())))),
                    ("Ssl_cipher", ""),
                    ("Queries", str(len(self.domain.stmt_summary.rows())
                                    if hasattr(self.domain.stmt_summary,
                                               "rows") else 0))]
            if stmt.like:
                from ..expr.lower_strings import like_to_regex
                rx = like_to_regex(stmt.like.lower())
                rows = [r for r in rows if rx.match(r[0].lower())]
            return ResultSet(["Variable_name", "Value"], rows)
        raise PlanError(f"unsupported SHOW {stmt.kind}")

    def _exec_show_stats(self, kind: str) -> ResultSet:
        """SHOW STATS_META / STATS_HISTOGRAMS / STATS_TOPN (reference:
        executor/show_stats.go)."""
        cat = self.domain.catalog
        rows = []
        for db, tables in sorted(cat.databases.items()):
            for name in sorted(tables):
                tbl = tables[name]
                ts = self.domain.stats.get(tbl)
                if ts is None:
                    continue
                if kind == "stats_meta":
                    rows.append((db, name, ts.modify_count,
                                 ts.realtime_count))
                elif kind == "stats_histograms":
                    for cn, cs in sorted(ts.cols.items()):
                        rows.append((db, name, cn, cs.ndv, cs.null_count,
                                     len(cs.hist.bounds)))
                else:
                    for cn, cs in sorted(ts.cols.items()):
                        for v, c in sorted(cs.topn.values.items(),
                                           key=lambda kv: -kv[1]):
                            rows.append((db, name, cn, v, c))
        headers = {
            "stats_meta": ["Db_name", "Table_name", "Modify_count",
                           "Row_count"],
            "stats_histograms": ["Db_name", "Table_name", "Column_name",
                                 "Distinct_count", "Null_count",
                                 "Bucket_count"],
            "stats_topn": ["Db_name", "Table_name", "Column_name", "Value",
                           "Count"],
        }[kind]
        return ResultSet(headers, rows)

    def _exec_admin(self, stmt: A.AdminStmt) -> ResultSet:
        if stmt.kind == "show ddl jobs":
            rows = []
            for j in self.domain.ddl.storage.all_jobs():
                rows.append((j.job_id, j.job_type, j.db, j.table,
                             j.schema_state, j.state, j.rows_backfilled,
                             j.error))
            return ResultSet(
                ["Job_id", "Type", "Db", "Table", "Schema_state", "State",
                 "Row_count", "Error"], rows)
        if stmt.kind == "check table":
            return self._admin_check_table(stmt.target)
        if stmt.kind == "recommend index":
            from ..planner.advisor import recommend_indexes
            return ResultSet(
                ["Table", "Columns", "Est_benefit_execs", "Sample_sql"],
                recommend_indexes(self.domain, self.db))
        if stmt.kind == "checksum table":
            # br/pkg/checksum analog: order-independent XOR of per-pair
            # CRCs over the table's record+index ranges at one ts
            import zlib

            from ..store.codec import (index_prefix, index_prefix_end,
                                       record_prefix, record_prefix_end)
            tbl = self.domain.catalog.get_table(self.db, stmt.target)
            ts = self.domain.kv.alloc_ts()
            cksum = kvs = nbytes = 0
            for lo, hi in ((record_prefix(tbl.table_id),
                            record_prefix_end(tbl.table_id)),
                           (index_prefix(tbl.table_id),
                            index_prefix_end(tbl.table_id))):
                for k, v in self.domain.kv.scan(lo, hi, ts):
                    cksum ^= zlib.crc32(v, zlib.crc32(k))
                    kvs += 1
                    nbytes += len(k) + len(v)
            return ResultSet(
                ["Db_name", "Table_name", "Checksum_crc32_xor",
                 "Total_kvs", "Total_bytes"],
                [(self.db, tbl.name, cksum, kvs, nbytes)])
        raise PlanError(f"unsupported ADMIN {stmt.kind}")

    def _admin_check_table(self, name: str) -> ResultSet:
        """Row <-> index consistency check (executor/check_table_index.go
        analog): recompute every index entry from rows and compare with
        the stored index keyspace."""
        tbl = self.domain.catalog.get_table(self.db, name)
        if tbl.kv is None:
            return ResultSet()   # bulk snapshots carry no indexes
        from ..session.codec_io import scan_table_rows
        from ..store.codec import index_prefix, index_prefix_end
        ts = tbl.kv.alloc_ts()
        handles, rows = scan_table_rows(tbl.kv, tbl.table_id, ts,
                                        tbl.col_types)
        for ix in tbl.indexes:
            if ix.state != "public":
                continue
            want = set()
            for h, r in zip(handles, rows):
                key, _ = tbl._index_entry(ix, tuple(r), int(h))
                want.add(key)
            got = {k for k, _ in tbl.kv.scan(
                index_prefix(tbl.table_id, ix.index_id),
                index_prefix_end(tbl.table_id, ix.index_id), ts)}
            if want != got:
                raise CatalogError(
                    f"admin check table {name}: index {ix.name!r} "
                    f"inconsistent (missing {len(want - got)}, "
                    f"orphan {len(got - want)})")
        return ResultSet()

    def _literal_value(self, node: A.Node):
        if isinstance(node, A.Lit):
            if node.kind in ("int", "bool"):
                return int(node.value)
            if node.kind == "float":
                return float(node.value)
            if node.kind == "decimal":
                return str(node.value)
            return node.value
        if isinstance(node, A.Unary) and node.op == "-":
            v = self._literal_value(node.arg)
            return -v if not isinstance(v, str) else "-" + v
        # general scalar expressions in VALUES: NOW(), NEXTVAL(seq),
        # arithmetic... evaluated through the expression engine
        # (the reference's insert value expression eval)
        try:
            return plainify(self._eval_scalar(node))
        except PlanError:
            raise
        except Exception as e:
            raise PlanError(f"unsupported INSERT value expression: {e}")


def _plan_cacheable(phys) -> bool:
    """A cached plan must hold no materialized row state: CTE scans carry
    a shared storage (executor CTEScanExec.storage) that memoizes results
    and races across sessions — exclude them (the reference likewise
    skips caching for non-deterministic/stateful plans)."""
    stack = [phys]
    while stack:
        p = stack.pop()
        if hasattr(p, "storage"):
            return False
        stack.extend(getattr(p, "children", ()))
    return True


def _flag_on(merged: dict, name: str, default: bool = True) -> bool:
    """Boolean sysvar semantics tolerant of ON/OFF/1/0/None values."""
    v = merged.get(name)
    if v is None:
        return default
    try:
        return int(v) != 0
    except (TypeError, ValueError):
        return str(v).strip().lower() in ("on", "true", "1", "yes")


def _rows_to_columns(tbl: TableInfo, rows: list[tuple]):
    from ..chunk.column import Column
    cols = []
    for i, t in enumerate(tbl.col_types):
        cols.append(Column.from_values(t, [r[i] for r in rows]))
    return cols


def _decode_val(v, t: dt.DataType):
    from ..types import decimal as dec, temporal as tmp
    k = t.kind
    if k == dt.TypeKind.DECIMAL:
        return dec.to_string(int(v), t.scale)
    if k == dt.TypeKind.DATE:
        return tmp.date_to_string(int(v))
    if k == dt.TypeKind.DATETIME:
        return tmp.datetime_to_string(int(v))
    if k in (dt.TypeKind.FLOAT64, dt.TypeKind.FLOAT32):
        return float(v)
    return int(v)




def _render_create_table(tbl) -> str:
    """SHOW CREATE TABLE rendering (executor/show.go ConstructResultOfShow
    CreateTable analog)."""
    from ..types import dtypes as dt
    from ..utils.collate import is_binary
    K = dt.TypeKind
    lines = []
    for name, t in zip(tbl.col_names, tbl.col_types):
        if t.kind == K.DECIMAL:
            ty = f"decimal({t.prec},{t.scale})"
        elif t.kind == K.ENUM:
            ty = "enum(" + ",".join(f"'{m}'" for m in t.members) + ")"
        elif t.kind == K.SET:
            ty = "set(" + ",".join(f"'{m}'" for m in t.members) + ")"
        elif t.kind == K.BIT:
            ty = f"bit({t.prec})"
        else:
            ty = t.kind.value
        line = f"  `{name}` {ty}"
        if t.kind == K.STRING and not is_binary(t.collation):
            line += f" COLLATE {t.collation}"
        if not t.nullable:
            line += " NOT NULL"
        if tbl.auto_inc_col == name:
            line += " AUTO_INCREMENT"
        lines.append(line)
    if tbl.primary_key:
        lines.append("  PRIMARY KEY (" +
                     ",".join(f"`{c}`" for c in tbl.primary_key) + ")")
    for ix in getattr(tbl, "indexes", []):
        if ix.state != "public" or ix.name.upper() == "PRIMARY":
            continue      # the PK's backing index renders as PRIMARY KEY
        kind = "UNIQUE KEY" if ix.unique else "KEY"
        lines.append(f"  {kind} `{ix.name}` (" +
                     ",".join(f"`{c}`" for c in ix.columns) + ")")
    return (f"CREATE TABLE `{tbl.name}` (\n" + ",\n".join(lines) +
            "\n) ENGINE=tpu-columnar DEFAULT CHARSET=utf8mb4")


__all__ = ["Session", "Domain", "ResultSet"]
