# ported from tidb_tpu/infoschema/__init__.py @ 9d319cb
"""information_schema / performance_schema memtable readers.

Reference analog: pkg/infoschema/tables.go (virtual memtable definitions)
and pkg/executor/infoschema_reader.go (the retrievers).  Tables here are
SQL-queryable views over live engine state — catalog, sessions, statement
summary, slow log, DDL jobs, stats, sysvars — produced on demand as host
rows (they never touch the device path; selections/projections/joins over
them run in the host root executors).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

from ..types import dtypes as dt

S = dt.varchar()
I = dt.bigint(True)
F = dt.double(True)


@dataclass(eq=False)
class MemTableInfo:
    """A virtual table: schema + row producer over the Domain.

    Quacks like catalog.TableInfo for the planner (col_names/col_types/
    indexes); executor/plan.py routes it to MemTableExec instead of a
    CopTask (infoschema_reader.go retriever role)."""
    name: str
    col_names: list[str]
    col_types: list
    producer: Callable          # (domain) -> list[tuple]
    indexes: list = field(default_factory=list)
    is_memtable: bool = True
    table_id: int = -1
    domain: object = None        # bound by Catalog.get_table
    _epoch: int = 0              # plan-cache fingerprint: rows are read at
                                 # execute time, so plans never go stale

    def snapshot(self):          # pragma: no cover - guarded by planner
        raise TypeError(f"memtable {self.name} has no columnar snapshot")

    @property
    def num_rows(self) -> int:
        return 0                 # planner cardinality: unknown/small


def _schemata(dom):
    return [("def", db, "utf8mb4", "utf8mb4_bin")
            for db in sorted(dom.catalog.databases)]


def _thread_pools(dom):
    from ..utils.poolmgr import MANAGER
    return MANAGER.stats_rows()


def _collations(dom):
    from ..utils.collate import collation_rows
    return collation_rows()


def _character_sets(dom):
    from ..utils.collate import charset_rows
    return charset_rows()


def _tables(dom):
    rows = []
    for db in sorted(dom.catalog.databases):
        for t in sorted(dom.catalog.databases[db].values(),
                        key=lambda x: x.name):
            rows.append(("def", db, t.name, "BASE TABLE", "tpu-columnar",
                         t.num_rows, t.table_id))
    return rows


def _type_name(t) -> str:
    if t.kind == dt.TypeKind.DECIMAL:
        return f"decimal({t.prec},{t.scale})"
    return t.kind.value


def _columns(dom):
    rows = []
    K = dt.TypeKind
    for db in sorted(dom.catalog.databases):
        for t in sorted(dom.catalog.databases[db].values(),
                        key=lambda x: x.name):
            for i, (cn, ct) in enumerate(zip(t.col_names, t.col_types)):
                prec = ct.prec if ct.kind == K.DECIMAL else None
                scale = ct.scale if ct.kind == K.DECIMAL else None
                rows.append(("def", db, t.name, cn, i + 1,
                             "YES" if ct.nullable else "NO",
                             _type_name(ct), prec, scale))
    return rows


def _statistics(dom):
    rows = []
    for db in sorted(dom.catalog.databases):
        for t in sorted(dom.catalog.databases[db].values(),
                        key=lambda x: x.name):
            for ix in getattr(t, "indexes", []):
                for seq, col in enumerate(ix.columns):
                    rows.append(("def", db, t.name,
                                 0 if ix.unique else 1, ix.name,
                                 seq + 1, col))
    return rows


def _tidb_indexes(dom):
    rows = []
    for db in sorted(dom.catalog.databases):
        for t in sorted(dom.catalog.databases[db].values(),
                        key=lambda x: x.name):
            for ix in getattr(t, "indexes", []):
                for seq, col in enumerate(ix.columns):
                    rows.append((db, t.name, ix.name, col, seq + 1,
                                 0 if ix.unique else 1, ix.index_id,
                                 ix.state))
    return rows


def _processlist(dom):
    return [(sid, sess.user, "127.0.0.1", sess.db,
             "Query", 0,
             "autocommit" if sess.txn is None else "in transaction", "")
            for sid, sess in dom.sessions()]


def _slow_query(dom):
    return [(sql, ms / 1000.0, rows, wait_ms, compile_ms, ru, retried,
             trace_id)
            for sql, ms, rows, wait_ms, compile_ms, ru, retried, trace_id
            in dom.stmt_summary.slow_rows()]


def _stmt_summary(dom):
    return dom.stmt_summary.summary_rows()


def _top_sql(dom):
    return dom.stmt_summary.top_sql_rows()


def _views(dom):
    rows = []
    for db in sorted(dom.catalog.views):
        for v in sorted(dom.catalog.views[db].values(),
                        key=lambda x: x.name):
            rows.append(("def", db, v.name, v.select_sql, "NONE",
                         "YES" if not v.columns else "NO"))
    return rows


def _partitions(dom):
    rows = []
    for db in sorted(dom.catalog.databases):
        for t in sorted(dom.catalog.databases[db].values(),
                        key=lambda x: x.name):
            spec = getattr(t, "partition", None)
            if spec is None:
                rows.append(("def", db, t.name, None, None, None, None,
                             t.num_rows))
                continue
            try:
                snap = t.snapshot()
                pid = t._partition_index(
                    snap.columns[t.col_names.index(spec.column)])
            except Exception:
                pid = None
            for i, (pname, bound) in enumerate(spec.parts):
                n = int((pid == i).sum()) if pid is not None else None
                rows.append(("def", db, t.name, pname, i + 1,
                             spec.kind.upper(),
                             "MAXVALUE" if spec.kind == "range"
                             and bound is None else
                             (str(bound) if bound is not None else None),
                             n))
    return rows


def _key_column_usage(dom):
    rows = []
    for db in sorted(dom.catalog.databases):
        for t in sorted(dom.catalog.databases[db].values(),
                        key=lambda x: x.name):
            for ix in getattr(t, "indexes", []):
                if not ix.unique:
                    continue
                for seq, col in enumerate(ix.columns):
                    rows.append(("def", db, ix.name, db, t.name, col,
                                 seq + 1, None, None))
            for k, fk in enumerate(getattr(t, "foreign_keys", [])):
                rows.append(("def", db, fk.name or f"fk_{t.name}_{k + 1}",
                             db, t.name, fk.column, 1,
                             fk.ref_table, fk.ref_column))
    return rows


def _referential_constraints(dom):
    rows = []
    for db in sorted(dom.catalog.databases):
        for t in sorted(dom.catalog.databases[db].values(),
                        key=lambda x: x.name):
            for k, fk in enumerate(getattr(t, "foreign_keys", [])):
                rows.append(("def", db,
                             fk.name or f"fk_{t.name}_{k + 1}",
                             t.name, fk.ref_table,
                             fk.on_delete.upper()))
    return rows


def _workload_repo(dom):
    return [(time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts)),
             dig, cnt, avg, mx, rows)
            for ts, dig, cnt, avg, mx, rows
            in getattr(dom, "workload_repo", [])]


def _ddl_jobs(dom):
    if dom._ddl is None:
        return []
    return [(j.job_id, j.db, j.table, j.job_type, j.schema_state, j.state,
             j.rows_backfilled, j.error)
            for j in dom.ddl.storage.all_jobs()]


def _session_variables(dom):
    return sorted((k, str(v)) for k, v in dom.sysvars.items())


def _stats_meta(dom):
    rows = []
    for db in sorted(dom.catalog.databases):
        for t in sorted(dom.catalog.databases[db].values(),
                        key=lambda x: x.name):
            st = dom.stats.get(t)
            if st is None:
                continue
            rows.append((db, t.name, st.version, st.count, st.modify_count))
    return rows


def _resource_groups(dom):
    return dom.resource_groups.rows()


def _dist_tasks(dom):
    m = getattr(dom, "_dxf", None)
    if m is None:
        return []
    return [(t.task_id, t.task_type, t.state,
             sum(1 for s in t.subtasks if s.state == "succeed"),
             len(t.subtasks), t.error)
            for t in m.tasks()]


def _cluster_info(dom):
    # the port's client: its device type ("cuda" or "cpu") and the
    # logical devices it fans a cop task out over
    devs = dom.client.devices
    return [("tidb-tpu", "127.0.0.1:4000", "0.2.0", devs[0].type,
             len(devs))]


_INFORMATION_SCHEMA = {
    "SCHEMATA": ([("CATALOG_NAME", S), ("SCHEMA_NAME", S),
                  ("DEFAULT_CHARACTER_SET_NAME", S),
                  ("DEFAULT_COLLATION_NAME", S)], _schemata),
    "TABLES": ([("TABLE_CATALOG", S), ("TABLE_SCHEMA", S),
                ("TABLE_NAME", S), ("TABLE_TYPE", S), ("ENGINE", S),
                ("TABLE_ROWS", I), ("TIDB_TABLE_ID", I)], _tables),
    "COLLATIONS": ([("COLLATION_NAME", S), ("CHARACTER_SET_NAME", S),
                    ("ID", I), ("IS_DEFAULT", S), ("IS_COMPILED", S),
                    ("SORTLEN", I), ("PAD_ATTRIBUTE", S)], _collations),
    "CHARACTER_SETS": ([("CHARACTER_SET_NAME", S),
                        ("DEFAULT_COLLATE_NAME", S), ("DESCRIPTION", S),
                        ("MAXLEN", I)], _character_sets),
    "THREAD_POOLS": ([("NAME", S), ("WORKERS", I), ("SUBMITTED", I),
                      ("COMPLETED", I), ("BUSY", I), ("WAIT_MS", I),
                      ("RUN_MS", I)], _thread_pools),
    "COLUMNS": ([("TABLE_CATALOG", S), ("TABLE_SCHEMA", S),
                 ("TABLE_NAME", S), ("COLUMN_NAME", S),
                 ("ORDINAL_POSITION", I), ("IS_NULLABLE", S),
                 ("DATA_TYPE", S), ("NUMERIC_PRECISION", I),
                 ("NUMERIC_SCALE", I)], _columns),
    "STATISTICS": ([("TABLE_CATALOG", S), ("TABLE_SCHEMA", S),
                    ("TABLE_NAME", S), ("NON_UNIQUE", I),
                    ("INDEX_NAME", S), ("SEQ_IN_INDEX", I),
                    ("COLUMN_NAME", S)], _statistics),
    "TIDB_INDEXES": ([("TABLE_SCHEMA", S), ("TABLE_NAME", S),
                      ("KEY_NAME", S), ("COLUMN_NAME", S),
                      ("SEQ_IN_INDEX", I), ("NON_UNIQUE", I),
                      ("INDEX_ID", I), ("STATE", S)], _tidb_indexes),
    "PROCESSLIST": ([("ID", I), ("USER", S), ("HOST", S), ("DB", S),
                     ("COMMAND", S), ("TIME", I), ("STATE", S),
                     ("INFO", S)], _processlist),
    "SLOW_QUERY": ([("QUERY", S), ("QUERY_TIME", F),
                    ("ROWS_SENT", I), ("SCHED_WAIT_MS", F),
                    ("COMPILE_MS", F), ("RU", F), ("RETRIED", I),
                    ("TRACE_ID", S)], _slow_query),
    "STATEMENTS_SUMMARY": ([("DIGEST_TEXT", S), ("EXEC_COUNT", I),
                            ("AVG_LATENCY_MS", F), ("MAX_LATENCY_MS", F),
                            ("SUM_ROWS", I), ("QUERY_SAMPLE_TEXT", S),
                            ("AVG_SCHED_WAIT_MS", F),
                            ("AVG_COMPILE_MS", F),
                            ("SUM_SCHED_TASKS", I), ("SUM_FUSED", I),
                            ("AVG_RU", F)],
                           _stmt_summary),
    "VIEWS": ([("TABLE_CATALOG", S), ("TABLE_SCHEMA", S),
               ("TABLE_NAME", S), ("VIEW_DEFINITION", S),
               ("CHECK_OPTION", S), ("IS_UPDATABLE", S)], _views),
    "PARTITIONS": ([("TABLE_CATALOG", S), ("TABLE_SCHEMA", S),
                    ("TABLE_NAME", S), ("PARTITION_NAME", S),
                    ("PARTITION_ORDINAL_POSITION", I),
                    ("PARTITION_METHOD", S),
                    ("PARTITION_DESCRIPTION", S),
                    ("TABLE_ROWS", I)], _partitions),
    "KEY_COLUMN_USAGE": ([("CONSTRAINT_CATALOG", S),
                          ("CONSTRAINT_SCHEMA", S),
                          ("CONSTRAINT_NAME", S), ("TABLE_SCHEMA", S),
                          ("TABLE_NAME", S), ("COLUMN_NAME", S),
                          ("ORDINAL_POSITION", I),
                          ("REFERENCED_TABLE_NAME", S),
                          ("REFERENCED_COLUMN_NAME", S)],
                         _key_column_usage),
    "REFERENTIAL_CONSTRAINTS": ([("CONSTRAINT_CATALOG", S),
                                 ("CONSTRAINT_SCHEMA", S),
                                 ("CONSTRAINT_NAME", S),
                                 ("TABLE_NAME", S),
                                 ("REFERENCED_TABLE_NAME", S),
                                 ("DELETE_RULE", S)],
                                _referential_constraints),
    "WORKLOAD_REPO_STATEMENTS": ([("SNAPSHOT_TS", S), ("SQL_DIGEST", S),
                                  ("EXEC_COUNT", I), ("AVG_LATENCY_MS", F),
                                  ("MAX_LATENCY_MS", F), ("SUM_ROWS", I)],
                                 _workload_repo),
    "TIDB_TOP_SQL": ([("SQL_DIGEST", S), ("PLAN_DIGEST", S),
                      ("CPU_TIME_MS", F), ("EXEC_COUNT", I),
                      ("AVG_LATENCY_MS", F), ("QUERY_SAMPLE_TEXT", S),
                      ("PLAN", S)], _top_sql),
    "DDL_JOBS": ([("JOB_ID", I), ("DB_NAME", S), ("TABLE_NAME", S),
                  ("JOB_TYPE", S), ("SCHEMA_STATE", S), ("STATE", S),
                  ("ROW_COUNT", I), ("ERROR", S)], _ddl_jobs),
    "SESSION_VARIABLES": ([("VARIABLE_NAME", S), ("VARIABLE_VALUE", S)],
                          _session_variables),
    "TIDB_STATS_META": ([("DB_NAME", S), ("TABLE_NAME", S),
                         ("VERSION", I), ("ROW_COUNT", I),
                         ("MODIFY_COUNT", I)], _stats_meta),
    "CLUSTER_INFO": ([("TYPE", S), ("INSTANCE", S), ("VERSION", S),
                      ("DEVICE_PLATFORM", S), ("DEVICE_COUNT", I)],
                     _cluster_info),
    "RESOURCE_GROUPS": ([("NAME", S), ("RU_PER_SEC", I), ("BURSTABLE", S),
                         ("EXEC_ELAPSED_SEC", F), ("RUNAWAY_ACTION", S),
                         ("RUNAWAY_COUNT", I), ("PRIORITY", S)],
                        _resource_groups),
    "DIST_TASKS": ([("TASK_ID", I), ("TYPE", S), ("STATE", S),
                    ("SUBTASKS_DONE", I), ("SUBTASKS_TOTAL", I),
                    ("ERROR", S)], _dist_tasks),
}

_PERFORMANCE_SCHEMA = {
    "EVENTS_STATEMENTS_SUMMARY_BY_DIGEST":
        _INFORMATION_SCHEMA["STATEMENTS_SUMMARY"],
    "SESSION_VARIABLES": _INFORMATION_SCHEMA["SESSION_VARIABLES"],
    "PROCESSLIST": _INFORMATION_SCHEMA["PROCESSLIST"],
}

_REGISTRY = {"information_schema": _INFORMATION_SCHEMA,
             "performance_schema": _PERFORMANCE_SCHEMA}


def is_system_db(db: str) -> bool:
    return db.lower() in _REGISTRY


def system_databases() -> list[str]:
    return sorted(_REGISTRY)


def system_tables(db: str) -> list[str]:
    return sorted(_REGISTRY.get(db.lower(), {}))


def get_memtable(db: str, name: str) -> MemTableInfo:
    tables = _REGISTRY.get(db.lower())
    if tables is None:
        raise KeyError(db)
    spec = tables.get(name.upper())
    if spec is None:
        from ..session.catalog import CatalogError
        raise CatalogError(f"table {db}.{name} doesn't exist")
    cols, producer = spec
    return MemTableInfo(name.upper(), [c for c, _ in cols],
                        [t for _, t in cols], producer)


__all__ = ["MemTableInfo", "is_system_db", "system_databases",
           "system_tables", "get_memtable"]
