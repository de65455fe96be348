"""The memtables of the port against the JAX session's: after the same
DDL and DML through both sessions, every ``INFORMATION_SCHEMA`` (and
``PERFORMANCE_SCHEMA``) table answers with the JAX session's rows,
parametrised by table.  Time-valued columns (latencies, CPU and wait
milliseconds, snapshot and statistics timestamps) are left out of the
comparison, as is ``CLUSTER_INFO``'s device platform ("cuda" or "cpu"
in the port, the JAX backend's platform there), and the plan digest of
``TIDB_TOP_SQL``, whose plan text names the cop task's device.  Then
``ADMIN RECOMMEND INDEX`` (planner/advisor over the statement summary)
and the extension points (extension/: bootstrap, system variables, a
scalar SQL function, session hooks) against the JAX package's.
"""

import re

import pytest

from tidb_tpu import extension as jext
from tidb_tpu.session import Domain as JDomain
from tidb_tpu.session import Session as JSession
from tidb_tpu_torch import extension as pext
from tidb_tpu_torch.infoschema import (_INFORMATION_SCHEMA,
                                       _PERFORMANCE_SCHEMA)
from tidb_tpu_torch.session import Domain, Session

SETUP = [
    "set global tidb_enable_auto_analyze = 0",
    "set global tidb_tpu_slow_threshold_ms = 0",   # every statement slow
    "create database shop",
    "use shop",
    "create table cust (id bigint primary key, name varchar(20), "
    "city varchar(10), unique key uk_name (name))",
    "create table ord (oid bigint primary key, cid bigint, "
    "amt decimal(10,2), day date, key ix_cid (cid), "
    "foreign key fk_c (cid) references cust (id) on delete cascade)",
    "create table part_t (k bigint, v bigint) partition by range (k) "
    "(partition p0 values less than (10), "
    "partition p1 values less than (maxvalue))",
    "create table ev (id bigint, created datetime) "
    "TTL = created + INTERVAL 1 DAY",
    "create view big as select id, name from cust where id > 1",
    "insert into cust values (1,'ann','x'),(2,'bob','y'),(3,'cy','x'),"
    "(4,'dee',null)",
    "insert into ord values (10,1,5.50,'2020-01-01'),"
    "(11,2,7.25,'2020-01-02'),(12,1,1.00,'2020-02-01')",
    "insert into part_t values (1,1),(5,2),(20,3)",
    "update ord set amt = amt + 1 where oid = 12",
    "delete from part_t where k = 5",
    "analyze table cust",
    "analyze table ord",
    "select * from cust where city = 'x'",
    "select * from cust where city = 'x'",
    "select sum(amt) from ord where day = '2020-01-01'",
    "select count(*) from part_t where v = 3",
    "create index ix_day on ord (day)",
    "drop index ix_cid on ord",
]

# columns whose values are times (or stamped with one), by table
_TIMED = {
    "THREAD_POOLS": {"WAIT_MS", "RUN_MS"},     # (compared as deltas)
    "PROCESSLIST": {"TIME"},
    # (and the trace id: a process-wide sequence, which the other test
    # files a worker ran advance apart in the two packages; its form is
    # checked below)
    "SLOW_QUERY": {"QUERY_TIME", "SCHED_WAIT_MS", "COMPILE_MS", "TRACE_ID"},
    "STATEMENTS_SUMMARY": {"AVG_LATENCY_MS", "MAX_LATENCY_MS",
                           "AVG_SCHED_WAIT_MS", "AVG_COMPILE_MS"},
    "EVENTS_STATEMENTS_SUMMARY_BY_DIGEST": {
        "AVG_LATENCY_MS", "MAX_LATENCY_MS", "AVG_SCHED_WAIT_MS",
        "AVG_COMPILE_MS"},
    "WORKLOAD_REPO_STATEMENTS": {"SNAPSHOT_TS", "AVG_LATENCY_MS",
                                 "MAX_LATENCY_MS"},
    "TIDB_STATS_META": {"VERSION"},
    "CLUSTER_INFO": {"DEVICE_PLATFORM"},
    # the plan text names the cop task's device ("-> TPU" in the JAX
    # package, "-> cpu" here; compared with the names swapped), and the
    # plan digest hashes that text
    "TIDB_TOP_SQL": {"CPU_TIME_MS", "AVG_LATENCY_MS", "PLAN_DIGEST"},
}

_TABLES = [("information_schema", t) for t in sorted(_INFORMATION_SCHEMA)] \
    + [("performance_schema", t) for t in sorted(_PERFORMANCE_SCHEMA)]


def _pair():
    """A JAX session and a port session, both bypassing their device
    schedulers (the statement summary's scheduler columns then read the
    same) and the port on the JAX mesh's eight logical devices."""
    jd = JDomain()
    jd.client.sched_enable = False          # no scheduler daemon threads
    jd.stats.auto_analyze_enabled = False   # no background ANALYZE
    pd = Domain("cpu", n_devices=8)
    pd.client.sched_enable = False
    return JSession(jd), Session(pd)


def _pool_counts(mgr) -> dict:
    """NAME -> (SUBMITTED, COMPLETED) of a package's process-wide pool
    manager (the THREAD_POOLS producer's source)."""
    return {r[0]: (r[2], r[3]) for r in mgr.stats_rows()}


@pytest.fixture(scope="module")
def sessions():
    from tidb_tpu.utils.poolmgr import MANAGER as jpools
    from tidb_tpu_torch.utils.poolmgr import MANAGER as ppools
    js, ps = _pair()
    pools_before = (_pool_counts(jpools), _pool_counts(ppools))
    for s in (js, ps):
        for sql in SETUP:
            s.execute(sql)
        # both the workload repository and the DXF table hold rows
        s.domain.snapshot_workload_repo()
        s.domain.dxf.run(s.domain.dxf.submit("analyze", {
            "db": "shop", "tables": ["part_t"]}))
    # every memtable read once, in one order in both sessions (each read
    # is itself a statement the summary records); TIDB_TOP_SQL first,
    # while the digests are fewer than its top 30
    order = sorted(_TABLES, key=lambda dt: (dt[1] != "TIDB_TOP_SQL", dt))
    answers = {(db, t): (js.execute(f"select * from {db}.{t}"),
                         ps.execute(f"select * from {db}.{t}"))
               for db, t in order}
    answers["pools_before"] = pools_before
    return js, ps, answers


def _pool_deltas(res, before: dict) -> list:
    """THREAD_POOLS' rows as this module's statements moved them: the
    pools and their counters are process-wide, and the other test files
    a worker ran before this one advance the two packages' apart."""
    out = []
    for name, _workers, sub, done, busy, _w, _r in res.rows:
        s0, d0 = before.get(name, (0, 0))
        if (sub - s0, done - d0) != (0, 0):
            out.append((name, sub - s0, done - d0, busy))
    return sorted(out)


def _masked(res, table):
    timed = _TIMED.get(table, set())
    keep = [i for i, n in enumerate(res.names) if n.upper() not in timed]
    rows = [tuple(v.replace("-> cpu", "-> TPU") if res.names[i] == "PLAN"
                  else v for i, v in enumerate(r) if i in keep)
            for r in res.rows]
    return [res.names[i] for i in keep], sorted(rows, key=repr)


@pytest.mark.parametrize("db,table", _TABLES,
                         ids=[f"{d}.{t}" for d, t in _TABLES])
def test_memtable_rows_equal_the_jax_session(sessions, db, table):
    want, got = sessions[2][(db, table)]
    assert got.names == want.names
    if table == "THREAD_POOLS":
        jb, pb = sessions[2]["pools_before"]
        assert _pool_deltas(got, pb) == _pool_deltas(want, jb)
        assert _pool_deltas(got, pb), got.rows
        return
    assert _masked(got, table) == _masked(want, table)


def test_slow_query_trace_ids_name_the_sessions_connection(sessions):
    js, ps, answers = sessions
    for sess, res in zip((js, ps),
                         answers[("information_schema", "SLOW_QUERY")]):
        i = res.names.index("TRACE_ID")
        ids = [r[i] for r in res.rows]
        assert ids and all(re.fullmatch(rf"{sess.conn_id}-[0-9a-f]{{6,}}", t)
                           for t in ids), ids
        assert len(set(ids)) == len(ids)


def test_every_memtable_is_compared():
    assert len(_TABLES) == len(_INFORMATION_SCHEMA) + \
        len(_PERFORMANCE_SCHEMA)
    assert set(_TIMED) <= {t for _d, t in _TABLES}


def test_memtable_in_a_query_with_filters_and_joins(sessions):
    js, ps, _answers = sessions
    for sql in (
            "select table_name, table_rows from information_schema.tables "
            "where table_schema = 'shop' order by table_name",
            "select c.table_name, count(*) from information_schema.columns c"
            " join information_schema.tables t on c.table_name = "
            "t.table_name and c.table_schema = t.table_schema "
            "where t.table_schema = 'shop' group by c.table_name "
            "order by c.table_name",
            "select count(*) from information_schema.statistics "
            "where non_unique = 0",
            "select state, subtasks_total from information_schema.dist_tasks"):
        assert ps.execute(sql).rows == js.execute(sql).rows, sql


def test_cluster_info_names_the_ports_devices(sessions):
    _js, ps, _answers = sessions
    assert ps.execute("select device_platform, device_count from "
                      "information_schema.cluster_info").rows == [("cpu", 8)]


# ------------------------------------------------------------------ #
# ADMIN RECOMMEND INDEX
# ------------------------------------------------------------------ #

def test_admin_recommend_index_equals_the_jax_advisor(sessions):
    js, ps, _answers = sessions
    want, got = js.execute("admin recommend index"), \
        ps.execute("admin recommend index")
    assert got.names == want.names == ["Table", "Columns",
                                       "Est_benefit_execs", "Sample_sql"]
    assert got.rows == want.rows
    assert ("cust", "city", 2, "select * from cust where city = 'x'") \
        in got.rows


def test_admin_recommend_index_after_a_point_lookup_workload():
    out = []
    for s in _pair():
        s.execute("create table pl (id bigint, k bigint, v bigint, "
                  "key ix_v (v))")
        s.execute("insert into pl values " + ",".join(
            f"({i}, {i % 50}, {i % 7})" for i in range(200)))
        for i in range(6):
            s.execute(f"select id from pl where k = {i}")
        for i in range(3):
            s.execute(f"select id from pl where id = {i} and k = {i}")
        s.execute("select id from pl where v = 3")        # indexed
        out.append(s.execute("admin recommend index").rows)
    assert out[1] == out[0]
    assert [r[:3] for r in out[1]] == [("pl", "k", 6), ("pl", "id,k", 3)]


# ------------------------------------------------------------------ #
# the extension points
# ------------------------------------------------------------------ #

class _Audit:
    """A plugin-style hook object an extension hands to the Domain."""

    name = ""

    def __init__(self):
        self.events = []

    def on_general_event(self, sess, sql, status, err=None):
        self.events.append((sql, status))


def test_extension_points_match_the_jax_extension():
    outs = []
    for ext, mk in ((jext, lambda: _pair()[0]), (pext, lambda: _pair()[1])):
        seen = []
        try:
            ext.register(
                "test-ext",
                bootstrap=lambda dom: seen.append(dom),
                functions={"triple_plus": (lambda x, y: 3 * x + y, 2)},
                sysvars=[("test_ext_mode", "fast")],
            )
            with pytest.raises(ValueError):
                ext.register("test-ext")        # one name, one extension
            s = mk()
            assert seen and seen[0] is s.domain
            s.execute("create table ext_t (a bigint, b bigint)")
            s.execute("insert into ext_t values (1, 2), (10, 5), (null, 1)")
            got = s.execute(
                "select triple_plus(a, b) from ext_t order by b").rows
            outs.append((s.domain.sysvars.get("test_ext_mode"), got,
                         [e.name for e in ext.registry.extensions()]))
        finally:
            assert ext.registry.unregister("test-ext")
    assert outs[1] == outs[0]
    assert outs[1][0] == "fast" and \
        [g[0] for g in outs[1][1]] == [None, 5.0, 35.0]


def test_extension_session_hooks_join_the_plugin_registry():
    from tidb_tpu_torch.plugin import registry as plugins
    audit = _Audit()
    try:
        pext.register("audit-ext", session_hooks=audit)
        s = Session(Domain("cpu"))
        assert audit.name == "ext:audit-ext"
        assert any(p.name == "ext:audit-ext" for p in plugins.plugins())
        Session(Domain("cpu"))                 # a second Domain: once
        assert sum(p.name == "ext:audit-ext" for p in plugins.plugins()) == 1
        s.execute("select 1")
    finally:
        pext.registry.unregister("audit-ext")
        plugins.unregister("ext:audit-ext")
