"""Online DDL and the index readers through the port's session against
the JAX package's.

``CREATE INDEX``/``ALTER TABLE ... ADD INDEX`` run through the port's
DDL owner (``ddl/owner.py``: the F1 state ladder, the write-reorg
backfill, the metadata locks); the plans then read through the index
readers (``IndexLookUpExec``, ``IndexMergeExec`` and, on an INL_JOIN
method, ``HostIndexLookupJoin``).  Rows and EXPLAIN trees equal the JAX
session's (built as in ``test_torch_dml.py``).

The online-DDL contract is held under concurrent writers: inserts and
deletes from another session while the index backfills leave ``ADMIN
CHECK TABLE`` clean and every written row indexed.  The port's backfill
waits out a writer's prewrite lock on its handle scan, where the JAX
package's raises ``KVError: locked``; a test holds such a lock across
the scan.  Each threaded test joins its threads within
``THREAD_LIMIT_S``.
"""

import threading
import time

import numpy as np
import pytest

from tidb_tpu_torch.ddl import owner as port_owner
from tidb_tpu_torch.store import codec
from tidb_tpu_torch.session import Domain, Session

from test_torch_dml import both, pair, run_script

THREAD_LIMIT_S = 60.0     # each threaded test's own time limit


def _fill(js, ps, n=300, seed=3):
    rng = np.random.default_rng(seed)
    run_script(js, ps, [
        "create table x (id bigint primary key, a bigint, b bigint,"
        " s varchar(8), d decimal(8,2))"])
    rows = [f"({i}, {int(rng.integers(0, 30))}, {int(rng.integers(0, 200))},"
            f" 's{int(rng.integers(0, 50))}',"
            f" {int(rng.integers(-9999, 9999)) / 100:.2f})"
            for i in range(n)]
    for lo in range(0, n, 100):
        both(js, ps, "insert into x values " + ", ".join(rows[lo:lo + 100]))


INDEX_QUERIES = {
    "point": "select id, b, s from x where a = 7 order by id",
    "range": "select id, a from x where b >= 150 and b < 160 order by id",
    "range open": "select count(*), sum(d) from x where b > 190",
    "composite prefix": "select id from x where a = 3 and b > 100"
                        " order by id",
    "string point": "select id, a from x where s = 's17' order by id",
    "residual": "select id from x where a = 5 and d > 0 order by id",
    "unique point": "select a, b from x where id = 42",
    "index merge": "select id from x where a = 2 or s = 's3' order by id",
    "no match": "select id from x where a = 99",
}
# the reader each statement plans (the JAX package's choice without
# statistics: a range with no equal prefix stays a scan on the card)
PLANNED = {"index merge": "IndexMerge", "unique point": "PointGet",
           "range": "CopTask", "range open": "CopTask"}


def _jax_tree(rows):
    lines = [r[0] for r in rows]
    return lines[:lines.index("contract: ok")] if "contract: ok" in lines \
        else lines


@pytest.fixture(scope="module")
def indexed():
    js, ps = pair()
    _fill(js, ps)
    run_script(js, ps, [
        "create index ia on x (a)",
        "alter table x add index ib (b)",
        "create index iab on x (a, b)",
        "create index isx on x (s)",
        "admin check table x",
    ])
    return js, ps


@pytest.mark.parametrize("name", list(INDEX_QUERIES))
def test_index_reads_equal_the_jax_session(indexed, name):
    js, ps = indexed
    sql = INDEX_QUERIES[name]
    got = both(js, ps, sql)
    jtree = _jax_tree(js.execute("explain " + sql).rows)
    ptree = [r[0] for r in ps.execute("explain " + sql).rows]
    assert ptree == [line.replace("-> TPU", "-> cpu") for line in jtree]
    assert any(PLANNED.get(name, "IndexLookUp") in line
               for line in ptree), ptree
    assert bool(got[2]) is (name != "no match")


def test_index_reads_equal_the_scan(indexed):
    """Each index read returns the rows a scan of the table gives."""
    _js, ps = indexed
    tbl = ps.domain.catalog.get_table("test", "x")
    cols = {n: c.to_python() for n, c in
            zip(tbl.col_names, tbl.snapshot().columns)}
    rows = list(zip(cols["id"], cols["a"], cols["b"], cols["s"]))
    assert ps.must_query(INDEX_QUERIES["point"]) == sorted(
        (i, b, s) for i, a, b, s in rows if a == 7)
    assert ps.must_query(INDEX_QUERIES["range"]) == sorted(
        (i, a) for i, a, b, s in rows if 150 <= b < 160)
    assert ps.must_query(INDEX_QUERIES["index merge"]) == sorted(
        (i,) for i, a, b, s in rows if a == 2 or s == "s3")


def test_index_lookup_join_equals_the_jax_package(indexed):
    """The index lookup join (the method an INL_JOIN hint picks; the
    port's session has no hints yet) over the same logical plan."""
    from tidb_tpu.executor import physical as jphys
    from tidb_tpu.executor import plan as jplan
    from tidb_tpu.planner.build import build_query as jbuild
    from tidb_tpu.planner.optimize import optimize_plan as jopt
    from tidb_tpu.sql.parser import parse_sql as jparse
    from tidb_tpu_torch.executor import physical as pphys
    from tidb_tpu_torch.planner.build import build_query
    from tidb_tpu_torch.planner.optimize import optimize_plan
    from tidb_tpu_torch.sql.parser import parse_sql
    js, ps = indexed
    for s in (js, ps):
        s.execute("create table o (oid bigint, oa bigint)")
        s.execute("insert into o values (1, 7), (2, 3), (3, 99), (4, 7)")
    sql = ("select oid, id, b from o join x on oa = a where oid < 4"
           " order by oid, id")
    res = []
    for sess, jax_pkg in ((js, True), (ps, False)):
        if jax_pkg:
            plan = jopt(jbuild(jparse(sql)[0], sess.domain.catalog,
                               "test").plan)
        else:
            plan = optimize_plan(build_query(parse_sql(sql)[0],
                                             sess.domain.catalog,
                                             "test").plan)
        stack, n = [plan], 0
        while stack:
            p = stack.pop()
            if type(p).__name__ == "LogicalJoin":
                p.hint_method = "inl"
                n += 1
            stack.extend(p.children)
        assert n == 1
        if jax_pkg:
            phys = jplan.to_physical(plan)
            ctx = jphys.ExecContext(sess.domain.client)
        else:
            phys = ps._to_physical(plan)
            ctx = pphys.ExecContext(sess.domain.client)
        assert "IndexLookupJoin" in phys.explain()
        chunk = phys.execute(ctx)
        res.append([c.to_python() for c in chunk.columns])
    assert res[0] == res[1] and len(res[1][0]) > 2


def test_ddl_jobs_and_index_errors_equal_the_jax_session():
    js, ps = pair()
    _fill(js, ps, n=60)
    run_script(js, ps, [
        "create index ia on x (a)",
        "create index ia on x (b)",                    # exists
        "create index if not exists ia on x (b)",
        "create unique index ua on x (a)",             # duplicates
        "create unique index us on x (id, a)",
        "create index iz on x (nope)",                 # unknown column
        "admin show ddl jobs",
        "drop index ia on x",
        "drop index ia on x",                          # gone
        "alter table x drop index us",
        "select count(*) from x where a = 3",
        "admin check table x",
        "create table y (id bigint primary key, v bigint, unique key uv (v))",
        "insert into y values (1, 10), (2, 20)",
        "insert into y values (3, 10)",                # unique violation
        "update y set v = 20 where id = 1",            # unique violation
        "admin check table y",
        "select * from y where v = 20",
    ])


def _writer_backfill(sess, make_writer, index_sql):
    errs, ddl_errs = [], []

    def ddl():
        try:
            sess.execute(index_sql)
        except Exception as e:  # pragma: no cover
            ddl_errs.append(e)
    t = threading.Thread(target=make_writer(errs), daemon=True)
    d = threading.Thread(target=ddl, daemon=True)
    t.start()
    d.start()
    deadline = time.monotonic() + THREAD_LIMIT_S
    d.join(THREAD_LIMIT_S)
    t.join(max(deadline - time.monotonic(), 0.0))
    assert not d.is_alive(), "the index build did not finish"
    assert not t.is_alive(), "writer did not finish"
    assert not ddl_errs, ddl_errs
    assert not errs, errs


def _d_session():
    s = Session(Domain("cpu"))
    s.execute("create table d (a bigint primary key, b bigint)")
    s.execute("insert into d values " + ", ".join(
        f"({i}, {i * 10})" for i in range(400)))
    return s


def test_writes_during_backfill_kept_consistent():
    """Insert rows concurrently with an ADD INDEX backfill; ADMIN CHECK
    passes afterwards and every concurrently written row is indexed
    (the online-DDL contract; tests/test_ddl.py's case on the port)."""
    sess = _d_session()

    def make(errs):
        def writer():
            s2 = Session(sess.domain)
            try:
                for i in range(2000, 2100):
                    s2.execute(f"insert into d values ({i}, {i * 10})")
            except Exception as e:  # pragma: no cover
                errs.append(e)
        return writer
    _writer_backfill(sess, make, "create index conc on d (b)")
    sess.execute("admin check table d")
    assert sess.must_query(
        "select count(*) from d where b >= 20000 and b < 21000") == [(100,)]
    assert sess.must_query("select a from d where b = 20500") == [(2050,)]
    assert any("IndexLookUp" in r[0] for r in sess.execute(
        "explain select a from d where b = 20500").rows)


def test_deletes_during_backfill_no_orphans():
    """Concurrent DELETEs while ADD INDEX backfills leave no orphan index
    entries (the backfill rechecks each row per batch transaction)."""
    sess = _d_session()

    def make(errs):
        def deleter():
            s2 = Session(sess.domain)
            try:
                for i in range(0, 400, 7):
                    s2.execute(f"delete from d where a = {i}")
            except Exception as e:  # pragma: no cover
                errs.append(e)
        return deleter
    _writer_backfill(sess, make, "create index delidx on d (b)")
    sess.execute("admin check table d")
    assert sess.must_query("select count(*) from d where b >= 0") == \
        [(400 - len(range(0, 400, 7)),)]


def test_backfill_waits_out_a_prewrite_lock(monkeypatch):
    """A writer's prewrite lock on a record key across the backfill's
    handle scan: the port's scan backs off until the writer commits,
    then the index is built and consistent (the JAX package's scan
    raises ``KVError: locked`` here)."""
    sess = _d_session()
    dom = sess.domain
    tbl = dom.catalog.get_table("test", "d")
    kv = dom.kv
    waits = []
    real = port_owner.Backoffer.backoff

    def counted(self, kind, err):
        waits.append(kind.name)
        return real(self, kind, err)
    monkeypatch.setattr(port_owner.Backoffer, "backoff", counted)
    # prewrite (lock) row 5's record key with its own value, as a writer
    # between its prewrite and commit would hold it
    key = codec.record_key(tbl.table_id, 5)
    val = kv.get(key, kv.alloc_ts())
    start_ts = kv.alloc_ts()
    lib, h = kv._lib, kv._h
    assert lib.kv_prewrite(h, key, len(key), val, len(val), key, len(key),
                           start_ts, 0) == 0
    done, errs = [], []

    def ddl():
        try:
            Session(dom).execute("create index lk on d (b)")
            done.append(time.monotonic())
        except Exception as e:  # pragma: no cover
            errs.append(e)
    th = threading.Thread(target=ddl)
    th.start()
    time.sleep(0.4)
    assert not done, "the backfill finished through a held lock"
    released = time.monotonic()
    assert lib.kv_commit(h, key, len(key), start_ts, kv.alloc_ts()) == 0
    th.join(THREAD_LIMIT_S)
    assert not th.is_alive() and not errs, errs
    assert done[0] >= released
    assert waits and set(waits) == {"txnLock"}
    sess.execute("admin check table d")
    assert sess.must_query("select a from d where b = 50") == [(5,)]
