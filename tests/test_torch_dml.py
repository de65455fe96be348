"""Write statements and transactions through the port's session against
the JAX package's.

Each case runs the same seeded statements through a JAX ``Session`` and
the port's ``Session(Domain(device="cpu"))``, each over a fresh domain
with its own row store.  After every statement the result names, the
rows (exactly: integers, decimals, strings, dates and floats alike, as
both evaluate on the host with numpy), the affected count and
``last_insert_id`` are equal, or both statements raise the same error
class.  The JAX client is built with ``sched_enable = False`` and
auto-analyze off, so no scheduler or statistics thread starts.

The cases cover INSERT (values, column lists, INSERT ... SELECT, ON
DUPLICATE KEY UPDATE, REPLACE, IGNORE, AUTO_INCREMENT), LOAD DATA,
UPDATE and DELETE (with ORDER BY/LIMIT, computed assignments, TRUNCATE),
the foreign-key actions, optimistic and pessimistic transactions, the
statement savepoint inside a transaction, ROLLBACK, write conflicts
between two sessions, temporary and generated columns, the durable
reopen of a ``Domain(data_dir=...)``, and the re-placement of a table's
snapshot after each write.
"""

import threading

import numpy as np
import pytest

from tidb_tpu.session import Domain as JDomain
from tidb_tpu.session import Session as JSession
from tidb_tpu_torch.session import Domain, Session

THREAD_LIMIT_S = 30.0     # each threaded test's own time limit


def jax_domain(**kw):
    d = JDomain(**kw)
    d.client.sched_enable = False         # no scheduler daemon threads
    d.stats.auto_analyze_enabled = False  # no background ANALYZE
    return d


def jax_session(domain):
    s = JSession(domain)
    s.execute("set tidb_enable_auto_analyze = 0")
    return s


def pair(**kw):
    """A fresh (JAX session, port session) pair, each on its own domain."""
    return jax_session(jax_domain(**kw)), Session(Domain("cpu", **kw))


def _run(sess, sql):
    try:
        res = sess.execute(sql)
    except Exception as e:     # the error class is compared across
        return ("error", type(e).__name__)
    return ("ok", res.names, res.rows, res.affected,
            getattr(sess, "last_insert_id", 0))


def both(js, ps, sql):
    """Run ``sql`` on both sessions; their outcomes must be equal."""
    want, got = _run(js, sql), _run(ps, sql)
    assert got == want, (sql, got, want)
    return got


def run_script(js, ps, stmts):
    return [both(js, ps, s) for s in stmts]


SCHEMA = """create table t (id bigint primary key auto_increment,
                            k varchar(8), v bigint, d decimal(10,2),
                            f double, day date, ts datetime,
                            unique key uk (k))"""

# statement scripts, each on a fresh pair of domains
SCRIPTS = {
    "insert variants": [
        SCHEMA,
        "insert into t (k, v, d, f, day, ts) values ('a', 1, 1.25, 0.5,"
        " '2024-01-02', '2024-01-02 03:04:05'), ('b', 2, null, -1.5,"
        " null, null)",
        "select last_insert_id()",
        "insert into t values (10, 'c', 3, 9.99, 2.0, '2023-12-31',"
        " '2023-12-31 23:59:59')",
        "insert into t (k, v) values ('d', 4)",
        "select last_insert_id()",
        "insert into t (k, v) values ('a', 5)",           # duplicate key
        "insert ignore into t (k, v) values ('a', 6), ('e', 7)",
        "replace into t (id, k, v) values (2, 'b2', 20), (30, 'f', 8)",
        "insert into t (k, v, d) values ('a', 100, 1.00), ('g', 9, 2.50)"
        " on duplicate key update v = v + values(v), d = values(d)",
        "insert into t (k, v) values ('g', 9) on duplicate key update"
        " v = 9",
        "select * from t order by id",
        "select k, v from t where v > 3 order by v desc",
    ],
    "insert select": [
        SCHEMA,
        "create table u (id bigint, k varchar(8), v bigint)",
        "insert into t (k, v, d) values ('x', 1, 1.10), ('y', 2, 2.20),"
        " ('z', 3, 3.30)",
        "insert into u select id, k, v * 10 from t where v >= 2",
        "select * from u order by id",
        "insert into u (id, v) select max(id) + 1, sum(v) from t",
        "select count(*), sum(v), max(k) from u",
    ],
    "update and delete": [
        SCHEMA,
        "insert into t (k, v, d, f) values ('a', 5, 1.00, 1.5), ('b', 3,"
        " 2.00, null), ('c', 9, null, 2.5), ('d', 1, 4.00, 3.5), ('e', 7,"
        " 5.00, -1.0), ('f', 3, 6.00, 0.0)",
        "update t set v = v * 2, d = d + 0.5 where v > 4",
        "update t set f = 0 where f is null",
        "update t set v = v + 100 order by v desc, id limit 2",
        "update t set k = 'zz' where id = 999",
        "select id, k, v, d, f from t order by id",
        "delete from t where d is null",
        "delete from t order by v limit 2",
        "select id, k, v from t order by id",
        "update t set day = '2020-02-29', ts = '2020-02-29 12:00:00'"
        " where k in ('b', 'd')",
        "select k, day, ts from t order by k",
        "delete from t",
        "select count(*) from t",
        "insert into t (k, v) values ('q', 1)",
        "truncate table t",
        "select count(*) from t",
    ],
    "foreign keys": [
        "create table p (id bigint primary key, name varchar(8))",
        "create table c (id bigint primary key, pid bigint,"
        " foreign key (pid) references p (id) on delete cascade)",
        "create table r (id bigint primary key, pid bigint,"
        " foreign key (pid) references p (id))",
        "insert into p values (1, 'one'), (2, 'two'), (3, 'three')",
        "insert into c values (10, 1), (11, 1), (12, 2)",
        "insert into c values (13, 9)",                    # no parent
        "insert into r values (20, 3)",
        "delete from p where id = 1",
        "select * from c order by id",
        "delete from p where id = 3",                      # restrict
        "update p set id = 30 where id = 3",               # restrict
        "update p set name = 'TWO' where id = 2",
        "select * from p order by id",
        "drop table p",                                    # referenced
        "delete from r",
        "delete from p where id = 3",
        "select count(*) from p",
    ],
    "optimistic txn": [
        SCHEMA,
        "insert into t (k, v) values ('a', 1), ('b', 2)",
        "begin",
        "insert into t (k, v) values ('c', 3)",
        "update t set v = v + 10 where k in ('a', 'c')",
        "delete from t where k = 'b'",
        "select k, v from t order by k",
        "commit",
        "select k, v from t order by k",
    ],
    "rollback": [
        SCHEMA,
        "insert into t (k, v) values ('a', 1), ('b', 2)",
        "begin",
        "insert into t (k, v) values ('c', 3)",
        "update t set v = 0",
        "delete from t where k = 'a'",
        "rollback",
        "select k, v from t order by k",
        "begin",
        "insert into t (k, v) values ('d', 4)",
        "commit",
        "select k, v from t order by k",
    ],
    "pessimistic txn": [
        SCHEMA,
        "insert into t (k, v) values ('a', 1), ('b', 2), ('c', 3)",
        "begin pessimistic",
        "select k, v from t where v >= 2 for update",
        "update t set v = v * 3 where v >= 2",
        "insert into t (k, v) values ('d', 4)",
        "delete from t where k = 'a'",
        "commit",
        "select k, v from t order by k",
        "set tidb_txn_mode = 'pessimistic'",
        "begin",
        "update t set v = -1 where k = 'd'",
        "rollback",
        "select k, v from t order by k",
    ],
    "statement savepoint": [
        SCHEMA,
        "insert into t (k, v) values ('a', 1)",
        "begin",
        "insert into t (k, v) values ('b', 2)",
        "insert into t (k, v) values ('c', 3), ('a', 4)",  # fails whole
        "update t set v = v + 1",
        "commit",
        "select k, v from t order by k",
    ],
    "ddl implicit commit": [
        SCHEMA,
        "begin",
        "insert into t (k, v) values ('a', 1)",
        "create table w (x bigint)",                       # commits
        "rollback",
        "select k, v from t",
        "create database db2",
        "use db2",
        "create table t (x bigint, y varchar(4))",
        "insert into t values (1, 'p'), (2, null)",
        "select * from t order by x",
        "alter table t add column z decimal(6,1)",
        "update t set z = 1.5 where x = 2",
        "alter table t drop column y",
        "select * from t order by x",
        "drop table t",
        "select * from t",
        "use test",
        "drop database db2",
        "drop table w",
        "drop table if exists w",
    ],
    "temporary and generated": [
        "create table g (a bigint, b bigint, s bigint as (a + b) stored)",
        "insert into g (a, b) values (1, 2), (3, null)",
        "insert into g values (1, 1, 5)",
        "select * from g order by a",
        "update g set b = 10 where a = 3",
        "select * from g order by a",
        "create temporary table tt (x bigint)",
        "insert into tt values (7), (8)",
        "select sum(x) from tt",
        "drop temporary table tt",
        "select * from tt",
    ],
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_script_equals_the_jax_session(name):
    js, ps = pair()
    outs = run_script(js, ps, SCRIPTS[name])
    # the scripts do reach their writes and reads
    assert any(o[0] == "ok" and o[3] for o in outs)


def _random_rows(seed, n):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        k = f"'k{int(rng.integers(0, 40))}'" if rng.random() > 0.1 \
            else "null"
        v = int(rng.integers(-50, 50))
        d = f"{int(rng.integers(-9999, 9999)) / 100:.2f}" \
            if rng.random() > 0.2 else "null"
        rows.append(f"({i + 1}, {k}, {v}, {d})")
    return rows


@pytest.mark.parametrize("seed", range(3))
def test_seeded_dml_equals_the_jax_session(seed):
    """Seeded batches of inserts, then UPDATE and DELETE with seeded
    predicates, ORDER BY and LIMIT, with a SELECT after each."""
    rng = np.random.default_rng(seed)
    js, ps = pair()
    both(js, ps, "create table s (id bigint primary key, k varchar(8),"
                 " v bigint, d decimal(8,2))")
    rows = _random_rows(seed, 80)
    for lo in range(0, 80, 20):
        both(js, ps, "insert into s values " + ", ".join(rows[lo:lo + 20]))
    check = "select k, count(*), sum(v), sum(d), min(d) from s group by k" \
            " order by k"
    both(js, ps, check)
    for _ in range(6):
        c = int(rng.integers(-40, 40))
        lim = int(rng.integers(1, 10))
        both(js, ps, f"update s set v = v + {c}, d = d * 2 where v < {c}"
                     f" order by d desc, id limit {lim}")
        both(js, ps, f"delete from s where k = 'k{int(rng.integers(0, 40))}'"
                     f" or v > {40 - lim}")
        both(js, ps, check)
        both(js, ps, "select id, v from s order by v, id limit 5")


def test_load_data_equals_the_jax_session(tmp_path):
    """LOAD DATA with a field separator, enclosure, IGNORE n LINES, \\N
    NULLs, a column list, IGNORE and REPLACE on duplicates."""
    f = tmp_path / "rows.tbl"
    f.write_text("header|line|x\n"
                 "1|a b|1.50|2024-03-01\n"
                 "2|\\N|2.25|\\N\n"
                 "3|\"c|d\"||2024-03-03\n")
    g = tmp_path / "more.tbl"
    g.write_text("2|b2|9.00|2024-04-01\n4|e|4.00|2024-04-04\n")
    js, ps = pair()
    run_script(js, ps, [
        "create table l (id bigint primary key, s varchar(8),"
        " d decimal(6,2), day date)",
        f"load data infile '{f}' into table l fields terminated by '|'"
        " enclosed by '\"' ignore 1 lines",
        "select * from l order by id",
        f"load data infile '{g}' into table l fields terminated by '|'",
        "select count(*) from l",
        f"load data infile '{g}' ignore into table l fields terminated"
        " by '|'",
        "select * from l order by id",
        f"load data infile '{g}' replace into table l fields terminated"
        " by '|'",
        "select * from l order by id",
        "create table l2 (day date, id bigint)",
        f"load data infile '{g}' into table l2 fields terminated by '|'"
        " (id, @skip, @skip2, day)",
        "select * from l2 order by id",
        f"load data infile '{tmp_path / 'missing.tbl'}' into table l",
    ])


def test_write_conflict_between_sessions_equals_the_jax_session():
    """Two optimistic transactions write one row: the first COMMIT
    wins, the second raises; pessimistic ones serialize instead."""
    outs = []
    for dom_fn, sess_fn in ((jax_domain, jax_session),
                            (lambda: Domain("cpu"), Session)):
        dom = dom_fn()
        a, b = sess_fn(dom), Session(dom) if sess_fn is Session \
            else jax_session(dom)
        a.execute(SCHEMA)
        a.execute("insert into t (k, v) values ('a', 1)")
        out = []
        for s in (a, b):
            s.execute("begin optimistic")
            s.execute("update t set v = v + 1 where k = 'a'")
        out.append(_run(a, "commit"))
        out.append(_run(b, "commit"))
        out.append(_run(a, "select v from t"))
        # autocommit statements retry a conflict against a fresh snapshot
        a.execute("begin")
        a.execute("update t set v = 100 where k = 'a'")
        out.append(_run(b, "update t set v = v + 5 where k = 'a'"))
        out.append(_run(a, "commit"))
        out.append(_run(a, "select v from t"))
        outs.append(out)
    assert outs[0] == outs[1]
    assert outs[1][1][0] == "error"


def test_pessimistic_writers_serialize_equals_the_jax_session():
    """Two pessimistic sessions increment one row from two threads: the
    second blocks on the first's lock, then applies on top of it (no
    lost update).  Each thread joins within ``THREAD_LIMIT_S``."""
    finals = []
    for dom_fn, sess_fn in ((jax_domain, jax_session),
                            (lambda: Domain("cpu"), Session)):
        dom = dom_fn()
        s0 = sess_fn(dom)
        s0.execute(SCHEMA)
        s0.execute("insert into t (k, v) values ('a', 0)")
        errs, barrier = [], threading.Barrier(2)

        def bump(dom=dom, sess_fn=sess_fn, errs=errs, barrier=barrier):
            s = sess_fn(dom)
            try:
                barrier.wait(THREAD_LIMIT_S)
                s.execute("begin pessimistic")
                s.execute("update t set v = v + 1 where k = 'a'")
                s.execute("commit")
            except Exception as e:  # pragma: no cover
                errs.append(e)
        ths = [threading.Thread(target=bump) for _ in range(2)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(THREAD_LIMIT_S)
            assert not th.is_alive()
        assert not errs, errs
        finals.append(s0.must_query("select v from t"))
    assert finals[0] == finals[1] == [(2,)]


def test_durable_reopen_equals_the_jax_session(tmp_path):
    """Schema, rows, indexes and the AUTO_INCREMENT counter survive a
    closed ``Domain(data_dir=...)`` reopened in the same process; an
    open transaction does not."""
    outs = []
    for tag, mk_dom, mk_sess in (
            ("jax", lambda d: jax_domain(data_dir=d), jax_session),
            ("port", lambda d: Domain("cpu", data_dir=d), Session)):
        d = str(tmp_path / tag)
        dom = mk_dom(d)
        s = mk_sess(dom)
        s.execute("create database app")
        s.execute("use app")
        s.execute(SCHEMA)
        s.execute("insert into t (k, v, d) values ('a', 1, 1.50),"
                  " ('b', 2, 2.25)")
        s.execute("create index iv on t (v)")
        s.execute("update t set v = 20 where k = 'b'")
        s2 = mk_sess(dom)
        s2.execute("use app")
        s2.execute("begin")
        s2.execute("insert into t (k, v) values ('lost', 9)")
        dom.close()
        dom2 = mk_dom(d)
        r = mk_sess(dom2)
        r.execute("use app")
        out = [_run(r, "select k, v, d from t order by id"),
               _run(r, "insert into t (k, v) values ('c', 3)"),
               _run(r, "select id, k from t order by id"),
               _run(r, "select k from t where v = 20"),
               _run(r, "admin check table t")]
        outs.append(out)
        dom2.close()
    assert outs[0] == outs[1]
    assert outs[1][0][2] == [("a", 1, outs[1][0][2][0][2]),
                             ("b", 20, outs[1][0][2][1][2])]


def test_snapshot_epoch_advances_on_each_write():
    """Every write bumps the table's epoch and frees the old epoch's
    placement; a SELECT after it places the new snapshot once and never
    reads a stale one."""
    ps = Session(Domain("cpu"))
    ps.execute("create table e (id bigint primary key, v bigint)")
    tbl = ps.domain.catalog.get_table("test", "e")
    dev = ps.domain.client.devices
    epochs = []
    writes = ["insert into e values (1, 10), (2, 20)",
              "update e set v = v + 1 where id = 1",
              "delete from e where id = 2",
              "insert into e values (3, 30)",
              "begin", "update e set v = 0", "commit",
              "replace into e values (3, 33)"]
    for w in writes:
        old = tbl.snapshot()
        old.device_cols(dev)
        assert old._device_cache
        ps.execute(w)
        if w in ("begin",):
            continue
        if w == "update e set v = 0":
            # buffered in the open transaction: the snapshot still
            # holds the committed rows until COMMIT
            cur = tbl.snapshot()
            assert [c.to_python() for c in cur.columns] == \
                [c.to_python() for c in old.columns]
            continue
        snap = tbl.snapshot()
        assert snap is not old and snap.epoch > old.epoch
        assert not old._device_cache            # the old placement freed
        epochs.append(snap.epoch)
        got = ps.must_query("select sum(v), count(*) from e")
        rows = list(zip(*[c.to_python() for c in snap.columns]))
        want = (sum(r[1] for r in rows), len(rows))
        assert got == [want]
        # the SELECT placed the new epoch, once
        assert list(snap._device_cache) and all(
            k[1] == snap.epoch for k in snap._device_cache)
    assert epochs == sorted(set(epochs))
    assert ps.must_query("select id, v from e order by id") == [(1, 0),
                                                                 (3, 33)]


@pytest.mark.parametrize("write", [
    "insert into e values (9, 9)", "update e set v = v + 1",
    "delete from e where id = 1", "replace into e values (2, 7)",
    "truncate table e"])
def test_select_after_write_is_never_stale(write):
    """A cached placement of the old epoch is never served after a
    write: the statement after it reads the written rows."""
    ps = Session(Domain("cpu"))
    js = jax_session(jax_domain())
    for s in (js, ps):
        s.execute("create table e (id bigint primary key, v bigint)")
        s.execute("insert into e values (1, 1), (2, 2), (3, 3)")
    q = "select count(*), sum(v), min(v), max(v) from e"
    both(js, ps, q)              # places the first epoch
    both(js, ps, write)
    both(js, ps, q)
    assert ps.domain.client.timings.get("place") is not None


# ------------------------------------------------------------------ #
# the TPC-H path of chip_smoke.py's store phase, at a tiny scale
# ------------------------------------------------------------------ #

FLOAT_RTOL = 1e-9     # float SUM/AVG: the two sum in different orders

TPCH_STORE_STMTS = {
    "Q1": "Q1", "Q6": "Q6",
    "join": """select o_orderpriority, count(*), sum(l_quantity)
               from lineitem join orders on l_orderkey = o_orderkey
               where o_orderdate < date '1995-03-15'
               group by o_orderpriority order by o_orderpriority""",
    "TopN": """select l_orderkey, l_linenumber, l_extendedprice
               from lineitem order by l_extendedprice desc, l_orderkey,
               l_linenumber limit 10""",
    "point": "select l_linenumber, l_quantity from lineitem"
             " where l_orderkey = 97 order by l_linenumber",
}


def _close(got, want):
    assert got[0] == want[0] == "ok", (got, want)
    assert got[1] == want[1] and got[3:] == want[3:]
    assert len(got[2]) == len(want[2])
    for g, w in zip(got[2], want[2]):
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=FLOAT_RTOL, abs=1e-9)
            else:
                assert type(x) is type(y) and x == y, (x, y)


def test_tpch_store_path_equals_the_jax_session(tmp_path):
    """LOAD DATA of the generator's lineitem and orders files, the
    statements of the store phase, a committed transaction of UPDATE,
    DELETE and INSERT, CREATE INDEX with an index read, and a rolled
    back transaction: the port's session equals the JAX session."""
    from tidb_tpu_torch.testing import tpch
    names, cols = tpch.gen_lineitem(0.0005, seed=0)
    tpch.write_tbl(tmp_path / "lineitem.tbl",
                   cols + [tpch.lineitem_comments(len(cols[0]))])
    _on, ocols = tpch.gen_orders(0.0005, seed=0)
    tpch.write_tbl(tmp_path / "orders.tbl", ocols)
    js, ps = pair()
    sqls = {k: getattr(tpch, "TPCH_" + v) if v in ("Q1", "Q6") else v
            for k, v in TPCH_STORE_STMTS.items()}

    def reads():
        for name, sql in sqls.items():
            _close(_run(ps, sql), _run(js, sql))

    for t in ("lineitem", "orders"):
        both(js, ps, f"create table {t} {tpch.TPCH_DDL[t]}")
        both(js, ps, f"load data infile '{tmp_path / (t + '.tbl')}' into"
                     f" table {t} fields terminated by '|'")
    reads()
    run_script(js, ps, [
        "begin",
        "update lineitem set l_discount = 0.1, l_tax = l_tax + 0.01"
        " where l_orderkey < 200",
        "delete from lineitem where l_orderkey between 300 and 500",
        "insert into lineitem values (97, 1, 1, 9, 5.00, 500.00, 0.05,"
        " 0.01, 'N', 'O', '1996-01-01', '1996-01-02', '1996-01-03',"
        " 'NONE', 'AIR', 'added')",
        "commit",
        "create index iok on lineitem (l_orderkey)",
        "admin check table lineitem",
        "begin",
        "delete from orders where o_orderkey < 100",
        "update orders set o_totalprice = 0",
        "insert into orders values (5, 1, 'O', 1.0, '1995-01-01',"
        " '5-LOW', 'Clerk#000000001', 0, 'x')",
        "rollback",
    ])
    sql = "select count(*), sum(o_totalprice) from orders"
    _close(_run(ps, sql), _run(js, sql))
    reads()
    assert any("IndexLookUp" in r[0] for r in ps.execute(
        "explain " + sqls["point"]).rows)


def test_tpch_ddl_is_the_diff_suites():
    """The store path's table types are tests/test_tpch_diff.py's."""
    from test_tpch_diff import DDL
    from tidb_tpu_torch.testing import tpch
    assert tpch.TPCH_DDL == {t: DDL[t] for t in tpch.TPCH_DDL}
