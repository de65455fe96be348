"""Views, sequences, SPLIT TABLE, partitioned tables, set operations and
CTEs through the port's session against the JAX package's.

Each script runs statement by statement through a JAX ``Session`` and
the port's ``Session(Domain(device="cpu"))`` (``pair()`` of
``test_torch_dml.py``: fresh domains, the JAX scheduler and
auto-analyze off); after every statement the names, rows, affected
count and ``last_insert_id`` are equal, or both raise the same error
class.  The statements are the JAX package's own tests' (``tests/
test_sqlite_diff.py``'s views and partitions corpus,
``test_sequence_gencol_temp.py``, ``test_qualified_ddl.py`` and
``test_sql_breadth.py``'s set operations and CTEs).  Partition pruning
shows in EXPLAIN as ``partitions=pK/N``, equal in both plans.
"""

import numpy as np
import pytest

from test_torch_dml import both, pair, run_script


def _vp_setup():
    """test_sqlite_diff.py's vp_engines: a RANGE- and a HASH-partitioned
    table and two views over them."""
    rng = np.random.default_rng(77)
    n = 400
    ids = rng.integers(0, 300, n)
    v = rng.integers(-100, 100, n)
    g = rng.integers(0, 6, n)
    rows = [(int(ids[i]), int(v[i]), int(g[i])) for i in range(n)]
    return [
        "create table pt (id bigint not null, v bigint, g bigint) "
        "partition by range (id) ("
        "partition p0 values less than (100),"
        "partition p1 values less than (200),"
        "partition p2 values less than maxvalue)",
        "create table ht (id bigint not null, v bigint) "
        "partition by hash (id) partitions 4",
        "insert into pt values " + ",".join(str(r) for r in rows),
        "insert into ht values " + ",".join(f"({r[0]}, {r[1]})"
                                            for r in rows),
        "create view pv as select id, v from pt where v > 0",
        "create view gv (grp, total, cnt) as "
        "select g, sum(v), count(*) from pt group by g",
    ]


VP_CORPUS = [
    # range-partition pruning shapes
    "select count(*), sum(v) from pt where id < 100",
    "select count(*) from pt where id >= 200",
    "select count(*) from pt where id between 120 and 180",
    "select count(*) from pt where id = 150",
    "select id, v from pt where id in (5, 150, 250) order by id, v",
    "select g, count(*) from pt where id < 200 group by g order by g",
    "select count(*) from pt where id > 250 and v > 0",
    "select count(*) from pt",
    # hash-partition pruning
    "select count(*) from ht where id = 17",
    "select sum(v) from ht where id in (3, 7, 11)",
    "select count(*) from ht where id < 3",
    # views
    "select * from pv order by id, v limit 20",
    "select count(*) from pv where id < 100",
    "select grp, total, cnt from gv order by grp",
    "select sum(total) from gv",
    "select p.id, p.v from pv p join gv on gv.grp = p.id % 6 "
    "  order by p.id, p.v limit 15",
    # a write into a partitioned table, then its partitions again
    "insert into pt values (5, 1, 1), (150, 2, 2), (299, 3, 3)",
    "delete from pt where id = 150 and v = 2",
    "update pt set v = v + 1 where id < 10",
    "select count(*), sum(v) from pt where id < 100",
    "select count(*) from pt where id between 120 and 180",
    "create or replace view pv as select id, v from pt where v < 0",
    "select count(*) from pv",
    "drop view gv",
    "select * from gv",
    "drop view if exists gv",
    "drop view gv",
]


@pytest.fixture(scope="module")
def vp_sessions():
    js, ps = pair()
    run_script(js, ps, _vp_setup())
    return js, ps


def test_views_and_partitions_equal_jax_session(vp_sessions):
    js, ps = vp_sessions
    run_script(js, ps, VP_CORPUS)


def _plan(sess, sql):
    lines = [r[0] for r in sess.execute("explain " + sql).rows]
    return lines[:lines.index("contract: ok")] if "contract: ok" in lines \
        else lines


@pytest.mark.parametrize("sql,part", [
    ("select count(*) from pt where id < 100", "partitions=p0/3"),
    ("select count(*) from pt where id between 120 and 180",
     "partitions=p1/3"),
    ("select count(*) from pt where id >= 200", "partitions=p2/3"),
    ("select count(*) from ht where id = 5", "partitions=p1/4"),
    ("select sum(v) from ht where id in (3, 7, 11)", "partitions="),
])
def test_pruned_partitions_equal_in_explain(vp_sessions, sql, part):
    js, ps = vp_sessions
    got, want = _plan(ps, sql), _plan(js, sql)
    assert any(part in line for line in got), got
    assert got == [line.replace("-> TPU", "-> cpu") for line in want]


def test_range_partition_rejects_out_of_range():
    js, ps = pair()
    run_script(js, ps, [
        "create table rp (id bigint not null) partition by range (id)"
        " (partition p0 values less than (10))",
        "insert into rp values (10)",
        "insert into rp values (9)",
        "select count(*) from rp",
        "create table bad (id varchar(4)) partition by hash (id) "
        "partitions 2",
        "create table bad2 (id bigint) partition by hash (nope) "
        "partitions 2",
    ])


SEQUENCE_SCRIPT = [
    "CREATE SEQUENCE s START WITH 5 INCREMENT BY 3 CACHE 4",
    "SELECT NEXTVAL(s)", "SELECT NEXTVAL(s)", "SELECT LASTVAL(s)",
    "SELECT SETVAL(s, 100)", "SELECT NEXTVAL(s)",
    "SELECT SETVAL(s, 50)", "SELECT NEXTVAL(s)",
    "CREATE SEQUENCE s2", "SELECT LASTVAL(s2)",
    "CREATE SEQUENCE s3", "CREATE TABLE t3 (k INT)",
    "INSERT INTO t3 VALUES (1),(2),(3)",
    "SELECT k, NEXTVAL(s3) FROM t3 ORDER BY k",
    "CREATE SEQUENCE s4 START WITH 7",
    "CREATE TABLE t4 (id BIGINT, v INT)",
    "INSERT INTO t4 VALUES (NEXTVAL(s4), 1), (NEXTVAL(s4), 2)",
    "SELECT id, v FROM t4 ORDER BY v",
    "CREATE SEQUENCE sm MAXVALUE 2 CACHE 1",
    "SELECT NEXTVAL(sm)", "SELECT NEXTVAL(sm)", "SELECT NEXTVAL(sm)",
    "CREATE SEQUENCE sc MAXVALUE 2 CACHE 1 CYCLE",
    "SELECT NEXTVAL(sc)", "SELECT NEXTVAL(sc)", "SELECT NEXTVAL(sc)",
    "SELECT NEXTVAL(sc)",
    "CREATE SEQUENCE s ", "CREATE SEQUENCE IF NOT EXISTS s",
    "CREATE SEQUENCE sd", "DROP SEQUENCE sd", "SELECT NEXTVAL(sd)",
    "DROP SEQUENCE IF EXISTS sd", "DROP SEQUENCE sd",
    # test_qualified_ddl.py: a dropped database takes its sequences along
    "create database sq", "use sq", "create sequence seq1 start 1",
    "select nextval(seq1)", "select nextval(seq1)", "drop database sq",
    "create database sq", "use sq", "create sequence seq1 start 1",
    "select nextval(seq1)",
]


def test_sequences_equal_jax_session():
    js, ps = pair()
    run_script(js, ps, SEQUENCE_SCRIPT)


def test_split_table_equal_jax_session():
    js, ps = pair()
    run_script(js, ps, [
        "create table sp (id bigint primary key, v bigint)",
        "insert into sp values " + ",".join(f"({i}, {i * 7 % 13})"
                                            for i in range(200)),
        "split table sp regions 4",
        "select count(*), sum(v) from sp",
        "select v, count(*) from sp group by v order by v",
        "insert into sp values (500, 1), (501, 2)",
        "split table sp regions 8",
        "select count(*), sum(v), max(id) from sp where id > 100",
        "split table nope regions 2",
    ])


SETOP_SETUP = [
    """create table emp (id bigint primary key, dept varchar(16),
       name varchar(32), salary bigint, hired date)""",
    """insert into emp values
       (1,'eng','ann',100,'2020-01-01'), (2,'eng','bob',90,'2020-02-01'),
       (3,'eng','cat',90,'2020-03-01'),  (4,'sales','dan',70,'2021-01-01'),
       (5,'sales','eve',80,'2021-02-01'),(6,'hr','fay',60,'2022-01-01')""",
    "create table nums (n bigint)",
    "insert into nums values (1),(2),(2),(3),(3),(3)",
    "create table other (n bigint)",
    "insert into other values (2),(3),(3),(4)",
    "create table edge (src bigint, dst bigint)",
    "insert into edge values (1,2),(2,3),(3,1),(3,4)",
]

SETOP_CORPUS = [
    # set operations (test_sql_breadth.py)
    "select n from nums union all select n from other order by n",
    "select n from nums union select n from other order by n",
    "select n from nums except select n from other order by n",
    "select n from nums intersect select n from other order by n",
    "select 1 union select 2 intersect select 2",
    "select 1 union select 2 intersect select 3",
    "select 1 union all select 2.5e0 order by 1",
    "select n from nums union all select n from other order by n desc "
    "limit 3",
    "(select n from nums order by n limit 1) union all "
    "(select n from other order by n desc limit 1)",
    "select dept from emp union select 'ops' order by dept",
    "select dept, count(*) from emp group by dept union all "
    "select 'all', count(*) from emp order by 1",
    "select n from nums where n > 1 except select n from other where n > 3 "
    "order by n",
    # CTEs, non-recursive and recursive
    """with top_paid as (select * from emp where salary >= 90)
       select count(*), sum(salary) from top_paid""",
    """with a(x) as (select n from nums),
            b as (select x + 1 as y from a)
       select min(y), max(y) from b""",
    """with d as (select distinct n from nums)
       select count(*) from d t1, d t2""",
    """with recursive t(n) as (
           select 1 union all select n + 1 from t where n < 10)
       select count(*), sum(n), max(n) from t""",
    """with recursive reach(node) as (
           select 1
           union
           select e.dst from reach r join edge e on r.node = e.src)
       select node from reach order by node""",
    """with recursive t(n) as (select 1 union all select n + 1 from t)
       select count(*) from t""",
    """with recursive t(n) as (
           select 1 union all select 'x' from t where n = 1)
       select * from t""",
    """with a as (select n from nums)
       select n from a intersect select n from other order by n""",
    """with s as (select dept, sum(salary) as tot from emp group by dept)
       select dept, tot from s where tot > (select avg(tot) from s)
       order by dept""",
    "(select n from nums) order by n desc limit 2",
    # a host table scan under a correlated subquery apply
    """select n, (select count(*) from other o where o.n < nums.n) as c
       from nums order by n, c""",
    """select name from emp e where salary > (select avg(salary) from emp
       where dept = e.dept) order by name""",
    """select n from nums where exists (select 1 from other
       where other.n = nums.n + 1) order by n""",
]


@pytest.fixture(scope="module")
def setop_sessions():
    js, ps = pair()
    run_script(js, ps, SETOP_SETUP)
    return js, ps


@pytest.mark.parametrize("sql", SETOP_CORPUS)
def test_set_operations_and_ctes_equal_jax_session(setop_sessions, sql):
    js, ps = setop_sessions
    both(js, ps, sql)


def test_set_operation_plans_equal_jax(setop_sessions):
    """The physical plans of a UNION and a CTE are the JAX session's."""
    js, ps = setop_sessions
    for sql in ("select n from nums union select n from other",
                "with a as (select n from nums where n > 1) "
                "select count(*) from a"):
        got, want = _plan(ps, sql), _plan(js, sql)
        assert got == [line.replace("-> TPU", "-> cpu") for line in want]
