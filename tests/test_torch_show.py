"""The port's SHOW statements against the JAX package's.

Every SHOW kind the port runs goes through the port's ``Session`` and
the JAX ``Session`` over the same schema: CREATE TABLE, TABLES,
DATABASES, COLUMNS, INDEX, COLLATION and CHARSET (with LIKE),
VARIABLES (with LIKE), and STATS_META, STATS_HISTOGRAMS and STATS_TOPN
before ANALYZE, after it and after DML.  Names and rows are equal.  The
kinds of later slices raise in the port (tests/test_torch_slice.py).
"""

import pytest

from tidb_tpu.session import Domain as JDomain
from tidb_tpu.session import Session as JSession
from tidb_tpu_torch.session import Domain, Session


def _jax_session():
    dom = JDomain()
    dom.client.sched_enable = False          # no scheduler daemon threads
    dom.stats.auto_analyze_enabled = False   # no background ANALYZE
    s = JSession(dom)
    s.execute("set tidb_enable_auto_analyze = 0")
    return s


SCHEMA = [
    "create table t (a bigint not null auto_increment, b double, "
    "c varchar(10) collate utf8mb4_general_ci, d decimal(12,3), e date, "
    "primary key (a))",
    "create table u (k bigint, g varchar(8), unique key uk (k))",
    "create index ib on t (b, c)",
    "create database other",
    "create view v as select a, b from t where a > 3",
    "insert into t (b, c, d, e) values " + ",".join(
        f"({i * 0.5}, 'v{i % 3}', {i}.125, '2020-01-{1 + i % 28:02d}')"
        for i in range(300)),
    "insert into u values " + ",".join(
        f"({i}, 'g{i % 4}')" for i in range(40)),
]


@pytest.fixture(scope="module")
def sessions():
    js, ps = _jax_session(), Session(Domain("cpu", n_devices=2))
    for s in (js, ps):
        for sql in SCHEMA:
            s.execute(sql)
    return js, ps


def _same(pair, sql):
    a, b = (s.execute(sql) for s in pair)
    assert b.names == a.names, sql
    assert [tuple(r) for r in b.rows] == [tuple(r) for r in a.rows], sql
    return b.rows


SHOWS = ["show create table t", "show create table u", "show tables",
         "show databases", "show columns from t", "show columns from u",
         "show index from t", "show index from u", "show collation",
         "show collation like 'utf8mb4%'", "show charset",
         "show character set like 'utf8%'",
         "show variables like 'tidb_enable_%'",
         "show variables like '%analyze%'", "show variables"]


@pytest.mark.parametrize("sql", SHOWS)
def test_show_equals_the_reference(sql, sessions):
    rows = _same(sessions, sql)
    if sql == "show tables":
        assert [r[0] for r in rows] == ["t", "u", "v"]


def test_show_tables_of_another_database(sessions):
    for s in sessions:
        s.execute("use other")
    try:
        assert _same(sessions, "show tables") == []
    finally:
        for s in sessions:
            s.execute("use test")


def test_show_stats_before_and_after_analyze():
    js, ps = _jax_session(), Session(Domain("cpu", n_devices=2))
    pair = (js, ps)
    for s in pair:
        for sql in SCHEMA:
            s.execute(sql)
    kinds = ["show stats_meta", "show stats_histograms", "show stats_topn"]
    for sql in kinds:
        assert _same(pair, sql) == []
    for s in pair:
        s.execute("analyze table t")
        s.execute("analyze table u")
    meta = _same(pair, "show stats_meta")
    assert ("test", "t", 0, 300) in meta
    hist = _same(pair, "show stats_histograms")
    assert [r for r in hist if r[2] == "c"][0][3] == 3
    topn = _same(pair, "show stats_topn")
    assert any(r[2] == "c" for r in topn)
    # DML counts into STATS_META
    for s in pair:
        s.execute("delete from t where a <= 20")
        s.execute("update u set g = 'x' where k < 5")
    assert ("test", "t", 20, 280) in _same(pair, "show stats_meta")
    for s in pair:
        s.execute("analyze table t columns c, d")
    for sql in kinds:
        _same(pair, sql)
