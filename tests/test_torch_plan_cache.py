"""The plan cache, PREPARE/EXECUTE and plan bindings through the port's
session against the JAX session.

- ``PREPARE``/``EXECUTE``/``DEALLOCATE`` scripts give equal outcomes in
  both sessions (``test_torch_dml.both``), and after each statement the
  two domains' ``PlanCache`` counters are equal: its ``hits`` and
  ``misses`` over the same sequence, writes, DDL and ANALYZE included.
- The corpus of ``tests/test_torch_sql.py`` and the 22 TPC-H statements
  run twice through one port session with the cache on (the default):
  equal rows both times, a hit on the second run for every statement
  whose plan the cache keeps, and a miss after a write, DDL or ANALYZE
  wherever ``table_fingerprint`` changes.
- ``CREATE``/``DROP`` ``GLOBAL``/``SESSION BINDING`` with the
  ``SHOW BINDINGS`` rows, and the EXPLAIN of a bound statement and of
  each hint kind (``HASH_JOIN``, ``MERGE_JOIN``, ``INL_JOIN``,
  ``USE_INDEX``, ``IGNORE_INDEX``, ``LEADING``), equal the JAX
  session's (its EXPLAIN's analysis footers aside, and the device its
  cop tasks name).
"""

import pytest

import test_tpch_diff as T
from test_torch_dml import both, pair
from test_torch_sql import QUERIES, SF, SEED, _rows_equal, _t_table
from tidb_tpu_torch.chunk.column import Column, StringDict
from tidb_tpu_torch.planner.plan_cache import table_fingerprint
from tidb_tpu_torch.session import Domain, Session
from tidb_tpu_torch.testing import tpch
from tidb_tpu_torch.types import dtypes as dt

# the TPC-H statements whose plan folds an uncorrelated scalar subquery
# at plan time (the planner's PLAN_TAINTS): the cache keeps none of them,
# in either package, since the folded constant goes stale with the data
TPCH_NOT_CACHED = {2, 11, 17, 20, 22}


def _counters(js, ps):
    jc, pc = js.domain.plan_cache, ps.domain.plan_cache
    return (jc.hits, jc.misses), (pc.hits, pc.misses)


PREPARED = [
    "create table t (id bigint primary key, k varchar(8), v bigint,"
    " d decimal(10,2), day date)",
    "insert into t values (1, 'a', 10, 1.50, '2024-01-01'),"
    " (2, 'b', 20, 2.25, '2024-02-01'), (3, 'a', 30, null, null)",
    "prepare s1 from 'select id, v from t where v > ? order by id'",
    "set @lo = 15",
    "execute s1 using @lo",
    "execute s1 using @lo",
    "set @lo = 5",
    "execute s1 using @lo",
    "prepare s2 from 'select k, count(*), sum(d) from t where k = ?"
    " and day >= ? group by k'",
    "set @k = 'a', @day = '2023-12-31'",
    "execute s2 using @k, @day",
    "execute s2 using @k",                       # too few parameters
    "execute s2 using @k, @nope",                # unset variable
    "prepare s3 from 'insert into t values (?, ?, ?, ?, ?)'",
    "set @i = 4, @kk = 'c', @v = 40, @d = 4.75, @dd = '2024-03-01'",
    "execute s3 using @i, @kk, @v, @d, @dd",
    "execute s1 using @lo",                      # after a write
    "prepare s4 from 'selec ?'",                 # syntax error
    "deallocate prepare s1",
    "execute s1 using @lo",                      # deallocated
    "deallocate prepare s1",
    "select count(*) from t",
    "select count(*) from t",
    "create index iv on t (v)",                  # DDL
    "select count(*) from t",
    "select count(*) from t where v > (select min(v) from t)",
    "select count(*) from t where v > (select min(v) from t)",
    "analyze table t",
    "select count(*) from t",
    "update t set v = v + 1 where id = 1",
    "select count(*) from t",
    "select count(*) from t",
    "set tidb_enable_plan_cache = 0",
    "select count(*) from t",
    "set tidb_enable_plan_cache = 1",
    "select count(*) from t",
    "with c as (select id from t) select count(*) from c",
    "with c as (select id from t) select count(*) from c",
]


def test_prepared_statements_and_cache_counters_equal_the_jax():
    js, ps = pair()
    for sql in PREPARED:
        both(js, ps, sql)
        jcnt, pcnt = _counters(js, ps)
        assert pcnt == jcnt, (sql, pcnt, jcnt)
    # the sequence did hit, and did miss after the write and the DDL
    assert ps.domain.plan_cache.hits >= 5
    assert ps.prepared.keys() == js.prepared.keys() == {"s2", "s3"}


@pytest.fixture(scope="module")
def corpus_session():
    return tpch.sql_session(
        {"lineitem": tpch.gen_lineitem(SF, SEED),
         "t": _t_table(Column, StringDict, dt)}, device="cpu", n_devices=8)


@pytest.mark.parametrize("name", list(QUERIES))
def test_corpus_twice_hits_the_cache(corpus_session, name):
    ps = corpus_session
    cache = ps.domain.plan_cache
    sql = QUERIES[name]
    first = ps.execute(sql)
    hits = cache.hits
    second = ps.execute(sql)
    assert second.names == first.names
    _rows_equal(second.rows, first.rows)
    # the folded scalar subquery is the one statement the cache skips
    assert cache.hits == hits + (name != "scalar subquery")


@pytest.fixture(scope="module")
def tpch_session():
    data = T._gen()
    ps = Session(Domain("cpu"))
    for tbl, ddl in T.DDL.items():
        rows = data[tbl]
        ps.execute(f"create table {tbl} {ddl}")
        for lo in range(0, len(rows), 200):
            ps.execute(f"insert into {tbl} values " + ",".join(
                "(" + ",".join(T._lit(v) for v in r) + ")"
                for r in rows[lo:lo + 200]))
    return ps


def test_tpch_22_twice_hits_the_cache(tpch_session):
    ps = tpch_session
    cache = ps.domain.plan_cache
    for qn in sorted(tpch.TPCH_22):
        sql = tpch.TPCH_22[qn]
        first = ps.must_query(sql)
        hits = cache.hits
        second = ps.must_query(sql)
        assert second == first, qn
        assert cache.hits == hits + (qn not in TPCH_NOT_CACHED), qn


@pytest.mark.parametrize("change,missed", [
    ("insert into nation values (99, 'NOWHERE', 0, 'x')", True),
    ("create index inn on nation (n_regionkey)", True),
    ("analyze table nation", None),
])
def test_change_between_runs_follows_the_fingerprint(tpch_session, change,
                                                     missed):
    """A write or a DDL on a referenced table makes the next run a miss;
    ANALYZE does as far as ``table_fingerprint`` moves (it does not:
    statistics are not part of the key, as in the JAX package)."""
    ps = tpch_session
    cache = ps.domain.plan_cache
    sql = ("select n_regionkey, count(*) from nation "
           "group by n_regionkey order by n_regionkey")
    ps.execute(sql)
    tbl = ps.domain.catalog.get_table("test", "nation")
    before = table_fingerprint(tbl)
    ps.execute(change)
    moved = table_fingerprint(tbl) != before
    if missed is not None:
        assert moved is missed
    hits, misses = cache.hits, cache.misses
    ps.execute(sql)
    assert (cache.hits - hits, cache.misses - misses) == \
        ((0, 1) if moved else (1, 0))


Q = "select b.v, sm.w from big b join small sm on b.k = sm.k"
HINTED = {
    "MERGE_JOIN": "select /*+ MERGE_JOIN(sm) */ b.v, sm.w from big b "
                  "join small sm on b.k = sm.k",
    "HASH_JOIN": "select /*+ HASH_JOIN(sm) */ b.v, sm.w from big b "
                 "join small sm on b.k = sm.k",
    "INL_JOIN": "select /*+ INL_JOIN(b) */ sm.w, b.v from small sm "
                "join big b on b.k = sm.k",
    "USE_INDEX": "select /*+ USE_INDEX(big, ik) */ v from big where k = 3",
    "IGNORE_INDEX": "select /*+ IGNORE_INDEX(big, ik) */ v from big "
                    "where k = 3",
    "LEADING": "select /*+ LEADING(b) */ count(*) from big b, small sm, "
               "third th where b.k = sm.k and sm.w = th.w",
}


def _hint_pair():
    js, ps = pair(n_devices=8)
    for s in (js, ps):
        s.execute("create table big (k bigint, v bigint)")
        s.execute("create table small (k bigint, w bigint)")
        s.execute("create table third (w bigint, z bigint)")
        s.execute("insert into big values " +
                  ",".join(f"({i % 50},{i})" for i in range(500)))
        s.execute("insert into small values (3,30),(7,70),(3,31)")
        s.execute("insert into third values (30,1),(70,2)")
        s.execute("create index ik on big (k)")
    # EXPLAIN's ``cost:`` footer reads each package's process-wide
    # correction store, which only the port's scheduler feeds here: the
    # compared plans are priced by the static model in both
    for s in (js, ps):
        s.execute("set global tidb_tpu_cost_calibration = 0")
    return js, ps


def _explain(s, sql):
    lines = [r[0] for r in s.execute("explain " + sql).rows]
    return [ln.replace("-> TPU", "-> cpu") for ln in lines]


@pytest.fixture(scope="module")
def hint_pair():
    return _hint_pair()


@pytest.mark.parametrize("hint", list(HINTED))
def test_hint_explain_and_rows_equal_the_jax(hint_pair, hint):
    js, ps = hint_pair
    sql = HINTED[hint]
    assert _explain(ps, sql) == _explain(js, sql)
    assert sorted(ps.must_query(sql)) == sorted(js.must_query(sql))


def test_bindings_equal_the_jax():
    js, ps = _hint_pair()
    steps = [
        f"create global binding for {Q} using {HINTED['MERGE_JOIN']}",
        "show global bindings",
        "show session bindings",
        f"create session binding for {Q} using {HINTED['HASH_JOIN']}",
        "show bindings",
        f"create global binding for {Q} using {Q}",          # no hints
        f"create global binding for {Q} using "
        "select /*+ HASH_JOIN(sm) */ w from small sm",       # other digest
        "create global binding for select v from big where k = 1 using "
        "select /*+ IGNORE_INDEX(big, ik) */ v from big where k = 1",
        "show global bindings",
    ]
    for sql in steps:
        both(js, ps, sql)
    # the session binding shadows the global one; a literal-only change
    # keeps the digest
    for sql in (Q, "select v from big where k = 42"):
        assert _explain(ps, sql) == _explain(js, sql)
        assert sorted(ps.must_query(sql)) == sorted(js.must_query(sql))
    assert any("HostHashJoin" in ln for ln in _explain(ps, Q))
    assert not any("IndexLookUp" in ln for ln in
                   _explain(ps, "select v from big where k = 42"))
    for sql in (f"drop session binding for {Q}", "show bindings",
                f"drop global binding for {Q}", f"drop global binding for {Q}",
                "show bindings"):
        both(js, ps, sql)
    assert _explain(ps, Q) == _explain(js, Q)
    assert not any("HostMergeJoin" in ln or "HostHashJoin" in ln
                   for ln in _explain(ps, Q))


def test_cached_plan_does_not_shadow_a_binding():
    js, ps = _hint_pair()
    for s in (js, ps):
        s.must_query(Q)                    # warm the cache unhinted
        s.must_query(Q)
        s.execute(f"create global binding for {Q} using "
                  f"{HINTED['MERGE_JOIN']}")
    assert _explain(ps, Q) == _explain(js, Q)
    assert any("HostMergeJoin" in ln for ln in _explain(ps, Q))
    assert sorted(ps.must_query(Q)) == sorted(js.must_query(Q))
    assert _counters(js, ps)[0] == _counters(js, ps)[1]
