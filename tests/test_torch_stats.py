"""The port's statistics against the JAX package's.

(a) the ANALYZE kernel: ``tidb_tpu_torch.stats.build.stats_kernel`` (on
    the CPU, where ``stable_argsort`` and ``group_reduce_lanes`` run
    their plain versions) against ``tidb_tpu.stats.build._stats_kernel``
    on the same int64 columns made from a seed: every output array
    (count, min, null count, NDV, bounds, cumulative counts, repeats,
    TopN values and counts, KMV minima, CM counters) equal in value and
    dtype; int64 and float64 (through ``sortable_f64``) columns, NULLs,
    fewer rows than ``n_top``, one value everywhere, ties at the k-th
    TopN place, every row NULL, full-range int64;
(b) the ``ColumnStats`` of both handles' ANALYZE over one table, a
    sampled build at a lowered ``SAMPLE_THRESHOLD`` among them, and an
    empty column;
(c) the cases of tests/test_stats.py and tests/test_stats_depth.py
    through the port's ``Session`` and the JAX ``Session``: selectivity
    rejecting or keeping an index path, the inline auto-analyze, the
    SORT capacity seeded by NDV (not through a projection), predicate
    columns, named columns and sampled ANALYZE, with the plans and rows
    of both sessions equal, and DML counted into ``modify_count``.

Everything here is exact: the statistics are integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.chunk.column import Column as JColumn
from tidb_tpu.copr import dag as JD
from tidb_tpu.planner.build import build_query as j_build_query
from tidb_tpu.planner.optimize import optimize_plan as j_optimize_plan
from tidb_tpu.planner.ranger import LogicalIndexScan as JIndexScan
from tidb_tpu.planner.ranger import apply_index_paths as j_apply_index_paths
from tidb_tpu.session import Domain as JDomain
from tidb_tpu.session import Session as JSession
from tidb_tpu.session.catalog import TableInfo as JTable
from tidb_tpu.sql.parser import parse_sql as j_parse_sql
from tidb_tpu.stats import build as jbuild
from tidb_tpu.stats.handle import StatsHandle as JHandle
from tidb_tpu.types import dtypes as jdt
from tidb_tpu_torch.chunk.column import Column
from tidb_tpu_torch.copr import dag as D
from tidb_tpu_torch.planner.build import build_query
from tidb_tpu_torch.planner.optimize import optimize_plan
from tidb_tpu_torch.planner.ranger import LogicalIndexScan, apply_index_paths
from tidb_tpu_torch.session import Domain, Session
from tidb_tpu_torch.session.catalog import TableInfo
from tidb_tpu_torch.sql.parser import parse_sql
from tidb_tpu_torch.stats import build as pbuild
from tidb_tpu_torch.stats.handle import StatsHandle
from tidb_tpu_torch.types import dtypes as dt

# ------------------------------------------------------------------ #
# (a) the kernel
# ------------------------------------------------------------------ #


def _kernel_case(name):
    """(int64 encoded column, validity, n_buckets, n_top) of a case."""
    rng = np.random.default_rng(11)
    n = 3000
    some_null = rng.random(n) < 0.9
    if name == "int64 with nulls":
        return rng.integers(-200, 400, n), some_null, 64, 16
    if name == "float64 with nulls":
        return (pbuild.sortable_f64(rng.normal(size=n) * 1e3), some_null,
                64, 16)
    if name == "float64 no nulls":
        f = np.round(rng.normal(size=n) * 50)      # repeats, both signs
        return pbuild.sortable_f64(f), np.ones(n, bool), 32, 16
    if name == "fewer rows than n_top":
        return np.array([5, 3, 5, 9, 3, 5], np.int64), \
            np.array([True, True, True, False, True, True]), 4, 16
    if name == "one value":
        return np.full(500, 42, np.int64), np.ones(500, bool), 64, 16
    if name == "ties at the k-th place":
        # 40 values, each 10 times: the 16 of TopN come from ties
        x = np.repeat(np.arange(40), 10)
        return rng.permutation(x).astype(np.int64), np.ones(400, bool), \
            8, 16
    if name == "every row null":
        return rng.integers(0, 9, 300), np.zeros(300, bool), 16, 16
    if name == "full-range int64":
        return rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64), \
            some_null, 64, 16
    raise KeyError(name)


KERNEL_CASES = ["int64 with nulls", "float64 with nulls", "float64 no nulls",
                "fewer rows than n_top", "one value",
                "ties at the k-th place", "every row null",
                "full-range int64"]


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_stats_kernel_equals_the_reference(case):
    x, valid, nb, nt = _kernel_case(case)
    x = x.astype(np.int64)
    want = {k: np.asarray(v) for k, v in jbuild._stats_kernel(
        jnp.asarray(x), jnp.asarray(valid), nb, nt).items()}
    got = {k: v.numpy() for k, v in pbuild.stats_kernel(
        torch.from_numpy(x), torch.from_numpy(valid), nb, nt).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


def test_build_column_stats_encodes_as_the_reference():
    rng = np.random.default_rng(5)
    for data in (rng.normal(size=700), rng.integers(0, 50, 700),
                 rng.integers(0, 9, 700).astype(np.int32)):
        valid = rng.random(700) < 0.8
        want = jbuild.build_column_stats(data, valid, 16, 8)
        got = pbuild.build_column_stats(data, valid, 16, 8, device="cpu")
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    assert pbuild.unsortable_f64(int(pbuild.sortable_f64(
        np.array([-2.5]))[0])) == -2.5


# ------------------------------------------------------------------ #
# (b) the handles
# ------------------------------------------------------------------ #

def _cs_equal(got, want) -> None:
    assert (got.name, got.ndv, got.null_count, got.count) == \
        (want.name, want.ndv, want.null_count, want.count)
    for f in ("bounds", "cum_counts", "repeats"):
        assert np.array_equal(getattr(got.hist, f), getattr(want.hist, f)), f
    assert (got.hist.ndv, got.hist.null_count, got.hist.min_val) == \
        (want.hist.ndv, want.hist.null_count, want.hist.min_val)
    assert list(got.topn.values.items()) == list(want.topn.values.items())
    assert np.array_equal(got.cms.table, want.cms.table)
    assert got.fms.kmv.dtype == want.fms.kmv.dtype
    assert np.array_equal(got.fms.kmv, want.fms.kmv)


def _tables(n, seed=3):
    """The same table in both packages: int, double, string, decimal
    and date columns with NULLs, and the raw numpy columns."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 50_000, n)
    f = np.round(rng.normal(size=n) * 100, 1)
    s = rng.integers(0, 7, n).astype(np.int32)
    d = rng.integers(-10 ** 6, 10 ** 6, n)
    day = rng.integers(8000, 9000, n).astype(np.int32)
    ok = rng.random(n) < 0.95
    names = ["a", "f", "s", "d", "day"]
    out = []
    for C, T in ((JColumn, jdt), (Column, dt)):
        from_sd = (__import__("tidb_tpu.chunk.column", fromlist=["x"])
                   if C is JColumn else
                   __import__("tidb_tpu_torch.chunk.column", fromlist=["x"]))
        cols = [C(T.bigint(True), a.astype(np.int64), ok.copy()),
                C(T.double(True), f, ok.copy()),
                C(T.varchar(True), s, np.ones(n, bool), from_sd.StringDict(
                    [f"s{i}" for i in range(7)])),
                C(T.decimal(12, 2, True), d.astype(np.int64), ok.copy()),
                C(T.date(True), day, ok.copy())]
        Tab = JTable if C is JColumn else TableInfo
        t = Tab("t", list(names), [c.dtype for c in cols])
        t.register_columns(cols)
        out.append(t)
    return out


@pytest.mark.parametrize("sampled", [False, True])
def test_column_stats_of_both_handles_equal(sampled):
    jt, pt = _tables(6000)
    jh, ph = JHandle(), StatsHandle("cpu")
    if sampled:
        for h in (jh, ph):
            h.SAMPLE_THRESHOLD = 4000
            h.SAMPLE_TARGET = 1500
    jts, pts = jh.analyze_table(jt), ph.analyze_table(pt)
    assert (pts.count, pts.realtime_count) == (jts.count, jts.realtime_count)
    assert sorted(pts.cols) == sorted(jts.cols)
    for name in jts.cols:
        _cs_equal(pts.cols[name], jts.cols[name])
    if sampled:
        assert pts.col("a").count < 6000 * 1.2


def test_empty_column_stats_equal():
    jt, pt = _tables(0)
    jts = JHandle().analyze_table(jt)
    pts = StatsHandle("cpu").analyze_table(pt)
    assert sorted(pts.cols) == sorted(jts.cols)
    for name in jts.cols:
        _cs_equal(pts.cols[name], jts.cols[name])


# ------------------------------------------------------------------ #
# (c) through both sessions
# ------------------------------------------------------------------ #

def _pair(auto_analyze=False):
    """(JAX session, port session); the JAX handle's background load off
    unless the inline auto-analyze is on in both."""
    jd = JDomain()
    jd.client.sched_enable = False
    jd.stats.auto_analyze_enabled = auto_analyze
    js, ps = JSession(jd), Session(Domain("cpu", n_devices=8))
    flag = 1 if auto_analyze else 0
    for s in (js, ps):
        s.execute(f"set tidb_enable_auto_analyze = {flag}")
    # EXPLAIN's ``cost:`` footer reads each package's process-wide
    # correction store, which only the port's scheduler feeds here: the
    # compared plans are priced by the static model in both
    for s in (js, ps):
        s.execute("set global tidb_tpu_cost_calibration = 0")
    return js, ps


def _both(pair, sql):
    return [s.execute(sql) for s in pair]


def _same(pair, sql):
    a, b = _both(pair, sql)
    assert b.names == a.names
    assert sorted(map(tuple, b.rows), key=repr) == \
        sorted(map(tuple, a.rows), key=repr)
    return b.rows


def _plan(s, sql):
    return [r[0] for r in s.execute("explain " + sql).rows]


def _port_plan(s, sql):
    """The port's EXPLAIN lines, its device named as the JAX package's
    (the JAX session prints the device its mesh runs on and adds the
    analysis gates' footers)."""
    return [ln.replace("-> cpu", "-> TPU") for ln in _plan(s, sql)]


def _jax_plan(s, sql):
    """The JAX package's whole EXPLAIN, its analysis footers included."""
    return _plan(s, sql)


def _index_scans(s, sql, pkg):
    """The LogicalIndexScan nodes of ``sql``'s logical plan after the
    index paths, with the session's statistics."""
    if pkg == "jax":
        built = j_build_query(j_parse_sql(sql)[0], s.domain.catalog, s.db)
        plan = j_apply_index_paths(j_optimize_plan(built.plan),
                                   s.domain.stats)
        kind = JIndexScan
    else:
        built = build_query(parse_sql(sql)[0], s.domain.catalog, s.db)
        plan = apply_index_paths(optimize_plan(built.plan), s.domain.stats)
        kind = LogicalIndexScan
    found, stack = [], [plan]
    while stack:
        p = stack.pop()
        stack.extend(p.children)
        if isinstance(p, kind):
            found.append(p.access.index.name)
    return found


def test_selectivity_drives_index_choice():
    pair = _pair()
    _both(pair, "create table t (a bigint, b bigint)")
    _both(pair, "insert into t values " + ",".join(
        f"({i % 2}, {i})" for i in range(2000)))
    _both(pair, "create index ia on t (a)")
    q_wide, q_point = "select b from t where a = 0", \
        "select b from t where a = 77"
    before = [_index_scans(pair[0], q_wide, "jax"),
              _index_scans(pair[1], q_wide, "port")]
    assert before[0] == before[1]
    _both(pair, "analyze table t")
    # a = 0 matches ~1000 of 2000 rows: the index is rejected by cost
    assert _index_scans(pair[0], q_wide, "jax") == [] == \
        _index_scans(pair[1], q_wide, "port")
    assert _same(pair, "select count(*) from t where a = 0") == [(1000,)]
    assert _same(pair, q_point) == []


def test_selective_index_still_used():
    pair = _pair()
    _both(pair, "create table t (a bigint, b bigint)")
    _both(pair, "insert into t values " + ",".join(
        f"({i}, {i})" for i in range(2000)))
    _both(pair, "create index ia on t (a)")
    _both(pair, "analyze table t")
    q = "select b from t where a = 77"
    assert _index_scans(pair[0], q, "jax") == ["ia"] == \
        _index_scans(pair[1], q, "port")
    assert _jax_plan(pair[0], q) == _port_plan(pair[1], q)
    assert _same(pair, q) == [(77,)]


def test_auto_analyze_triggers():
    pair = _pair(auto_analyze=True)
    _both(pair, "create table t (a bigint)")
    _both(pair, "insert into t values " + ",".join(
        f"({i})" for i in range(1500)))
    _same(pair, "select count(*) from t where a > 10")
    jts, pts = [s.domain.stats.get(s.domain.catalog.get_table("test", "t"))
                for s in pair]
    assert pts is not None and jts is not None
    _cs_equal(pts.col("a"), jts.col("a"))
    # DML counts into the modify count; past half the analyzed rows, the
    # next plan re-analyzes
    _both(pair, "insert into t values " + ",".join(
        f"({i})" for i in range(1500, 2500)))
    assert pts.modify_count == jts.modify_count == 1000
    _same(pair, "select count(*) from t where a > 10")
    jts2, pts2 = [s.domain.stats.get(s.domain.catalog.get_table("test", "t"))
                  for s in pair]
    assert pts2 is not pts and pts2.count == jts2.count == 2500
    _both(pair, "delete from t where a < 100")
    _both(pair, "update t set a = a + 1 where a > 2400")
    assert (pts2.modify_count, pts2.realtime_count) == \
        (jts2.modify_count, jts2.realtime_count) == (199, 2400)


def _sort_capacity(s, sql, parse):
    _built, phys = s._plan_select(parse(sql)[0])
    caps, stack = [], [phys]
    while stack:
        op = stack.pop()
        dag = getattr(op, "dag", None)
        if dag is not None and type(dag).__name__ == "Aggregation" \
                and dag.strategy.value == "sort":
            caps.append(dag.group_capacity)
        stack.extend(getattr(op, "children", []))
    return caps


def test_analyze_feeds_sort_agg_capacity():
    pair = _pair()
    _both(pair, "create table nd (k bigint not null, v bigint)")
    _both(pair, "insert into nd values " + ",".join(
        f"({i % 1500}, {i})" for i in range(3000)))
    q = "select k, count(*) from nd group by k"
    before = [_sort_capacity(pair[0], q, j_parse_sql),
              _sort_capacity(pair[1], q, parse_sql)]
    assert before == [[0], [0]]
    _both(pair, "analyze table nd")
    after = [_sort_capacity(pair[0], q, j_parse_sql),
             _sort_capacity(pair[1], q, parse_sql)]
    assert after[0] == after[1] and 1500 <= after[1][0] <= 8192
    _same(pair, q)
    assert JD.GroupStrategy.SORT.value == D.GroupStrategy.SORT.value


def test_ndv_capacity_not_seeded_through_projection():
    pair = _pair()
    _both(pair, "create table pj (a bigint not null, b bigint not null)")
    _both(pair, "insert into pj values " + ",".join(
        f"({i}, {i % 3})" for i in range(1200)))
    _both(pair, "analyze table pj")
    q = "select distinct b + 0 from pj where a >= 0"
    caps = [_sort_capacity(pair[0], q, j_parse_sql),
            _sort_capacity(pair[1], q, parse_sql)]
    assert caps[0] == caps[1] and caps[1] and all(c == 0 for c in caps[1])
    assert sorted(_same(pair, "select distinct b + 0 from pj")) == \
        [(0,), (1,), (2,)]


@pytest.fixture(scope="module")
def depth_pair():
    pair = _pair()
    _both(pair, "CREATE TABLE t (a INT, b INT, c INT)")
    _both(pair, "INSERT INTO t VALUES " + ",".join(
        f"({i},{i % 100},{i % 7})" for i in range(3000)))
    return pair


def _stats(s, name="t"):
    return s.domain.stats.get(s.domain.catalog.get_table("test", name))


def test_predicate_columns_and_restricted_analyze(depth_pair):
    js, ps = depth_pair
    _same(depth_pair, "SELECT COUNT(*) FROM t WHERE b > 50 AND c = 3")
    tj, tp = [s.domain.catalog.get_table("test", "t") for s in depth_pair]
    assert ps.domain.stats.predicate_columns(tp) == \
        js.domain.stats.predicate_columns(tj) == {"b", "c"}
    _both(depth_pair, "ANALYZE TABLE t PREDICATE COLUMNS")
    assert sorted(_stats(ps).cols) == sorted(_stats(js).cols) == ["b", "c"]
    _both(depth_pair, "ANALYZE TABLE t COLUMNS a, c")
    assert sorted(_stats(ps).cols) == sorted(_stats(js).cols)
    for name in _stats(js).cols:
        _cs_equal(_stats(ps).col(name), _stats(js).col(name))


def test_sampled_analyze_through_sessions(depth_pair):
    _both(depth_pair, "ANALYZE TABLE t WITH 0.1 SAMPLERATE")
    js, ps = depth_pair
    for name in ("a", "b", "c"):
        _cs_equal(_stats(ps).col(name), _stats(js).col(name))
    assert 2000 <= _stats(ps).col("a").count <= 4000
    _both(depth_pair, "CREATE TABLE emp (a INT)")
    _both(depth_pair, "ANALYZE TABLE emp WITH 0.5 SAMPLERATE")
    assert _stats(ps, "emp").count == _stats(js, "emp").count == 0


def test_plans_after_analyze_equal(depth_pair):
    """After a full ANALYZE, the join reorder and the filters plan as in
    the JAX session, and the rows agree."""
    _both(depth_pair, "ANALYZE TABLE t")
    _both(depth_pair, "CREATE TABLE u (b INT, w INT)")
    _both(depth_pair, "INSERT INTO u VALUES " + ",".join(
        f"({i}, {i * 3})" for i in range(100)))
    _both(depth_pair, "ANALYZE TABLE u")
    for q in ("select count(*), sum(w) from t join u on t.b = u.b "
              "where t.c = 3",
              "select c, count(*) from t where a between 100 and 700 "
              "group by c",
              "select b, sum(a) from t group by b"):
        assert _jax_plan(depth_pair[0], q) == _port_plan(depth_pair[1], q)
        _same(depth_pair, q)
