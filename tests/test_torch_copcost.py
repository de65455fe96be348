"""The port's cost model and high-NDV strategy choice against the JAX
package's.

(a) ``analysis/copcost``: over the plans of ``TPCH_PLAN_QUERIES`` and
    ``TPCH_SHUFFLE_QUERIES`` (testing/tpch.py) in both sessions, the
    ``plan_cost`` of each plan and the ``dag_cost`` of each cop task's
    DAG over its table's ``snapshot_layout`` are equal field for field,
    and ``stable_digest``/``family_digest`` of every DAG are equal (the
    two packages' DAG dataclasses carry the same names and fields, so the
    canonical encodings agree byte for byte);
(b) the three arbitration candidates (SCATTER, SEGMENT, SORT) of a
    high-NDV GROUP BY: ``dag_cost``, ``predict_ms``, ``arbitrated_ms``
    and the digests equal, with both correction stores empty;
(c) the strategy EXPLAIN names and the rows equal to the JAX session's:
    at an NDV whose capacity stays under ``SEGMENT_MIN_NDV`` = 2^15 and
    one just over, both after ANALYZE; past 1,000,000 groups by the
    domain product of two VARCHAR keys of 1,100 values each, without
    statistics.

``executor.plan.ARBITRATE_FALLBACKS`` stays 0 throughout (the
``no_arbitrate_fallback`` fixture): a fault in the copied cost model
cannot hide behind the reference's fall back to the first candidate.
"""

import dataclasses

import numpy as np
import pytest

from tidb_tpu.analysis import calibrate as jcal
from tidb_tpu.analysis import compilekey as jkey
from tidb_tpu.analysis import copcost as jcost
from tidb_tpu.chunk.column import Column as JColumn
from tidb_tpu.chunk.column import StringDict as JStringDict
from tidb_tpu.executor import plan as jplan
from tidb_tpu.session import Domain as JDomain
from tidb_tpu.session import Session as JSession
from tidb_tpu.session.catalog import TableInfo as JTable
from tidb_tpu.sql.parser import parse_one as j_parse_one
from tidb_tpu.testing import tpch as jtpch
from tidb_tpu.types import dtypes as jdt
from tidb_tpu_torch.analysis import calibrate as pcal
from tidb_tpu_torch.analysis import compilekey as pkey
from tidb_tpu_torch.analysis import copcost as pcost
from tidb_tpu_torch.chunk.column import Column, StringDict
from tidb_tpu_torch.executor import plan as pplan
from tidb_tpu_torch.sql.parser import parse_one
from tidb_tpu_torch.testing import tpch
from tidb_tpu_torch.types import dtypes as dt

N_DEV = 8
COP_OPS = ("CopTaskExec", "CopJoinTaskExec", "CopShuffleJoinExec",
           "CopWindowExec")


@pytest.fixture(autouse=True)
def no_arbitrate_fallback(monkeypatch):
    """``ARBITRATE_FALLBACKS`` starts each test at 0 and stays 0.  Each
    package's correction store is process-wide, and the clients of other
    test files in this process feed it (the port's through its device
    scheduler): both are emptied first, so that both packages price with
    the static model."""
    jcal.correction_store().reset()
    pcal.correction_store().reset()
    monkeypatch.setattr(pplan, "ARBITRATE_FALLBACKS", 0)
    yield
    assert pplan.ARBITRATE_FALLBACKS == 0


def _stores_empty() -> None:
    assert jcal.correction_store().stats()["entries"] == 0
    assert pcal.correction_store().stats()["entries"] == 0


def _jax_session(tables: dict):
    dom = JDomain()
    dom.client.sched_enable = False          # no scheduler daemon threads
    dom.stats.auto_analyze_enabled = False   # no background ANALYZE
    for name, (names, cols) in tables.items():
        t = JTable(name, list(names), [c.dtype for c in cols])
        t.register_columns(list(cols))
        dom.catalog.create_table("test", t)
    s = JSession(dom)
    s.execute("set tidb_enable_auto_analyze = 0")
    return s


def _cop_ops(phys):
    out, stack = [], [phys]
    while stack:
        op = stack.pop()
        if type(op).__name__ in COP_OPS:
            out.append(op)
        stack.extend(c for c in (getattr(op, "children", ()) or ())
                     if c is not None)
        if getattr(op, "fallback", None) is not None:
            stack.append(op.fallback)
    return out


def _cost_equal(got, want) -> None:
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ------------------------------------------------------------------ #
# (a) the plan corpus
# ------------------------------------------------------------------ #

def _corpus_tables(gen):
    return {"lineitem": gen.gen_lineitem(0.001, seed=42),
            "part": gen.gen_part(sf=0.01, seed=7),
            "orders": gen.gen_orders_mini(512)}


@pytest.fixture(scope="module")
def corpus_sessions():
    js = _jax_session(_corpus_tables(jtpch))
    ps = tpch.sql_session(_corpus_tables(tpch), device="cpu",
                          n_devices=N_DEV)
    return js, ps


CORPUS = ([("plan", q) for q in tpch.TPCH_PLAN_QUERIES]
          + [("shuffle", q) for q in tpch.TPCH_SHUFFLE_QUERIES])


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_corpus_costs_and_digests_equal(i, corpus_sessions, monkeypatch):
    kind, sql = CORPUS[i]
    js, ps = corpus_sessions
    if kind == "shuffle":
        monkeypatch.setattr(jplan, "BROADCAST_BUILD_MAX_ROWS", 0)
        monkeypatch.setattr(pplan, "BROADCAST_BUILD_MAX_ROWS", 0)
    _stores_empty()
    jphys = js._plan_select(j_parse_one(sql))[1]
    pphys = ps._plan_select(parse_one(sql))[1]
    _cost_equal(pcost.plan_cost(pphys, N_DEV), jcost.plan_cost(jphys, N_DEV))
    jops, pops = _cop_ops(jphys), _cop_ops(pphys)
    assert [type(o).__name__ for o in pops] == \
        [type(o).__name__ for o in jops]
    for jo, po in zip(jops, pops):
        if not hasattr(po, "dag"):
            continue
        jsnap, psnap = jo.table.snapshot(), po.table.snapshot()
        jl, pl = (jcost.snapshot_layout(jsnap, N_DEV),
                  pcost.snapshot_layout(psnap, N_DEV))
        assert dataclasses.asdict(pl) == dataclasses.asdict(jl)
        jw, pw = (jcost.snapshot_scan_widths(jsnap),
                  pcost.snapshot_scan_widths(psnap))
        assert pw == jw
        _cost_equal(pcost.dag_cost(po.dag, pl, pw),
                    jcost.dag_cost(jo.dag, jl, jw))
        assert pkey.stable_digest(po.dag) == jkey.stable_digest(jo.dag)
        assert pkey.family_digest(po.dag) == jkey.family_digest(jo.dag)


# ------------------------------------------------------------------ #
# (b) the arbitration candidates
# ------------------------------------------------------------------ #

def _candidates(agg, cap):
    """The three candidates ``_arbitrate_strategy`` prices, in order."""
    S = type(agg.strategy)
    return (dataclasses.replace(agg, strategy=S.SCATTER, num_buckets=cap,
                                group_capacity=0),
            dataclasses.replace(agg, strategy=S.SEGMENT, num_buckets=cap,
                                group_capacity=0),
            dataclasses.replace(agg, strategy=S.SORT, group_capacity=cap,
                                num_buckets=0))


@pytest.mark.parametrize("sql", [
    "select l_orderkey, sum(l_quantity) from lineitem group by l_orderkey",
    "select l_orderkey, l_suppkey, max(l_extendedprice) from lineitem "
    "group by l_orderkey, l_suppkey",
    "select l_partkey, count(*), avg(l_discount) from lineitem "
    "where l_quantity < 20 group by l_partkey"])
@pytest.mark.parametrize("cap", [1 << 15, 1 << 20])
def test_arbitration_candidates_price_equal(sql, cap, corpus_sessions):
    js, ps = corpus_sessions
    _stores_empty()
    jop = _cop_ops(js._plan_select(j_parse_one(sql))[1])[0]
    pop = _cop_ops(ps._plan_select(parse_one(sql))[1])[0]
    jsnap, psnap = jop.table.snapshot(), pop.table.snapshot()
    jl, jw = (jcost.snapshot_layout(jsnap, 8),
              jcost.snapshot_scan_widths(jsnap))
    pl, pw = (pcost.snapshot_layout(psnap, 8),
              pcost.snapshot_scan_widths(psnap))
    for jc, pc in zip(_candidates(jop.dag, cap), _candidates(pop.dag, cap)):
        jd, pd = jkey.stable_digest(jc), pkey.stable_digest(pc)
        assert pd == jd
        jlc, plc = jcost.dag_cost(jc, jl, jw), pcost.dag_cost(pc, pl, pw)
        _cost_equal(plc, jlc)
        assert pcal.predict_ms(plc) == jcal.predict_ms(jlc)
        assert pcal.arbitrated_ms(pd, plc) == jcal.arbitrated_ms(jd, jlc)
    # the port's choice over its candidates is the JAX package's
    got = pplan._arbitrate_strategy(_candidates(pop.dag, cap), pop)
    want = jplan._arbitrate_strategy(_candidates(jop.dag, cap), jop)
    assert got.strategy.value == want.strategy.value


@pytest.mark.parametrize("input_bytes,flops", [(0, 0), (1 << 24, 10 ** 8),
                                               (12345, 678), (1 << 40, 1)])
def test_static_price_equal_while_the_store_is_empty(input_bytes, flops):
    """With no launch fed back, ``arbitrated_ms`` is ``predict_ms`` in
    both packages, and the two equal each other."""
    _stores_empty()
    cost_j = jcost.LaunchCost(input_bytes=input_bytes, flops=flops)
    cost_p = pcost.LaunchCost(input_bytes=input_bytes, flops=flops)
    assert pcal.predict_ms(cost_p) == jcal.predict_ms(cost_j)
    assert pcal.arbitrated_ms("d", cost_p) == jcal.arbitrated_ms(
        "d", cost_j) == pcal.predict_ms(cost_p)
    for f in (0.0, 0.125, 1.0, 7.9, 100.0):
        assert pcal.clamp_factor(f) == jcal.clamp_factor(f)


# ------------------------------------------------------------------ #
# (c) the strategy through both sessions
# ------------------------------------------------------------------ #

def _hk_tables(ndv, n, seed=4):
    rng = np.random.default_rng(seed)
    k = rng.permutation(np.concatenate(
        [np.arange(ndv), rng.integers(0, ndv, n - ndv)])).astype(np.int64)
    v = rng.integers(-1000, 1000, n).astype(np.int64)
    ok = rng.random(n) < 0.97
    return [{"hk": (["k", "v"], [C(T.bigint(False), k, np.ones(n, bool)),
                                 C(T.bigint(True), v, ok.copy())])}
            for C, T in ((JColumn, jdt), (Column, dt))]


def _strategy(s, sql, jax_side):
    """The aggregation strategy the statement's EXPLAIN names."""
    lines = [r[0] for r in s.execute("explain " + sql).rows]
    for ln in lines:
        if "Aggregation[" in ln:
            return ln.split("Aggregation[", 1)[1].split("]", 1)[0]
    raise AssertionError(lines)


def _agg_dag(s, sql, parse):
    return _cop_ops(s._plan_select(parse(sql))[1])[0].dag


def _rows_equal(js, ps, sql):
    a = sorted(map(tuple, js.execute(sql).rows), key=repr)
    b = sorted(map(tuple, ps.execute(sql).rows), key=repr)
    assert b == a
    return b


@pytest.mark.parametrize("ndv,expect_arbitrated", [(13_000, False),
                                                   (14_000, True)])
def test_strategy_around_2_pow_15_after_analyze(ndv, expect_arbitrated):
    """NDV 13,000 seeds a SORT capacity of 2^14; 14,000 one of 2^15,
    which the cost model arbitrates."""
    jt, pt = _hk_tables(ndv, 20_000)
    js = _jax_session(jt)
    ps = tpch.sql_session(pt, device="cpu", n_devices=N_DEV)
    sql = "select k, sum(v), count(*) from hk group by k"
    assert _strategy(js, sql, True) == _strategy(ps, sql, False) == "sort"
    for s in (js, ps):
        s.execute("analyze table hk")
    _stores_empty()
    got, want = _strategy(ps, sql, False), _strategy(js, sql, True)
    assert got == want
    jdag, pdag = _agg_dag(js, sql, j_parse_one), _agg_dag(ps, sql, parse_one)
    assert pdag.state_capacity == jdag.state_capacity == \
        (1 << 15 if expect_arbitrated else 1 << 14)
    if not expect_arbitrated:
        assert got == "sort"
    rows = _rows_equal(js, ps, sql)
    assert len(rows) == ndv


def test_two_varchar_keys_past_a_million_groups():
    """The probe of two VARCHAR keys of 1,100 values each: the domain
    product passes MAX_DENSE_GROUPS without statistics, and the port
    now answers with the JAX package's strategy and rows."""
    rng = np.random.default_rng(1)
    n = 4100
    a = np.concatenate([np.arange(1100), rng.integers(0, 1100, n - 1100)])
    b = np.concatenate([np.arange(1100), rng.integers(0, 1100, n - 1100)])
    v = rng.integers(0, 100, n)
    tabs = []
    for C, T, SD in ((JColumn, jdt, JStringDict), (Column, dt, StringDict)):
        tabs.append({"t": (["a", "b", "v"], [
            C(T.varchar(True), a.astype(np.int32), np.ones(n, bool),
              SD([f"a{i:04d}" for i in range(1100)])),
            C(T.varchar(True), b.astype(np.int32), np.ones(n, bool),
              SD([f"b{i:04d}" for i in range(1100)])),
            C(T.bigint(True), v.astype(np.int64), np.ones(n, bool))])})
    js = _jax_session(tabs[0])
    ps = tpch.sql_session(tabs[1], device="cpu", n_devices=N_DEV)
    sql = "select a, b, sum(v) from t group by a, b"
    _stores_empty()
    got, want = _strategy(ps, sql, False), _strategy(js, sql, True)
    assert got == want and got in ("scatter", "segment", "sort")
    _rows_equal(js, ps, sql)
