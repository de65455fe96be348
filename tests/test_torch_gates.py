"""The plan-time gates of the port against the JAX package's.

Both sessions are built over the same tables made from one numpy seed
(lineitem, part and orders of ``testing/tpch``, lineitem ANALYZEd), on 8
logical devices in the port and the 8-device CPU mesh in the JAX package.
Held equal:

- the refusals of ROADMAP.md Queue 3 item 1 (a device lane that would
  wrap): the same ``PlanContractError`` rule in both sessions, and with
  ``tidb_tpu_verify_plan`` off the port runs them (the gate is what
  refuses);
- over the TPC-H plan corpus: ``contracts.verify_plan``'s operator
  count, ``valueflow`` (``prove_narrow_sums`` through the stamped
  ``narrow_sums``, ``verify_plan_values``' count, ``plan_narrow_states``,
  ``value_findings``), ``shardflow`` (``verify_plan_sharding``'s count
  or rule and ``plan_transfer``) under the native view and under the
  declared two-host view (``tidb_tpu_topology_hosts = 2``);
- a seeded bad plan per ``verify_plan`` rule: the same rule in both;
- the proof registry: a digest the session rejected is rejected again
  at the port's scheduler submit; ANALYZE watermark drift is counted in
  both packages and on ``/sched``'s ``value_drifts``;
- narrow SUMs: an analyzed table's results equal the same statements
  over limbs (the table unanalyzed) and the JAX session's, integer and
  decimal states bit for bit, floats within ``FLOAT_RTOL``.

The proof registry, the watermarks and the host view are process-wide
in both packages: every test starts and ends with them emptied.
"""

import dataclasses

import numpy as np
import pytest

from tidb_tpu.analysis import contracts as jC
from tidb_tpu.analysis import shardflow as jSF
from tidb_tpu.analysis import valueflow as jV
from tidb_tpu.chunk.column import Column as JColumn
from tidb_tpu.executor import plan as jplan
from tidb_tpu.expr.ir import ColumnRef as JRef
from tidb_tpu.parallel import topology as jtopo
from tidb_tpu.session import Domain as JDomain
from tidb_tpu.session import Session as JSession
from tidb_tpu.session.catalog import TableInfo as JTable
from tidb_tpu.sql.parser import parse_one as j_parse_one
from tidb_tpu.testing import tpch as jtpch
from tidb_tpu.types import dtypes as jdt
from tidb_tpu_torch.analysis import contracts as pC
from tidb_tpu_torch.analysis import shardflow as pSF
from tidb_tpu_torch.analysis import valueflow as pV
from tidb_tpu_torch.analysis.contracts import PlanContractError
from tidb_tpu_torch.chunk.column import Column
from tidb_tpu_torch.executor import plan as pplan
from tidb_tpu_torch.expr.ir import ColumnRef as PRef
from tidb_tpu_torch.parallel import topology as ptopo
from tidb_tpu_torch.session import Domain, Session
from tidb_tpu_torch.sql.parser import parse_one as p_parse_one
from tidb_tpu_torch.testing import tpch
from tidb_tpu_torch.types import dtypes as pdt

N_DEV = 8
SF, N_ORDERS = 0.001, 512
FLOAT_RTOL = 1e-9     # float SUM/AVG: the two sum in different orders

# ROADMAP.md Queue 3 item 1: the statements the JAX session refuses over
# an analyzed table, with the rule it names
WRAPS = {
    "select d / 2.5 from t": "NUM-DIV-PRESCALE",
    "select sum(d / 2.5) from t": "NUM-DIV-PRESCALE",
    "select a + a from t": "NUM-OVERFLOW-DEVICE",
    "select sum(a + a) from t": "NUM-OVERFLOW-DEVICE",
    "select a * 16 from u where a > 100": "NUM-OVERFLOW-DEVICE",
}
WRAP_SETUP = [
    "create table t (d decimal(18,2), a bigint)",
    f"insert into t values (999999999999.99, {2 ** 62}), (1.50, 3)",
    "analyze table t",
    "create table u (a bigint)",
    f"insert into u values ({2 ** 61}), (5)",
    "analyze table u",
]


def _clear():
    for V in (jV, pV):
        V.clear_registry()
        V._WATERMARKS.clear()
    for topo in (jtopo, ptopo):
        topo.set_host_view(None)


@pytest.fixture(autouse=True)
def _clean_state():
    """Digest-keyed verdicts and watermarks are process-wide: a verdict
    leaked from another test would shadow an identical DAG here."""
    _clear()
    yield
    _clear()


def _tables(gen):
    return {"lineitem": gen.gen_lineitem(SF, seed=42),
            "part": gen.gen_part(sf=max(SF * 10, 0.005), seed=7),
            "orders": gen.gen_orders_mini(N_ORDERS)}


def _jax_session(tables, analyze=True):
    dom = JDomain()
    dom.client.sched_enable = False          # no scheduler daemon threads
    dom.stats.auto_analyze_enabled = False   # no background ANALYZE
    for name, (names, cols) in tables.items():
        t = JTable(name, list(names), [c.dtype for c in cols])
        t.register_columns(list(cols))
        dom.catalog.create_table("test", t)
    s = JSession(dom)
    s.execute("set tidb_enable_auto_analyze = 0")
    s.execute("set global tidb_tpu_cost_calibration = 0")
    if analyze:
        s.execute("analyze table lineitem")
    return s


def _port_session(tables, analyze=True):
    s = tpch.sql_session(tables, device="cpu", n_devices=N_DEV)
    s.execute("set global tidb_tpu_cost_calibration = 0")
    if analyze:
        s.execute("analyze table lineitem")
    return s


@pytest.fixture(scope="module")
def corpus():
    """(JAX session, port session, [(sql, jax plan, port plan)]) over
    the JAX package's plan corpus, the shuffle statements planned under
    a zero broadcast budget in both."""
    js = _jax_session(_tables(jtpch))
    ps = _port_session(_tables(tpch))
    plans = []
    for sql in jtpch.TPCH_PLAN_QUERIES:
        plans.append((sql, js._plan_select(j_parse_one(sql))[1],
                      ps._plan_select(p_parse_one(sql))[1]))
    saved = jplan.BROADCAST_BUILD_MAX_ROWS, pplan.BROADCAST_BUILD_MAX_ROWS
    jplan.BROADCAST_BUILD_MAX_ROWS = pplan.BROADCAST_BUILD_MAX_ROWS = 0
    try:
        for sql in jtpch.TPCH_SHUFFLE_QUERIES:
            plans.append((sql, js._plan_select(j_parse_one(sql))[1],
                          ps._plan_select(p_parse_one(sql))[1]))
    finally:
        jplan.BROADCAST_BUILD_MAX_ROWS, pplan.BROADCAST_BUILD_MAX_ROWS = saved
    return js, ps, plans


def _ops(phys, name):
    out, stack = [], [phys]
    while stack:
        op = stack.pop()
        if type(op).__name__ == name:
            out.append(op)
        stack += [c for c in getattr(op, "children", []) or []
                  if c is not None]
        fb = getattr(op, "fallback", None)
        if fb is not None:
            stack.append(fb)
    return out


def _outcome(fn):
    try:
        return ("ok", fn())
    except PlanContractError as e:
        return ("rejected", e.rule)


def _rows_equal(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert isinstance(x, float)
                assert x == pytest.approx(y, rel=FLOAT_RTOL, abs=1e-9) \
                    or (np.isnan(x) and np.isnan(y))
            else:
                assert type(x) is type(y) and x == y, (x, y)


# ------------------------------------------------------------------ #
# Queue 3 item 1: the wraps the gate refuses
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def wrap_sessions():
    js = _jax_session({}, analyze=False)
    ps = _port_session({}, analyze=False)
    for s in (js, ps):
        for sql in WRAP_SETUP:
            s.execute(sql)
        # a plan cache hit skips the gates (in both packages): each
        # statement here is planned afresh, under the gate's setting
        s.execute("set tidb_enable_plan_cache = 0")
    return js, ps


def _rule_of(sess, sql):
    with pytest.raises(Exception) as ei:
        sess.execute(sql)
    assert type(ei.value).__name__ == "PlanContractError", ei.value
    return ei.value.rule


@pytest.mark.parametrize("sql", list(WRAPS))
def test_wrapping_lane_refused_with_the_jax_rule(wrap_sessions, sql):
    js, ps = wrap_sessions
    assert _rule_of(js, sql) == _rule_of(ps, sql) == WRAPS[sql]


# the JAX session with the gate off: its host lane raises for the one
# SUM whose decimal quotient overflows on the CPU (ROADMAP.md Queue 3
# item 4); its device lanes and the port's wrap alike
JAX_GATE_OFF = {"select sum(d / 2.5) from t": "OverflowError"}


@pytest.mark.parametrize("sql", list(WRAPS))
def test_gate_off_runs_the_statement(wrap_sessions, sql):
    """With ``tidb_tpu_verify_plan`` off (a session variable the JAX
    package reads and neither package's SET accepts) the port launches
    the statement: the gate is what refuses it."""
    js, ps = wrap_sessions
    for s in (js, ps):
        s.vars["tidb_tpu_verify_plan"] = 0
    try:
        got = ps.execute(sql).rows
        if sql in JAX_GATE_OFF:
            with pytest.raises(Exception) as ei:
                js.execute(sql)
            assert type(ei.value).__name__ == JAX_GATE_OFF[sql]
        else:
            _rows_equal(sorted(got, key=repr),
                        sorted(js.execute(sql).rows, key=repr))
    finally:
        for s in (js, ps):
            s.vars.pop("tidb_tpu_verify_plan")


def test_rejected_digest_replayed_at_the_port_scheduler(wrap_sessions):
    """A digest the session rejected stays rejected at the scheduler's
    submit, before any launch, even for a caller that skipped the
    session's gate."""
    import torch
    from tidb_tpu_torch.sched.task import CopTask
    _js, ps = wrap_sessions
    ps.execute("analyze table t")
    sql = "select sum(a + a) from t"
    ps.vars["tidb_tpu_verify_plan"] = 0
    try:
        dag = _ops(ps._plan_select(p_parse_one(sql))[1],
                   "CopTaskExec")[0].dag
    finally:
        ps.vars.pop("tidb_tpu_verify_plan")
    assert pV.registry_verdict(dag) is None
    assert _rule_of(ps, sql) == "NUM-OVERFLOW-DEVICE"
    assert pV.registry_verdict(dag)[0] == "rejected"
    devs = ps.domain.client.devices
    cols = [(torch.zeros((N_DEV, 16), dtype=torch.int64), None)]
    counts = torch.full((N_DEV,), 16, dtype=torch.int64)
    sched = ps.domain.client._scheduler()
    with pytest.raises(PlanContractError) as ei:
        sched.submit(CopTask.structured(dag, devs, 0, cols, counts, ()))
    assert ei.value.rule == "NUM-OVERFLOW-DEVICE"
    assert ei.value.path[0] == "sched"


# ------------------------------------------------------------------ #
# the corpus: verify_plan, valueflow and shardflow equal
# ------------------------------------------------------------------ #

def test_corpus_verifies_and_narrows_as_the_jax_planner(corpus):
    js, ps, plans = corpus
    narrowed = 0
    for sql, jp, pp in plans:
        assert pC.verify_plan(pp) == jC.verify_plan(jp), sql
        assert _outcome(lambda: pV.verify_plan_values(pp, ps.domain.stats)) \
            == _outcome(lambda: jV.verify_plan_values(
                jp, js.domain.stats)), sql
        assert pV.plan_narrow_states(pp) == jV.plan_narrow_states(jp), sql
        pdags = [op.dag for op in _ops(pp, "CopTaskExec")]
        jdags = [op.dag for op in _ops(jp, "CopTaskExec")]
        assert [getattr(d, "narrow_sums", ()) for d in pdags] == \
            [getattr(d, "narrow_sums", ()) for d in jdags], sql
        narrowed += pV.plan_narrow_states(pp)
    assert narrowed > 0     # the analyzed lineitem proves some SUMs narrow


def test_prove_narrow_sums_equal(corpus):
    """The proof itself, on each plan's stamped aggregation with its
    stamp removed: the same slots in both packages."""
    js, ps, plans = corpus
    jt = js.domain.catalog.get_table("test", "lineitem")
    pt = ps.domain.catalog.get_table("test", "lineitem")
    n = 0
    for sql, jp, pp in plans:
        for jop, pop in zip(_ops(jp, "CopTaskExec"), _ops(pp, "CopTaskExec")):
            if type(pop.dag).__name__ != "Aggregation" \
                    or pop.table.name != "lineitem":
                continue
            jagg = dataclasses.replace(jop.dag, narrow_sums=())
            pagg = dataclasses.replace(pop.dag, narrow_sums=())
            got = pV.prove_narrow_sums(pagg, pt, ps.domain.stats)
            assert got == jV.prove_narrow_sums(jagg, jt, js.domain.stats)
            assert got == pop.dag.narrow_sums, sql
            n += 1
    assert n > 0


def test_value_findings_and_report_equal(corpus):
    js, ps, plans = corpus
    jplans = [(sql, jp) for sql, jp, _pp in plans]
    pplans = [(sql, pp) for sql, _jp, pp in plans]
    assert [vars(f) for f in pV.value_findings(pplans, ps.domain.stats)] \
        == [vars(f) for f in jV.value_findings(jplans, js.domain.stats)]
    assert pV.value_report(pplans, ps.domain.stats) \
        == jV.value_report(jplans, js.domain.stats)


@pytest.mark.parametrize("hosts", [1, 2])
def test_sharding_and_transfer_equal_under_the_view(corpus, hosts):
    _js, _ps, plans = corpus
    jtop = jtopo.MeshTopology((jtopo.SHARD_AXIS,), N_DEV, hosts)
    ptop = ptopo.MeshTopology((ptopo.SHARD_AXIS,), N_DEV, hosts)
    for sql, jp, pp in plans:
        assert _outcome(lambda: pSF.verify_plan_sharding(pp, ptop)) == \
            _outcome(lambda: jSF.verify_plan_sharding(jp, jtop)), sql
        assert pSF.plan_transfer(pp, ptop).as_tuple() == \
            jSF.plan_transfer(jp, jtop).as_tuple(), sql
    jplans = [(sql, jp) for sql, jp, _pp in plans]
    pplans = [(sql, pp) for sql, _jp, pp in plans]
    assert [vars(f) for f in pSF.shard_findings(pplans, N_DEV)] == \
        [vars(f) for f in jSF.shard_findings(jplans, N_DEV)]
    assert pSF.transfer_report(pplans, N_DEV) == \
        jSF.transfer_report(jplans, N_DEV)


@pytest.mark.parametrize("hosts", [-1, 2])
def test_declared_host_view_reaches_explain(corpus, hosts):
    """``tidb_tpu_topology_hosts`` feeds the session's topology in both
    packages: EXPLAIN's transfer footer of a shuffle join is equal."""
    js, ps, _plans = corpus
    sql = jtpch.TPCH_SHUFFLE_QUERIES[0]
    saved = jplan.BROADCAST_BUILD_MAX_ROWS, pplan.BROADCAST_BUILD_MAX_ROWS
    jplan.BROADCAST_BUILD_MAX_ROWS = pplan.BROADCAST_BUILD_MAX_ROWS = 0
    lines, views = [], []
    try:
        for s, topo in ((js, jtopo), (ps, ptopo)):
            s.execute(f"set global tidb_tpu_topology_hosts = {hosts}")
            lines.append([r[0] for r in s.execute("explain " + sql).rows
                          if r[0].startswith(("transfer:", "contract:"))])
            views.append(topo.host_view())
    finally:
        jplan.BROADCAST_BUILD_MAX_ROWS, pplan.BROADCAST_BUILD_MAX_ROWS = saved
        for s in (js, ps):
            s.execute("set global tidb_tpu_topology_hosts = -1")
    assert lines[1] == lines[0] and "contract: ok" in lines[1]
    assert views == [2, 2] if hosts == 2 else views == [None, None]
    transfer = [ln for ln in lines[1] if ln.startswith("transfer:")]
    assert len(transfer) == 1
    assert transfer[0].endswith(" 0B dci") is (hosts != 2)


# ------------------------------------------------------------------ #
# seeded bad plans: one per verify_plan rule
# ------------------------------------------------------------------ #

def _seed_dtype(cop, pkg):
    D, dt, Ref = pkg
    agg = cop.dag
    sel = agg.child
    bad = dataclasses.replace(
        sel, conditions=sel.conditions + (Ref(dt.double(False), 0, "x"),))
    return dataclasses.replace(cop, dag=dataclasses.replace(agg, child=bad))


def _seed_column_ref(cop, pkg):
    D, dt, Ref = pkg
    return dataclasses.replace(cop, dag=dataclasses.replace(
        cop.dag, group_by=(Ref(dt.bigint(False), 99, "oob"),)))


def _seed_capacity(cop, pkg):
    D, dt, Ref = pkg
    return dataclasses.replace(cop, dag=D.Aggregation(
        child=cop.dag.child, group_by=(Ref(dt.bigint(False), 0, "k"),),
        aggs=cop.dag.aggs, strategy=D.GroupStrategy.DENSE,
        domain_sizes=(4, 4)))


def _seed_arity(cop, pkg):
    return dataclasses.replace(cop, out_names=list(cop.out_names) + ["x"])


def _seed_exchange(shuffle, pkg):
    D, dt, Ref = pkg
    spec = shuffle.spec
    return dataclasses.replace(shuffle, spec=dataclasses.replace(
        spec, left_dtypes=spec.left_dtypes + (dt.bigint(False),)))


def _seed_narrow(cop, pkg):
    """A narrow stamp the seeded statistics cannot re-prove: the value
    pass refuses it (NUM-FENCE-UNPROVEN)."""
    return dataclasses.replace(cop, dag=dataclasses.replace(
        cop.dag, narrow_sums=(0,)))


SEEDS = {"dtype-mismatch": ("revenue", "CopTaskExec", _seed_dtype),
         "column-ref": ("revenue", "CopTaskExec", _seed_column_ref),
         "capacity-shape": ("revenue", "CopTaskExec", _seed_capacity),
         "arity": ("revenue", "CopTaskExec", _seed_arity),
         "exchange-mismatch": (None, "CopShuffleJoinExec", _seed_exchange)}


@pytest.mark.parametrize("rule", list(SEEDS))
def test_seeded_bad_plan_same_rule(corpus, rule):
    from tidb_tpu.copr import dag as JD
    from tidb_tpu_torch.copr import dag as PD
    _js, _ps, plans = corpus
    key, opname, seed = SEEDS[rule]
    got = []
    for i, (C, pkg) in enumerate(((jC, (JD, jdt, JRef)),
                                  (pC, (PD, pdt, PRef)))):
        phys = next(p[1 + i] for p in plans
                    if (key is None or key in p[0])
                    and _ops(p[1 + i], opname))
        bad = seed(_ops(phys, opname)[0], pkg)
        with pytest.raises(Exception) as ei:
            C.verify_plan(bad)
        got.append((type(ei.value).__name__, ei.value.rule))
    assert got[0] == got[1] == ("PlanContractError", rule)


def test_seeded_unprovable_narrow_claim_same_rule():
    """Over an analyzed table whose values make the stamped slot
    unprovable, both value passes refuse the claim."""
    from tidb_tpu.copr import dag as JD
    from tidb_tpu_torch.copr import dag as PD
    big = 2 ** 61
    rules = []
    for mk, parse, V, pkg in (
            (lambda: _jax_session({}, analyze=False), j_parse_one, jV,
             (JD, jdt, JRef)),
            (lambda: _port_session({}, analyze=False), p_parse_one, pV,
             (PD, pdt, PRef))):
        s = mk()
        s.execute("create table w (a bigint)")
        s.execute(f"insert into w values ({big}), (1)")
        s.execute("analyze table w")
        cop = _ops(s._plan_select(parse("select sum(a) from w"))[1],
                   "CopTaskExec")[0]
        assert cop.dag.narrow_sums == ()
        with pytest.raises(Exception) as ei:
            V.verify_plan_values(_seed_narrow(cop, pkg), s.domain.stats)
        rules.append(ei.value.rule)
    assert rules == ["NUM-FENCE-UNPROVEN"] * 2


# ------------------------------------------------------------------ #
# watermark drift: counted in both, surfaced on /sched
# ------------------------------------------------------------------ #

def _drift_sessions():
    js = _jax_session({}, analyze=False)
    ps = _port_session({}, analyze=False)
    for s in (js, ps):
        s.execute("create table m (a bigint)")
        s.execute("insert into m values " +
                  ",".join(f"({i})" for i in range(1, 65)))
        s.execute("analyze table m")
        s.execute("set tidb_enable_plan_cache = 1")
    return js, ps


def test_watermark_drift_counted_in_both():
    """A cached plan proved against the old statistics meets the new
    watermarks after a write and a new ANALYZE: drift, in both
    packages, never a wrong result."""
    import torch
    from tidb_tpu.sched.task import CopTask as JTask
    from tidb_tpu.parallel.mesh import get_mesh
    import jax.numpy as jnp
    from tidb_tpu_torch.sched.task import CopTask as PTask
    js, ps = _drift_sessions()
    sql = "select sum(a) from m"
    for s in (js, ps):
        s.execute("insert into m values (100000)")   # past the watermark
    jrows, prows = js.execute(sql).rows, ps.execute(sql).rows
    assert prows == jrows == [(pytest.approx(2080 + 100000),)]
    for s in (js, ps):
        s.execute("analyze table m")     # stamps the wider watermark
    jdag = _ops(js._plan_select(j_parse_one(sql), sql)[1],
                "CopTaskExec")[0].dag
    pdag = _ops(ps._plan_select(p_parse_one(sql), sql)[1],
                "CopTaskExec")[0].dag
    jt = JTask.structured(jdag, get_mesh(), 0,
                          [(jnp.zeros((8, 16), jnp.int64), None)],
                          jnp.full((8,), 16, jnp.int64), ())
    pt = PTask.structured(pdag, ps.domain.client.devices, 0,
                          [(torch.zeros((8, 16), dtype=torch.int64), None)],
                          torch.full((8,), 16, dtype=torch.int64), ())
    j0, p0 = jV.drift_count(), pV.drift_count()
    jV.verify_task_values(jt)
    pV.verify_task_values(pt)
    assert jt.value_drift == pt.value_drift == 1
    assert (jV.drift_count() - j0, pV.drift_count() - p0) == (1, 1)


def test_drift_reaches_sched_and_a_new_plan_stops_it():
    """On the port's statement path: the plan-cache hit replays the old
    proof against the new watermark and ``/sched`` counts the drift,
    with the exact result; re-planned after the ANALYZE, it is quiet."""
    _js, ps = _drift_sessions()
    # every run launches: the client's result cache would answer the
    # repeated statement without one
    ps.execute("set global tidb_tpu_result_cache_entries = 0")
    sql = "select sum(a) from m"
    sched = ps.domain.client._scheduler()
    ps.execute("insert into m values (100000)")
    ps.execute(sql)                      # planned on the old statistics
    ps.execute("analyze table m")
    d0 = sched.stats()["value_drifts"]
    assert ps.execute(sql).rows == [(2080 + 100000,)]
    assert sched.stats()["value_drifts"] == d0 + 1
    ps.execute("set tidb_enable_plan_cache = 0")     # a fresh proof
    assert ps.execute(sql).rows == [(2080 + 100000,)]
    assert sched.stats()["value_drifts"] == d0 + 1


# ------------------------------------------------------------------ #
# narrow SUMs: equal to the limbs and to the JAX session
# ------------------------------------------------------------------ #

NARROW_SQL = {name: tpch.SQL_QUERIES[name] for name in ("Q1", "Q6")}


@pytest.fixture(scope="module")
def narrow_sessions():
    tables = {"lineitem": tpch.gen_lineitem(SF, seed=42)}
    jtables = {"lineitem": jtpch.gen_lineitem(sf=SF, seed=42)}
    return (_jax_session(jtables), _port_session(tables),
            _port_session(tables, analyze=False))


@pytest.mark.parametrize("name", list(NARROW_SQL))
def test_narrow_results_equal_limbs_and_jax(narrow_sessions, name):
    js, ps, limbs = narrow_sessions
    sql = NARROW_SQL[name]
    narrow = pV.plan_narrow_states(ps._plan_select(p_parse_one(sql))[1])
    assert narrow > 0
    assert narrow == jV.plan_narrow_states(
        js._plan_select(j_parse_one(sql))[1])
    assert pV.plan_narrow_states(limbs._plan_select(p_parse_one(sql))[1]) \
        == 0
    got = ps.execute(sql).rows
    _rows_equal(got, js.execute(sql).rows)
    _rows_equal(got, limbs.execute(sql).rows)
