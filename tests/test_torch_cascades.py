"""The cascades planner (``planner/cascades/``) of the port against the
JAX package's.

The cases are those of ``tests/test_cascades.py``, each built twice from
the same seeded numpy columns: once over a JAX ``Domain`` (its client
with ``sched_enable = False``, auto-analyze off) and once over the
port's ``Domain("cpu")``.  ``search`` is called directly on the
optimized plan in both packages, never through ``cascades_optimize``
(which falls back to the greedy reorder on any error, so a broken
search would still give right answers): the memo's group counts, the
extracted plan's ``explain_logical`` text and the join methods it
stamps are equal.  Through the session with
``tidb_enable_cascades_planner`` on, the rows equal the JAX session's
with the flag on and the port's own heuristic plan's; the plan cache
keys on the flag.
"""

import numpy as np
import pytest

from test_torch_dml import jax_domain, jax_session
from tidb_tpu.chunk.column import Column as JColumn
from tidb_tpu.planner.build import build_query as j_build_query
from tidb_tpu.planner.cascades.memo import Memo as JMemo
from tidb_tpu.planner.cascades.search import search as j_search
from tidb_tpu.planner.logical import explain_logical as j_explain
from tidb_tpu.planner.logical import walk_plan as j_walk
from tidb_tpu.planner.optimize import optimize_plan as j_optimize
from tidb_tpu.session.catalog import TableInfo as JTable
from tidb_tpu.sql.parser import parse_one as j_parse_one
from tidb_tpu.types import dtypes as jdt
from tidb_tpu_torch.chunk.column import Column
from tidb_tpu_torch.planner.build import build_query
from tidb_tpu_torch.planner.cascades.memo import Memo
from tidb_tpu_torch.planner.cascades.search import search
from tidb_tpu_torch.planner.logical import (DataSource, LogicalJoin,
                                            LogicalTopN, explain_logical,
                                            walk_plan)
from tidb_tpu_torch.planner.optimize import optimize_plan
from tidb_tpu_torch.planner.plan_cache import _PLAN_SYSVARS
from tidb_tpu_torch.session import Domain, Session
from tidb_tpu_torch.session.catalog import TableInfo
from tidb_tpu_torch.sql.parser import parse_one
from tidb_tpu_torch.types import dtypes as dt

# each package's planner entry points, by the same names
JAX = {"Column": JColumn, "TableInfo": JTable, "dt": jdt,
       "build_query": j_build_query, "parse_one": j_parse_one,
       "optimize_plan": j_optimize, "search": j_search, "Memo": JMemo,
       "explain": j_explain, "walk": j_walk}
PORT = {"Column": Column, "TableInfo": TableInfo, "dt": dt,
        "build_query": build_query, "parse_one": parse_one,
        "optimize_plan": optimize_plan, "search": search, "Memo": Memo,
        "explain": explain_logical, "walk": walk_plan}


def _session(pkg):
    if pkg is JAX:
        return jax_session(jax_domain())
    return Session(Domain("cpu"))


def _mk(pkg, dom, name, cols):
    """An in-memory table of bigint columns ``cols`` (name, array)."""
    t = pkg["TableInfo"](name, [n for n, _ in cols],
                         [pkg["dt"].bigint() for _ in cols])
    t.register_columns([pkg["Column"](pkg["dt"].bigint(),
                                      a.astype(np.int64),
                                      np.ones(len(a), bool))
                        for _, a in cols])
    dom.catalog.create_table("test", t)
    return t


def _world_arrays():
    rng = np.random.default_rng(0)
    return {"big": [("a", rng.integers(0, 5000, 50_000)),
                    ("v", rng.integers(0, 100, 50_000))],
            "mid": [("a", np.arange(5000)),
                    ("b", rng.integers(0, 8, 5000))],
            "tiny": [("b", np.arange(8)), ("w", np.arange(8) * 10)]}


def _fanout_arrays():
    rng = np.random.default_rng(0)
    return {"probe": [("k", rng.integers(0, 1000, 100_000)),
                      ("v", rng.integers(0, 50, 100_000))],
            "dim": [("k", np.repeat(np.arange(1000), 5)),
                    ("w", rng.integers(0, 9, 5000))]}


def _build(pkg, arrays):
    """A session over ``arrays``'s tables, each analyzed."""
    s = _session(pkg)
    dom = s.domain
    for name, cols in arrays.items():
        dom.stats.analyze_table(_mk(pkg, dom, name, cols))
    return s


def _inl_world(pkg):
    """tests/test_cascades.py's KV-backed fact (indexed on k) and probe."""
    s = _session(pkg)
    s.execute("create table fact (k bigint, v bigint, key ix_k (k))")
    s.execute("create table probe (k bigint)")
    s.execute("insert into fact values " + ",".join(
        f"({i % 500}, {i})" for i in range(5000)))
    s.execute("insert into probe values " + ",".join(
        f"({i})" for i in range(20)))
    for t in ("fact", "probe"):
        s.domain.stats.analyze_table(s.domain.catalog.get_table("test", t))
    return s


def _worlds(kind):
    if kind == "inl":
        return _inl_world(JAX), _inl_world(PORT)
    arrays = _world_arrays() if kind == "world" else _fanout_arrays()
    return _build(JAX, arrays), _build(PORT, arrays)


def _optimized(pkg, s, sql):
    built = pkg["build_query"](pkg["parse_one"](sql), s.domain.catalog,
                               "test")
    return pkg["optimize_plan"](built.plan)


def _searched(pkg, s, sql):
    return pkg["search"](_optimized(pkg, s, sql), s.domain.stats)


def _methods(pkg, plan):
    return [getattr(n, "hint_method", "") for n in pkg["walk"](plan)
            if type(n).__name__ == "LogicalJoin"]


# (world, statement): the statements tests/test_cascades.py searches
SEARCHED = {
    "dp join order": ("world", "select count(*) from big, mid, tiny "
                               "where big.a = mid.a and mid.b = tiny.b "
                               "and tiny.w < 30"),
    "group by join": ("world", "select tiny.w, count(*) c from big join mid "
                               "on big.a = mid.a join tiny on mid.b = tiny.b "
                               "group by tiny.w order by tiny.w"),
    "topn left join": ("world", "select big.v from big left join mid on "
                                "big.a = mid.a order by big.v limit 5"),
    "filtered join": ("world", "select mid.b, sum(big.v) from big, mid where "
                               "big.a = mid.a and big.v < 50 group by mid.b "
                               "order by mid.b"),
    "merge join": ("fanout", "select probe.k, dim.w from probe join dim on "
                             "probe.k = dim.k order by probe.k"),
    "inl join": ("inl", "select probe.k, fact.v from probe join fact "
                        "on probe.k = fact.k"),
}


@pytest.fixture(scope="module")
def worlds():
    """One (JAX, port) session pair a world, shared by the module."""
    return {k: _worlds(k) for k in ("world", "fanout", "inl")}


@pytest.mark.parametrize("case", sorted(SEARCHED))
def test_search_plans_equal(worlds, case):
    """``search`` on the same optimized plan extracts the same tree in
    both packages: the same ``explain_logical`` text and join methods."""
    kind, sql = SEARCHED[case]
    js, ps = worlds[kind]
    want, got = _searched(JAX, js, sql), _searched(PORT, ps, sql)
    assert explain_logical(got) == j_explain(want), case
    assert _methods(PORT, got) == _methods(JAX, want)


@pytest.mark.parametrize("case", sorted(SEARCHED))
def test_memo_groups_equal(worlds, case):
    """The memo of each statement has as many groups in both packages,
    and inserting the same tree twice adds none (dedup)."""
    kind, sql = SEARCHED[case]
    counts = []
    for pkg, s in zip((JAX, PORT), worlds[kind]):
        plan = _optimized(pkg, s, sql)
        memo = pkg["Memo"]()
        g1 = memo.insert_tree(plan, s.domain.stats)
        n = len(memo.groups)
        g2 = memo.insert_tree(plan, s.domain.stats)
        assert g1 == g2 and len(memo.groups) == n
        counts.append(n)
    assert counts[0] == counts[1], counts


def test_dp_join_order_starts_from_filtered_tiny(worlds):
    """DP builds (mid ⋈ σ(tiny)) first and probes with big on top."""
    _kind, sql = SEARCHED["dp join order"]
    txt = explain_logical(_searched(PORT, worlds["world"][1], sql))
    depth = {}
    for line in txt.splitlines():
        ind = len(line) - len(line.lstrip())
        for t in ("big", "tiny"):
            if t in line and t not in depth:
                depth[t] = ind
    assert depth["tiny"] > depth["big"], txt


def test_merge_join_wins_on_fanout_with_order(worlds):
    """The fan-out join under ORDER BY its key takes the merge method,
    which provides the order: the extracted plan has no Sort."""
    _kind, sql = SEARCHED["merge join"]
    out = _searched(PORT, worlds["fanout"][1], sql)
    txt = explain_logical(out)
    assert "LogicalSort" not in txt, txt
    assert {n.table.name for n in walk_plan(out)
            if isinstance(n, DataSource)} == {"probe", "dim"}, txt
    joins = [n for n in walk_plan(out) if isinstance(n, LogicalJoin)]
    assert joins and joins[0].hint_method == "merge", txt


def test_inl_join_chosen_for_small_outer_indexed_inner(worlds):
    _kind, sql = SEARCHED["inl join"]
    out = _searched(PORT, worlds["inl"][1], sql)
    joins = [n for n in walk_plan(out) if isinstance(n, LogicalJoin)]
    assert joins and joins[0].hint_method == "inl", explain_logical(out)


def test_topn_pushes_through_left_join(worlds):
    _kind, sql = SEARCHED["topn left join"]
    out = _searched(PORT, worlds["world"][1], sql)
    join = next(n for n in walk_plan(out) if isinstance(n, LogicalJoin))
    assert [n for n in walk_plan(join) if isinstance(n, LogicalTopN)], \
        explain_logical(out)


# (world, statement, sort the rows): the statements run through the
# session with the flag on
SESSION_SQL = {
    "dp join order": ("world", SEARCHED["dp join order"][1], False),
    "group by join": ("world", SEARCHED["group by join"][1], False),
    "topn left join": ("world", "select big.v from big left join mid on "
                                "big.a = mid.a order by big.v limit 7",
                       False),
    "filtered join": ("world", SEARCHED["filtered join"][1], False),
    "merge join": ("fanout", SEARCHED["merge join"][1]
                   + " , dim.w limit 50", False),
    "inl join": ("inl", SEARCHED["inl join"][1], True),
    "hash hint": ("fanout", "select /*+ HASH_JOIN(dim) */ probe.k, dim.w "
                            "from probe join dim on probe.k = dim.k "
                            "order by probe.k limit 10", False),
    "merge hint": ("world", "select /*+ MERGE_JOIN(mid) */ count(*) from "
                            "big, mid where big.a = mid.a", False),
}


@pytest.mark.parametrize("case", sorted(SESSION_SQL))
def test_session_results_equal(worlds, case):
    """With ``tidb_enable_cascades_planner`` on, the port's rows equal
    the JAX session's with it on and the port's heuristic plan's."""
    kind, sql, unordered = SESSION_SQL[case]
    js, ps = worlds[kind]
    heuristic = Session(ps.domain).must_query(sql)
    jsc, psc = jax_session(js.domain), Session(ps.domain)
    for s in (jsc, psc):
        s.execute("set tidb_enable_cascades_planner=1")
    want, got = jsc.must_query(sql), psc.must_query(sql)
    norm = sorted if unordered else list
    assert norm(got) == norm(want), case
    assert norm(got) == norm(heuristic), case


@pytest.mark.parametrize("hint,absent,present", [
    ("HASH_JOIN(dim)", "MergeJoin", None),
    ("MERGE_JOIN(dim)", None, "MergeJoin"),
])
def test_hints_survive_cascades(worlds, hint, absent, present):
    """A user's join-method hint wins over the search's choice, and the
    EXPLAIN's operator lines equal the JAX session's."""
    js, ps = worlds["fanout"]
    sql = (f"select /*+ {hint} */ probe.k, dim.w from probe join dim on "
           "probe.k = dim.k order by probe.k limit 10")
    plans = []
    for s in (jax_session(js.domain), Session(ps.domain)):
        s.execute("set tidb_enable_cascades_planner=1")
        plans.append("\n".join(r[0] for r in s.must_query("explain " + sql)))
    got = plans[1]
    if absent:
        assert absent not in got, got
    if present:
        assert present in got, got
    # the operator lines (the analysis footers price by each package's
    # device count and correction store)
    names = [[ln.split("[")[0].split("(")[0].strip()
              for ln in p.splitlines() if ln.lstrip()[:1].isupper()
              and ":" not in ln.split("[")[0]] for p in plans]
    assert names[1] == names[0], plans


def test_plan_cache_keys_on_cascades_flag(worlds):
    """Flipping the flag misses the heuristic plan's cache entry and
    gives the same rows."""
    _js, ps = worlds["world"]
    s = Session(ps.domain)
    q = "select count(*) from big, mid where big.a = mid.a"
    assert "tidb_enable_cascades_planner" in _PLAN_SYSVARS
    first = s.must_query(q)
    cache = ps.domain.plan_cache
    misses = cache.misses
    s.must_query(q)
    assert cache.misses == misses
    s.execute("set tidb_enable_cascades_planner=1")
    assert s.must_query(q) == first
    assert cache.misses == misses + 1
