"""SQL text through the port's session against the JAX package's.

Both packages' sessions get the same columns: lineitem from
``gen_lineitem(sf=0.001, seed=42)`` and a small table ``t`` with NULLs
in a dict-coded key, a decimal and a double column.  The JAX session
runs with auto-analyze off (``tidb_enable_auto_analyze = 0`` and its
statistics handle's background load off) and its client's admission
scheduler bypassed (``sched_enable``); the port's runs on
``device="cpu"`` with ``n_devices=8``, the JAX tests' mesh.  The port
has no statistics yet, so this is the one configuration in which the
two plan alike: with statistics the JAX package may plan a high-NDV
group-by as SEGMENT where the port plans SORT.

For every statement of the port's SQL path
(``tidb_tpu_torch.testing.tpch.SQL_QUERIES``, and the statements over
``t``): the result names are equal, the rows are equal (integers,
decimals, strings and dates exactly; floats within ``FLOAT_RTOL``), the
EXPLAIN trees are equal apart from the device the cop task names, and
the port ran the statement through its device path: the aggregations
through ``group_reduce_lanes``, the sorts through ``stable_argsort``.
The parser's ASTs are equal for every statement of the JAX package's
corpora and the 22 TPC-H texts of tests/test_tpch_diff.py.
"""

import dataclasses

import numpy as np
import pytest

from tidb_tpu.chunk.column import Column as JColumn
from tidb_tpu.chunk.column import StringDict as JDict
from tidb_tpu.session import Domain as JDomain
from tidb_tpu.session import Session as JSession
from tidb_tpu.session.catalog import TableInfo as JTable
from tidb_tpu.sql.parser import parse_sql as j_parse_sql
from tidb_tpu.testing import tpch as jtpch
from tidb_tpu.types import dtypes as jdt
from tidb_tpu_torch.chunk.column import Column, StringDict
from tidb_tpu_torch.copr import exec as port_exec
from tidb_tpu_torch.copr import segment as port_segment
from tidb_tpu_torch.sql.parser import parse_sql
from tidb_tpu_torch.testing import tpch
from tidb_tpu_torch.types import dtypes as dt

from test_tpch_diff import Q as TPCH_TEXTS

SF = 0.001
SEED = 42
FLOAT_RTOL = 1e-9     # float SUM/AVG: the two sum in different orders

# statements over t: a nullable dict-coded key k, an int g, a nullable
# DECIMAL(12,2) d and a nullable DOUBLE f
T_QUERIES = {
    "t DENSE": """select k, count(*), count(d), sum(d), avg(d), min(d),
                         max(d), sum(f), avg(f)
                  from t group by k order by k""",
    "t SORT": """select k, g, count(*), sum(d), max(f) from t
                 group by k, g order by k, g""",
    "t SCALAR": """select count(*), sum(d), sum(f), min(f)
                   from t where k is null or d > 10""",
    "t TopN": "select k, g, d from t order by d desc, g limit 7",
}
# other SELECT shapes over lineitem: an uncorrelated scalar subquery
# folded at plan time, INTERVAL months, a host aggregate over the rows,
# ORDER BY a position with LIMIT over a dense aggregate
MORE_QUERIES = {
    "scalar subquery": """select count(*), sum(l_quantity) from lineitem
                          where l_quantity > (select avg(l_quantity)
                                              from lineitem)""",
    "interval month": """select l_shipmode, count(*) from lineitem
                         where l_shipdate >= date '1995-01-01'
                                             + interval '3' month
                         group by l_shipmode order by l_shipmode""",
    "count distinct": "select count(distinct l_suppkey) from lineitem",
    "order by position": """select l_returnflag, sum(l_quantity)
                            from lineitem group by l_returnflag
                            order by 2 desc limit 2""",
}
QUERIES = {**tpch.SQL_QUERIES, **T_QUERIES, **MORE_QUERIES}

# the device functions each statement's cop task must have run
KERNELS = {"Q1": {"group_reduce_lanes"}, "Q6": {"group_reduce_lanes"},
           "Q6 corpus": {"group_reduce_lanes"},
           "Q1 corpus": {"group_reduce_lanes"},
           "SORT": {"group_reduce_lanes", "stable_argsort"},
           "SORT two keys": {"group_reduce_lanes", "stable_argsort"},
           "SORT two keys filtered": {"group_reduce_lanes",
                                      "stable_argsort"},
           "TopN": {"stable_argsort"}, "Limit": set(), "rows": set(),
           "HAVING": {"group_reduce_lanes"},
           "t DENSE": {"group_reduce_lanes"},
           "t SORT": {"group_reduce_lanes", "stable_argsort"},
           "t SCALAR": {"group_reduce_lanes"}, "t TopN": {"stable_argsort"},
           "scalar subquery": {"group_reduce_lanes"},
           "interval month": {"group_reduce_lanes"},
           "count distinct": set(),
           "order by position": {"group_reduce_lanes"}}


def _t_columns(n=400, seed=5):
    """numpy columns of t: k has NULLs and codes into a 4-word dict."""
    rng = np.random.default_rng(seed)
    words = ["ash", "birch", "elm", "oak"]
    k = rng.integers(0, len(words), n).astype(np.int32)
    kv = rng.random(n) > 0.15
    g = rng.integers(0, 9, n)
    d = rng.integers(-5_000, 50_000, n)
    dv = rng.random(n) > 0.1
    f = rng.normal(0.0, 1e3, n)
    fv = rng.random(n) > 0.2
    return [("k", "varchar", k, kv, words), ("g", "bigint", g, None, None),
            ("d", "decimal", d, dv, None), ("f", "double", f, fv, None)]


def _t_table(col_cls, dict_cls, types):
    specs = _t_columns()
    cols = []
    for _name, kind, data, valid, words in specs:
        ty = {"varchar": types.varchar(True), "bigint": types.bigint(False),
              "decimal": types.decimal(12, 2, True),
              "double": types.double(True)}[kind]
        cols.append(col_cls.from_numpy(
            ty, data, valid, dict_cls(words) if words else None))
    return [s[0] for s in specs], cols


@pytest.fixture(scope="module")
def sessions():
    jd = JDomain()
    jd.client.sched_enable = False       # no scheduler daemon threads
    jd.stats.auto_analyze_enabled = False     # no background ANALYZE
    for name, (names, cols) in (
            ("lineitem", jtpch.gen_lineitem(sf=SF, seed=SEED)),
            ("t", _t_table(JColumn, JDict, jdt))):
        t = JTable(name, list(names), [c.dtype for c in cols])
        t.register_columns(list(cols))
        jd.catalog.create_table("test", t)
    js = JSession(jd)
    js.execute("set tidb_enable_auto_analyze = 0")
    ps = tpch.sql_session(
        {"lineitem": tpch.gen_lineitem(SF, SEED),
         "t": _t_table(Column, StringDict, dt)}, device="cpu", n_devices=8)
    # EXPLAIN's ``cost:`` footer reads each package's process-wide
    # correction store, which only the port's scheduler feeds here: the
    # compared plans are priced by the static model in both
    for s in (js, ps):
        s.execute("set global tidb_tpu_cost_calibration = 0")
    return js, ps


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


def _jax_tree(rows) -> list:
    """The JAX package's whole EXPLAIN: the operator tree and its
    analysis footers (``contract: ok``, ``est. device bytes`` with its
    ``donate:`` part, ``transfer:``, ``cost:`` and the strategy line)."""
    return [r[0] for r in rows]


@pytest.mark.parametrize("name", list(QUERIES))
def test_sql_equals_the_jax_session(sessions, name, monkeypatch):
    js, ps = sessions
    sql = QUERIES[name]
    ran = set()

    def counting(fn, label):
        def wrapped(*a, **k):
            ran.add(label)
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(port_exec, "group_reduce_lanes", counting(
        port_exec.group_reduce_lanes, "group_reduce_lanes"))
    for mod in (port_exec, port_segment):
        monkeypatch.setattr(mod, "stable_argsort", counting(
            mod.stable_argsort, "stable_argsort"))
    want = js.execute(sql)
    got = ps.execute(sql)
    assert got.names == want.names
    _rows_equal(got.rows, want.rows)
    assert ran == KERNELS[name]
    # the cop task ran on the port's device path: placed, then the
    # device program
    assert {"place", "device"} <= set(ps.domain.client.timings)
    jtree = _jax_tree(js.execute("explain " + sql).rows)
    ptree = [r[0] for r in ps.execute("explain " + sql).rows]
    assert any("CopTask" in line for line in ptree)
    assert ptree == [line.replace("-> TPU", "-> cpu") for line in jtree]


def test_session_timings(sessions):
    _js, ps = sessions
    ps.execute(tpch.TPCH_Q6)
    assert set(ps.timings) == {"parse", "plan", "execute", "decode"}
    assert all(v >= 0 for v in ps.timings.values())


def test_sql_queries_are_the_corpus():
    """The port's copy of the corpus is the JAX package's."""
    assert tpch.TPCH_PLAN_QUERIES == jtpch.TPCH_PLAN_QUERIES


def test_session_defaults_to_the_card():
    """``Domain()`` builds its client on ``cuda``: without a GPU it
    raises, and nothing falls back to the CPU."""
    import torch
    from tidb_tpu_torch.session import Domain
    if torch.cuda.is_available():
        assert Domain().client.devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            Domain()


# ------------------------------------------------------------------ #
# the parser
# ------------------------------------------------------------------ #

def _plain(node):
    """An AST as nested tuples of class names and field values, so the
    two packages' dataclasses compare."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return (type(node).__name__,) + tuple(
            (f.name, _plain(getattr(node, f.name)))
            for f in dataclasses.fields(node))
    if isinstance(node, (list, tuple)):
        return tuple(_plain(x) for x in node)
    if isinstance(node, dict):
        return tuple(sorted((k, _plain(v)) for k, v in node.items()))
    return node


PARSE_TEXTS = {
    **{f"plan {i}": q for i, q in enumerate(jtpch.TPCH_PLAN_QUERIES)},
    **{f"shuffle {i}": q for i, q in enumerate(jtpch.TPCH_SHUFFLE_QUERIES)},
    **{f"multichip {i}": q
       for i, q in enumerate(jtpch.MULTICHIP_PLAN_QUERIES)},
    **{f"tpch Q{n}": q for n, q in TPCH_TEXTS.items()},
    "spec Q1": tpch.TPCH_Q1, "spec Q6": tpch.TPCH_Q6,
}


@pytest.mark.parametrize("name", list(PARSE_TEXTS))
def test_parser_equals_the_jax_parser(name):
    sql = PARSE_TEXTS[name]
    got, want = parse_sql(sql), j_parse_sql(sql)
    assert len(got) == len(want) >= 1
    assert _plain(got) == _plain(want)
