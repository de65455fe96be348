"""All 22 TPC-H statements through the port's session against the JAX
session and sqlite.

The tables are ``tests/test_tpch_diff.py``'s (its ``_gen`` data at its
scale, about 1,800 lineitem rows), loaded into each engine by its own
``CREATE TABLE`` and ``INSERT`` statements; the port's domain runs on 8
logical CPU devices.  Each statement's rows equal sqlite's and the JAX
session's under ``test_sqlite_diff.rows_equal`` (floats within a
relative 1e-9: each engine sums in its own order), and Q15 runs through
its view.  The JAX session is built as ``tests/test_torch_dml.py``
builds it (its scheduler and auto-analyze off).

Then ``testing/tpch.gen_tpch``, the generator of the card's TPC-H
phase, is checked at SF=0.001: the specification's key relations hold,
and Q9's join is not empty.
"""

import sqlite3

import numpy as np
import pytest

import test_tpch_diff as T
from test_sqlite_diff import rows_equal
from test_torch_dml import jax_domain, jax_session
from tidb_tpu_torch.session import Domain, Session
from tidb_tpu_torch.testing import tpch


def test_the_port_carries_the_test_files_statements():
    assert tpch.TPCH_22 == T.Q
    assert tpch.TPCH_Q15_VIEW == T.Q15_VIEW and tpch.TPCH_Q15 == T.Q15
    assert tpch.TPCH_TABLE_DDL == T.DDL


@pytest.fixture(scope="module")
def engines():
    data = T._gen()
    ps = Session(Domain("cpu", 8))
    js = jax_session(jax_domain())
    lite = sqlite3.connect(":memory:")
    lite.create_function("year", 1, lambda d: None if d is None
                         else int(str(d)[:4]))
    for tbl, ddl in T.DDL.items():
        rows = data[tbl]
        for s in (ps, js):
            s.execute(f"create table {tbl} {ddl}")
            for lo in range(0, len(rows), 200):
                s.execute(f"insert into {tbl} values " + ",".join(
                    "(" + ",".join(T._lit(v) for v in r) + ")"
                    for r in rows[lo:lo + 200]))
        lite.execute(f"create table {tbl} {ddl}")
        lite.executemany(
            f"insert into {tbl} values ({','.join('?' * len(rows[0]))})",
            rows)
    lite.commit()
    return ps, js, lite


@pytest.mark.parametrize("qn", sorted(tpch.TPCH_22))
def test_tpch_query_equals_sqlite_and_jax(engines, qn):
    ps, js, lite = engines
    sql = tpch.TPCH_22[qn]
    got = ps.must_query(sql)
    exp = lite.execute(sql).fetchall()
    assert rows_equal(got, exp), (
        f"\nTPC-H Q{qn}\nport ({len(got)}): {got[:8]}\n"
        f"sqlite ({len(exp)}): {exp[:8]}")
    assert rows_equal(got, js.must_query(sql))


def test_tpch_q15_view_equals_sqlite_and_jax(engines):
    ps, js, lite = engines
    for e in (ps, js, lite):
        e.execute(tpch.TPCH_Q15_VIEW)
    try:
        got = ps.must_query(tpch.TPCH_Q15)
        assert got, "Q15 selected no supplier"
        assert rows_equal(got, lite.execute(tpch.TPCH_Q15).fetchall())
        assert rows_equal(got, js.must_query(tpch.TPCH_Q15))
    finally:
        for e in (ps, js, lite):
            e.execute("drop view revenue0")


def test_year_and_the_view_run_on_the_device_path(engines):
    """Q8's and Q9's ``year(o_orderdate)`` sits in a cop task, and Q15's
    view expands into one: no host projection evaluates it."""
    ps, _js, _lite = engines
    for qn in (8, 9):
        assert "year" in tpch.pushed_ops(ps, tpch.TPCH_22[qn]), qn
    ps.execute(tpch.TPCH_Q15_VIEW)
    try:
        plan = "\n".join(r[0] for r in ps.execute(
            "explain " + tpch.TPCH_Q15).rows)
    finally:
        ps.execute("drop view revenue0")
    assert "CopTask" in plan, plan


# ------------------------------------------------------------------ #
# the generator of the card's phase
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def gen():
    return {t: dict(zip(names, cols))
            for t, (names, cols) in tpch.gen_tpch(0.001, seed=3).items()}


def _text(col):
    return np.asarray(col.dictionary.values, dtype=object)[col.data]


def test_gen_tpch_has_every_ddl_column(gen):
    for t, ddl in tpch.TPCH_TABLE_DDL.items():
        names = [c.strip().split()[0] for c in ddl.strip("()").split(",")]
        assert list(gen[t]) == names, t


def test_gen_tpch_key_relations(gen):
    ps, li, o = gen["partsupp"], gen["lineitem"], gen["orders"]
    n_part, n_supp = len(gen["part"]["p_partkey"].data), \
        len(gen["supplier"]["s_suppkey"].data)
    # four distinct suppliers a part
    pairs = set(zip(ps["ps_partkey"].data.tolist(),
                    ps["ps_suppkey"].data.tolist()))
    assert len(pairs) == 4 * n_part == len(ps["ps_partkey"].data)
    assert ps["ps_suppkey"].data.min() >= 1 \
        and ps["ps_suppkey"].data.max() <= n_supp
    # a line's supplier is one of its part's four
    assert set(zip(li["l_partkey"].data.tolist(),
                   li["l_suppkey"].data.tolist())) <= pairs
    # every line's order exists, and 1-7 lines an order
    okeys = o["o_orderkey"].data
    assert np.isin(li["l_orderkey"].data, okeys).all()
    per = np.unique(li["l_orderkey"].data, return_counts=True)[1]
    assert per.min() >= 1 and per.max() <= 7
    assert len(np.unique(li["l_orderkey"].data)) == len(okeys)
    # dates: ship and commit after the order date, receipt after ship
    odate = dict(zip(okeys.tolist(), o["o_orderdate"].data.tolist()))
    od = np.asarray([odate[k] for k in li["l_orderkey"].data.tolist()])
    assert (li["l_shipdate"].data > od).all()
    assert (li["l_commitdate"].data > od).all()
    assert (li["l_receiptdate"].data > li["l_shipdate"].data).all()
    # customers with a key divisible by 3 place no order
    assert (o["o_custkey"].data % 3 != 0).all()
    # an order's status from its lines' status
    ls = _text(li["l_linestatus"])
    st = dict(zip(okeys.tolist(), _text(o["o_orderstatus"]).tolist()))
    for k in okeys[:200].tolist():
        s = set(ls[li["l_orderkey"].data == k].tolist())
        assert st[k] == ("F" if s == {"F"} else "O" if s == {"O"} else "P")
    # p_name is five of the spec's colour words
    for name in _text(gen["part"]["p_name"])[:50]:
        words = name.split()
        assert len(words) == 5 and set(words) <= set(tpch.COLORS)


def test_gen_tpch_q9_join_is_not_empty():
    s = tpch.sql_session(tpch.gen_tpch(0.001, seed=3), device="cpu",
                         n_devices=8)
    rows = s.must_query(tpch.TPCH_22[9])
    assert rows and all(r[2] is not None for r in rows)


def _jax_session_over(data):
    """A JAX session over ``gen_tpch``'s tables, registered as columns
    (as the port's ``sql_session`` registers them), no ANALYZE."""
    from tidb_tpu.chunk.column import Column as JColumn
    from tidb_tpu.chunk.column import StringDict as JDict
    from tidb_tpu.session.catalog import TableInfo as JTable
    from tidb_tpu.types import dtypes as jdt
    jd = jax_domain()
    for name, (names, cols) in data.items():
        jcols = [JColumn(jdt.DataType(jdt.TypeKind[c.dtype.kind.name],
                                      c.dtype.nullable, c.dtype.prec,
                                      c.dtype.scale),
                         c.data, c.validity,
                         None if c.dictionary is None
                         else JDict(c.dictionary.values)) for c in cols]
        t = JTable(name, list(names), [c.dtype for c in jcols])
        t.register_columns(jcols)
        jd.catalog.create_table("test", t)
    return jax_session(jd)


@pytest.mark.parametrize("sf,qn", [(0.001, 11), (0.01, 7)])
def test_join_fallbacks_are_the_jax_plans_branches(sf, qn, monkeypatch):
    """A broadcast join whose build side turns out empty or keyed with
    duplicates runs its host plan, in both packages (the JAX package's
    ``_prep_build_groups`` giving None, or ``_empty_build_result``): the
    port's ``join_fallbacks`` count equals the JAX package's branches
    taken, and the rows are equal (gen_tpch data: Q11 at SF=0.001, no
    supplier in GERMANY; Q7 at SF=0.01, customer probed against the
    orders chain keyed by o_custkey)."""
    import tidb_tpu.executor.physical as jphys
    data = tpch.gen_tpch(sf, seed=0)
    ps = tpch.sql_session(data, device="cpu", n_devices=8)
    js = _jax_session_over(data)
    taken = []
    prep, empty = jphys._prep_build_groups, \
        jphys.CopJoinTaskExec._empty_build_result

    def counted_prep(*a, **k):
        out = prep(*a, **k)
        taken.extend([1] if out is None else [])
        return out

    def counted_empty(self, *a, **k):
        taken.append(1)
        return empty(self, *a, **k)
    monkeypatch.setattr(jphys, "_prep_build_groups", counted_prep)
    monkeypatch.setattr(jphys.CopJoinTaskExec, "_empty_build_result",
                        counted_empty)
    want = js.must_query(tpch.TPCH_22[qn])
    got = ps.must_query(tpch.TPCH_22[qn])
    assert rows_equal(got, want)
    assert ps.domain.client.join_fallbacks == len(taken) > 0
