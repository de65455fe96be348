"""The port's window functions against the JAX package's.

(a) the statements of tests/test_window_device.py (row_number, rank and
    dense_rank DESC, whole-partition aggregates, NULL keys, the skew
    regrow, the window over a filter, string MIN/MAX and its host path,
    the DECIMAL AVG) and tests/test_fragment.py's window over a
    broadcast join, through the port's ``Session`` (8 logical CPU
    devices) and the JAX ``Session``: plans hold the same window
    operator, rows are equal;
(b) the port's ``ShardedWindowProgram`` against
    ``tidb_tpu.parallel.window.get_window_program`` over the same
    tables, with the specs each session plans: the regrow rounds of the
    client's loop, each device's ``wmax``, ``ovf``, row count and rows.

Integers, decimals, strings, ranks and masks are exactly equal.  Float
SUM and AVG agree within a relative ``FRTOL`` = 1e-12: the JAX package
reduces a float SUM by an XLA scatter-add (another order than the
port's ``group_reduce``), and XLA on the CPU turns the DECIMAL AVG's
division by ``10 ** scale`` into a product with its reciprocal, where
the port divides.
"""

import math

import jax
import numpy as np
import pytest
import torch

from tidb_tpu.parallel.mesh import get_mesh
from tidb_tpu.parallel.window import get_window_program
from tidb_tpu.session import Domain as JDomain
from tidb_tpu.session import Session as JSession
from tidb_tpu.sql.parser import parse_one as j_parse_one
from tidb_tpu_torch.executor import physical as pphys
from tidb_tpu_torch.parallel.window import ShardedWindowProgram
from tidb_tpu_torch.session import Domain, Session
from tidb_tpu_torch.sql.parser import parse_one
from tidb_tpu_torch.store.columnar import _pow2_at_least

N_DEV = 8
CPU8 = (torch.device("cpu"),) * N_DEV
FRTOL = 1e-12


def _jax_session():
    dom = JDomain()
    dom.client.sched_enable = False          # no scheduler daemon threads
    dom.stats.auto_analyze_enabled = False   # no background ANALYZE
    s = JSession(dom)
    s.execute("set tidb_enable_auto_analyze = 0")
    return s


def _setup(s) -> None:
    rng = np.random.default_rng(7)
    s.execute("create table t (g bigint, o bigint, v bigint, "
              "d decimal(10,2), f double, name varchar(10))")
    rows = []
    for i in range(2000):
        g = "NULL" if i % 97 == 0 else int(rng.integers(0, 25))
        v = "NULL" if i % 89 == 0 else int(rng.integers(-50, 50))
        rows.append(f"({g}, {int(rng.integers(0, 60))}, {v}, "
                    f"{int(rng.integers(0, 100000)) / 100:.2f}, "
                    f"{float(rng.normal() * 100)!r}, "
                    f"'{['pear', 'apple', 'fig', 'kiwi'][i % 4]}')")
    s.execute("insert into t values " + ",".join(rows))
    s.execute("create table n (g bigint, v bigint)")
    s.execute("insert into n values (1, 10), (1, NULL), (NULL, 5), "
              "(NULL, 7), (2, 3)")
    s.execute("create table sk (g bigint, v bigint)")
    s.execute("insert into sk values " +
              ",".join(f"(7, {i})" for i in range(10000)))
    s.execute("create table wf (id bigint not null, dk bigint, v bigint, "
              "primary key (id))")
    s.execute("create table wd (dk bigint not null, grp varchar(8), "
              "primary key (dk))")
    s.execute("insert into wd values " + ",".join(
        f"({k}, 'g{k % 3}')" for k in range(20)))
    s.execute("insert into wf values " + ",".join(
        f"({i}, {int(rng.integers(0, 20))}, {int(rng.integers(0, 100))})"
        for i in range(400)))


@pytest.fixture(scope="module")
def sessions():
    js, ps = _jax_session(), Session(Domain("cpu", n_devices=N_DEV))
    for s in (js, ps):
        _setup(s)
    return js, ps


# name -> (statement, the window operator both plans hold)
STMTS = {
    "row_number": ("select g, o, v, row_number() over "
                   "(partition by g order by o, v) from t", "CopWindow"),
    "rank dense_rank desc": (
        "select g, v, rank() over (partition by g order by v desc), "
        "dense_rank() over (partition by g order by v desc) from t",
        "CopWindow"),
    "whole-partition aggregates": (
        "select g, sum(v) over (partition by g), count(*) over "
        "(partition by g), count(v) over (partition by g), min(v) over "
        "(partition by g), max(v) over (partition by g), avg(v) over "
        "(partition by g) from t", "CopWindow"),
    "float and decimal aggregates": (
        "select g, sum(f) over (partition by g), avg(f) over (partition "
        "by g), min(f) over (partition by g), max(f) over (partition by "
        "g), sum(d) over (partition by g), avg(d) over (partition by g), "
        "max(d) over (partition by g) from t", "CopWindow"),
    "two partition keys": (
        "select g, o, v, rank() over (partition by g, o % 3 order by v, "
        "f desc) from t", "CopWindow"),
    "null keys": ("select g, v, row_number() over (partition by g order "
                  "by v) from n", "CopWindow"),
    "skew regrow": ("select v, row_number() over (partition by g order "
                    "by v) from sk", "CopWindow"),
    "over a filter": ("select g, v, rank() over (partition by g order by "
                      "v) from t where v >= 0", "CopWindow"),
    "string min max": ("select g, min(name) over (partition by g), "
                       "max(name) over (partition by g) from t",
                       "CopWindow"),
    "derived string": ("select g, min(upper(name)) over (partition by g) "
                       "from t", "CopWindow"),
    "ordered string min host": (
        "select g, min(name) over (partition by g order by v) from t "
        "where v <= 2", "HostWindow"),
    "global window host": ("select v, row_number() over (order by v, o) "
                           "from t where g = 3", "HostWindow"),
    "over a broadcast join": (
        "select id, grp, row_number() over (partition by grp order by "
        "v desc, id) as rn from wf join wd on wf.dk = wd.dk",
        "CopWindow"),
    "aggregate over a broadcast join": (
        "select grp, sum(v) over (partition by grp) from wf join wd on "
        "wf.dk = wd.dk", "CopWindow"),
}


def _plan(s, q) -> str:
    return "\n".join(r[0] for r in s.execute("explain " + q).rows)


def _sort_key(row):
    return tuple((1, "") if x is None else
                 (0, f"{float(x):.9e}") if isinstance(x, float)
                 else (0, repr(x)) for x in row)


def _rows_equal(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(sorted(map(tuple, got), key=_sort_key),
                    sorted(map(tuple, want), key=_sort_key)):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and b is not None:
                assert isinstance(a, float)
                assert math.isclose(a, b, rel_tol=FRTOL, abs_tol=0.0) \
                    or a == b, (g, w)
            else:
                assert a == b and type(a) is type(b), (g, w)


@pytest.fixture()
def no_fallback(monkeypatch):
    """A broadcast join's host plan fails the test."""
    def boom(ctx, fallback):
        raise AssertionError("host fallback taken")
    monkeypatch.setattr(pphys, "_join_fallback", boom)


@pytest.mark.parametrize("name", sorted(STMTS))
def test_window_statement_equals_the_reference(name, sessions, no_fallback):
    js, ps = sessions
    sql, op = STMTS[name]
    jplan, pplan = _plan(js, sql), _plan(ps, sql)
    assert op in jplan and op in pplan, (jplan, pplan)
    if op == "CopWindow":
        assert "HostWindow" not in pplan
    want = js.execute(sql)
    got = ps.execute(sql)
    assert got.names == want.names
    _rows_equal(got.rows, want.rows)
    assert ps.domain.client.join_fallbacks == 0


def test_window_null_keys_oracle(sessions):
    """NULL partition keys form one partition; NULL orders first ASC."""
    _js, ps = sessions
    got = sorted(ps.execute(STMTS["null keys"][0]).rows,
                 key=lambda r: (r[0] is None, r[0] or 0, r[1] is None,
                                r[1] or 0))
    assert got == [(1, 10, 2), (1, None, 1), (2, 3, 1), (None, 5, 1),
                   (None, 7, 2)]


def test_window_duplicate_build_keys_fall_back_counted():
    """A window over a broadcast join whose build keys repeat runs its
    host plan in both packages, counted in ``join_fallbacks``."""
    js, ps = _jax_session(), Session(Domain("cpu", n_devices=2))
    q = ("select id, grp, row_number() over (partition by grp order by "
         "id) from wf2 join wd2 on wf2.dk = wd2.dk")
    for s in (js, ps):
        s.execute("create table wf2 (id bigint not null, dk bigint, "
                  "primary key (id))")
        s.execute("create table wd2 (dk bigint, grp varchar(8))")
        s.execute("insert into wd2 values (1, 'a'), (1, 'b'), (2, 'c')")
        s.execute("insert into wf2 values (1, 1), (2, 1), (3, 2)")
    _rows_equal(ps.execute(q).rows, js.execute(q).rows)
    assert sorted(ps.execute(q).rows) == [
        (1, "a", 1), (1, "b", 1), (2, "a", 2), (2, "b", 2), (3, "c", 1)]
    assert ps.domain.client.join_fallbacks == 2


# ------------------------------------------------------------------ #
# (b) the program against get_window_program
# ------------------------------------------------------------------ #

def _window_op(phys):
    stack = [phys]
    while stack:
        op = stack.pop()
        if type(op).__name__ == "CopWindowExec":
            return op
        stack.extend(getattr(op, "children", ()) or ())
    raise AssertionError("no CopWindowExec in the plan")


def _regrow(run, cap):
    """The client's regrow loop over ``run(cap) -> (out, wmax)``: the
    capacities of its rounds, the last output and ``wmax``."""
    caps = []
    for _ in range(10):
        caps.append(cap)
        out, extras = run(cap)
        wmax = np.asarray(extras["wmax"])
        if int(wmax.max()) <= cap:
            return caps, out, extras
        cap = _pow2_at_least(int(wmax.max()))
    raise AssertionError("no convergence")


PROGRAM_STMTS = ["row_number", "rank dense_rank desc",
                 "whole-partition aggregates", "float and decimal aggregates",
                 "two partition keys", "skew regrow", "over a filter",
                 "string min max"]


# (statement, the first bucket capacity: the client's estimate, or 64 so
# that every device's buckets overflow and the program regrows)
PROGRAM_RUNS = [(n, "client") for n in PROGRAM_STMTS] + [
    ("row_number", 64), ("skew regrow", 64)]


@pytest.mark.parametrize("name,start", PROGRAM_RUNS)
def test_window_program_equals_the_reference(name, start, sessions):
    js, ps = sessions
    sql = STMTS[name][0]
    jop = _window_op(js._plan_select(j_parse_one(sql))[1])
    pop = _window_op(ps._plan_select(parse_one(sql))[1])
    assert len(pop.spec.items) == len(jop.spec.items)
    mesh = get_mesh()
    n = pop.table.snapshot().num_rows
    cap0 = _pow2_at_least(max(2 * n // (N_DEV * N_DEV) + 1, 1024)) \
        if start == "client" else start
    jc, jk = jop.table.snapshot().device_cols(mesh)
    pc, pk = pop.table.snapshot().device_cols(CPU8)
    jcaps, (jcols, jcnt), jex = _regrow(
        lambda c: [jax.device_get(x) for x in
                   get_window_program(jop.spec, mesh, c)(jc, jk, ())],
        cap0)
    pcaps, (pcols, pcnt), pex = _regrow(
        lambda c: ShardedWindowProgram(pop.spec, CPU8, c)(pc, pk, ()),
        cap0)
    assert pcaps == jcaps
    if name == "skew regrow" and start == 64:
        assert len(pcaps) > 1
    for k in ("wmax", "ovf"):
        assert np.array_equal(pex[k].numpy(), np.asarray(jex[k]).reshape(-1))
    jcnt = np.asarray(jcnt).reshape(-1)
    assert np.array_equal(pcnt.numpy(), jcnt)
    assert len(pcols) == len(jcols)
    for (pv, pm), (jv, jm) in zip(pcols, jcols):
        jv, jm = np.asarray(jv), np.asarray(jm)
        for d in range(N_DEV):
            c = int(jcnt[d])
            a, b = pv[d, :c].numpy(), jv[d, :c]
            assert np.array_equal(pm[d, :c].numpy(), jm[d, :c])
            if b.dtype.kind == "f":
                assert np.allclose(a, b, rtol=FRTOL, atol=0, equal_nan=True)
            else:
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_client_regrow_rounds_match_the_program(sessions):
    """``CopClient.execute_window`` records its rounds: the skewed table
    (every row one partition, so each device sends all its rows to one
    bucket) regrows once from the uniform-hash estimate."""
    _js, ps = sessions
    rows = ps.execute(STMTS["skew regrow"][0]).rows
    assert sorted(rows) == [(i, i + 1) for i in range(10000)]
    caps = ps.domain.client.timings["windows"]
    assert len(caps) == 2 and caps[1] > caps[0] == 1024
