"""The port's device evaluator lane by lane against the JAX package's.

Every op of the port's ``DEVICE_OPS`` (the ops the planner pushes into
a cop task) is evaluated over the same seeded numpy columns by
``tidb_tpu.expr.compile.Evaluator(jnp)`` and by
``tidb_tpu_torch.expr.compile.Evaluator("cpu")``.  The columns hold
NULLs, int8/16/32 physical widths of BIGINT, DECIMAL and DATE values,
negatives, zero divisors, the int64 edges, dates before 1970 and leap
days, datetimes, and BIGINT UNSIGNED values past 2^63.

Integer, decimal, date and boolean results, and every validity mask,
must be equal bit for bit, over every lane (a NULL lane included).
Doubles must agree within ``MAX_ULP`` units in the last place: XLA's
and torch's transcendentals may round differently in the last bits.
Then a few DAGs with these lanes in a Selection and in aggregate
arguments are held against ``tidb_tpu.parallel.spmd.
get_sharded_program``, and SQL statements of the JAX package's cast and
builtin test files whose lanes push down run through both sessions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.expr import builders as jb
from tidb_tpu.expr import ir as jir
from tidb_tpu.expr.compile import Evaluator as JEvaluator
from tidb_tpu.types import dtypes as jdt
from tidb_tpu_torch.executor.physical import DEVICE_OPS
from tidb_tpu_torch.expr import builders as b
from tidb_tpu_torch.expr import ir
from tidb_tpu_torch.expr.compile import Evaluator
from tidb_tpu_torch.testing.tpch import pushed_ops
from tidb_tpu_torch.types import dtypes as dt

from test_torch_dml import both, pair, run_script
from torch_lane_cases import CASES, DATA, N, NAMES, F, _P, col, lit

# doubles: XLA's and torch's libm may differ in the last bits
MAX_ULP = 4
# XLA on the CPU flushes subnormal results to zero; torch keeps them
TINY = np.finfo(np.float64).tiny


class _J:
    b, dt, Func, Const, Ref = jb, jdt, jir.Func, jir.Const, jir.ColumnRef
    jax = True      # its BIGINT UNSIGNED literals ride as np.uint64


def _ops(e):
    out = set()
    stack = [e]
    while stack:
        x = stack.pop()
        if isinstance(x, ir.Func):
            out.add(x.op)
            stack.extend(x.args)
    return out


def _inputs():
    jcols, tcols = [], []
    for name in NAMES:
        _t, data, valid = DATA[name]
        jcols.append((jnp.asarray(data), True if valid is None
                      else jnp.asarray(valid)))
        tcols.append((torch.from_numpy(data.copy()), True if valid is None
                      else torch.from_numpy(valid.copy())))
    return jcols, tcols


J_COLS, T_COLS = _inputs()


def _np(v, like_n=N):
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.uint64:
            v = v.view(torch.int64)
        v = v.numpy()
    v = np.asarray(v)
    if v.dtype == np.uint64:
        v = v.view(np.int64)
    return np.broadcast_to(v, (like_n,))


def _mask(m):
    if m is True or m is False:
        return np.full(N, m)
    return _np(m).astype(bool)


def assert_same(jpair, tpair, what=""):
    """Bit-equal masks and integer/bool values; doubles within MAX_ULP."""
    jv, jm = jpair
    tv, tm = tpair
    assert (_mask(jm) == _mask(tm)).all(), f"{what}: validity differs"
    a, t = _np(jv), _np(tv)
    if a.dtype.kind == "f" or t.dtype.kind == "f":
        assert a.dtype.kind == "f" and t.dtype.kind == "f", \
            f"{what}: {a.dtype} against {t.dtype}"
        a, t = a.astype(np.float64), t.astype(np.float64)
        a = np.where(np.abs(a) < TINY, 0.0, a)
        t = np.where(np.abs(t) < TINY, 0.0, t)
        same = (a == t) | (np.isnan(a) & np.isnan(t))
        fin = np.isfinite(a) & np.isfinite(t)
        a0, t0 = np.where(fin, a, 0.0), np.where(fin, t, 0.0)
        tol = MAX_ULP * np.spacing(np.maximum(np.abs(a0), np.abs(t0)))
        ok = same | (fin & (np.abs(a0 - t0) <= tol))
        bad = np.flatnonzero(~ok)
        assert not len(bad), \
            f"{what}: {len(bad)} lanes past {MAX_ULP} ulp, first " \
            f"{a[bad[0]]!r} against {t[bad[0]]!r}"
        return
    assert (a.dtype == bool) == (t.dtype == bool), \
        f"{what}: {a.dtype} against {t.dtype}"
    bad = np.flatnonzero(a.astype(np.int64) != t.astype(np.int64))
    assert not len(bad), \
        f"{what}: {len(bad)} lanes differ, first lane {bad[0]}: " \
        f"{a[bad[0]]!r} against {t[bad[0]]!r}"


# decimal division by a BIGINT UNSIGNED column: the JAX package's lanes
# (device and host alike) divide an int64 by a uint64, which jnp and
# numpy promote to float64; the port divides exactly in integers
_JAX_FLOAT_DIV = ("div(i,u)", "div(u,w)")


@pytest.mark.parametrize("name", sorted(set(CASES) - set(_JAX_FLOAT_DIV)))
def test_lane_matches_the_jax_evaluator(name):
    build = CASES[name]
    je, te = build(_J), build(_P)
    want = JEvaluator(jnp).eval(je, J_COLS)
    got = Evaluator("cpu").eval(te, T_COLS)
    assert_same(jax.device_get(want), got, name)


def test_every_device_op_has_a_lane_and_a_case():
    """DEVICE_OPS is what the planner pushes down: each op needs a lane
    in the port's Evaluator and a parity case above."""
    lacking = sorted(op for op in DEVICE_OPS
                     if not callable(getattr(Evaluator, f"op_{op}", None)))
    assert not lacking, f"ops without a port lane: {lacking}"
    covered = set()
    for build in CASES.values():
        covered |= _ops(build(_P))
    assert not sorted(DEVICE_OPS - covered), \
        f"ops without a parity case: {sorted(DEVICE_OPS - covered)}"
    from tidb_tpu.executor.physical import DEVICE_OPS as J_OPS
    assert set(DEVICE_OPS) == set(J_OPS)


@pytest.mark.parametrize("name", _JAX_FLOAT_DIV)
def test_decimal_division_by_unsigned_is_exact(name):
    """The port's decimal ``/`` by a BIGINT UNSIGNED column rounds the
    exact quotient half away from zero; the JAX lane's result is float64
    (ROADMAP.md, Queue 3 item 4)."""
    x, y = name[4:-1].split(",")
    want = JEvaluator(jnp).eval(CASES[name](_J), J_COLS)[0]
    assert np.asarray(want).dtype == np.float64
    e = CASES[name](_P)
    v, m = Evaluator("cpu").eval(e, T_COLS)
    k = e.dtype.scale         # neither operand is a DECIMAL
    got = _np(v)
    valid = _mask(m)
    for r in np.flatnonzero(valid)[:500]:
        a = int(DATA[x][1][r]) * 10 ** k
        d = int(DATA[y][1][r])
        a = (a + 2 ** 63) % 2 ** 64 - 2 ** 63     # the int64 pre-scale wraps
        q = (abs(a) + d // 2) // d
        q = -q if a < 0 else q
        assert got[r] == (q + 2 ** 63) % 2 ** 64 - 2 ** 63, (r, a, d)


def test_string_greatest_needs_merged_codes():
    """GREATEST over dictionary codes with no merged dictionary raises in
    both packages, never compares codes of two dictionaries."""
    for P, Ev, cols in ((_J, lambda: JEvaluator(jnp), J_COLS),
                        (_P, lambda: Evaluator("cpu"), T_COLS)):
        e = P.b.greatest_least("greatest", [col(P, "code"), col(P, "code")])
        with pytest.raises(NotImplementedError, match="dictionary"):
            Ev().eval(e, cols)


def test_unsigned_division_is_exact():
    """``_udiv`` against python's exact unsigned quotient, divisors with
    the top bit set and clear, dividends past 2^63."""
    from tidb_tpu_torch.expr.compile import _udiv
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2 ** 64 - 1, 20000, dtype=np.uint64, endpoint=True)
    bb = np.concatenate([
        rng.integers(1, 2 ** 64 - 1, 10000, dtype=np.uint64, endpoint=True),
        rng.integers(1, 1000, 10000).astype(np.uint64)])
    got = _udiv(torch.from_numpy(a.view(np.int64)),
                torch.from_numpy(bb.view(np.int64))).numpy().view(np.uint64)
    want = np.array([int(x) // int(y) for x, y in zip(a, bb)], np.uint64)
    assert (got == want).all()


@pytest.mark.parametrize("op", ["lt", "ge", "eq"])
def test_wide_decimal_comparand_is_exact(op):
    """A comparand rescaled past int64 (a DECIMAL(18,0) literal of 18
    digits against a scale-2 column) orders above every row, as exact
    python integers give it (the JAX package's host lane compares object
    ints the same way)."""
    big = 9 * 10 ** 17
    e = b.compare(op, col(_P, "d2"), b.lit(big, dt.decimal(18, 0, False)))
    v, m = Evaluator("cpu").eval(e, T_COLS)
    d2 = DATA["d2"][1]
    want = {"lt": lambda x: x < big * 100, "ge": lambda x: x >= big * 100,
            "eq": lambda x: x == big * 100}[op](d2.astype(object))
    assert (_np(v) == want.astype(bool)).all()
    # the JAX device lane multiplies the two python ints in jnp, which
    # wraps the rescaled literal to int64 (ROADMAP.md, Queue 3 item 4)
    je = jb.compare(op, col(_J, "d2"), jb.lit(big, jdt.decimal(18, 0, False)))
    jv = np.broadcast_to(np.asarray(JEvaluator(jnp).eval(je, J_COLS)[0]), N)
    wrapped = (big * 100 + 2 ** 63) % 2 ** 64 - 2 ** 63
    jwant = {"lt": lambda x: x < wrapped, "ge": lambda x: x >= wrapped,
             "eq": lambda x: x == wrapped}[op](d2)
    assert (jv == jwant).all()


# ------------------------------------------------------------------ #
# the lanes inside device programs
# ------------------------------------------------------------------ #

DAG_COLS = ["i", "j", "n8", "d2", "d4", "f", "u", "w", "day", "d16", "ts"]
N_DEV = 8
CPU8 = (torch.device("cpu"),) * N_DEV
FLOAT_RTOL = 1e-12


def _dag_snaps():
    """The DAG columns as both packages' snapshots (the scans narrow the
    integer columns to their physical widths again)."""
    from tidb_tpu.chunk.column import Column as JColumn
    from tidb_tpu.store import snapshot_from_columns as j_snapshot
    from tidb_tpu_torch.store import snapshot_from_numpy
    jcols, specs = [], []
    for name in DAG_COLS:
        tmake, data, valid = DATA[name]
        t = tmake(_P)
        data = np.asarray(data).astype(
            np.uint64 if t.kind.name == "UINT64" else
            np.float64 if t.kind.name == "FLOAT64" else np.int64)
        jt = tmake(_J)
        jcols.append(JColumn.from_numpy(jt, data, valid))
        specs.append({"kind": t.kind.name, "nullable": t.nullable,
                      "prec": t.prec, "scale": t.scale, "data": data,
                      "validity": valid})
    return j_snapshot(DAG_COLS, jcols), snapshot_from_numpy(DAG_COLS, specs)


def _dcol(P, name):
    return P.Ref(DATA[name][0](P), DAG_COLS.index(name), name)


def _dag(P, which):
    from tidb_tpu.copr import dag as JD
    from tidb_tpu.copr.aggregate import sum_out_dtype as j_sum_t
    from tidb_tpu_torch.copr import dag as PD
    from tidb_tpu_torch.copr.aggregate import sum_out_dtype
    D, sum_t = (JD, j_sum_t) if P is _J else (PD, sum_out_dtype)
    c = lambda n: _dcol(P, n)                      # noqa: E731
    scan = D.TableScan(tuple(range(len(DAG_COLS))),
                       tuple(c(n).dtype for n in DAG_COLS))
    A, Fn = D.AggDesc, D.AggFunc
    i64 = P.dt.bigint(False)

    def s(e):
        return A(Fn.SUM, e, sum_t(e.dtype))
    if which == "scalar":
        cond = P.b.logic("and", P.b.compare(
            "ne", P.b.arith("mod", c("i"), c("j")), lit(P, 0)),
            P.b.compare("ge", F(P, "year", lambda P: P.dt.bigint(),
                                c("day")), lit(P, 1970)))
        day_m = P.b.date_add(c("day"), c("n8"), "MONTH")
        rnd = P.b.round_func(c("f"), 1)
        return D.Aggregation(D.Selection(scan, (cond,)), (), (
            A(Fn.COUNT, None, i64),
            s(P.b.arith("div", c("d2"), c("d4"))),
            A(Fn.MIN, day_m, day_m.dtype), A(Fn.MAX, rnd, rnd.dtype),
            s(P.Func(P.dt.decimal(15, 3), "cast", (c("f"),))),
            A(Fn.COUNT, c("u"), i64)), D.GroupStrategy.SCALAR)
    if which == "dense":
        key = F(P, "weekday", lambda P: P.dt.bigint(False), c("d16"))
        cast_u = P.Func(P.dt.double(), "cast", (c("u"),))
        return D.Aggregation(D.Selection(scan, (P.b.compare(
            "gt", c("u"), c("w")),)), (key,), (
            s(P.b.arith("intdiv", c("i"), c("j"))),
            A(Fn.MAX, cast_u, cast_u.dtype),
            s(P.b.datediff(c("ts"), c("day"))),
            A(Fn.COUNT, None, i64)), D.GroupStrategy.DENSE,
            domain_sizes=(7,))
    key = F(P, "year", lambda P: P.dt.bigint(), c("ts"))
    sq = P.b.math_func("sqrt", c("f"))
    return D.Aggregation(D.Selection(scan, (P.b.compare(
        "lt", c("day"), c("ts")),)), (key,), (
        s(P.b.arith("sub", c("u"), c("w"))),
        A(Fn.SUM, sq, P.dt.double()),
        A(Fn.MIN, P.b.arith("mul", c("d2"), c("n8")), P.dt.decimal(18, 2)),
        A(Fn.COUNT, None, i64)), D.GroupStrategy.SORT, group_capacity=512)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("which", ["scalar", "dense", "sort"])
def test_lanes_in_programs_equal_get_sharded_program(which):
    """A Selection and aggregate arguments over the new lanes: the port's
    program on 8 logical devices against the JAX package's sharded
    program, every state leaf (float sums within FLOAT_RTOL)."""
    from tidb_tpu.parallel.mesh import get_mesh
    from tidb_tpu.parallel.spmd import get_sharded_program
    from tidb_tpu_torch.parallel.spmd import ShardedCopProgram
    jsnap, snap = _dag_snaps()
    jcols, jcounts = jsnap.device_cols(get_mesh())
    want = dict(_leaves(jax.device_get(get_sharded_program(
        _dag(_J, which), get_mesh())(jcols, jcounts))))
    cols, counts = snap.device_cols(CPU8)
    got = dict(_leaves(ShardedCopProgram(_dag(_P, which), CPU8)(cols,
                                                                 counts)))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w, g = np.asarray(w), got[name].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if w.dtype.kind == "f" and name.endswith(".sum"):
            assert (np.abs(g - w) <= FLOAT_RTOL * np.maximum(
                np.abs(w), 1.0)).all(), name
        elif w.dtype.kind == "f":
            assert (g.view(np.int64) == w.view(np.int64)).all(), name
        else:
            assert (g == w).all(), name


# ------------------------------------------------------------------ #
# statements of the JAX package's cast and builtin tests
# ------------------------------------------------------------------ #

SQL_SETUP = [
    # test_cast_matrix.py
    "create table t (a varchar(20), n bigint, d date, f double)",
    "insert into t values ('2024-01-31', 5, '2024-03-01', 1.5), "
    "(null, null, null, null), ('12.7', 7, '2023-12-25', 2.0), "
    "('garbage', 0, '2000-01-01', -3.25)",
    # test_fn_breadth.py
    "create table fb (s varchar(20), d date, n bigint)",
    "insert into fb values ('hello world', '2024-01-01', 5), "
    "('Smith', '2023-01-01', 17), ('abc,def,ghi', '2024-02-29', 0), "
    "(null, null, null)",
    # test_builtin_breadth.py
    "create table b (st varchar(30), n bigint, ip varchar(20), "
    "hx varchar(10))",
    "insert into b values ('hello world', 5, '10.0.0.1', 'ff'), "
    "(null, null, null, null), ('Quadratic', 300, '256.1.1.1', '2b')",
    # unsigned, decimal and datetime columns
    "create table m (id bigint, u bigint unsigned, v decimal(12,2), "
    "ts datetime, g bigint)",
    "insert into m values (1, 18446744073709551615, 12.50, "
    "'2024-02-29 23:59:59', 1), (2, 9223372036854775808, -7.25, "
    "'1969-12-31 00:00:01', 2), (3, 5, 0.00, '2000-01-01 12:00:00', 1), "
    "(4, null, null, null, 2), (5, 0, 100.10, '1999-06-15 06:30:00', 3)",
]

# (statement, the ops its cop task must hold, or () for parity alone)
SQL_CASES = [
    ("select cast(n as signed), cast(f as signed), cast(f as unsigned) "
     "from t", ()),
    ("select cast(f as decimal(10,2)), cast(n as double) from t", ()),
    ("select datediff(d, '2024-01-01'), year(d), quarter(d) from t", ()),
    ("select count(*) from t where cast(f as signed) > 1", {"cast"}),
    ("select sum(n div 2), sum(n % 3), sum(f / 2) from t", {"intdiv", "mod",
                                                            "div"}),
    ("select year(d), count(*) from t group by year(d) order by 1",
     {"year"}),
    ("select week(d), week(d, 0) from fb where n = 5", ()),
    ("select count(*) from fb where dayofweek(d) = 2", {"dayofweek"}),
    ("select makedate(2024, n) from fb order by n", ()),
    ("select from_unixtime(n * 86400) from fb order by n", ()),
    ("select max(last_day(d)), min(d + interval 1 month) from fb",
     {"last_day", "dateadd_months"}),
    ("select count(*) from b where n * 2 > 10 xor n < 100", {"xor"}),
    ("select sum(round(n / 7, 2)), sum(truncate(n / 7, 1)) from b",
     {"round", "truncate"}),
    ("select max(sqrt(n)), min(ln(n)), sum(pow(n, 2)) from b",
     {"sqrt", "ln", "pow"}),
    ("select count(*) from m where u > 9223372036854775807", ()),
    ("select id from m where u > 10 order by id", ()),
    ("select max(u), min(u), count(u) from m where u > 1", ()),
    ("select g, max(greatest(v, g)), sum(sign(v)) from m group by g "
     "order by g", {"greatest", "sign"}),
    ("select count(*) from m where ts > '2000-01-01'", ()),
    ("select count(*) from m where date(ts) = '2024-02-29'", ()),
    ("select hour(ts), minute(ts), second(ts), unix_timestamp(ts) from m "
     "order by id", ()),
    ("select g, count(*) from m where year(ts) < 2000 or v / 3 > 1 "
     "group by g order by g", {"year", "div"}),
    ("select g, sum(v % 2), max(cast(v as signed)) from m group by g "
     "order by g", {"mod", "cast"}),
]


@pytest.fixture(scope="module")
def sql_sessions():
    js, ps = pair()
    run_script(js, ps, SQL_SETUP)
    return js, ps


@pytest.mark.parametrize("case", range(len(SQL_CASES)))
def test_statements_equal_the_jax_session(sql_sessions, case):
    js, ps = sql_sessions
    sql, ops = SQL_CASES[case]
    both(js, ps, sql)
    assert set(ops) <= pushed_ops(ps, sql), (sql, pushed_ops(ps, sql))


def test_unsigned_div_sum_follows_the_device_lane(sql_sessions):
    """SUM(u DIV 3) over BIGINT UNSIGNED values past 2^63: the port's
    device lane divides unsigned and the sum is exact; the JAX session on
    the CPU aggregates on its host (numpy) lanes, whose uint64-by-int64
    division goes through float64 (ROADMAP.md, Queue 3 item 4)."""
    js, ps = sql_sessions
    sql = "select sum(u div 3) from m where u >= 5"
    us = [18446744073709551615, 9223372036854775808, 5]
    want = sum(u // 3 for u in us)
    assert int(ps.must_query(sql)[0][0]) == want
    assert "intdiv" in pushed_ops(ps, sql)
    assert int(js.must_query(sql)[0][0]) != want
