"""Rollup (``GROUP BY ... WITH ROLLUP``) on the port against the JAX package.

The JAX package runs a DENSE aggregation over an Expand node in one of
two branches, by the platform it traces for (``copr/exec.py::
agg_states``): level by level on the TPU (``set_trace_platform("tpu")``),
over the materialized ``levels x n`` replication elsewhere (``"cpu"``).
The port takes the level-by-level branch wherever it runs, one
``group_reduce_lanes`` call a level; a SORT, SEGMENT or SCATTER
aggregation over an Expand reads the materialized node in both packages.

Both branches of the JAX package are held against the port's program on
8 logical CPU devices over the same seeded columns (a nullable key, a
dictionary-coded string key, an int16 physical width, a decimal and a
double): counts, limbs and MIN/MAX bit for bit, float sums within
``FLOAT_RTOL`` (each side adds in its own order).  Then the statements
of the JAX package's ``tests/test_rollup.py`` run through both sessions.
"""

import jax
import numpy as np
import pytest
import torch

from tidb_tpu.copr import dag as JD
from tidb_tpu.copr import exec as jexec
from tidb_tpu.copr.aggregate import sum_out_dtype as j_sum_t
from tidb_tpu.chunk.column import Column as JColumn
from tidb_tpu.chunk.column import StringDict as JStringDict
from tidb_tpu.expr.ir import ColumnRef as JRef
from tidb_tpu.parallel.mesh import get_mesh
from tidb_tpu.parallel.spmd import ShardedCopProgram as JProgram
from tidb_tpu.parallel.spmd import get_sharded_program
from tidb_tpu.store import snapshot_from_columns as j_snapshot
from tidb_tpu.types import dtypes as jdt
from tidb_tpu_torch.copr import dag as D
from tidb_tpu_torch.copr import exec as pexec
from tidb_tpu_torch.copr.aggregate import sum_out_dtype
from tidb_tpu_torch.expr.ir import ColumnRef
from tidb_tpu_torch.parallel.spmd import ShardedCopProgram
from tidb_tpu_torch.store import snapshot_from_numpy
from tidb_tpu_torch.types import dtypes as dt

from test_torch_dml import pair

N_DEV = 8
CPU8 = (torch.device("cpu"),) * N_DEV
FLOAT_RTOL = 1e-12
N = 20_000


class _J:
    D, dt, Ref, sum_t = JD, jdt, JRef, staticmethod(j_sum_t)


class _P:
    D, dt, Ref, sum_t = D, dt, ColumnRef, staticmethod(sum_out_dtype)


def _specs(k1_domain: int):
    rng = np.random.default_rng(41)
    k1 = rng.integers(0, k1_domain, N)
    k1v = rng.random(N) > 0.1
    return [
        {"kind": "INT64", "nullable": True, "data": k1, "validity": k1v},
        {"kind": "STRING", "nullable": False,
         "data": rng.integers(0, 3, N).astype(np.int32),
         "dictionary": ["x", "y", "z"]},
        {"kind": "DECIMAL", "nullable": True, "prec": 12, "scale": 2,
         "data": rng.integers(-10 ** 7, 10 ** 7, N),
         "validity": rng.random(N) > 0.05},
        {"kind": "FLOAT64", "nullable": False,
         "data": rng.normal(0, 100, N)},
        {"kind": "INT64", "nullable": False,
         "data": rng.integers(-20_000, 20_000, N)},
    ]


NAMES = ["k1", "k2", "v", "f", "n"]


def _snaps(k1_domain):
    specs = _specs(k1_domain)
    jcols = []
    for s in specs:
        t = jdt.DataType(jdt.TypeKind[s["kind"]], s["nullable"],
                         s.get("prec", -1), s.get("scale", -1))
        if "dictionary" in s:
            jcols.append(JColumn(t, s["data"], np.ones(N, bool),
                                 JStringDict(s["dictionary"])))
        else:
            jcols.append(JColumn.from_numpy(t, s["data"],
                                            s.get("validity")))
    return j_snapshot(NAMES, jcols), snapshot_from_numpy(NAMES, specs)


def _rollup_agg(P, k1_domain, strategy="DENSE"):
    """SELECT k1, k2, COUNT(*), SUM(v), SUM(f), SUM(n), MIN(n), MAX(v),
    COUNT(v) ... GROUP BY k1, k2 WITH ROLLUP, as the planner binds it:
    the Expand appends a nullable column a rollup key and the gid."""
    ni64, i64 = P.dt.bigint(), P.dt.bigint(False)
    s = P.dt.varchar(False)
    dec, f64 = P.dt.decimal(12, 2), P.dt.double(False)
    scan = P.D.TableScan((0, 1, 2, 3, 4), (ni64, s, dec, f64, i64))
    keys = (P.Ref(ni64, 0, "k1"), P.Ref(s, 1, "k2"))
    exp = P.D.Expand(scan, keys, 3)
    gb = (P.Ref(ni64, 5), P.Ref(P.dt.varchar(True), 6), P.Ref(i64, 7))
    A, F = P.D.AggDesc, P.D.AggFunc
    v, f, n = P.Ref(dec, 2), P.Ref(f64, 3), P.Ref(i64, 4)
    aggs = (A(F.COUNT, None, i64), A(F.SUM, v, P.sum_t(dec)),
            A(F.SUM, f, P.dt.double()), A(F.SUM, n, P.sum_t(i64)),
            A(F.MIN, n, P.dt.bigint()), A(F.MAX, v, dec),
            A(F.COUNT, v, i64))
    if strategy == "DENSE":
        return P.D.Aggregation(exp, gb, aggs, P.D.GroupStrategy.DENSE,
                               domain_sizes=(k1_domain + 1, 4, 3))
    return P.D.Aggregation(exp, gb, aggs, P.D.GroupStrategy[strategy],
                           group_capacity=256, num_buckets=256)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _assert_states_equal(want, got):
    want, got = dict(_leaves(want)), dict(_leaves(got))
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, \
            (name, g.shape, w.shape, g.dtype, w.dtype)
        if w.dtype.kind == "f" and name.endswith(".sum"):
            err = np.abs(g - w)
            assert (err <= FLOAT_RTOL * np.maximum(np.abs(w), 1.0)).all(), \
                name
        elif w.dtype.kind == "f":
            assert (g.view(np.int64) == w.view(np.int64)).all(), name
        else:
            assert (g == w).all(), name


def _jax_states(jagg, jsnap, platform):
    """The JAX program's merged states, traced for ``platform``: "tpu"
    takes its level-by-level branch, "cpu" the materialized Expand."""
    jexec.set_trace_platform(platform)
    try:
        jcols, jcounts = jsnap.device_cols(get_mesh())
        return jax.device_get(JProgram(jagg, get_mesh())(jcols, jcounts))
    finally:
        jexec.set_trace_platform(None)


# 3 keys a level of k1 (one-hot range of the JAX TPU branch: 4*4*3 = 48
# groups <= 64) and 40 (a scatter: 41*4*3 = 492 groups)
@pytest.mark.parametrize("k1_domain", [3, 40])
@pytest.mark.parametrize("platform", ["tpu", "cpu"])
def test_dense_rollup_states_equal_both_jax_branches(platform, k1_domain):
    jsnap, snap = _snaps(k1_domain)
    want = _jax_states(_rollup_agg(_J, k1_domain), jsnap, platform)
    cols, counts = snap.device_cols(CPU8)
    got = ShardedCopProgram(_rollup_agg(_P, k1_domain), CPU8)(cols, counts)
    _assert_states_equal(want, got)


def test_level_by_level_branch_is_the_ports_and_launches_once_a_level(
        monkeypatch):
    """The port aggregates a DENSE rollup level by level on every
    device type: one ``group_reduce_lanes`` call a level a logical
    device, over the un-expanded n rows (never ``levels x n``)."""
    calls = []
    real = pexec.group_reduce_lanes

    def counted(gids, G, lanes):
        calls.append(lanes[0].mask.shape[0])
        return real(gids, G, lanes)
    monkeypatch.setattr(pexec, "group_reduce_lanes", counted)
    _jsnap, snap = _snaps(3)
    cols, counts = snap.device_cols(CPU8)
    ShardedCopProgram(_rollup_agg(_P, 3), CPU8)(cols, counts)
    rows = cols[0][0].shape[1] * (cols[0][0].shape[0] // N_DEV)
    assert calls == [rows] * (3 * N_DEV)


@pytest.mark.parametrize("strategy", ["SORT", "SEGMENT", "SCATTER"])
def test_high_ndv_rollup_reads_the_materialized_expand(strategy):
    """SORT, SEGMENT and SCATTER over an Expand read its tiled batch, as
    the JAX program does: every per-device state leaf is equal."""
    jsnap, snap = _snaps(40)
    jagg = _rollup_agg(_J, 40, strategy)
    jcols, jcounts = jsnap.device_cols(get_mesh())
    want = jax.device_get(get_sharded_program(jagg, get_mesh())(jcols,
                                                                jcounts))
    cols, counts = snap.device_cols(CPU8)
    got = ShardedCopProgram(_rollup_agg(_P, 40, strategy), CPU8)(cols,
                                                                  counts)
    _assert_states_equal(want, got)


# ------------------------------------------------------------------ #
# the statements of tests/test_rollup.py through both sessions
# ------------------------------------------------------------------ #

ROLLUP_SQL = [
    "SELECT a, b, SUM(v), COUNT(*) FROM t GROUP BY a, b WITH ROLLUP",
    "SELECT a, b, COUNT(*) FROM t GROUP BY a, b WITH ROLLUP",
    "SELECT a, b, GROUPING(a), GROUPING(b), GROUPING(a,b) FROM t "
    "GROUP BY a, b WITH ROLLUP",
    "SELECT a, GROUPING(a) FROM t GROUP BY a",
    "SELECT a, SUM(v) AS sv FROM t GROUP BY a WITH ROLLUP "
    "HAVING sv >= 70 ORDER BY sv DESC LIMIT 2",
    "SELECT a, SUM(v) FROM t GROUP BY a WITH ROLLUP HAVING GROUPING(a) = 1",
    "SELECT t.a, SUM(u.w) FROM t JOIN u ON t.a=u.a GROUP BY t.a WITH ROLLUP",
    "SELECT a, COUNT(DISTINCT b) FROM t GROUP BY a WITH ROLLUP",
    "SELECT a+1, COUNT(*) FROM t GROUP BY a+1 WITH ROLLUP",
    "SELECT b, SUM(v) FROM t GROUP BY b WITH ROLLUP",
    "SELECT a FROM t GROUP BY a WITH CUBE",
    "SELECT a, b, COUNT(*), SUM(v), MIN(v), MAX(v) FROM t "
    "GROUP BY a, b WITH ROLLUP",
    "SELECT a, b, AVG(v), SUM(v * 2) FROM t WHERE v > 15 "
    "GROUP BY a, b WITH ROLLUP",
]

SETUP = ["CREATE TABLE t (a INT, b VARCHAR(10), v INT)",
         "INSERT INTO t VALUES (1,'x',10),(1,'y',20),(2,'x',30),"
         "(2,NULL,40),(NULL,'x',50),(1,'x',60)",
         "CREATE TABLE u (a INT, w INT)",
         "INSERT INTO u VALUES (1,100),(2,200)"]


@pytest.fixture(scope="module")
def sessions():
    js, ps = pair()
    for s in SETUP:
        js.execute(s)
        ps.execute(s)
    return js, ps


def _outcome(sess, sql):
    try:
        res = sess.execute(sql)
    except Exception as e:
        return ("error", type(e).__name__)
    return ("ok", res.names, sorted(res.rows, key=lambda r: tuple(
        (x is None, str(x)) for x in r)))


@pytest.mark.parametrize("sql", ROLLUP_SQL)
def test_rollup_statements_equal_jax_session(sessions, sql):
    js, ps = sessions
    assert _outcome(ps, sql) == _outcome(js, sql)


def test_rollup_explain_fuses_the_expand(sessions):
    """The Expand rides inside the cop task, and the port's plan tree is
    the JAX session's (up to its analysis footers and device name)."""
    js, ps = sessions
    q = "EXPLAIN SELECT a, SUM(v) FROM t GROUP BY a WITH ROLLUP"
    got = [r[0] for r in ps.execute(q).rows]
    lines = [r[0] for r in js.execute(q).rows]
    want = lines[:lines.index("contract: ok")] if "contract: ok" in lines \
        else lines
    assert any("Expand" in line for line in got), got
    assert any("CopTask[agg]" in line for line in got), got
    assert got == [line.replace("-> TPU", "-> cpu") for line in want]
