"""The port's host aggregation (``tidb_tpu_torch/copr/hostagg.py``)
against the JAX package's ``tidb_tpu/copr/hostagg.py``.

The same tables, made from a seed with numpy, go into a snapshot of each
package; the same DAG, built in each package, goes through each
package's ``host_sort_agg`` (SORT; over an Expand its rollup path
``host_rollup_agg``) or ``host_dense_agg`` (DENSE, SCALAR).  Every
partial state must be equal: counts, limbs, keys, their validity and
``__ngroups__`` bit for bit, float SUM fields within ``FLOAT_RTOL``
(relative, of at least 1.0) — both packages run the same numpy
operations, so they agree exactly today; the tolerance is the parity
rule for float sums.  The cases are those of tests/test_hostagg.py:
every aggregate kind over an int key, nullable and multiple keys with a
float sum, a filter with a string key, a wide key range (the sorting
unique instead of the histogram), the high-selectivity trim group with
one- and two-limb sums, a low-selectivity SCALAR, and a rollup.

The port builds ``native/hostops.cpp`` with g++ into its ``_build/``
(``copr/nativeops.py``); ``nativeops.available()`` must be true, and
the numpy path it falls back to must give the same states.
"""

import numpy as np
import pytest

from tidb_tpu.chunk.column import Column as JColumn
from tidb_tpu.chunk.column import StringDict as JStringDict
from tidb_tpu.copr import dag as JD
from tidb_tpu.copr import hostagg as jhost
from tidb_tpu.copr.aggregate import sum_out_dtype as j_sum_t
from tidb_tpu.expr import builders as jb
from tidb_tpu.expr.ir import ColumnRef as JRef
from tidb_tpu.store import snapshot_from_columns as j_snapshot
from tidb_tpu.types import dtypes as jdt
from tidb_tpu_torch.chunk.column import Column, StringDict
from tidb_tpu_torch.copr import dag as D
from tidb_tpu_torch.copr import hostagg, nativeops
from tidb_tpu_torch.copr.aggregate import sum_out_dtype
from tidb_tpu_torch.expr import builders as b
from tidb_tpu_torch.expr.ir import ColumnRef
from tidb_tpu_torch.store.columnar import snapshot_from_columns
from tidb_tpu_torch.types import dtypes as dt

FLOAT_RTOL = 1e-12


class _JaxNS:
    D, dt, b, Ref, Col, Dict = JD, jdt, jb, JRef, JColumn, JStringDict
    sum_t = staticmethod(j_sum_t)
    host = jhost
    snapshot = staticmethod(j_snapshot)


class _PortNS:
    D, dt, b, Ref, Col, Dict = D, dt, b, ColumnRef, Column, StringDict
    sum_t = staticmethod(sum_out_dtype)
    host = hostagg
    snapshot = staticmethod(snapshot_from_columns)


def _table(case):
    """(column specs, row count) of a case: each spec (kind, nullable,
    data, validity, dictionary values)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case in ("int key all aggs", "rollup"):
        n = 5000
        v_ok = np.ones(n, bool)
        v_ok[rng.integers(0, n, 200)] = False
        return [("INT64", False, rng.integers(0, 700, n), None, None),
                ("INT64", True, rng.integers(-1000, 1000, n), v_ok, None),
                ("INT64", False, rng.integers(0, 5, n), None, None)], n
    if case == "nullable multi key":
        n = 3000
        return [("INT64", True, rng.integers(0, 40, n),
                 rng.random(n) > 0.1, None),
                ("INT64", False, rng.integers(-5, 5, n), None, None),
                ("FLOAT64", False, rng.random(n) * 100, None, None)], n
    if case == "string key":
        n = 4000
        return [("VARCHAR", False, rng.integers(0, 50, n).astype(np.int32),
                 None, [f"w{i:03d}" for i in range(50)]),
                ("INT64", False, rng.integers(0, 100, n), None, None)], n
    if case == "wide key range":
        n = 2000
        k = rng.integers(0, 10 ** 12, n)
        k[rng.integers(0, n, 500)] = 42                  # one hot group
        return [("INT64", False, k, None, None),
                ("INT64", False, rng.integers(0, 10 ** 6, n), None, None)], n
    n = 20_000                                  # the dense cases
    return [("INT64", False, rng.integers(0, 3, n), None, None),
            ("INT64", False, rng.integers(0, 1000, n), None, None),
            ("INT64", False, rng.integers(0, 1 << 45, n), None, None),
            ("INT64", True, rng.integers(-50, 50, n), rng.random(n) > 0.2,
             None),
            ("INT64", False, rng.integers(0, 1000, n), None, None),
            ("FLOAT64", True, rng.normal(0.0, 1e4, n), rng.random(n) > 0.1,
             None)], n


def _columns(P, specs, n):
    cols = []
    for kind, nullable, data, valid, words in specs:
        t = (P.dt.varchar(nullable) if kind == "VARCHAR"
             else P.dt.DataType(P.dt.TypeKind[kind], nullable))
        cols.append(P.Col(t, np.asarray(data),
                          np.ones(n, bool) if valid is None else valid,
                          None if words is None else P.Dict(words)))
    return cols


def _dag(P, case, cols):
    """The case's aggregation in package P."""
    ts = tuple(c.dtype for c in cols)
    scan = P.D.TableScan(tuple(range(len(cols))), ts)
    r = [P.Ref(t, i, f"c{i}") for i, t in enumerate(ts)]
    i64 = P.dt.bigint(False)
    A, F = P.D.AggDesc, P.D.AggFunc
    if case == "int key all aggs":
        return P.D.Aggregation(scan, (r[0],), (
            A(F.COUNT, None, i64), A(F.COUNT, r[1], i64),
            A(F.SUM, r[1], P.sum_t(ts[1])), A(F.MIN, r[1], ts[1]),
            A(F.MAX, r[1], ts[1])), P.D.GroupStrategy.SORT,
            group_capacity=2048)
    if case == "nullable multi key":
        return P.D.Aggregation(scan, (r[0], r[1]), (
            A(F.COUNT, None, i64), A(F.SUM, r[2], P.sum_t(ts[2]))),
            P.D.GroupStrategy.SORT, group_capacity=1024)
    if case == "string key":
        sel = P.D.Selection(scan, (P.b.compare("lt", r[1],
                                               P.b.lit(60, ts[1])),))
        return P.D.Aggregation(sel, (r[0],), (
            A(F.COUNT, None, i64), A(F.MIN, r[1], ts[1])),
            P.D.GroupStrategy.SORT, group_capacity=256)
    if case == "wide key range":
        return P.D.Aggregation(scan, (r[0],), (
            A(F.SUM, r[1], P.sum_t(ts[1])),), P.D.GroupStrategy.SORT,
            group_capacity=4096)
    if case == "rollup":
        # ROLLUP(c2, c0): the Expand appends the two keys and the gid
        ex = P.D.Expand(scan, (r[2], r[0]), 3)
        k2 = P.Ref(P.dt.bigint(True), 3, "k2")
        k0 = P.Ref(P.dt.bigint(True), 4, "k0")
        gid = P.Ref(i64, 5, "gid")
        return P.D.Aggregation(ex, (k2, k0, gid), (
            A(F.COUNT, None, i64), A(F.SUM, r[1], P.sum_t(ts[1])),
            A(F.MAX, r[1], ts[1])), P.D.GroupStrategy.SORT,
            group_capacity=4096)
    dense_aggs = (A(F.COUNT, None, i64), A(F.SUM, r[1], P.sum_t(ts[1])),
                  A(F.SUM, r[2], P.sum_t(ts[2])), A(F.COUNT, r[3], i64),
                  A(F.MIN, r[3], ts[3]), A(F.MAX, r[2], ts[2]),
                  A(F.SUM, r[5], P.sum_t(ts[5])), A(F.MIN, r[5], ts[5]))
    if case == "dense trim group":
        # ~95% selectivity: the dead rows go to the trim group past G
        sel = P.D.Selection(scan, (P.b.compare("lt", r[4],
                                               P.b.lit(950, ts[4])),))
        return P.D.Aggregation(sel, (r[0],), dense_aggs,
                               P.D.GroupStrategy.DENSE, domain_sizes=(3,))
    # "scalar": ~30% selectivity, the rows compacted
    sel = P.D.Selection(scan, (P.b.compare("lt", r[4],
                                           P.b.lit(300, ts[4])),))
    return P.D.Aggregation(sel, (), dense_aggs, P.D.GroupStrategy.SCALAR)


SORT_CASES = ["int key all aggs", "nullable multi key", "string key",
              "wide key range", "rollup"]
DENSE_CASES = ["dense trim group", "scalar"]


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v)


def _assert_states_equal(want, got):
    want, got = dict(_leaves(want)), dict(_leaves(got))
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if w.dtype.kind == "f" and name.endswith(".sum"):
            err = np.abs(g - w)
            assert (err <= FLOAT_RTOL * np.maximum(np.abs(w), 1.0)).all(), \
                name
        elif w.dtype.kind == "f":
            assert (g.view(np.int64) == w.view(np.int64)).all(), name
        else:
            assert (g == w).all(), name


def _states(P, case):
    specs, n = _table(case)
    cols = _columns(P, specs, n)
    snap = P.snapshot([f"c{i}" for i in range(len(cols))], cols,
                      n_shards=4)
    agg = _dag(P, case, cols)
    run = (P.host.host_sort_agg if case in SORT_CASES
           else P.host.host_dense_agg)
    return run(agg, snap)


@pytest.mark.parametrize("case", SORT_CASES + DENSE_CASES)
def test_host_states_equal_the_jax_package(case):
    want = _states(_JaxNS, case)
    got = _states(_PortNS, case)
    assert want is not None and got is not None
    _assert_states_equal(want, got)
    if case in SORT_CASES:
        assert int(got["__ngroups__"]) > 1


@pytest.mark.parametrize("case", ["int key all aggs", "rollup"])
def test_numpy_path_equals_the_native_one(case, monkeypatch):
    """Without the native library ``_group_codes`` takes the JAX
    package's numpy histogram; the states do not change."""
    native = _states(_PortNS, case)
    monkeypatch.setattr(nativeops, "_lib", None)
    monkeypatch.setattr(nativeops, "_tried", True)
    assert not nativeops.available()
    _assert_states_equal(native, _states(_PortNS, case))


def test_native_library_is_the_ports_build():
    """The port loads the library it built from its own hostops.cpp,
    named by the source's hash, never the JAX package's."""
    assert nativeops.available(), nativeops.build_error()
    so = nativeops.library_path()
    assert so.parent.name == "_build"
    assert so.parent.parent.name == "tidb_tpu_torch"
    assert so.name.startswith("libtpuhostops-") and so.exists()
    assert nativeops._load()._name == str(so)
    keys = np.array([3, 5, 3, 9], np.int64)
    assert nativeops.count_keys(keys, 3, 7).tolist() == [2, 0, 1, 0, 0, 0, 1]
    lookup = np.array([0, -1, 1, -1, -1, -1, 2], np.int32)
    assert nativeops.gather_lookup(keys, 3, lookup).tolist() == [0, 1, 0, 2]


def test_out_of_scope_plans_return_none():
    """A plan the host engines do not cover (a FIRST or BIT_OR
    aggregate) returns None in both packages, for the caller's own
    fallback."""
    for P in (_JaxNS, _PortNS):
        specs, n = _table("int key all aggs")
        cols = _columns(P, specs, n)
        snap = P.snapshot(["c0", "c1", "c2"], cols, n_shards=4)
        t = cols[1].dtype
        scan = P.D.TableScan((0, 1, 2), tuple(c.dtype for c in cols))
        for func in (P.D.AggFunc.FIRST, P.D.AggFunc.BIT_OR):
            agg = P.D.Aggregation(scan, (P.Ref(cols[0].dtype, 0),), (
                P.D.AggDesc(func, P.Ref(t, 1), t),),
                P.D.GroupStrategy.SORT, group_capacity=1024)
            assert P.host.host_sort_agg(agg, snap) is None
            assert P.host.host_dense_agg(agg, snap) is None
