"""The port's row-returning path against the JAX package: Limit, TopN
and a filtered projection, compacted on each device and paged by the
client.

The same inputs go through the port's ``ShardedCopProgram(root, devices,
row_capacity=cap)`` on 8 logical CPU devices and through the JAX
package's ``get_sharded_program(root, mesh, row_capacity=cap)`` on its
8-device CPU mesh: each device's ``(cols, count)`` must be equal, bit
for bit.  The port's ``CopClient("cpu", 8).execute_rows`` must equal the
JAX client's ``execute_rows`` on the same snapshot, including a run that
regrows its row capacity, and a numpy oracle.

The corpus statements (tidb_tpu/testing/tpch.py):
    select l_orderkey, l_extendedprice from lineitem
    order by l_extendedprice desc, l_orderkey limit 10
    select l_partkey from lineitem limit 5
    select l_orderkey, l_extendedprice * (1 - l_discount)
    from lineitem where l_quantity < 5
"""

import jax
import numpy as np
import pytest
import torch

from tidb_tpu.chunk.column import Column as JColumn
from tidb_tpu.copr import dag as JD
from tidb_tpu.expr import builders as jb
from tidb_tpu.expr.ir import ColumnRef as JRef
from tidb_tpu.parallel.mesh import get_mesh
from tidb_tpu.parallel.spmd import get_sharded_program
from tidb_tpu.store import CopClient as JClient
from tidb_tpu.store import snapshot_from_columns as j_snapshot
from tidb_tpu.testing.tpch import gen_lineitem as j_gen_lineitem
from tidb_tpu.types import dtypes as jdt
from tidb_tpu_torch.copr import dag as D
from tidb_tpu_torch.expr import builders as b
from tidb_tpu_torch.expr.ir import ColumnRef
from tidb_tpu_torch.ops import sort as S
from tidb_tpu_torch.parallel.spmd import ShardedCopProgram
from tidb_tpu_torch.store import CopClient, snapshot_from_numpy
from tidb_tpu_torch.types import dtypes as dt


def _jclient():
    """The JAX package's client with its admission scheduler bypassed
    (``sched_enable``): it starts no ``sched-drain`` or
    ``copforge-predict`` daemon thread, which can abort the test process
    at exit."""
    client = JClient(get_mesh())
    client.sched_enable = False
    return client


SF = 0.005                       # 30,000 lineitem rows
N_DEV = 8
CPU8 = (torch.device("cpu"),) * N_DEV
LI_COLS = ["l_orderkey", "l_partkey", "l_quantity", "l_extendedprice",
           "l_discount"]


class _JaxNS:
    D, dt, b, Ref = JD, jdt, jb, JRef


class _PortNS:
    D, dt, b, Ref = D, dt, b, ColumnRef


def _spec(c):
    return {"kind": c.dtype.kind.name, "nullable": c.dtype.nullable,
            "prec": c.dtype.prec, "scale": c.dtype.scale, "data": c.data,
            "validity": c.validity}


def _snaps(names, jcols):
    return (j_snapshot(names, jcols),
            snapshot_from_numpy(names, [_spec(c) for c in jcols]))


@pytest.fixture(scope="module")
def lineitem_snaps():
    names, cols = j_gen_lineitem(SF, seed=1, columns=LI_COLS)
    return _snaps(names, cols), dict(zip(names, cols))


def _corpus(which, P, qty_below=5):
    """The root of a corpus statement over the LI_COLS layout."""
    i64, dec2 = P.dt.bigint(False), P.dt.decimal(15, 2)
    scan = P.D.TableScan((0, 1, 2, 3, 4), (i64, i64, dec2, dec2, dec2))
    ok, pk = P.Ref(i64, 0), P.Ref(i64, 1)
    qty, price, disc = P.Ref(dec2, 2), P.Ref(dec2, 3), P.Ref(dec2, 4)
    if which == "TopN":
        return P.D.TopN(P.D.Projection(scan, (ok, price)),
                        sort_keys=((P.Ref(dec2, 1), True),
                                   (P.Ref(i64, 0), False)), limit=10)
    if which == "Limit":
        return P.D.Limit(P.D.Projection(scan, (pk,)), 5)
    sel = P.D.Selection(scan, (P.b.compare("lt", qty, P.b.lit(qty_below)),))
    return P.D.Projection(sel, (ok, P.b.arith(
        "mul", price, P.b.arith("sub", P.b.lit(1), disc))))


def _assert_rows_equal(jroot, root, jsnap, snap, cap):
    """Each device's compacted (cols, count) of the port equals the JAX
    program's at row capacity ``cap``; returns the counts."""
    jcols, jcounts = jsnap.device_cols(get_mesh())
    want_cols, want_n = jax.device_get(
        get_sharded_program(jroot, get_mesh(), row_capacity=cap)(jcols,
                                                                 jcounts))
    cols, counts = snap.device_cols(CPU8)
    got_cols, got_n = ShardedCopProgram(root, CPU8, row_capacity=cap)(
        cols, counts)
    assert (got_n.numpy() == np.asarray(want_n)).all()
    assert len(got_cols) == len(want_cols)
    for (gv, gm), (wv, wm) in zip(got_cols, want_cols):
        wv, wm = np.asarray(wv), np.asarray(wm)
        assert gv.shape == wv.shape == (N_DEV, cap)
        assert gv.numpy().dtype == wv.dtype
        if wv.dtype.kind == "f":
            assert (gv.numpy().view(np.int64) == wv.view(np.int64)).all()
        else:
            assert (gv.numpy() == wv).all()
        assert (gm.numpy() == wm).all()
    return np.asarray(want_n)


@pytest.mark.parametrize("which,cap", [("TopN", 16), ("Limit", 16),
                                       ("filtered projection", 1024),
                                       ("filtered projection", 64)])
def test_corpus_rows_equal_jax(lineitem_snaps, which, cap):
    """Per-device rows of the corpus statements, one at a capacity the
    filtered rows overflow (the count then exceeds it)."""
    (jsnap, snap), _ = lineitem_snaps
    n = _assert_rows_equal(_corpus(which, _JaxNS), _corpus(which, _PortNS),
                           jsnap, snap, cap)
    if which == "filtered projection":
        assert (n > 64).all() and (n <= 1024).all()


def _topn_snaps(n, seed):
    """Keys with many ties, a nullable key, a DOUBLE key with -0.0, +0.0,
    NaN and +-inf, and a BIGINT UNSIGNED column past 2^63."""
    rng = np.random.default_rng(seed)
    tie = rng.integers(0, 4, n)
    nk = rng.integers(-20, 20, n)
    nkv = rng.random(n) < 0.8
    fk = rng.choice(np.array([-0.0, 0.0, np.nan, np.inf, -np.inf, 1.5,
                              -7.25, 1e-300]), n)
    uk = rng.choice(np.array([3, 2 ** 63, 2 ** 64 - 1], dtype=np.uint64), n)
    rid = np.arange(n)
    kinds = [("INT64", False), ("INT64", True), ("FLOAT64", False),
             ("UINT64", False), ("INT64", False)]
    data = [(tie, None), (nk, nkv), (fk, None), (uk, None), (rid, None)]
    jcols = [JColumn.from_numpy(jdt.DataType(jdt.TypeKind[k], nl), d, v)
             for (k, nl), (d, v) in zip(kinds, data)]
    return _snaps(["tie", "nk", "fk", "uk", "rid"], jcols), data


def _topn(P, case, limit):
    types = [P.dt.bigint(False), P.dt.bigint(True), P.dt.double(False),
             P.dt.ubigint(False), P.dt.bigint(False)]
    scan = P.D.TableScan(tuple(range(5)), tuple(types))
    r = [P.Ref(t, i) for i, t in enumerate(types)]
    sel = P.D.Selection(scan, (P.b.compare("lt", r[4], P.b.lit(5000)),))
    if case == "single key":
        return P.D.TopN(sel, r[4], True, limit)
    if case == "two keys with ties":
        return P.D.TopN(sel, sort_keys=((r[0], False), (r[1], True)),
                        limit=limit)
    if case == "DESC float key":
        return P.D.TopN(sel, sort_keys=((r[2], True),), limit=limit)
    if case == "nullable key ASC":
        return P.D.TopN(sel, sort_keys=((r[1], False),), limit=limit)
    if case == "unsigned key":
        return P.D.TopN(sel, sort_keys=((r[3], True), (r[0], False)),
                        limit=limit)
    raise KeyError(case)


TOPN_CASES = ["single key", "two keys with ties", "DESC float key",
              "nullable key ASC", "unsigned key"]


@pytest.mark.parametrize("limit", [7, 700])
@pytest.mark.parametrize("case", TOPN_CASES)
def test_topn_rows_equal_jax(case, limit):
    """TopN with ties (kept in row order, as the stable lax.sort keeps
    them), NULLs first ASC and last DESC, a DESC DOUBLE key with -0.0,
    NaN and infinities, and a BIGINT UNSIGNED key; a limit past some
    devices' live rows too."""
    (jsnap, snap), _ = _topn_snaps(6000, 3)
    before = S.PASSES["stable_argsort"]
    _assert_rows_equal(_topn(_JaxNS, case, limit), _topn(_PortNS, case,
                                                         limit),
                       jsnap, snap, max(limit, 16))
    assert S.PASSES["stable_argsort"] > before


def test_limit_keeps_the_first_live_rows():
    """Limit over a Selection keeps each device's first ``limit`` live
    rows, NULL masks and all."""
    (jsnap, snap), _ = _topn_snaps(6000, 4)
    roots = []
    for P in (_JaxNS, _PortNS):
        types = [P.dt.bigint(False), P.dt.bigint(True)]
        scan = P.D.TableScan((0, 1), tuple(types))
        sel = P.D.Selection(scan, (P.b.compare("gt", P.Ref(types[0], 0),
                                               P.b.lit(1)),))
        roots.append(P.D.Limit(sel, 40))
    _assert_rows_equal(*roots, jsnap, snap, 64)


# ------------------------------------------------------------------ #
# the client's paging loop
# ------------------------------------------------------------------ #

def _col_equal(c, j):
    assert c.data.dtype == j.data.dtype
    assert (c.validity == j.validity).all()
    if c.data.dtype.kind == "f":
        return (c.data.view(np.int64) == j.data.view(np.int64)).all()
    return (c.data == j.data).all()


def _execute_both(jroot, root, jsnap, snap):
    client = CopClient("cpu", N_DEV)
    got = client.execute_rows(root, snap, D.output_dtypes(root))
    want = _jclient().execute_rows(jroot, jsnap,
                                            JD.output_dtypes(jroot))
    assert len(got) == len(want)
    for c, j in zip(got, want):
        assert _col_equal(c, j)
    return got, client


def _oracle(which, li, qty_below=5):
    ok, pk = li["l_orderkey"].data, li["l_partkey"].data
    price, disc = li["l_extendedprice"].data, li["l_discount"].data
    if which == "TopN":
        order = np.lexsort((ok, -price))[:10]
        return [ok[order], price[order]]
    if which == "Limit":
        return None
    keep = li["l_quantity"].data < qty_below * 100
    return [ok[keep], price[keep] * (100 - disc[keep])]


@pytest.mark.parametrize("which", ["TopN", "Limit", "filtered projection"])
def test_corpus_execute_rows_equals_jax_and_oracle(lineitem_snaps, which):
    (jsnap, snap), li = lineitem_snaps
    got, client = _execute_both(_corpus(which, _JaxNS),
                                _corpus(which, _PortNS), jsnap, snap)
    want = _oracle(which, li)
    if which == "TopN":
        # the root re-trims the devices' union to the top 10
        assert len(got[0].data) == N_DEV * 10
        order = np.lexsort((got[0].data, -got[1].data))[:10]
        assert (got[0].data[order] == want[0]).all()
        assert (got[1].data[order] == want[1]).all()
        assert client.timings["pages"] == [16]
    elif which == "Limit":
        assert len(got[0].data) == N_DEV * 5
        assert np.isin(got[0].data, li["l_partkey"].data).all()
    else:
        assert (got[0].data == want[0]).all()
        assert (np.array([int(x) for x in got[1].data]) == want[1]).all()
        assert client.timings["pages"] == [1024]
    for k in ("place", "device", "transfer", "assemble"):
        assert client.timings[k] >= 0.0


def test_execute_rows_regrows_its_capacity(lineitem_snaps):
    """A filter keeping more rows than a quarter of a shard overflows
    the first capacity; the client regrows it, the result equals the
    JAX client's and the oracle, and the page feedback sizes the next
    run of the same statement at once."""
    (jsnap, snap), li = lineitem_snaps
    jroot = _corpus("filtered projection", _JaxNS, qty_below=30)
    root = _corpus("filtered projection", _PortNS, qty_below=30)
    got, client = _execute_both(jroot, root, jsnap, snap)
    pages = client.timings["pages"]
    assert pages[0] == 1024 and len(pages) == 2 and pages[1] > 1024
    assert client.last_page_iters == 2
    want = _oracle("filtered projection", li, qty_below=30)
    assert (got[0].data == want[0]).all()
    again = client.execute_rows(root, snap, D.output_dtypes(root))
    assert len(client.timings["pages"]) == 1
    for c, j in zip(again, got):
        assert _col_equal(c, j)


def test_projected_null_literal_compacts():
    """A projected NULL literal (value 0, mask the scalar False) and a
    constant compact like columns, as the JAX program compacts them."""
    (jsnap, snap), _ = _topn_snaps(3000, 6)
    roots = []
    for P in (_JaxNS, _PortNS):
        types = [P.dt.bigint(False), P.dt.bigint(True)]
        scan = P.D.TableScan((0, 1), tuple(types))
        sel = P.D.Selection(scan, (P.b.compare("lt", P.Ref(types[0], 0),
                                               P.b.lit(2)),))
        roots.append(P.D.Projection(sel, (P.Ref(types[1], 1),
                                          P.b.lit(None), P.b.lit(7))))
    _assert_rows_equal(*roots, jsnap, snap, 256)
