"""The port's high-NDV GROUP BY slice end to end against the JAX package.

The same TPC-H lineitem data (the JAX generator's output, carried into
the port with ``snapshot_from_numpy``) goes through
``tidb_tpu_torch.store.CopClient(device="cpu").execute_agg`` and through
the JAX package's sharded SCATTER program on its 8-device CPU mesh, with
the Pallas gate on (interpret mode) and off (XLA lowering), followed by
its host merge.  Both are also held against a numpy oracle.  Everything
is integer or decimal, so every comparison is exact.

Query A is the grouping inside TPC-H Q18:
    select l_orderkey, sum(l_quantity), count(*) from lineitem
    group by l_orderkey
Query B is the repo's corpus query (tidb_tpu/testing/tpch.py):
    select l_orderkey, l_suppkey, max(l_extendedprice) from lineitem
    where l_quantity < 45 group by l_orderkey, l_suppkey
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.chunk.column import Column as JColumn
from tidb_tpu.copr import dag as JD
from tidb_tpu.copr import radix as jradix
from tidb_tpu.copr.aggregate import GroupKeyMeta as JMeta
from tidb_tpu.copr.aggregate import finalize_sorted as j_finalize
from tidb_tpu.copr.aggregate import merge_sorted_states as j_merge
from tidb_tpu.copr.aggregate import sum_out_dtype as j_sum_t
from tidb_tpu.expr import builders as jb
from tidb_tpu.expr.compile import Evaluator as JEvaluator
from tidb_tpu.expr.ir import ColumnRef as JRef
from tidb_tpu.parallel.mesh import get_mesh
from tidb_tpu.parallel.spmd import get_sharded_program
from tidb_tpu.store import snapshot_from_columns as j_snapshot
from tidb_tpu.testing.tpch import gen_lineitem as j_gen_lineitem
from tidb_tpu.types import dtypes as jdt
from tidb_tpu_torch.copr import dag as D
from tidb_tpu_torch.copr import radix, segment
from tidb_tpu_torch.copr.cuda import radix_kernel as rk
from tidb_tpu_torch.copr.aggregate import GroupKeyMeta, sum_out_dtype
from tidb_tpu_torch.expr import builders as b
from tidb_tpu_torch.expr.compile import Evaluator
from tidb_tpu_torch.expr.ir import ColumnRef
from tidb_tpu_torch.parallel.spmd import ShardedCopProgram
from tidb_tpu_torch.store import CopClient, snapshot_from_numpy
from tidb_tpu_torch.testing.tpch import gen_lineitem
from tidb_tpu_torch.types import dtypes as dt

SF = 0.005                       # 30,000 lineitem rows
N_DEV = 8
CPU8 = (torch.device("cpu"),) * N_DEV


@pytest.fixture(autouse=True)
def _auto_pallas_mode():
    jradix.set_pallas_mode("auto")
    yield
    jradix.set_pallas_mode("auto")


def _spec(c):
    """A JAX Column as the plain numpy spec snapshot_from_numpy takes."""
    return {"kind": c.dtype.kind.name, "nullable": c.dtype.nullable,
            "prec": c.dtype.prec, "scale": c.dtype.scale, "data": c.data,
            "validity": c.validity,
            "dictionary": None if c.dictionary is None
            else list(c.dictionary.values)}


# ------------------------------------------------------------------ #
# the two queries, built once in each package
# ------------------------------------------------------------------ #

A_COLS = ["l_orderkey", "l_quantity"]
B_COLS = ["l_orderkey", "l_suppkey", "l_quantity", "l_extendedprice"]


def _query(which, P, num_buckets):
    """(agg, key dtypes) of query A or B in package P (the JAX modules
    or the port's, passed as a namespace)."""
    dec2 = P.dt.decimal(15, 2)
    i64 = P.dt.bigint(False)
    if which == "A":
        scan = P.D.TableScan((0, 1), (i64, dec2))
        aggs = (P.D.AggDesc(P.D.AggFunc.SUM, P.Ref(dec2, 1), P.sum_t(dec2)),
                P.D.AggDesc(P.D.AggFunc.COUNT, None, i64))
        return P.D.Aggregation(scan, (P.Ref(i64, 0),), aggs,
                               P.D.GroupStrategy.SCATTER,
                               num_buckets=num_buckets), [i64]
    scan = P.D.TableScan((0, 1, 2, 3), (i64, i64, dec2, dec2))
    cond = P.b.compare("lt", P.Ref(dec2, 2), P.b.lit(45))
    aggs = (P.D.AggDesc(P.D.AggFunc.MAX, P.Ref(dec2, 3),
                        dec2.with_nullable(True)),)
    return P.D.Aggregation(P.D.Selection(scan, (cond,)),
                           (P.Ref(i64, 0), P.Ref(i64, 1)), aggs,
                           P.D.GroupStrategy.SCATTER,
                           num_buckets=num_buckets), [i64, i64]


class _JaxNS:
    D, dt, b, Ref, sum_t = JD, jdt, jb, JRef, staticmethod(j_sum_t)


class _PortNS:
    D, dt, b, Ref, sum_t = D, dt, b, ColumnRef, staticmethod(sum_out_dtype)


@pytest.fixture(scope="module")
def lineitem():
    names, cols = j_gen_lineitem(SF, seed=0, columns=B_COLS)
    return dict(zip(names, cols))


def _snaps(lineitem, names):
    cols = [lineitem[n] for n in names]
    return (j_snapshot(names, cols),
            snapshot_from_numpy(names, [_spec(c) for c in cols]))


def _jax_run(agg, jsnap, key_types):
    prog = get_sharded_program(agg, get_mesh())
    cols, counts = jsnap.device_cols(get_mesh())
    states = jax.device_get(prog(cols, counts))
    per_dev = [jax.tree_util.tree_map(lambda a, d=d: np.asarray(a)[d],
                                      states) for d in range(N_DEV)]
    merged = j_merge(agg, per_dev)
    return j_finalize(agg, merged, [JMeta(t, 0) for t in key_types])


def _as_map(key_cols, agg_cols):
    out = {}
    for i in range(len(agg_cols[0])):
        key = tuple(int(k.data[i]) if k.validity[i] else None
                    for k in key_cols)
        out[key] = tuple(int(c.data[i]) if c.validity[i] else None
                         for c in agg_cols)
    return out


def _oracle(which, li):
    ok = li["l_orderkey"].data
    qty = li["l_quantity"].data
    if which == "A":
        u, inv = np.unique(ok, return_inverse=True)
        s = np.zeros(len(u), object)
        np.add.at(s, inv, qty.astype(object))
        c = np.bincount(inv)
        return {(int(k),): (int(x), int(y)) for k, x, y in zip(u, s, c)}
    keep = qty < 4500
    keys = np.stack([ok[keep], li["l_suppkey"].data[keep]], axis=1)
    u, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    mx = np.full(len(u), np.iinfo(np.int64).min)
    np.maximum.at(mx, inv, li["l_extendedprice"].data[keep])
    return {(int(k[0]), int(k[1])): (int(m),) for k, m in zip(u, mx)}


_PORT_RESULTS: dict = {}


def _port_result(which, lineitem):
    """The port's answer, run once per query: CopClient on 8 logical CPU
    devices, starting from 1024 buckets so the regrow loop runs."""
    if which not in _PORT_RESULTS:
        _jsnap, snap = _snaps(lineitem, A_COLS if which == "A" else B_COLS)
        agg, key_types = _query(which, _PortNS, 1024)
        client = CopClient(device="cpu", n_devices=N_DEV)
        res = client.execute_agg(agg, snap,
                                 [GroupKeyMeta(t, 0) for t in key_types])
        _PORT_RESULTS[which] = (_as_map(res.key_columns, res.columns),
                                dict(client.timings), res)
    return _PORT_RESULTS[which]


# ------------------------------------------------------------------ #
# data carried across
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("seed", [0, 5])
def test_gen_lineitem_equals_jax(seed):
    jn, jc = j_gen_lineitem(0.002, seed=seed)
    n, c = gen_lineitem(0.002, seed=seed)
    assert n == jn
    for name, a, b_ in zip(n, c, jc):
        assert a.dtype.kind.name == b_.dtype.kind.name, name
        assert (a.dtype.prec, a.dtype.scale, a.dtype.nullable) == \
            (b_.dtype.prec, b_.dtype.scale, b_.dtype.nullable), name
        assert a.data.dtype == b_.data.dtype, name
        assert (a.data == b_.data).all(), name
        assert (a.validity == b_.validity).all(), name
        assert (a.dictionary is None) == (b_.dictionary is None), name
        if a.dictionary is not None:
            assert a.dictionary.values == b_.dictionary.values, name


def test_snapshot_from_numpy_keeps_the_stacked_layout(lineitem):
    jsnap, snap = _snaps(lineitem, B_COLS)
    jcols, jcounts = jsnap.device_cols(get_mesh())
    cols, counts = snap.device_cols(CPU8)
    assert (counts.numpy() == np.asarray(jcounts)).all()
    for (jv, jm), (v, m) in zip(jcols, cols):
        assert v.numpy().dtype == np.asarray(jv).dtype  # narrow widths
        assert (v.numpy() == np.asarray(jv)).all()
        assert (jm is None) == (m is None)


# ------------------------------------------------------------------ #
# the device program: per-device states bit for bit
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("which", ["A", "B"])
def test_per_device_states_equal_jax(lineitem, which, mode):
    """Each of the 8 devices' raw state table (keys, limbs, counts,
    max, __ngroups__) equals the JAX program's."""
    _assert_states_equal_jax(lineitem, which, mode)


def _tiled_partition(bid, bits, n):
    """The CUDA kernel path's partition with each key-carrying pass
    computed as the kernels compute it: the plain histogram and scatter
    at KERNEL_TILE, chained through the exclusive offsets."""
    key, idx = bid, torch.arange(n, dtype=torch.int32)
    for p in range(-(-bits // D.RADIX_BITS)):
        shift = p * D.RADIX_BITS
        offs = rk.exclusive_offsets(rk.radix_hist_plain(key, shift))
        key, idx = rk.radix_scatter_plain(key, idx, offs, shift)
    return idx


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("which", ["A", "B"])
def test_per_device_states_through_tiled_kernels_equal_jax(
        lineitem, which, mode, monkeypatch):
    """The same states with the partition routed through the kernels'
    arithmetic at their own tile, as the GPU runs it."""
    calls = []

    def partition(bid, bits, n):
        calls.append(n)
        return _tiled_partition(bid, bits, n)
    monkeypatch.setattr(radix, "_partition_plain", partition)
    _assert_states_equal_jax(lineitem, which, mode)
    assert len(calls) == N_DEV


def _assert_states_equal_jax(lineitem, which, mode):
    jsnap, snap = _snaps(lineitem, A_COLS if which == "A" else B_COLS)
    jagg, _ = _query(which, _JaxNS, 8192)
    agg, _ = _query(which, _PortNS, 8192)
    jradix.set_pallas_mode(mode)
    jcols, jcounts = jsnap.device_cols(get_mesh())
    want = jax.device_get(get_sharded_program(jagg, get_mesh())(jcols,
                                                                jcounts))
    cols, counts = snap.device_cols(CPU8)
    got = ShardedCopProgram(agg, CPU8)(cols, counts)

    def leaves(tree, prefix=""):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + ".")
            else:
                yield prefix + k, v
    want_l, got_l = dict(leaves(want)), dict(leaves(got))
    assert sorted(want_l) == sorted(got_l)
    for name, w in want_l.items():
        g = got_l[name].numpy()
        assert g.shape == np.asarray(w).shape, name
        assert (g == np.asarray(w)).all(), name
    assert (np.asarray(want_l["__ngroups__"]) > 1000).all()


# ------------------------------------------------------------------ #
# the client end to end
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("which", ["A", "B"])
def test_execute_agg_equals_jax_and_oracle(lineitem, which, mode):
    got, timings, _res = _port_result(which, lineitem)
    jsnap, _snap = _snaps(lineitem, A_COLS if which == "A" else B_COLS)
    jagg, key_types = _query(which, _JaxNS, 8192)
    jradix.set_pallas_mode(mode)
    want = _as_map(*_jax_run(jagg, jsnap, key_types))
    assert got == want
    assert got == _oracle(which, lineitem)
    assert len(timings["buckets"]) >= 2      # regrown from 1024 buckets
    assert timings["buckets"][-1] > 1024


def test_result_columns_have_the_jax_types(lineitem):
    _got, _t, res = _port_result("A", lineitem)
    jsnap, _snap = _snaps(lineitem, A_COLS)
    jagg, key_types = _query("A", _JaxNS, 8192)
    jkeys, jaggs = _jax_run(jagg, jsnap, key_types)
    for a, j in zip(res.key_columns + res.columns, jkeys + jaggs):
        assert a.data.dtype == j.data.dtype
        assert (a.dtype.kind.name, a.dtype.prec, a.dtype.scale) == \
            (j.dtype.kind.name, j.dtype.prec, j.dtype.scale)


def _null_multikey_data():
    rng = np.random.default_rng(13)
    n = 20_000
    a = rng.integers(0, 3000, n)
    av = rng.random(n) < 0.9             # ~10% NULL keys
    bk = rng.integers(-5, 5, n)
    v = rng.integers(-1000, 1000, n)
    vv = rng.random(n) < 0.95            # NULL values too
    return a, av, bk, v, vv


def test_null_and_multicolumn_keys():
    """NULL keys form their own group; COUNT(v) skips NULL values;
    SUM/MIN/MAX over nullable values — port == JAX == python oracle."""
    a, av, bk, v, vv = _null_multikey_data()
    n = len(a)
    results = []
    for P in (_JaxNS, _PortNS):
        i64 = P.dt.bigint(False)
        ni64 = P.dt.bigint()
        scan = P.D.TableScan((0, 1, 2), (ni64, i64, ni64))
        vref = P.Ref(ni64, 2)
        aggs = (P.D.AggDesc(P.D.AggFunc.COUNT, vref, i64),
                P.D.AggDesc(P.D.AggFunc.SUM, vref, P.sum_t(vref.dtype)),
                P.D.AggDesc(P.D.AggFunc.MIN, vref, ni64),
                P.D.AggDesc(P.D.AggFunc.MAX, vref, ni64))
        agg = P.D.Aggregation(scan, (P.Ref(ni64, 0), P.Ref(i64, 1)), aggs,
                              P.D.GroupStrategy.SCATTER, num_buckets=1 << 14)
        if P is _JaxNS:
            snap = j_snapshot(["a", "b", "v"], [
                JColumn(ni64, a, av), JColumn(i64, bk, np.ones(n, bool)),
                JColumn(ni64, v, vv)])
            results.append(_as_map(*_jax_run(agg, snap, [ni64, i64])))
        else:
            snap = snapshot_from_numpy(["a", "b", "v"], [
                {"kind": "INT64", "data": a, "validity": av},
                {"kind": "INT64", "nullable": False, "data": bk},
                {"kind": "INT64", "data": v, "validity": vv}])
            res = CopClient("cpu", N_DEV).execute_agg(
                agg, snap, [GroupKeyMeta(ni64, 0), GroupKeyMeta(i64, 0)])
            results.append(_as_map(res.key_columns, res.columns))
    exp: dict = {}
    for i in range(n):
        key = (int(a[i]) if av[i] else None, int(bk[i]))
        c, s, mn, mx = exp.get(key, (0, None, None, None))
        if vv[i]:
            x = int(v[i])
            c, s = c + 1, x if s is None else s + x
            mn = x if mn is None else min(mn, x)
            mx = x if mx is None else max(mx, x)
        exp[key] = (c, s, mn, mx)
    assert results[0] == exp
    assert results[1] == exp
    assert any(k[0] is None for k in exp)


def test_decimal_sum_past_int64():
    """Decimal SUMs whose group totals overflow int64 recombine exactly
    through the (hi, lo) limb states."""
    rng = np.random.default_rng(17)
    n = 20_000
    k = rng.integers(0, 4, n)
    val = rng.integers(1 << 41, (1 << 41) + (1 << 20), n) * 1000
    dec = dt.decimal(18, 2)
    snap = snapshot_from_numpy(["k", "d"], [
        {"kind": "INT64", "nullable": False, "data": k},
        {"kind": "DECIMAL", "prec": 18, "scale": 2, "data": val}])
    agg = D.Aggregation(D.TableScan((0, 1), (dt.bigint(False), dec)),
                        (ColumnRef(dt.bigint(False), 0),),
                        (D.AggDesc(D.AggFunc.SUM, ColumnRef(dec, 1),
                                   sum_out_dtype(dec)),),
                        D.GroupStrategy.SCATTER, num_buckets=1024)
    res = CopClient("cpu", N_DEV).execute_agg(
        agg, snap, [GroupKeyMeta(dt.bigint(False), 0)])
    got = {int(key): int(s) for key, s in zip(res.key_columns[0].data,
                                              res.columns[0].data)}
    exp = {int(u): int(val[k == u].astype(object).sum()) for u in np.unique(k)}
    assert got == exp
    assert max(abs(t) for t in exp.values()) > 2 ** 63


@pytest.mark.parametrize("n_devices", [1, 8])
def test_bucket_regrow_hashes_keys_once(n_devices):
    """All-distinct keys far past 1024 buckets: the client regrows the
    bucket space from __ngroups__, returns every group, and hashes the
    key tuple once (the hoisted hash), not once per re-entry."""
    n = 20_000
    k = np.arange(n) * 7 - 50_000
    snap = snapshot_from_numpy(["k"], [
        {"kind": "INT64", "nullable": False, "data": k}])
    agg = D.Aggregation(D.TableScan((0,), (dt.bigint(False),)),
                        (ColumnRef(dt.bigint(False), 0),),
                        (D.AggDesc(D.AggFunc.COUNT, None, dt.bigint(False)),),
                        D.GroupStrategy.SCATTER, num_buckets=1024)
    client = CopClient("cpu", n_devices)
    before = segment.HASH_CALLS[0]
    res = client.execute_agg(agg, snap, [GroupKeyMeta(dt.bigint(False), 0)])
    assert segment.HASH_CALLS[0] - before == 1
    assert len(client.timings["buckets"]) >= 2
    assert (np.sort(res.key_columns[0].data) == k).all()
    assert (res.columns[0].data == 1).all()


# ------------------------------------------------------------------ #
# the evaluator's Selection lanes
# ------------------------------------------------------------------ #

def _predicates(P):
    dec2 = P.dt.decimal(15, 2)
    a, bb = P.Ref(P.dt.bigint(), 0), P.Ref(P.dt.bigint(), 1)
    q = P.Ref(dec2, 2)
    nar = P.Ref(P.dt.bigint(False), 3)         # an int16 physical column
    c = P.b.compare
    return {
        "a < 5": c("lt", a, P.b.lit(5)),
        "a = b": c("eq", a, bb),
        "a <> b": c("ne", a, bb),
        "q >= 12.5": c("ge", q, P.b.decimal_lit("12.5")),
        "q <= int": c("le", q, P.b.lit(30)),
        "narrow > 100000": c("gt", nar, P.b.lit(100_000)),
        "narrow < -100000": c("lt", nar, P.b.lit(-100_000)),
        "narrow = 7": c("eq", nar, P.b.lit(7)),
        "a < NULL": c("lt", a, P.b.lit(None)),
        "and": P.b.logic("and", c("lt", a, P.b.lit(5)),
                         c("gt", bb, P.b.lit(0))),
        "or isnull": P.b.logic("or", c("lt", a, P.b.lit(-3)),
                               P.b.is_null(bb)),
        "not": P.b.logic("not", c("ge", a, bb)),
        "and NULL": P.b.logic("and", c("lt", a, P.b.lit(0)),
                              c("lt", bb, P.b.lit(None))),
    }


@pytest.mark.parametrize("name", sorted(_predicates(_PortNS)))
def test_selection_predicates_equal_jax(name):
    """MySQL three-valued logic, decimal scale alignment, and narrow
    columns compared against literals past their width (torch would wrap
    the literal) — the rows a Selection keeps, and the NULL mask."""
    rng = np.random.default_rng(31)
    n = 3000
    a = rng.integers(-10, 10, n)
    av = rng.random(n) < 0.8
    bb = rng.integers(-10, 10, n)
    bv = rng.random(n) < 0.8
    q = rng.integers(100, 5000, n)
    nar = rng.integers(-20_000, 20_000, n).astype(np.int16)
    jcols = [(jnp.asarray(a), jnp.asarray(av)), (jnp.asarray(bb),
                                                 jnp.asarray(bv)),
             (jnp.asarray(q), True), (jnp.asarray(nar), True)]
    tcols = [(torch.from_numpy(a), torch.from_numpy(av)),
             (torch.from_numpy(bb), torch.from_numpy(bv)),
             (torch.from_numpy(q), True), (torch.from_numpy(nar), True)]
    jv, jm = JEvaluator(jnp).eval(_predicates(_JaxNS)[name], jcols)
    tv, tm = Evaluator("cpu").eval(_predicates(_PortNS)[name], tcols)

    def keep(v, m, conv):
        v = np.broadcast_to(conv(v) != 0, (n,))
        m = np.ones(n, bool) if m is True else \
            np.broadcast_to(conv(m), (n,)).astype(bool)
        return v & m, m
    jk, jmask = keep(jv, jm, np.asarray)
    tk, tmask = keep(tv, tm, lambda x: x.numpy() if isinstance(
        x, torch.Tensor) else np.asarray(x))
    assert (tk == jk).all() and (tmask == jmask).all()


# ------------------------------------------------------------------ #
# what the slice does not do raises
# ------------------------------------------------------------------ #

def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        CopClient()


def _unported_cases():
    i64, f64, u64 = dt.bigint(False), dt.double(False), dt.ubigint(False)
    count = (D.AggDesc(D.AggFunc.COUNT, None, i64),)
    scan = D.TableScan((0, 1, 2), (i64, f64, u64))
    return {
        # shards over several GPUs arrive with the multi-GPU slice
        "two physical devices": D.Aggregation(
            scan, (), count, D.GroupStrategy.SCALAR, num_buckets=16,
            group_capacity=16),
    }


# the statements that raised before the observability slice (and, for
# the memtable and the index advisor, the coordination slice; for the
# cascades planner, the tools-and-cascades slice; for the resource
# groups, the resource-control slice) ported them, each with a check of
# what it now returns
_PORTED_SQL = {
    "SQL create resource group": (
        """create resource group rg1 ru_per_sec = 100;
           select name, ru_per_sec from information_schema.resource_groups
           where name = 'rg1'""",
        lambda res: res.rows == [("rg1", 100)]),
    "SQL cascades planner": (
        """set tidb_enable_cascades_planner = 1;
           select count(*) from part p join lineitem l
           on p.p_partkey = l.l_partkey""",
        lambda res: res.rows == [(int(np.isin(
            gen_lineitem(0.0005, seed=1)[1][1].data,
            np.arange(1, 41)).sum()),)]),
    "SQL memtable": (
        "select count(*) from information_schema.tables",
        lambda res: res.rows == [(2,)]),
    "SQL admin recommend index": (
        "admin recommend index",
        lambda res: res.names == ["Table", "Columns", "Est_benefit_execs",
                                  "Sample_sql"]),
    "SQL show statements summary": (
        "show statements_summary",
        lambda res: res.names[:2] == ["Digest_text", "Exec_count"]
        and any(r[0] == "select count(*) from part" for r in res.rows)),
    "SQL show slow queries": (
        "show slow_queries",
        lambda res: res.names[-1] == "Trace_id"),
    "SQL show status": (
        "show status",
        lambda res: dict(res.rows)["Queries"] == "0"),
    "SQL explain analyze": (
        "explain analyze select count(*) from part",
        lambda res: res.names == ["operator", "actRows", "time", "loops"]
        and res.rows[-1][1] == 1),
    "SQL trace": (
        "trace select count(*) from part",
        lambda res: [r[0] for r in res.rows][:3] == [
            "session.ExecuteStmt", "  planner.Optimize",
            "  executor.Run"]),
    "SQL plan replayer": (
        "plan replayer dump explain select * from part",
        lambda res: res.rows[0][0].startswith("replayer_")),
}


def _sql_session():
    """A port session on the CPU over a small lineitem and part."""
    from tidb_tpu_torch.chunk.column import Column, StringDict
    from tidb_tpu_torch.testing.tpch import sql_session
    n = 40
    part = (["p_partkey", "p_brand", "p_size"], [
        Column.from_numpy(dt.bigint(False), np.arange(1, n + 1)),
        Column(dt.varchar(False), np.arange(n, dtype=np.int32) % 4,
               np.ones(n, bool),
               StringDict([f"Brand#{i}" for i in range(4)])),
        Column.from_numpy(dt.bigint(False), np.arange(n) % 50)])
    return sql_session({"lineitem": gen_lineitem(0.0005, seed=1),
                        "part": part}, device="cpu", n_devices=8)


@pytest.mark.parametrize("case", sorted(_PORTED_SQL))
def test_ported_observability_statements_answer(case):
    """The statements of the observability slice answer through the
    port's session (tests/test_torch_observability.py holds them
    against the JAX package's, tests/test_torch_cascades.py the
    cascades planner's)."""
    sql, ok = _PORTED_SQL[case]
    sess = _sql_session()
    sess.execute("select count(*) from part")
    res = sess.execute(sql)
    assert ok(res), (sql, res.names, res.rows)


@pytest.mark.parametrize("case", sorted(_unported_cases()))
def test_unported_paths_raise(case):
    """What the slice does not port raises NotImplementedError naming
    the ROADMAP queue that brings it, never a wrong answer: the DAG
    paths through the client (no SQL statement of the JAX session is
    left unported)."""
    snap = snapshot_from_numpy(["k", "f", "u"], [
        {"kind": "INT64", "nullable": False, "data": np.arange(10)},
        {"kind": "FLOAT64", "nullable": False, "data": np.ones(10)},
        {"kind": "UINT64", "nullable": False,
         "data": np.arange(10, dtype=np.uint64)}])
    client = CopClient("cpu")
    client.devices = (torch.device("cpu"), torch.device("meta"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        client.execute_agg(_unported_cases()[case], snap,
                           [GroupKeyMeta(dt.bigint(False), 0)])
