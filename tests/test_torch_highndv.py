"""The port's SORT and SEGMENT group-bys against the JAX package.

The same inputs, made from a seed with numpy (or by the JAX package's
TPC-H generator), go through the port's ``ShardedCopProgram`` on 8
logical CPU devices and through the JAX package's sharded program on its
8-device CPU mesh (``get_sharded_program``, called directly: the JAX
client sends SORT and SEGMENT on a CPU mesh to its host oracle).  Every
per-device state leaf must be equal: integer, decimal and key fields bit
for bit, float SUM fields within ``FLOAT_RTOL``.  The port's client
(``CopClient("cpu", 8).execute_agg``) must equal the JAX client and a
numpy oracle, through at least one regrow.

The corpus statements (tidb_tpu/testing/tpch.py):
    SORT:    select l_orderkey, sum(l_extendedprice) from lineitem
             group by l_orderkey
    SEGMENT: select l_orderkey, l_partkey, count(*), sum(l_quantity)
             from lineitem group by l_orderkey, l_partkey
"""

import jax
import numpy as np
import pytest
import torch

from tidb_tpu.chunk.column import Column as JColumn
from tidb_tpu.copr import dag as JD
from tidb_tpu.copr import exec as jexec
from tidb_tpu.copr.aggregate import GroupKeyMeta as JMeta
from tidb_tpu.copr.aggregate import sum_out_dtype as j_sum_t
from tidb_tpu.expr import builders as jb
from tidb_tpu.expr.compile import Evaluator as JEvaluator
from tidb_tpu.expr.ir import ColumnRef as JRef
from tidb_tpu.parallel.mesh import get_mesh
from tidb_tpu.parallel.spmd import get_sharded_program
from tidb_tpu.store import CopClient as JClient
from tidb_tpu.store import snapshot_from_columns as j_snapshot
from tidb_tpu.testing.tpch import gen_lineitem as j_gen_lineitem
from tidb_tpu.types import dtypes as jdt
from tidb_tpu_torch.copr import aggregate as agg_mod
from tidb_tpu_torch.copr import dag as D
from tidb_tpu_torch.copr import exec as pexec
from tidb_tpu_torch.copr.aggregate import GroupKeyMeta, sum_out_dtype
from tidb_tpu_torch.expr import builders as b
from tidb_tpu_torch.expr.compile import Evaluator
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
FLOAT_RTOL = 1e-12
LI_COLS = ["l_orderkey", "l_partkey", "l_quantity", "l_extendedprice"]


class _JaxNS:
    D, dt, b, Ref, sum_t = JD, jdt, jb, JRef, staticmethod(j_sum_t)
    Meta = JMeta


class _PortNS:
    D, dt, b, Ref, sum_t = D, dt, b, ColumnRef, staticmethod(sum_out_dtype)
    Meta = GroupKeyMeta


def _spec(c):
    """A JAX Column as the plain numpy spec snapshot_from_numpy takes."""
    return {"kind": c.dtype.kind.name, "nullable": c.dtype.nullable,
            "prec": c.dtype.prec, "scale": c.dtype.scale, "data": c.data,
            "validity": c.validity}


def _snaps(names, jcols):
    return (j_snapshot(names, jcols),
            snapshot_from_numpy(names, [_spec(c) for c in jcols]))


@pytest.fixture(scope="module")
def lineitem():
    names, cols = j_gen_lineitem(SF, seed=0, columns=LI_COLS)
    return dict(zip(names, cols))


def _corpus(which, P, cap):
    """(agg, key dtypes) of a corpus statement over the LI_COLS layout in
    package P at state capacity ``cap``."""
    i64, dec2 = P.dt.bigint(False), P.dt.decimal(15, 2)
    scan = P.D.TableScan((0, 1, 2, 3), (i64, i64, dec2, dec2))
    if which == "SORT":
        aggs = (P.D.AggDesc(P.D.AggFunc.SUM, P.Ref(dec2, 3), P.sum_t(dec2)),)
        return P.D.Aggregation(scan, (P.Ref(i64, 0),), aggs,
                               P.D.GroupStrategy.SORT,
                               group_capacity=cap), [i64]
    aggs = (P.D.AggDesc(P.D.AggFunc.COUNT, None, i64),
            P.D.AggDesc(P.D.AggFunc.SUM, P.Ref(dec2, 2), P.sum_t(dec2)))
    return P.D.Aggregation(scan, (P.Ref(i64, 0), P.Ref(i64, 1)), aggs,
                           P.D.GroupStrategy.SEGMENT,
                           num_buckets=cap), [i64, i64]


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _assert_states_equal(jagg, agg, jsnap, snap, float_sums=()):
    """Every device's every state leaf of the port equals the JAX
    program's; returns the JAX leaves."""
    jcols, jcounts = jsnap.device_cols(get_mesh())
    want = dict(_leaves(jax.device_get(
        get_sharded_program(jagg, get_mesh())(jcols, jcounts))))
    cols, counts = snap.device_cols(CPU8)
    got = dict(_leaves(ShardedCopProgram(agg, CPU8)(cols, counts)))
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name in float_sums:
            err = np.abs(g - w)
            assert (err <= FLOAT_RTOL * np.maximum(np.abs(w), 1.0)).all(), \
                name
        elif w.dtype.kind == "f":
            assert (g.view(np.int64) == w.view(np.int64)).all(), name
        else:
            assert (g == w).all(), name
    return want


# ------------------------------------------------------------------ #
# per-device states
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("cap", [4096, 256])
@pytest.mark.parametrize("which", ["SORT", "SEGMENT"])
def test_corpus_states_equal_jax(lineitem, which, cap):
    """The two corpus statements' per-device states, at a capacity that
    holds every group and at one that overflows (live rows of the groups
    past the table park in the sink, ``__ngroups__`` exceeds it)."""
    jsnap, snap = _snaps(LI_COLS, [lineitem[c] for c in LI_COLS])
    jagg, _ = _corpus(which, _JaxNS, cap)
    agg, _ = _corpus(which, _PortNS, cap)
    want = _assert_states_equal(jagg, agg, jsnap, snap)
    ng = np.asarray(want["__ngroups__"])
    assert (ng > 500).all()
    assert (ng > cap).all() == (cap == 256)


def _mixed_keys(n, seed):
    """Nullable int keys, a DOUBLE key with -0.0, +0.0 and NaN, a BIGINT
    UNSIGNED key past 2^63, and values."""
    rng = np.random.default_rng(seed)
    ik = rng.integers(-50, 50, n)
    ikv = rng.random(n) < 0.85
    fk = rng.choice(np.array([-0.0, 0.0, np.nan, -1.5, 2.25, np.inf,
                              -np.inf, 1e300]), n)
    fkv = rng.random(n) < 0.9
    uk = rng.choice(np.array([0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 63 + 1,
                              2 ** 64 - 1], dtype=np.uint64), n)
    ukv = rng.random(n) < 0.9
    v = rng.integers(-10 ** 6, 10 ** 6, n)
    fv = rng.standard_normal(n) * 1e3
    return [(ik, ikv), (fk, fkv), (uk, ukv), (v, None), (fv, None)]


MIXED_KINDS = ["INT64", "FLOAT64", "UINT64", "INT64", "FLOAT64"]


def _mixed_snaps(n, seed):
    data = _mixed_keys(n, seed)
    names = ["ik", "fk", "uk", "v", "fv"]
    jcols = []
    for kind, (d, valid) in zip(MIXED_KINDS, data):
        t = jdt.DataType(jdt.TypeKind[kind], valid is not None)
        jcols.append(JColumn.from_numpy(t, d, valid))
    return _snaps(names, jcols), data


def _mixed_agg(P, keys, strategy, cap):
    """Group by the named keys of the mixed layout; COUNT(*), SUM(v),
    MIN(fv), MAX(v) and SUM(fv)."""
    types = [P.dt.DataType(P.dt.TypeKind[k], nullable)
             for k, nullable in zip(MIXED_KINDS,
                                    (True, True, True, False, False))]
    scan = P.D.TableScan(tuple(range(5)), tuple(types))
    ref = {n: P.Ref(types[i], i) for i, n in
           enumerate(["ik", "fk", "uk", "v", "fv"])}
    aggs = (P.D.AggDesc(P.D.AggFunc.COUNT, None, P.dt.bigint(False)),
            P.D.AggDesc(P.D.AggFunc.SUM, ref["v"], P.sum_t(types[3])),
            P.D.AggDesc(P.D.AggFunc.MIN, ref["fv"], types[4]),
            P.D.AggDesc(P.D.AggFunc.MAX, ref["v"], types[3]),
            P.D.AggDesc(P.D.AggFunc.SUM, ref["fv"], P.sum_t(types[4])))
    return P.D.Aggregation(
        scan, tuple(ref[k] for k in keys), aggs,
        P.D.GroupStrategy[strategy], group_capacity=cap,
        num_buckets=cap), [types[["ik", "fk", "uk"].index(k)] for k in keys]


KEY_SETS = {"nullable int": ("ik",), "float": ("fk",),
            "unsigned": ("uk",), "all three": ("ik", "fk", "uk")}


@pytest.mark.parametrize("strategy", ["SORT", "SEGMENT"])
@pytest.mark.parametrize("keys", sorted(KEY_SETS))
def test_mixed_key_states_equal_jax(keys, strategy):
    """NULL keys, a DOUBLE key with -0.0, +0.0 and NaN, and a BIGINT
    UNSIGNED key past 2^63: every per-device state equals the JAX
    program's (float sums within FLOAT_RTOL)."""
    (jsnap, snap), _ = _mixed_snaps(6000, 5)
    jagg, _ = _mixed_agg(_JaxNS, KEY_SETS[keys], strategy, 1024)
    agg, _ = _mixed_agg(_PortNS, KEY_SETS[keys], strategy, 1024)
    _assert_states_equal(jagg, agg, jsnap, snap, float_sums=("a4.sum",))


# ------------------------------------------------------------------ #
# the client
# ------------------------------------------------------------------ #

def _norm(x):
    """A hashable, NaN-equal, -0.0 == +0.0 form of one cell."""
    if x is None:
        return None
    if isinstance(x, (float, np.floating)):
        return "nan" if np.isnan(x) else float(x) + 0.0
    return int(x)


def _as_map(key_cols, agg_cols, float_aggs=()):
    out = {}
    for i in range(len(agg_cols[0].data)):
        key = tuple(_norm(k.data[i]) if k.validity[i] else None
                    for k in key_cols)
        out[key] = tuple(
            (round(float(c.data[i]), 6) if j in float_aggs
             else _norm(c.data[i])) if c.validity[i] else None
            for j, c in enumerate(agg_cols))
    assert len(out) == len(agg_cols[0].data)
    return out


def _corpus_oracle(which, li):
    ok, pk = li["l_orderkey"].data, li["l_partkey"].data
    if which == "SORT":
        out = {}
        for k, p in zip(ok, li["l_extendedprice"].data):
            out[(int(k),)] = out.get((int(k),), 0) + int(p)
        return {k: (v,) for k, v in out.items()}
    out = {}
    for k, p, q in zip(ok, pk, li["l_quantity"].data):
        c, s = out.get((int(k), int(p)), (0, 0))
        out[(int(k), int(p))] = (c + 1, s + int(q))
    return out


@pytest.mark.parametrize("which", ["SORT", "SEGMENT"])
def test_corpus_execute_agg_equals_jax_and_oracle(lineitem, which):
    """From a 256-group table the client regrows, and the merged result
    equals the JAX client's and a numpy oracle."""
    jsnap, snap = _snaps(LI_COLS, [lineitem[c] for c in LI_COLS])
    jagg, jtypes = _corpus(which, _JaxNS, 256)
    agg, types = _corpus(which, _PortNS, 256)
    client = CopClient("cpu", N_DEV)
    res = client.execute_agg(agg, snap, [GroupKeyMeta(t, 0) for t in types])
    jres = _jclient().execute_agg(
        jagg, jsnap, [JMeta(t, 0) for t in jtypes])
    got = _as_map(res.key_columns, res.columns)
    assert got == _as_map(jres.key_columns, jres.columns)
    assert got == _corpus_oracle(which, lineitem)
    caps = client.timings["buckets"]
    assert caps[0] == 256 and len(caps) >= 2 and caps[-1] > 256
    for c, j in zip(res.key_columns + res.columns,
                    jres.key_columns + jres.columns):
        assert c.data.dtype == j.data.dtype


def _mixed_oracle(data, keys):
    cols = dict(zip(["ik", "fk", "uk", "v", "fv"], data))
    n = len(data[0][0])
    out = {}
    for i in range(n):
        key = tuple(_norm(cols[k][0][i]) if cols[k][1][i] else None
                    for k in keys)
        c, s, mn, mx, fs = out.get(key, (0, 0, np.inf, None, 0.0))
        v, fv = int(cols["v"][0][i]), float(cols["fv"][0][i])
        out[key] = (c + 1, s + v, min(mn, fv),
                    v if mx is None else max(mx, v), fs + fv)
    return {k: (c, s, round(mn, 6), mx, round(fs, 6))
            for k, (c, s, mn, mx, fs) in out.items()}


@pytest.mark.parametrize("strategy", ["SORT", "SEGMENT"])
@pytest.mark.parametrize("keys", sorted(KEY_SETS))
def test_mixed_execute_agg_equals_jax_and_oracle(keys, strategy):
    """Float keys (-0.0 groups with +0.0, NaN with NaN), unsigned keys
    past 2^63 and NULL keys decode through the host merge and finalize
    as the JAX client's do."""
    (jsnap, snap), data = _mixed_snaps(6000, 5)
    jagg, jtypes = _mixed_agg(_JaxNS, KEY_SETS[keys], strategy, 16)
    agg, types = _mixed_agg(_PortNS, KEY_SETS[keys], strategy, 16)
    client = CopClient("cpu", N_DEV)
    res = client.execute_agg(agg, snap, [GroupKeyMeta(t, 0) for t in types])
    jres = _jclient().execute_agg(
        jagg, jsnap, [JMeta(t, 0) for t in jtypes])
    floats = (2, 4)
    got = _as_map(res.key_columns, res.columns, floats)
    assert got == _as_map(jres.key_columns, jres.columns, floats)
    assert got == _mixed_oracle(data, KEY_SETS[keys])
    for c, j in zip(res.key_columns, jres.key_columns):
        assert c.data.dtype == j.data.dtype
    if keys == "float":
        assert set(got) == {(None,), (0.0,), ("nan",), (-1.5,), (2.25,),
                            (np.inf,), (-np.inf,), (1e300,)}


# ------------------------------------------------------------------ #
# the three faults this slice fixes, each pinned
# ------------------------------------------------------------------ #

def test_with_capacity_sizes_each_strategys_table():
    """SORT regrows ``group_capacity``, SEGMENT and SCATTER
    ``num_buckets``, each to a power of two."""
    i64 = dt.bigint(False)
    scan = D.TableScan((0,), (i64,))
    for strategy, field in (("SORT", "group_capacity"),
                            ("SEGMENT", "num_buckets"),
                            ("SCATTER", "num_buckets")):
        agg = D.Aggregation(scan, (ColumnRef(i64, 0),), (),
                            D.GroupStrategy[strategy])
        sized = CopClient._with_capacity(agg, 5000)
        assert getattr(sized, field) == 8192
        assert sized.state_capacity == 8192


def test_sort_regrow_returns_every_group():
    """All-distinct keys from a 16-group SORT table: the regrow compares
    the observed groups with the SORT table, not the bucket space."""
    n = 5000
    k = np.arange(n) * 3 - 7000
    snap = snapshot_from_numpy(["k"], [
        {"kind": "INT64", "nullable": False, "data": k}])
    agg = D.Aggregation(D.TableScan((0,), (dt.bigint(False),)),
                        (ColumnRef(dt.bigint(False), 0),),
                        (D.AggDesc(D.AggFunc.COUNT, None, dt.bigint(False)),),
                        D.GroupStrategy.SORT, group_capacity=16)
    client = CopClient("cpu", 4)
    before = S.PASSES["stable_argsort"]
    res = client.execute_agg(agg, snap, [GroupKeyMeta(dt.bigint(False), 0)])
    assert client.timings["buckets"] == [16, 2048]
    assert S.PASSES["stable_argsort"] > before
    assert (np.sort(res.key_columns[0].data) == k).all()
    assert (res.columns[0].data == 1).all()


def test_group_keyinfo_folds_negative_zero():
    """A DOUBLE key's -0.0 takes +0.0's value and code, as the JAX
    package's group_keyinfo gives them; NaN keeps its own."""
    import jax.numpy as jnp
    f = np.array([-0.0, 0.0, np.nan, -2.5, 3.0])
    t, jt = dt.double(False), jdt.double(False)
    agg = D.Aggregation(D.TableScan((0,), (t,)), (ColumnRef(t, 0),), (),
                        D.GroupStrategy.SORT, group_capacity=8)
    jagg = JD.Aggregation(JD.TableScan((0,), (jt,)), (JRef(jt, 0),), (),
                          JD.GroupStrategy.SORT, group_capacity=8)
    (vz, _m, _nf, code), = pexec.group_keyinfo(
        agg, pexec.DeviceBatch([(torch.from_numpy(f), True)], True),
        Evaluator("cpu"), {}, len(f))
    (jvz, _jm, _jnf, jcode), = jexec.group_keyinfo(
        jagg, jexec.DeviceBatch([(jnp.asarray(f), True)], True),
        JEvaluator(jnp), {}, len(f))
    assert (code.numpy() == np.asarray(jcode)).all()
    assert (vz.numpy().view(np.int64) == np.asarray(jvz).view(np.int64)).all()
    assert code[0] == code[1] == 0 and not np.signbit(vz.numpy()[0])


def test_np_key_code_groups_floats_as_sql():
    """The host merge's key code: -0.0 equals +0.0, NaN equals NaN, the
    order of the finite values kept; NULL lanes zeroed."""
    f = np.array([-0.0, 0.0, np.nan, np.nan, -1.0, 1.0, 7.0])
    valid = np.array([True] * 6 + [False])
    code = agg_mod._np_key_code(f, valid, dt.double())
    assert code[0] == code[1] == 0
    assert code[2] == code[3]
    assert code[4] < code[0] < code[5]
    assert code[6] == 0
    u = np.array([2 ** 63, 2 ** 63, 5], dtype=np.uint64)
    ucode = agg_mod._np_key_code(u, np.ones(3, bool), dt.ubigint())
    assert ucode[0] == ucode[1] != ucode[2]


@pytest.mark.parametrize("strategy", ["SORT", "SEGMENT", "SCATTER"])
def test_one_reduce_call_per_state_table(strategy, monkeypatch):
    """The segment reduce that SORT, SEGMENT and SCATTER share
    (``states_from_partition``) reduces every lane of a device's table
    in one ``group_reduce_lanes`` call (one kernel launch on the card):
    ``__rows__`` (COUNT(*) too), SUM(v)'s (hi, lo) limbs, MIN(fv),
    MAX(v) and SUM(fv), six lanes, where one-lane launches took eight
    reductions."""
    from tidb_tpu_torch.copr import exec as pexec
    from tidb_tpu_torch.copr.cuda import group_reduce as gr
    calls = []
    real = pexec.group_reduce_lanes

    def counted(gids, G, lanes):
        calls.append((G, len(gr.unique_lanes(lanes))))
        return real(gids, G, lanes)
    monkeypatch.setattr(pexec, "group_reduce_lanes", counted)
    (_jsnap, snap), _ = _mixed_snaps(6000, 5)
    agg, _ = _mixed_agg(_PortNS, KEY_SETS["all three"], strategy, 1024)
    cols, counts = snap.device_cols(CPU8)
    ShardedCopProgram(agg, CPU8)(cols, counts)
    assert calls == [(1024, 6)] * N_DEV
