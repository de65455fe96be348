"""The port's DENSE/SCALAR main path against the JAX package.

TPC-H Q1, Q6 and Q19, and DENSE variants (a nullable key, MIN/MAX over a
narrow column, a float64 SUM, a proven-narrow SUM, a Projection), are
built in both packages over the same data: the JAX generator's lineitem,
carried into the port with ``snapshot_from_numpy``.  For each:

- the port's merged device states (``ShardedCopProgram`` on 8 logical
  CPU devices, the partial states merged as the devices' psum merges
  them) equal the JAX package's sharded program on its 8-device CPU mesh
  (``get_sharded_program``): integer and decimal fields bit for bit,
  float fields within ``FLOAT_RTOL``;
- the finalized result of ``CopClient(device="cpu").execute_agg`` equals
  the JAX package's ``CopClient.execute_agg`` and a numpy oracle.

Float sums are taken in another order by each side (psum against a
stacked sum, a scatter-add against ``index_add_``), so their fields get
a relative tolerance of ``FLOAT_RTOL``; every other field is exact.

The evaluator's new lanes (arithmetic over narrow physical columns, IN,
BETWEEN, IF/CASE/COALESCE, DOUBLE operands) are held against the JAX
``Evaluator(jnp)`` on the same columns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.copr import dag as JD
from tidb_tpu.copr.aggregate import GroupKeyMeta as JMeta
from tidb_tpu.copr.aggregate import sum_out_dtype as j_sum_t
from tidb_tpu.expr import builders as jb
from tidb_tpu.expr.compile import Evaluator as JEvaluator
from tidb_tpu.expr.ir import ColumnRef as JRef
from tidb_tpu.expr.ir import Const as JConst
from tidb_tpu.expr.ir import Func as JFunc
from tidb_tpu.parallel.mesh import get_mesh
from tidb_tpu.parallel.spmd import get_sharded_program
from tidb_tpu.store import CopClient as JClient
from tidb_tpu.store import snapshot_from_columns as j_snapshot
from tidb_tpu.chunk.column import Column as JColumn
from tidb_tpu.testing.tpch import gen_lineitem as j_gen_lineitem
from tidb_tpu.types import dtypes as jdt
from tidb_tpu_torch.chunk.column import StringDict
from tidb_tpu_torch.copr import dag as D
from tidb_tpu_torch.copr.aggregate import GroupKeyMeta, sum_out_dtype
from tidb_tpu_torch.expr import builders as b
from tidb_tpu_torch.expr.compile import Evaluator
from tidb_tpu_torch.expr.ir import ColumnRef, Const, Func
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


SF = 0.002                       # 12,000 lineitem rows
N_DEV = 8
CPU8 = (torch.device("cpu"),) * N_DEV
FLOAT_RTOL = 1e-12

Q_COLS = ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
          "l_returnflag", "l_linestatus", "l_shipdate", "l_shipinstruct",
          "l_shipmode"]


class _JaxNS:
    D, dt, b, Ref, Const, Func, sum_t, Meta = (
        JD, jdt, jb, JRef, JConst, JFunc, staticmethod(j_sum_t), JMeta)


class _PortNS:
    D, dt, b, Ref, Const, Func, sum_t, Meta = (
        D, dt, b, ColumnRef, Const, Func, staticmethod(sum_out_dtype),
        GroupKeyMeta)


def _spec(c):
    """A JAX Column as the plain numpy spec snapshot_from_numpy takes."""
    return {"kind": c.dtype.kind.name, "nullable": c.dtype.nullable,
            "prec": c.dtype.prec, "scale": c.dtype.scale, "data": c.data,
            "validity": c.validity,
            "dictionary": None if c.dictionary is None
            else list(c.dictionary.values)}


@pytest.fixture(scope="module")
def lineitem():
    names, cols = j_gen_lineitem(SF, seed=0, columns=Q_COLS)
    return names, cols


def _snaps(names, cols):
    return (j_snapshot(names, cols),
            snapshot_from_numpy(names, [_spec(c) for c in cols]))


# ------------------------------------------------------------------ #
# the queries, built once in each package
# ------------------------------------------------------------------ #

def _ref(P, names, cols):
    ix = {n: i for i, n in enumerate(names)}

    def r(n):
        t = cols[ix[n]].dtype
        return P.Ref(P.dt.DataType(P.dt.TypeKind[t.kind.name], t.nullable,
                                   t.prec, t.scale), ix[n], n)
    scan = P.D.TableScan(tuple(range(len(names))),
                         tuple(r(n).dtype for n in names))
    return r, scan, ix


def _q1(P, names, cols):
    """TPC-H Q1 as __graft_entry__._q1_dag builds it."""
    r, scan, ix = _ref(P, names, cols)
    sel = P.D.Selection(scan, (P.b.compare(
        "le", r("l_shipdate"), P.b.lit("1998-09-02", P.dt.date())),))
    one = P.b.lit(1)
    disc_price = P.b.arith("mul", r("l_extendedprice"),
                           P.b.arith("sub", one, r("l_discount")))
    charge = P.b.arith("mul", disc_price, P.b.arith("add", one, r("l_tax")))
    nf = len(cols[ix["l_returnflag"]].dictionary)
    ns = len(cols[ix["l_linestatus"]].dictionary)
    aggs = (P.D.AggDesc(P.D.AggFunc.SUM, r("l_quantity"),
                        P.sum_t(r("l_quantity").dtype)),
            P.D.AggDesc(P.D.AggFunc.SUM, r("l_extendedprice"),
                        P.sum_t(r("l_extendedprice").dtype)),
            P.D.AggDesc(P.D.AggFunc.SUM, disc_price,
                        P.sum_t(disc_price.dtype)),
            P.D.AggDesc(P.D.AggFunc.SUM, charge, P.sum_t(charge.dtype)),
            P.D.AggDesc(P.D.AggFunc.COUNT, None, P.dt.bigint(False)))
    return P.D.Aggregation(sel, (r("l_returnflag"), r("l_linestatus")),
                           aggs, P.D.GroupStrategy.DENSE,
                           domain_sizes=(nf + 1, ns + 1))


def _q6(P, names, cols):
    """TPC-H Q6 as bench._q6_dag builds it."""
    r, scan, _ix = _ref(P, names, cols)
    sel = P.D.Selection(scan, (
        P.b.compare("ge", r("l_shipdate"), P.b.lit("1994-01-01",
                                                    P.dt.date())),
        P.b.compare("lt", r("l_shipdate"), P.b.lit("1995-01-01",
                                                    P.dt.date())),
        P.b.between(r("l_discount"), P.b.decimal_lit("0.05"),
                    P.b.decimal_lit("0.07")),
        P.b.compare("lt", r("l_quantity"), P.b.decimal_lit("24"))))
    rev = P.b.arith("mul", r("l_extendedprice"), r("l_discount"))
    return P.D.Aggregation(sel, (), (
        P.D.AggDesc(P.D.AggFunc.SUM, rev, P.sum_t(rev.dtype)),
        P.D.AggDesc(P.D.AggFunc.COUNT, None, P.dt.bigint(False))),
        P.D.GroupStrategy.SCALAR)


def _q19_codes(names, cols):
    ix = {n: i for i, n in enumerate(names)}
    md = cols[ix["l_shipmode"]].dictionary
    sd = cols[ix["l_shipinstruct"]].dictionary
    return ([md.code_of(m) for m in ("AIR", "REG AIR", "FOB", "MAIL",
                                     "SHIP", "TRUCK")],
            sd.code_of("DELIVER IN PERSON"))


def _q19(P, names, cols):
    """TPC-H Q19 as bench._q19_dag builds it."""
    r, scan, _ix = _ref(P, names, cols)
    (air, regair, fob, mail, ship_, truck), dip = _q19_codes(names, cols)
    sc = lambda c: P.Const(r("l_shipmode").dtype, c)
    qty = r("l_quantity")

    def clause(qlo, qhi, modes):
        return P.b.logic(
            "and", P.b.logic("and",
                             P.b.between(qty, P.b.decimal_lit(str(qlo)),
                                         P.b.decimal_lit(str(qhi))),
                             P.b.in_list(r("l_shipmode"),
                                         [sc(m) for m in modes])),
            P.b.compare("eq", r("l_shipinstruct"),
                        P.Const(r("l_shipinstruct").dtype, dip)))
    pred = P.b.logic("or", P.b.logic("or", clause(1, 11, (air, regair)),
                                     clause(10, 20, (fob, mail))),
                     clause(20, 30, (ship_, truck)))
    rev = P.b.arith("mul", r("l_extendedprice"),
                    P.b.arith("sub", P.b.decimal_lit("1"), r("l_discount")))
    return P.D.Aggregation(P.D.Selection(scan, (pred,)), (), (
        P.D.AggDesc(P.D.AggFunc.SUM, rev, P.sum_t(rev.dtype)),
        P.D.AggDesc(P.D.AggFunc.COUNT, None, P.dt.bigint(False))),
        P.D.GroupStrategy.SCALAR)


def _q1_meta(P, names, cols):
    """Key metas of Q1's two dictionary keys.  The key columns are not
    nullable, so neither are the metas: the dense gid then has no NULL
    slot to decode (a nullable meta would shift every code by one)."""
    ix = {n: i for i, n in enumerate(names)}
    fd = cols[ix["l_returnflag"]].dictionary
    sd = cols[ix["l_linestatus"]].dictionary

    def d(x):
        return x if P is _JaxNS else StringDict(x.values)
    return [P.Meta(P.dt.varchar(False), len(fd) + 1, d(fd)),
            P.Meta(P.dt.varchar(False), len(sd) + 1, d(sd))]


# the DENSE variants run over a synthetic table of their own
def _variant_table():
    rng = np.random.default_rng(23)
    n = 6000
    k = rng.integers(0, 5, n)                  # nullable key, 5 codes
    kv = rng.random(n) < 0.85
    k2 = rng.integers(0, 3, n)                 # second key, 3 codes
    nar = rng.integers(-30_000, 30_000, n)     # int16 physical
    dec = rng.integers(-10 ** 9, 10 ** 9, n)   # DECIMAL(15, 2)
    decv = rng.random(n) < 0.9
    f = rng.normal(0.0, 1e4, n)
    return [
        {"kind": "INT64", "nullable": True, "data": k, "validity": kv},
        {"kind": "INT64", "nullable": False, "data": k2},
        {"kind": "INT64", "nullable": False, "data": nar},
        {"kind": "DECIMAL", "nullable": True, "prec": 15, "scale": 2,
         "data": dec, "validity": decv},
        {"kind": "FLOAT64", "nullable": False, "data": f},
    ]


def _variant(P, which):
    i64, ni64 = P.dt.bigint(False), P.dt.bigint()
    ndec = P.dt.decimal(15, 2)
    f64 = P.dt.double(False)
    scan = P.D.TableScan((0, 1, 2, 3, 4), (ni64, i64, i64, ndec, f64))
    k, k2 = P.Ref(ni64, 0, "k"), P.Ref(i64, 1, "k2")
    nar, dec, f = P.Ref(i64, 2, "nar"), P.Ref(ndec, 3, "dec"), \
        P.Ref(f64, 4, "f")
    A, F = P.D.AggDesc, P.D.AggFunc
    if which == "nullable key":
        return P.D.Aggregation(scan, (k, k2), (
            A(F.SUM, dec, P.sum_t(ndec)), A(F.COUNT, dec, i64),
            A(F.COUNT, None, i64)), P.D.GroupStrategy.DENSE,
            domain_sizes=(6, 3))
    if which == "narrow min/max":
        return P.D.Aggregation(scan, (k2,), (
            A(F.MIN, nar, ni64), A(F.MAX, nar, ni64),
            A(F.MIN, dec, ndec), A(F.MAX, dec, ndec)),
            P.D.GroupStrategy.DENSE, domain_sizes=(3,))
    if which == "float sum":
        return P.D.Aggregation(scan, (k2,), (
            A(F.SUM, f, P.dt.double()), A(F.MIN, f, P.dt.double()),
            A(F.MAX, f, P.dt.double()), A(F.COUNT, None, i64)),
            P.D.GroupStrategy.DENSE, domain_sizes=(3,))
    if which == "narrow sums":
        return P.D.Aggregation(scan, (k2,), (
            A(F.SUM, nar, P.sum_t(i64)), A(F.SUM, dec, P.sum_t(ndec)),
            A(F.COUNT, None, i64)), P.D.GroupStrategy.DENSE,
            domain_sizes=(3,), narrow_sums=(0, 1))
    if which == "projection":
        # a Projection of IF / CASE / COALESCE / arithmetic under SCALAR
        proj = P.D.Projection(P.D.Selection(scan, (P.b.compare(
            "gt", nar, P.b.lit(-20_000)),)), (
            P.b.if_(P.b.compare("lt", k2, P.b.lit(1)), nar,
                    P.b.arith("mul", nar, P.b.lit(4))),
            P.b.case_when([(P.b.compare("eq", k2, P.b.lit(0)), dec),
                           (P.b.compare("eq", k2, P.b.lit(1)),
                            P.b.decimal_lit("1.5"))], None),
            P.b.coalesce(dec, P.b.decimal_lit("-7.25")),
            P.b.arith("add", f, dec),
            P.b.neg(nar)))
        t = [e.dtype for e in proj.exprs]
        c = [P.Ref(t[i], i) for i in range(len(t))]
        return P.D.Aggregation(proj, (), (
            A(F.SUM, c[0], P.sum_t(t[0])), A(F.SUM, c[1], P.sum_t(t[1])),
            A(F.COUNT, c[1], i64), A(F.SUM, c[2], P.sum_t(t[2])),
            A(F.SUM, c[3], P.dt.double()), A(F.MIN, c[4], t[4]),
            A(F.COUNT, None, i64)), P.D.GroupStrategy.SCALAR)
    raise KeyError(which)


VARIANTS = ["nullable key", "narrow min/max", "float sum", "narrow sums",
            "projection"]


def _variant_meta(P, which):
    i64, ni64 = P.dt.bigint(False), P.dt.bigint()
    return {"nullable key": [P.Meta(ni64, 6), P.Meta(i64, 3)],
            "projection": []}.get(which, [P.Meta(i64, 3)])


def _variant_snaps():
    specs = _variant_table()
    names = ["k", "k2", "nar", "dec", "f"]
    jcols = []
    for s in specs:
        t = jdt.DataType(jdt.TypeKind[s["kind"]], s["nullable"],
                         s.get("prec", -1), s.get("scale", -1))
        jcols.append(JColumn.from_numpy(t, s["data"], s.get("validity")))
    return j_snapshot(names, jcols), snapshot_from_numpy(names, specs)


# ------------------------------------------------------------------ #
# the comparison
# ------------------------------------------------------------------ #

def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _assert_states_equal(got, want):
    """The port's merged states against the JAX program's: same names,
    shapes and dtypes; integer fields exact, float within FLOAT_RTOL."""
    got_l = {k: v.numpy() for k, v in _leaves(got)}
    want_l = {k: np.asarray(v) for k, v in _leaves(want)}
    assert sorted(got_l) == sorted(want_l)
    for name, w in want_l.items():
        g = got_l[name]
        assert g.shape == w.shape and g.dtype == w.dtype, \
            (name, g.shape, w.shape, g.dtype, w.dtype)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, err_msg=name)
        else:
            assert (g == w).all(), name


def _result_rows(res):
    """[(keys..., values...)] of a CopResult, each cell a python value or
    None for NULL; floats stay floats."""
    cols = res.key_columns + res.columns
    n = len(cols[0].data) if cols else 0
    out = []
    for i in range(n):
        row = []
        for c in cols:
            if not c.validity[i]:
                row.append(None)
            elif np.asarray(c.data).dtype.kind == "f":
                row.append(float(c.data[i]))
            else:
                row.append(int(c.data[i]))
        out.append(tuple(row))
    return out


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=FLOAT_RTOL), (g, w)
            else:
                assert x == y, (g, w)


def _run_both(jagg, agg, jsnap, snap, jmeta, meta):
    """(port states, JAX states, port rows, JAX rows)."""
    jcols, jcounts = jsnap.device_cols(get_mesh())
    want = jax.device_get(get_sharded_program(jagg, get_mesh())(jcols,
                                                                jcounts))
    cols, counts = snap.device_cols(CPU8)
    got = ShardedCopProgram(agg, CPU8)(cols, counts)
    res = CopClient("cpu", N_DEV).execute_agg(agg, snap, meta)
    jres = _jclient().execute_agg(jagg, jsnap, jmeta)
    return got, want, _result_rows(res), _result_rows(jres)


# ------------------------------------------------------------------ #
# numpy oracles (the predicates of bench.py's np_q1 / np_q6 / np_q19)
# ------------------------------------------------------------------ #

def _exact_sum(x):
    return int(np.asarray(x).astype(object).sum()) if len(x) else 0


def _oracle(which, names, cols):
    c = {n: col.data for n, col in zip(names, cols)}
    qty, price = c["l_quantity"], c["l_extendedprice"]
    disc, tax = c["l_discount"], c["l_tax"]
    ship = c["l_shipdate"]
    if which == "Q1":
        keep = ship <= 10471                     # 1998-09-02
        rows = []
        for f in range(3):
            for s in range(2):
                m = keep & (c["l_returnflag"] == f) & (c["l_linestatus"] == s)
                if not m.any():
                    continue
                dp = price[m].astype(object) * (100 - disc[m])
                ch = dp * (100 + tax[m])
                rows.append((f, s, _exact_sum(qty[m]), _exact_sum(price[m]),
                             int(dp.sum()), int(ch.sum()), int(m.sum())))
        return rows
    if which == "Q6":
        m = ((ship >= 8766) & (ship < 9131) & (disc >= 5) & (disc <= 7)
             & (qty < 2400))
        return [(_exact_sum(price[m].astype(object) * disc[m]),
                 int(m.sum()))]
    (air, regair, fob, mail, ship_, truck), dip = _q19_codes(names, cols)
    mode, inst = c["l_shipmode"], c["l_shipinstruct"]
    c1 = (qty >= 100) & (qty <= 1100) & ((mode == air) | (mode == regair))
    c2 = (qty >= 1000) & (qty <= 2000) & ((mode == fob) | (mode == mail))
    c3 = (qty >= 2000) & (qty <= 3000) & ((mode == ship_) | (mode == truck))
    m = (c1 | c2 | c3) & (inst == dip)
    return [(_exact_sum(price[m].astype(object) * (100 - disc[m])),
             int(m.sum()))]


_TPCH = {"Q1": _q1, "Q6": _q6, "Q19": _q19}


@pytest.mark.parametrize("which", ["Q1", "Q6", "Q19"])
def test_tpch_states_and_results_equal_jax_and_oracle(lineitem, which):
    names, cols = lineitem
    jsnap, snap = _snaps(names, cols)
    build = _TPCH[which]
    jagg, agg = build(_JaxNS, names, cols), build(_PortNS, names, cols)
    meta = _q1_meta(_PortNS, names, cols) if which == "Q1" else []
    jmeta = _q1_meta(_JaxNS, names, cols) if which == "Q1" else []
    got, want, rows, jrows = _run_both(jagg, agg, jsnap, snap, jmeta, meta)
    _assert_states_equal(got, want)
    _assert_rows_equal(rows, jrows)
    assert rows == _oracle(which, names, cols)
    assert rows[0][-1] > 0                       # the filter kept rows


@pytest.mark.parametrize("which", VARIANTS)
def test_dense_variants_equal_jax(which):
    jsnap, snap = _variant_snaps()
    jagg, agg = _variant(_JaxNS, which), _variant(_PortNS, which)
    got, want, rows, jrows = _run_both(jagg, agg, jsnap, snap,
                                       _variant_meta(_JaxNS, which),
                                       _variant_meta(_PortNS, which))
    _assert_states_equal(got, want)
    _assert_rows_equal(rows, jrows)
    assert rows


def test_nullable_key_oracle():
    """The NULL key is its own group; COUNT(dec) skips NULL values."""
    specs = _variant_table()
    k, kv = specs[0]["data"], specs[0]["validity"]
    k2 = specs[1]["data"]
    dec, decv = specs[3]["data"], specs[3]["validity"]
    _js, snap = _variant_snaps()
    res = CopClient("cpu", N_DEV).execute_agg(
        _variant(_PortNS, "nullable key"), snap,
        _variant_meta(_PortNS, "nullable key"))
    want = {}
    for i in range(len(k)):
        key = (int(k[i]) if kv[i] else None, int(k2[i]))
        s, c, rows = want.get(key, (None, 0, 0))
        if decv[i]:
            s = int(dec[i]) + (s or 0)
            c += 1
        want[key] = (s, c, rows + 1)
    got = {r[:2]: r[2:] for r in _result_rows(res)}
    assert got == want
    assert any(key[0] is None for key in want)


def test_narrow_min_max_keep_the_physical_width():
    """MIN/MAX over an int16 physical column reduce at int16, as the JAX
    program does, and finalize to the logical values."""
    jsnap, snap = _variant_snaps()
    agg = _variant(_PortNS, "narrow min/max")
    cols, counts = snap.device_cols(CPU8)
    assert cols[2][0].dtype == torch.int16
    st = ShardedCopProgram(agg, CPU8)(cols, counts)
    assert st["a0"]["min"].dtype == torch.int16
    nar, k2 = _variant_table()[2]["data"], _variant_table()[1]["data"]
    assert st["a0"]["min"].tolist() == [int(nar[k2 == g].min())
                                        for g in range(3)]
    assert st["a1"]["max"].tolist() == [int(nar[k2 == g].max())
                                        for g in range(3)]


@pytest.mark.parametrize("which", ["Q1", "Q6", "Q19", "narrow sums",
                                   "float sum"])
def test_psum_limb_fence_matches_jax(lineitem, which):
    """The merge's 2^31-row fence guards exactly the programs the JAX
    package guards, and raises at S x C >= 2^31."""
    names, cols = lineitem
    if which in _TPCH:
        jagg, agg = (_TPCH[which](P, names, cols) for P in (_JaxNS, _PortNS))
    else:
        jagg, agg = _variant(_JaxNS, which), _variant(_PortNS, which)
    prog = ShardedCopProgram(agg, CPU8)
    assert prog.merge_kind == "psum"
    assert prog._psum_limb_fence == \
        get_sharded_program(jagg, get_mesh())._psum_limb_fence
    if prog._psum_limb_fence:
        huge = torch.zeros(1, 1, dtype=torch.int8).expand(1 << 16, 1 << 15)
        with pytest.raises(OverflowError, match="2\\^31"):
            prog([(huge, None)], torch.zeros(1 << 16, dtype=torch.int64))


def test_client_timings_split(lineitem):
    names, cols = lineitem
    _js, snap = _snaps(names, cols)
    client = CopClient("cpu")
    client.execute_agg(_q6(_PortNS, names, cols), snap, [])
    assert set(client.timings) == {"place", "device", "transfer", "merge"}
    assert all(v >= 0 for v in client.timings.values())


# ------------------------------------------------------------------ #
# the evaluator's lanes over narrow physical columns
# ------------------------------------------------------------------ #

def _lane_exprs(P):
    i64, ni64 = P.dt.bigint(False), P.dt.bigint()
    dec2, dec1 = P.dt.decimal(15, 2, False), P.dt.decimal(15, 1)
    f64 = P.dt.double(False)
    nar = P.Ref(i64, 0)          # int16 physical
    tiny = P.Ref(i64, 1)         # int8 physical
    price = P.Ref(dec2, 2)       # int32 physical, DECIMAL(15, 2)
    disc = P.Ref(dec2, 3)        # int8 physical
    tax = P.Ref(dec2, 4)         # int8 physical
    a = P.Ref(ni64, 5)           # nullable int64
    q = P.Ref(dec1, 6)           # nullable DECIMAL(15, 1)
    f = P.Ref(f64, 7)
    one = P.b.lit(1)
    c, ar = P.b.compare, P.b.arith
    disc_price = ar("mul", price, ar("sub", one, disc))
    return {
        "int16 * 4": ar("mul", nar, P.b.lit(4)),
        "int16 * int16": ar("mul", nar, nar),
        "100 - int8": ar("sub", P.b.lit(100), tiny),
        "int16 + int8": ar("add", nar, tiny),
        "charge": ar("mul", disc_price, ar("add", one, tax)),
        "decimal scales": ar("add", price, q),
        "decimal - int": ar("sub", q, nar),
        "neg int16": P.b.neg(nar),
        "neg decimal": P.b.neg(q),
        "abs int16": P.Func(i64, "abs", (nar,)),
        "abs decimal": P.Func(dec1, "abs", (q,)),
        "double + decimal": ar("add", f, price),
        "double * int": ar("mul", f, nar),
        "double < decimal": c("lt", f, q),
        "double >= 0.5": c("ge", f, P.b.lit(0.5)),
        "in narrow": P.b.in_list(nar, [P.b.lit(7), P.b.lit(100_000),
                                       P.b.lit(-3)]),
        "in decimal": P.b.in_list(q, [P.b.decimal_lit("1.5"),
                                      P.b.lit(2), P.b.decimal_lit("0.25")]),
        "in with NULL": P.b.in_list(a, [P.b.lit(1), P.b.lit(None),
                                        P.b.lit(3)]),
        "between narrow": P.b.between(nar, P.b.lit(-40_000),
                                      P.b.lit(1000)),
        "if narrow/decimal": P.b.if_(c("lt", a, P.b.lit(0)), nar, q),
        "if double": P.b.if_(c("gt", f, P.b.lit(0.0)), f, P.b.lit(1)),
        "case no else": P.b.case_when(
            [(c("lt", nar, P.b.lit(0)), tiny),
             (c("gt", a, P.b.lit(3)), P.b.lit(40_000))], None),
        "case else": P.b.case_when(
            [(c("eq", a, P.b.lit(1)), price)], q),
        "coalesce": P.b.coalesce(a, q, P.b.lit(0)),
        "ifnull": P.b.ifnull(a, nar),
        "date literal": c("le", P.Ref(P.dt.date(False), 8),
                          P.b.lit("1998-09-02", P.dt.date())),
    }


def _lane_cols():
    rng = np.random.default_rng(41)
    n = 4000
    nar = rng.integers(-32_768, 32_768, n).astype(np.int16)
    nar[:4] = [-32_768, 32_767, 7, -3]
    tiny = rng.integers(-128, 128, n).astype(np.int8)
    price = rng.integers(100, 10_500_000, n).astype(np.int32)
    disc = rng.integers(0, 11, n).astype(np.int8)
    tax = rng.integers(0, 9, n).astype(np.int8)
    a = rng.integers(-5, 6, n)
    av = rng.random(n) < 0.8
    q = rng.integers(-50, 50, n)
    qv = rng.random(n) < 0.8
    f = rng.normal(0.0, 10.0, n)
    ship = rng.integers(8000, 11000, n).astype(np.int16)
    return [(nar, None), (tiny, None), (price, None), (disc, None),
            (tax, None), (a, av), (q, qv), (f, None), (ship, None)]


@pytest.mark.parametrize("name", sorted(_lane_exprs(_PortNS)))
def test_evaluator_lanes_equal_jax(name):
    """Each lane's values where valid, and its validity, equal the JAX
    evaluator's on the same narrow physical columns; the products past
    the narrow widths (int16 * 4 past 2^15, Q1's charge past 2^31) come
    out at int64, unwrapped."""
    n = 4000
    raw = _lane_cols()
    jcols = [(jnp.asarray(v), True if m is None else jnp.asarray(m))
             for v, m in raw]
    tcols = [(torch.from_numpy(v), True if m is None else torch.from_numpy(m))
             for v, m in raw]
    jv, jm = JEvaluator(jnp).eval(_lane_exprs(_JaxNS)[name], jcols)
    tv, tm = Evaluator("cpu").eval(_lane_exprs(_PortNS)[name], tcols)

    def arr(x, dtype=None):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return np.broadcast_to(x, (n,))
    jmask = np.ones(n, bool) if jm is True else arr(jm).astype(bool)
    tmask = np.ones(n, bool) if tm is True else arr(tm).astype(bool)
    assert (tmask == jmask).all()
    jval, tval = arr(jv), arr(tv)
    if jval.dtype.kind == "f":
        assert tval.dtype == np.float64
        np.testing.assert_array_equal(tval[jmask], jval[jmask])
    else:
        assert tval.dtype.kind in "iub"
        assert (tval[jmask].astype(np.int64)
                == jval[jmask].astype(np.int64)).all()
    if name == "int16 * 4":
        assert tval.dtype == np.int64 and tval.max() > 2 ** 15
    if name == "charge":
        assert tval.dtype == np.int64 and tval.max() > 2 ** 31


# ------------------------------------------------------------------ #
# one reduction call a state table
# ------------------------------------------------------------------ #

# the distinct lanes of each program's state table: __rows__, then per
# aggregate its state fields; a COUNT over the selection (or COUNT(*)) is
# the __rows__ lane, and the aggregates of one nullable argument share
# one mask, so one count lane
_TABLE_LANES = {"Q1": 9, "Q6": 3, "Q19": 3, "nullable key": 4,
                "narrow min/max": 6, "float sum": 4, "narrow sums": 4,
                "projection": 13}


@pytest.mark.parametrize("which", ["Q1", "Q6", "Q19"] + VARIANTS)
def test_one_reduce_call_per_state_table(lineitem, which, monkeypatch):
    """A program run makes one ``group_reduce_lanes`` call (one kernel
    launch on the card) a logical device, over every lane of the state
    table, where one-lane launches took one a lane (Q1: 13)."""
    from tidb_tpu_torch.copr import exec as pexec
    from tidb_tpu_torch.copr.cuda import group_reduce as gr
    calls = []
    real = pexec.group_reduce_lanes

    def counted(gids, G, lanes):
        calls.append(len(gr.unique_lanes(lanes)))
        return real(gids, G, lanes)
    monkeypatch.setattr(pexec, "group_reduce_lanes", counted)
    if which in _TPCH:
        names, cols = lineitem
        snap = _snaps(names, cols)[1]
        agg = _TPCH[which](_PortNS, names, cols)
    else:
        snap = _variant_snaps()[1]
        agg = _variant(_PortNS, which)
    dcols, counts = snap.device_cols(CPU8)
    ShardedCopProgram(agg, CPU8)(dcols, counts)
    assert calls == [_TABLE_LANES[which]] * N_DEV
