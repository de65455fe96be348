"""The port's batched and fused programs against the JAX package's.

K tasks of one program over different tables of one shape
(``BatchedCopProgram``, ``BatchedRowsProgram``) and N chains over one
scan (``FusedCopProgram``, ``FusedRowsProgram``) on 8 logical CPU
devices, held against the JAX ``get_batched_program``,
``get_batched_rows_program``, ``get_fused_program`` and
``get_fused_rows_program`` on the 8-device CPU mesh, over the same
numpy inputs made from a seed, and against the port's solo programs:

- aggregation states: integer, limb, COUNT and MIN/MAX fields bit for
  bit; float SUM fields within a relative ``FLOAT_RTOL`` (the batched
  reduction adds a slot's floats as one scatter over K·G groups, the
  solo SCALAR one as one sum, the JAX program in XLA's order);
- rows: every device's compacted (data, valid, count) exactly.

Also pinned: one ``group_reduce_lanes`` call a logical device for all K
slots, the power-of-two slot counts, the per-slot limb fence, and
``fusion_signature`` equal to the JAX package's on pairs that fuse and
pairs that do not.
"""

import jax
import numpy as np
import pytest
import torch

from tidb_tpu.analysis.contracts import fusion_signature as j_fusion_sig
from tidb_tpu.chunk.column import Column as JColumn
from tidb_tpu.copr import dag as JD
from tidb_tpu.parallel import spmd as jspmd
from tidb_tpu.parallel.mesh import get_mesh
from tidb_tpu.store import snapshot_from_columns as j_snapshot
from tidb_tpu.testing.tpch import gen_lineitem as j_gen_lineitem
from tidb_tpu.types import dtypes as jdt
from tidb_tpu_torch.analysis.contracts import fusion_signature
from tidb_tpu_torch.copr import dag as D
from tidb_tpu_torch.copr import exec as _exec
from tidb_tpu_torch.parallel import spmd
from tidb_tpu_torch.store import snapshot_from_numpy
from tidb_tpu_torch.types import dtypes as dt

import test_torch_dense as TD
import test_torch_rows as TR

N_DEV = 8
CPU8 = (torch.device("cpu"),) * N_DEV
FLOAT_RTOL = 1e-12
SF = 0.001                       # 6,000 lineitem rows a table


# ------------------------------------------------------------------ #
# inputs: tables of one shape, made from seeds
# ------------------------------------------------------------------ #

def _lineitem_pair(seeds=(0, 1, 2)):
    """Lineitem tables of one row count from ``seeds``, in both
    packages: ``[(jsnap, snap)], names, cols of the first``."""
    out = []
    for seed in seeds:
        names, cols = j_gen_lineitem(SF, seed=seed, columns=TD.Q_COLS)
        out.append((j_snapshot(names, cols),
                    snapshot_from_numpy(names, [TD._spec(c)
                                                for c in cols])))
        if seed == seeds[0]:
            first = (names, cols)
    return out, first


@pytest.fixture(scope="module")
def lineitems():
    return _lineitem_pair()


def _float_table(seed: int, n: int = 4000):
    """A table of a nullable key, a narrow int, a nullable DECIMAL and a
    DOUBLE, in both packages."""
    rng = np.random.default_rng(seed)
    specs = [
        {"kind": "INT64", "nullable": False, "data": rng.integers(0, 3, n)},
        {"kind": "INT64", "nullable": False,
         "data": rng.integers(-30_000, 30_000, n)},
        {"kind": "DECIMAL", "nullable": True, "prec": 15, "scale": 2,
         "data": rng.integers(-10 ** 9, 10 ** 9, n),
         "validity": rng.random(n) < 0.9},
        {"kind": "FLOAT64", "nullable": False,
         "data": rng.normal(0.0, 1e4, n)},
    ]
    names = ["k", "nar", "dec", "f"]
    jcols = []
    for s in specs:
        t = jdt.DataType(jdt.TypeKind[s["kind"]], s["nullable"],
                         s.get("prec", -1), s.get("scale", -1))
        jcols.append(JColumn.from_numpy(t, s["data"], s.get("validity")))
    return j_snapshot(names, jcols), snapshot_from_numpy(names, specs)


def _float_plan(P, strategy: str):
    """SUM/MIN/MAX of a DOUBLE, MIN/MAX of a narrow int, SUM/COUNT of a
    nullable DECIMAL and COUNT(*), DENSE by the key or SCALAR."""
    i64, ndec, f64 = P.dt.bigint(False), P.dt.decimal(15, 2), \
        P.dt.double(False)
    scan = P.D.TableScan((0, 1, 2, 3), (i64, i64, ndec, f64))
    k, nar = P.Ref(i64, 0, "k"), P.Ref(i64, 1, "nar")
    dec, f = P.Ref(ndec, 2, "dec"), P.Ref(f64, 3, "f")
    A, F = P.D.AggDesc, P.D.AggFunc
    sel = P.D.Selection(scan, (P.b.compare("gt", nar, P.b.lit(-25_000)),))
    aggs = (A(F.SUM, f, P.dt.double()), A(F.MIN, f, P.dt.double()),
            A(F.MAX, f, P.dt.double()), A(F.MIN, nar, P.dt.bigint()),
            A(F.MAX, nar, P.dt.bigint()), A(F.SUM, dec, P.sum_t(ndec)),
            A(F.COUNT, dec, i64), A(F.COUNT, None, i64))
    if strategy == "SCALAR":
        return P.D.Aggregation(sel, (), aggs, P.D.GroupStrategy.SCALAR)
    return P.D.Aggregation(sel, (k,), aggs, P.D.GroupStrategy.DENSE,
                           domain_sizes=(3,))


def _plans(which, first):
    names, cols = first
    if which == "Q1":
        return TD._q1(TD._JaxNS, names, cols), TD._q1(TD._PortNS, names, cols)
    if which == "Q6":
        return TD._q6(TD._JaxNS, names, cols), TD._q6(TD._PortNS, names, cols)
    strategy = which.split()[-1]
    return (_float_plan(TD._JaxNS, strategy),
            _float_plan(TD._PortNS, strategy))


def _inputs(which, lineitems, k):
    snaps, first = lineitems
    if which in ("Q1", "Q6"):
        pairs = snaps[:k]
    else:
        pairs = [_float_table(seed) for seed in range(k)]
    jin = [s[0].device_cols(get_mesh()) for s in pairs]
    pin = [s[1].device_cols(CPU8) for s in pairs]
    return jin, pin, first


def _assert_states(got, want, rtol_float=FLOAT_RTOL):
    """Same names, shapes and dtypes; float fields within the relative
    tolerance, every other field bit for bit."""
    got_l = {k: v.numpy() for k, v in TD._leaves(got)}
    want_l = {k: np.asarray(v) for k, v in TD._leaves(want)}
    assert sorted(got_l) == sorted(want_l)
    for name, w in want_l.items():
        g = got_l[name]
        assert g.shape == w.shape and g.dtype == w.dtype, \
            (name, g.shape, w.shape, g.dtype, w.dtype)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=rtol_float, err_msg=name)
        else:
            assert (g == w).all(), name


# ------------------------------------------------------------------ #
# BatchedCopProgram
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("which,k", [("Q1", 2), ("Q6", 3),
                                     ("float DENSE", 2),
                                     ("float SCALAR", 2)])
def test_batched_states_equal_jax_and_solo(lineitems, which, k):
    """Each slot's merged states: the JAX batched program's, and the
    port's solo program's over the same table."""
    jin, pin, first = _inputs(which, lineitems, k)
    jagg, agg = _plans(which, first)
    want = jspmd.get_batched_program(jagg, get_mesh(), k)(
        [c for c, _ in jin], [n for _, n in jin])
    want = jax.device_get(want)
    prog = spmd.get_batched_program(agg, CPU8, k)
    assert prog.n_slots == jspmd.get_batched_program(
        jagg, get_mesh(), k).n_slots == (2 if k == 2 else 4)
    got = prog([c for c, _ in pin], [n for _, n in pin])
    assert len(got) == len(want) == k
    solo = spmd.get_sharded_program(agg, CPU8)
    for i in range(k):
        _assert_states(got[i], want[i])
        _assert_states(got[i], solo(*pin[i]))


def test_one_group_reduce_call_per_device_for_k_slots(lineitems,
                                                      monkeypatch):
    """K slots of Q1 reduce in ONE group_reduce_lanes call a logical
    device (over K·G groups), where K solo runs make K calls a device."""
    jin, pin, first = _inputs("Q1", lineitems, 2)
    _jagg, agg = _plans("Q1", first)
    calls = []
    real = _exec.group_reduce_lanes

    def counting(gids, G, lanes):
        calls.append(G)
        return real(gids, G, lanes)
    monkeypatch.setattr(_exec, "group_reduce_lanes", counting)
    spmd.get_batched_program(agg, CPU8, 2)([c for c, _ in pin],
                                           [n for _, n in pin])
    assert calls == [2 * agg.num_groups] * N_DEV
    calls.clear()
    solo = spmd.get_sharded_program(agg, CPU8)
    for cols, counts in pin:
        solo(cols, counts)
    assert calls == [agg.num_groups] * (2 * N_DEV)


def test_batchable_plans_and_slot_fence(lineitems):
    """Row-wise SCALAR/DENSE chains batch; host-merged strategies, TopN
    and Limit do not.  The limb fence is per slot: two slots of 2^30
    rows each batch, as each one's solo run would."""
    _snaps, first = lineitems
    _jq1, q1 = _plans("Q1", first)
    assert spmd.batchable(spmd.get_sharded_program(q1, CPU8))
    sort = D.Aggregation(q1.child, q1.group_by, q1.aggs,
                         D.GroupStrategy.SORT, group_capacity=64)
    assert not spmd.batchable(spmd.get_sharded_program(sort, CPU8))
    for root in (TR._corpus("TopN", TR._PortNS),
                 TR._corpus("Limit", TR._PortNS)):
        assert not spmd.batchable(spmd.get_sharded_program(root, CPU8, 16))
    rows = TR._corpus("filtered projection", TR._PortNS)
    assert spmd.batchable(spmd.get_sharded_program(rows, CPU8, 64))
    with pytest.raises(ValueError):
        spmd.BatchedCopProgram(sort, CPU8, 2)
    spmd._limb_fence(1, 2 ** 31 - 1)
    with pytest.raises(OverflowError):
        spmd._limb_fence(2, 2 ** 30)


# ------------------------------------------------------------------ #
# BatchedRowsProgram
# ------------------------------------------------------------------ #

def _rows_inputs(k):
    out = []
    for seed in range(k):
        names, cols = j_gen_lineitem(SF, seed=seed, columns=TR.LI_COLS)
        out.append(TR._snaps(names, cols))
    return ([s[0].device_cols(get_mesh()) for s in out],
            [s[1].device_cols(CPU8) for s in out])


def _assert_rows(got, want):
    (gcols, gn), (wcols, wn) = got, want
    assert (gn.numpy() == np.asarray(wn)).all()
    assert len(gcols) == len(wcols)
    for (gv, gm), (wv, wm) in zip(gcols, wcols):
        wv, wm = np.asarray(wv), np.asarray(wm)
        assert gv.shape == wv.shape and gv.numpy().dtype == wv.dtype
        assert (gv.numpy() == wv).all() and (gm.numpy() == wm).all()


@pytest.mark.parametrize("cap", [1024, 16])
def test_batched_rows_equal_jax_and_solo(cap):
    """Each slot's compacted rows and counts, at a capacity the rows fit
    and one they overflow (each slot's count then exceeds it)."""
    jin, pin = _rows_inputs(2)
    jroot = TR._corpus("filtered projection", TR._JaxNS, qty_below=20)
    root = TR._corpus("filtered projection", TR._PortNS, qty_below=20)
    want = jax.device_get(jspmd.get_batched_rows_program(
        jroot, get_mesh(), cap, 2)([c for c, _ in jin],
                                   [n for _, n in jin]))
    got = spmd.get_batched_rows_program(root, CPU8, cap, 2)(
        [c for c, _ in pin], [n for _, n in pin])
    solo = spmd.get_sharded_program(root, CPU8, cap)
    for i in range(2):
        _assert_rows(got[i], want[i])
        _assert_rows(got[i], jax.device_get(solo(*pin[i])))
    if cap == 16:
        assert (got[0][1].numpy() > cap).any()


# ------------------------------------------------------------------ #
# FusedCopProgram / FusedRowsProgram
# ------------------------------------------------------------------ #

def test_fused_states_equal_jax_and_solo(lineitems):
    """Q1 and Q6 fused over one scan: each member's states equal the JAX
    fused program's and its solo run's."""
    snaps, first = lineitems
    (jsnap, snap) = snaps[0]
    jq1, q1 = _plans("Q1", first)
    jq6, q6 = _plans("Q6", first)
    jcols, jcounts = jsnap.device_cols(get_mesh())
    want = jax.device_get(jspmd.get_fused_program(
        JD.FusedDag((jq1, jq6)), get_mesh())(jcols, jcounts))
    cols, counts = snap.device_cols(CPU8)
    fprog = spmd.get_fused_program(D.FusedDag((q1, q6)), CPU8)
    got = fprog(cols, counts)
    assert len(got) == len(want) == 2
    for g, w, dag in zip(got, want, (q1, q6)):
        _assert_states(g, w)
        _assert_states(g, spmd.get_sharded_program(dag, CPU8)(cols, counts))
    assert spmd.get_fused_program(D.FusedDag((q1, q6)), CPU8) is fprog


def test_fused_rows_equal_jax_and_solo():
    """Two row chains over one scan at their own capacities."""
    jin, pin = _rows_inputs(1)
    caps = (1024, 16)
    jmembers = (TR._corpus("filtered projection", TR._JaxNS, qty_below=20),
                TR._corpus("filtered projection", TR._JaxNS, qty_below=3))
    members = (TR._corpus("filtered projection", TR._PortNS, qty_below=20),
               TR._corpus("filtered projection", TR._PortNS, qty_below=3))
    want = jax.device_get(jspmd.get_fused_rows_program(
        JD.FusedDag(jmembers), get_mesh(), caps)(*jin[0]))
    got = spmd.get_fused_rows_program(D.FusedDag(members), CPU8, caps)(
        *pin[0])
    for g, w, m, cap in zip(got, want, members, caps):
        _assert_rows(g, w)
        _assert_rows(g, jax.device_get(
            spmd.get_sharded_program(m, CPU8, cap)(*pin[0])))
    with pytest.raises(ValueError):
        spmd.FusedRowsProgram(D.FusedDag(members), CPU8, (16,))


# ------------------------------------------------------------------ #
# fusion_signature
# ------------------------------------------------------------------ #

def _sig_cases(P, first):
    names, cols = first
    ns = TD._JaxNS if P is TR._JaxNS else TD._PortNS
    q1, q6 = TD._q1(ns, names, cols), TD._q6(ns, names, cols)
    return {
        "Q1": q1, "Q6": q6,
        "SORT 64": P.D.Aggregation(q1.child, q1.group_by, q1.aggs,
                                   P.D.GroupStrategy.SORT,
                                   group_capacity=64),
        "SORT 64 again": P.D.Aggregation(q6.child, q1.group_by, q1.aggs,
                                         P.D.GroupStrategy.SORT,
                                         group_capacity=64),
        "SORT 48": P.D.Aggregation(q1.child, q1.group_by, q1.aggs,
                                   P.D.GroupStrategy.SORT,
                                   group_capacity=48),
        "SEGMENT 256": P.D.Aggregation(q1.child, q1.group_by, q1.aggs,
                                       P.D.GroupStrategy.SEGMENT,
                                       num_buckets=256),
        "SEGMENT 512": P.D.Aggregation(q1.child, q1.group_by, q1.aggs,
                                       P.D.GroupStrategy.SEGMENT,
                                       num_buckets=512),
        "rows": TR._corpus("filtered projection", P),
        "TopN": TR._corpus("TopN", P),
    }


def test_fusion_signature_equals_jax(lineitems):
    """Every case's class, and which pairs share one, equal the JAX
    package's."""
    _snaps, first = lineitems
    jcases, cases = _sig_cases(TR._JaxNS, first), _sig_cases(TR._PortNS,
                                                             first)
    jsig = {k: j_fusion_sig(v) for k, v in jcases.items()}
    sig = {k: fusion_signature(v) for k, v in cases.items()}
    assert sig == jsig
    assert sig["Q1"] == sig["Q6"] == ("inprog-agg",)
    assert sig["SORT 64"] == sig["SORT 64 again"] != sig["SEGMENT 256"]
    assert sig["SORT 48"] is None
    assert sig["SEGMENT 256"] != sig["SEGMENT 512"]
    fuse = {(a, b): sig[a] is not None and sig[a] == sig[b]
            for a in sig for b in sig}
    assert fuse == {(a, b): jsig[a] is not None and jsig[a] == jsig[b]
                    for a in jsig for b in jsig}
