"""The port's joins against the JAX package's.

On the CPU, with ``n_devices=8`` logical devices as the JAX tests' mesh:

(a) ``copr/join.py``'s ``match_ranges``, ``expand_slots`` and
    ``gather_expand`` against ``tidb_tpu.copr.join`` on seeded numpy
    inputs (no matches, left null extension, duplicate keys, INT64_MAX
    keys, a total past ``out_capacity``): values equal (the reference's
    slots are int32, the port's int64);
(b) the sharded program over a ``LookupJoin`` against
    ``get_sharded_program`` with the same aux groups: merged (SCALAR)
    and per-device (SORT) states, compacted rows, and ``join_total``
    for unique inner and left, semi, anti (null-aware too) and m:n
    inner and left, bit for bit;
(c) ``hash_partition_ids`` bit-equal, and each device's received rows
    of ``all_to_all_exchange`` equal to the JAX exchange on the
    8-device mesh;
(d) the repartition program against ``get_shuffle_program`` at the same
    ``ShuffleCaps``, extras included, at roomy and at overflowing caps;
(e) every ``JOIN_QUERIES`` statement through the port's ``Session``
    against the JAX ``Session``: names, rows and EXPLAIN, the
    repartition statements with ``BROADCAST_BUILD_MAX_ROWS = 0`` in both
    packages; the host merge join (planned with the merge-join method
    set on the logical join in both) and the hash join's partition-spill
    path (a small ``tidb_mem_quota_query``);
(f) the m:n and shuffle tests of tests/test_join_device.py over
    ``register_columns``, failing on any host fallback of a join;
(g) the join-output ``OverflowError`` at a lowered ``MAX_JOIN_ROWS``.
"""

import dataclasses
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from tidb_tpu.chunk.column import Column as JColumn
from tidb_tpu.copr import dag as JD
from tidb_tpu.copr import join as jjoin
from tidb_tpu.copr.aggregate import sum_out_dtype as j_sum_dtype
from tidb_tpu.executor import plan as jplan
from tidb_tpu.executor.physical import ExecContext as JCtx
from tidb_tpu.expr.ir import ColumnRef as JRef
from tidb_tpu.parallel import exchange as jex
from tidb_tpu.parallel.mesh import SHARD_AXIS, get_mesh, shard_map
from tidb_tpu.parallel.shuffle import ShuffleCaps as JCaps
from tidb_tpu.parallel.shuffle import get_shuffle_program
from tidb_tpu.parallel.spmd import get_sharded_program
from tidb_tpu.session import Domain as JDomain
from tidb_tpu.session import Session as JSession
from tidb_tpu.session.catalog import TableInfo as JTable
from tidb_tpu.sql.parser import parse_one as j_parse_one
from tidb_tpu.store import snapshot_from_columns as j_snapshot
from tidb_tpu.testing import tpch as jtpch
from tidb_tpu.types import dtypes as jdt
from tidb_tpu_torch.chunk.column import Column
from tidb_tpu_torch.copr import dag as D
from tidb_tpu_torch.copr import join as pjoin
from tidb_tpu_torch.copr.aggregate import sum_out_dtype
from tidb_tpu_torch.executor import physical as pphys
from tidb_tpu_torch.executor import plan as pplan
from tidb_tpu_torch.expr.ir import ColumnRef
from tidb_tpu_torch.parallel import exchange as pex
from tidb_tpu_torch.parallel.shuffle import (ShardedShuffleJoinProgram,
                                             ShuffleCaps)
from tidb_tpu_torch.parallel.spmd import ShardedCopProgram
from tidb_tpu_torch.sql.parser import parse_one
from tidb_tpu_torch.store import snapshot_from_columns
from tidb_tpu_torch.testing import tpch
from tidb_tpu_torch.types import dtypes as dt

N_DEV = 8
CPU8 = (torch.device("cpu"),) * N_DEV
I64_MAX = 2 ** 63 - 1

# JOIN_QUERIES at lineitem SF 0.02 (120,000 rows), part 40,000, orders
# 512: Q19 as written returns a non-NULL revenue there
SF, PART_SF, N_ORDERS = 0.02, 0.2, 512
# the statements planned as repartition joins: the broadcast threshold
# is 0 in both packages while they plan
FORCED_SHUFFLE = ("shuffle", "shuffle group by")
# the operator each statement's plan must hold
PLANNED = {"left join ON filter": "HostHashJoin[left]",
           "scalar subquery apply": "HostApply",
           "shuffle": "CopShuffleJoin[agg,inner]",
           "shuffle group by": "CopShuffleJoin[agg,inner]",
           "m:n inner": "CopJoinTask[agg,inner]",
           "m:n left": "CopJoinTask[agg,left]"}
# the statements whose build keys repeat: the expanding join ran
EXPANDING = ("m:n inner", "m:n left")


def _np(x):
    return np.asarray(jax.device_get(x))


def _eq(got, want) -> None:
    """Values equal (dtypes aside: the reference's join slots are
    int32, the port's int64)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want), (got, want)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is True:
        yield path, np.asarray(True)
    else:
        yield path, tree


def _trees_equal(got, want) -> None:
    g, w = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = _np(b)
        assert a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path


# ------------------------------------------------------------------ #
# (a) the join helpers
# ------------------------------------------------------------------ #

def _helper_case(name, seed=3):
    """(sorted build keys, n_live, probe keys, probe_ok, sel) of a case."""
    rng = np.random.default_rng(seed)
    n = 200
    if name == "no matches":
        bk = np.sort(rng.integers(1000, 2000, 50))
        pk = rng.integers(0, 500, n)
    elif name == "duplicates":
        bk = np.sort(rng.integers(0, 40, 120))
        pk = rng.integers(-5, 50, n)
    elif name == "INT64_MAX keys":
        live = np.sort(np.concatenate([rng.integers(0, 30, 40),
                                       np.full(5, I64_MAX)]))
        bk = np.concatenate([live, np.full(20, I64_MAX)])   # parked slots
        pk = np.where(rng.random(n) < 0.2, I64_MAX, rng.integers(0, 35, n))
        return (bk, len(live), pk, rng.random(n) < 0.9,
                rng.random(n) < 0.95)
    else:                                   # unique keys, some misses
        bk = np.sort(rng.choice(300, 150, replace=False))
        pk = rng.integers(0, 320, n)
    ok = rng.random(n) < 0.85
    sel = ok | (rng.random(n) < 0.5)
    return bk, len(bk), pk, ok & sel, sel


HELPER_CASES = ["no matches", "duplicates", "INT64_MAX keys", "unique"]


@pytest.mark.parametrize("case", HELPER_CASES)
@pytest.mark.parametrize("kind", ["inner", "left"])
@pytest.mark.parametrize("cap", [64, 4096])
def test_join_helpers_equal_the_reference(case, kind, cap):
    bk, n_live, pk, ok, sel = _helper_case(case)
    t = torch.from_numpy
    lo, hi, cnt = pjoin.match_ranges(t(bk), n_live, t(pk), t(ok))
    jlo, jhi, jcnt = jjoin.match_ranges(jnp.asarray(bk), n_live,
                                        jnp.asarray(pk), jnp.asarray(ok))
    for g, w in ((lo, jlo), (hi, jhi), (cnt, jcnt)):
        _eq(g, w)
    got = pjoin.expand_slots(t(sel), cnt, kind, cap)
    want = jjoin.expand_slots(jnp.asarray(sel), jcnt, kind, cap)
    for g, w in zip(got, want):
        _eq(g, w)
    # gather_expand over a probe column with a mask and a build column
    rng = np.random.default_rng(9)
    pv, pm = rng.integers(-99, 99, len(pk)), rng.random(len(pk)) < 0.9
    bv, bm = rng.integers(0, 10 ** 6, len(bk)), rng.random(len(bk)) < 0.8
    perm = rng.permutation(len(bk))
    cols, out_sel, total = pjoin.gather_expand(
        [(t(pv), t(pm)), (t(pk), True)], t(sel), t(ok),
        [(t(bv), t(bm)), (t(bv), True)], t(perm), lo, cnt, kind, cap)
    jcols, jsel, jtotal = jjoin.gather_expand(
        [(jnp.asarray(pv), jnp.asarray(pm)), (jnp.asarray(pk), True)],
        jnp.asarray(sel), jnp.asarray(ok),
        [(jnp.asarray(bv), jnp.asarray(bm)), (jnp.asarray(bv), True)],
        jnp.asarray(perm), jlo, jcnt, kind, cap)
    _eq(out_sel, jsel)
    _eq(total, jtotal)
    assert len(cols) == len(jcols) == 4
    for (gv, gm), (wv, wm) in zip(cols, jcols):
        _eq(gv, wv)
        if wm is True:
            assert gm is True
        else:
            _eq(gm, wm)


# ------------------------------------------------------------------ #
# (b) the sharded program over a LookupJoin
# ------------------------------------------------------------------ #

class _J:
    D, dt, Ref, sum_dtype = JD, jdt, JRef, staticmethod(j_sum_dtype)


class _P:
    D, dt, Ref, sum_dtype = D, dt, ColumnRef, staticmethod(sum_out_dtype)


FACT_N, FACT_KEYS = 4000, 150
JOIN_KINDS = {                      # (kind, unique, null_aware)
    "unique inner": ("inner", True, False),
    "unique left": ("left", True, False),
    "semi": ("semi", False, False),
    "anti": ("anti", False, False),
    "anti null-aware": ("anti", False, True),
    "m:n inner": ("inner", False, False),
    "m:n left": ("left", False, False),
}


def _fact_columns(col_cls, types, seed=4):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, FACT_KEYS, FACT_N)
    kv = rng.random(FACT_N) > 0.1
    v = rng.integers(-1000, 10 ** 6, FACT_N)
    return ["k", "v"], [col_cls.from_numpy(types.bigint(True), k, kv),
                        col_cls.from_numpy(types.bigint(False), v)]


def _build_side(unique: bool, seed=5):
    """(sorted keys, perm, w, w validity) of a build side: unique keys
    over part of the fact's key range, or ~2.5 rows a key."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(200, 120, replace=False) if unique \
        else rng.integers(0, 120, 300)
    order = np.argsort(keys, kind="stable")
    w = rng.integers(0, 10 ** 5, len(keys))
    wv = rng.random(len(keys)) > 0.15
    return keys[order], np.arange(len(keys))[order], w, wv


def _join_root(P, case: str, root: str, cap: int):
    kind, unique, null_aware = JOIN_KINDS[case]
    i64n, i64 = P.dt.bigint(True), P.dt.bigint(False)
    scan = P.D.TableScan((0, 1), (i64n, i64))
    semi = kind in ("semi", "anti")
    join = P.D.LookupJoin(scan, P.Ref(i64n, 0), kind,
                          () if semi else (i64n,), unique,
                          0 if unique or semi else cap, null_aware)
    k, v, w = P.Ref(i64n, 0), P.Ref(i64, 1), P.Ref(i64n, 2)
    if root == "rows":
        return P.D.Projection(join, (k, v) if semi else (k, v, w))
    aggs = [P.D.AggDesc(P.D.AggFunc.COUNT, None, i64),
            P.D.AggDesc(P.D.AggFunc.SUM, v, P.sum_dtype(v.dtype))]
    if not semi:
        aggs += [P.D.AggDesc(P.D.AggFunc.SUM, w, P.sum_dtype(w.dtype)),
                 P.D.AggDesc(P.D.AggFunc.COUNT, w, i64)]
    if root == "SCALAR":
        return P.D.Aggregation(join, (), tuple(aggs),
                               P.D.GroupStrategy.SCALAR)
    return P.D.Aggregation(join, (k,), tuple(aggs), P.D.GroupStrategy.SORT,
                           group_capacity=256)


@pytest.fixture(scope="module")
def fact_snaps():
    jn, jc = _fact_columns(JColumn, jdt)
    pn, pc = _fact_columns(Column, dt)
    return j_snapshot(jn, jc), snapshot_from_columns(pn, pc)


@pytest.mark.parametrize("root", ["SCALAR", "SORT", "rows"])
@pytest.mark.parametrize("case", list(JOIN_KINDS))
def test_lookup_join_program_equals_the_reference(case, root, fact_snaps):
    """States (merged or per device), rows and ``join_total`` of the
    port's program equal ``get_sharded_program``'s, at a join capacity
    some devices overflow (m:n)."""
    kind, unique, null_aware = JOIN_KINDS[case]
    jsnap, psnap = fact_snaps
    sk, perm, w, wv = _build_side(unique)
    semi = kind in ("semi", "anti")
    grp = [(sk, None), (perm, None)] + ([] if semi else [(w, wv)])
    jaux = (tuple((jnp.asarray(v), None if m is None else jnp.asarray(m))
                  for v, m in grp),)
    paux = (tuple((torch.from_numpy(v), None if m is None
                   else torch.from_numpy(m)) for v, m in grp),)
    cap, row_cap = 512, 2048
    jroot = _join_root(_J, case, root, cap)
    proot = _join_root(_P, case, root, cap)
    jcols, jcounts = jsnap.device_cols(get_mesh())
    jprog = get_sharded_program(jroot, get_mesh(),
                                row_capacity=row_cap if root == "rows" else 0)
    want = jprog(jcols, jcounts, jaux)
    pcols, pcounts = psnap.device_cols(CPU8)
    pprog = ShardedCopProgram(proot, CPU8,
                              row_capacity=row_cap if root == "rows" else 0)
    got = pprog(pcols, pcounts, paux)
    assert pprog.has_extras == jprog.has_extras == (
        not unique and not semi)
    if jprog.has_extras:
        (want, wex), (got, gex) = want, got
        assert set(gex) == set(wex) == {"join_total"}
        _eq(gex["join_total"], wex["join_total"])
        if root != "rows":
            # the capacity overflows on some device: the regrow's signal
            assert (gex["join_total"] > cap).any()
    _trees_equal(got, want)


# ------------------------------------------------------------------ #
# (c) the exchange
# ------------------------------------------------------------------ #

def _exchange_keys(n, seed=6):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2 ** 62, 2 ** 62, n)
    keys[:8] = [0, 1, -1, I64_MAX, -I64_MAX - 1, 2 ** 33, -(2 ** 40), 7]
    return keys


@pytest.mark.parametrize("n_parts", [1, 3, 8])
def test_hash_partition_ids_bit_equal(n_parts):
    keys = _exchange_keys(5000)
    got = pex.hash_partition_ids(torch.from_numpy(keys), n_parts)
    want = jex.hash_partition_ids(jnp.asarray(keys), n_parts)
    _eq(got, want)


@pytest.mark.parametrize("cap", [160, 8])
def test_all_to_all_exchange_equals_the_reference(cap):
    """Each device's received rows, validity, overflow and largest
    bucket equal the JAX exchange inside ``shard_map`` on the 8-device
    mesh; at ``cap=8`` buckets overflow."""
    n_per = 128
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 1000, N_DEV * n_per)
    vals = keys * 7 - 3
    vmask = rng.random(len(keys)) < 0.8
    valid = rng.random(len(keys)) < 0.9

    def fn(k, v, vm, ok):
        k, v, vm, ok = k.reshape(-1), v.reshape(-1), vm.reshape(-1), \
            ok.reshape(-1)
        cols, rvalid, ovf, maxc = jex.all_to_all_exchange(
            [(k, True), (v, vm)], ok, k, N_DEV, cap)
        return (cols[0][0][None], cols[1][0][None], cols[1][1][None],
                rvalid[None], ovf[None], maxc[None])

    f = jax.jit(shard_map(fn, mesh=get_mesh(),
                          in_specs=(JP(SHARD_AXIS),) * 4,
                          out_specs=(JP(SHARD_AXIS),) * 6))
    shp = (N_DEV, n_per)
    want = [_np(x) for x in f(keys.reshape(shp), vals.reshape(shp),
                              vmask.reshape(shp), valid.reshape(shp))]
    t = torch.from_numpy
    per_dev = [([(t(keys[s]), True), (t(vals[s]), t(vmask[s]))],
                t(valid[s]), t(keys[s]))
               for s in (slice(d * n_per, (d + 1) * n_per)
                         for d in range(N_DEV))]
    got = pex.all_to_all_exchange(per_dev, N_DEV, cap)
    for d, (cols, rvalid, ovf, maxc) in enumerate(got):
        assert cols[0][1] is rvalid           # a True mask: the validity
        for g, w in ((cols[0][0], want[0][d]), (cols[1][0], want[1][d]),
                     (cols[1][1], want[2][d]), (rvalid, want[3][d]),
                     (ovf, want[4][d]), (maxc, want[5][d])):
            _eq(g, w)
    if cap == 8:
        assert want[4].sum() > 0
    else:
        assert want[4].sum() == 0 and want[3].sum() == valid.sum()


def test_broadcast_gather_receives_every_row():
    rng = np.random.default_rng(2)
    parts = [(rng.integers(0, 100, 50), rng.random(50) < 0.7)
             for _ in range(N_DEV)]
    cols, valid = pex.broadcast_gather(
        [([(torch.from_numpy(k), torch.from_numpy(m))],
          torch.ones(50, dtype=torch.bool)) for k, m in parts])
    assert torch.equal(cols[0][0], torch.from_numpy(
        np.concatenate([k for k, _ in parts])))
    assert torch.equal(cols[0][1], torch.from_numpy(
        np.concatenate([m for _, m in parts])))
    assert valid.all() and len(valid) == N_DEV * 50


# ------------------------------------------------------------------ #
# tables for (d) and (f)
# ------------------------------------------------------------------ #

def _fact_dim(col_cls, types, seed=11, n=20000, m=3000, kdom=400):
    """fact(k, v) and dim(k, w), dim keys duplicated and missing, as
    tests/test_join_device.py makes them."""
    rng = np.random.default_rng(seed)
    fk = rng.integers(0, kdom, n)
    fv = rng.integers(0, 1000, n)
    dk = rng.integers(0, kdom + kdom // 4, m)
    dw = rng.integers(0, 1000, m)

    def col(a):
        return col_cls(types.bigint(), a.astype(np.int64),
                       np.ones(len(a), bool))
    return {"fact": (["k", "v"], [col(fk), col(fv)]),
            "dim": (["k", "w"], [col(dk), col(dw)])}, (fk, fv, dk, dw)


def _jax_session(tables: dict):
    dom = JDomain()
    dom.client.sched_enable = False          # no scheduler daemon threads
    dom.stats.auto_analyze_enabled = False   # no background ANALYZE
    for name, (names, cols) in tables.items():
        t = JTable(name, list(names), [c.dtype for c in cols])
        t.register_columns(list(cols))
        dom.catalog.create_table("test", t)
    s = JSession(dom)
    s.execute("set tidb_enable_auto_analyze = 0")
    return s


def _port_session(tables: dict):
    return tpch.sql_session(tables, device="cpu", n_devices=N_DEV)


@pytest.fixture()
def shuffle_forced(monkeypatch):
    """The repartition join in both packages: a zero broadcast budget."""
    monkeypatch.setattr(jplan, "BROADCAST_BUILD_MAX_ROWS", 0)
    monkeypatch.setattr(pplan, "BROADCAST_BUILD_MAX_ROWS", 0)


@pytest.fixture()
def no_fallback(monkeypatch):
    """Any host plan of a broadcast join fails the test."""
    def boom(ctx, fallback):
        raise AssertionError("host fallback taken")
    monkeypatch.setattr(pphys, "_join_fallback", boom)


# ------------------------------------------------------------------ #
# (d) the repartition program
# ------------------------------------------------------------------ #

SHUFFLE_STMTS = {
    "agg": "select count(*), sum(v + w) from fact join dim on fact.k = dim.k",
    "group by": """select fact.k, count(*), sum(w) from fact
                   join dim on fact.k = dim.k group by fact.k""",
    "left": """select count(*), count(w) from fact
               left join dim on fact.k = dim.k""",
    "rows": """select fact.k, v, w from fact join dim on fact.k = dim.k
               where v < 100 and w < 500""",
}


def _shuffle_op(phys):
    stack = [phys]
    while stack:
        op = stack.pop()
        if type(op).__name__ == "CopShuffleJoinExec":
            return op
        stack.extend(getattr(op, "children", ()) or ())
    raise AssertionError("no CopShuffleJoinExec in the plan")


@pytest.fixture(scope="module")
def fact_dim_sessions():
    jt, _ = _fact_dim(JColumn, jdt, n=3000, m=500)
    pt, raw = _fact_dim(Column, dt, n=3000, m=500)
    return _jax_session(jt), _port_session(pt), raw


@pytest.mark.parametrize("caps", [(1024, 1024, 4096), (32, 4, 128)])
@pytest.mark.parametrize("stmt", list(SHUFFLE_STMTS))
def test_shuffle_program_equals_the_reference(stmt, caps, fact_dim_sessions,
                                              shuffle_forced):
    """Per-device (or merged) states or rows and the extras ``lmax``,
    ``rmax`` and ``join_total`` of the port's repartition program equal
    ``get_shuffle_program``'s at the same capacities; the second set
    overflows the exchange buckets and the join output."""
    js, ps, _ = fact_dim_sessions
    sql = SHUFFLE_STMTS[stmt]
    jop = _shuffle_op(js._plan_select(j_parse_one(sql))[1])
    pop = _shuffle_op(ps._plan_select(parse_one(sql))[1])
    jspec, pspec = jop.spec, pop.spec
    if isinstance(pspec.top, D.Aggregation) and \
            pspec.top.strategy in D.HOST_MERGE_STRATEGIES:
        jspec = dataclasses.replace(jspec, top=dataclasses.replace(
            jspec.top, group_capacity=512))
        pspec = dataclasses.replace(pspec, top=dataclasses.replace(
            pspec.top, group_capacity=512))
    rows = 2048 if stmt == "rows" else 0
    mesh = get_mesh()
    lc, lk = jop.left_table.snapshot().device_cols(mesh)
    rc, rk = jop.right_table.snapshot().device_cols(mesh)
    want, wex = get_shuffle_program(jspec, mesh, JCaps(*caps, rows))(
        lc, lk, rc, rk, ())
    lc, lk = pop.left_table.snapshot().device_cols(CPU8)
    rc, rk = pop.right_table.snapshot().device_cols(CPU8)
    got, gex = ShardedShuffleJoinProgram(pspec, CPU8, ShuffleCaps(
        *caps, rows))(lc, lk, rc, rk, ())
    assert set(gex) == set(wex) == {"lmax", "rmax", "join_total"}
    for k in gex:
        _eq(gex[k], wex[k])
    if caps[0] < 1024:        # a bucket or the join output overflowed
        assert (gex["lmax"] > caps[0]).any() or \
            (gex["rmax"] > caps[1]).any() or \
            (gex["join_total"] > caps[2]).any()
    _trees_equal(got, want)


def _op_of(phys, name):
    stack = [phys]
    while stack:
        op = stack.pop()
        if type(op).__name__ == name:
            return op
        stack.extend(getattr(op, "children", ()) or ())
    raise AssertionError(f"no {name} in the plan")


def test_broadcast_join_admission_cost_equals_jax_copcost(
        fact_dim_sessions, monkeypatch):
    """ROADMAP.md Queue 3 item 3: the admission ``LaunchCost`` of a
    broadcast join's launch (the probe scan with the build side as aux
    inputs, 8 devices in both) equals the JAX ``copcost``'s for the same
    DAG and inputs, every field — the bytes the roofline divides by the
    device time are the reference's own count."""
    from tidb_tpu.analysis import copcost as jcc
    from tidb_tpu.sched.task import CopTask as JTask
    from tidb_tpu_torch.analysis import copcost as pcc
    from tidb_tpu_torch.sched.task import CopTask
    js, ps, _ = fact_dim_sessions
    sql = SHUFFLE_STMTS["agg"]
    seen = {}

    def spy(name, real):
        def launch(dag, cols, counts, aux, *a, **kw):
            seen[name] = (dag, cols, counts, tuple(aux))
            return real(dag, cols, counts, aux, *a, **kw)
        return launch
    monkeypatch.setattr(js.domain.client, "_launch",
                        spy("jax", js.domain.client._launch))
    monkeypatch.setattr(ps.domain.client, "_submit",
                        spy("port", ps.domain.client._submit))
    assert ps.execute(sql).rows == js.execute(sql).rows
    jdag, jcols, jcounts, jaux = seen["jax"]
    pdag, pcols, pcounts, paux = seen["port"]
    assert any(isinstance(n, D.LookupJoin) for n in D.iter_nodes(pdag))
    assert len(paux) == len(jaux) == 1 and len(paux[0]) == len(jaux[0])
    jc = jcc.task_cost(JTask.structured(jdag, get_mesh(), 0, jcols, jcounts,
                                        jaux))
    pc = pcc.task_cost(CopTask.structured(pdag, CPU8, 0, pcols, pcounts,
                                          paux))
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.aux_bytes > 0 and pc.input_bytes > 0
    # the plan-level cost EXPLAIN's footer prints, from the same op
    jop = _op_of(js._plan_select(j_parse_one(sql))[1], "CopJoinTaskExec")
    pop = _op_of(ps._plan_select(parse_one(sql))[1], "CopJoinTaskExec")
    assert dataclasses.asdict(pcc._cop_exec_cost(pop, N_DEV)) == \
        dataclasses.asdict(jcc._cop_exec_cost(jop, N_DEV))


def test_repartition_join_cost_equals_jax_copcost(fact_dim_sessions,
                                                   shuffle_forced):
    """A repartition join launches as an opaque task in both packages:
    admission prices no ``LaunchCost`` for it (so no roofline row), and
    its plan-level cost — the exchange buckets, the collective bytes
    by link — equals the JAX ``copcost``'s for every statement."""
    from tidb_tpu.analysis import copcost as jcc
    from tidb_tpu.sched.task import CopTask as JTask
    from tidb_tpu_torch.analysis import copcost as pcc
    from tidb_tpu_torch.sched.task import CopTask
    js, ps, _ = fact_dim_sessions
    for sql in SHUFFLE_STMTS.values():
        jop = _shuffle_op(js._plan_select(j_parse_one(sql))[1])
        pop = _shuffle_op(ps._plan_select(parse_one(sql))[1])
        jc = jcc._shuffle_exec_cost(jop, N_DEV)
        pc = pcc._shuffle_exec_cost(pop, N_DEV)
        assert dataclasses.asdict(pc) == dataclasses.asdict(jc), sql
        assert pc.input_bytes > 0 and pc.inter_bytes > 0, sql
    assert pcc.task_cost(CopTask.opaque(lambda: None, CPU8)) is None
    assert jcc.task_cost(JTask.opaque(lambda: None)) is None


# ------------------------------------------------------------------ #
# (e) the join statements through both sessions
# ------------------------------------------------------------------ #

def _join_tables(gen):
    return {"lineitem": gen.gen_lineitem(SF, seed=42),
            "part": gen.gen_part(sf=PART_SF, seed=7),
            "orders": gen.gen_orders_mini(N_ORDERS)}


@pytest.fixture(scope="module")
def join_sessions():
    js = _jax_session(_join_tables(jtpch))
    ps = _port_session(_join_tables(tpch))
    # EXPLAIN's ``cost:`` footer reads each package's process-wide
    # correction store, which only the port's scheduler feeds here: the
    # compared plans are priced by the static model in both
    for s in (js, ps):
        s.execute("set global tidb_tpu_cost_calibration = 0")
    return js, ps


def _jax_tree(rows) -> list:
    """The JAX session's whole EXPLAIN, its analysis footers included."""
    return [r[0] for r in rows]


def _rows_equal(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            assert type(x) is type(y) and x == y, (x, y)


@pytest.mark.parametrize("name", list(tpch.JOIN_QUERIES))
def test_join_statement_equals_the_jax_session(name, join_sessions,
                                               monkeypatch, no_fallback):
    js, ps = join_sessions
    sql = tpch.JOIN_QUERIES[name]
    if name in FORCED_SHUFFLE:
        monkeypatch.setattr(jplan, "BROADCAST_BUILD_MAX_ROWS", 0)
        monkeypatch.setattr(pplan, "BROADCAST_BUILD_MAX_ROWS", 0)
    want = js.execute(sql)
    got = ps.execute(sql)
    assert got.names == want.names
    _rows_equal(got.rows, want.rows)
    assert all(v is not None for r in got.rows for v in r), got.rows
    jtree = _jax_tree(js.execute("explain " + sql).rows)
    ptree = [r[0] for r in ps.execute("explain " + sql).rows]
    assert ptree == [line.replace("-> TPU", "-> cpu") for line in jtree]
    want_op = PLANNED.get(name, "CopJoinTask")
    assert any(want_op in line for line in ptree), ptree
    if name in EXPANDING:
        ps.execute(sql)
        assert ps.domain.client.timings.get("joins"), \
            "the expanding join did not run"
    assert ps.domain.client.join_fallbacks == 0


def test_join_queries_are_the_corpus():
    """The port's copies of the corpus are the JAX package's."""
    assert tpch.TPCH_SHUFFLE_QUERIES == jtpch.TPCH_SHUFFLE_QUERIES
    assert tpch.MULTICHIP_PLAN_QUERIES == jtpch.MULTICHIP_PLAN_QUERIES
    for gen in ("gen_part", "gen_orders_mini"):
        (pn, pc), (jn, jc) = getattr(tpch, gen)(), getattr(jtpch, gen)()
        assert pn == jn
        for p, j in zip(pc, jc):
            assert np.array_equal(p.data, j.data)


def _logical(sess, sql, jax_pkg: bool):
    """The optimized, join-reordered logical plan of ``sql``."""
    if jax_pkg:
        from tidb_tpu.planner.build import build_query
        from tidb_tpu.planner.join_reorder import reorder_joins
        from tidb_tpu.planner.optimize import optimize_plan
        plan = optimize_plan(build_query(j_parse_one(sql),
                                         sess.domain.catalog, "test").plan)
        return reorder_joins(plan, sess.domain.stats)
    from tidb_tpu_torch.planner.build import build_query
    from tidb_tpu_torch.planner.join_reorder import reorder_joins
    from tidb_tpu_torch.planner.optimize import optimize_plan
    plan = optimize_plan(build_query(parse_one(sql), sess.domain.catalog,
                                     "test").plan)
    return reorder_joins(plan, None)


def _set_join_method(plan, method: str) -> int:
    n = 0
    stack = [plan]
    while stack:
        p = stack.pop()
        if type(p).__name__ == "LogicalJoin":
            p.hint_method = method
            n += 1
        stack.extend(p.children)
    return n


MERGE_STMTS = {
    "inner": """select count(*), sum(p_size), sum(l_quantity) from lineitem
                join part on l_partkey = p_partkey where l_quantity < 3""",
    "left": """select count(*), count(p_size) from lineitem left join part
               on l_partkey = p_partkey and p_size < 3""",
}


@pytest.mark.parametrize("stmt", list(MERGE_STMTS))
def test_host_merge_join_equals_the_jax_package(stmt, join_sessions):
    """The host merge join (the method a MERGE_JOIN hint picks; the
    port's session has no hints yet) over the same logical plan in both
    packages."""
    js, ps = join_sessions
    sql = MERGE_STMTS[stmt]
    res = []
    for sess, jax_pkg in ((js, True), (ps, False)):
        plan = _logical(sess, sql, jax_pkg)
        assert _set_join_method(plan, "merge") == 1
        if jax_pkg:
            phys = jplan.to_physical(plan)
            ctx = JCtx(sess.domain.client)
        else:
            phys = ps._to_physical(plan)
            ctx = pphys.ExecContext(sess.domain.client)
        assert "HostMergeJoin" in phys.explain()
        chunk = phys.execute(ctx)
        res.append([c.to_python() for c in chunk.columns])
    assert res[0] == res[1]


def test_host_hash_join_spill_equals_the_jax_session(join_sessions,
                                                     monkeypatch):
    """The hash join's partition-spill path (a build side over half the
    statement's memory quota) gives the JAX session's rows."""
    js, ps = join_sessions
    sql = tpch.JOIN_QUERIES["left join ON filter"]
    spilled = []
    real = pphys.HostHashJoin._execute_spilled

    def counted(self, ctx, lc, rc):
        spilled.append(1)
        return real(self, ctx, lc, rc)
    monkeypatch.setattr(pphys.HostHashJoin, "_execute_spilled", counted)
    for s in (js, ps):
        s.execute("set tidb_mem_quota_query = 200000")
    try:
        want, got = js.execute(sql), ps.execute(sql)
    finally:
        for s in (js, ps):
            s.execute("set tidb_mem_quota_query = 1073741824")
    assert spilled
    _rows_equal(got.rows, want.rows)


# ------------------------------------------------------------------ #
# (f) tests/test_join_device.py over register_columns
# ------------------------------------------------------------------ #

def _small(rows):
    """A table of bigint columns from a list of row tuples."""
    cols = list(zip(*rows))
    return [Column(dt.bigint(), np.array(c, np.int64),
                   np.ones(len(c), bool)) for c in cols]


def test_multimatch_device_join(no_fallback):
    s = _port_session({
        "f": (["k", "v"], _small([(1, 10), (2, 20), (3, 30)])),
        "d": (["k", "w"], _small([(1, 100), (1, 101), (2, 200)]))})
    rows = s.execute(
        "select f.k, w from f join d on f.k = d.k order by f.k, w").rows
    assert rows == [(1, 100), (1, 101), (2, 200)]
    assert s.domain.client.timings.get("joins")


def test_multimatch_device_join_large(no_fallback):
    rng = np.random.default_rng(7)
    fk, fv = rng.integers(0, 50, 5000), rng.integers(0, 1000, 5000)
    dk, dw = rng.integers(0, 60, 300), rng.integers(0, 1000, 300)

    def cols(*arrs):
        return [Column(dt.bigint(), a.astype(np.int64),
                       np.ones(len(a), bool)) for a in arrs]
    s = _port_session({"fact": (["k", "v"], cols(fk, fv)),
                       "dim": (["k", "w"], cols(dk, dw))})
    got = s.execute("select count(*), sum(v + w) from fact "
                    "join dim on fact.k = dim.k").rows
    dmap = defaultdict(list)
    for k, w in zip(dk.tolist(), dw.tolist()):
        dmap[k].append(w)
    total = vsum = 0
    for k, v in zip(fk.tolist(), fv.tolist()):
        for w in dmap.get(k, ()):
            total += 1
            vsum += v + w
    assert got[0] == (total, vsum)
    assert s.domain.client.timings["joins"]


def test_multimatch_regrows_its_capacity(no_fallback):
    """A skewed build side: the first capacity (a device's probe rows x
    the mean duplication) is too small, the client regrows it to the
    reported total and the result is exact."""
    rng = np.random.default_rng(12)
    fk = rng.integers(0, 5, 5000)
    dk = np.concatenate([np.zeros(200, np.int64), np.arange(1, 101)])
    dw = rng.integers(0, 1000, len(dk))

    def cols(*arrs):
        return [Column(dt.bigint(), a.astype(np.int64),
                       np.ones(len(a), bool)) for a in arrs]
    s = _port_session({"fact": (["k"], cols(fk)),
                       "dim": (["k", "w"], cols(dk, dw))})
    got = s.execute("select count(*), sum(w) from fact "
                    "join dim on fact.k = dim.k").rows[0]
    dmap = _dmap(dk, dw)
    assert got == (sum(len(dmap[k]) for k in fk.tolist()),
                   sum(sum(dmap[k]) for k in fk.tolist()))
    caps = s.domain.client.timings["joins"]
    assert len(caps) == 2 and caps[1] > caps[0]


def test_multimatch_left_join_device(no_fallback):
    s = _port_session({
        "f": (["k", "v"], _small([(1, 10), (2, 20), (3, 30), (4, 40)])),
        "d": (["k", "w"], _small([(1, 100), (1, 101), (9, 900)]))})
    rows = s.execute(
        "select f.k, w from f left join d on f.k = d.k order by f.k, w").rows
    assert rows == [(1, 100), (1, 101), (2, None), (3, None), (4, None)]
    cnt = s.execute("select count(*), count(w) "
                    "from f left join d on f.k = d.k").rows
    assert cnt[0] == (5, 2)


def _dmap(dk, dw):
    dmap = defaultdict(list)
    for k, w in zip(dk.tolist(), dw.tolist()):
        dmap[k].append(w)
    return dmap


def _shuffle_session(**kw):
    tables, raw = _fact_dim(Column, dt, **kw)
    return _port_session(tables), raw


def _plan_has(s, sql, op):
    plan = "\n".join(r[0] for r in s.execute("explain " + sql).rows)
    assert op in plan, plan


def test_shuffle_join_agg(shuffle_forced):
    s, (fk, fv, dk, dw) = _shuffle_session()
    q = "select count(*), sum(v + w) from fact join dim on fact.k = dim.k"
    _plan_has(s, q, "CopShuffleJoin[agg,inner]")
    dmap = _dmap(dk, dw)
    total = vsum = 0
    for k, v in zip(fk.tolist(), fv.tolist()):
        for w in dmap.get(k, ()):
            total += 1
            vsum += v + w
    assert s.execute(q).rows[0] == (total, vsum)


def test_shuffle_join_rows_and_filter(shuffle_forced):
    s, (fk, fv, dk, dw) = _shuffle_session(n=2000, m=500)
    q = ("select fact.k, v, w from fact join dim on fact.k = dim.k "
         "where v < 100 and w < 500")
    _plan_has(s, q, "CopShuffleJoin[rows,inner]")
    dmap = _dmap(dk, dw)
    exp = sorted((k, v, w)
                 for k, v in zip(fk.tolist(), fv.tolist()) if v < 100
                 for w in dmap.get(k, ()) if w < 500)
    assert sorted(s.execute(q).rows) == exp


def test_shuffle_left_join(shuffle_forced):
    s, (fk, fv, dk, dw) = _shuffle_session(n=3000, m=400, kdom=600)
    q = ("select count(*), count(w) from fact "
         "left join dim on fact.k = dim.k")
    _plan_has(s, q, "CopShuffleJoin[agg,left]")
    dmap = _dmap(dk, dw)
    total = matched = 0
    for k in fk.tolist():
        c = len(dmap.get(k, ()))
        total += max(c, 1)
        matched += c
    assert s.execute(q).rows[0] == (total, matched)


def test_shuffle_join_groupby(shuffle_forced):
    s, (fk, fv, dk, dw) = _shuffle_session(n=5000, m=800)
    q = ("select fact.k, count(*), sum(w) from fact "
         "join dim on fact.k = dim.k group by fact.k")
    _plan_has(s, q, "CopShuffleJoin[agg,inner]")
    dmap = _dmap(dk, dw)
    exp = defaultdict(lambda: [0, 0])
    for k in fk.tolist():
        for w in dmap.get(k, ()):
            exp[k][0] += 1
            exp[k][1] += w
    got = {r[0]: (r[1], r[2]) for r in s.execute(q).rows}
    assert got == {k: (c, sw) for k, (c, sw) in exp.items()}


# ------------------------------------------------------------------ #
# (g) the join-output bound
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("route", ["broadcast", "shuffle"])
def test_join_output_past_the_int32_slots_raises(route, monkeypatch):
    """A device's join output past ``MAX_JOIN_ROWS`` (the reference's
    int32 slots, 2^31 - 1; lowered here) raises ``OverflowError``
    instead of running a join the reference would wrap."""
    if route == "shuffle":
        monkeypatch.setattr(pplan, "BROADCAST_BUILD_MAX_ROWS", 0)
    s, (fk, _fv, dk, _dw) = _shuffle_session(n=3000, m=500)
    q = "select count(*), sum(v + w) from fact join dim on fact.k = dim.k"
    _plan_has(s, q, "CopShuffleJoin" if route == "shuffle"
              else "CopJoinTask")
    total = s.execute(q).rows[0][0]         # within the bound: runs
    dmap = _dmap(dk, _dw)
    assert total == sum(len(dmap.get(k, ())) for k in fk.tolist())
    monkeypatch.setattr(pjoin, "MAX_JOIN_ROWS", total // N_DEV // 2)
    with pytest.raises(OverflowError, match="int32 join slots"):
        s.execute(q)
