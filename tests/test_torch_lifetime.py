"""Buffer lifetime (``analysis/lifetime``) of the port against the JAX
package's, and what a donating launch does in the port.

The plans come from the JAX package's plan corpus, planned in both
sessions over the same tables made from one numpy seed (8 logical
devices in the port, the 8-device CPU mesh in the JAX package).  Held
equal: every program kind's ``DonationPlan`` (slot classes, reasons,
``donate_argnums``) and the program objects' ``_donate_argnums``;
``DonationError`` for an unsafe override; ``copcost`` under a
``DonationPlan`` (every ``LaunchCost`` field); ``plan_donation``,
``donation_findings`` and ``donation_report``.

In the port a donating launch hands its inputs back to the caching
allocator at the launch (``parallel/spmd.release_donated``): tensors
torch owns shrink to nothing, a batch whose stacks numpy owns (the CPU
streamed path) is left alone, and results equal the undonated runs.
Snapshot residents are registered (``register_resident``, credited on
the memory ledger) and a donating task over one is refused at the
scheduler's admission.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from tidb_tpu.analysis import copcost as jcc
from tidb_tpu.analysis import lifetime as jL
from tidb_tpu.copr import dag as JD
from tidb_tpu.parallel import spmd as jspmd
from tidb_tpu.parallel.mesh import get_mesh
from tidb_tpu.sql.parser import parse_one as j_parse_one
from tidb_tpu.store import snapshot_from_columns as j_snapshot
from tidb_tpu.testing import tpch as jtpch
from tidb_tpu_torch.analysis import copcost as pcc
from tidb_tpu_torch.analysis import lifetime as pL
from tidb_tpu_torch.analysis.contracts import verify_task
from tidb_tpu_torch.copr import dag as PD
from tidb_tpu_torch.parallel import spmd as pspmd
from tidb_tpu_torch.sched.task import CopTask
from tidb_tpu_torch.sql.parser import parse_one as p_parse_one
from tidb_tpu_torch.store import CopClient, snapshot_from_numpy
from tidb_tpu_torch.testing import tpch

from test_torch_dense import (Q_COLS, _JaxNS, _PortNS, _jclient, _q1,
                              _q1_meta, _q6, _spec)
from test_torch_gates import _jax_session, _ops, _port_session, _tables
from test_torch_stream import _rows

N_DEV = 8
CPU8 = (torch.device("cpu"),) * N_DEV


@pytest.fixture(scope="module")
def corpus():
    """[(sql, jax plan, port plan)] over the JAX package's corpus."""
    js = _jax_session(_tables(jtpch))
    ps = _port_session(_tables(tpch))
    return [(sql, js._plan_select(j_parse_one(sql))[1],
             ps._plan_select(p_parse_one(sql))[1])
            for sql in jtpch.TPCH_PLAN_QUERIES]


def _cop_pairs(corpus):
    """(jax op, port op) of every broadcast/solo cop exec of the corpus."""
    out = []
    for _sql, jp, pp in corpus:
        for name in ("CopTaskExec", "CopJoinTaskExec"):
            out += list(zip(_ops(jp, name), _ops(pp, name)))
    return out


def _plan_view(plan):
    return (plan.program, plan.donate_argnums,
            [(s.name, s.argnum, s.cls.value, s.reason) for s in plan.slots])


def _fused_pairs(corpus):
    """FusedDags in both packages: two in-program aggregations, and a
    join DAG fused with itself (a shared aux slot)."""
    pairs = _cop_pairs(corpus)
    aggs = [(j.dag, p.dag) for j, p in pairs
            if isinstance(p.dag, PD.Aggregation)
            and p.dag.strategy in (PD.GroupStrategy.SCALAR,
                                   PD.GroupStrategy.DENSE)][:2]
    joins = [(j.dag, p.dag) for j, p in pairs
             if any(isinstance(n, PD.LookupJoin) for n in PD.iter_nodes(p.dag))]
    out = [(JD.FusedDag((aggs[0][0], aggs[1][0])),
            PD.FusedDag((aggs[0][1], aggs[1][1])))]
    if joins:
        out.append((JD.FusedDag((joins[0][0], joins[0][0])),
                    PD.FusedDag((joins[0][1], joins[0][1]))))
    return out


# ------------------------------------------------------------------ #
# the plans: equal for every program kind
# ------------------------------------------------------------------ #

def test_donation_plans_equal_every_program_kind(corpus):
    pairs = [(j.dag, p.dag) for j, p in _cop_pairs(corpus)]
    pairs += _fused_pairs(corpus)
    classes = set()
    for jd, pd in pairs:
        assert pL.scan_lifetime(pd)[0].value == jL.scan_lifetime(jd)[0].value
        assert pL.aux_lifetime(pd)[0].value == jL.aux_lifetime(jd)[0].value
        for program in pL.PROGRAMS:
            got = _plan_view(pL.donation_plan(pd, program))
            assert got == _plan_view(jL.donation_plan(jd, program))
            classes.update(c for _n, _a, c, _r in got[2])
    # the corpus reaches every class
    assert classes == {"persistent", "loop-carried", "ephemeral"}


def _loop_carried(corpus):
    return next((j.dag, p.dag) for j, p in _cop_pairs(corpus)
                if pL.scan_lifetime(p.dag)[0]
                is pL.BufferClass.LOOP_CARRIED)


@pytest.mark.parametrize("argnums", [(0,), (1,), (2,), (5,)])
def test_unsafe_override_raises_the_same_error(corpus, argnums):
    jd, pd = _loop_carried(corpus)
    got = []
    for L, dag in ((jL, jd), (pL, pd)):
        with pytest.raises(L.DonationError) as ei:
            L.verify_donation(dag, argnums, "solo")
        got.append((ei.value.rule, ei.value.detail))
    assert got[0] == got[1] and got[0][0] == "donate-unsafe"


def test_programs_derive_the_jax_argnums(corpus):
    """Each program kind's ``donation`` and ``_donate_argnums`` equal
    the JAX package's; an unsafe override raises before any launch."""
    mesh = get_mesh()
    pairs = _cop_pairs(corpus)
    jq, pq = next((j.dag, p.dag) for j, p in pairs
                  if isinstance(p.dag, PD.Aggregation)
                  and p.dag.strategy is PD.GroupStrategy.SCALAR
                  and not any(isinstance(n, PD.LookupJoin)
                              for n in PD.iter_nodes(p.dag)))
    for donate in (False, True):
        jp = jspmd.ShardedCopProgram(jq, mesh, donate=donate)
        pp = pspmd.ShardedCopProgram(pq, CPU8, donate=donate)
        assert pp._donate_argnums == jp._donate_argnums
        assert _plan_view(pp.donation) == _plan_view(jp.donation)
    jb, pb = (jspmd.BatchedCopProgram(jq, mesh, 2),
              pspmd.BatchedCopProgram(pq, CPU8, 2))
    assert pb._donate_argnums == jb._donate_argnums == (0, 1, 2)
    assert _plan_view(pb.donation) == _plan_view(jb.donation)
    jfd, pfd = _fused_pairs(corpus)[0]
    jf = jspmd.FusedCopProgram(jfd, mesh, donate=True)
    pf = pspmd.FusedCopProgram(pfd, CPU8, donate=True)
    assert pf._donate_argnums == jf._donate_argnums
    assert _plan_view(pf.donation) == _plan_view(jf.donation)
    jlc, plc = _loop_carried(corpus)
    for L, make in ((jL, lambda: jspmd.ShardedCopProgram(
                        jlc, mesh, donate_argnums=(0,))),
                    (pL, lambda: pspmd.ShardedCopProgram(
                        plc, CPU8, donate_argnums=(0,)))):
        with pytest.raises(L.DonationError):
            make()
    # a loop-carried program asked to donate derives no donation at all
    assert pspmd.ShardedCopProgram(plc, CPU8, donate=True)._donate_argnums \
        == jspmd.ShardedCopProgram(jlc, mesh, donate=True)._donate_argnums \
        == ()


# ------------------------------------------------------------------ #
# cost and the gate passes
# ------------------------------------------------------------------ #

def test_cost_under_a_donation_plan_equals_jax(corpus):
    priced = 0
    for jop, pop in _cop_pairs(corpus):
        jc = jcc._cop_exec_cost(jop, N_DEV,
                                donation=jL.donation_plan(jop.dag, "solo"))
        pc = pcc._cop_exec_cost(pop, N_DEV,
                                donation=pL.donation_plan(pop.dag, "solo"))
        assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
        priced += pc.donated_bytes > 0
    assert priced > 0


@pytest.mark.parametrize("donate", [False, True])
def test_admission_cost_equals_jax(corpus, donate):
    """The scheduler's admission ``task_cost`` over each package's own
    placed inputs (8 devices in both): every field equal, host-merged
    SORT/SEGMENT programs and row programs included (ROADMAP.md Queue 3
    item 3: an 8x gap there came from a JAX process with one device)."""
    import jax.numpy as jnp
    from tidb_tpu.analysis.copcost import task_cost as j_task_cost
    from tidb_tpu.sched.task import CopTask as JTask
    from tidb_tpu_torch.analysis.copcost import task_cost as p_task_cost
    mesh = get_mesh()
    strategies = set()
    for jop, pop in _cop_pairs(corpus):
        if type(pop).__name__ != "CopTaskExec":
            continue
        jcols, jcounts = jop.table.snapshot().device_cols(mesh)
        pcols, pcounts = pop.table.snapshot().device_cols(CPU8)
        jt = JTask.structured(jop.dag, mesh, 0, jcols, jcounts, (),
                              donate=donate)
        pt = CopTask.structured(pop.dag, CPU8, 0, pcols, pcounts, (),
                                donate=donate)
        assert dataclasses.asdict(p_task_cost(pt)) == \
            dataclasses.asdict(j_task_cost(jt))
        strategies.add(getattr(pop.dag, "strategy", None))
    assert PD.GroupStrategy.SEGMENT in strategies or \
        PD.GroupStrategy.SORT in strategies
    assert None in strategies            # a row program too


def test_plan_donation_findings_and_report_equal(corpus):
    for sql, jp, pp in corpus:
        assert pL.plan_donation(pp, N_DEV) == jL.plan_donation(jp, N_DEV), sql
    jplans = [(sql, jp) for sql, jp, _pp in corpus]
    pplans = [(sql, pp) for sql, _jp, pp in corpus]
    assert [vars(f) for f in pL.donation_findings(pplans, N_DEV)] == \
        [vars(f) for f in jL.donation_findings(jplans, N_DEV)]
    assert pL.donation_report(pplans, N_DEV) == \
        jL.donation_report(jplans, N_DEV)


# ------------------------------------------------------------------ #
# residents, the release, the streamed path
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def q_data():
    return jtpch.gen_lineitem(0.002, seed=0, columns=Q_COLS)


def test_residents_registered_and_guarded(q_data):
    """``device_cols`` registers its counts tensor as a resident and
    credits the ledger; a donating task over it is refused at admission
    with the JAX rule, and the same task over a fresh copy passes."""
    from tidb_tpu_torch.obs.hbm import ledger_for
    from tidb_tpu_torch.sched.task import mesh_fingerprint
    names, cols = q_data
    snap = snapshot_from_numpy(names, [_spec(c) for c in cols])
    led = ledger_for(mesh_fingerprint(CPU8))
    before = led.stats()["registered"]
    put_cols, counts = snap.device_cols(CPU8)
    assert pL.is_resident(counts)
    assert not pL.is_resident(counts.clone())
    assert any(r is counts for r in pL.residents())
    assert led.stats()["registered"] == before + 1
    agg = _q6(_PortNS, names, cols)
    task = CopTask.structured(agg, CPU8, 0, put_cols, counts, (),
                              donate=True)
    with pytest.raises(pL.DonationError) as ei:
        verify_task(task)
    assert ei.value.rule == "donate-unsafe"
    fresh = CopTask.structured(agg, CPU8, 0, [(v.clone(), m) for v, m in
                                              put_cols], counts.clone(), (),
                               donate=True)
    verify_task(fresh)


def test_release_frees_what_torch_owns():
    owned = [(torch.arange(64, dtype=torch.int64),
              torch.ones(64, dtype=torch.bool))]
    counts = torch.full((8,), 8, dtype=torch.int64)
    freed = pspmd.release_donated((0, 1, 2), owned, counts)
    assert freed == 64 * 8 + 64 + 8 * 8
    assert owned[0][0].untyped_storage().nbytes() == 0
    assert counts.untyped_storage().nbytes() == 0
    arr = np.arange(16, dtype=np.int64)
    numpy_owned = [(torch.from_numpy(arr), None)]
    assert pspmd.release_donated((0,), numpy_owned,
                                 torch.from_numpy(arr[:8])) == 0
    assert arr.sum() == 120          # numpy's stacks are left alone
    kept = torch.arange(8)
    assert pspmd.release_donated((), [(kept, None)], kept) == 0
    assert kept.sum() == 28


def test_batched_program_releases_its_stacks(q_data, monkeypatch):
    """The batched kinds donate the slot stacks they build per launch:
    released at the launch, results equal to solo runs."""
    names, cols = q_data
    agg = _q6(_PortNS, names, cols)
    snaps = [snapshot_from_numpy(names, [_spec(c) for c in cols])
             for _ in range(2)]
    inputs = [s.device_cols(CPU8) for s in snaps]
    freed = []
    real = pspmd.release_donated

    def counted(*a, **k):
        freed.append(real(*a, **k))
        return freed[-1]
    monkeypatch.setattr(pspmd, "release_donated", counted)
    solo = pspmd.get_sharded_program(agg, CPU8)
    want = [solo(c, n) for c, n in inputs]
    assert freed == []                   # the resident program donates none
    got = pspmd.BatchedCopProgram(agg, CPU8, 2)([c for c, _ in inputs],
                                                [n for _, n in inputs])
    assert len(freed) == 1 and freed[0] > 0

    def same(a, b):
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                same(a[k], b[k])
        else:
            assert torch.equal(a, b)
    for g, w in zip(got, want):
        same(g, w)
    for c, n in inputs:                  # the members' own tensors live on
        assert n.untyped_storage().nbytes() > 0


@pytest.mark.parametrize("which", ["Q1", "Q6"])
def test_streamed_batches_donate(q_data, which):
    """The streamed path launches its batches donating: the scheduler
    counts donated launches, tasks and priced bytes, and the results
    equal the resident run and the JAX client's."""
    names, cols = q_data
    build = _q1 if which == "Q1" else _q6
    meta = _q1_meta(_PortNS, names, cols) if which == "Q1" else []
    jmeta = _q1_meta(_JaxNS, names, cols) if which == "Q1" else []
    agg = build(_PortNS, names, cols)
    snap = snapshot_from_numpy(names, [_spec(c) for c in cols],
                               min_capacity=64)
    client = CopClient("cpu", N_DEV)
    client.device_mem_cap = snap.device_bytes() // 5
    client._result_cache_cap = 0
    n_batches = len(snap.row_batches(client.device_mem_cap))
    sched = client._scheduler()
    s0 = sched.stats()
    streamed = client.execute_agg(agg, snap, meta)
    # the drain books a launch after its waiter is finished
    deadline = time.monotonic() + 5
    while sched.stats()["donated_tasks"] - s0["donated_tasks"] \
            < n_batches and time.monotonic() < deadline:
        time.sleep(0.01)
    s1 = sched.stats()
    assert s1["donated_tasks"] - s0["donated_tasks"] == n_batches
    assert s1["donated_launches"] - s0["donated_launches"] == n_batches
    assert s1["donated_bytes"] > s0["donated_bytes"]
    resident = CopClient("cpu", N_DEV).execute_agg(agg, snap, meta)
    jsnap = j_snapshot(names, cols, n_shards=4, min_capacity=64)
    want = _jclient().execute_agg(build(_JaxNS, names, cols), jsnap, jmeta)
    assert _rows(streamed) == _rows(resident) == _rows(want)
