"""The port's client resilience against the JAX package's: the fault
plan and the launch circuit breaker (faults/), the retries that heal the
snapshot's placement, the result cache, the OOM and quarantine ladders,
and the sysvars that tune them.

Each comparison runs the same seeded inputs through both packages:

- ``FaultPlan``: the same specs parse to the same rules (or the same
  error), and the same calls fire the same faults in the same order;
- ``CircuitBreaker``: the same failures, successes and clock steps walk
  both through the same states and quarantine errors;
- retries: the same injected ``RegionError``s heal both snapshots'
  placements into the same shards, stores and epochs, and both answer
  equal to numpy; an unhealable error exhausts the budget in both;
- the ladders: a launch that raises a ``MemoryFault``, a
  ``torch.cuda.OutOfMemoryError`` or a ``LaunchQuarantinedError``
  (patched into the port's ``_launch``: nothing on the CPU runs out of
  device memory, and nothing in the port raises a quarantine until the
  scheduler is ported) is served by the rung the JAX package's ladder
  takes, with results equal to the JAX client's, bit for bit; any other
  launch error propagates untouched.
"""

import numpy as np
import pytest
import torch

from tidb_tpu import faults as jfaults
from tidb_tpu.chunk.column import Column as JColumn
from tidb_tpu.parallel.mesh import get_mesh
from tidb_tpu.store import CopClient as JClient
from tidb_tpu.store import backoff as jbackoff
from tidb_tpu.store import snapshot_from_columns as j_snapshot
from tidb_tpu.store.placement import Placement as JPlacement
from tidb_tpu_torch import faults
from tidb_tpu_torch.chunk.column import Column
from tidb_tpu_torch.copr.cuda.build import KernelBuildError, raise_on
from tidb_tpu_torch.session import Domain, Session
from tidb_tpu_torch.store import CopClient
from tidb_tpu_torch.store.backoff import (REGION_MISS, STORE_UNAVAILABLE,
                                          RetryBudgetExceeded)
from tidb_tpu_torch.store.columnar import snapshot_from_columns
from tidb_tpu_torch.store.placement import Placement

from test_torch_highndv import _JaxNS, _PortNS

N_DEV = 4


@pytest.fixture(autouse=True)
def _no_fault_plan():
    """Every test starts and ends with both packages' fault planes
    disarmed (the plans are process-wide)."""
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _jclient():
    client = JClient(get_mesh())
    client.sched_enable = False
    return client


# ------------------------------------------------------------------ #
# the fault plan and the breaker
# ------------------------------------------------------------------ #

SPECS = ["seed=42,launch:transient:0.3,dispatch:poison:0.5",
         "seed=7,*:oom:0.25:times=3,transfer:transient:1:match=ab",
         "dispatch:transient:1:times=2", ""]
BAD_SPECS = ["launch", "nowhere:transient", "launch:sometimes"]


@pytest.mark.parametrize("spec", SPECS + BAD_SPECS)
def test_fault_plan_parses_and_fires_as_the_jax_plan(spec):
    if spec in BAD_SPECS:
        for mod in (faults, jfaults):
            with pytest.raises(ValueError):
                mod.FaultPlan.parse(spec)
        return
    plans = [faults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)]
    if not spec:
        assert plans == [None, None]
        return
    assert plans[0].rules == tuple(faults.FaultRule(*jr.__dict__.values())
                                   for jr in plans[1].rules)
    rng = np.random.default_rng(3)
    calls = [(faults.SEAMS[int(rng.integers(0, 5))],
              int(rng.integers(0, 1 << 62)) if rng.random() < 0.7 else None)
             for _ in range(200)]
    fired = []
    for plan in plans:
        out = []
        for seam, key in calls:
            try:
                plan.check(seam, key)
                out.append(None)
            except RuntimeError as e:
                out.append((type(e).__name__, e.kind(), str(e)))
        fired.append(out)
    assert fired[0] == fired[1]
    assert any(f is not None for f in fired[0])
    assert plans[0].stats() == plans[1].stats()


def test_breaker_walks_the_jax_state_machine():
    now = [0.0]
    made = [mod.CircuitBreaker(threshold=3, window_s=10.0, cooldown_s=2.0,
                               clock=lambda: now[0])
            for mod in (faults, jfaults)]
    script = [("fail", 1), ("fail", 1), ("admit", 1), ("fail", 1),
              ("admit", 1), ("step", 1.0), ("admit", 1), ("step", 1.5),
              ("admit", 1), ("admit", 1), ("fail", 1), ("admit", 1),
              ("step", 2.5), ("admit", 1), ("ok", 1), ("admit", 1),
              ("fail", 2), ("ok", 2), ("fail", 2), ("fail", 2),
              ("fail", 2), ("admit", 2), ("reset", 2), ("admit", 2)]
    trace = [[], []]
    for op, arg in script:
        if op == "step":
            now[0] += arg
            continue
        for br, out in zip(made, trace):
            try:
                if op == "admit":
                    br.admit(arg)
                elif op == "fail":
                    br.record_failure(arg)
                elif op == "ok":
                    br.record_success(arg)
                else:
                    br.reset(arg)
                out.append(br.state(arg))
            except RuntimeError as e:
                assert type(e).__name__ == "LaunchQuarantinedError"
                out.append(("quarantined", e.failures,
                            round(e.retry_after_s, 6)))
    assert trace[0] == trace[1]
    assert ("quarantined", 3, 2.0) in trace[0]
    assert faults.HALF_OPEN in trace[0] and faults.OPEN in trace[0]


@pytest.mark.parametrize("err,oom", [
    (faults.MemoryFault("launch"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"), True),
    (RuntimeError("group_reduce_lanes launch failed: CUDA error 2 "
                  "(out of memory)"), True),
    (RuntimeError("RESOURCE_EXHAUSTED: while allocating"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     False),
    (RuntimeError("radix_scatter launch failed: CUDA error 701 (too many "
                  "resources requested for launch)"), False),
    (KernelBuildError("group_reduce.so: nvcc failed (1):\nerror: out of "
                      "memory"), False),
    (faults.TransientFault("launch"), False),
    (faults.PoisonFault("launch"), False),
])
def test_oom_classification(err, oom):
    """A CUDA OOM, by type or by the runtime's text, is an OOM; a launch
    failure of any other kind, or a build failure whose compiler text
    mentions memory, is not."""
    assert faults.is_oom_error(err) is oom


@pytest.mark.parametrize("rc,oom", [(2, True), (700, False), (701, False),
                                    (719, False), (98, False)])
def test_launcher_errors_carry_the_runtime_text(rc, oom):
    with pytest.raises(RuntimeError) as e:
        raise_on(rc, "group_reduce_lanes")
    assert f"CUDA error {rc} (" in str(e.value)
    assert faults.is_oom_error(e.value) is oom


# ------------------------------------------------------------------ #
# retries that heal the placement
# ------------------------------------------------------------------ #

def _count_snaps(n=4000, n_shards=8, min_capacity=1024):
    """(port snapshot, JAX snapshot, expected {key: count}) of a 4-key
    column, each snapshot with an even placement of its own."""
    k = np.random.default_rng(3).integers(0, 4, n).astype(np.int64)
    snaps = []
    for P, Col, Pl, mk in ((_PortNS, Column, Placement,
                            snapshot_from_columns),
                           (_JaxNS, JColumn, JPlacement, j_snapshot)):
        col = Col(P.dt.bigint(False), k, np.ones(n, bool))
        snaps.append(mk(["k"], [col], n_shards=n_shards,
                        placement=Pl.even(n, n_shards),
                        min_capacity=min_capacity))
    exp = {int(u): int(c) for u, c in zip(*np.unique(k, return_counts=True))}
    return snaps[0], snaps[1], exp


def _count_agg(P, strategy="SORT"):
    i64 = P.dt.bigint(False)
    scan = P.D.TableScan((0,), (i64,))
    count = (P.D.AggDesc(P.D.AggFunc.COUNT, None, i64),)
    if strategy == "SORT":
        return P.D.Aggregation(scan, (P.Ref(i64, 0),), count,
                               P.D.GroupStrategy.SORT, group_capacity=64)
    return P.D.Aggregation(scan, (P.Ref(i64, 0),), count,
                           P.D.GroupStrategy.DENSE, domain_sizes=(4,))


def _decode(res):
    return {int(res.key_columns[0].data[i]): int(res.columns[0].data[i])
            for i in range(len(res.key_columns[0]))}


def _layout(p):
    return ([(s.shard_id, s.lo, s.hi, s.store) for s in p.shards],
            sorted(p.excluded), p.epoch)


HEALS = {"store excluded": [("STORE_UNAVAILABLE", {"store": 2})],
         "shard split": [("REGION_MISS", {"shard": 0})],
         "three stores lost": [("STORE_UNAVAILABLE", {"store": s})
                               for s in (0, 1, 2)]}
KINDS = {"STORE_UNAVAILABLE": (STORE_UNAVAILABLE,
                               jbackoff.STORE_UNAVAILABLE),
         "REGION_MISS": (REGION_MISS, jbackoff.REGION_MISS)}


@pytest.mark.parametrize("case", sorted(HEALS))
def test_injected_failures_heal_as_the_jax_client(case):
    snap, jsnap, exp = _count_snaps(n_shards=4 if case == "three stores lost"
                                    else 8)
    client, jclient = CopClient("cpu", N_DEV), _jclient()
    for kind, where in HEALS[case]:
        client.inject_failures(KINDS[kind][0], n=1, **where)
        jclient.inject_failures(KINDS[kind][1], n=1, **where)
    got = client.execute_agg(_count_agg(_PortNS), snap,
                             [_PortNS.Meta(_PortNS.dt.bigint(False), 0)])
    want = jclient.execute_agg(_count_agg(_JaxNS), jsnap,
                               [_JaxNS.Meta(_JaxNS.dt.bigint(False), 0)])
    assert _decode(got) == _decode(want) == exp
    assert _layout(snap.placement) == _layout(jsnap.placement)
    assert client.last_heals == jclient.last_heals == len(HEALS[case])
    assert client.last_retries == jclient.last_retries == len(HEALS[case])


def test_unhealable_errors_exhaust_the_budget():
    snap, jsnap, _exp = _count_snaps()
    for c, s, P, bo in ((CopClient("cpu", N_DEV), snap, _PortNS,
                         (STORE_UNAVAILABLE, RetryBudgetExceeded)),
                        (_jclient(), jsnap, _JaxNS,
                         (jbackoff.STORE_UNAVAILABLE,
                          jbackoff.RetryBudgetExceeded))):
        c.retry_budget_ms = 30.0
        c.inject_failures(bo[0], n=50)
        with pytest.raises(bo[1]):
            c.execute_agg(_count_agg(P), s,
                          [P.Meta(P.dt.bigint(False), 0)])


@pytest.mark.parametrize("seam", ["dispatch", "transfer"])
def test_transient_faults_retry(seam):
    """Two injected transient faults at a seam: the third attempt
    answers, equal to numpy."""
    snap, _jsnap, exp = _count_snaps()
    faults.install(faults.FaultPlan.parse(f"{seam}:transient:1:times=2"))
    client = CopClient("cpu", N_DEV)
    res = client.execute_agg(_count_agg(_PortNS, "DENSE"), snap,
                             [_PortNS.Meta(_PortNS.dt.bigint(False), 4)])
    assert _decode(res) == exp
    assert client.last_retries == 2
    assert faults.stats()["injected"] == {f"{seam}:transient": 2}


def test_poison_fault_propagates():
    snap, _jsnap, _exp = _count_snaps()
    faults.install(faults.FaultPlan.parse("dispatch:poison"))
    client = CopClient("cpu", N_DEV)
    with pytest.raises(faults.PoisonFault):
        client.execute_agg(_count_agg(_PortNS), snap,
                           [_PortNS.Meta(_PortNS.dt.bigint(False), 0)])
    assert client.degraded == client.oom_recovered == 0


# ------------------------------------------------------------------ #
# the result cache
# ------------------------------------------------------------------ #

def _meta():
    return [_PortNS.Meta(_PortNS.dt.bigint(False), 0)]


def test_result_cache_hit_and_misses(monkeypatch):
    snap, _jsnap, exp = _count_snaps()
    client = CopClient("cpu", N_DEV)
    agg = _count_agg(_PortNS)
    first = client.execute_agg(agg, snap, _meta())
    launches = []
    real = client._launch
    monkeypatch.setattr(client, "_launch",
                        lambda *a, **k: launches.append(1) or real(*a, **k))
    assert client.execute_agg(agg, snap, _meta()) is first   # a hit
    assert launches == [] and client.result_cache_hits == 1
    # same rows, a new snapshot object and epoch: a miss
    snap2 = snapshot_from_columns(snap.names, snap.columns, n_shards=8,
                                  epoch=snap.epoch + 1)
    assert _decode(client.execute_agg(agg, snap2, _meta())) == exp
    # a topology change of the same snapshot: a miss
    snap.placement.exclude_store(1)
    assert _decode(client.execute_agg(agg, snap, _meta())) == exp
    assert client.result_cache_hits == 1
    assert client.result_cache_misses == 3
    assert len(launches) >= 2
    # capacity bound
    client._result_cache_cap = 4
    for e in range(10):
        sn = snapshot_from_columns(snap.names, snap.columns, n_shards=8,
                                   epoch=100 + e)
        client.execute_agg(agg, sn, _meta())
    assert len(client._result_cache) == 4


def test_sql_write_invalidates_the_result_cache():
    s = Session(Domain(device="cpu"))
    s.execute("create table c (g bigint, v bigint)")
    s.execute("insert into c values " +
              ",".join(f"({i % 3},{i})" for i in range(300)))
    q = "select g, count(*), sum(v) from c group by g order by g"
    base = s.execute(q).rows
    client = s.domain.client
    h0 = client.result_cache_hits
    assert s.execute(q).rows == base
    assert client.result_cache_hits == h0 + 1   # the repeat skipped the card
    s.execute("insert into c values (0, 1000)")
    got = s.execute(q).rows
    assert got[0][1] == base[0][1] + 1 and got[1:] == base[1:]
    assert client.result_cache_hits == h0 + 1


# ------------------------------------------------------------------ #
# the OOM and quarantine ladders
# ------------------------------------------------------------------ #

def _ladder_inputs(strategy):
    snap, jsnap, exp = _count_snaps(n=6000, min_capacity=32)
    agg, jagg = _count_agg(_PortNS, strategy), _count_agg(_JaxNS, strategy)
    off = 4 if strategy == "DENSE" else 0
    meta = [_PortNS.Meta(_PortNS.dt.bigint(False), off)]
    jmeta = [_JaxNS.Meta(_JaxNS.dt.bigint(False), off)]
    want = _decode(_jclient().execute_agg(jagg, jsnap, jmeta))
    return snap, agg, meta, want


def _failing_launch(client, monkeypatch, err, times):
    """Patch the client's launch to raise ``err`` its first ``times``
    calls (every call when ``times`` is None)."""
    calls = []
    real = client._launch

    def launch(*a, **k):
        calls.append(1)
        if times is None or len(calls) <= times:
            raise err
        return real(*a, **k)
    monkeypatch.setattr(client, "_launch", launch)
    return calls


OOMS = {"MemoryFault": lambda: faults.MemoryFault("launch"),
        "CUDA OutOfMemoryError": lambda: torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 20.00 GiB")}


@pytest.mark.parametrize("strategy", ["DENSE", "SORT"])
@pytest.mark.parametrize("oom", sorted(OOMS))
@pytest.mark.parametrize("rung", ["stream", "host"])
def test_oom_ladder(strategy, oom, rung, monkeypatch):
    """The resident launch runs out of memory: half-size streamed
    batches answer (with the host fallback off, the default); if those
    run out too, the host does when the fallback is on.  Either way the
    result equals the JAX client's, and ``oom_recovered`` counts it."""
    snap, agg, meta, want = _ladder_inputs(strategy)
    client = CopClient("cpu", N_DEV)
    client.host_fallback = rung == "host"
    _failing_launch(client, monkeypatch, OOMS[oom](),
                    1 if rung == "stream" else None)
    got = _decode(client.execute_agg(agg, snap, meta))
    assert got == want
    assert client.oom_recovered == 1
    assert client.timings["oom_rung"] == rung
    assert client.degraded == (1 if rung == "host" else 0)
    if rung == "stream":
        assert len(client.timings["batches"]) >= 2
    assert not snap._device_cache        # the failed placement released


@pytest.mark.parametrize("oom", sorted(OOMS))
def test_oom_without_host_fallback_propagates(oom, monkeypatch):
    """With the host fallback off (the port's default), an OOM that the
    half-size stream meets again propagates: no statement leaves the
    card for the CPU."""
    snap, agg, meta, _want = _ladder_inputs("DENSE")
    client = CopClient("cpu", N_DEV)
    assert client.host_fallback is False
    calls = _failing_launch(client, monkeypatch, OOMS[oom](), None)
    with pytest.raises(type(OOMS[oom]())):
        client.execute_agg(agg, snap, meta)
    assert len(calls) == 2          # the resident launch, one half batch
    assert client.oom_recovered == client.degraded == 0
    assert "oom_rung" not in client.timings


@pytest.mark.parametrize("strategy", ["DENSE", "SORT"])
@pytest.mark.parametrize("fallback", [True, False])
def test_quarantine_ladder(strategy, fallback, monkeypatch):
    snap, agg, meta, want = _ladder_inputs(strategy)
    client = CopClient("cpu", N_DEV)
    client.host_fallback = fallback
    err = faults.LaunchQuarantinedError(0xAB12, 3, 1.5)
    _failing_launch(client, monkeypatch, err, None)
    if not fallback:
        with pytest.raises(faults.LaunchQuarantinedError):
            client.execute_agg(agg, snap, meta)
        assert client.degraded == 0
        return
    assert _decode(client.execute_agg(agg, snap, meta)) == want
    assert client.degraded == 1 and client.oom_recovered == 0


@pytest.mark.parametrize("text", [
    "CUDA error: an illegal memory access was encountered",
    "group_reduce_lanes launch failed: CUDA error 701 (too many resources "
    "requested for launch)"])
def test_non_oom_launch_error_propagates(text, monkeypatch):
    snap, agg, meta, _want = _ladder_inputs("DENSE")
    client = CopClient("cpu", N_DEV)
    calls = _failing_launch(client, monkeypatch, RuntimeError(text), None)
    with pytest.raises(RuntimeError, match=text[:20]):
        client.execute_agg(agg, snap, meta)
    assert len(calls) == 1                 # no rung ran another launch
    assert client.degraded == client.oom_recovered == 0
    assert client.result_cache_misses == 1 and not client._result_cache


# ------------------------------------------------------------------ #
# the four sysvars
# ------------------------------------------------------------------ #

def test_sysvars_reach_the_client():
    s = Session(Domain(device="cpu"))
    client = s.domain.client
    assert (client.device_mem_cap, client._result_cache_cap,
            client.host_fallback) == (0, 64, False)
    # the sysvar's default (1, as in the JAX package) stays off the client
    assert s.execute("select @@global.tidb_tpu_sched_host_fallback"
                     ).rows[0][0] == 1
    s.execute("select 1")
    assert client.host_fallback is False
    s.execute("set global tidb_tpu_sched_host_fallback = 1")
    s.execute("select 1")
    assert client.host_fallback is True
    s.execute("create table t (a bigint)")
    s.execute("insert into t values (1), (2), (3)")
    s.execute("set global tidb_tpu_device_mem_cap = 123456")
    s.execute("set global tidb_tpu_result_cache_entries = 7")
    s.execute("set global tidb_tpu_sched_host_fallback = 0")
    s.execute("set global tidb_tpu_faults = 'seed=5,transfer:transient:"
              "0.5:times=1'")
    assert s.execute("select sum(a) from t").rows[0][0] == 6
    assert client.device_mem_cap == 123456
    assert client._result_cache_cap == 7
    assert client.host_fallback is False
    plan = faults.active()
    assert plan is not None and plan.seed == 5
    assert plan.rules == (faults.FaultRule("transfer", "transient", 0.5, "",
                                           1),)
    s.execute("set global tidb_tpu_faults = ''")
    s.execute("set global tidb_tpu_device_mem_cap = 0")
    assert s.execute("select count(*) from t").rows[0][0] == 3
    assert faults.active() is None and client.device_mem_cap == 0


def test_result_cache_under_eight_threads():
    """Eight threads share one client's result cache (a server's
    connection threads do): every call is a hit or a miss, counted
    exactly, and every answer equals numpy."""
    import sys
    import threading
    snaps = [_count_snaps(n=2000 + 500 * i)[::2] for i in range(3)]
    client = CopClient("cpu", N_DEV)
    agg = _count_agg(_PortNS)
    calls, errs = 24, []

    def run():
        try:
            for j in range(calls):
                snap, exp = snaps[j % len(snaps)]
                assert _decode(client.execute_agg(agg, snap, _meta())) == exp
        except Exception as e:       # reported below
            errs.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ths = [threading.Thread(target=run) for _ in range(8)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths)
    assert not errs, errs
    assert client.result_cache_hits + client.result_cache_misses == 8 * calls
    assert client.result_cache_hits >= 8 * calls - 8 * len(snaps)
    assert len(client._result_cache) == len(snaps)
