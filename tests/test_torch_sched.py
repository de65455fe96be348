"""The port's device admission scheduler (sched/) through its Session on
the CPU: 8 logical devices, lineitem tables from a seed.

Mirrors the JAX package's ``tests/test_sched.py`` and
``tests/test_sched_fusion.py``: in-flight dedup without new programs,
one batched launch for two tables, one fused launch for Q1 with Q6 and
fusion turned off by its sysvar, every result equal to its solo run;
weighted-fair order, 9003 on overflow (also over the wire), the
window's EWMA and clamp, a transient fault retried, a poisoned member
demuxed and retried solo, quarantine after repeated failures, KILL of a
queued task, one submit a launch over Q1 and a join (none with
``TIDB_TPU_SCHED_DISABLE=1``), and a process that ran a scheduled
statement exiting with code 0.  The port's own: a submit to a full
queue waits for a slot while the drain serves, and answers 9003 when the
wait runs out or the drain is paused.

Queues are built with ``pause()``/``resume()`` and every wait and join
has a timeout: nothing sleeps for an arrival.  The scheduler is one a
device tuple, shared by every test of the process, so each test puts
back the knobs it changed.
"""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from tidb_tpu_torch.compilecache import compile_cache
from tidb_tpu_torch.copr.coordinator import QueryInterrupted
from tidb_tpu_torch.faults import plan as faults
from tidb_tpu_torch.faults.breaker import LaunchQuarantinedError
from tidb_tpu_torch.parallel import spmd
from tidb_tpu_torch.sched import (DEFAULT_MAX_COALESCE, DEFAULT_QUEUE_DEPTH,
                                  CopTask, DeviceScheduler, ServerBusyError,
                                  TaskCancelledError)
from tidb_tpu_torch.sched import scheduler as S
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.testing.tpch import SQL_QUERIES, gen_lineitem, \
    gen_part, sql_session

ROOT = Path(__file__).resolve().parents[1]
SF = 0.001                       # 6,000 lineitem rows a table
Q1, Q6 = SQL_QUERIES["Q1"], SQL_QUERIES["Q6"]
TIMEOUT = 60.0


def _wait_until(pred, timeout=TIMEOUT, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {msg}")


def _reset(sched):
    """The knobs a test may have changed, back to the defaults."""
    sched.resume()
    sched.configure(max_depth=DEFAULT_QUEUE_DEPTH,
                    max_coalesce=DEFAULT_MAX_COALESCE, fusion=True,
                    window_us=-1)
    faults.clear()


@pytest.fixture
def dom():
    """A port Domain on 8 logical CPU devices with lineitem and
    lineitem2, two tables of one shape, the result cache off."""
    s = sql_session({"lineitem": gen_lineitem(SF, seed=0),
                     "lineitem2": gen_lineitem(SF, seed=1)},
                    device="cpu", n_devices=8)
    s.execute("set global tidb_tpu_result_cache_entries = 0")
    d = s.domain
    s.must_query(Q6)                  # starts the scheduler
    sched = d.client._sched_obj
    assert sched is not None, "the launch did not go through the scheduler"
    _reset(sched)
    yield d
    _reset(sched)


def _run_concurrent(d, sqls, queued):
    """Run ``sqls`` in threads, one Session each, released together once
    ``queued`` tasks are queued: their rows, in order."""
    sched = d.client._sched_obj
    out, errors = {}, []

    def run(i, sql):
        try:
            out[i] = Session(d).must_query(sql)
        except Exception as e:  # noqa: BLE001 - surfaced by the assert
            errors.append(e)
    sched.pause()
    try:
        threads = [threading.Thread(target=run, args=(i, q))
                   for i, q in enumerate(sqls)]
        for t in threads:
            t.start()
        _wait_until(lambda: sched.depth >= queued,
                    msg=f"{queued} queued cop tasks")
    finally:
        sched.resume()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    assert not errors, errors
    return [out[i] for i in range(len(sqls))]


# ------------------------------------------------------------------ #
# coalescing, batching, fusion
# ------------------------------------------------------------------ #

def test_concurrent_identical_q6_coalesces_without_new_programs(dom):
    """8 sessions x Q6 over one snapshot share launches, build no new
    program, and each gets the solo answer."""
    sched = dom.client._sched_obj
    solo = Session(dom).must_query(Q6)
    misses0 = compile_cache().misses
    c0, l0 = sched.coalesced_launches, sched.launches
    out = _run_concurrent(dom, [Q6] * 8, 8)
    assert out == [solo] * 8
    assert sched.coalesced_launches > c0
    assert sched.launches - l0 < 8
    assert compile_cache().misses == misses0


def test_two_tables_give_one_batched_launch(dom):
    """Q6 over lineitem and lineitem2 at once: one batched launch, each
    slot's answer its solo run's."""
    sched = dom.client._sched_obj
    q2 = Q6.replace("lineitem", "lineitem2")
    solo = [Session(dom).must_query(q) for q in (Q6, q2)]
    b0 = sched.batched_launches
    assert _run_concurrent(dom, [Q6, q2], 2) == solo
    assert sched.batched_launches == b0 + 1


def test_q1_with_q6_fuse_and_the_sysvar_turns_fusion_off(dom):
    """Q1 and Q6 over one scan: one fused launch, each result its solo
    run's; ``tidb_tpu_sched_fusion = 0`` launches them apart."""
    sched = dom.client._sched_obj
    solo = [Session(dom).must_query(q) for q in (Q1, Q6)]
    f0 = sched.fused_launches
    assert _run_concurrent(dom, [Q1, Q6], 2) == solo
    assert sched.fused_launches == f0 + 1
    s = Session(dom)
    s.execute("set global tidb_tpu_sched_fusion = 0")
    try:
        s.must_query(Q6)
        assert sched.fusion_enable is False
        assert _run_concurrent(dom, [Q1, Q6], 2) == solo
        assert sched.fused_launches == f0 + 1
    finally:
        s.execute("set global tidb_tpu_sched_fusion = 1")
    s.must_query(Q6)
    assert sched.fusion_enable is True


# ------------------------------------------------------------------ #
# admission: fair order, the bounded queue
# ------------------------------------------------------------------ #

def test_weighted_fair_order_across_groups():
    """Stride scheduling: a 16x-weight group's tasks drain ahead of a
    1x-weight group's."""
    sched = DeviceScheduler()
    sched.pause()
    order: list = []
    tasks = [sched.submit(CopTask(fn=lambda: order.append("g"),
                                  group="gold", weight=16.0))
             for _ in range(8)]
    tasks += [sched.submit(CopTask(fn=lambda: order.append("l"),
                                   group="lead", weight=1.0))
              for _ in range(8)]
    sched.resume()
    for t in tasks:
        _wait_until(lambda t=t: t.done, msg="a task served")
        t.wait()
    gold = [i for i, tag in enumerate(order) if tag == "g"]
    assert max(gold) <= 8, order
    st = sched.stats()
    assert st["groups"]["gold"]["tasks"] == 8
    assert st["groups"]["lead"]["tasks"] == 8
    assert st["groups"]["gold"]["rus"] > 0     # per-group RU accounting
    sched.shutdown()


def test_queue_overflow_raises_9003():
    sched = DeviceScheduler(max_depth=4)
    sched.pause()
    tasks = [sched.submit(CopTask(fn=lambda: None)) for _ in range(4)]
    with pytest.raises(ServerBusyError) as ei:
        sched.submit(CopTask(fn=lambda: None))
    assert ei.value.errno == 9003 and "busy" in str(ei.value)
    assert sched.busy_rejects == 1
    sched.resume()
    for t in tasks:
        _wait_until(lambda t=t: t.done, msg="a task served")
    assert sched.stats()["queue_depth"] == 0
    sched.shutdown()


def _busy_drain(max_depth: int):
    """A scheduler whose drain is serving a task that blocks until the
    returned event is set, with ``max_depth`` more tasks queued behind
    it: the queue is full and the drain is not paused."""
    sched = DeviceScheduler(max_depth=max_depth)
    release, serving = threading.Event(), threading.Event()

    def block():
        serving.set()
        release.wait(TIMEOUT)
    head = sched.submit(CopTask(fn=block))
    assert serving.wait(TIMEOUT)
    queued = [sched.submit(CopTask(fn=lambda: None))
              for _ in range(max_depth)]
    return sched, release, [head] + queued


def test_full_queue_waits_for_a_slot_while_the_drain_serves():
    """The port's admission wait: a submit to a full queue that a drain
    is serving waits for a slot and is admitted, with no 9003."""
    sched, release, tasks = _busy_drain(2)
    sched.busy_wait_s = TIMEOUT
    admitted = []
    t = threading.Thread(
        target=lambda: admitted.append(sched.submit(CopTask(fn=lambda: 7))))
    t.start()
    time.sleep(0.05)
    assert t.is_alive() and sched.depth == 2     # waiting, not queued
    release.set()
    t.join(TIMEOUT)
    assert not t.is_alive() and len(admitted) == 1
    assert admitted[0].wait() == 7
    for task in tasks:
        _wait_until(lambda task=task: task.done, msg="a task served")
    assert sched.busy_rejects == 0
    sched.shutdown()


def test_full_queue_answers_9003_when_the_wait_runs_out():
    """A submit that waits ``busy_wait_s`` without a slot freeing gets
    the 9003 busy error; a paused drain answers it at once."""
    sched, release, tasks = _busy_drain(1)
    sched.busy_wait_s = 0.1
    t0 = time.monotonic()
    with pytest.raises(ServerBusyError):
        sched.submit(CopTask(fn=lambda: None))
    assert time.monotonic() - t0 >= 0.1
    sched.pause()
    sched.busy_wait_s = TIMEOUT
    t0 = time.monotonic()
    with pytest.raises(ServerBusyError):
        sched.submit(CopTask(fn=lambda: None))
    assert time.monotonic() - t0 < TIMEOUT / 2
    assert sched.busy_rejects == 2
    release.set()
    sched.resume()
    for task in tasks:
        _wait_until(lambda task=task: task.done, msg="a task served")
    sched.shutdown()


def test_overflow_answers_9003_over_the_wire(dom):
    """Queue depth 2, two statements queued: a third connection's
    statement gets MySQL error 9003."""
    from tidb_tpu_torch.server import MySQLServer
    from tidb_tpu_torch.server.client import Client, MySQLError
    sched = dom.client._sched_obj
    srv = MySQLServer(dom)
    srv.start()
    errors, out = [], []
    try:
        Session(dom).execute("set global tidb_tpu_sched_queue_depth = 2")
        Session(dom).must_query(Q6)         # applies the depth
        assert sched.max_depth == 2
        sched.pause()
        clients = [Client("127.0.0.1", srv.port, db="test")
                   for _ in range(3)]

        def run(c):
            try:
                out.append(c.query(Q6))
            except MySQLError as e:
                errors.append(e)
        threads = [threading.Thread(target=run, args=(c,))
                   for c in clients[:2]]
        for t in threads:
            t.start()
        _wait_until(lambda: sched.depth >= 2, msg="2 queued statements")
        with pytest.raises(MySQLError) as ei:
            clients[2].query(Q6)
        assert ei.value.errno == 9003
        sched.resume()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        assert not errors and len(out) == 2
        for c in clients:
            c.close()
    finally:
        Session(dom).execute("set global tidb_tpu_sched_queue_depth = -1")
        _reset(sched)
        srv.close(timeout=5.0)


def test_ru_buckets_at_the_drain():
    """The drain prices and debits RUs: a group whose bucket cannot pay
    is skipped while another group's task launches, and its task fails
    with 8252 at the max-queue deadline; the default group is
    unlimited."""
    from tidb_tpu_torch.rc.controller import (ResourceExhaustedError,
                                              ResourceGroupManager)
    mgr = ResourceGroupManager()
    assert not mgr.get("default").limited
    tight = mgr.create("tight", ru_per_sec=1)
    tight.bucket.force_debit(1000)
    sched = DeviceScheduler()
    sched.rc_max_queue_s = 0.2
    sched.pause()
    t1 = sched.submit(CopTask(fn=lambda: 1, group="tight", rc_group=tight))
    t2 = sched.submit(CopTask(fn=lambda: 2, group="default",
                              rc_group=mgr.get("default")))
    sched.resume()
    _wait_until(lambda: t1.done and t2.done, msg="both tasks resolved")
    assert t2.wait() == 2
    with pytest.raises(ResourceExhaustedError) as ei:
        t1.wait()
    assert ei.value.errno == 8252
    st = sched.stats()
    assert st["rc_throttled"] >= 1 and st["rc_exhausted"] == 1
    assert st["groups"]["default"]["rus"] >= 1.0
    sched.shutdown()


def test_window_ewma_and_clamp():
    """The micro-batch window is per-key EWMA-tuned: bursty keys earn a
    bounded hold, slow keys never delay their own launch."""
    sched = DeviceScheduler()
    lead = CopTask(fn=lambda: None)
    lead.key = ("k",)
    lead.fusion_key = ("fk",)
    assert sched._window_ns(lead) == 0         # no history, no hold
    t0 = lead.submit_ns
    for i in range(4):
        t = CopTask(fn=lambda: None)
        t.fusion_key = ("fk",)
        t.submit_ns = t0 + i * 100_000          # 100 us apart
        sched._note_arrival(t)
    w = sched._window_ns(lead)
    assert 0 < w <= S.WINDOW_CAP_US * 1000, w
    # a long lull clamps before feeding the EWMA, and a slow key (EWMA
    # past the cap) holds nothing
    slow = CopTask(fn=lambda: None)
    slow.fusion_key = ("fk",)
    slow.submit_ns = t0 + 10_000_000_000
    sched._note_arrival(slow)
    assert sched._fk_gap[("fk",)] <= S.WINDOW_GAP_CLAMP_NS
    for i in range(6):
        t = CopTask(fn=lambda: None)
        t.fusion_key = ("fk",)
        t.submit_ns = slow.submit_ns + (i + 1) * 40_000_000
        sched._note_arrival(t)
    assert sched._window_ns(lead) == 0
    # holds that never gain riders decay the window below its floor
    for i in range(4):
        t = CopTask(fn=lambda: None)
        t.fusion_key = ("fk2",)
        t.submit_ns = t0 + i * 100_000
        sched._note_arrival(t)
    lead.fusion_key = ("fk2",)
    assert sched._window_ns(lead) > 0
    for _ in range(12):
        sched._note_window_outcome(lead, False)
    assert sched._window_ns(lead) == 0
    sched.configure(window_us=250)             # a fixed window
    assert sched._window_ns(lead) == 250_000
    sched.configure(window_us=0)
    assert sched._window_ns(lead) == 0
    sched.configure(window_us=250)             # opaque tasks never hold
    assert sched._window_ns(CopTask(fn=lambda: None)) == 0


# ------------------------------------------------------------------ #
# supervision
# ------------------------------------------------------------------ #

def test_transient_fault_retried(dom):
    """A transient launch fault re-launches through the DEVICE_FAILED
    budget, on the same device, and the statement answers."""
    sched = dom.client._sched_obj
    solo = Session(dom).must_query(Q6)
    r0 = sched.retried_launches
    sched._retry_sleep = lambda s: None
    try:
        faults.install(faults.FaultPlan.parse("launch:transient:times=1"))
        assert Session(dom).must_query(Q6) == solo
    finally:
        sched._retry_sleep = time.sleep
        faults.clear()
    assert sched.retried_launches == r0 + 1


def _digest_hex(d, sql):
    """The task key digest (hex) of ``sql``'s one cop task."""
    seen = []
    real = S.DeviceScheduler.submit

    def spy(self, task):
        if task.key is not None:
            seen.append(task.key[0])
        return real(self, task)
    S.DeviceScheduler.submit = spy
    try:
        Session(d).must_query(sql)
    finally:
        S.DeviceScheduler.submit = real
    assert len(seen) == 1
    return f"{seen[0] & ((1 << 64) - 1):016x}"


def test_poisoned_member_demuxed_and_retried_solo(dom):
    """Q1 fused with a poisoned Q6: the fused launch fails, its members
    relaunch solo, Q1 answers and only Q6 fails."""
    sched = dom.client._sched_obj
    solo_q1 = Session(dom).must_query(Q1)
    hx = _digest_hex(dom, Q6)
    b0 = sched.bisected_launches
    out, errors = {}, {}

    def run(i, sql):
        try:
            out[i] = Session(dom).must_query(sql)
        except Exception as e:  # noqa: BLE001
            errors[i] = e
    faults.install(faults.FaultPlan.parse(f"launch:poison:match={hx}"))
    sched.pause()
    try:
        threads = [threading.Thread(target=run, args=(i, q))
                   for i, q in enumerate((Q1, Q6))]
        for t in threads:
            t.start()
        _wait_until(lambda: sched.depth >= 2, msg="2 queued cop tasks")
        sched.resume()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
    finally:
        faults.clear()
        sched.breaker.reset()
        _reset(sched)
    assert out == {0: solo_q1}
    assert isinstance(errors[1], faults.PoisonFault)
    assert sched.bisected_launches == b0 + 1


def test_quarantine_after_repeated_failures(dom):
    """A program that fails its launches trips the breaker OPEN: the
    next submit fails fast with LaunchQuarantinedError, which reaches
    the client's quarantine ladder (host fallback off: it propagates)."""
    sched = dom.client._sched_obj
    hx = _digest_hex(dom, Q6)
    q0 = sched.quarantined
    faults.install(faults.FaultPlan.parse(f"launch:poison:match={hx}"))
    try:
        for _ in range(3):
            with pytest.raises(faults.PoisonFault):
                Session(dom).must_query(Q6)
        with pytest.raises(LaunchQuarantinedError):
            Session(dom).must_query(Q6)
        assert sched.quarantined == q0 + 1
        assert "OPEN" in str(sched.stats()["breaker"])
    finally:
        faults.clear()
        sched.breaker.reset()


def test_kill_of_a_queued_task(dom):
    """KILL of a statement whose task is queued: the statement stops
    with QueryInterrupted and the drain fails its task with
    TaskCancelledError, launching nothing for it."""
    sched = dom.client._sched_obj
    victim = Session(dom)
    errors = []

    def run():
        try:
            victim.must_query(Q6)
        except Exception as e:  # noqa: BLE001
            errors.append(e)
    sched.pause()
    try:
        t = threading.Thread(target=run)
        t.start()
        _wait_until(lambda: sched.depth >= 1, msg="a queued task")
        task = sched._groups["default"].queue[0]
        l0 = sched.launches
        Session(dom).execute(f"kill query {victim.conn_id}")
        _wait_until(lambda: task.cancelled, msg="the waiter cancelled")
    finally:
        sched.resume()
    t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    _wait_until(lambda: task.done, msg="the drain to fail the task")
    assert isinstance(task._exc, TaskCancelledError)
    assert len(errors) == 1 and isinstance(errors[0], QueryInterrupted)
    assert sched.launches == l0


# ------------------------------------------------------------------ #
# every launch through submit; the bypass; the status route; exit
# ------------------------------------------------------------------ #

JOIN = ("select count(*), sum(l_quantity) from lineitem, part "
        "where l_partkey = p_partkey and p_size < 20")


def _count_submits_and_launches(monkeypatch, d):
    """Q1 and a join through ``d``: (structured submits, program runs)."""
    counts = {"submit": 0, "launch": 0}
    real_submit = S.DeviceScheduler.submit
    real_call = spmd.ShardedCopProgram.__call__

    def submit(self, task):
        if task.key is not None:
            counts["submit"] += 1
        return real_submit(self, task)

    def call(self, *a, **k):
        counts["launch"] += 1
        return real_call(self, *a, **k)
    monkeypatch.setattr(S.DeviceScheduler, "submit", submit)
    monkeypatch.setattr(spmd.ShardedCopProgram, "__call__", call)
    s = Session(d)
    s.execute("set global tidb_tpu_result_cache_entries = 0")
    s.must_query(Q1)
    assert s.must_query(JOIN)[0][0] > 0
    return counts["submit"], counts["launch"]


def _join_tables():
    return {"lineitem": gen_lineitem(SF, seed=0),
            "part": gen_part(sf=0.01, seed=7)}


def test_one_submit_a_launch_and_the_bypass(monkeypatch):
    on = sql_session(_join_tables(), device="cpu", n_devices=8).domain
    submits, launches = _count_submits_and_launches(monkeypatch, on)
    assert submits == launches >= 2
    monkeypatch.setenv("TIDB_TPU_SCHED_DISABLE", "1")
    off = sql_session(_join_tables(), device="cpu", n_devices=8).domain
    assert off.client.sched_enable is False
    submits, launches = _count_submits_and_launches(monkeypatch, off)
    assert submits == 0 and launches >= 2


def test_sched_status_route(dom):
    import json
    import urllib.request
    from tidb_tpu_torch.server.status import StatusServer
    srv = StatusServer(dom)
    port = srv.start()
    try:
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/sched",
                                      timeout=10).read()
    finally:
        srv.close()
    st = json.loads(body)
    assert st["enabled"] and st["started"] and st["launches"] >= 1
    for field in ("coalesced_launches", "batched_launches",
                  "fused_launches", "window_waits", "wait_p99_ms",
                  "groups", "compile_cache", "client", "breaker"):
        assert field in st, field
    assert st["groups"]["default"]["tasks"] >= 1


def test_a_scheduled_statement_process_exits_0():
    """A process that ran a statement through the scheduler (its drain
    thread still alive at exit) exits with code 0."""
    code = (
        "from tidb_tpu_torch.testing.tpch import gen_lineitem, sql_session\n"
        "s = sql_session({'lineitem': gen_lineitem(0.0005, seed=0)},\n"
        "                device='cpu', n_devices=8)\n"
        "s.must_query('select count(*) from lineitem')\n"
        "assert s.domain.client._sched_obj._thread is not None\n"
        "print('ran')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ran"
