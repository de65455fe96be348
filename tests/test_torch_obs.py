"""The port's observability plane (obs/, utils/tracing) against the JAX
package's, on the CPU.

The unit half builds the same inputs in both packages and compares the
outputs exactly: span trees recorded with fixed nanosecond times (the
``add``/``add_batch``/``flag``/``annotate`` surface, ``ordered``,
``rows``, ``to_dict`` and ``chrome_trace`` with the tree's clock zero
and wall start pinned), the trace context (``span``, ``flag``,
``annotate``), the flight recorder's retention and sampling, the
``Tracer`` shim, and the roofline's ``attribution`` and store (the
``bound`` verdict and every percentage, exactly: the arithmetic is the
same Python floats).  The port's ``NVIDIA_PEAKS`` name the H100 SXM's
datasheet numbers.

The session half runs statements through the port's ``Session`` on 8
logical CPU devices with the scheduler on: the drain's spans stitch
under the statement's ``cop.dispatch`` span from the drain thread and
are in the tree when the waiter returns (the drain paused and resumed,
never a sleep), two connections' statements see only their own spans,
tracing off leaves no tree, no context and no recorder entry, the
status routes ``/trace``, ``/trace/<id>`` (``?fmt=chrome``), ``/hbm``
and ``/profile`` answer, and a scheduled statement's span names equal
the JAX session's for the same statement (its scheduler on, its device
path pinned open as tests/test_obs.py pins it).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from tidb_tpu.obs import FlightRecorder as JFlightRecorder
from tidb_tpu.obs import SpanTree as JSpanTree
from tidb_tpu.obs import TraceCtx as JTraceCtx
from tidb_tpu.obs import roofline as jroof
from tidb_tpu.obs import trace as jtrace
from tidb_tpu.session import Domain as JDomain
from tidb_tpu.session import Session as JSession
from tidb_tpu.utils.tracing import Tracer as JTracer
from tidb_tpu_torch.obs import FlightRecorder, SpanTree, TraceCtx
from tidb_tpu_torch.obs import hbm as phbm
from tidb_tpu_torch.obs import roofline as proof
from tidb_tpu_torch.obs import trace as ptrace
from tidb_tpu_torch.obs.recorder import KEEP_FLAGS
from tidb_tpu_torch.sched import DEFAULT_MAX_COALESCE, DEFAULT_QUEUE_DEPTH
from tidb_tpu_torch.server.status import StatusServer
from tidb_tpu_torch.session import Domain, Session
from tidb_tpu_torch.utils.tracing import Tracer

TIMEOUT = 60.0


# ------------------------------------------------------------------ #
# unit parity: span trees, the context, the recorder, the shim
# ------------------------------------------------------------------ #

def _scripted_tree(tree_cls):
    """A span tree recorded with fixed times: explicit parents given
    out of order, a batch with ("rel", k) parents, flags and
    annotations; clock zero and wall start pinned."""
    tree = tree_cls(trace_id="t-1", sql="select 1", conn_id=7)
    tree.t0 = 1_000
    tree.wall_start = 1.5e9
    tree.latency_ms = 2.25
    root = tree.add("session.ExecuteStmt", 1_000, 90_000)
    disp = tree.add("cop.dispatch", 5_000, 60_000, parent_id=root)
    tree.add("late", 70_000, 80_000, parent_id=root, k="v")
    ids = tree.add_batch([
        ("sched.queue", 5_500, 9_000, disp, {"group": "default",
                                             "ru": 1.5}),
        ("sched.launch", 9_000, 50_000, disp, {"mode": "fused",
                                               "measured_ms": 0.041}),
        ("sched.compile", 9_000, 12_000, ("rel", 1), {"result": "miss"}),
        ("sched.fusion", 8_000, 9_000, ("rel", 1), {"members": 3}),
    ])
    tree.add("cop.transfer", 60_000, 62_000, parent_id=root,
             intra_bytes=4096)
    tree.add("orphan", 3_000, 4_000, parent_id=999)
    tree.annotate(ids[1], device_ms=0.037)
    tree.annotate(disp, opaque=True)
    tree.flag("slow", "retried")
    tree.flag("slow")
    open_id = tree.add("open", 85_000, 0, parent_id=root)
    return tree, open_id


def _shape(tree):
    return [(sp.span_id, sp.parent_id, sp.name, d, sp.start_ns, sp.end_ns,
             dict(sp.attrs)) for sp, d in tree.ordered()]


def test_span_tree_matches_reference():
    """Order and depth, the TRACE rows, the recorder JSON and the Chrome
    trace of one scripted tree: equal to the JAX package's."""
    jt, jopen = _scripted_tree(JSpanTree)
    pt, popen = _scripted_tree(SpanTree)
    assert popen == jopen
    assert _shape(pt) == _shape(jt)
    assert pt.rows() == jt.rows()
    assert pt.to_dict() == jt.to_dict()
    assert pt.chrome_trace() == jt.chrome_trace()
    assert pt.flags == jt.flags == {"slow", "retried"}
    # depth derives from parents; an orphan renders at root depth
    depth = {sp.name: d for sp, d in pt.ordered()}
    assert depth["sched.compile"] == depth["sched.fusion"] == 3
    assert depth["orphan"] == 0
    json.dumps(pt.chrome_trace())


def _with_ctx(mod, tree_cls, ctx_cls):
    """span()/flag()/annotate() under a bound context, then untraced."""
    tree = tree_cls(trace_id="c-1")
    root = tree.add("stmt", 0, 0)
    tok = mod.TRACE_CTX.set(ctx_cls(tree, root))
    try:
        with mod.span("outer", a=1) as octx:
            mod.annotate(b=2)
            with mod.span("inner"):
                mod.flag("degraded")
            assert mod.current().span_id == octx.span_id
        with mod.span("sibling"):
            pass
        child = mod.current().child(root)
        child.add("drain", 5, 6, x=3)
    finally:
        mod.TRACE_CTX.reset(tok)
    with mod.span("ghost") as g:
        assert g is None
    mod.flag("failed")            # untraced: no-op
    mod.annotate(z=1)
    return ([(sp.span_id, sp.parent_id, sp.name, d, dict(sp.attrs))
             for sp, d in tree.ordered()], sorted(tree.flags))


def test_trace_context_matches_reference():
    assert _with_ctx(ptrace, SpanTree, TraceCtx) == \
        _with_ctx(jtrace, JSpanTree, JTraceCtx)


def test_tracer_shim_matches_reference():
    def run(cls):
        tr = cls()
        with tr.region("a"):
            with tr.region("b", k=1):
                pass
            with tr.region("c"):
                pass
        return ([(s.name, s.depth) for s in tr.spans],
                [r[0] for r in tr.rows()])
    assert run(Tracer) == run(JTracer) == (
        [("a", 0), ("b", 1), ("c", 1)], ["a", "  b {k=1}", "  c"])


def _offer(rec_cls, tree_cls, capacity, every, flags_seq):
    fr = rec_cls(capacity=capacity, sample_every=every)
    admitted = []
    for i, fl in enumerate(flags_seq):
        t = tree_cls(trace_id=f"t{i}", sql="x" * 300)
        t.wall_start = 0.0
        t.flag(*fl)
        admitted.append(fr.record(t))
    return (admitted, fr.stats(), fr.index(), len(fr),
            [fr.get(f"t{i}") is not None for i in range(len(flags_seq))])


RECORDER_CASES = {
    "sampled": (8, 4, [()] * 20),
    "keep flags": (8, 4, [(f,) for f in sorted(KEEP_FLAGS)] + [()] * 9),
    "flood": (4, 16, [("failed",)] * 12 + [()] * 3),
    "every one": (16, 1, [()] * 10),
    "mixed": (6, 3, [(), ("oom",), ("slow",), (), (), ("retried",),
                     (), ("quarantined", "x"), (), ()]),
}


@pytest.mark.parametrize("case", sorted(RECORDER_CASES))
def test_flight_recorder_matches_reference(case):
    """Admission (KEEP_FLAGS always, the rest 1-in-N), the bounded ring,
    the newest-first index (sql cut at 200) and lookups."""
    cap, every, seq = RECORDER_CASES[case]
    assert _offer(FlightRecorder, SpanTree, cap, every, seq) == \
        _offer(JFlightRecorder, JSpanTree, cap, every, seq)


# ------------------------------------------------------------------ #
# unit parity: the roofline
# ------------------------------------------------------------------ #

class _Cost:
    def __init__(self, transfer_bytes, flops):
        self.transfer_bytes = transfer_bytes
        self.flops = flops


# (ewma_ms, transfer_bytes, flops, peaks): memory-, compute- and
# launch-bound digests, and one whose unclamped share passes 100%
ROOF_CASES = {
    "memory": (2.0, 4_000_000_000, 10_000_000, (3.35e12, 67e12)),
    "compute": (5.0, 1_000_000, 300_000_000_000, (3.35e12, 67e12)),
    "launch": (0.2, 10_000_000, 10_000_000, (3.35e12, 67e12)),
    "over peak": (1.0, 9_000_000_000, 1_000, (3.35e12, 67e12)),
    "cpu peaks": (3.0, 50_000_000, 2_000_000, (5e9, 6e8)),
    "zero time": (0.0, 1_000, 1_000, (819e9, 197e12)),
}


@pytest.mark.parametrize("case", sorted(ROOF_CASES))
def test_roofline_attribution_matches_reference(case):
    """The bound verdict and every rate and percentage, exactly (the
    same float arithmetic in both)."""
    ms, nbytes, flops, peaks = ROOF_CASES[case]
    p = proof.RoofStat(ewma_ms=ms, transfer_bytes=nbytes, flops=flops,
                       measured_hbm=77, samples=3).attribution(peaks)
    j = jroof.RoofStat(ewma_ms=ms, transfer_bytes=nbytes, flops=flops,
                       measured_hbm=77, samples=3).attribution(peaks)
    assert p == j
    if case == "over peak":
        assert p["bytes_pct"] == 100.0       # clamped, as the JAX one
        assert p["achieved_gbps"] > 3350.0   # the unclamped rate shows


def _store_script(mod):
    st = mod.RooflineStore(cap=4)
    peaks = (3.35e12, 67e12, "declared:test")
    for i, (d, ms, nb, fl) in enumerate([
            ("d1", 2.0, 4_000_000_000, 10), ("d2", 0.1, 10, 10),
            ("d1", 4.0, 4_000_000_000, 10), ("d3", 9.0, 1, 10 ** 12),
            ("d4", 1.0, 10 ** 9, 1), ("d5", 3.0, 10 ** 8, 10 ** 8),
            ("d1", 1.0, 4_000_000_000, 10), ("dx", 0.0, 1, 1)]):
        st.observe(d, _Cost(nb, fl), int(ms * 1e6), peaks,
                   measured_hbm=i * 100)
    st.observe("dn", None, 1_000, peaks)
    return (st.get("d1"), st.get("d2"), st.stats(), st.top(3),
            st.observed)


def test_roofline_store_matches_reference():
    """EWMA per digest, the LRU bound, the top-N tables and the stats:
    equal for one scripted stream of launches."""
    assert _store_script(proof) == _store_script(jroof)


def test_declared_peaks():
    """The H100 SXM (its CUDA name) reads NVIDIA's datasheet peaks; the
    TPU kinds read the JAX package's table; a kind neither names on
    the CPU reads the numpy microbench, never a TPU number."""
    bw, fl, src = proof.backend_peaks("NVIDIA H100 80GB HBM3")
    assert (bw, fl) == (3.35e12, 67e12)
    assert src.startswith("declared:nvidia-datasheet")
    for kind in ("TPU v5 lite", "TPU v4", "TPU v6e", "tpu-x"):
        assert proof.backend_peaks(kind) == jroof.backend_peaks(kind)
    import torch
    cpu = (torch.device("cpu"),) * 8
    bw, fl, src = proof.peaks_for_mesh(cpu)
    assert src == "microbench:cpu" and bw > 0 and fl > 0
    assert proof.peaks_for_mesh(cpu) == (bw, fl, src)


def test_device_memory_stats_none_on_cpu():
    import torch
    assert phbm.device_memory_stats((torch.device("cpu"),)) is None
    led = phbm.HbmLedger("fp")
    led.launch_begin(100)
    assert led.reconcile((torch.device("cpu"),), force=True) is None
    assert led.resident_bytes == 100
    led.launch_end(100)
    assert led.stats()["reconciled"] is None


def test_failed_attempt_drops_its_pending_launch_timings():
    """A failed statement keeps no launch timing on its thread (the
    drain's ring settles those); a successful one settles its own."""
    from tidb_tpu_torch.store.client import CopClient

    class Timing:
        settled = 0

        def settle(self):
            self.settled += 1
            return True
    client = CopClient("cpu", 2)
    t = Timing()

    def boom():
        client._local.launches = [t]
        raise ValueError("launch failed")
    with pytest.raises(ValueError, match="launch failed"):
        client._retry(boom)
    assert client._local.launches == [] and t.settled == 0

    def ok():
        client._local.launches = [t]
        return 7
    assert client._retry(ok) == 7
    assert client._local.launches == [] and t.settled == 1


# ------------------------------------------------------------------ #
# the session: spans across threads on the scheduler
# ------------------------------------------------------------------ #

N_ROWS = 3000
QUERIES = ["select count(*) from obs_t where d >= 5",
           "select d, sum(p), count(*) from obs_t group by d",
           "select min(p) from obs_t where q > 10"]


def _rows():
    rng = np.random.default_rng(0)
    return list(zip(rng.integers(1, 50, N_ROWS).tolist(),
                    rng.integers(0, 10, N_ROWS).tolist(),
                    rng.integers(100, 10_000, N_ROWS).tolist()))


def _load(s):
    s.execute("create table obs_t (q bigint, d bigint, p bigint)")
    s.execute("insert into obs_t values "
              + ",".join(f"({a},{b},{c})" for a, b, c in _rows()))
    s.execute("set global tidb_tpu_result_cache_entries = 0")
    s.execute("set global tidb_tpu_trace = 1")
    s.execute("set global tidb_tpu_trace_sample = 1")


def _reset(sched):
    sched.resume()
    sched.configure(max_depth=DEFAULT_QUEUE_DEPTH,
                    max_coalesce=DEFAULT_MAX_COALESCE, fusion=True,
                    window_us=-1)


@pytest.fixture(scope="module")
def pdom():
    """A port Domain on 8 logical CPU devices with obs_t, every trace
    kept, the result cache off, the scheduler started."""
    dom = Domain("cpu", n_devices=8)
    s = Session(dom)
    _load(s)
    s.must_query(QUERIES[0])
    sched = dom.client._sched_obj
    assert sched is not None
    _reset(sched)
    yield dom
    _reset(sched)


def _trace_of(dom, frag):
    for ent in dom.flight_recorder.index():
        if frag in ent["sql"]:
            return dom.flight_recorder.get(ent["trace_id"])
    return None


def _wait_until(pred, msg):
    deadline = time.monotonic() + TIMEOUT
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {msg}")


def test_drain_spans_stitch_before_the_waiter_returns(pdom, monkeypatch):
    """With the drain paused, a statement queues its task; once resumed,
    the drain records sched.queue and sched.launch under the
    statement's cop.dispatch span from the drain thread, and they are
    in the tree when the waiter's wait() returns."""
    from tidb_tpu_torch.store.client import CopClient
    sched = pdom.client._sched_obj
    seen = []
    orig = CopClient._note_sched

    def note(self, task):
        # runs on the waiter right after wait() returned
        ctx = ptrace.current()
        seen.append(sorted({sp.name for sp in ctx.tree.spans}))
        return orig(self, task)
    monkeypatch.setattr(CopClient, "_note_sched", note)
    out, errs = [], []

    def run():
        try:
            out.append(Session(pdom).must_query(QUERIES[1]))
        except Exception as e:  # noqa: BLE001 - asserted below
            errs.append(e)
    sched.pause()
    try:
        th = threading.Thread(target=run, name="conn-a")
        th.start()
        _wait_until(lambda: sched.depth >= 1, "a queued task")
    finally:
        sched.resume()
    th.join(TIMEOUT)
    assert not th.is_alive() and not errs, errs
    assert seen and all({"sched.queue", "sched.launch"} <= set(n)
                        for n in seen), seen
    tree = _trace_of(pdom, "sum(p)")
    spans = {sp.span_id: sp for sp in tree.spans}
    launch = next(sp for sp in tree.spans if sp.name == "sched.launch")
    disp = spans[launch.parent_id]
    assert disp.name == "cop.dispatch" and disp.thread == "conn-a"
    assert launch.thread.startswith("sched-drain")
    assert spans[disp.parent_id].name == "session.ExecuteStmt"
    # on the CPU the device time is the drain's wall
    assert launch.attrs["device_ms"] == launch.attrs["measured_ms"]
    assert {"cop.transfer", "cop.host_merge"} <= {sp.name
                                                  for sp in tree.spans}


def test_two_connections_see_only_their_own_spans(pdom):
    """Two statements on two connections, queued together: each tree
    holds its own statement's spans, every span parented in its own
    tree, and no span of the other's launch."""
    sched = pdom.client._sched_obj
    sqls = {"conn-1": QUERIES[0], "conn-2": QUERIES[2]}
    trees, errs = {}, []

    def run(name, sql):
        try:
            s = Session(pdom)
            s.must_query(sql)
            trees[name] = _trace_of(pdom, sql)
        except Exception as e:  # noqa: BLE001 - asserted below
            errs.append(e)
    sched.pause()
    try:
        ths = [threading.Thread(target=run, args=kv, name=kv[0])
               for kv in sqls.items()]
        for th in ths:
            th.start()
        _wait_until(lambda: sched.depth >= 2, "two queued tasks")
    finally:
        sched.resume()
    for th in ths:
        th.join(TIMEOUT)
        assert not th.is_alive()
    assert not errs, errs
    a, b = trees["conn-1"], trees["conn-2"]
    assert a is not b and a.trace_id != b.trace_id
    for name, tree in trees.items():
        assert tree.sql == sqls[name]
        ids = {sp.span_id for sp in tree.spans}
        assert all(sp.parent_id is None or sp.parent_id in ids
                   for sp in tree.spans)
        session_threads = {sp.thread for sp in tree.spans
                           if not sp.name.startswith("sched.")}
        assert session_threads == {name}
        assert sum(sp.name == "sched.launch" for sp in tree.spans) == 1


def test_trace_off_records_nothing(pdom, monkeypatch):
    """tidb_tpu_trace = 0: no tree, no context variable in the client,
    no trace on the task, no recorder entry, no trace id in the slow
    log; the statement still runs its launch through the scheduler."""
    from tidb_tpu_torch.store.client import CopClient
    s = Session(pdom)
    s.execute("set tidb_tpu_trace = 0")
    s.execute("set tidb_tpu_slow_threshold_ms = 0")
    seen = []
    orig = CopClient._note_sched

    def note(self, task):
        seen.append((ptrace.current(), task.trace))
        return orig(self, task)
    monkeypatch.setattr(CopClient, "_note_sched", note)
    before = pdom.flight_recorder.stats()["seen"]
    launches = pdom.client._sched_obj.launches
    rows = s.must_query(QUERIES[2])
    assert rows and seen and all(c is None and t is None
                                 for c, t in seen)
    assert pdom.flight_recorder.stats()["seen"] == before
    assert pdom.client._sched_obj.launches > launches
    slow = [r for r in s.must_query("show slow_queries")
            if r[0] == QUERIES[2]]
    assert slow and slow[-1][7] == ""
    assert ptrace.current() is None


# ------------------------------------------------------------------ #
# the status routes
# ------------------------------------------------------------------ #

def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


def _status(port, path):
    try:
        urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                               timeout=10)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    return 200, ""


def test_status_routes(pdom, tmp_path):
    """/trace, /trace/<id> and its Chrome export, /hbm, /profile (off,
    started, refused while active, its trace exported) on the CPU;
    /resource answers (tests/test_torch_resource.py holds it against the
    JAX route) and /locksan still answers 501 naming entry 12."""
    s = Session(pdom)
    s.must_query(QUERIES[1])
    srv = StatusServer(pdom)
    port = srv.start()
    try:
        idx = _get(port, "/trace")
        assert idx["stats"]["size"] >= 1
        ent = next(e for e in idx["traces"] if "sum(p)" in e["sql"])
        full = _get(port, f"/trace/{ent['trace_id']}")
        assert full["trace_id"] == ent["trace_id"]
        names = {sp["name"] for sp in full["spans"]}
        assert {"session.ExecuteStmt", "cop.dispatch", "sched.launch",
                "cop.transfer"} <= names
        chrome = _get(port, f"/trace/{ent['trace_id']}?fmt=chrome")
        assert {e["name"] for e in chrome["traceEvents"]
                if e["ph"] == "X"} == names
        assert _status(port, "/trace/nope")[0] == 404
        hbm = _get(port, "/hbm")
        assert {"ledgers", "resident_bytes", "watermark_bytes",
                "calibration", "roofline", "profiler"} <= set(hbm)
        assert hbm["roofline"]["peak_source"] in ("microbench:cpu",
                                                  "unknown")
        assert "refused" in _get(port, "/profile?ms=50")
        s.execute("set global tidb_tpu_profile = 1")
        gate = phbm.profiler_gate()
        started = _get(port, "/profile?ms=200")
        assert started.get("started"), started
        assert started["activities"] == ["CPU"]
        assert "already" in _get(port, "/profile?ms=50")["refused"]
        s.must_query(QUERIES[0])
        _wait_until(lambda: not gate.stats()["active"], "capture end")
        st = gate.stats()
        assert st["trace"], st
        with open(st["trace"]) as f:
            assert "traceEvents" in json.load(f)
        assert "default" in _get(port, "/resource")["groups"]
        code, body = _status(port, "/locksan")
        assert code == 501 and "slice 12" in body, body
        pd_body = _get(port, "/pd")
        assert pd_body["this_domain"] == {"enabled": False}, pd_body
        assert pd_body["status"]["coordinators"] == len(
            pd_body["status"].get("members", ())), pd_body
    finally:
        s.execute("set global tidb_tpu_profile = 0")
        srv.close()


def test_profile_gate_stop_failure_releases(monkeypatch, tmp_path):
    """A stop that fails still releases the gate, as the JAX one does."""
    import torch
    gate = phbm.ProfilerGate()

    class Boom:
        def __init__(self, **kw):
            pass

        def start(self):
            pass

        def stop(self):
            raise RuntimeError("stop failed")
    monkeypatch.setattr(torch.profiler, "profile", Boom)
    assert gate.start(10, str(tmp_path))["started"]
    _wait_until(lambda: not gate.stats()["active"], "gate release")
    assert "stop failed" in gate.stats()["last_error"]

    class NoStart(Boom):
        def start(self):
            raise RuntimeError("no profiler")
    monkeypatch.setattr(torch.profiler, "profile", NoStart)
    out = gate.start(10, str(tmp_path))
    assert "no profiler" in out["refused"] and not gate.stats()["active"]


# ------------------------------------------------------------------ #
# a scheduled statement against the JAX session's
# ------------------------------------------------------------------ #

def _names(tree):
    return [(d, sp.name) for sp, d in tree.ordered()]


@pytest.mark.parametrize("sql", [QUERIES[0], QUERIES[1]])
def test_scheduled_statement_span_names_match_reference(sql, monkeypatch):
    """Both sessions with their schedulers on (the JAX device path
    pinned open; its drain's idle exit shortened and awaited, so no
    drain thread outlives the test): the warm statement's span names
    and depths equal."""
    import tidb_tpu.sched.scheduler as jsched_mod
    monkeypatch.setattr(jsched_mod, "IDLE_EXIT_S", 0.2)
    jdom = JDomain()
    jdom.stats.auto_analyze_enabled = False
    js = JSession(jdom)
    js.execute("set tidb_enable_auto_analyze = 0")
    jdom.client._platform = lambda: "tpu"
    ps = Session(Domain("cpu", n_devices=8))
    for s in (js, ps):
        _load(s)
        s.execute("set global tidb_tpu_sched_fusion = 0")
        s.must_query(sql)                    # cold: builds the program
    try:
        assert ps.must_query(sql) == js.must_query(sql)
        jt = _trace_of(jdom, sql)
        pt = _trace_of(ps.domain, sql)
        assert jdom.client._sched_obj is not None
        assert _names(pt) == _names(jt)
        assert ("sched.launch" in {n for _d, n in _names(pt)})
    finally:
        for s in (js, ps):
            s.execute("set global tidb_tpu_sched_fusion = 1")
        jsched = jdom.client._sched_obj
        _wait_until(lambda: jsched is None or jsched._thread is None,
                    "the JAX drain's exit")
