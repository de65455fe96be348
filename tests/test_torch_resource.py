"""Resource control through the port's session against the JAX one.

Each test runs the same SQL through a JAX ``Session`` and a port
``Session``, each on its own ``Domain`` over the same seeded numpy table
(the port's on 8 logical CPU devices, as the JAX one sees 8 CPU
devices), and holds the outcomes equal: the resource-group statements
with ``information_schema.resource_groups`` and the ``PlanError`` texts,
throttling, the runaway actions (KILL, COOLDOWN, SWITCH_GROUP), the RU
reports of ``EXPLAIN ANALYZE`` and the statement summary, the device
time each queued group is given, and the ``/resource`` route.

The port keeps no CPU engine choice: its aggregates launch through the
scheduler, priced at the drain.  So where a test needs the device path,
the JAX client's platform is pinned to "tpu", as the JAX package's own
rc tests pin it; its drain's idle exit is shortened and awaited at the
test's end, so no JAX drain thread outlives the test.  RU figures are
held equal exactly (both packages price the same ``LaunchCost``);
what reads the clock (a throttled loop's wall, a runaway's elapsed
time) is held by a bound stated in the test.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import tidb_tpu.sched.scheduler as jsched_mod
from tidb_tpu.planner.build import PlanError as JPlanError
from tidb_tpu.rc.controller import DEFAULT_OVERDRAFT_RU as JOVERDRAFT
from tidb_tpu.server.status import StatusServer as JStatusServer
from tidb_tpu.session import Domain as JDomain
from tidb_tpu.session import Session as JSession
from tidb_tpu.sql.parser import ParseError as JParseError
from tidb_tpu.sql.parser import parse_sql as jparse
from tidb_tpu_torch.planner.build import PlanError
from tidb_tpu_torch.rc.controller import DEFAULT_OVERDRAFT_RU
from tidb_tpu_torch.rc.pricing import MIN_TASK_RU
from tidb_tpu_torch.server.status import StatusServer
from tidb_tpu_torch.session import Domain, Session
from tidb_tpu_torch.sql.parser import ParseError, parse_sql

TIMEOUT = 60.0
Q = "select sum(a*b) from t where b < 7"


def _wait_until(pred, msg="condition", timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 50, n), rng.integers(0, 10, n)


@pytest.fixture
def pair(monkeypatch):
    """``make(n, pin)``: a JAX and a port session over table ``t (a, b)``
    of ``n`` seeded rows, the result cache off; ``pin`` pins the JAX
    client's platform to "tpu" (the device path the port always takes).
    At the end the JAX drain is awaited and the overdraft put back."""
    monkeypatch.setattr(jsched_mod, "IDLE_EXIT_S", 0.2)
    made = []

    def make(n=400, pin=True):
        jdom = JDomain()
        jdom.stats.auto_analyze_enabled = False
        js = JSession(jdom)
        js.execute("set tidb_enable_auto_analyze = 0")
        if pin:
            jdom.client._platform = lambda: "tpu"
        else:
            jdom.client.sched_enable = False
        ps = Session(Domain("cpu", n_devices=8))
        a, b = _data(n)
        for s in (js, ps):
            s.execute("create table t (a bigint, b bigint)")
            s.execute("insert into t values "
                      + ",".join(f"({x},{y})" for x, y in zip(a, b)))
            s.execute("set global tidb_tpu_result_cache_entries = 0")
        made.append((js, ps))
        return js, ps, (a, b)

    yield make
    for js, ps in made:
        for s, default in ((js, JOVERDRAFT), (ps, DEFAULT_OVERDRAFT_RU)):
            sched = s.domain.client._sched_obj
            if sched is not None:
                sched.resume()
                sched.rc_overdraft_ru = default
        jsched = js.domain.client._sched_obj
        _wait_until(lambda: jsched is None or jsched._thread is None,
                    "the JAX drain's exit")


def _outcome(sess, sql):
    """A statement's rows, or its error's kind and text."""
    try:
        return ("ok", sess.execute(sql).rows)
    except (JPlanError, PlanError) as e:
        return ("error", type(e).__name__, str(e))


def _both(js, ps, sqls):
    """Each statement's outcome through each session; they must agree."""
    want = [_outcome(js, sql) for sql in sqls]
    got = [_outcome(ps, sql) for sql in sqls]
    assert got == want
    return got


# ------------------------------------------------------------------ #
# the statements
# ------------------------------------------------------------------ #

LIFECYCLE = [
    "create resource group rg RU_PER_SEC = 1000 BURSTABLE",
    "select name, ru_per_sec, burstable from "
    "information_schema.resource_groups order by name",
    "create resource group rg RU_PER_SEC = 1",
    "create resource group if not exists rg RU_PER_SEC = 5",
    "select ru_per_sec, burstable from information_schema.resource_groups "
    "where name = 'rg'",
    "alter resource group rg RU_PER_SEC = 2000",
    "select ru_per_sec, burstable from information_schema.resource_groups "
    "where name = 'rg'",
    "alter resource group missing RU_PER_SEC = 1",
    "create resource group hi RU_PER_SEC = 0 PRIORITY = HIGH",
    "create resource group lim RU_PER_SEC = 10 "
    "QUERY_LIMIT = (EXEC_ELAPSED = '2s' ACTION = COOLDOWN)",
    "alter resource group lim PRIORITY = LOW",
    "create resource group bad RU_PER_SEC = 1 QUERY_LIMIT = "
    "(EXEC_ELAPSED = '1s' ACTION = SWITCH_GROUP(nope))",
    "create resource group tgt RU_PER_SEC = 1",
    "create resource group watcher RU_PER_SEC = 1 QUERY_LIMIT = "
    "(EXEC_ELAPSED = '1s' ACTION = SWITCH_GROUP(tgt))",
    "select * from information_schema.resource_groups order by name",
    "drop resource group tgt",
    "select * from information_schema.resource_groups order by name",
    "set resource group nope",
    "set resource group rg",
    "select count(*) from t where a > 10",
    "set resource group default",
    "drop resource group rg",
    "drop resource group rg",
    "drop resource group if exists rg",
    "drop resource group default",
    "select * from information_schema.resource_groups order by name",
]


def test_resource_group_lifecycle_equals_jax(pair):
    """CREATE (IF NOT EXISTS), ALTER merging only the options it names,
    DROP (IF EXISTS, never ``default``), SET and the SWITCH_GROUP target
    checks: every outcome, rows and PlanError texts, equal."""
    js, ps, _ = pair(pin=False)
    got = _both(js, ps, LIFECYCLE)
    assert ("rg", 1000, "YES") in got[1][1]
    assert got[2][0] == got[7][0] == got[11][0] == "error"
    assert got[6][1] == [(2000, "YES")]
    # dropping an armed target disarms the watcher to cooldown
    assert ("watcher", 1, "NO", 1.0, "COOLDOWN", 0, "MEDIUM") in got[16][1]
    assert [o[0] for o in got[-5:]] == ["ok", "error", "ok", "error", "ok"]


# ------------------------------------------------------------------ #
# throttling
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("path", ["host", "device"])
def test_limited_group_blocks_and_default_does_not(pair, path):
    """A 4 RU/s group blocks more than 0.8 s over 10 statements (10 RU
    less at most 1 s of burst), and ``default`` does not, in both
    packages: a host-only statement pays its row charge at its end; a
    device statement is held at the drain once its group's bucket cannot
    cover it (overdraft 0)."""
    js, ps, _ = pair(pin=path == "device")
    sql = "select 1" if path == "host" else "select count(*) from t"
    out = []
    for s in (js, ps):
        if path == "device":
            s.execute("set global tidb_tpu_rc_overdraft_ru = 0")
        s.execute("create resource group slow RU_PER_SEC = 4")
        want = s.must_query(sql)              # warm the program
        s.execute("set resource group slow")
        t0 = time.monotonic()
        rows = [s.must_query(sql) for _ in range(10)]
        limited = time.monotonic() - t0
        s.execute("set resource group default")
        t0 = time.monotonic()
        rows += [s.must_query(sql) for _ in range(10)]
        free = time.monotonic() - t0
        assert rows == [want] * 20
        out.append((limited > 0.8, free < 0.8, want))
    assert out[1] == out[0] == (True, True, out[0][2])


# ------------------------------------------------------------------ #
# the runaway actions
# ------------------------------------------------------------------ #

def _last_record(sess):
    rec = sess.domain.resource_groups.runaway_ring.records()[-1]
    return rec["group"], rec["action"], rec["target"]


def _runaway_count(sess, group):
    return sess.must_query("select runaway_count from "
                           "information_schema.resource_groups "
                           f"where name = '{group}'")[0][0]


def test_runaway_kill_raises_on_a_read(pair):
    """KILL raises ``RunawayError`` (errno 8253) on a read-only
    statement; the session stays usable and the group counts it."""
    js, ps, _ = pair()
    out = []
    for s in (js, ps):
        s.execute("create resource group tight RU_PER_SEC = 0 "
                  "QUERY_LIMIT = (EXEC_ELAPSED = '1ms' ACTION = KILL)")
        s.execute("set resource group tight")
        with pytest.raises(Exception) as ei:
            s.must_query("select count(*) from t where a > 1")
        s.execute("set resource group default")
        out.append((type(ei.value).__name__, ei.value.errno, str(ei.value),
                    s.must_query("select 1"), _last_record(s),
                    _runaway_count(s, "tight") >= 1))
    assert out[1] == out[0]
    assert out[0][:2] == ("RunawayError", 8253) and out[0][-1]


def test_runaway_kill_spares_committed_dml(pair):
    """A write in a KILL group commits: the watch runs after it, so its
    rows stand and it counts as runaway only."""
    js, ps, _ = pair(n=300)
    out = []
    for s in (js, ps):
        s.execute("create resource group w RU_PER_SEC = 0 "
                  "QUERY_LIMIT = (EXEC_ELAPSED = '1ms' ACTION = KILL)")
        s.execute("set resource group w")
        affected = s.execute("insert into t select a + 9999, b from t")\
            .affected
        s.execute("set resource group default")
        out.append((affected,
                    s.must_query("select count(*) from t where a >= 9999"),
                    _last_record(s), _runaway_count(s, "w") >= 1))
    assert out[1] == out[0] == (300, [(300,)], ("w", "kill", ""), True)


def test_runaway_cooldown_double_charges(pair):
    """COOLDOWN does not kill: the statement's rows come back and its
    group pays its priced RUs twice, the same RUs in both packages."""
    js, ps, _ = pair()
    out = []
    for s in (js, ps):
        s.execute("create resource group cd RU_PER_SEC = 100000 "
                  "QUERY_LIMIT = (EXEC_ELAPSED = '1ms' ACTION = COOLDOWN)")
        s.must_query("select count(*) from t")           # warm
        s.execute("set resource group cd")
        g = s.domain.resource_groups.get("cd")
        d0 = g.bucket.debited
        rows = s.must_query("select count(*) from t")
        s.execute("set resource group default")
        out.append((rows, round(g.bucket.debited - d0, 9), _last_record(s),
                    _runaway_count(s, "cd") >= 1))
    assert out[1] == out[0]
    assert out[0][0] == [(400,)]
    assert out[0][1] == 2 * MIN_TASK_RU and out[0][2][1] == "cooldown"


def test_runaway_switch_group_reprices(pair):
    """SWITCH_GROUP moves the statement's debit to the target group; the
    ring records the switch and the memtable shows the armed target."""
    js, ps, _ = pair()
    out = []
    for s in (js, ps):
        s.execute("create resource group batch RU_PER_SEC = 1000")
        s.execute("create resource group hot RU_PER_SEC = 1000 "
                  "QUERY_LIMIT = (EXEC_ELAPSED = '1ms' "
                  "ACTION = SWITCH_GROUP(batch))")
        s.must_query("select count(*) from t where a > 1")   # warm
        s.execute("set resource group hot")
        batch = s.domain.resource_groups.get("batch")
        hot = s.domain.resource_groups.get("hot")
        b0, h0 = batch.bucket.debited, hot.bucket.debited
        rows = s.must_query("select count(*) from t where a > 1")
        s.execute("set resource group default")
        out.append((rows, round(batch.bucket.debited - b0, 9),
                    round(hot.bucket.debited - h0, 9), _last_record(s),
                    _runaway_count(s, "hot") >= 1,
                    s.must_query("select runaway_action from "
                                 "information_schema.resource_groups "
                                 "where name = 'hot'")))
    assert out[1] == out[0]
    assert out[0][1] > 0 and out[0][3] == ("hot", "switch_group", "batch")
    assert out[0][5] == [("SWITCH_GROUP(batch)",)]


def test_switch_group_parse_errors():
    """SWITCH_GROUP without a target is a parse error in both parsers;
    with one, both give the same action and target."""
    bad = ("create resource group x QUERY_LIMIT = "
           "(EXEC_ELAPSED = '1s' ACTION = SWITCH_GROUP)")
    with pytest.raises(JParseError):
        jparse(bad)
    with pytest.raises(ParseError):
        parse_sql(bad)
    for text in ("(EXEC_ELAPSED = 'abc' ACTION = KILL)",
                 "(EXEC_ELAPSED = '1s' ACTION = KILLL)"):
        sql = f"create resource group b QUERY_LIMIT = {text}"
        with pytest.raises(JParseError):
            jparse(sql)
        with pytest.raises(ParseError):
            parse_sql(sql)
    good = ("create resource group x QUERY_LIMIT = "
            "(EXEC_ELAPSED = '1s' ACTION = SWITCH_GROUP(other))")
    j, p = jparse(good)[0], parse_sql(good)[0]
    assert (p.action, p.switch_target, p.exec_elapsed_sec) == \
        (j.action, j.switch_target, j.exec_elapsed_sec) == \
        ("switch_group", "other", 1.0)


# ------------------------------------------------------------------ #
# the RU reports
# ------------------------------------------------------------------ #

def _ru_of(explain_rows):
    text = "\n".join(str(r[0]) for r in explain_rows)
    assert "schedWait" in text and "ru:" in text, text
    return float(text.split("ru: ", 1)[1].split(",", 1)[0].rstrip("]"))


def test_explain_analyze_and_summary_report_ru(pair):
    """EXPLAIN ANALYZE's cop task shows the RUs it was priced, and the
    statement summary's ``Avg_ru`` (last column, also in the memtable)
    the statement's: equal in both packages."""
    js, ps, _ = pair(n=600)
    out = []
    for s in (js, ps):
        ru = _ru_of(s.execute("explain analyze " + Q).rows)
        s.must_query(Q)
        res = s.execute("show statements_summary")
        i_ru = res.names.index("Avg_ru")
        avg = sorted(r[i_ru] for r in res.rows if "sum(a" in r[0])
        mem = s.must_query(
            "select avg_ru from information_schema.statements_summary "
            "where digest_text like '%sum(a%'")
        out.append((ru, res.names[-1], avg, sorted(mem)))
    assert out[1] == out[0]
    assert out[0][0] >= MIN_TASK_RU and out[0][1] == "Avg_ru"
    assert all(v >= 1.0 for v in out[0][2])


def test_device_time_attributed_to_each_queued_group(pair):
    """Two groups' statements queued together (the drain paused): after
    the drain, each group has device time and at least the floor RU,
    and the per-digest map is filled, in both packages."""
    js, ps, (a, b) = pair(n=3000)
    m = b < 7
    want_a = [(int((a[m] * b[m]).sum()),)]
    q2 = "select count(*) from t where b < 7"
    want_b = [(int(m.sum()),)]
    for s in (js, ps):
        s.execute("create resource group ga RU_PER_SEC = 0 PRIORITY = HIGH")
        s.execute("create resource group gb RU_PER_SEC = 0 PRIORITY = LOW")
        assert s.must_query(Q) == want_a and s.must_query(q2) == want_b
        dom = s.domain
        sess_cls = type(s)
        sched = dom.client._sched_obj
        before = {g: dict(sched.stats()["groups"].get(g) or {})
                  for g in ("ga", "gb")}
        got, errors = {}, []

        def run(grp, sql, tag, dom=dom, sess_cls=sess_cls):
            sess = sess_cls(dom)
            sess.execute(f"set resource group {grp}")
            try:
                got[tag] = sess.must_query(sql)
            except Exception as e:  # noqa: BLE001 - surfaced below
                errors.append(e)

        sched.pause()
        threads = [threading.Thread(target=run, args=("ga", Q, "a")),
                   threading.Thread(target=run, args=("gb", q2, "b"))]
        try:
            for t in threads:
                t.start()
            _wait_until(lambda: sched.depth >= 2, "2 queued cop tasks")
        finally:
            sched.resume()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not errors, errors
        assert got == {"a": want_a, "b": want_b}
        st = sched.stats()
        for grp in ("ga", "gb"):
            g = st["groups"][grp]
            assert g["device_ms"] > before[grp].get("device_ms", 0.0), g
            assert g["rus"] - before[grp].get("rus", 0.0) >= MIN_TASK_RU
        assert st["digest_device_ms"], st


# ------------------------------------------------------------------ #
# /resource
# ------------------------------------------------------------------ #

def _get(srv_cls, dom, route):
    srv = srv_cls(dom)
    port = srv.start()
    try:
        return json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}{route}", timeout=10).read())
    finally:
        srv.close()


def test_resource_route_equals_jax(pair):
    """``/resource`` answers with the JAX route's keys: the top level,
    each group's budget and scheduler fields, and the runaway ring; a
    declared group shows its rate and a positive balance."""
    js, ps, _ = pair()
    for s in (js, ps):
        s.execute("create resource group viewme RU_PER_SEC = 777")
        s.execute("create resource group k RU_PER_SEC = 0 "
                  "QUERY_LIMIT = (EXEC_ELAPSED = '1ms' ACTION = COOLDOWN)")
        s.execute("set resource group k")
        s.must_query("select count(*) from t")
        s.execute("set resource group default")
    want = _get(JStatusServer, js.domain, "/resource")
    got = _get(StatusServer, ps.domain, "/resource")
    assert set(got) == set(want)
    assert set(got["runaway"]) == set(want["runaway"])
    mine = set(ps.domain.resource_groups.resource_stats())
    assert mine == set(js.domain.resource_groups.resource_stats()) == \
        {"default", "viewme", "k"}
    assert mine <= set(got["groups"]) and mine <= set(want["groups"])
    for name in mine:
        assert set(got["groups"][name]) == set(want["groups"][name]), name
    assert set(got["groups"]["k"]) >= {"tasks", "queued", "rus",
                                       "throttled", "device_ms"}
    for body in (got, want):
        v = body["groups"]["viewme"]
        assert v["ru_per_sec"] == 777 and v["balance"] > 0
        assert body["groups"]["k"]["runaway_count"] >= 1
        assert body["runaway"]["records"][-1]["action"] == "cooldown"
        assert body["rc_enable"] is True
