"""The port's background workers against the JAX package's: the timer
framework (tidb_tpu_torch/timer), the TTL sweep (ttl/, the same rows
deleted as the JAX sweep for the same rows and the same fixed ``now``),
the GC worker, the Domain's ``start_background``/``close``, the
auto-analyze timer (statistics equal to the JAX handle's), the async
stats load (``StatsHandle.request_load``) and the workload repository.

Every timer thread a test starts is closed by it (``Domain.close`` joins
the framework's thread): a daemon thread left running at exit is a
hazard of the parity files (ROADMAP.md, pinned hazards).
"""

import calendar
import threading
import time

import numpy as np
import pytest

from tidb_tpu.session import Domain as JDomain
from tidb_tpu.session import Session as JSession
from tidb_tpu.store.gcworker import GCWorker as JGCWorker
from tidb_tpu.ttl import run_ttl_sweep as j_run_ttl_sweep
from tidb_tpu.ttl import sweep_table as j_sweep_table
from tidb_tpu_torch.session import Domain, Session
from tidb_tpu_torch.session.catalog import CatalogError
from tidb_tpu_torch.store.gcworker import GCWorker
from tidb_tpu_torch.timer import TimerFramework
from tidb_tpu_torch.ttl import BATCH_ROWS, run_ttl_sweep, sweep_table


def _jsession():
    d = JDomain()
    d.client.sched_enable = False          # no scheduler daemon threads
    d.stats.auto_analyze_enabled = False   # no background ANALYZE
    s = JSession(d)
    s.execute("set tidb_enable_auto_analyze = 0")
    return s


def _pair():
    return _jsession(), Session(Domain("cpu"))


def _rows(s, sql):
    return sorted(s.execute(sql).rows)


# ------------------------------------------------------------------ #
# the timer framework
# ------------------------------------------------------------------ #

def test_timer_framework_fires_and_isolates_errors():
    fw = TimerFramework(tick=0.02)
    hits = []
    fw.register("ok", 0.01, lambda: hits.append(1))
    fw.register("boom", 0.01, lambda: 1 / 0)
    fw.start()
    deadline = time.time() + 3
    while len(hits) < 2 and time.time() < deadline:
        time.sleep(0.02)
    fw.close()
    assert len(hits) >= 2
    boom = [t for t in fw.timers() if t.name == "boom"][0]
    assert "ZeroDivisionError" in boom.last_error
    ok = [t for t in fw.timers() if t.name == "ok"][0]
    assert ok.last_error == ""


def test_timer_close_joins_its_thread_and_trigger_is_synchronous():
    fw = TimerFramework(tick=0.02)
    seen = []
    fw.register("slow", 3600.0, lambda: seen.append(
        threading.current_thread().name))
    fw.trigger("slow")                   # fires on the caller's thread
    assert seen == [threading.current_thread().name]
    t = fw.register("never", 3600.0, lambda: None)
    t.enabled = False
    fw.start()
    assert any(th.name == "timer-fw" for th in threading.enumerate())
    fw.close()
    assert not fw._thread.is_alive()
    assert [x.fire_count for x in fw.timers()] == [1, 0]


# ------------------------------------------------------------------ #
# TTL: the same rows deleted as the JAX sweep
# ------------------------------------------------------------------ #

def _ttl_table(s, n, seed, kind):
    """``n`` rows of (id, created) with created spread around the cutoff
    and one in ten NULL, the same in both packages."""
    rng = np.random.default_rng(seed)
    col = "datetime" if kind == "datetime" else "date"
    s.execute(f"create table ev (id bigint, created {col}) "
              "TTL = created + INTERVAL 1 DAY")
    base = calendar.timegm((2020, 1, 6, 0, 0, 0))
    offs = rng.integers(-5 * 86400, 2 * 86400, n)
    vals = []
    for i, o in enumerate(offs):
        if i % 10 == 3:
            vals.append(f"({i}, NULL)")
            continue
        t = time.gmtime(int(base + o))
        txt = (time.strftime("%Y-%m-%d %H:%M:%S", t) if kind == "datetime"
               else time.strftime("%Y-%m-%d", t))
        vals.append(f"({i}, '{txt}')")
    for k in range(0, n, 2000):
        s.execute("insert into ev values " + ",".join(vals[k:k + 2000]))
    return s.domain.catalog.get_table("test", "ev")


@pytest.mark.parametrize("kind,n,seed", [("datetime", 300, 1),
                                         ("date", 300, 2),
                                         ("datetime", 2 * BATCH_ROWS + 700, 3)])
def test_ttl_sweep_deletes_the_rows_the_jax_sweep_deletes(kind, n, seed):
    js, ps = _pair()
    jt, pt = _ttl_table(js, n, seed, kind), _ttl_table(ps, n, seed, kind)
    assert (pt.ttl_col, pt.ttl_interval_sec) == (jt.ttl_col,
                                                 jt.ttl_interval_sec)
    now = calendar.timegm((2020, 1, 6, 0, 0, 1))
    deleted = sweep_table(pt, now=now)
    assert deleted == j_sweep_table(jt, now=now) > 0
    assert _rows(ps, "select id from ev") == _rows(js, "select id from ev")
    assert _rows(ps, "select count(*), sum(id) from ev") == \
        [(n - deleted, int(sum(r[0] for r in
                               js.execute("select id from ev").rows)))]
    assert sweep_table(pt, now=now) == 0            # idempotent


def test_ttl_enable_off_skips_sweep():
    for s, sweep in zip(_pair(), (j_run_ttl_sweep, run_ttl_sweep)):
        s.execute("create table ev2 (id bigint, d date) "
                  "TTL = d + INTERVAL 1 DAY TTL_ENABLE = 'OFF'")
        s.execute("insert into ev2 values (1, '2000-01-01')")
        assert sweep(s.domain) == {}
        assert s.execute("select count(*) from ev2").rows == [(1,)]


def test_ttl_requires_temporal_column():
    s = Session(Domain("cpu"))
    with pytest.raises(CatalogError):
        s.execute("create table bad (id bigint) TTL = id + INTERVAL 1 DAY")


def test_run_ttl_sweep_covers_all_databases():
    outs = []
    for s, sweep in zip(_pair(), (j_run_ttl_sweep, run_ttl_sweep)):
        s.execute("create database ttldb")
        s.execute("use ttldb")
        s.execute("create table t (id bigint, d date) "
                  "TTL = d + INTERVAL 1 DAY")
        s.execute("insert into t values (1, '2000-01-01'), (2, '2099-01-01')")
        outs.append((sweep(s.domain), s.execute("select id from t").rows))
    assert outs[1] == outs[0] == ({"ttldb.t": 1}, [(2,)])


# ------------------------------------------------------------------ #
# GC
# ------------------------------------------------------------------ #

def test_gc_worker_drops_the_versions_the_jax_worker_drops():
    out = []
    for s, Gc in zip(_pair(), (JGCWorker, GCWorker)):
        s.execute("create table g (a bigint, b bigint)")
        s.execute("insert into g values (1, 1), (2, 2)")
        for i in range(5):    # churn: each update rewrites the row
            s.execute(f"update g set b = {i} where a = 1")
        s.execute("delete from g where a = 2")
        kv = s.domain.kv
        gc = Gc(kv, life_seconds=10.0)
        t0 = time.time()
        first = gc.run_once(now=t0)          # nothing older than life yet
        dropped = gc.run_once(now=t0 + 11.0)
        out.append((first, dropped, s.execute("select a, b from g").rows))
    assert out[1] == out[0]
    assert out[1][0] == 0 and out[1][1] > 0 and out[1][2] == [(1, 4)]


# ------------------------------------------------------------------ #
# the Domain's background workers
# ------------------------------------------------------------------ #

def test_domain_background_workers_start_and_close():
    dom = Domain("cpu")
    timers = dom.start_background()
    assert dom.start_background() is timers          # idempotent
    names = {t.name for t in timers.timers()}
    assert names == {"gc", "ttl", "auto-analyze", "workload-repo"}
    jd = JDomain()
    jd.client.sched_enable = False
    jt = jd.start_background()
    try:
        assert {(t.name, t.interval) for t in timers.timers()} == \
            {(t.name, t.interval) for t in jt.timers()}
    finally:
        jd.close()
    timers.trigger("gc")
    timers.trigger("ttl")
    timers.trigger("workload-repo")
    assert all(t.last_error == "" for t in timers.timers())
    dom.close()
    assert not timers._thread.is_alive()


def test_ttl_timer_then_an_aggregate_equals_numpy_on_the_kept_rows():
    dom = Domain("cpu")
    s = Session(dom)
    rng = np.random.default_rng(19)
    n = 3000
    now = time.time()
    age = rng.integers(0, 4 * 86400, n)      # seconds old; TTL 2 days
    # no row within a minute of the cutoff: the sweep runs a moment
    # after ``now`` and must find each row on its side
    age[np.abs(age - 2 * 86400) < 60] += 120
    price = rng.integers(1, 10_000, n)
    s.execute("create table ev (id bigint, price bigint, created datetime) "
              "TTL = created + INTERVAL 2 DAY")
    stamp = [time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime(int(now - x)))
             for x in age]
    s.execute("insert into ev values " + ",".join(
        f"({i}, {p}, '{t}')" for i, (p, t) in enumerate(zip(price, stamp))))
    keep = age < 2 * 86400
    dom.start_background().trigger("ttl")
    try:
        assert s.execute("select count(*), sum(price) from ev").rows == \
            [(int(keep.sum()), int(price[keep].sum()))]
        assert sorted(r[0] for r in s.execute("select id from ev").rows) \
            == np.nonzero(keep)[0].tolist()
    finally:
        dom.close()


def _analyze_pair(n, seed):
    """A table of ``n`` rows in both packages, through SQL."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 500, n)
    b = rng.integers(-10 ** 6, 10 ** 6, n)
    js, ps = _pair()
    for s in (js, ps):
        s.execute("create table aa (a bigint, b bigint, c double)")
        for k in range(0, n, 2500):
            s.execute("insert into aa values " + ",".join(
                f"({x}, {y}, {y / 7:.3f})"
                for x, y in zip(a[k:k + 2500], b[k:k + 2500])))
    return js, ps, a, b


def _stats_equal(jts, pts):
    assert (pts.count, pts.modify_count) == (jts.count, jts.modify_count)
    assert sorted(pts.cols) == sorted(jts.cols)
    for name in jts.cols:
        g, w = pts.cols[name], jts.cols[name]
        assert (g.ndv, g.null_count, g.count) == (w.ndv, w.null_count,
                                                  w.count), name
        assert np.array_equal(g.hist.bounds, w.hist.bounds), name
        assert np.array_equal(g.hist.cum_counts, w.hist.cum_counts), name
        assert list(g.topn.values.items()) == list(w.topn.values.items())
        assert np.array_equal(g.cms.table, w.cms.table), name


def test_auto_analyze_timer_builds_the_jax_statistics():
    js, ps, _a, _b = _analyze_pair(4000, 5)
    jt = js.domain.catalog.get_table("test", "aa")
    pt = ps.domain.catalog.get_table("test", "aa")
    assert ps.domain.stats.get(pt) is None
    timers = ps.domain.start_background()
    try:
        ps.execute("set global tidb_enable_auto_analyze = 1")
        timers.trigger("auto-analyze")
        js.domain.stats.auto_analyze_enabled = True
        js.domain._auto_analyze_sweep()
        _stats_equal(js.domain.stats.get(jt), ps.domain.stats.get(pt))
        # a fresh table needs no second sweep: the timer is a no-op
        v = ps.domain.stats.get(pt).version
        timers.trigger("auto-analyze")
        assert ps.domain.stats.get(pt).version == v
        auto = [t for t in timers.timers() if t.name == "auto-analyze"][0]
        assert auto.fire_count == 2 and auto.last_error == ""
    finally:
        ps.domain.close()


def test_auto_analyze_under_concurrent_statements_stays_exact():
    """The auto-analyze timer's ANALYZE (sorts and reductions on the
    Domain's device) runs while four threads send an aggregate: every
    result stays exact, and the statistics equal a plain ANALYZE's."""
    js, ps, a, b = _analyze_pair(6000, 6)
    q = "select count(*), sum(b) from aa where a < 250"
    want = [(int((a < 250).sum()), int(b[a < 250].sum()))]
    errors, done = [], threading.Event()

    def worker():
        s = Session(ps.domain)
        # only the timer analyzes: the statements' own auto-analyze and
        # stats load stay off in their sessions
        s.execute("set tidb_enable_auto_analyze = 0")
        while not done.is_set():
            try:
                got = s.execute(q).rows
                if got != want:
                    errors.append(got)
            except Exception as e:   # noqa: BLE001 - collected, failed below
                errors.append(repr(e))
    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    timers = ps.domain.start_background()
    try:
        ps.execute("set global tidb_enable_auto_analyze = 1")
        timers.trigger("auto-analyze")
    finally:
        done.set()
        for t in threads:
            t.join()
        ps.domain.close()
    assert errors == []
    auto = [t for t in timers.timers() if t.name == "auto-analyze"][0]
    assert auto.last_error == ""
    pt = ps.domain.catalog.get_table("test", "aa")
    js.execute("analyze table aa")
    _stats_equal(js.domain.stats.get(js.domain.catalog.get_table("test",
                                                                  "aa")),
                 ps.domain.stats.get(pt))


def test_auto_analyze_timer_follows_the_domain_sysvar():
    """The timer's sweep is gated as the inline auto-analyze is: off
    with the Domain's default ``tidb_enable_auto_analyze = 0``, and
    ``SET GLOBAL`` turns it on and off again."""
    _js, ps, _a, _b = _analyze_pair(3000, 9)
    pt = ps.domain.catalog.get_table("test", "aa")
    timers = ps.domain.start_background()
    try:
        timers.trigger("auto-analyze")
        assert ps.domain.stats.get(pt) is None       # the default: off
        ps.execute("set global tidb_enable_auto_analyze = 1")
        timers.trigger("auto-analyze")
        assert ps.domain.stats.get(pt) is not None
        ps.domain.stats._cache.clear()
        ps.execute("set global tidb_enable_auto_analyze = 0")
        timers.trigger("auto-analyze")
        assert ps.domain.stats.get(pt) is None
        auto = [t for t in timers.timers() if t.name == "auto-analyze"][0]
        assert auto.fire_count == 3 and auto.last_error == ""
    finally:
        ps.domain.close()


def test_request_load_analyzes_in_the_background_as_the_jax_handle_does():
    js, ps, _a, _b = _analyze_pair(3000, 7)
    jt = js.domain.catalog.get_table("test", "aa")
    pt = ps.domain.catalog.get_table("test", "aa")
    # the handles' own gate and the row floor decide, in both packages
    for h, t in ((js.domain.stats, jt), (ps.domain.stats, pt)):
        h.auto_analyze_enabled = False
        assert h.request_load(t) is False
        h.auto_analyze_enabled = True
    assert ps.domain.stats.request_load(pt) is True
    assert js.domain.stats.request_load(jt) is True
    deadline = time.time() + 60
    # both loads done, their threads past the analyze (a JAX thread alive
    # at interpreter exit is a hazard)
    while time.time() < deadline and (ps.domain.stats._loading
                                      or js.domain.stats._loading):
        time.sleep(0.05)
    _stats_equal(js.domain.stats.get(jt), ps.domain.stats.get(pt))
    assert ps.domain.stats.request_load(pt) is False   # has stats now
    js.domain.stats.auto_analyze_enabled = False


def test_the_session_requests_a_load_only_with_auto_analyze_on():
    _js, ps, _a, _b = _analyze_pair(3000, 8)
    pt = ps.domain.catalog.get_table("test", "aa")
    h = ps.domain.stats
    calls = []
    real = h.request_load
    h.request_load = lambda t: calls.append(t) or False
    try:
        ps.execute("select count(*) from aa where a < 3")
        assert calls == []                  # the Domain's default: off
        # (the inline auto-analyze runs first and finds the table
        # unanalyzed: it analyzes, so the load finds stats and declines)
        ps.execute("set tidb_enable_auto_analyze = 1")
        ps.execute("select count(*) from aa where a < 4")
        assert calls == [pt]
        assert h.get(pt) is not None
        ps.execute("select count(*) from information_schema.tables")
        assert calls == [pt]                # never a memtable
    finally:
        h.request_load = real


def test_workload_repository_snapshots():
    s = Session(Domain("cpu"))
    s.execute("create table wr (a bigint)")
    s.execute("insert into wr values (1),(2)")
    s.execute("select count(*) from wr")
    s.domain.snapshot_workload_repo()
    s.execute("select sum(a) from wr")
    s.domain.snapshot_workload_repo()
    rows = s.execute(
        "select snapshot_ts, sql_digest, exec_count from "
        "information_schema.workload_repo_statements").rows
    assert len(rows) >= 3
    assert any("count" in r[1] for r in rows)
    timers = s.domain.start_background()
    n = len(s.domain.workload_repo)
    timers.trigger("workload-repo")
    s.domain.close()
    assert len(s.domain.workload_repo) > n
