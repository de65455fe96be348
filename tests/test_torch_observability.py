"""The port's statement observability through its Session against the
JAX package's Session, on the CPU.

Both sessions load the same tables (``obs_t`` from a seed, a small
``dim`` for a join, a JSON column ``j`` with NULLs and a non-JSON
document) over their own domains, with their admission schedulers on
(the JAX client's device path pinned open, as tests/test_obs.py pins
it; its drain's idle exit shortened so no drain thread outlives the
module) and the result caches off.  With times removed, these are
equal:

- ``EXPLAIN ANALYZE``: the operator labels (the cop task's device name
  mapped to the JAX package's) with ``actRows`` and ``loops``; of the
  cop task's runtime detail, its launch counts (``tasks``, ``fused``)
  and the compile verdict.  Its ``ru`` and ``hbm`` figures are left
  out: they price the calibrated LaunchCost, whose feedback (measured
  times and peaks) differs by package, and the JAX package's planner
  narrows proven aggregation states the port keeps at full width.
- ``TRACE``'s span names and depths;
- ``SHOW STATEMENTS_SUMMARY`` (digest, executions, rows, sample
  statement, device tasks and fused tasks) and ``SHOW SLOW_QUERIES``
  at a zero threshold (statement, rows, retries, a trace id);
- ``SHOW STATUS``, with the JAX package's two quirks pinned: ``Uptime``
  and ``Queries`` read 0;
- ``PLAN REPLAYER DUMP``'s zip entries, its statement and schema;
- every JSON function the planner names, over the JSON column (NULLs
  and a non-JSON document among its rows) and constants, bad paths
  raising the same error class.
"""

import io
import re
import time
import zipfile

import numpy as np
import pytest

import tidb_tpu.sched.scheduler as jsched_mod
from tidb_tpu.session import Domain as JDomain
from tidb_tpu.session import Session as JSession
from tidb_tpu_torch.session import Domain, Session

N_ROWS = 2000

SETUP = [
    "create table obs_t (q bigint, d bigint, p bigint)",
    "create table dim (k bigint, v bigint, name varchar(10))",
    "insert into dim values " + ",".join(
        f"({k}, {k % 4}, 'n{k}')" for k in range(10)),
    "create table j (id bigint, doc json)",
    """insert into j values
        (1, '{"a": 1, "b": {"c": "x"}, "arr": [1,2,3]}'),
        (2, '{"a": 2, "k": "v"}'), (3, 'not json'), (4, NULL),
        (5, '[1, {"a": "x"}, "abc"]'), (6, '"str"'), (7, '3.5'),
        (8, '{"a": [1, 2], "b": null}')""",
    "set global tidb_tpu_result_cache_entries = 0",
    "set global tidb_tpu_trace_sample = 1",
]

SELECTS = {
    "scalar": "select count(*), sum(p) from obs_t where d >= 5",
    "dense": "select d, sum(p), count(*) from obs_t where q < 20 "
             "group by d order by d",
    "topn": "select q, p from obs_t where q > 45 order by p desc, q "
            "limit 5",
    "join": "select dim.name, count(*) from obs_t join dim "
            "on obs_t.d = dim.k where dim.v > 1 group by dim.name "
            "order by dim.name",
    "json": "select id, json_type(doc) from j where json_valid(doc) = 1 "
            "order by id",
}


def _obs_rows():
    rng = np.random.default_rng(7)
    return list(zip(rng.integers(1, 50, N_ROWS).tolist(),
                    rng.integers(0, 10, N_ROWS).tolist(),
                    rng.integers(100, 10_000, N_ROWS).tolist()))


def _load(s):
    for sql in SETUP:
        s.execute(sql)
    s.execute("insert into obs_t values "
              + ",".join(f"({a},{b},{c})" for a, b, c in _obs_rows()))


@pytest.fixture(scope="module")
def pair():
    saved = jsched_mod.IDLE_EXIT_S
    jsched_mod.IDLE_EXIT_S = 0.2
    jdom = JDomain()
    jdom.stats.auto_analyze_enabled = False
    js = JSession(jdom)
    jdom.client._platform = lambda: "tpu"
    ps = Session(Domain("cpu", n_devices=8))
    for s in (js, ps):
        s.execute("set tidb_enable_auto_analyze = 0")
        _load(s)
        for sql in SELECTS.values():
            s.must_query(sql)             # warm: every program built
    try:
        yield js, ps
    finally:
        jsched = jdom.client._sched_obj
        deadline = time.monotonic() + 30
        while jsched is not None and jsched._thread is not None \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        jsched_mod.IDLE_EXIT_S = saved


def _detail(label: str) -> str:
    """A cop task's runtime detail with times, RUs and memory removed."""
    m = re.search(r" \[(schedWait: [^\]]*)\]$", label)
    if m is None:
        return label
    keep = []
    for part in m.group(1).split(", "):
        key, _, val = part.partition(": ")
        if key in ("tasks", "fused", "retried"):
            keep.append(part)
        elif key == "compile":
            keep.append(f"compile: {val.split()[0]}")
        elif part == "degraded":
            keep.append(part)
    return label[:m.start()] + " [" + ", ".join(keep) + "]"


def _explain_analyze(s, sql):
    res = s.execute("explain analyze " + sql)
    rows = []
    for op, act, tm, loops in res.rows:
        assert tm is None or tm.endswith("ms")
        rows.append((_detail(op.replace("-> TPU", "-> cpu")), act, loops))
    return res.names, rows


@pytest.mark.parametrize("case", sorted(SELECTS))
def test_explain_analyze_equals_reference(pair, case):
    js, ps = pair
    want = _explain_analyze(js, SELECTS[case])
    got = _explain_analyze(ps, SELECTS[case])
    assert got == want
    assert got[0] == ["operator", "actRows", "time", "loops"]


def _trace_names(s, sql):
    res = s.execute("trace " + sql)
    assert res.names == ["operation", "startTS_us", "duration_us"]
    return [re.sub(r" \{.*\}$", "", r[0]) for r in res.rows]


@pytest.mark.parametrize("case", ["scalar", "dense", "topn"])
def test_trace_span_names_equal_reference(pair, case):
    js, ps = pair
    got = _trace_names(ps, SELECTS[case])
    assert got == _trace_names(js, SELECTS[case])
    for name in ("session.ExecuteStmt", "  planner.Optimize",
                 "  executor.Run", "    cop.dispatch",
                 "      sched.launch"):
        assert name in got, got


def test_trace_of_a_write_statement(pair):
    js, ps = pair
    sql = "insert into dim values (99, 3, 'n99')"
    assert _trace_names(ps, sql) == _trace_names(js, sql) == [
        "session.ExecuteStmt", "  executor.Run"]
    for s in (js, ps):
        s.execute("delete from dim where k = 99")


def _summary(s):
    res = s.execute("show statements_summary")
    assert res.names == ["Digest_text", "Exec_count", "Avg_latency_ms",
                         "Max_latency_ms", "Sum_rows", "Sample_sql",
                         "Avg_sched_wait_ms", "Avg_compile_ms",
                         "Sum_sched_tasks", "Sum_fused", "Avg_ru"]
    return sorted((r[0], r[1], r[4], r[5], r[8], r[9]) for r in res.rows)


def test_statements_summary_equals_reference(pair):
    js, ps = pair
    for s in (js, ps):
        for sql in SELECTS.values():
            s.must_query(sql)
    got = _summary(ps)
    assert got == _summary(js)
    by_digest = {r[0]: r for r in got}
    dense = by_digest[SELECTS["dense"].replace("20", "?")]
    assert dense[1] >= 2 and dense[4] >= 2


def test_slow_queries_equals_reference(pair):
    js, ps = pair
    out = []
    for s in (js, ps):
        s.execute("set tidb_tpu_slow_threshold_ms = 0")
        try:
            s.must_query(SELECTS["scalar"])
            s.must_query(SELECTS["topn"])
            res = s.execute("show slow_queries")
        finally:
            s.execute("set tidb_tpu_slow_threshold_ms = 300")
        assert res.names == ["Query", "Latency_ms", "Rows",
                             "Sched_wait_ms", "Compile_ms", "Ru",
                             "Retried", "Trace_id"]
        rows = [r for r in res.rows
                if r[0] in (SELECTS["scalar"], SELECTS["topn"])][-2:]
        assert all(re.fullmatch(r"[0-9a-f]+-[0-9a-f]{6}", r[7])
                   for r in rows), rows
        # the slow log's trace id names a trace the recorder kept
        assert s.domain.flight_recorder.get(rows[-1][7]) is not None
        out.append([(r[0], r[2], r[6]) for r in rows])
    assert out[1] == out[0]
    assert [r[1] for r in out[1]] == [1, 5]


def test_show_status_quirks_equal_reference(pair):
    """Uptime reads a Domain._t0 nothing sets and Queries a
    StmtSummary.rows() that does not exist: both 0, in both packages."""
    js, ps = pair
    for sql in ("show status", "show status like 'u%'"):
        want = js.execute(sql)
        got = ps.execute(sql)
        assert (got.names, got.rows) == (want.names, want.rows)
    rows = dict(ps.execute("show status").rows)
    assert rows["Uptime"] == "0" and rows["Queries"] == "0"
    assert rows["Threads_connected"] == "1"


def _replayer(s, sql):
    import os
    import tempfile
    token = s.execute("plan replayer dump explain " + sql).rows[0][0]
    path = os.path.join(tempfile.gettempdir(), "tidb_tpu_replayer", token)
    with open(path, "rb") as f:
        z = zipfile.ZipFile(io.BytesIO(f.read()))
    os.remove(path)
    return token, z


def test_plan_replayer_entries_equal_reference(pair):
    js, ps = pair
    sql = SELECTS["join"]
    jt, jz = _replayer(js, sql)
    pt, pz = _replayer(ps, sql)
    assert re.fullmatch(r"replayer_[0-9a-f]+\.zip", pt)
    assert pz.namelist() == jz.namelist() == [
        "sql/sql.sql", "plan.txt", "schema/schema.sql", "stats.json",
        "variables.json", "meta.txt"]
    for name in ("sql/sql.sql", "schema/schema.sql", "stats.json",
                 "meta.txt"):
        assert pz.read(name) == jz.read(name), name
    assert "CopTask" in pz.read("plan.txt").decode()


# every JSON function the planner names (planner/build.py), over the
# column and constants; NULL arguments and bad paths among them
JSON_EXPRS = [
    "json_extract(doc, '$.a')", "json_extract(doc, '$.arr[1]')",
    "json_extract(doc, '$[1].a')", "json_unquote(json_extract(doc, "
    "'$.b.c'))", "json_unquote(doc)", "json_type(doc)", "json_valid(doc)",
    "json_length(doc)", "json_length(doc, '$.a')",
    "json_contains(doc, '1', '$.a')", "json_contains(doc, '2')",
    "json_set(doc, '$.a', 10)", "json_insert(doc, '$.z', 'n')",
    "json_replace(doc, '$.a', 'r')", "json_remove(doc, '$.a')",
    "json_keys(doc)", "json_keys(doc, '$.b')",
    "json_search(doc, 'one', 'x')", "json_search(doc, 'all', 'x', NULL)",
    "json_merge_patch(doc, '{\"m\": 1}')",
    "json_merge_preserve(doc, '[7]')", "json_merge(doc, '{\"a\": 9}')",
    "json_array_append(doc, '$.arr', 4)", "json_pretty(doc)",
    "json_quote(json_type(doc))", "json_value(doc, '$.a')",
    "json_depth(doc)", "json_contains_path(doc, 'one', '$.a', '$.q')",
    "json_storage_size(doc)", "json_overlaps(doc, '{\"a\": 1}')",
    "json_extract(NULL, '$.a')", "json_array(1, 'x', NULL)",
    "json_object('k', 2, 'n', NULL)", "json_array()",
]

BAD_JSON = [
    "select json_extract(doc, 'a') from j",
    "select json_length(doc, '$[') from j",
    "select json_object('k') from j",
    "select json_array(id) from j",
    "select json_extract(doc) from j",
]


def _outcome(s, sql):
    try:
        res = s.execute(sql)
    except Exception as e:   # the error class is compared across
        return ("error", type(e).__name__)
    return ("ok", res.rows)


@pytest.mark.parametrize("expr", JSON_EXPRS)
def test_json_function_equals_reference(pair, expr):
    js, ps = pair
    sql = f"select id, {expr} from j order by id"
    got = _outcome(ps, sql)
    assert got == _outcome(js, sql), sql
    assert got[0] == "ok" and len(got[1]) == 8


@pytest.mark.parametrize("sql", BAD_JSON)
def test_json_bad_call_raises_as_reference(pair, sql):
    js, ps = pair
    got = _outcome(ps, sql)
    assert got == _outcome(js, sql)
    assert got[0] == "error"


def test_json_predicate_on_the_device(pair):
    js, ps = pair
    sql = ("select count(*) from j where json_valid(doc) = 1 "
           "and json_type(doc) = 'OBJECT'")
    assert ps.must_query(sql) == js.must_query(sql) == [(3,)]
    plan = "\n".join(r[0] for r in ps.must_query("explain " + sql))
    assert "CopTask[agg]" in plan, plan


def test_telemetry_report_equals_reference(pair, tmp_path):
    """The report's shape, schema, workload and feature flags equal the
    JAX package's; its hardware names the port's device (the CPU here)
    where the JAX one reads jax.devices(); no file unless
    tidb_enable_telemetry is on."""
    from tidb_tpu.utils import telemetry as jtele
    from tidb_tpu_torch.utils import telemetry as ptele
    js, ps = pair
    want, got = jtele.collect(js.domain), ptele.collect(ps.domain)
    assert sorted(got) == sorted(want)
    for key in ("version", "schema", "features"):
        assert got[key] == want[key], key
    assert got["workload"]["distinct_digests"] > 0
    assert got["hardware"]["platform"] == "cpu"
    assert got["hardware"]["device_count"] == 1
    path = tmp_path / "report.json"
    assert ptele.report(ps.domain, str(path)) is None
    assert not path.exists()
    ps.execute("set global tidb_enable_telemetry = 1")
    try:
        assert ptele.report(ps.domain, str(path)) == str(path)
    finally:
        ps.execute("set global tidb_enable_telemetry = 0")
    import json
    assert json.loads(path.read_text())["schema"] == got["schema"]
