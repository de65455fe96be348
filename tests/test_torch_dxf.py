"""The port's distributed task framework (tidb_tpu_torch/dxf/) against
the JAX package's: the six DXF tests of tests/test_control_plane.py
(the analyze and import-csv tasks through both sessions, failure,
cancel, resume after a restart, the planner's failure, a re-run), and
the three of tests/test_dxf_balancer.py over three port store processes
(``store/remote.RemoteCluster``): ADD INDEX's backfill spread over the
nodes, surviving a node's loss with a complete index, and failing
cleanly when every node dies.
"""

import time

import numpy as np
import pytest

from tidb_tpu.session import Domain as JDomain
from tidb_tpu.session import Session as JSession
from tidb_tpu_torch.dxf import TaskManager, TaskTypeRegistry
from tidb_tpu_torch.dxf.balancer import DXFNodeError, DXFNodePool
from tidb_tpu_torch.session import Domain, Session
from tidb_tpu_torch.store.remote import RemoteCluster


def _pair():
    jd = JDomain()
    jd.client.sched_enable = False          # no scheduler daemon threads
    jd.stats.auto_analyze_enabled = False   # no background ANALYZE
    js = JSession(jd)
    js.execute("set tidb_enable_auto_analyze = 0")
    return js, Session(Domain("cpu"))


def _task_row(t):
    return (t.task_id, t.task_type, t.state, t.error,
            [(s.idx, s.meta, s.state, s.result, s.error)
             for s in t.subtasks])


# ---------------- DXF ---------------- #

def test_dxf_plan_run_succeed():
    out = []
    for s in _pair():
        s.execute("create table a (x bigint)")
        s.execute("create table b (x bigint)")
        s.execute("insert into a values (1),(2)")
        s.execute("insert into b values (3)")
        m = s.domain.dxf
        tid = m.submit("analyze", {"db": "test"})
        t = m.run(tid)
        rows = s.execute("select task_id, type, state, subtasks_done, "
                         "subtasks_total from "
                         "information_schema.dist_tasks").rows
        st = s.domain.stats.get(s.domain.catalog.get_table("test", "a"))
        out.append((_task_row(t), rows, st.count,
                    sorted((c.name, c.ndv) for c in st.cols.values())))
    assert out[1] == out[0]
    task, rows, count, _cols = out[1]
    assert task[2] == "succeed"
    assert sorted(r[3] for r in task[4]) == [1, 2]
    assert rows == [(1, "analyze", "succeed", 2, 2)] and count == 2


def test_dxf_import_csv(tmp_path):
    p = tmp_path / "rows.csv"
    p.write_text("\n".join(f"{i},{i * 2}" for i in range(10_000)) + "\n")
    out = []
    for s in _pair():
        s.execute("create table t (a bigint, b bigint)")
        m = s.domain.dxf
        tid = m.submit("import-csv", {"table": "t", "path": str(p),
                                      "chunk_rows": 2048})
        t = m.run(tid)
        out.append((_task_row(t), s.execute(
            "select count(*), sum(b), min(a), max(a) from t").rows))
    assert out[1] == out[0]
    assert out[1][0][2] == "succeed" and len(out[1][0][4]) == 5
    assert out[1][1] == [(10_000, sum(i * 2 for i in range(10_000)), 0,
                          9_999)]


def test_dxf_failure_and_cancel():
    reg = TaskTypeRegistry()
    reg.register("boom", lambda meta: [{"i": i} for i in range(4)],
                 lambda meta: (_ for _ in ()).throw(
                     RuntimeError(f"sub{meta['i']}")))
    m = TaskManager(workers=2, registry=reg)
    tid = m.submit("boom", {})
    t = m.run(tid)
    assert t.state == "failed" and "sub" in t.error
    assert sorted(s.error for s in t.subtasks) == [f"sub{i}"
                                                   for i in range(4)]
    reg.register("slow", lambda meta: [{} for _ in range(4)],
                 lambda meta: time.sleep(0.01))
    tid2 = m.submit("slow", {})
    m.cancel(tid2)
    assert m.run(tid2).state == "cancelled"


def test_dxf_resume_after_restart(tmp_path):
    """Subtask completions persist as they happen: a restarted manager
    resumes only unfinished subtasks, and the persisted document is the
    JAX package's."""
    from tidb_tpu_torch.dxf import META_TASK
    from tidb_tpu_torch.store.kv import KVStore
    kv = KVStore(path=str(tmp_path / "kv"))
    runs = []
    crash = {"on": True}
    reg = TaskTypeRegistry()

    def work(meta):
        if crash["on"] and meta["i"] >= 2:
            raise RuntimeError("owner crash")   # first run dies partway
        runs.append(meta["i"])
        return meta["i"]

    reg.register("work", lambda meta: [{"i": i} for i in range(4)], work)
    m1 = TaskManager(kv=kv, workers=1, registry=reg)
    tid = m1.submit("work", {})
    assert m1.run(tid).state == "failed"
    assert sorted(runs) == [0, 1]
    crash["on"] = False
    m2 = TaskManager(kv=kv, registry=reg)   # "restarted owner"
    t2 = m2.get(tid)
    assert t2 is not None
    assert [s.state for s in t2.subtasks[:2]] == ["succeed", "succeed"]
    # the persisted record reads back through the JAX package's class
    from tidb_tpu.dxf import DistTask as JDistTask
    blob = next(v for _k, v in kv.scan(META_TASK, META_TASK + b"\xff",
                                       kv.alloc_ts()))
    assert _task_row(JDistTask.from_json(blob)) == _task_row(t2)
    for s_ in t2.subtasks:
        if s_.state == "failed":
            s_.state = "pending"
    out = m2.run(tid)
    assert out.state == "succeed" and out.error == ""
    assert sorted(runs) == [0, 1, 2, 3]  # subtasks 0/1 were NOT re-run


def test_dxf_planner_failure_no_ghost_task():
    s = Session(Domain("cpu"))
    m = s.domain.dxf
    with pytest.raises(FileNotFoundError):
        m.submit("import-csv", {"table": "t", "path": "/no/such/file"})
    assert m.tasks() == []
    assert s.execute("select * from information_schema.dist_tasks").rows \
        == []


def test_dxf_rerun_clears_error():
    reg = TaskTypeRegistry()
    state = {"fail": True}

    def run(meta):
        if state["fail"]:
            raise RuntimeError("flaky")
        return 1

    reg.register("flaky", lambda meta: [{}], run)
    m = TaskManager(workers=1, registry=reg)
    tid = m.submit("flaky", {})
    assert m.run(tid).state == "failed"
    state["fail"] = False
    for s_ in m.get(tid).subtasks:
        if s_.state == "failed":
            s_.state = "pending"
    t = m.run(tid)
    assert t.state == "succeed" and t.error == ""


# ---------------- the balancer over three store processes ---------------- #

N_ROWS = 3000


@pytest.fixture(scope="module")
def cluster_factory():
    made = []

    def make():
        c = RemoteCluster(n_stores=3)
        made.append(c)
        return c
    yield make
    for c in made:
        c.close()


def _mk_session(pool):
    s = Session(Domain("cpu"))
    s.domain.dxf_pool = pool
    s.execute("create table b (k bigint primary key, v bigint, "
              "w varchar(8))")
    rng = np.random.default_rng(11)
    rows = ",".join(
        f"({i}, {int(rng.integers(0, 500))}, "
        f"'{['aa', 'bb', 'cc'][int(rng.integers(0, 3))]}')"
        for i in range(N_ROWS))
    s.execute("insert into b values " + rows)
    return s


def _check_index_complete(s, name="iv"):
    """Every row has exactly one index entry (ADMIN CHECK TABLE re-derives
    entries from rows; the raw count catches duplicates), and a read
    through the index equals a scan."""
    from tidb_tpu_torch.store.codec import index_prefix, index_prefix_end
    tbl = s.domain.catalog.get_table("test", "b")
    ix = tbl.index_by_name(name)
    assert ix is not None and ix.state == "public"
    ts = tbl.kv.alloc_ts()
    n = sum(1 for _ in tbl.kv.scan(
        index_prefix(tbl.table_id, ix.index_id),
        index_prefix_end(tbl.table_id, ix.index_id), ts))
    assert n == N_ROWS, n
    s.execute("admin check table b")
    assert s.execute("select count(*) from b where v = 17").rows == \
        s.execute("select count(*) from b ignore index (iv) "
                  "where v = 17").rows


def test_distributed_backfill_across_nodes(cluster_factory):
    cluster = cluster_factory()
    pool = DXFNodePool(cluster.stores)
    s = _mk_session(pool)
    s.execute("alter table b add index iv (v)")
    _check_index_complete(s)
    counts = [pool.per_node[st.store_id] for st in cluster.stores]
    assert all(c > 0 for c in counts), counts
    assert sum(counts) >= N_ROWS // 512


def test_backfill_survives_node_loss(cluster_factory):
    cluster = cluster_factory()
    pool = DXFNodePool(cluster.stores)
    s = _mk_session(pool)
    # store 0 dies after serving 2 more requests — mid-reorg
    cluster.stores[0].request(("fail_after", 2))
    s.execute("alter table b add index iv (v)")
    _check_index_complete(s)
    assert cluster.stores[0].store_id in pool.dead
    assert pool.rebalanced >= 1
    survivors = [pool.per_node[st.store_id] for st in cluster.stores[1:]]
    assert sum(survivors) > 0


def test_all_nodes_dead_fails_cleanly(cluster_factory):
    cluster = cluster_factory()
    pool = DXFNodePool(cluster.stores)
    s = _mk_session(pool)
    for st in cluster.stores:
        st.request(("fail_after", 1))
    with pytest.raises(Exception):
        s.execute("alter table b add index iv (v)")
    tbl = s.domain.catalog.get_table("test", "b")
    assert tbl.index_by_name("iv") is None
    with pytest.raises(DXFNodeError):
        pool.run_subtasks([1], lambda st: ("ping",), lambda st, r: None)
