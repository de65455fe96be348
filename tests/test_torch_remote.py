"""The port's remote store (store/rpc.py, store/server.py,
store/remote.py) against the JAX package.

One module-scoped cluster of two store processes
(``python -m tidb_tpu_torch.store.server``, started with
``CUDA_VISIBLE_DEVICES=""``: the host role) serves a port session whose
client is a ``RemoteCopClient`` on the CPU.  The same table, made from a
seed, lives in a JAX session on its own local store.  Then:

- every statement of the JAX package's remote corpus
  (tests/test_remote_store.py) gives the same rows through the remote
  topology as the JAX session, and as the port's own local client;
- a store's partial states for a range request equal the JAX package's
  host engine over the same rows, bit for bit;
- a write bumps the snapshot's epoch and the client re-ships the table;
- the SQL process serves its own tables as a coprocessor
  (``serve_coprocessor``), and a batch round's cache skips the stores
  that already answered;
- last, because they take the stores down: a store that exits before
  its next response heals (its shards re-home to the survivor), and
  with every store dead the local client answers (``local_fallbacks``).
"""

import numpy as np
import pytest

from tidb_tpu.chunk.column import Column as JColumn
from tidb_tpu.chunk.column import StringDict as JStringDict
from tidb_tpu.copr import hostagg as jhost
from tidb_tpu.store import snapshot_from_columns as j_snapshot
from tidb_tpu_torch.copr import dag as D
from tidb_tpu_torch.copr.aggregate import (finalize, merge_states,
                                           sum_out_dtype)
from tidb_tpu_torch.expr import builders as b
from tidb_tpu_torch.expr.ir import ColumnRef
from tidb_tpu_torch.session import Domain, Session
from tidb_tpu_torch.store.remote import (RemoteCluster, RemoteCopClient,
                                         RemoteStore)
from tidb_tpu_torch.store.server import serve_coprocessor
from tidb_tpu_torch.types import dtypes as dt

from test_torch_dml import jax_domain, jax_session
from test_torch_highndv import _JaxNS

SCHEMA = "create table r (k bigint not null, v bigint, c varchar(10))"


def _insert_rows(n=2000, seed=5):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        color = ["red", "green", "blue"][int(rng.integers(0, 3))]
        v = "null" if rng.random() < 0.1 else str(int(rng.integers(0, 100)))
        rows.append(f"({i}, {v}, '{color}')")
    return "insert into r values " + ",".join(rows)


@pytest.fixture(scope="module")
def cluster():
    c = RemoteCluster(n_stores=2)
    yield c
    c.close()


@pytest.fixture(scope="module")
def sessions(cluster):
    """(JAX session on its local store, port session over the cluster),
    both holding table r."""
    ps = Session(Domain(device="cpu"))
    ps.domain.client = RemoteCopClient(cluster, device="cpu")
    js = jax_session(jax_domain())
    for s in (js, ps):
        s.execute(SCHEMA)
        s.execute(_insert_rows())
    return js, ps


SQL_CORPUS = [
    "select c, count(*), sum(v), min(v), max(v) from r group by c "
    "order by c",
    "select count(*) from r",
    "select k from r where k between 10 and 14 order by k",
    "select k from r order by k desc limit 3",
    "select c, count(*) from r where v > 50 group by c order by c",
    "select count(distinct c) from r",
    "select k, v from r where v is null order by k limit 5",
    "select c, sum(v) from r group by c having sum(v) > 0 order by c",
    "select upper(c), count(*) from r group by upper(c) order by 1",
    "select a1.c, count(*) from r a1 join r a2 on a1.k = a2.k "
    "  group by a1.c order by a1.c",
    "select v, count(*) from r group by v order by v limit 10",
]


@pytest.mark.parametrize("sql", SQL_CORPUS)
def test_remote_rows_equal_the_jax_package(sessions, sql):
    js, ps = sessions
    client = ps.domain.client
    got = ps.execute(sql).rows
    assert got == js.execute(sql).rows, sql
    ps.domain.client = client.inner
    try:
        assert ps.execute(sql).rows == got, sql
    finally:
        ps.domain.client = client


def test_remote_aggregation_went_remote(sessions):
    _js, ps = sessions
    client = ps.domain.client
    before = client.remote_dispatches
    ps.execute("select c, max(v) from r where k < 1500 group by c")
    assert client.remote_dispatches > before
    assert client.local_fallbacks == 0


def _scalar_agg(snap, group=False):
    ts = tuple(snap.dtypes)
    v = ColumnRef(ts[1], 1, "v")
    aggs = (D.AggDesc(D.AggFunc.COUNT, None, dt.bigint(False)),
            D.AggDesc(D.AggFunc.SUM, v, sum_out_dtype(v.dtype)),
            D.AggDesc(D.AggFunc.MIN, v, v.dtype))
    if group:
        return D.Aggregation(D.TableScan((0, 1, 2), ts),
                             (ColumnRef(ts[2], 2, "c"),), aggs,
                             D.GroupStrategy.SORT, group_capacity=64)
    return D.Aggregation(D.TableScan((0, 1, 2), ts), (), aggs,
                         D.GroupStrategy.SCALAR)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v)


@pytest.mark.parametrize("group", [False, True])
def test_store_states_equal_the_jax_host_engine(sessions, cluster, group):
    """A range request's partial states from a store process equal the
    JAX package's host engine over the same rows."""
    _js, ps = sessions
    snap = ps.domain.catalog.get_table("test", "r").snapshot()
    store = cluster.stores[1]
    table = f"check{int(group)}"
    store.request(("load", table, snap.epoch, snap.names, snap.dtypes,
                   snap.columns))
    ranges = [(100, 700), (1200, 1900)]
    kind, got = store.request(("exec_agg", table, snap.epoch,
                               _scalar_agg(snap, group), ranges))
    assert kind == "states"
    jcols = []
    for c in snap.columns:
        t = c.dtype
        jt = _JaxNS.dt.DataType(_JaxNS.dt.TypeKind[t.kind.name], t.nullable,
                                t.prec, t.scale)
        idx = np.concatenate([np.arange(lo, hi) for lo, hi in ranges])
        jcols.append(JColumn(jt, c.data[idx], c.validity[idx],
                             None if c.dictionary is None
                             else JStringDict(list(c.dictionary.values))))
    jsnap = j_snapshot(snap.names, jcols, n_shards=1)
    P = _JaxNS
    jts = tuple(c.dtype for c in jcols)
    jv = P.Ref(jts[1], 1, "v")
    jaggs = (P.D.AggDesc(P.D.AggFunc.COUNT, None, P.dt.bigint(False)),
             P.D.AggDesc(P.D.AggFunc.SUM, jv, P.sum_t(jv.dtype)),
             P.D.AggDesc(P.D.AggFunc.MIN, jv, jv.dtype))
    if group:
        jagg = P.D.Aggregation(P.D.TableScan((0, 1, 2), jts),
                               (P.Ref(jts[2], 2, "c"),), jaggs,
                               P.D.GroupStrategy.SORT, group_capacity=64)
        want = jhost.host_sort_agg(jagg, jsnap)
    else:
        jagg = P.D.Aggregation(P.D.TableScan((0, 1, 2), jts), (), jaggs,
                               P.D.GroupStrategy.SCALAR)
        want = jhost.host_dense_agg(jagg, jsnap)
    want, got = dict(_leaves(want)), dict(_leaves(got))
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and (got[name] == w).all(), name


def test_stale_epoch_reships(sessions):
    js, ps = sessions
    for s in (js, ps):
        s.execute("update r set v = 1 where k = 0")
    sql = "select v, count(*) from r where k < 3 group by v order by v"
    assert ps.execute(sql).rows == js.execute(sql).rows
    assert ps.execute("select v from r where k = 0").rows == [(1,)]


def test_tidb_as_coprocessor():
    """The SQL process serves DAGs over its own catalog tables to a peer
    (executor/coprocessor.go:57), as a store process does."""
    s = Session(Domain(device="cpu"))
    s.execute("create table cop (a bigint not null, b bigint, c bigint, "
              "primary key (a))")
    s.execute("insert into cop values " + ",".join(
        f"({i}, {i % 7}, {i % 3})" for i in range(200)))
    port = serve_coprocessor(s.domain)
    peer = RemoteStore(0, port)
    try:
        assert peer.request(("ping",))[0] == "pong"
        snap = s.domain.catalog.get_table("test", "cop").snapshot()
        agg = _scalar_agg(snap)
        st1 = peer.request(("exec_agg", "test.cop", -1, agg, [(0, 100)]))
        st2 = peer.request(("exec_agg", "test.cop", -1, agg, [(100, 200)]))
        assert st1[0] == "states" and st2[0] == "states"
        _k, cols = finalize(agg, merge_states([st1[1], st2[1]]), [])
        assert int(cols[0].data[0]) == 200
        assert int(cols[1].data[0]) == sum(i % 7 for i in range(200))
        sel = D.Selection(D.TableScan((0, 1, 2), tuple(snap.dtypes)),
                          (b.compare("lt", ColumnRef(dt.bigint(False), 0,
                                                     "a"), b.lit(5)),))
        rows = peer.request(("exec_rows", "test.cop", -1, sel, None,
                             tuple(snap.dtypes)))
        assert rows[0] == "rows" and rows[1][0].data.tolist() == \
            [0, 1, 2, 3, 4]
    finally:
        peer.close()
        s.domain._copr_endpoint[0].close()


def test_batch_round_cache_skips_successful_stores(sessions, cluster):
    """Within one dispatch round a (store, ranges) task set that already
    answered is served from the round cache: the stores are not asked
    again (batch_coprocessor.go's partial retry)."""
    _js, ps = sessions
    client = ps.domain.client
    snap = ps.domain.catalog.get_table("test", "r").snapshot()
    ent = client._snap_meta(snap)
    agg = _scalar_agg(snap)

    def msg(table, ranges):
        return ("exec_agg", table, snap.epoch, agg, ranges)

    def served():
        return {sid: cluster.stores[sid].request(("ping",))[1]
                for sid in cluster.live_ids()}
    rc: dict = {}
    first = client._per_store(ent, snap, msg, rc)
    base = served()
    again = client._per_store(ent, snap, msg, rc)
    after = served()
    assert all(after[sid] - base[sid] == 1 for sid in after), (base, after)
    assert len(again) == len(first) == 2


def test_store_killed_mid_query_heals(sessions, cluster):
    """Store 0 exits before its next response: STORE_UNAVAILABLE, the
    placement excludes it, the shards re-home to store 1, and the same
    statement answers as the JAX session does."""
    js, ps = sessions
    client = ps.domain.client
    sql = "select count(*), sum(v), max(k) from r"
    epochs = sum(ent["placement"].epoch for ent in client._meta.values())
    cluster.stores[0].request(("fail_after", 1))
    assert ps.execute(sql).rows == js.execute(sql).rows
    assert 0 not in cluster.live_ids()
    for ent in client._meta.values():
        if ent["ref"]() is not None:
            assert all(sh.store != 0 for sh in ent["placement"].shards
                       if sh.num_rows)
    assert sum(ent["placement"].epoch
               for ent in client._meta.values()) > epochs


def test_all_stores_dead_fall_back_to_the_local_client(sessions, cluster):
    js, ps = sessions
    client = ps.domain.client
    cluster.close()
    before = client.local_fallbacks
    sql = "select c, count(*), sum(v) from r group by c order by c"
    assert ps.execute(sql).rows == js.execute(sql).rows
    assert client.local_fallbacks > before
