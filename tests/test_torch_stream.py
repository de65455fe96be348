"""The port's streamed path: a snapshot past ``device_mem_cap`` runs as
row-range batches, each placed outside the resident cache
(``ColumnarSnapshot.device_put_uncached``) and reduced by the same
programs and kernels as a resident run.

The same lineitem (the JAX package's generator, carried into the port
as numpy specs) goes through the port's client resident, through the
port's client streamed, and through the JAX package's client, for TPC-H
Q1 (DENSE, its key metas not nullable: ROADMAP.md Queue 3 item 5) and
Q6 (SCALAR), a SORT group-by regrown across the batches, and the rows
route (a filtered projection, a TopN).  Integer and decimal results must
be equal bit for bit; there is no float aggregate here.  Each streamed
DENSE batch runs one ``group_reduce_lanes`` call a logical device, and
every batch of a stream has one program shape; a snapshot that fits
never streams.  On the CPU the batches are plain tensors (no pinned
memory, no copy stream); on the card ``chip_smoke.py`` phase 15 holds the
streamed results against resident ones.
"""

import numpy as np
import pytest
import torch

from tidb_tpu.store import snapshot_from_columns as j_snapshot
from tidb_tpu.testing.tpch import gen_lineitem as j_gen_lineitem
from tidb_tpu_torch.copr import exec as pexec
from tidb_tpu_torch.store import CopClient, snapshot_from_numpy

from test_torch_dense import (Q_COLS, _JaxNS, _PortNS, _jclient, _q1,
                              _q1_meta, _q6, _spec)

SF = 0.002                       # 12,000 lineitem rows
N_DEV = 8
MIN_CAP = 64                     # shard capacity floor: several batches
SORT_COLS = ["l_orderkey", "l_partkey", "l_quantity", "l_extendedprice"]


@pytest.fixture(scope="module")
def q_data():
    names, cols = j_gen_lineitem(SF, seed=0, columns=Q_COLS)
    return names, cols


def _snaps(names, cols):
    return (j_snapshot(names, cols, n_shards=4, min_capacity=MIN_CAP),
            snapshot_from_numpy(names, [_spec(c) for c in cols],
                                min_capacity=MIN_CAP))


def _rows(res):
    out = []
    for i in range(len(res.columns[0])):
        row = []
        for c in res.key_columns + res.columns:
            v = c.data[i]
            row.append((v.item() if hasattr(v, "item") else v)
                       if c.validity[i] else None)
        out.append(tuple(row))
    return sorted(out, key=repr)


def _streaming(snap, parts: int = 5):
    client = CopClient("cpu", N_DEV)
    client.device_mem_cap = snap.device_bytes() // parts
    batches = snap.row_batches(client.device_mem_cap)
    assert batches is not None and len(batches) >= 4
    return client, batches


def _count_reduces(monkeypatch):
    calls = []
    real = pexec.group_reduce_lanes

    def counted(gids, num_groups, lanes):
        calls.append(len(lanes))
        return real(gids, num_groups, lanes)
    monkeypatch.setattr(pexec, "group_reduce_lanes", counted)
    return calls


@pytest.mark.parametrize("which", ["Q1", "Q6"])
def test_streamed_dense_equals_resident_and_jax(q_data, which,
                                                monkeypatch):
    names, cols = q_data
    build = _q1 if which == "Q1" else _q6
    jsnap, snap = _snaps(names, cols)
    meta = _q1_meta(_PortNS, names, cols) if which == "Q1" else []
    jmeta = _q1_meta(_JaxNS, names, cols) if which == "Q1" else []
    agg = build(_PortNS, names, cols)
    client, batches = _streaming(snap)
    calls = _count_reduces(monkeypatch)
    streamed = _rows(client.execute_agg(agg, snap, meta))
    # one reduce call a logical device a batch, every batch recorded
    assert len(calls) == N_DEV * len(batches)
    rec = client.timings["batches"]
    assert [r["rows"] for r in rec] == [b.num_rows for b in batches]
    assert sum(r["rows"] for r in rec) == snap.num_rows
    assert not snap._device_cache        # nothing placed resident
    resident = _rows(CopClient("cpu", N_DEV).execute_agg(agg, snap, meta))
    assert streamed == resident
    assert _rows(_jclient().execute_agg(build(_JaxNS, names, cols), jsnap,
                                        jmeta)) == resident


@pytest.fixture(scope="module")
def sort_data():
    names, cols = j_gen_lineitem(SF, seed=1, columns=SORT_COLS)
    return names, cols


def _sort_agg(P, cap):
    i64, dec2 = P.dt.bigint(False), P.dt.decimal(15, 2)
    scan = P.D.TableScan((0, 1, 2, 3), (i64, i64, dec2, dec2))
    aggs = (P.D.AggDesc(P.D.AggFunc.COUNT, None, i64),
            P.D.AggDesc(P.D.AggFunc.SUM, P.Ref(dec2, 3), P.sum_t(dec2)),
            P.D.AggDesc(P.D.AggFunc.MIN, P.Ref(dec2, 2), dec2))
    return P.D.Aggregation(scan, (P.Ref(i64, 1),), aggs,
                           P.D.GroupStrategy.SORT, group_capacity=cap)


def test_streamed_sort_equals_resident_and_jax(sort_data):
    names, cols = sort_data
    jsnap, snap = _snaps(names, cols)
    meta = [_PortNS.Meta(_PortNS.dt.bigint(False), 0)]
    agg = _sort_agg(_PortNS, 16)
    resident = _rows(CopClient("cpu", N_DEV).execute_agg(agg, snap, meta))
    client, batches = _streaming(snap)
    streamed = client.execute_agg(agg, snap, meta)
    assert _rows(streamed) == resident
    want = _jclient().execute_agg(
        _sort_agg(_JaxNS, 16), jsnap,
        [_JaxNS.Meta(_JaxNS.dt.bigint(False), 0)])
    assert _rows(want) == resident
    buckets = client.timings["buckets"]
    assert len(buckets) > len(batches)            # regrown on the way
    assert buckets[0] == 16 and buckets[-1] > 16
    assert len(client.timings["batches"]) == len(batches)


def _rows_plans(P, names, cols):
    ix = {n: i for i, n in enumerate(names)}
    price = cols[ix["l_extendedprice"]].dtype
    price = P.dt.decimal(price.prec, price.scale)
    scan = P.D.TableScan((ix["l_extendedprice"],), (price,))
    sel = P.D.Selection(scan, (P.b.compare(
        "gt", P.Ref(price, 0), P.b.decimal_lit("30000")),))
    topn = P.D.TopN(scan, sort_key=P.Ref(price, 0), desc=True, limit=7)
    return {"rows": sel, "TopN": topn}, (price,)


@pytest.mark.parametrize("which", ["rows", "TopN"])
def test_streamed_rows_equal_resident_and_jax(q_data, which):
    names, cols = q_data
    jsnap, snap = _snaps(names, cols)
    plans, out_t = _rows_plans(_PortNS, names, cols)
    jplans, jout_t = _rows_plans(_JaxNS, names, cols)
    resident = CopClient("cpu", N_DEV).execute_rows(plans[which], snap,
                                                    out_t)
    client, batches = _streaming(snap)
    streamed = client.execute_rows(plans[which], snap, out_t)
    want = _jclient().execute_rows(jplans[which], jsnap, jout_t)
    assert len(client.timings["batches"]) == len(batches)
    got = [np.sort(np.asarray(r[0].data)) for r in (resident, streamed,
                                                    want)]
    if which == "TopN":
        # candidate unions, re-trimmed by the caller: the top 7 of each
        got = [g[::-1][:7] for g in got]
        price = cols[names.index("l_extendedprice")].data
        np.testing.assert_array_equal(got[0], np.sort(price)[::-1][:7])
    np.testing.assert_array_equal(got[1], got[0])
    np.testing.assert_array_equal(got[2], got[0])


def test_batches_share_one_program_shape(q_data):
    names, cols = q_data
    _jsnap, snap = _snaps(names, cols)
    batches = snap.row_batches(snap.device_bytes() // 6)
    assert batches is not None and len(batches) >= 4
    assert len({b.shard_layout()[:2] for b in batches}) == 1
    assert sum(b.num_rows for b in batches) == snap.num_rows
    # a batch placed on the CPU is the view's own stacking, uncached
    cols_, counts = batches[1].device_put_uncached((torch.device("cpu"),)
                                                   * N_DEV)
    want_cols, want_counts = batches[1].device_cols(
        (torch.device("cpu"),) * N_DEV)
    assert torch.equal(counts, want_counts)
    for (d, v), (wd, wv) in zip(cols_, want_cols):
        assert torch.equal(d, wd) and (v is None) == (wv is None)
        assert v is None or torch.equal(v, wv)


def test_small_snapshot_never_streams(q_data):
    names, cols = q_data
    _jsnap, snap = _snaps(names, cols)
    assert snap.row_batches(snap.device_bytes()) is None
    assert snap.row_batches(0) is None
    client = CopClient("cpu", N_DEV)
    client.device_mem_cap = snap.device_bytes()
    agg = _q6(_PortNS, names, cols)
    client.execute_agg(agg, snap, [])
    assert "batches" not in client.timings and snap._device_cache
