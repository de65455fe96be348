"""The port's row store against the JAX package's.

The port builds its own copy of the native MVCC engine
(``tidb_tpu_torch/native/kvstore.cpp``) into ``tidb_tpu_torch/_build/``
and binds it in ``tidb_tpu_torch/store/kv.py``; both engines load into
this one process (``RTLD_LOCAL``), so the same seeded operations run
through each: gets, scans, the percolator 2PC, write conflicts, locks,
pessimistic locks with deadlock and lock-wait errors, GC, keyspaces and
the durable WAL + checkpoint mode.  Every value, error code and
timestamp is equal.  The row codec is held bit for bit: ``encode_row``,
record keys, index keys and entries equal the reference's as bytes.  The
catalog's encoding on KV (``session/meta.py``), the AUTO_INCREMENT
service and the GC worker are held against theirs too.
"""

import threading
import time

import numpy as np
import pytest

from tidb_tpu.store import codec as jcodec
from tidb_tpu.store import gcworker as jgc
from tidb_tpu.store import kv as jkv
from tidb_tpu.session import autoid as jautoid
from tidb_tpu.types import dtypes as jdt
from tidb_tpu_torch.store import codec, gcworker, kv
from tidb_tpu_torch.session import autoid
from tidb_tpu_torch.types import dtypes as dt

THREAD_LIMIT_S = 20.0     # each threaded test's own time limit


def _stores(**kw):
    return kv.KVStore(**kw), jkv.KVStore(**kw)


def _outcome(fn):
    """A call's value, or the code of the KVError it raised."""
    try:
        return ("ok", fn())
    except kv.KVError as e:
        return ("err", type(e).__name__, e.code)
    except jkv.KVError as e:
        return ("err", type(e).__name__, e.code)


def _run(store, script):
    """Run one op script on a store; returns every outcome in order."""
    txns, out = {}, []
    for op in script:
        name = op[0]
        if name == "begin":
            txns[op[1]] = store.begin(pessimistic=op[2])
            out.append(("ok", txns[op[1]].start_ts))
        elif name == "put":
            out.append(_outcome(lambda: txns[op[1]].put(op[2], op[3])))
        elif name == "delete":
            out.append(_outcome(lambda: txns[op[1]].delete(op[2])))
        elif name == "commit":
            out.append(_outcome(lambda: txns[op[1]].commit()))
        elif name == "rollback":
            out.append(_outcome(lambda: txns[op[1]].rollback()))
        elif name == "tget":
            out.append(_outcome(lambda: txns[op[1]].get(op[2])))
        elif name == "tscan":
            out.append(_outcome(lambda: list(txns[op[1]].scan(op[2], op[3]))))
        elif name == "get":
            out.append(_outcome(lambda: store.get(op[1], store.alloc_ts())))
        elif name == "scan":
            out.append(_outcome(lambda: list(
                store.scan(op[1], op[2], store.alloc_ts(), limit=op[3]))))
        elif name == "gc":
            out.append(("ok", store.gc(store.alloc_ts())))
        elif name == "flush":
            out.append(("ok", store.flush()))
    out.append(("keys", store.num_keys()))
    return out


def _script(seed, n_ops=160, n_keys=12):
    """A seeded interleaving of transactions over a few keys: puts,
    deletes, reads inside and outside transactions, commits (some of
    which conflict or hit locks), rollbacks, flushes and GC."""
    rng = np.random.default_rng(seed)
    keys = [b"k%02d" % i for i in range(n_keys)]
    live, script, nxt = [], [], 0
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.15 or not live:
            script.append(("begin", nxt, bool(rng.random() < 0.2)))
            live.append(nxt)
            nxt += 1
            continue
        t = live[int(rng.integers(len(live)))]
        k = keys[int(rng.integers(n_keys))]
        if r < 0.45:
            script.append(("put", t, k, b"v%d" % int(rng.integers(1000))))
        elif r < 0.52:
            script.append(("delete", t, k))
        elif r < 0.60:
            script.append(("tget", t, k))
        elif r < 0.64:
            lo, hi = sorted(rng.choice(n_keys, 2, replace=False))
            script.append(("tscan", t, keys[lo], keys[hi]))
        elif r < 0.72:
            script.append(("get", k))
        elif r < 0.76:
            script.append(("scan", b"k", b"l", int(rng.integers(1, 20))))
        elif r < 0.90:
            script.append(("commit", t))
            live.remove(t)
        elif r < 0.96:
            script.append(("rollback", t))
            live.remove(t)
        elif r < 0.98:
            script.append(("flush",))
        else:
            script.append(("gc",))
    # pessimistic locks never wait here: a blocked lock would wait on a
    # transaction only this thread could end
    return [op if op[0] != "begin" else ("begin", op[1], False)
            for op in script]


@pytest.mark.parametrize("seed", range(6))
def test_kv_script_equals_the_jax_store(seed):
    ps, js = _stores()
    try:
        got, want = _run(ps, _script(seed)), _run(js, _script(seed))
        assert got == want
        # the scripts reach the 2PC's conflicts and locks
        codes = {o[2] for o in want if o[0] == "err"}
        if seed == 0:
            assert codes & {kv.ERR_LOCKED, kv.ERR_WRITE_CONFLICT}
    finally:
        ps.close()
        js.close()


def test_kv_engine_is_the_ports_build():
    """The port loads the engine it built from its own source, named by
    the source's hash, never the JAX package's library."""
    ps, js = _stores()
    so = kv.library_path()
    assert so.parent.name == "_build"
    assert so.parent.parent.name == "tidb_tpu_torch"
    assert so.name.startswith("libtpukv-") and so.exists()
    assert ps._lib._name == str(so)
    assert js._lib._name != ps._lib._name
    # both engines serve their own stores side by side
    for s in (ps, js):
        t = s.begin()
        t.put(b"a", b"1")
        t.commit()
        assert s.get(b"a", s.alloc_ts()) == b"1"
    ps.close()
    js.close()


def test_kv_build_failure_raises(tmp_path, monkeypatch):
    """A g++ failure raises with its output; nothing else is loaded."""
    bad = tmp_path / "kvstore.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(kv, "_SRC", bad)
    monkeypatch.setattr(kv, "_BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        kv.build_library()


@pytest.mark.parametrize("kind", ["pessimistic block", "deadlock",
                                  "lock wait timeout", "for update release"])
def test_pessimistic_locks_equal_the_jax_store(kind):
    """The same pessimistic interleaving on each store gives the same
    outcome (threaded: each case joins its threads within
    ``THREAD_LIMIT_S``)."""
    results = []
    for mod in (kv, jkv):
        s = mod.KVStore()
        t0 = s.begin()
        t0.put(b"a", b"0")
        t0.put(b"b", b"0")
        t0.commit()
        res = {}
        if kind == "pessimistic block":
            def bump(tag, s=s, res=res):
                t = s.begin(pessimistic=True)
                t.lock_keys([b"a"], wait_ms=5000)
                cur = int(t.get(b"a"))
                time.sleep(0.02)
                t.put(b"a", b"%d" % (cur + 1))
                t.commit()
                res[tag] = True
            ths = [threading.Thread(target=bump, args=(i,))
                   for i in range(2)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(THREAD_LIMIT_S)
                assert not th.is_alive()
            res = {"done": sorted(res), "a": s.get(b"a", s.alloc_ts())}
        elif kind == "deadlock":
            t1 = s.begin(pessimistic=True)
            t2 = s.begin(pessimistic=True)
            t1.lock_keys([b"a"])
            t2.lock_keys([b"b"])

            def t1_wants_b(t1=t1, res=res, mod=mod):
                try:
                    t1.lock_keys([b"b"], wait_ms=8000)
                    res["t1"] = "ok"
                except mod.DeadlockError:
                    res["t1"] = "deadlock"
            th = threading.Thread(target=t1_wants_b)
            th.start()
            time.sleep(0.15)
            try:
                t2.lock_keys([b"a"], wait_ms=8000)
                res["t2"] = "ok"
            except mod.DeadlockError:
                res["t2"] = "deadlock"
            th.join(THREAD_LIMIT_S)
            assert not th.is_alive()
            res = sorted(res.values())
        elif kind == "lock wait timeout":
            t1 = s.begin(pessimistic=True)
            t1.lock_keys([b"a"])
            t2 = s.begin(pessimistic=True)
            try:
                t2.lock_keys([b"a"], wait_ms=150)
                res["t2"] = "ok"
            except mod.LockWaitTimeout as e:
                res["t2"] = ("timeout", e.code)
            t1.rollback()
            t2.lock_keys([b"a"], wait_ms=150)
            res["after"] = "ok"
            t2.rollback()
        else:
            t1 = s.begin(pessimistic=True)
            t1.lock_keys([b"a"])
            t1.commit()
            t2 = s.begin(pessimistic=True)
            t2.lock_keys([b"a"], wait_ms=100)
            res["relocked"] = True
            t2.rollback()
        results.append(res)
        s.close()
    assert results[0] == results[1]


def test_keyspaces_equal_the_jax_store():
    for mod in (kv, jkv):
        s = mod.KVStore()
        a, b = s.with_keyspace("ta"), s.with_keyspace("tb")
        for view, v in ((a, b"A"), (b, b"B")):
            t = view.begin()
            t.put(b"k", v)
            t.commit()
        ts = s.alloc_ts()
        got = (a.get(b"k", ts), b.get(b"k", ts), s.get(b"k", ts),
               list(a.scan(b"", b"", ts)), list(b.scan(b"", b"", ts)))
        if mod is kv:
            port = got
        s.close()
    assert port == got == (b"A", b"B", None, [(b"k", b"A")], [(b"k", b"B")])


def test_durable_wal_and_checkpoint_equal_the_jax_store(tmp_path):
    """Committed writes survive a reopen from the WAL, an open
    transaction does not, the history stays readable, and a checkpoint
    truncates the WAL: the same on both engines."""
    out = []
    for mod in (kv, jkv):
        p = str(tmp_path / mod.__name__.split(".")[0] / "kv")
        import os
        os.makedirs(os.path.dirname(p))
        s1 = mod.KVStore(path=p)
        t = s1.begin()
        t.put(b"a", b"1")
        t.put(b"b", b"2")
        t.commit()
        mid = s1.alloc_ts()
        t = s1.begin()
        t.put(b"a", b"3")
        t.delete(b"b")
        t.commit()
        open_txn = s1.begin()
        open_txn.put(b"c", b"9")
        s2 = mod.KVStore(path=p)
        ts = s2.alloc_ts()
        row = [s2.get(b"a", ts), s2.get(b"b", ts), s2.get(b"c", ts),
               s2.get(b"a", mid), s2.get(b"b", mid)]
        n = s2.checkpoint()
        row += [n, os.path.getsize(p + ".wal")]
        t = s2.begin()
        t.put(b"post", b"w")
        t.commit()
        s3 = mod.KVStore(path=p)
        ts3 = s3.alloc_ts()
        row += [s3.get(b"a", ts3), s3.get(b"post", ts3)]
        for s in (s1, s2, s3):
            s.close()
        out.append(row)
    assert out[0] == out[1]
    assert out[0][:5] == [b"3", None, None, b"1", b"2"]


# ------------------------------------------------------------------ #
# the codec, bit for bit
# ------------------------------------------------------------------ #

def _types(m):
    return [m.bigint(True), m.ubigint(True), m.double(True),
            m.decimal(12, 2, True), m.decimal(30, 4, True),
            m.date(True), m.datetime(True), m.varchar(True),
            m.time(True), m.bit(8, True)]


def _rows(seed, n=60):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        r = [int(rng.integers(-2**62, 2**62)), int(rng.integers(0, 2**63)),
             float(rng.normal() * 1e6),
             f"{int(rng.integers(-10**9, 10**9)) / 100:.2f}",
             f"{int(rng.integers(-10**12, 10**12))}."
             f"{int(rng.integers(0, 10**4)):04d}",
             f"{int(rng.integers(1970, 2030))}-"
             f"{int(rng.integers(1, 13)):02d}-{int(rng.integers(1, 29)):02d}",
             f"2001-02-03 {int(rng.integers(0, 24)):02d}:"
             f"{int(rng.integers(0, 60)):02d}:{int(rng.integers(0, 60)):02d}",
             "".join(chr(int(c)) for c in rng.integers(97, 123,
                                                       int(rng.integers(0, 9)))),
             int(rng.integers(0, 86_400_000_000)),
             int(rng.integers(0, 256))]
        for i in range(len(r)):
            if rng.random() < 0.15:
                r[i] = None
        rows.append(r)
    return rows


@pytest.mark.parametrize("seed", range(3))
def test_encode_row_is_byte_equal(seed):
    ptypes, jtypes = _types(dt), _types(jdt)
    for r in _rows(seed):
        b = codec.encode_row(r, ptypes)
        assert b == jcodec.encode_row(r, jtypes)
        assert codec.decode_row(b, ptypes) == jcodec.decode_row(b, jtypes)


@pytest.mark.parametrize("seed", range(3))
def test_index_keys_are_byte_equal(seed):
    ptypes, jtypes = _types(dt), _types(jdt)
    rng = np.random.default_rng(100 + seed)
    for r in _rows(seed):
        tid, iid = int(rng.integers(1, 10**6)), int(rng.integers(1, 50))
        h = int(rng.integers(-2**40, 2**40))
        assert codec.record_key(tid, h) == jcodec.record_key(tid, h)
        assert codec.decode_record_key(codec.record_key(tid, h)) == (tid, h)
        cols = [i for i in range(len(r)) if i != 4]   # no wide decimal
        for i in cols:
            assert codec.encode_index_value(r[i], ptypes[i]) == \
                jcodec.encode_index_value(r[i], jtypes[i])
        pick = list(rng.choice(cols, 3, replace=False))
        for unique in (True, False):
            got = codec.encode_index_entry(
                tid, iid, [r[i] for i in pick], [ptypes[i] for i in pick],
                h, unique)
            assert got == jcodec.encode_index_entry(
                tid, iid, [r[i] for i in pick], [jtypes[i] for i in pick],
                h, unique)
            assert codec.decode_index_handle(*got) == \
                jcodec.decode_index_handle(*got)
        for fn in ("record_prefix", "record_prefix_end"):
            assert getattr(codec, fn)(tid) == getattr(jcodec, fn)(tid)
        for fn in ("index_prefix", "index_prefix_end"):
            assert getattr(codec, fn)(tid, iid) == getattr(jcodec, fn)(tid,
                                                                      iid)


def test_int_and_float_keys_sort_as_values():
    vals = [-2**63, -5, -1, 0, 1, 7, 2**63 - 1]
    keys = [codec.encode_int_key(v) for v in vals]
    assert keys == sorted(keys)
    assert keys == [jcodec.encode_int_key(v) for v in vals]
    fl = [-1e300, -2.5, -0.0, 0.0, 1e-300, 3.0, 1e300]
    fk = [codec.encode_float_key(v) for v in fl]
    assert fk == sorted(fk) == [jcodec.encode_float_key(v) for v in fl]


# ------------------------------------------------------------------ #
# the helpers on KV: GC worker, AUTO_INCREMENT service
# ------------------------------------------------------------------ #

def test_gc_worker_equals_the_jax_worker():
    out = []
    for kmod, gmod in ((kv, gcworker), (jkv, jgc)):
        s = kmod.KVStore()
        for i in range(5):
            t = s.begin()
            t.put(b"k", b"v%d" % i)
            t.commit()
        w = gmod.GCWorker(s, life_seconds=10.0)
        row = [w.run_once(now=100.0), w.run_once(now=105.0)]
        for i in range(3):
            t = s.begin()
            t.put(b"k", b"w%d" % i)
            t.commit()
        row += [w.run_once(now=115.0), w.run_once(now=130.0),
                w.last_safepoint, w.total_dropped,
                s.get(b"k", s.alloc_ts())]
        out.append(row)
        s.close()
    assert out[0] == out[1]
    assert out[0][5] > 0


def test_autoid_service_equals_the_jax_service(tmp_path):
    out = []
    for kmod, amod in ((kv, autoid), (jkv, jautoid)):
        s = kmod.KVStore()
        a = amod.AutoIDService(s)
        row = [a.alloc_range(7, 10), a.alloc_range(7, 10, at_least=50)]
        a.bump(7, 500)
        row += [a.current(7), a.alloc_range(8), amod.AutoIDService(s)
                .current(7)]
        out.append(row)
        s.close()
    assert out[0] == out[1] == [(0, 10), (50, 60), 500, (0, 4000), 500]


# ------------------------------------------------------------------ #
# owner election and the metadata locks over the port's store
# ------------------------------------------------------------------ #

def test_owner_election_equals_the_jax_election():
    """Campaign, resign, lease expiry and one winner among racing
    campaigns, on each package's store (threads join within
    ``THREAD_LIMIT_S``)."""
    from tidb_tpu.ddl import election as jel
    from tidb_tpu_torch.ddl import election as pel
    out = []
    for kmod, emod in ((kv, pel), (jkv, jel)):
        s = kmod.KVStore()
        a = emod.OwnerManager(s, "ddl", lease_sec=0.2, owner_id="a")
        b = emod.OwnerManager(s, "ddl", lease_sec=0.2, owner_id="b")
        row = [a.campaign(), a.is_owner(), b.campaign(), b.is_owner()]
        a.resign()
        row += [b.campaign(), b.is_owner(), a.renew()]
        time.sleep(0.3)                    # b's lease expires
        row += [a.campaign(), a.is_owner(), b.is_owner(), b.renew()]
        a.close()
        mgrs = [emod.OwnerManager(s, "race", lease_sec=5.0,
                                  owner_id=f"m{i}") for i in range(4)]
        won, barrier = {}, threading.Barrier(4)

        def go(m, won=won, barrier=barrier):
            barrier.wait(THREAD_LIMIT_S)
            won[m.owner_id] = m.campaign()
        ths = [threading.Thread(target=go, args=(m,)) for m in mgrs]
        for th in ths:
            th.start()
        for th in ths:
            th.join(THREAD_LIMIT_S)
            assert not th.is_alive()
        row.append(sum(won.values()))
        out.append(row)
        s.close()
    assert out[0] == out[1] == [True, True, False, False, True, True,
                                False, True, True, False, False, 1]


def test_mdl_registry_equals_the_jax_registry():
    """Acquire, drain, evict and release on each package's metadata
    lock registry; a drain waits for the holder's release."""
    from tidb_tpu.ddl import mdl as jmdl
    from tidb_tpu_torch.ddl import mdl as pmdl
    out = []
    for mod in (pmdl, jmdl):
        r = mod.MDLRegistry()
        r.acquire(7, "t1", 3)
        r.acquire(7, "t1", 5)            # keeps the oldest version
        r.acquire(7, "t2", 4)
        row = [r.holders_below(7, 4), r.holders_below(7, 5),
               r.wait_drain(7, 4, timeout_s=0.05)]
        th = threading.Timer(0.1, r.release_all, args=("t1",))
        th.start()
        row.append(r.wait_drain(7, 4, timeout_s=THREAD_LIMIT_S))
        th.join(THREAD_LIMIT_S)
        row += [r.evict_below(7, 5), r.holders_below(7, 9)]
        out.append(row)
    assert out[0] == out[1] == [1, 2, False, True, 1, 0]


def test_catalog_on_kv_equals_the_jax_encoding():
    """A table's schema record on KV (``session/meta.py``) is the JAX
    package's, and decodes back to the same table."""
    import json
    from tidb_tpu.session import meta as jmeta
    from tidb_tpu_torch.session import meta as pmeta
    from test_torch_dml import pair
    js, ps = pair()
    for s in (js, ps):
        s.execute("create table m (id bigint primary key auto_increment,"
                  " k varchar(8) collate utf8mb4_general_ci, d decimal(9,3),"
                  " day date, unique key uk (k))")
        s.execute("create index idd on m (d, day)")
    jt = js.domain.catalog.get_table("test", "m")
    pt = ps.domain.catalog.get_table("test", "m")
    jb, pb = jmeta.encode_table(jt), pmeta.encode_table(pt)
    assert json.loads(pb) == json.loads(jb)
    back = pmeta.decode_table(pb, ps.domain.kv)
    assert pmeta.encode_table(back) == pb
    assert pmeta.table_key("test", "m") == jmeta.table_key("test", "m")


def test_native_engine_source_is_the_reference_copy():
    """The port's engine source is the JAX package's, line for line,
    under a first line naming it."""
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    port = (root / "tidb_tpu_torch/native/kvstore.cpp").read_text()
    first, rest = port.split("\n", 1)
    assert first.startswith("// ported from tidb_tpu/native/kvstore.cpp @ ")
    assert rest == (root / "tidb_tpu/native/kvstore.cpp").read_text()
    assert kv._SRC == root / "tidb_tpu_torch/native/kvstore.cpp"
