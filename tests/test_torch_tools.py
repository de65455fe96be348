"""The ecosystem tools of the port (``tools/``) against the JAX
package's: BR's backup, restore and point-in-time restore, Lightning's
direct and global-sort imports, Dumpling's export and the external
sorter's run files.

Every case runs the same statements and the same seeded CSV files
through a JAX ``Domain`` (``sched_enable = False``, auto-analyze off,
``test_torch_dml.jax_domain``) and a port ``Domain("cpu")``.  What the
tools write is compared byte for byte: the imported tables' KV pairs
(each table id replaced by a placeholder, since the two domains number
their tables apart), the dump files, the backup files and meta (table
ids and ``backup_ts`` aside), the sorted-run files; each package
restores and reads what the other wrote.  Query results are compared
with ``test_torch_sql._rows_equal`` (floats within its ``FLOAT_RTOL``).
The tools' thread pools run inside ``_within``, which fails the test
past ``LIMIT_S`` instead of hanging the run.
"""

import csv
import json
import os
import threading

import numpy as np
import pytest

from test_torch_dml import jax_domain, jax_session
from test_torch_sql import _rows_equal
from tidb_tpu.session.catalog import DuplicateKeyError as JDuplicateKeyError
from tidb_tpu.store import codec as jcodec
from tidb_tpu.tools import br as jbr
from tidb_tpu.tools import dump as jdump
from tidb_tpu.tools import external_sort as jxs
from tidb_tpu.tools import lightning as jlt
from tidb_tpu_torch.session import Domain, Session
from tidb_tpu_torch.session.catalog import DuplicateKeyError
from tidb_tpu_torch.store import codec
from tidb_tpu_torch.testing import bench_host, bench_kv, tpch
from tidb_tpu_torch.tools import br, dump, external_sort as xs, lightning as lt

LIMIT_S = 120.0      # a tool call's own time limit (thread pools inside)

# each package's tools and codec, by the same names
JAX = {"br": jbr, "dump": jdump, "xs": jxs, "lt": jlt, "codec": jcodec,
       "dup": JDuplicateKeyError}
PORT = {"br": br, "dump": dump, "xs": xs, "lt": lt, "codec": codec,
        "dup": DuplicateKeyError}

SCHEMA = [
    "create database shop",
    "use shop",
    "create table items (id bigint not null, name varchar(30), "
    "price decimal(8,2), day date, w double, primary key (id))",
    "create table orders (oid bigint, item bigint, qty bigint)",
    "create index oi on orders (item)",
    "insert into items values (1, 'apple', 1.25, '2024-01-02', 0.5), "
    "(2, 'pear', 0.80, null, 1.5), (3, null, null, '2023-12-31', null)",
    "insert into orders values (10, 1, 3), (11, 2, 1)",
]

QUERIES = [
    "select count(*), sum(price), min(day), max(day), sum(w) from items",
    "select id, name, price, day, w from items order by id",
    "select item, count(*), sum(qty) from orders group by item "
    "order by item",
    "select count(*) from orders where item = 3",
    "select i.name, sum(o.qty) from orders o join items i on o.item = i.id "
    "group by i.name order by i.name",
]


def _within(fn, *a, **k):
    """``fn(*a, **k)`` on a thread of its own, joined within
    ``LIMIT_S``: its result, or its exception raised here."""
    out = {}

    def run():
        try:
            out["v"] = fn(*a, **k)
        except BaseException as e:   # noqa: BLE001 - re-raised below
            out["e"] = e
    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(LIMIT_S)
    assert not th.is_alive(), f"{fn.__name__} ran past {LIMIT_S} s"
    if "e" in out:
        raise out["e"]
    return out.get("v")


def _sessions():
    """A (JAX, port) session pair over fresh domains, SCHEMA applied."""
    js = jax_session(jax_domain())
    ps = Session(Domain("cpu"))
    for sql in SCHEMA:
        js.execute(sql)
        ps.execute(sql)
    return js, ps


def _pkg_sessions():
    js, ps = _sessions()
    return ((JAX, js), (PORT, ps))


def _items_csv(path, n: int, seed: int, start: int = 100,
               dup: bool = False) -> None:
    """``n`` rows of items from a numpy seed: NULLs as empty fields and
    ``\\N``, decimals with two digits, dates, doubles by repr."""
    rng = np.random.default_rng(seed)
    ids = np.arange(start, start + n)
    if dup:
        ids[-1] = ids[0]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "name", "price", "day", "w"])
        for i, p, d, x, m in zip(ids.tolist(),
                                 rng.integers(0, 100_000, n).tolist(),
                                 rng.integers(0, 3000, n).tolist(),
                                 rng.random(n).tolist(),
                                 rng.integers(0, 10, n).tolist()):
            day = (np.datetime64("2015-01-01") + np.timedelta64(d, "D"))
            w.writerow([i, "" if m == 0 else f"name,{i % 97}",
                        "\\N" if m == 1 else f"{p // 100}.{p % 100:02d}",
                        "\\N" if m == 2 else str(day),
                        "" if m == 3 else repr(x * 1000)])


def _orders_csv(path, n: int, seed: int, shuffle: bool = False) -> None:
    rng = np.random.default_rng(seed)
    oid = np.arange(1000, 1000 + n)
    if shuffle:
        rng.shuffle(oid)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["oid", "item", "qty"])
        w.writerows(zip(oid.tolist(), rng.integers(0, 50, n).tolist(),
                        rng.integers(1, 9, n).tolist()))


def _table_kvs(pkg, dom, db: str, table: str) -> list:
    """The table's record and index pairs at a fresh ts, its table id
    replaced by ``<T>`` in every key."""
    c = pkg["codec"]
    tbl = dom.catalog.get_table(db, table)
    ts = dom.kv.alloc_ts()
    prefix = b"t" + c.encode_int_key(tbl.table_id)
    out = []
    for lo, hi in ((c.record_prefix(tbl.table_id),
                    c.record_prefix_end(tbl.table_id)),
                   (c.index_prefix(tbl.table_id),
                    c.index_prefix_end(tbl.table_id))):
        for k, v in dom.kv.scan(lo, hi, ts):
            assert k.startswith(prefix)
            out.append((b"<T>" + k[len(prefix):], v))
    return out


def _same_answers(js, ps, queries=QUERIES) -> None:
    for q in queries:
        _rows_equal(ps.must_query(q), js.must_query(q))


def _norm_kv_file(path: str, table_ids) -> list:
    """A backup's ``.kv`` pairs with every table id of ``table_ids``
    replaced by ``<T>`` (after the optional P/D tag of an increment)."""
    out = []
    for k, v in jbr._read_kvs(path):
        tag = k[:1] if k[:1] in (b"P", b"D") and not k.startswith(b"t") \
            else b""
        body = k[len(tag):]
        for tid in table_ids:
            p = b"t" + jcodec.encode_int_key(tid)
            if body.startswith(p):
                body = b"<T>" + body[len(p):]
                break
        out.append((tag + body, v))
    return out


# ------------------------------------------------------------------ #
# Lightning: the direct import
# ------------------------------------------------------------------ #

def test_import_csv_equals_the_jax_package(tmp_path):
    """import_csv of the same files (4 threads, several chunks) writes
    the same KV pairs, row and index, and the tables answer alike."""
    _items_csv(tmp_path / "items.csv", 9000, seed=1)
    _orders_csv(tmp_path / "orders.csv", 6000, seed=2)
    got = []
    for pkg, s in _pkg_sessions():
        n = [_within(pkg["lt"].import_csv, s.domain, "shop", t,
                     str(tmp_path / f"{t}.csv"), threads=4)
             for t in ("items", "orders")]
        got.append((n, _table_kvs(pkg, s.domain, "shop", "items"),
                    _table_kvs(pkg, s.domain, "shop", "orders"), s))
        s.execute("admin check table orders")
    (jn, jitems, jorders, js), (pn, pitems, porders, ps) = got
    assert pn == jn == [9000, 6000]
    assert pitems == jitems and porders == jorders
    _same_answers(js, ps)


def test_import_duplicate_raises_in_both(tmp_path):
    _items_csv(tmp_path / "dup.csv", 50, seed=3, dup=True)
    for pkg, s in _pkg_sessions():
        with pytest.raises(pkg["dup"]):
            _within(pkg["lt"].import_csv, s.domain, "shop", "items",
                    str(tmp_path / "dup.csv"))


def test_import_checkpoint_resume_equal(tmp_path):
    """A checkpoint naming chunk 1 done skips it; a second run over a
    complete checkpoint imports nothing; both packages write the same
    checkpoint file and the same pairs."""
    _orders_csv(tmp_path / "o.csv", 3 * lt.CHUNK_ROWS + 17, seed=4)
    got = []
    for pkg, s in _pkg_sessions():
        ck = tmp_path / f"ck_{pkg['lt'].__name__}.json"
        ck.write_text(json.dumps([1]))
        first = _within(pkg["lt"].import_csv, s.domain, "shop", "orders",
                        str(tmp_path / "o.csv"), checkpoint_path=str(ck))
        again = _within(pkg["lt"].import_csv, s.domain, "shop", "orders",
                        str(tmp_path / "o.csv"), checkpoint_path=str(ck))
        got.append((first, again, ck.read_bytes(),
                    _table_kvs(pkg, s.domain, "shop", "orders"), s))
    (jf, ja, jck, jkv, js), (pf, pa, pck, pkv, ps) = got
    assert (pf, pa) == (jf, ja) == (2 * lt.CHUNK_ROWS + 17, 0)
    assert pck == jck and pkv == jkv
    _same_answers(js, ps)


def test_direct_write_refreshes_cached_results(tmp_path):
    """Q6 over a non-empty lineitem, the result cache on, before and
    after an import into it: the second answer is the new one (the
    store's direct write invalidates the placement and the cached
    result), equal to the JAX session's."""
    names, cols = tpch.gen_tpch(0.0005, seed=5)["lineitem"]
    texts = [tpch._as_text(c) for c in cols]
    n = len(texts[0])
    for part, (lo, hi) in (("a", (0, n // 2)), ("b", (n // 2, n))):
        with open(tmp_path / f"li_{part}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(names)
            w.writerows(zip(*[t[lo:hi] for t in texts]))
    answers = []
    for pkg, s in _pkg_sessions():
        s.execute(f"create table lineitem {tpch.TPCH_DDL['lineitem']}")
        s.execute("set global tidb_tpu_result_cache_entries = 64")
        _within(pkg["lt"].import_csv, s.domain, "shop", "lineitem",
                str(tmp_path / "li_a.csv"))
        before = [s.must_query(tpch.TPCH_Q6) for _ in range(2)]
        _within(pkg["lt"].import_csv, s.domain, "shop", "lineitem",
                str(tmp_path / "li_b.csv"))
        after = s.must_query(tpch.TPCH_Q6)
        answers.append((before, after))
        if pkg is PORT:
            assert s.domain.client.result_cache_hits >= 1
    (jb, ja), (pb, pa) = answers
    _rows_equal(pb[0], jb[0])
    _rows_equal(pb[1], jb[0])
    _rows_equal(pa, ja)
    assert pa != pb[0]


# ------------------------------------------------------------------ #
# Lightning: the global-sort import and its external sorter
# ------------------------------------------------------------------ #

def test_global_sort_import_equals_the_jax_package(tmp_path):
    """A shuffled file past the memory budget spills several runs; the
    merged ingest writes the same pairs as the JAX package's."""
    _orders_csv(tmp_path / "gs.csv", 4000, seed=6, shuffle=True)
    got = []
    for pkg, s in _pkg_sessions():
        run_dir = tmp_path / f"runs_{pkg['lt'].__name__}"
        n = _within(pkg["lt"].global_sort_import, s.domain, "shop",
                    "orders", str(tmp_path / "gs.csv"), str(run_dir),
                    mem_budget_bytes=1 << 15)
        got.append((n, _table_kvs(pkg, s.domain, "shop", "orders"), s))
        assert os.listdir(run_dir) == []          # runs cleaned up
        s.execute("admin check table orders")
    (jn, jkv, js), (pn, pkv, ps) = got
    assert pn == jn == 4000 and pkv == jkv
    _same_answers(js, ps)


def test_global_sort_import_refuses_a_stale_run_dir(tmp_path):
    (tmp_path / "one.csv").write_text("oid,item,qty\n1,2,3\n")
    for pkg, s in _pkg_sessions():
        d = str(tmp_path / f"stale_{pkg['lt'].__name__}")
        stale = pkg["xs"].ExternalSorter(d, mem_budget_bytes=1 << 16)
        stale.add(b"k", b"v")
        stale.flush()
        with pytest.raises(ValueError, match="earlier attempt"):
            pkg["lt"].global_sort_import(s.domain, "shop", "orders",
                                         str(tmp_path / "one.csv"), d)


def test_global_sort_import_under_concurrent_inserts(tmp_path):
    """Handle blocks reserve under the allocation lock: INSERTs from
    another thread during the import overwrite no imported row."""
    _orders_csv(tmp_path / "c.csv", 2500, seed=7)
    ps = Session(Domain("cpu"))
    ps.execute("create table gci (oid bigint, item bigint, qty bigint)")
    stop, inserted = threading.Event(), [0]

    def writer():
        s2 = Session(ps.domain)
        while not stop.is_set():
            s2.execute(f"insert into gci values (-1, {inserted[0]}, 0)")
            inserted[0] += 1
    th = threading.Thread(target=writer)
    th.start()
    try:
        got = _within(lt.global_sort_import, ps.domain, "test", "gci",
                      str(tmp_path / "c.csv"), str(tmp_path / "runs"),
                      mem_budget_bytes=1 << 15)
    finally:
        stop.set()
        th.join(LIMIT_S)
    assert not th.is_alive()
    assert got == 2500
    assert ps.must_query("select count(*) from gci") == \
        [(2500 + inserted[0],)]
    assert ps.must_query("select count(*) from gci where oid >= 0") == \
        [(2500,)]


def _sorter_pairs(seed: int) -> list:
    rng = np.random.default_rng(seed)
    keys = [b"k%06d" % k for k in rng.integers(0, 10_000, 5000).tolist()]
    return [(k, b"v" + k) for k in keys]


def test_external_sorter_runs_byte_identical(tmp_path):
    """The same adds under the same budget write byte-identical run
    files (magic, records, stats footer) in both packages."""
    pairs = _sorter_pairs(8)
    runs = {}
    for pkg in (JAX, PORT):
        d = tmp_path / pkg["xs"].__name__
        s = pkg["xs"].ExternalSorter(str(d), mem_budget_bytes=1 << 16)
        for k, v in pairs:
            s.add(k, v)
        s.flush()
        runs[pkg["xs"].__name__] = {p.name: p.read_bytes()
                                    for p in sorted(d.iterdir())}
    jr, pr = runs[jxs.__name__], runs[xs.__name__]
    assert len(jr) > 1 and pr == jr


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-runs-read-by-port",
                              "port-runs-read-by-jax"])
def test_external_sorter_reads_the_other_packages_runs(tmp_path, writer,
                                                       reader):
    pairs = _sorter_pairs(9)
    d = str(tmp_path / "runs")
    w = writer["xs"].ExternalSorter(d, mem_budget_bytes=1 << 16)
    for k, v in pairs:
        w.add(k, v)
    w.flush()
    r = reader["xs"].ExternalSorter(d)
    assert r.runs == w.runs
    assert list(r.merged()) == sorted(pairs, key=lambda kv: kv[0])
    assert r.stats() == w.stats()
    clip = list(reader["xs"].read_run(r.runs[0], b"k003000", b"k006000"))
    assert clip == [kv for kv in writer["xs"].read_run(w.runs[0])
                    if b"k003000" <= kv[0] < b"k006000"]


# ------------------------------------------------------------------ #
# Dumpling
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("fmt", ["sql", "csv"])
def test_dump_files_byte_identical(tmp_path, fmt):
    """dump_database (4 threads) writes the same files, byte for byte,
    in both packages."""
    _items_csv(tmp_path / "items.csv", 1500, seed=10)
    files = []
    for pkg, s in _pkg_sessions():
        _within(pkg["lt"].import_csv, s.domain, "shop", "items",
                str(tmp_path / "items.csv"))
        out = tmp_path / f"dump_{pkg['dump'].__name__}"
        counts = _within(pkg["dump"].dump_database, s.domain, "shop",
                         str(out), fmt=fmt, threads=4)
        assert counts == {"items": 1503, "orders": 2}
        files.append({p.name: p.read_bytes() for p in sorted(out.iterdir())})
    assert files[1] == files[0]


# ------------------------------------------------------------------ #
# BR: backup, restore, log backup and PITR
# ------------------------------------------------------------------ #

def _backed_up(tmp_path):
    """Both packages' sessions with imported items, each backed up."""
    _items_csv(tmp_path / "items.csv", 2000, seed=11)
    out = []
    for pkg, s in _pkg_sessions():
        _within(pkg["lt"].import_csv, s.domain, "shop", "items",
                str(tmp_path / "items.csv"))
        d = tmp_path / f"bk_{pkg['br'].__name__}"
        counts = pkg["br"].backup(s.domain, "shop", str(d))
        out.append((pkg, s, d, counts))
    return out


def test_backups_agree(tmp_path):
    """The backup files equal the JAX package's: the meta JSON (table
    ids and ``backup_ts`` aside), the checkpoint and every table's
    pairs (table ids normalized); a resumed backup does nothing."""
    (jpkg, js, jd, jc), (ppkg, ps, pd, pc) = _backed_up(tmp_path)
    assert pc == jc and pc["items"] > 2000
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))

    def meta(d):
        m = json.loads((d / jbr.META_FILE).read_text())
        ids = [t.pop("table_id") for t in m["tables"].values()]
        m.pop("backup_ts")
        return m, ids
    (jm, jids), (pm, pids) = meta(jd), meta(pd)
    assert pm == jm
    assert (pd / jbr.CKPT_FILE).read_bytes() == \
        (jd / jbr.CKPT_FILE).read_bytes()
    for name in jm["tables"]:
        f = f"shop.{name}.kv"
        assert _norm_kv_file(str(pd / f), pids) == \
            _norm_kv_file(str(jd / f), jids), name
    assert ppkg["br"].backup(ps.domain, "shop", str(pd)) == {}


@pytest.mark.parametrize("source", ["jax", "port"])
def test_restore_of_either_packages_backup(tmp_path, source):
    """A backup written by either package, restored by the port and by
    the JAX package under a new name, gives the JAX restore of the JAX
    backup's answers; the restored tables pass ADMIN CHECK and take
    writes."""
    (jpkg, js, jd, _), (ppkg, ps, pd, _) = _backed_up(tmp_path)
    src = jd if source == "jax" else pd
    want_s = jax_session(jax_domain())
    jbr.restore(want_s.domain, str(jd), db="shop2")
    want_s.execute("use shop2")
    for pkg, s in ((JAX, jax_session(jax_domain())),
                   (PORT, Session(Domain("cpu")))):
        got = pkg["br"].restore(s.domain, str(src), db="shop2")
        assert set(got) == {"items", "orders"}
        s.execute("use shop2")
        _same_answers(want_s, s)
        s.execute("admin check table orders")
        s.execute("insert into items values (99999, 'plum', 2.00, null, "
                  "null)")
        assert s.must_query("select count(*) from items") == [(2004,)]
        s.execute("admin check table items")


def _pitr_script(pkg, s, d: str) -> list:
    """The log-backup stream over t: a base, then two ticks of writes;
    returns [(ts, changed keys, rows of t)] for the base and each
    tick."""
    s.execute("create table t (id bigint, v varchar(10), d decimal(6,2))")
    s.execute("create unique index uid on t (id)")
    s.execute("insert into t values (1,'a',1.5),(2,'b',null),(5,'e',0.25)")
    q = "select id, v, d from t order by id"
    pkg["br"].log_backup_start(s.domain, "test", d)
    marks = [(json.load(open(os.path.join(d, "stream.json")))["last_ts"],
              0, s.must_query(q))]
    for writes in (["insert into t values (3,'c',3)",
                    "update t set v = 'B' where id = 2"],
                   ["delete from t where id = 1",
                    "insert into t values (4,'d',null)",
                    "update t set d = d * 2 where id = 5"]):
        for w in writes:
            s.execute(w)
        n = pkg["br"].log_backup_tick(s.domain, d)
        ts = json.load(open(os.path.join(d, "stream.json")))["last_ts"]
        marks.append((ts, n, s.must_query(q)))
    assert pkg["br"].log_backup_tick(s.domain, d) == 0   # nothing changed
    return marks


def test_pitr_matches_at_each_tick(tmp_path):
    """restore_pitr to the base and to each tick gives the source's rows
    at that point in both packages, with the same changed-key counts;
    the port restores the JAX package's stream the same way."""
    streams = {}
    for pkg in (JAX, PORT):
        s = jax_session(jax_domain()) if pkg is JAX else \
            Session(Domain("cpu"))
        d = str(tmp_path / f"stream_{pkg['br'].__name__}")
        streams[pkg["br"].__name__] = (d, _pitr_script(pkg, s, d))
    jd, jmarks = streams[jbr.__name__]
    pd, pmarks = streams[br.__name__]
    assert [(n, rows) for _, n, rows in pmarks] == \
        [(n, rows) for _, n, rows in jmarks]

    def increments(d):
        """The stream's increment files in order, table ids normalized."""
        meta = json.load(open(os.path.join(d, jbr.META_FILE)))
        ids = [t["table_id"] for t in meta["tables"].values()]
        state = json.load(open(os.path.join(d, jbr.STREAM_FILE)))
        return [_norm_kv_file(os.path.join(d, f"inc-{ts}.kv"), ids)
                for ts in state["increments"]]
    assert increments(pd) == increments(jd)
    assert len(increments(jd)) == 2
    for restorer, d, marks in ((PORT, pd, pmarks), (JAX, jd, jmarks),
                               (PORT, jd, jmarks)):
        for i, (ts, _n, rows) in enumerate(marks):
            s = jax_session(jax_domain()) if restorer is JAX else \
                Session(Domain("cpu"))
            restorer["br"].restore_pitr(s.domain, d, restore_ts=ts,
                                        db=f"at{i}")
            got = s.must_query(f"select id, v, d from at{i}.t order by id")
            assert got == rows, (restorer["br"].__name__, i)
            s.execute(f"use at{i}")
            with pytest.raises(Exception, match="[Dd]uplicate"):
                s.execute(f"insert into t values ({rows[0][0]}, 'x', 0)")


# ------------------------------------------------------------------ #
# the micro-benchmarks
# ------------------------------------------------------------------ #

def test_bench_host_main_runs_small():
    out = bench_host.main(20_000, 2_000)
    assert out["projection"][2] == 20_000
    assert out["hash_join"][2] > 0


def test_bench_kv_main_runs_small():
    (mem_us, mem_n, _), (fl_us, fl_n, _) = bench_kv.main(2_000, gets=1_000)
    assert mem_n == fl_n == 2_000 and mem_us > 0 and fl_us > 0
