"""The port's MySQL wire server against the JAX package's, packet by
packet, and the port's client made safe for concurrent statements.

A JAX ``MySQLServer`` (its domain's scheduler, background stats load and
inline auto-analyze off, as the parity files build it) and a port
``MySQLServer`` (``Domain("cpu", 8)``) listen on port 0 side by side
over the same tables, and the same requests go to each:

- result sets compare packet by packet: the column count, the column
  definitions and the EOF packets byte for byte, text rows byte for byte
  but for DOUBLE values, which agree within ``FLOAT_RTOL`` (the two sum
  in different orders);
- the binary protocol the same way: ``COM_STMT_PREPARE``'s answer,
  ``COM_STMT_EXECUTE`` with a parameter of each type, and a read-only
  cursor paged by ``COM_STMT_FETCH``;
- errors compare by errno and SQLSTATE: a parse error, an unknown table,
  a duplicate key, a denied statement and a killed query;
- ``COM_INIT_DB``, ``COM_FIELD_LIST``, several connections over one
  domain, caching_sha2 over TLS (skipped where ``openssl`` is missing),
  a bad password and a graceful close;
- the status API's JSON routes compare route by route (``/settings``
  without ``tidb_enable_auto_analyze``, whose default the port sets
  apart); the routes of later slices answer 501 naming their item.

Then eight threads of mixed statements over one port ``Domain`` give
the serial results while the paging feedback evicts entries.
"""

import gc
import json
import shutil
import struct
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_dml import jax_domain
from tidb_tpu.server.mysql_server import MySQLServer as JServer
from tidb_tpu.server.status import StatusServer as JStatus
from tidb_tpu.session import Session as JSession
from tidb_tpu_torch.server import packet as P
from tidb_tpu_torch.server.client import Client, MySQLError
from tidb_tpu_torch.server.mysql_server import MySQLServer
from tidb_tpu_torch.server.status import StatusServer
from tidb_tpu_torch.session import Domain, Session

FLOAT_RTOL = 1e-9
WAIT_S = 20.0              # every join and wait of a threaded test

SETUP = [
    "create table t (id bigint primary key, k varchar(8), v bigint,"
    " d decimal(12,2), day date, f double)",
    "create table u (id bigint, w bigint)",
    "insert into t values " + ",".join(
        f"({i}, {'NULL' if i % 7 == 0 else repr('k' + str(i % 4))},"
        f" {i * 3 - 40}, {'NULL' if i % 5 == 0 else f'{i * 1.25:.2f}'},"
        f" {'NULL' if i % 6 == 0 else repr(f'2024-{1 + i % 12:02d}-{1 + i % 27:02d}')},"
        f" {i / 3.0!r})" for i in range(1, 61)),
    "insert into u values (1, 10), (2, 20), (3, 30)",
    "create user reader identified by 'rpw'",
    "grant select on test.u to reader",
]

QUERIES = {
    "rows": "select id, k, v, d, day from t order by id",
    "doubles": "select id, f, f * 2, v / 7 from t where id < 20 order by id",
    "group": """select k, count(*), sum(v), sum(d), avg(d), min(day),
                       max(day), sum(f) from t group by k order by k""",
    "scalar": "select count(*), sum(d), min(v), max(f) from t where v > 0",
    "topn": "select id, d from t order by d desc, id limit 5",
    "no table": "select 1, 'x', null, 2.5, -3",
    "join": """select t.id, u.w from t join u on t.id = u.id
               order by t.id""",
    "show tables": "show tables",
    "show columns": "show columns from t",
    "empty": "select id from t where id < 0",
}

ERRORS = {
    "parse": "selec 1",
    "unknown table": "select * from nosuch",
    "duplicate key": "insert into t (id, v) values (1, 0)",
}


def _start_pair():
    jd = jax_domain()
    jd.sysvars["tidb_enable_auto_analyze"] = 0   # the inline auto-analyze
    pd = Domain("cpu", 8)
    js, ps = JSession(jd), Session(pd)
    for sql in SETUP:
        js.execute(sql)
        ps.execute(sql)
    jsrv, psrv = JServer(jd), MySQLServer(pd)
    jsrv.start()
    psrv.start()
    return jsrv, psrv


@pytest.fixture(scope="module")
def servers():
    jsrv, psrv = _start_pair()
    yield jsrv, psrv
    jsrv.close()
    psrv.close()
    psrv.domain.close()


class Raw:
    """A logged-in connection whose requests return the raw packets of
    the server's answer."""

    def __init__(self, port, user="root", password=""):
        self.c = Client("127.0.0.1", port, user=user, password=password)
        self.io = self.c.io

    def send(self, cmd: int, body: bytes = b""):
        self.io.reset_seq()
        self.io.write(bytes([cmd]) + body)

    def read_result(self) -> list:
        """OK, ERR, or a result set: count, column defs, EOF, rows,
        EOF."""
        first = self.io.read()
        if first[0] in (0x00, 0xFF):
            return [first]
        n, _ = P.get_lenenc_int(first, 0)
        out = [first] + [self.io.read() for _ in range(n + 1)]
        if struct.unpack_from("<H", out[-1], 3)[0] \
                & P.SERVER_STATUS_CURSOR_EXISTS:
            return out                        # rows come by COM_STMT_FETCH
        return out + self._rows()

    def _rows(self) -> list:
        out = []
        while True:
            pkt = self.io.read()
            out.append(pkt)
            if pkt[0] in (0xFE, 0xFF) and len(pkt) < 9:
                return out

    def query(self, sql: str) -> list:
        self.send(P.COM_QUERY, sql.encode())
        return self.read_result()

    def prepare(self, sql: str) -> list:
        self.send(P.COM_STMT_PREPARE, sql.encode())
        head = self.io.read()
        if head[0] == 0xFF:
            return [head]
        n_params = struct.unpack_from("<H", head, 7)[0]
        return [head] + [self.io.read()
                         for _ in range(n_params + (1 if n_params else 0))]

    def execute(self, stmt_id: int, params=(), flags: int = 0) -> list:
        body = struct.pack("<IBI", stmt_id, flags, 1)
        if params:
            nb = bytearray((len(params) + 7) // 8)
            types, vals = bytearray(), bytearray()
            for i, v in enumerate(params):
                if v is None:
                    nb[i // 8] |= 1 << (i % 8)
                    types += bytes([P.MYSQL_TYPE_NULL, 0])
                elif isinstance(v, int):
                    types += bytes([P.MYSQL_TYPE_LONGLONG, 0])
                    vals += struct.pack("<q", v)
                elif isinstance(v, float):
                    types += bytes([P.MYSQL_TYPE_DOUBLE, 0])
                    vals += struct.pack("<d", v)
                else:
                    types += bytes([P.MYSQL_TYPE_VAR_STRING, 0])
                    vals += P.put_lenenc_str(str(v).encode())
            body += bytes(nb) + b"\x01" + bytes(types) + bytes(vals)
        self.send(P.COM_STMT_EXECUTE, body)
        return self.read_result()

    def fetch(self, stmt_id: int, count: int) -> list:
        self.send(P.COM_STMT_FETCH, struct.pack("<II", stmt_id, count))
        return self._rows()

    def close(self):
        self.c.close()


def _col_types(packets) -> list:
    """The wire type of each column of a result set's packets."""
    n, _ = P.get_lenenc_int(packets[0], 0)
    types = []
    for cdef in packets[1:1 + n]:
        pos = 0
        for _ in range(6):
            _, pos = P.get_lenenc_str(cdef, pos)
        types.append(cdef[pos + 1 + 2 + 4])
    return types


def _text_values(pkt, n):
    out, pos = [], 0
    for _ in range(n):
        if pkt[pos] == 0xFB:
            out.append(None)
            pos += 1
        else:
            b, pos = P.get_lenenc_str(pkt, pos)
            out.append(b)
    return out


def _binary_values(pkt, types):
    n = len(types)
    nb = (n + 9) // 8
    bitmap, pos, out = pkt[1:1 + nb], 1 + nb, []
    for i, ty in enumerate(types):
        if bitmap[(i + 2) // 8] & (1 << ((i + 2) % 8)):
            out.append(None)
        elif ty in (P.MYSQL_TYPE_LONGLONG, P.MYSQL_TYPE_DOUBLE):
            out.append(pkt[pos:pos + 8])
            pos += 8
        elif ty in (P.MYSQL_TYPE_DATE, P.MYSQL_TYPE_DATETIME):
            ln = pkt[pos]
            out.append(pkt[pos:pos + 1 + ln])
            pos += 1 + ln
        else:
            b, pos = P.get_lenenc_str(pkt, pos)
            out.append(b)
    return out


def _double_close(a: bytes, b: bytes, binary: bool) -> bool:
    x, y = ((struct.unpack("<d", a)[0], struct.unpack("<d", b)[0])
            if binary else (float(a), float(b)))
    return x == pytest.approx(y, rel=FLOAT_RTOL, abs=1e-12) \
        or (np.isnan(x) and np.isnan(y))


def assert_packets_equal(got: list, want: list, binary: bool = False,
                         types=None):
    """Byte-equal packets, but for the DOUBLE values of row packets."""
    assert len(got) == len(want), (got, want)
    if types is None and got[0][0] not in (0x00, 0xFF, 0xFE) \
            and len(got) > 1:
        types = _col_types(got)
        assert _col_types(want) == types
    n_head = 0 if types is None or got[0][0] in (0x00, 0xFF) \
        else len(types) + 2
    for i, (g, w) in enumerate(zip(got, want)):
        is_row = i >= n_head and not (g[0] in (0xFE, 0xFF) and len(g) < 9)
        if not is_row or types is None \
                or P.MYSQL_TYPE_DOUBLE not in types:
            assert g == w, (i, g, w)
            continue
        gv = (_binary_values(g, types) if binary
              else _text_values(g, len(types)))
        wv = (_binary_values(w, types) if binary
              else _text_values(w, len(types)))
        for ty, a, b in zip(types, gv, wv):
            if ty == P.MYSQL_TYPE_DOUBLE and a is not None \
                    and b is not None:
                assert _double_close(a, b, binary), (a, b)
            else:
                assert a == b, (a, b)


@pytest.fixture(scope="module")
def conns(servers):
    jsrv, psrv = servers
    j, p = Raw(jsrv.port), Raw(psrv.port)
    yield j, p
    j.close()
    p.close()


@pytest.mark.parametrize("name", list(QUERIES))
def test_text_result_sets_equal_the_jax_server(conns, name):
    j, p = conns
    want, got = j.query(QUERIES[name]), p.query(QUERIES[name])
    assert got[0][0] not in (0x00, 0xFF), got[0]
    assert_packets_equal(got, want)


def test_writes_answer_equal_ok_packets(conns):
    j, p = conns
    for sql in ("insert into u values (4, 40), (5, 50)",
                "update u set w = w + 1 where id > 3",
                "delete from u where id = 5",
                "select id, w from u order by id"):
        assert_packets_equal(p.query(sql), j.query(sql))


@pytest.mark.parametrize("name", list(ERRORS))
def test_errors_equal_the_jax_server(conns, name):
    j, p = conns
    want, got = j.query(ERRORS[name]), p.query(ERRORS[name])
    assert got[0][0] == want[0][0] == 0xFF
    assert got[0][1:9] == want[0][1:9]          # errno, '#', SQLSTATE
    assert struct.unpack_from("<H", got[0], 1)[0] == \
        {"parse": 1064, "unknown table": 1105, "duplicate key": 1062}[name]


def test_denied_statement_and_bad_password_equal_the_jax(servers):
    jsrv, psrv = servers
    outs = []
    for srv in (jsrv, psrv):
        r = Raw(srv.port, user="reader", password="rpw")
        denied = r.query("select count(*) from t")[0]
        allowed = r.query("select count(*) from u")
        r.close()
        with pytest.raises(MySQLError) as e:
            Client("127.0.0.1", srv.port, user="reader", password="bad")
        outs.append((denied[:9], denied[9:], allowed, e.value.errno,
                     str(e.value)))
    assert outs[1] == outs[0]
    assert struct.unpack_from("<H", outs[0][0], 1)[0] == 1105
    assert outs[0][0][3:9] == b"#HY000"
    assert outs[0][3] == 1045


def test_unported_path_is_an_error_packet_and_the_connection_stays(conns):
    _j, p = conns
    got = p.query("explain analyze select count(*) from t")[0]
    assert got[0] == 0xFF
    assert struct.unpack_from("<H", got, 1)[0] == 1105
    assert b"ROADMAP.md, Queue 1 item 8" in got
    assert p.query("select 1")[-2] == P.put_lenenc_str(b"1")


def test_prepared_binary_rows_equal_the_jax_server(conns):
    j, p = conns
    sql = ("select id, k, v, d, day, f from t where id > ? and k <> ?"
           " and f < ? and day >= ? and d >= ? order by id")
    jp, pp = j.prepare(sql), p.prepare(sql)
    assert_packets_equal(pp, jp)
    sid = struct.unpack_from("<I", pp[0], 1)[0]
    for params in ((3, "k1", 15.5, "2024-02-01", "2.50"),
                   (0, "k0", 100.0, "2024-01-01", "0")):
        want, got = j.execute(sid, params), p.execute(sid, params)
        assert len(got) > 3
        assert_packets_equal(got, want, binary=True)
    # NULL binds compare false: an empty result set
    want, got = (j.execute(sid, (None, "k1", 1.0, None, None)),
                 p.execute(sid, (None, "k1", 1.0, None, None)))
    assert_packets_equal(got, want, binary=True)
    ins = "insert into u values (?, ?)"
    jp, pp = j.prepare(ins), p.prepare(ins)
    iid = struct.unpack_from("<I", pp[0], 1)[0]
    assert_packets_equal(p.execute(iid, (7, 70)), j.execute(iid, (7, 70)))


def test_cursor_fetch_pages_equal_the_jax_server(conns):
    j, p = conns
    sql = "select id, d, day, f from t where v > ? order by id"
    jp, pp = j.prepare(sql), p.prepare(sql)
    sid = struct.unpack_from("<I", pp[0], 1)[0]
    want = j.execute(sid, (0,), flags=P.CURSOR_TYPE_READ_ONLY)
    got = p.execute(sid, (0,), flags=P.CURSOR_TYPE_READ_ONLY)
    assert_packets_equal(got, want)
    types = _col_types(got)
    pages = 0
    while True:
        wpage, gpage = j.fetch(sid, 7), p.fetch(sid, 7)
        assert_packets_equal(gpage, wpage, binary=True, types=types)
        pages += 1
        if struct.unpack_from("<H", gpage[-1], 3)[0] \
                & P.SERVER_STATUS_LAST_ROW_SENT:
            break
    assert pages >= 4


def test_init_db_and_field_list_equal_the_jax_server(servers):
    jsrv, psrv = servers
    outs = []
    for srv in (jsrv, psrv):
        r = Raw(srv.port)
        out = []
        for db in (b"test", b"nosuch"):
            r.send(P.COM_INIT_DB, db)
            out.append(r.io.read())
        r.send(P.COM_FIELD_LIST, b"t\x00")
        out.append(r._rows())
        r.send(P.COM_PING)
        out.append(r.io.read())
        r.close()
        outs.append(out)
    got, want = outs[1], outs[0]
    assert got[0] == want[0] and got[0][0] == 0x00
    assert got[1][:9] == want[1][:9] and got[1][0] == 0xFF
    assert got[2] == want[2] and len(got[2]) == 7
    assert got[3] == want[3]


def _gate_check_killed(monkeypatch, coordinator_mod, victim_event):
    """Make the victim's statement wait at its first cancellation point
    until KILL sets its event, then run the real check: the killed query
    is deterministic, whatever the statement's speed.  The gate opens
    once."""
    real = coordinator_mod.check_killed
    armed = [victim_event]

    def gated():
        ev = coordinator_mod.KILL_EVENT.get()
        if armed and ev is armed[0]:
            armed.clear()
            ev.wait(WAIT_S)
        real()
    monkeypatch.setattr(coordinator_mod, "check_killed", gated)


def test_killed_query_equals_the_jax_server(servers, monkeypatch):
    """KILL QUERY from a second connection: the victim's statement gets
    errno 1105 "Query execution was interrupted" in both servers, and
    its connection answers the next query."""
    from tidb_tpu.copr import coordinator as jcoord
    from tidb_tpu_torch.copr import coordinator as pcoord
    outs = []
    for srv, mod in ((servers[0], jcoord), (servers[1], pcoord)):
        victim = Raw(srv.port)
        cid = max(sid for sid, _s in srv.domain.sessions())
        sess = dict(srv.domain.sessions())[cid]
        _gate_check_killed(monkeypatch, mod, sess._kill_event)
        res = []
        th = threading.Thread(target=lambda: res.append(
            victim.query("select k, sum(v) from t group by k")))
        th.start()
        killer = Raw(srv.port)
        deadline = time.monotonic() + WAIT_S
        while srv.domain.coordinator.get(cid) is None:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        listed = killer.query("show processlist")
        assert any(P.put_lenenc_str(str(cid).encode()) in pkt
                   for pkt in listed[6:-1])
        ok = killer.query(f"kill query {cid}")
        th.join(WAIT_S)
        assert not th.is_alive()
        after = victim.query("select count(*) from u")
        victim.close()
        killer.close()
        outs.append((ok, res[0], after))
    assert outs[1][0] == outs[0][0]
    err = outs[1][1]
    assert len(err) == 1 and err[0][:9] == outs[0][1][0][:9]
    assert struct.unpack_from("<H", err[0], 1)[0] == 1105
    assert err[0][3:9] == b"#HY000"
    assert err[0][9:] == outs[0][1][0][9:] == \
        b"Query execution was interrupted"
    assert outs[1][2] == outs[0][2]


def test_connections_share_one_domain(servers):
    _jsrv, psrv = servers
    c1, c2 = Client("127.0.0.1", psrv.port), Client("127.0.0.1", psrv.port)
    c1.execute("create table if not exists shared_t (v bigint)")
    c1.execute("insert into shared_t values (7)")
    assert c2.query("select v from shared_t") == [("7",)]
    got, errs = {}, []

    def run(i):
        try:
            c = Client("127.0.0.1", psrv.port)
            got[i] = c.query(f"select count(*), sum(v) from t where id > {i}")
            c.close()
        except Exception as e:          # reported below
            errs.append(e)
    ths = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(WAIT_S)
    assert not errs and not any(th.is_alive() for th in ths)
    for i in range(4):
        assert got[i] == c1.query(
            f"select count(*), sum(v) from t where id > {i}")
    c1.execute("drop table shared_t")
    c1.close()
    c2.close()


def test_caching_sha2_over_tls_equals_the_jax_server(servers):
    if shutil.which("openssl") is None:
        pytest.skip("openssl is missing: no self-signed TLS pair")
    from tidb_tpu_torch.testing.mysql_client import (ClientError,
                                                     MiniMySQLClient)
    outs = []
    for srv in servers:
        srv.sha2_cache.clear()
        c = MiniMySQLClient("127.0.0.1", srv.port, use_tls=True,
                            auth_plugin="caching_sha2_password")
        full = (c.tls, c.query("select count(*), sum(w) from u"))
        c.close()
        c = MiniMySQLClient("127.0.0.1", srv.port,
                            auth_plugin="caching_sha2_password")
        fast = (c.tls, c.query("select 2"))
        c.close()
        with pytest.raises(ClientError) as e:
            MiniMySQLClient("127.0.0.1", srv.port, use_tls=True,
                            password="wrong",
                            auth_plugin="caching_sha2_password")
        srv.sha2_cache.clear()
        with pytest.raises(ClientError) as e2:     # full auth needs TLS
            MiniMySQLClient("127.0.0.1", srv.port,
                            auth_plugin="caching_sha2_password")
        outs.append((full, fast, e.value.errno, e2.value.errno))
    assert outs[1] == outs[0]
    assert outs[0][0][0] is True and outs[0][2] == 1045


STATUS_ROUTES = ["/status", "/schema", "/schema/test", "/schema/test/t",
                 "/stats", "/settings", "/regions/meta",
                 "/mvcc/key/test/t/1", "/ddl/history", "/schema_version"]


def _get(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=WAIT_S) as r:
        return r.read().decode()


def test_status_routes_equal_the_jax_server(servers):
    jsrv, psrv = servers
    jst, pst = JStatus(jsrv.domain), StatusServer(psrv.domain)
    jst.start()
    pst.start()
    try:
        gc.collect()          # the session registries are weak
        for route in STATUS_ROUTES:
            want = json.loads(_get(jst.port, route))
            got = json.loads(_get(pst.port, route))
            if route == "/settings":
                want.pop("tidb_enable_auto_analyze")
                got.pop("tidb_enable_auto_analyze")
            if route == "/status":
                # each domain counts its own live sessions
                want.pop("connections")
                assert got.pop("connections") >= 1
            if route.startswith("/mvcc/"):
                # commit timestamps are each store's own clock
                for ent in want["versions"] + got["versions"]:
                    ent.pop("commit_ts")
            assert got == want, route
        metrics = _get(pst.port, "/metrics")
        assert "tidb_tpu_query_total" in metrics
        assert "tidb_tpu_query_duration_seconds" in metrics
        for route in ("/sched", "/resource", "/pd", "/hbm", "/locksan",
                      "/profile", "/trace", "/trace/abc"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(pst.port, route)
            assert e.value.code == 501
            assert "ROADMAP.md, Queue 1 item" in e.value.read().decode()
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(pst.port, "/schema/nosuch")
        assert e.value.code == 404
    finally:
        jst.close()
        pst.close()


def test_graceful_close():
    srv = MySQLServer(Domain("cpu"))
    srv.start()
    c = Client("127.0.0.1", srv.port)
    assert c.query("select 1") == [("1",)]
    live = Client("127.0.0.1", srv.port)
    c.close()
    t0 = time.monotonic()
    srv.close(timeout=1.0)
    assert time.monotonic() - t0 < 5.0
    with pytest.raises(OSError):
        Client("127.0.0.1", srv.port)
    with pytest.raises((OSError, MySQLError, IndexError)):
        live.query("select 1")
    srv.domain.close()


# ------------------------------------------------------------------ #
# the client made safe for concurrent statements
# ------------------------------------------------------------------ #

N_THREADS = 8


def _mixed_statements(i: int) -> list:
    """Thread ``i``'s statements: aggregations, and row-returning
    statements whose predicate constants differ between threads, each a
    new paging-feedback digest."""
    return [
        "select l_returnflag, count(*), sum(l_quantity) from lineitem"
        " group by l_returnflag order by l_returnflag",
        f"select l_orderkey, l_linenumber from lineitem where l_quantity"
        f" > {10 + i} order by l_orderkey, l_linenumber",
        f"select count(*), sum(l_extendedprice) from lineitem"
        f" where l_discount < 0.0{i % 9 + 1}",
        f"select l_orderkey, l_quantity from lineitem where l_partkey"
        f" % {i + 3} = 0 and l_quantity < {30 + i}",
        f"select l_shipmode, max(l_tax) from lineitem where l_quantity"
        f" < {20 + 2 * i} group by l_shipmode order by l_shipmode",
        f"select l_orderkey from lineitem where l_suppkey < {i * 7 + 5}"
        f" order by l_orderkey limit 9",
    ]


def test_eight_threads_equal_the_serial_run(monkeypatch):
    from tidb_tpu_torch.store import client as client_mod
    from tidb_tpu_torch.testing import tpch
    monkeypatch.setattr(client_mod, "PAGE_FEEDBACK_CAP", 4)
    sess = tpch.sql_session({"lineitem": tpch.gen_lineitem(0.002, 3)},
                            device="cpu", n_devices=2)
    dom = sess.domain
    # every statement runs its cop task (no result-cache hit), so each
    # thread's own timings come from a device program run
    sess.execute("set global tidb_tpu_result_cache_entries = 0")
    work = {i: _mixed_statements(i) for i in range(N_THREADS)}
    serial = {i: [sess.must_query(q) for q in qs] for i, qs in work.items()}
    got, errs = {}, []
    start = threading.Barrier(N_THREADS)

    def run(i):
        s = Session(dom)
        out = []
        try:
            start.wait(WAIT_S)
            for _ in range(2):
                for q in work[i]:
                    out.append(s.must_query(q))
                    # the client's timings are this thread's own
                    assert "place" in dom.client.timings
        except Exception as e:          # reported below
            errs.append((i, repr(e)))
        got[i] = out

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ths = [threading.Thread(target=run, args=(i,))
               for i in range(N_THREADS)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(WAIT_S * 6)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths)
    assert not errs, errs
    for i in range(N_THREADS):
        assert got[i] == serial[i] * 2, i
    assert len(dom.client._page_feedback) <= 4
