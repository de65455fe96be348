# ported from tidb_tpu/server/mysql_server.py @ 6233200
"""MySQL wire protocol server.

Reference analog: pkg/server — Server.Run accept loop (server.go),
clientConn.Run dispatch loop (conn.go:1048,:1289), prepared statements
(conn_stmt.go).  One thread per connection (the goroutine-per-conn
analog), all connections sharing one Domain; each gets its own Session.

Supports: handshake v10 with mysql_native_password AND
caching_sha2_password auth (fast path from the sha2 cache, full auth
over TLS — conn.go authSha analog), TLS connection upgrade
(conn.go:2497 upgradeToTLS analog; self-signed cert auto-generated via
openssl when none is configured), COM_QUERY (text resultsets,
multi-statement), COM_INIT_DB, COM_PING, COM_FIELD_LIST,
COM_STMT_PREPARE/EXECUTE/RESET/CLOSE (binary protocol), read-only
cursors + COM_STMT_FETCH streaming (conn.go:1436 ComStmtFetch analog),
graceful shutdown draining live connections.

The port's server builds its Domain on the caller's ``device`` (the
default is the card) and never swaps it for another: a statement that
fails on the card reaches the client as an error packet.  A path the
port does not run yet raises ``NotImplementedError`` naming its
ROADMAP.md item, which reaches the client as errno 1105 with the
connection left open.
"""

from __future__ import annotations

import os
import socket
import ssl
import struct
import subprocess
import tempfile
import threading
from dataclasses import dataclass, field
from typing import Optional

from ..session.session import Domain, Session
# placeholder binding is shared with the SQL-level PREPARE/EXECUTE path
from ..sql.bind import (bind_placeholders as _bind_placeholders,
                        count_placeholders as _count_placeholders,
                        strip_placeholders as _strip_placeholders)
from . import packet as P

SERVER_VERSION = "8.0.11-tidb-tpu-0.1"

ER_ACCESS_DENIED = 1045
ER_UNKNOWN = 1105
ER_PARSE = 1064
ER_DUP_ENTRY = 1062


class PacketIO:
    """Length-prefixed packet framing with sequence ids (conn.go
    readPacket/writePacket analog)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.seq = 0

    def read(self) -> bytes:
        header = self._read_n(4)
        length = int.from_bytes(header[:3], "little")
        self.seq = (header[3] + 1) & 0xFF
        payload = self._read_n(length)
        while length == 0xFFFFFF:  # multi-packet payload
            header = self._read_n(4)
            length = int.from_bytes(header[:3], "little")
            self.seq = (header[3] + 1) & 0xFF
            payload += self._read_n(length)
        return payload

    def write(self, payload: bytes):
        data = payload
        while True:
            chunk, data = data[:0xFFFFFF], data[0xFFFFFF:]
            self.sock.sendall(len(chunk).to_bytes(3, "little")
                              + bytes([self.seq]) + chunk)
            self.seq = (self.seq + 1) & 0xFF
            if len(chunk) < 0xFFFFFF:
                break

    def reset_seq(self):
        self.seq = 0

    def _read_n(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            got = self.sock.recv(n - len(buf))
            if not got:
                raise ConnectionError("client closed")
            buf += got
        return buf


@dataclass
class PreparedStmt:
    stmt_id: int
    sql: str
    n_params: int
    param_types: Optional[list] = None
    # read-only cursor state (COM_STMT_EXECUTE with CURSOR_TYPE_READ_ONLY
    # stores the resultset; COM_STMT_FETCH streams it in row batches)
    cursor_rows: Optional[list] = None
    cursor_dtypes: Optional[list] = None
    cursor_pos: int = 0


class ClientConn:
    """One connection: auth handshake then the dispatch loop."""

    def __init__(self, server: "MySQLServer", sock: socket.socket):
        self.server = server
        self.io = PacketIO(sock)
        self.sock = sock
        self.session = Session(server.domain)
        self.stmts: dict[int, PreparedStmt] = {}
        self._next_stmt_id = 0
        self.user = ""
        self.tls = False

    # -------------------------------------------------------------- #

    def run(self):
        try:
            if not self._handshake():
                return
            while not self.server._closing:
                self.io.reset_seq()
                try:
                    payload = self.io.read()
                except ConnectionError:
                    return
                if not payload:
                    continue
                cmd, body = payload[0], payload[1:]
                if cmd == P.COM_QUIT:
                    return
                try:
                    self._dispatch(cmd, body)
                except ConnectionError:
                    return
                except Exception as e:  # statement errors -> ERR packet
                    self.io.write(P.err_packet(_errno_for(e), str(e)))
        finally:
            try:
                self.session.close()   # drop temp tables' KV rows
            except Exception:
                pass
            try:
                self.sock.close()
            except OSError:
                pass
            self.server._conn_done(self)

    def _handshake(self) -> bool:
        salt = os.urandom(20).replace(b"\x00", b"\x01")
        caps = P.SERVER_CAPABILITIES
        if self.server.tls_enabled:      # advertise without eager keygen
            caps |= P.CLIENT_SSL
        self.io.write(P.handshake_v10(self.session.conn_id, salt,
                                      SERVER_VERSION, caps))
        payload = self.io.read()
        client_caps = struct.unpack_from("<I", payload, 0)[0]
        if client_caps & P.CLIENT_SSL and len(payload) <= 32:
            # SSLRequest: upgrade the connection, then read the real
            # handshake response over TLS (conn.go upgradeToTLS)
            if self.server.ssl_context is None:
                self.io.write(P.err_packet(ER_UNKNOWN, "TLS not enabled"))
                return False
            self.sock = self.server.ssl_context.wrap_socket(
                self.sock, server_side=True)
            self.io.sock = self.sock
            self.tls = True
            payload = self.io.read()
        resp = P.parse_handshake_response(payload)
        self.user = resp["user"]
        ok, err = self._authenticate(resp, salt)
        if not ok:
            self.io.write(P.err_packet(
                ER_ACCESS_DENIED,
                err or f"Access denied for user '{resp['user']}'",
                "28000"))
            return False
        if resp["db"]:
            try:
                self.session.execute(f"USE {resp['db']}")
            except Exception as e:
                self.io.write(P.err_packet(ER_UNKNOWN, str(e)))
                return False
        self.session.user = resp["user"]
        self.io.write(P.ok_packet(status=self._status()))
        return True

    def _authenticate(self, resp: dict, salt: bytes):
        """Plugin-aware auth: mysql_native_password verifies the SHA1
        scramble; caching_sha2_password takes the fast path when the
        server's sha2 cache holds this user, else requests FULL
        authentication (cleartext over TLS only — the RSA exchange is
        deliberately absent, like a no-RSA-key reference deployment)."""
        user, auth = resp["user"], resp["auth"]
        plugin = resp["plugin"] or "mysql_native_password"
        if plugin == "mysql_native_password":
            return self.server.authenticate(user, auth, salt)
        if plugin != "caching_sha2_password":
            # unknown plugin: switch the client down to native
            self.io.write(P.auth_switch_request(
                "mysql_native_password", salt))
            auth = self.io.read()
            return self.server.authenticate(user, auth, salt)
        cached = self.server.sha2_cache.get(user)
        if cached is not None:
            digest, primed_hash = cached
            # a password change invalidates the cache entry: it was
            # derived from a credential that no longer matches
            if primed_hash != self.server.stored_credential(user):
                self.server.sha2_cache.pop(user, None)
            else:
                from ..utils.auth import check_sha2_scramble
                if check_sha2_scramble(auth, salt, digest):
                    self.io.write(P.auth_more_data(P.SHA2_FAST_AUTH_OK))
                    return True, None
                # fast-auth mismatch falls THROUGH to full auth (MySQL's
                # protocol: only full auth may hard-deny)
                self.server.sha2_cache.pop(user, None)
        # cache miss: full authentication — cleartext password, TLS only
        self.io.write(P.auth_more_data(P.SHA2_FULL_AUTH))
        if not getattr(self, "tls", False):
            return False, ("caching_sha2_password full authentication "
                           "requires a TLS connection")
        pwd = self.io.read().rstrip(b"\x00").decode()
        ok, err = self.server.authenticate_cleartext(user, pwd)
        if ok:
            from ..utils.auth import sha2_cache_digest
            self.server.sha2_cache[user] = (
                sha2_cache_digest(pwd), self.server.stored_credential(user))
        return ok, err

    def _status(self) -> int:
        st = P.SERVER_STATUS_AUTOCOMMIT
        if self.session.txn is not None:
            st |= P.SERVER_STATUS_IN_TRANS
        return st

    # -------------------------------------------------------------- #

    def _dispatch(self, cmd: int, body: bytes):
        if cmd == P.COM_PING:
            self.io.write(P.ok_packet(status=self._status()))
        elif cmd == P.COM_INIT_DB:
            self.session.execute(f"USE {body.decode()}")
            self.io.write(P.ok_packet(status=self._status()))
        elif cmd == P.COM_QUERY:
            self._handle_query(body.decode())
        elif cmd == P.COM_FIELD_LIST:
            self._handle_field_list(body)
        elif cmd == P.COM_STMT_PREPARE:
            self._handle_stmt_prepare(body.decode())
        elif cmd == P.COM_STMT_EXECUTE:
            self._handle_stmt_execute(body)
        elif cmd == P.COM_STMT_FETCH:
            self._handle_stmt_fetch(body)
        elif cmd == P.COM_STMT_RESET:
            st = self.stmts.get(struct.unpack_from("<I", body, 0)[0])
            if st is not None:
                st.cursor_rows = None
                st.cursor_pos = 0
            self.io.write(P.ok_packet(status=self._status()))
        elif cmd == P.COM_STMT_CLOSE:
            self.stmts.pop(struct.unpack_from("<I", body, 0)[0], None)
            # COM_STMT_CLOSE sends no response
        else:
            self.io.write(P.err_packet(ER_UNKNOWN,
                                       f"unsupported command {cmd:#x}"))

    def _handle_query(self, sql: str):
        rs = self.session.execute(sql)
        if rs.names:
            self._write_resultset(rs, binary=False)
        else:
            self.io.write(P.ok_packet(rs.affected, rs.last_insert_id,
                                      status=self._status()))

    def _handle_field_list(self, body: bytes):
        table = body.split(b"\x00", 1)[0].decode()
        tbl = self.session.domain.catalog.get_table(self.session.db, table)
        for name, t in zip(tbl.col_names, tbl.col_types):
            self.io.write(P.column_def(name, t, self.session.db, table))
        self.io.write(P.eof_packet(self._status()))

    def _write_resultset(self, rs, binary: bool):
        dtypes = rs.dtypes or [None] * len(rs.names)
        self.io.write(P.put_lenenc_int(len(rs.names)))
        for name, t in zip(rs.names, dtypes):
            self.io.write(P.column_def(name, t, self.session.db))
        self.io.write(P.eof_packet(self._status()))
        for row in rs.rows:
            self.io.write(P.binary_row(row, dtypes) if binary
                          else P.text_row(row))
        self.io.write(P.eof_packet(self._status()))

    # ---------------- prepared statements ---------------- #

    def _handle_stmt_prepare(self, sql: str):
        from ..sql.parser import parse_sql
        parse_sql(_strip_placeholders(sql))  # syntax check at prepare time
        n_params = _count_placeholders(sql)
        self._next_stmt_id += 1
        st = PreparedStmt(self._next_stmt_id, sql, n_params)
        self.stmts[st.stmt_id] = st
        head = (b"\x00" + struct.pack("<I", st.stmt_id)
                + struct.pack("<H", 0)            # column count (deferred)
                + struct.pack("<H", n_params)
                + b"\x00" + struct.pack("<H", 0))
        self.io.write(head)
        if n_params:
            for i in range(n_params):
                self.io.write(P.column_def(f"?{i}", None))
            self.io.write(P.eof_packet(self._status()))

    def _handle_stmt_execute(self, body: bytes):
        stmt_id = struct.unpack_from("<I", body, 0)[0]
        st = self.stmts.get(stmt_id)
        if st is None:
            self.io.write(P.err_packet(ER_UNKNOWN, "unknown statement"))
            return
        flags = body[4]
        pos = 4 + 1 + 4  # stmt id, flags, iteration count
        params, st.param_types = P.parse_binary_params(
            body, pos, st.n_params, st.param_types)
        sql = _bind_placeholders(st.sql, params)
        st.cursor_rows = None       # re-execute closes any open cursor
        st.cursor_pos = 0
        rs = self.session.execute(sql)
        if rs.names and flags & P.CURSOR_TYPE_READ_ONLY:
            # cursor open (ComStmtFetch protocol, conn.go:1436): column
            # defs + CURSOR_EXISTS now, rows stream via COM_STMT_FETCH
            st.cursor_rows = list(rs.rows)
            st.cursor_dtypes = rs.dtypes or [None] * len(rs.names)
            st.cursor_pos = 0
            self.io.write(P.put_lenenc_int(len(rs.names)))
            for name, t in zip(rs.names, st.cursor_dtypes):
                self.io.write(P.column_def(name, t, self.session.db))
            self.io.write(P.eof_packet(
                self._status() | P.SERVER_STATUS_CURSOR_EXISTS))
            return
        if rs.names:
            self._write_resultset(rs, binary=True)
        else:
            self.io.write(P.ok_packet(rs.affected, rs.last_insert_id,
                                      status=self._status()))

    def _handle_stmt_fetch(self, body: bytes):
        stmt_id, count = struct.unpack_from("<II", body, 0)
        st = self.stmts.get(stmt_id)
        if st is None or st.cursor_rows is None:
            self.io.write(P.err_packet(ER_UNKNOWN, "no open cursor"))
            return
        end = min(st.cursor_pos + max(count, 1), len(st.cursor_rows))
        for row in st.cursor_rows[st.cursor_pos:end]:
            self.io.write(P.binary_row(row, st.cursor_dtypes))
        st.cursor_pos = end
        status = self._status() | P.SERVER_STATUS_CURSOR_EXISTS
        if end >= len(st.cursor_rows):
            status |= P.SERVER_STATUS_LAST_ROW_SENT
        self.io.write(P.eof_packet(status))


_AUTO_SSL_CTX: list = [None]    # process-wide cache: one keygen total
_auto_ssl_lock = threading.Lock()


def _make_ssl_context(cert: Optional[str],
                      key: Optional[str]) -> Optional[ssl.SSLContext]:
    """Server TLS context.  An EXPLICITLY configured cert/key that fails
    to load raises (silently downgrading to plaintext would hide the
    operator's mistake); with none configured, a self-signed pair is
    generated once per process via openssl (the reference auto-generates
    certs the same way, util/misc.go CreateCertificates) and TLS
    degrades to disabled only if openssl is unavailable."""
    if cert is not None or key is not None:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert, key)      # raises on bad config
        return ctx
    with _auto_ssl_lock:
        if _AUTO_SSL_CTX[0] is not None:
            return _AUTO_SSL_CTX[0]
        try:
            d = tempfile.mkdtemp(prefix="tidb_tpu_tls_")
            cpath = os.path.join(d, "server.crt")
            kpath = os.path.join(d, "server.key")
            subprocess.run(
                ["openssl", "req", "-x509", "-newkey", "rsa:2048",
                 "-keyout", kpath, "-out", cpath, "-days", "365",
                 "-nodes", "-subj", "/CN=tidb-tpu"],
                check=True, capture_output=True)
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(cpath, kpath)
            import atexit
            import shutil
            atexit.register(shutil.rmtree, d, True)  # don't leak the key
            _AUTO_SSL_CTX[0] = ctx
            return ctx
        except Exception:
            return None


def _errno_for(e: Exception) -> int:
    # typed errors carry their MySQL/TiDB error number (e.g. the
    # admission scheduler's ServerBusyError = 9003, TiKV-server-is-busy)
    code = getattr(e, "errno", None)
    if isinstance(code, int) and 1000 <= code <= 65535:
        return code
    name = type(e).__name__
    if "Duplicate" in name or "Duplicate entry" in str(e):
        return ER_DUP_ENTRY
    if "Parse" in name:
        return ER_PARSE
    return ER_UNKNOWN




class MySQLServer:
    """Accept loop + connection registry (server.go Server analog)."""

    def __init__(self, domain: Optional[Domain] = None, host: str = "127.0.0.1",
                 port: int = 0, ssl_cert: Optional[str] = None,
                 ssl_key: Optional[str] = None, tls: bool = True,
                 device="cuda"):
        self.domain = domain or Domain(device)
        self.host = host
        self.port = port
        self._listener: Optional[socket.socket] = None
        self._conns: set[ClientConn] = set()
        self._lock = threading.Lock()
        self._closing = False
        self._thread: Optional[threading.Thread] = None
        # user -> SHA1(SHA1(password)) (mysql.user authentication_string)
        self.users: dict[str, bytes] = {"root": P.native_password_hash("")}
        # cleartext registry for caching_sha2 FULL auth verification when
        # no privilege manager is installed (test/bootstrap servers)
        self._plain_users: dict[str, str] = {"root": ""}
        # caching_sha2_password fast-auth cache:
        # user -> (SHA256(SHA256(pw)), credential it was derived from)
        self.sha2_cache: dict[str, tuple] = {}
        self._tls = tls
        self._ssl_cert, self._ssl_key = ssl_cert, ssl_key
        self._ssl_ctx: Optional[ssl.SSLContext] = None

    @property
    def tls_enabled(self) -> bool:
        return self._tls

    @property
    def ssl_context(self) -> Optional[ssl.SSLContext]:
        """Lazily built on first use: the auto-generated self-signed cert
        costs an RSA keygen, which embedded/test servers that never see
        an SSLRequest should not pay."""
        if not self._tls:
            return None
        if self._ssl_ctx is None:
            self._ssl_ctx = _make_ssl_context(self._ssl_cert, self._ssl_key)
            if self._ssl_ctx is None:
                self._tls = False
        return self._ssl_ctx

    def stored_credential(self, user: str):
        """The current stored auth credential (cache-invalidation token
        for the sha2 fast-auth cache)."""
        priv = getattr(self.domain, "privileges", None)
        if priv is not None:
            rec = priv._match(user)
            return rec.auth_hash if rec is not None else None
        h = self.users.get(user)
        return h if h is not None else self._plain_users.get(user)

    # -------------------------------------------------------------- #

    def authenticate(self, user: str, auth: bytes, salt: bytes):
        from ..plugin import registry as _plugins
        veto = _plugins.check_auth(user)
        if veto is False:        # authentication plugin kind: hard veto
            return False, f"Access denied for user '{user}' (plugin)"
        priv = getattr(self.domain, "privileges", None)
        if priv is not None:
            return priv.authenticate(user, auth, salt)
        stored = self.users.get(user)
        if stored is None:
            return False, None
        return P.check_scramble(auth, salt, stored), None

    def authenticate_cleartext(self, user: str, password: str):
        """caching_sha2 full-auth verify: the cleartext (TLS-protected)
        password checks against the stored SHA1(SHA1(pw)) credential."""
        priv = getattr(self.domain, "privileges", None)
        if priv is not None and hasattr(priv, "authenticate_cleartext"):
            return priv.authenticate_cleartext(user, password)
        expect = (self.users.get(user) if priv is None
                  else getattr(priv, "stored_hash", lambda u: None)(user))
        if expect is None:
            rec = self._plain_users.get(user)
            if rec is None:
                return False, None
            return rec == password, None
        return P.native_password_hash(password) == expect, None

    def start(self) -> int:
        """Bind + start the accept thread; returns the bound port."""
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self._listener.listen(64)
        self.port = self._listener.getsockname()[1]
        # daemon plugin kind starts only after the bind succeeded (a
        # failed start() must not leak running daemons)
        from ..plugin import registry as _plugins
        _plugins.start_daemons(self.domain)
        self._daemons_started = True
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="mysql-accept", daemon=True)
        self._thread.start()
        return self.port

    def _accept_loop(self):
        while not self._closing:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            if self._closing:
                sock.close()
                return
            conn = ClientConn(self, sock)
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=conn.run, daemon=True).start()

    def _conn_done(self, conn: ClientConn):
        with self._lock:
            self._conns.discard(conn)

    def close(self, timeout: float = 5.0):
        """Graceful shutdown: stop accepting, wait for live conns
        (server.go graceful shutdown analog)."""
        if getattr(self, "_daemons_started", False):
            from ..plugin import registry as _plugins
            _plugins.stop_daemons()
            self._daemons_started = False
        self._closing = True
        if self._listener is not None:
            # shutdown() interrupts a thread blocked in accept() — close()
            # alone leaves the kernel socket alive via the in-syscall ref
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        import time
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if not self._conns:
                    break
            time.sleep(0.02)
        with self._lock:
            for c in list(self._conns):
                try:
                    c.sock.close()
                except OSError:
                    pass


__all__ = ["MySQLServer", "ClientConn", "SERVER_VERSION"]
