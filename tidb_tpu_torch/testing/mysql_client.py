# ported from tidb_tpu/testing/mysql_client.py @ 6233200
"""Minimal protocol-faithful MySQL client (v4.1 protocol).

Role: the image ships no third-party MySQL connector (pymysql /
mysql-connector are absent), so interop tests drive the server through
this independent client implementation instead — TLS upgrade
(SSLRequest), mysql_native_password AND caching_sha2_password (fast +
full auth), COM_QUERY text resultsets, and prepared statements with
read-only cursors + COM_STMT_FETCH.  It shares NO code with the server
loop: packets are parsed here from the wire bytes, so a framing or
status-flag bug on either side fails the tests.

Reference analog: the clients TiDB tests itself with (go-sql-driver
semantics; conn.go:2497 upgradeToTLS, conn.go:1436 ComStmtFetch).
"""

from __future__ import annotations

import socket
import ssl as ssl_mod
import struct
from typing import Any, Optional

from ..utils.auth import scramble_password, sha2_scramble

CLIENT_LONG_PASSWORD = 1 << 0
CLIENT_CONNECT_WITH_DB = 1 << 3
CLIENT_PROTOCOL_41 = 1 << 9
CLIENT_SSL = 1 << 11
CLIENT_TRANSACTIONS = 1 << 13
CLIENT_SECURE_CONNECTION = 1 << 15
CLIENT_PLUGIN_AUTH = 1 << 19

COM_QUERY = 0x03
COM_STMT_PREPARE = 0x16
COM_STMT_EXECUTE = 0x17
COM_STMT_FETCH = 0x1C
CURSOR_TYPE_READ_ONLY = 0x01

SERVER_STATUS_CURSOR_EXISTS = 0x0040
SERVER_STATUS_LAST_ROW_SENT = 0x0080

MYSQL_TYPE_LONGLONG = 0x08
MYSQL_TYPE_DOUBLE = 0x05
MYSQL_TYPE_DATE = 0x0A
MYSQL_TYPE_DATETIME = 0x0C


class ClientError(RuntimeError):
    def __init__(self, errno, msg):
        super().__init__(f"({errno}) {msg}")
        self.errno = errno


def _lenenc_int(buf, pos):
    first = buf[pos]
    if first < 0xFB:
        return first, pos + 1
    if first == 0xFC:
        return struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
    if first == 0xFD:
        return int.from_bytes(buf[pos + 1:pos + 4], "little"), pos + 4
    return struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9


def _lenenc_str(buf, pos):
    n, pos = _lenenc_int(buf, pos)
    return buf[pos:pos + n], pos + n


class MiniMySQLClient:
    def __init__(self, host: str, port: int, user: str = "root",
                 password: str = "", use_tls: bool = False,
                 auth_plugin: str = "mysql_native_password",
                 database: str = ""):
        self.sock = socket.create_connection((host, port), timeout=30)
        self.seq = 0
        self.tls = False
        self._connect(user, password, use_tls, auth_plugin, database)

    # ---------------- framing ---------------- #

    def _read_n(self, n):
        buf = b""
        while len(buf) < n:
            got = self.sock.recv(n - len(buf))
            if not got:
                raise ConnectionError("server closed")
            buf += got
        return buf

    def _read_packet(self) -> bytes:
        hdr = self._read_n(4)
        ln = int.from_bytes(hdr[:3], "little")
        self.seq = (hdr[3] + 1) & 0xFF
        return self._read_n(ln)

    def _write_packet(self, payload: bytes):
        self.sock.sendall(len(payload).to_bytes(3, "little")
                          + bytes([self.seq]) + payload)
        self.seq = (self.seq + 1) & 0xFF

    def _command(self, cmd: int, body: bytes):
        self.seq = 0
        self._write_packet(bytes([cmd]) + body)

    # ---------------- handshake ---------------- #

    def _connect(self, user, password, use_tls, plugin, database):
        greet = self._read_packet()
        # protocol v10 greeting
        pos = greet.index(0, 1) + 1          # server version NUL
        pos += 4                              # conn id
        salt = greet[pos:pos + 8]
        pos += 9
        caps = struct.unpack_from("<H", greet, pos)[0]
        pos += 2 + 1 + 2                      # caps lo, charset, status
        caps |= struct.unpack_from("<H", greet, pos)[0] << 16
        pos += 2 + 1 + 10
        salt += greet[pos:pos + 12]
        self.server_caps = caps

        my_caps = (CLIENT_LONG_PASSWORD | CLIENT_PROTOCOL_41
                   | CLIENT_TRANSACTIONS | CLIENT_SECURE_CONNECTION
                   | CLIENT_PLUGIN_AUTH)
        if database:
            my_caps |= CLIENT_CONNECT_WITH_DB
        if use_tls:
            if not caps & CLIENT_SSL:
                raise ClientError(0, "server does not offer TLS")
            my_caps |= CLIENT_SSL
            # SSLRequest: caps + max packet + charset + 23 filler
            self._write_packet(struct.pack("<IIB", my_caps, 1 << 24, 33)
                               + b"\x00" * 23)
            ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_CLIENT)
            ctx.check_hostname = False
            ctx.verify_mode = ssl_mod.CERT_NONE   # self-signed server cert
            self.sock = ctx.wrap_socket(self.sock)
            self.tls = True

        if plugin == "caching_sha2_password":
            token = sha2_scramble(password, salt)
        else:
            token = scramble_password(password, salt)
        resp = struct.pack("<IIB", my_caps, 1 << 24, 33) + b"\x00" * 23
        resp += user.encode() + b"\x00"
        resp += bytes([len(token)]) + token
        if database:
            resp += database.encode() + b"\x00"
        resp += plugin.encode() + b"\x00"
        self._write_packet(resp)
        self._auth_loop(password, salt, plugin)

    def _auth_loop(self, password, salt, plugin):
        while True:
            pkt = self._read_packet()
            if pkt[0] == 0x00:        # OK
                return
            if pkt[0] == 0xFF:
                errno = struct.unpack_from("<H", pkt, 1)[0]
                raise ClientError(errno, pkt[9:].decode(errors="replace"))
            if pkt[0] == 0x01:        # AuthMoreData
                if pkt[1:] == b"\x03":      # sha2 fast-auth success
                    continue
                if pkt[1:] == b"\x04":      # perform full authentication
                    if not self.tls:
                        raise ClientError(0, "full auth requires TLS")
                    self._write_packet(password.encode() + b"\x00")
                    continue
            if pkt[0] == 0xFE:        # AuthSwitchRequest
                end = pkt.index(0, 1)
                new_plugin = pkt[1:end].decode()
                new_salt = pkt[end + 1:].rstrip(b"\x00")
                if new_plugin == "caching_sha2_password":
                    self._write_packet(sha2_scramble(password, new_salt))
                else:
                    self._write_packet(scramble_password(password, new_salt))
                continue
            raise ClientError(0, f"unexpected auth packet {pkt[:1].hex()}")

    # ---------------- queries ---------------- #

    def query(self, sql: str) -> list[tuple]:
        """COM_QUERY -> decoded text resultset (or [] for OK)."""
        self._command(COM_QUERY, sql.encode())
        first = self._read_packet()
        if first[0] == 0x00:
            return []
        if first[0] == 0xFF:
            errno = struct.unpack_from("<H", first, 1)[0]
            raise ClientError(errno, first[9:].decode(errors="replace"))
        ncols, _ = _lenenc_int(first, 0)
        cols = [self._read_column_def() for _ in range(ncols)]
        self._read_packet()               # EOF after column defs
        rows = []
        while True:
            pkt = self._read_packet()
            if pkt[0] == 0xFE and len(pkt) < 9:
                return rows
            rows.append(self._decode_text_row(pkt, ncols))

    def _read_column_def(self):
        pkt = self._read_packet()
        pos = 0
        fields = []
        for _ in range(6):    # catalog, schema, table, org_table, name, org
            s, pos = _lenenc_str(pkt, pos)
            fields.append(s)
        pos += 1 + 2 + 4      # filler, charset, column length
        type_code = pkt[pos]
        return {"name": fields[4].decode(), "type": type_code}

    @staticmethod
    def _decode_text_row(pkt, ncols):
        out, pos = [], 0
        for _ in range(ncols):
            if pkt[pos] == 0xFB:
                out.append(None)
                pos += 1
            else:
                s, pos = _lenenc_str(pkt, pos)
                out.append(s.decode())
        return tuple(out)

    # ---------------- prepared statements + cursor fetch ------------- #

    def prepare(self, sql: str) -> tuple[int, int]:
        self._command(COM_STMT_PREPARE, sql.encode())
        head = self._read_packet()
        if head[0] == 0xFF:
            errno = struct.unpack_from("<H", head, 1)[0]
            raise ClientError(errno, head[9:].decode(errors="replace"))
        stmt_id = struct.unpack_from("<I", head, 1)[0]
        n_params = struct.unpack_from("<H", head, 7)[0]
        if n_params:
            for _ in range(n_params):
                self._read_packet()
            self._read_packet()    # EOF
        return stmt_id, n_params

    def execute_cursor(self, stmt_id: int) -> list[dict]:
        """COM_STMT_EXECUTE with CURSOR_TYPE_READ_ONLY: returns column
        defs; rows stream through fetch()."""
        body = struct.pack("<IBI", stmt_id, CURSOR_TYPE_READ_ONLY, 1)
        self._command(COM_STMT_EXECUTE, body)
        first = self._read_packet()
        if first[0] == 0xFF:
            errno = struct.unpack_from("<H", first, 1)[0]
            raise ClientError(errno, first[9:].decode(errors="replace"))
        ncols, _ = _lenenc_int(first, 0)
        cols = [self._read_column_def() for _ in range(ncols)]
        eof = self._read_packet()
        status = struct.unpack_from("<H", eof, 3)[0]
        assert status & SERVER_STATUS_CURSOR_EXISTS, \
            "server did not open a cursor"
        self._cursor_cols = cols
        return cols

    def fetch(self, stmt_id: int, count: int) -> tuple[list[tuple], bool]:
        """COM_STMT_FETCH: up to `count` binary rows; (rows, done)."""
        self._command(COM_STMT_FETCH, struct.pack("<II", stmt_id, count))
        rows = []
        while True:
            pkt = self._read_packet()
            if pkt[0] == 0xFE and len(pkt) < 9:
                status = struct.unpack_from("<H", pkt, 3)[0]
                return rows, bool(status & SERVER_STATUS_LAST_ROW_SENT)
            rows.append(self._decode_binary_row(pkt, self._cursor_cols))

    @staticmethod
    def _decode_binary_row(pkt, cols):
        n = len(cols)
        nb = (n + 7 + 2) // 8
        bitmap = pkt[1:1 + nb]
        pos = 1 + nb
        out = []
        for i, c in enumerate(cols):
            if bitmap[(i + 2) // 8] & (1 << ((i + 2) % 8)):
                out.append(None)
                continue
            t = c["type"]
            if t == MYSQL_TYPE_LONGLONG:
                out.append(struct.unpack_from("<q", pkt, pos)[0])
                pos += 8
            elif t == MYSQL_TYPE_DOUBLE:
                out.append(struct.unpack_from("<d", pkt, pos)[0])
                pos += 8
            elif t in (MYSQL_TYPE_DATE, MYSQL_TYPE_DATETIME):
                ln = pkt[pos]
                pos += 1 + ln
                out.append(f"<temporal:{ln}>")
            else:
                s, pos = _lenenc_str(pkt, pos)
                out.append(s.decode())
        return tuple(out)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


__all__ = ["MiniMySQLClient", "ClientError"]
