# ported from tidb_tpu/server/client.py @ 6233200
"""Minimal MySQL client over the wire protocol.

The testkit-side counterpart of mysql_server.py (reference analog: the
go-sql-driver used by tests + cmd/dumpling's connection layer).  Speaks
handshake v10 + mysql_native_password, COM_QUERY text resultsets and the
binary prepared-statement protocol — enough for tests and the dump tool
to talk to any MySQL-compatible server.
"""

from __future__ import annotations

import socket
import struct
from typing import Any, Optional, Sequence

from . import packet as P
from .mysql_server import PacketIO


class MySQLError(RuntimeError):
    def __init__(self, errno: int, msg: str):
        super().__init__(f"({errno}) {msg}")
        self.errno = errno


class Client:
    def __init__(self, host: str, port: int, user: str = "root",
                 password: str = "", db: str = ""):
        self.sock = socket.create_connection((host, port), timeout=30)
        self.io = PacketIO(self.sock)
        self._connect(user, password, db)

    def _connect(self, user: str, password: str, db: str):
        greeting = self.io.read()
        if greeting and greeting[0] == 0xFF:
            self._raise_err(greeting)
        assert greeting[0] == 0x0A, "unexpected handshake"
        pos = greeting.index(0, 1) + 1          # skip version
        pos += 4                                 # thread id
        salt = greeting[pos:pos + 8]
        pos += 9                                 # salt1 + filler
        pos += 2 + 1 + 2 + 2 + 1 + 10            # caps, charset, status...
        salt += greeting[pos:pos + 12]
        caps = (P.CLIENT_PROTOCOL_41 | P.CLIENT_SECURE_CONNECTION
                | P.CLIENT_PLUGIN_AUTH | P.CLIENT_LONG_PASSWORD)
        if db:
            caps |= P.CLIENT_CONNECT_WITH_DB
        auth = P.scramble_password(password, salt)
        p = bytearray()
        p += struct.pack("<I", caps)
        p += struct.pack("<I", 1 << 24)
        p += bytes([33])
        p += b"\x00" * 23
        p += user.encode() + b"\x00"
        p += bytes([len(auth)]) + auth
        if db:
            p += db.encode() + b"\x00"
        p += b"mysql_native_password\x00"
        self.io.write(bytes(p))
        resp = self.io.read()
        if resp and resp[0] == 0xFF:
            self._raise_err(resp)

    def _raise_err(self, payload: bytes):
        errno = struct.unpack_from("<H", payload, 1)[0]
        msg = payload[9:].decode(errors="replace")
        raise MySQLError(errno, msg)

    def close(self):
        try:
            self.io.reset_seq()
            self.io.write(bytes([P.COM_QUIT]))
        except OSError:
            pass
        self.sock.close()

    # -------------------------------------------------------------- #

    def query(self, sql: str) -> list[tuple]:
        """COM_QUERY; returns rows (text protocol, values as str/None)."""
        self.io.reset_seq()
        self.io.write(bytes([P.COM_QUERY]) + sql.encode())
        return self._read_result()[1]

    def execute(self, sql: str) -> int:
        """COM_QUERY for statements without a resultset; returns affected."""
        self.io.reset_seq()
        self.io.write(bytes([P.COM_QUERY]) + sql.encode())
        affected, rows = self._read_result()
        return affected

    def _read_result(self) -> tuple[int, list[tuple]]:
        first = self.io.read()
        if first[0] == 0xFF:
            self._raise_err(first)
        if first[0] == 0x00:                     # OK packet
            affected, pos = P.get_lenenc_int(first, 1)
            return affected, []
        n_cols, _ = P.get_lenenc_int(first, 0)
        self.columns = []
        for _ in range(n_cols):
            cdef = self.io.read()
            name, _ = _col_name(cdef)
            self.columns.append(name)
        self._expect_eof()
        rows = []
        while True:
            pkt = self.io.read()
            if pkt[0] == 0xFE and len(pkt) < 9:
                break
            if pkt[0] == 0xFF:
                self._raise_err(pkt)
            rows.append(_decode_text_row(pkt, n_cols))
        return 0, rows

    def _expect_eof(self):
        pkt = self.io.read()
        assert pkt[0] == 0xFE, pkt

    # ---------------- prepared statements ---------------- #

    def prepare(self, sql: str) -> "Prepared":
        self.io.reset_seq()
        self.io.write(bytes([P.COM_STMT_PREPARE]) + sql.encode())
        head = self.io.read()
        if head[0] == 0xFF:
            self._raise_err(head)
        stmt_id = struct.unpack_from("<I", head, 1)[0]
        n_cols = struct.unpack_from("<H", head, 5)[0]
        n_params = struct.unpack_from("<H", head, 7)[0]
        for _ in range(n_params):
            self.io.read()
        if n_params:
            self._expect_eof()
        for _ in range(n_cols):
            self.io.read()
        if n_cols:
            self._expect_eof()
        return Prepared(self, stmt_id, n_params)


class Prepared:
    def __init__(self, client: Client, stmt_id: int, n_params: int):
        self.client = client
        self.stmt_id = stmt_id
        self.n_params = n_params

    def execute(self, *params) -> list[tuple]:
        assert len(params) == self.n_params
        c = self.client
        body = bytearray()
        body += bytes([P.COM_STMT_EXECUTE])
        body += struct.pack("<I", self.stmt_id)
        body += b"\x00"
        body += struct.pack("<I", 1)
        if params:
            nb = bytearray((len(params) + 7) // 8)
            types = bytearray()
            vals = bytearray()
            for i, v in enumerate(params):
                if v is None:
                    nb[i // 8] |= 1 << (i % 8)
                    types += bytes([P.MYSQL_TYPE_NULL, 0])
                elif isinstance(v, bool) or isinstance(v, int):
                    types += bytes([P.MYSQL_TYPE_LONGLONG, 0])
                    vals += struct.pack("<q", int(v))
                elif isinstance(v, float):
                    types += bytes([P.MYSQL_TYPE_DOUBLE, 0])
                    vals += struct.pack("<d", v)
                else:
                    types += bytes([P.MYSQL_TYPE_VAR_STRING, 0])
                    vals += P.put_lenenc_str(str(v).encode())
            body += bytes(nb) + b"\x01" + bytes(types) + bytes(vals)
        c.io.reset_seq()
        c.io.write(bytes(body))
        return self._read_binary_result()

    def close(self):
        c = self.client
        c.io.reset_seq()
        c.io.write(bytes([P.COM_STMT_CLOSE])
                   + struct.pack("<I", self.stmt_id))

    def _read_binary_result(self) -> list[tuple]:
        c = self.client
        first = c.io.read()
        if first[0] == 0xFF:
            c._raise_err(first)
        if first[0] == 0x00:
            return []
        n_cols, _ = P.get_lenenc_int(first, 0)
        col_types = []
        for _ in range(n_cols):
            cdef = c.io.read()
            _, ty = _col_name(cdef)
            col_types.append(ty)
        c._expect_eof()
        rows = []
        while True:
            pkt = c.io.read()
            if pkt[0] == 0xFE and len(pkt) < 9:
                break
            if pkt[0] == 0xFF:
                c._raise_err(pkt)
            rows.append(_decode_binary_row(pkt, col_types))
        return rows


# ------------------------------------------------------------------ #

def _col_name(cdef: bytes) -> tuple[str, int]:
    pos = 0
    for _ in range(4):                     # catalog, schema, table, org_table
        _, pos = P.get_lenenc_str(cdef, pos)
    name, pos = P.get_lenenc_str(cdef, pos)
    _, pos = P.get_lenenc_str(cdef, pos)   # org_name
    pos += 1 + 2 + 4                       # filler, charset, length
    ty = cdef[pos]
    return name.decode(), ty


def _decode_text_row(pkt: bytes, n_cols: int) -> tuple:
    out = []
    pos = 0
    for _ in range(n_cols):
        if pkt[pos] == 0xFB:
            out.append(None)
            pos += 1
        else:
            b, pos = P.get_lenenc_str(pkt, pos)
            out.append(b.decode())
    return tuple(out)


def _decode_binary_row(pkt: bytes, col_types: Sequence[int]) -> tuple:
    n = len(col_types)
    pos = 1
    nb_len = (n + 7 + 2) // 8
    null_bitmap = pkt[pos:pos + nb_len]
    pos += nb_len
    out: list[Any] = []
    for i, ty in enumerate(col_types):
        if null_bitmap[(i + 2) // 8] & (1 << ((i + 2) % 8)):
            out.append(None)
            continue
        if ty == P.MYSQL_TYPE_LONGLONG:
            out.append(struct.unpack_from("<q", pkt, pos)[0])
            pos += 8
        elif ty == P.MYSQL_TYPE_DOUBLE:
            out.append(struct.unpack_from("<d", pkt, pos)[0])
            pos += 8
        elif ty in (P.MYSQL_TYPE_DATE, P.MYSQL_TYPE_DATETIME):
            ln = pkt[pos]
            pos += 1
            if ln == 0:
                out.append("0000-00-00")
            else:
                y, m, d = struct.unpack_from("<HBB", pkt, pos)
                if ln >= 7:
                    hh, mm, ss = struct.unpack_from("<BBB", pkt, pos + 4)
                    out.append(
                        f"{y:04d}-{m:02d}-{d:02d} {hh:02d}:{mm:02d}:{ss:02d}")
                else:
                    out.append(f"{y:04d}-{m:02d}-{d:02d}")
            pos += ln
        else:
            b, pos = P.get_lenenc_str(pkt, pos)
            out.append(b.decode())
    return tuple(out)


__all__ = ["Client", "Prepared", "MySQLError"]
