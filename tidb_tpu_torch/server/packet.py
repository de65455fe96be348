# ported from tidb_tpu/server/packet.py @ 6233200
"""MySQL client/server protocol packet codec.

Reference analog: pkg/server packet IO + resultset writers
(server/conn.go writePacket/readPacket, column.go dumpColumnInfo,
util.go dumpTextRow/dumpBinaryRow).  Implements the v4.1 protocol:
lenenc primitives, handshake v10, OK/ERR/EOF, column definitions, and
text + binary row encodings, independent of any socket so it is testable
in isolation and reusable by the test client.
"""

from __future__ import annotations

import datetime as pydt
import decimal as pydec
import struct
from typing import Any, Optional, Sequence

from ..types import dtypes as dt
from ..utils.auth import (check_scramble, check_sha2_scramble,
                          native_password_hash, scramble_password,
                          sha2_cache_digest, sha2_scramble)

K = dt.TypeKind

# capability flags (include/mysql capability bits)
CLIENT_LONG_PASSWORD = 1 << 0
CLIENT_FOUND_ROWS = 1 << 1
CLIENT_LONG_FLAG = 1 << 2
CLIENT_CONNECT_WITH_DB = 1 << 3
CLIENT_SSL = 1 << 11
CLIENT_PROTOCOL_41 = 1 << 9
CLIENT_TRANSACTIONS = 1 << 13
CLIENT_SECURE_CONNECTION = 1 << 15
CLIENT_MULTI_STATEMENTS = 1 << 16
CLIENT_MULTI_RESULTS = 1 << 17
CLIENT_PLUGIN_AUTH = 1 << 19
CLIENT_PLUGIN_AUTH_LENENC_CLIENT_DATA = 1 << 21
CLIENT_DEPRECATE_EOF = 1 << 24

# CLIENT_MULTI_STATEMENTS/MULTI_RESULTS deliberately absent: the dispatch
# loop returns one resultset per COM_QUERY (no SERVER_MORE_RESULTS_EXISTS)
SERVER_CAPABILITIES = (
    CLIENT_LONG_PASSWORD | CLIENT_LONG_FLAG | CLIENT_CONNECT_WITH_DB
    | CLIENT_PROTOCOL_41 | CLIENT_TRANSACTIONS | CLIENT_SECURE_CONNECTION
    | CLIENT_PLUGIN_AUTH)

# server status bits
SERVER_STATUS_AUTOCOMMIT = 0x0002
SERVER_STATUS_IN_TRANS = 0x0001
SERVER_STATUS_CURSOR_EXISTS = 0x0040
SERVER_STATUS_LAST_ROW_SENT = 0x0080

# commands
COM_QUIT = 0x01
COM_INIT_DB = 0x02
COM_QUERY = 0x03
COM_FIELD_LIST = 0x04
COM_PING = 0x0E
COM_STMT_PREPARE = 0x16
COM_STMT_EXECUTE = 0x17
COM_STMT_CLOSE = 0x19
COM_STMT_RESET = 0x1A
COM_STMT_FETCH = 0x1C

# COM_STMT_EXECUTE cursor flags (conn_stmt.go / cursor protocol)
CURSOR_TYPE_READ_ONLY = 0x01

# column types (include/field_types.h)
MYSQL_TYPE_DOUBLE = 0x05
MYSQL_TYPE_NULL = 0x06
MYSQL_TYPE_LONGLONG = 0x08
MYSQL_TYPE_DATE = 0x0A
MYSQL_TYPE_TIME = 0x0B
MYSQL_TYPE_DATETIME = 0x0C
MYSQL_TYPE_NEWDECIMAL = 0xF6
MYSQL_TYPE_VAR_STRING = 0xFD

UNSIGNED_FLAG = 0x20
BINARY_FLAG = 0x80
NOT_NULL_FLAG = 0x01


# ------------------------------------------------------------------ #
# lenenc primitives
# ------------------------------------------------------------------ #

def put_lenenc_int(n: int) -> bytes:
    if n < 0xFB:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def put_lenenc_str(b: bytes) -> bytes:
    return put_lenenc_int(len(b)) + b


def get_lenenc_int(buf: bytes, pos: int) -> tuple[int, int]:
    first = buf[pos]
    if first < 0xFB:
        return first, pos + 1
    if first == 0xFC:
        return struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
    if first == 0xFD:
        return int.from_bytes(buf[pos + 1:pos + 4], "little"), pos + 4
    return struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9


def get_lenenc_str(buf: bytes, pos: int) -> tuple[bytes, int]:
    n, pos = get_lenenc_int(buf, pos)
    return buf[pos:pos + n], pos + n


# auth primitives live in utils/auth.py (shared with the privilege
# manager); re-exported here for wire-layer callers.

# ------------------------------------------------------------------ #
# server packets
# ------------------------------------------------------------------ #

def handshake_v10(conn_id: int, salt: bytes, server_version: str,
                  capabilities: int = SERVER_CAPABILITIES,
                  plugin: str = "mysql_native_password") -> bytes:
    assert len(salt) == 20
    p = bytearray()
    p += b"\x0a" + server_version.encode() + b"\x00"
    p += struct.pack("<I", conn_id)
    p += salt[:8] + b"\x00"
    p += struct.pack("<H", capabilities & 0xFFFF)
    p += bytes([33])  # utf8_general_ci
    p += struct.pack("<H", SERVER_STATUS_AUTOCOMMIT)
    p += struct.pack("<H", capabilities >> 16)
    p += bytes([21])  # auth data length (20 + NUL)
    p += b"\x00" * 10
    p += salt[8:20] + b"\x00"
    p += plugin.encode() + b"\x00"
    return bytes(p)


def auth_switch_request(plugin: str, salt: bytes) -> bytes:
    """AuthSwitchRequest (conn.go writeAuthSwitchRequest analog)."""
    return b"\xfe" + plugin.encode() + b"\x00" + salt + b"\x00"


def auth_more_data(payload: bytes) -> bytes:
    """AuthMoreData frame (0x01-prefixed; caching_sha2 fast/full
    markers ride here: 0x03 = fast-auth success, 0x04 = perform full
    authentication)."""
    return b"\x01" + payload


SHA2_FAST_AUTH_OK = b"\x03"
SHA2_FULL_AUTH = b"\x04"


def parse_handshake_response(payload: bytes) -> dict:
    caps = struct.unpack_from("<I", payload, 0)[0]
    pos = 4 + 4 + 1 + 23  # caps, max packet, charset, reserved
    end = payload.index(0, pos)
    user = payload[pos:end].decode()
    pos = end + 1
    if caps & CLIENT_PLUGIN_AUTH_LENENC_CLIENT_DATA:
        auth, pos = get_lenenc_str(payload, pos)
    else:
        n = payload[pos]
        auth = payload[pos + 1:pos + 1 + n]
        pos += 1 + n
    db = ""
    if caps & CLIENT_CONNECT_WITH_DB and pos < len(payload):
        end = payload.index(0, pos)
        db = payload[pos:end].decode()
        pos = end + 1
    plugin = ""
    if caps & CLIENT_PLUGIN_AUTH and pos < len(payload):
        end = payload.find(0, pos)
        plugin = payload[pos:end if end >= 0 else len(payload)].decode()
    return {"capabilities": caps, "user": user, "auth": auth, "db": db,
            "plugin": plugin}


def ok_packet(affected: int = 0, last_insert_id: int = 0,
              status: int = SERVER_STATUS_AUTOCOMMIT,
              warnings: int = 0) -> bytes:
    return (b"\x00" + put_lenenc_int(affected) + put_lenenc_int(last_insert_id)
            + struct.pack("<HH", status, warnings))


def err_packet(errno: int, msg: str, sqlstate: str = "HY000") -> bytes:
    return (b"\xff" + struct.pack("<H", errno) + b"#" + sqlstate.encode()
            + msg.encode())


def eof_packet(status: int = SERVER_STATUS_AUTOCOMMIT,
               warnings: int = 0) -> bytes:
    return b"\xfe" + struct.pack("<HH", warnings, status)


def _mysql_type(t: Optional[dt.DataType]) -> tuple[int, int, int]:
    """(wire type, flags, decimals) for a column dtype."""
    if t is None:
        return MYSQL_TYPE_VAR_STRING, 0, 0
    flags = 0 if t.nullable else NOT_NULL_FLAG
    k = t.kind
    if k == K.INT64:
        return MYSQL_TYPE_LONGLONG, flags, 0
    if k == K.UINT64:
        return MYSQL_TYPE_LONGLONG, flags | UNSIGNED_FLAG, 0
    if k in (K.FLOAT64, K.FLOAT32):
        return MYSQL_TYPE_DOUBLE, flags, 31
    if k == K.DECIMAL:
        return MYSQL_TYPE_NEWDECIMAL, flags, max(t.scale, 0)
    if k == K.DATE:
        return MYSQL_TYPE_DATE, flags | BINARY_FLAG, 0
    if k == K.DATETIME:
        return MYSQL_TYPE_DATETIME, flags | BINARY_FLAG, 0
    if k == K.TIME:
        return MYSQL_TYPE_TIME, flags | BINARY_FLAG, 0
    return MYSQL_TYPE_VAR_STRING, flags, 0


def column_def(name: str, t: Optional[dt.DataType], db: str = "",
               table: str = "") -> bytes:
    wire, flags, decimals = _mysql_type(t)
    p = bytearray()
    p += put_lenenc_str(b"def")
    p += put_lenenc_str(db.encode())
    p += put_lenenc_str(table.encode())
    p += put_lenenc_str(table.encode())
    p += put_lenenc_str(name.encode())
    p += put_lenenc_str(name.encode())
    p += b"\x0c"
    p += struct.pack("<H", 33)         # charset utf8
    p += struct.pack("<I", 255)        # display length
    p += bytes([wire])
    p += struct.pack("<H", flags)
    p += bytes([decimals])
    p += b"\x00\x00"
    return bytes(p)


# ------------------------------------------------------------------ #
# row encodings
# ------------------------------------------------------------------ #

def _text_value(v: Any) -> bytes:
    if isinstance(v, bool):
        return b"1" if v else b"0"
    if isinstance(v, float):
        return repr(v).encode()
    if isinstance(v, (int, pydec.Decimal)):
        return str(v).encode()
    if isinstance(v, pydt.date):
        return v.isoformat().encode()
    if isinstance(v, bytes):
        return v
    return str(v).encode()


def text_row(row: Sequence[Any]) -> bytes:
    out = bytearray()
    for v in row:
        if v is None:
            out += b"\xfb"
        else:
            out += put_lenenc_str(_text_value(v))
    return bytes(out)


def _binary_datetime(v: Any) -> bytes:
    s = str(v)
    date_part, _, time_part = s.partition(" ")
    y, m, d = (int(x) for x in date_part.split("-"))
    if not time_part:
        return bytes([4]) + struct.pack("<HBB", y, m, d)
    hh, mm, ss = time_part.split(":")
    sec, _, frac = ss.partition(".")
    if frac:
        micro = int(frac.ljust(6, "0")[:6])
        return bytes([11]) + struct.pack("<HBBBBBI", y, m, d, int(hh),
                                         int(mm), int(sec), micro)
    return bytes([7]) + struct.pack("<HBBBBB", y, m, d, int(hh), int(mm),
                                    int(sec))


def binary_row(row: Sequence[Any], dtypes: Sequence[Optional[dt.DataType]]) -> bytes:
    n = len(row)
    null_bitmap = bytearray((n + 7 + 2) // 8)
    vals = bytearray()
    for i, v in enumerate(row):
        if v is None:
            null_bitmap[(i + 2) // 8] |= 1 << ((i + 2) % 8)
            continue
        t = dtypes[i] if i < len(dtypes) else None
        k = t.kind if t is not None else None
        if k in (K.INT64, K.UINT64) or (k is None and isinstance(v, int)):
            vals += struct.pack("<q", int(v))
        elif k in (K.FLOAT64, K.FLOAT32) or (k is None and isinstance(v, float)):
            vals += struct.pack("<d", float(v))
        elif k in (K.DATE, K.DATETIME):
            vals += _binary_datetime(v)
        else:  # NEWDECIMAL / VAR_STRING / TIME travel as lenenc strings
            vals += put_lenenc_str(_text_value(v))
    return b"\x00" + bytes(null_bitmap) + bytes(vals)


def parse_binary_params(payload: bytes, pos: int, n_params: int,
                        prev_types: Optional[list] = None
                        ) -> tuple[list, Optional[list]]:
    """Decode COM_STMT_EXECUTE parameter values -> python values."""
    if n_params == 0:
        return [], prev_types
    nb_len = (n_params + 7) // 8
    null_bitmap = payload[pos:pos + nb_len]
    pos += nb_len
    new_bound = payload[pos]
    pos += 1
    if new_bound:
        types = [(payload[pos + 2 * i], payload[pos + 2 * i + 1])
                 for i in range(n_params)]
        pos += 2 * n_params
    else:
        types = prev_types
        if types is None:
            raise ValueError("no parameter types bound")
    out: list[Any] = []
    for i, (ty, flag) in enumerate(types):
        if null_bitmap[i // 8] & (1 << (i % 8)):
            out.append(None)
            continue
        if ty == MYSQL_TYPE_LONGLONG:
            out.append(struct.unpack_from("<q" if not flag & UNSIGNED_FLAG
                                          else "<Q", payload, pos)[0])
            pos += 8
        elif ty == 0x03:  # LONG
            out.append(struct.unpack_from("<i", payload, pos)[0])
            pos += 4
        elif ty == 0x02:  # SHORT
            out.append(struct.unpack_from("<h", payload, pos)[0])
            pos += 2
        elif ty == 0x01:  # TINY
            out.append(struct.unpack_from("<b", payload, pos)[0])
            pos += 1
        elif ty == MYSQL_TYPE_DOUBLE:
            out.append(struct.unpack_from("<d", payload, pos)[0])
            pos += 8
        elif ty == 0x04:  # FLOAT
            out.append(struct.unpack_from("<f", payload, pos)[0])
            pos += 4
        elif ty in (MYSQL_TYPE_DATE, MYSQL_TYPE_DATETIME, 0x07):
            ln = payload[pos]
            pos += 1
            if ln == 0:
                out.append("0000-00-00")
            else:
                y, m, d = struct.unpack_from("<HBB", payload, pos)
                if ln >= 7:
                    hh, mm, ss = struct.unpack_from("<BBB", payload, pos + 4)
                    out.append(f"{y:04d}-{m:02d}-{d:02d} {hh:02d}:{mm:02d}:{ss:02d}")
                else:
                    out.append(f"{y:04d}-{m:02d}-{d:02d}")
            pos += ln
        else:  # strings, decimals, blobs: lenenc
            b, pos = get_lenenc_str(payload, pos)
            out.append(b.decode())
    return out, types


__all__ = [name for name in dir() if not name.startswith("_")]
