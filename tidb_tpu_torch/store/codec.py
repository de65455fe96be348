# ported from tidb_tpu/store/codec.py @ 3951242
"""Key and row codecs — the storage contract.

Reference analog (SURVEY.md §A.2):
- record key layout t{tableID}_r{handle} with memcomparable encodings
  (pkg/tablecodec/tablecodec.go:50-103, pkg/util/codec: ints with sign-bit
  flip big-endian so byte order == numeric order)
- row value: versioned compact binary (rowcodec v2 analog,
  pkg/util/rowcodec: ver byte + null bitmap + per-column payloads), decoded
  straight into columns at columnarization time (decode once per snapshot,
  not per query).
"""

from __future__ import annotations

import struct
from typing import Any, Optional, Sequence

import numpy as np

from ..types import dtypes as dt
from ..types import decimal as dec
from ..types import temporal as tmp

K = dt.TypeKind

SIGN_FLIP = 1 << 63


# ---------------- memcomparable keys ---------------- #

def encode_int_key(v: int) -> bytes:
    """int64 -> 8 bytes, big-endian with sign bit flipped (byte order ==
    numeric order; util/codec EncodeIntToCmpUint analog)."""
    return struct.pack(">Q", (v + (1 << 63)) & 0xFFFFFFFFFFFFFFFF)


def decode_int_key(b: bytes) -> int:
    return struct.unpack(">Q", b)[0] - (1 << 63)


def record_key(table_id: int, handle: int) -> bytes:
    return b"t" + encode_int_key(table_id) + b"_r" + encode_int_key(handle)


def record_prefix(table_id: int) -> bytes:
    return b"t" + encode_int_key(table_id) + b"_r"


def record_prefix_end(table_id: int) -> bytes:
    return b"t" + encode_int_key(table_id) + b"_s"  # '_r' + 1


def decode_record_key(key: bytes) -> tuple[int, int]:
    assert key[:1] == b"t" and key[9:11] == b"_r", key
    return decode_int_key(key[1:9]), decode_int_key(key[11:19])


def index_key(table_id: int, index_id: int, *parts: bytes) -> bytes:
    out = b"t" + encode_int_key(table_id) + b"_i" + encode_int_key(index_id)
    for p in parts:
        out += p
    return out


def index_prefix(table_id: int, index_id: Optional[int] = None) -> bytes:
    p = b"t" + encode_int_key(table_id) + b"_i"
    if index_id is not None:
        p += encode_int_key(index_id)
    return p


def index_prefix_end(table_id: int, index_id: Optional[int] = None) -> bytes:
    if index_id is None:
        return b"t" + encode_int_key(table_id) + b"_j"  # '_i' + 1
    return index_prefix(table_id, index_id + 1)


# ---------------- memcomparable index values ---------------- #
#
# Reference: pkg/util/codec — ints big-endian with sign flip, floats with
# sign-bit manipulation, bytes in 8-byte groups with pad-count markers so
# byte order == value order; NULLs get a 0x00 flag (sort first), non-NULL
# values a 0x01 flag (tablecodec index key layout).

def encode_bytes_key(b: bytes) -> bytes:
    """Order-preserving var-length bytes: 8-byte groups padded with \\x00,
    each followed by a marker 0xF7 + count of real bytes in the group
    (util/codec EncodeBytes analog)."""
    out = bytearray()
    for i in range(0, len(b) + 1, 8):
        group = b[i:i + 8]
        out += group + b"\x00" * (8 - len(group))
        out.append(0xF7 + len(group))
        if len(group) < 8:
            break
    return bytes(out)


def encode_float_key(v: float) -> bytes:
    bits = struct.unpack(">Q", struct.pack(">d", float(v)))[0]
    if bits & SIGN_FLIP:
        bits ^= 0xFFFFFFFFFFFFFFFF    # negative: flip all
    else:
        bits |= SIGN_FLIP             # positive: flip sign bit
    return struct.pack(">Q", bits)


def encode_index_value(v: Any, t: dt.DataType) -> bytes:
    """One python-level column value -> memcomparable bytes incl. the NULL
    flag byte."""
    if v is None:
        return b"\x00"
    k = t.kind
    if k in (K.INT64, K.UINT64):
        return b"\x01" + encode_int_key(int(v))
    if k in (K.FLOAT64, K.FLOAT32):
        return b"\x01" + encode_float_key(float(v))
    if k == K.DECIMAL:
        scaled = v if isinstance(v, int) else dec.encode(v, t.scale)
        return b"\x01" + encode_int_key(scaled)
    if k == K.DATE:
        d = v if isinstance(v, int) else tmp.parse_date(str(v))
        return b"\x01" + encode_int_key(d)
    if k == K.DATETIME:
        d = v if isinstance(v, int) else tmp.parse_datetime(str(v))
        return b"\x01" + encode_int_key(d)
    if k == K.STRING:
        return b"\x01" + encode_bytes_key(str(v).encode())
    if k in (K.TIME, K.ENUM, K.SET):
        return b"\x01" + encode_int_key(int(v))
    if k == K.BIT:
        # uint64 memcomparable via sign-flip (BIT(64) values >= 2^63)
        return b"\x01" + encode_int_key(int(v) - (1 << 63))
    raise ValueError(f"cannot index {t}")


def encode_index_entry(table_id: int, index_id: int, values: Sequence[Any],
                       types: Sequence[dt.DataType], handle: int,
                       unique: bool) -> tuple[bytes, bytes]:
    """Index KV pair.  Unique: key = prefix+values, value = handle.
    Non-unique: key = prefix+values+handle, value = empty (the reference's
    tablecodec layout, SURVEY.md §A.2)."""
    parts = [encode_index_value(v, t) for v, t in zip(values, types)]
    has_null = any(v is None for v in values)
    if unique and not has_null:
        return (index_key(table_id, index_id, *parts),
                struct.pack(">q", handle))
    # NULL-containing unique entries degrade to non-unique form (MySQL
    # allows many NULLs in a unique index)
    parts.append(encode_int_key(handle))
    return index_key(table_id, index_id, *parts), b""


def decode_index_handle(key: bytes, value: bytes) -> int:
    """Handle from an index entry (tail of key, or the value for unique)."""
    if value:
        return struct.unpack(">q", value)[0]
    return decode_int_key(key[-8:])


# ---------------- row values ---------------- #

ROW_VERSION = 1
_NULL = 0xFF


def encode_row(values: Sequence[Any], types: Sequence[dt.DataType]) -> bytes:
    """values are python-level (str/int/Decimal-string/None)."""
    out = bytearray([ROW_VERSION])
    out += struct.pack("<H", len(values))
    for v, t in zip(values, types):
        if v is None:
            out.append(_NULL)
            continue
        k = t.kind
        if k in (K.INT64, K.UINT64):
            out.append(0)
            out += struct.pack("<q" if k == K.INT64 else "<Q", int(v))
        elif k in (K.FLOAT64, K.FLOAT32):
            out.append(1)
            out += struct.pack("<d", float(v))
        elif k == K.DECIMAL:
            scaled = dec.encode(v, t.scale)
            if t.is_wide_decimal:
                # 19-65 digit decimals: length-prefixed little-endian
                # signed magnitude (mydecimal.go's var-width analog)
                nb = (scaled.bit_length() + 8) // 8 or 1
                out.append(8)
                out += struct.pack("<B", nb)
                out += scaled.to_bytes(nb, "little", signed=True)
            else:
                out.append(2)
                out += struct.pack("<q", scaled)
        elif k == K.STRING:
            b = str(v).encode()
            out.append(3)
            out += struct.pack("<I", len(b)) + b
        elif k == K.DATE:
            out.append(4)
            out += struct.pack("<i", v if isinstance(v, int)
                               else tmp.parse_date(str(v)))
        elif k == K.DATETIME:
            out.append(5)
            out += struct.pack("<q", v if isinstance(v, int)
                               else tmp.parse_datetime(str(v)))
        elif k in (K.TIME, K.ENUM, K.SET):
            out.append(6)
            out += struct.pack("<q", int(v))
        elif k == K.BIT:
            out.append(7)
            out += struct.pack("<Q", int(v))
        elif k == K.VECTOR:
            # [u16 dim][f32 x dim] (types VectorFloat32 serialization)
            arr = (dt.parse_vector_text(v, t.prec) if isinstance(v, str)
                   else np.asarray(v, dtype=np.float32))
            out.append(9)
            out += struct.pack("<H", len(arr))
            out += arr.tobytes()
        else:
            raise ValueError(f"cannot encode {t}")
    return bytes(out)


def decode_row(data: bytes, types: Sequence[dt.DataType]) -> list[Any]:
    """Decode to python-level values (Decimal as string, DATE as iso str)."""
    assert data[0] == ROW_VERSION
    (n,) = struct.unpack_from("<H", data, 1)
    off = 3
    out: list[Any] = []
    for i in range(n):
        tag = data[off]
        off += 1
        if tag == _NULL:
            out.append(None)
            continue
        t = types[i]
        if tag == 0:
            fmt = "<q" if t.kind == K.INT64 else "<Q"
            (v,) = struct.unpack_from(fmt, data, off)
            off += 8
            out.append(int(v))
        elif tag == 1:
            (v,) = struct.unpack_from("<d", data, off)
            off += 8
            out.append(float(v))
        elif tag == 2:
            (v,) = struct.unpack_from("<q", data, off)
            off += 8
            out.append(dec.to_string(v, t.scale))
        elif tag == 8:
            nb = data[off]
            off += 1
            v = int.from_bytes(data[off:off + nb], "little", signed=True)
            off += nb
            out.append(dec.to_string(v, t.scale))
        elif tag == 3:
            (ln,) = struct.unpack_from("<I", data, off)
            off += 4
            out.append(data[off:off + ln].decode())
            off += ln
        elif tag == 4:
            (v,) = struct.unpack_from("<i", data, off)
            off += 4
            out.append(tmp.date_to_string(v))
        elif tag == 5:
            (v,) = struct.unpack_from("<q", data, off)
            off += 8
            out.append(tmp.datetime_to_string(v))
        elif tag == 6:
            (v,) = struct.unpack_from("<q", data, off)
            off += 8
            out.append(int(v))
        elif tag == 7:
            (v,) = struct.unpack_from("<Q", data, off)
            off += 8
            out.append(int(v))
        elif tag == 9:
            (dim,) = struct.unpack_from("<H", data, off)
            off += 2
            out.append(np.frombuffer(data, np.float32, dim, off).copy())
            off += 4 * dim
        else:
            raise ValueError(f"bad tag {tag}")
    return out


__all__ = [
    "encode_int_key", "decode_int_key", "record_key", "record_prefix",
    "record_prefix_end", "decode_record_key", "index_key", "index_prefix",
    "index_prefix_end", "encode_bytes_key", "encode_float_key",
    "encode_index_value", "encode_index_entry", "decode_index_handle",
    "encode_row", "decode_row", "ROW_VERSION",
]
