# ported from tidb_tpu/session/codec_io.py @ 3951242
"""Row-store IO helpers: encode/decode table rows through the KV engine.

Reference analog: pkg/table/tables AddRecord (encode at write,
tablecodec.go:111) and the cophandler's rowcodec.ChunkDecoder path (decode
straight into columns at read, cop_handler.go:496) — here decode happens
once per columnarization, not per query.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..store.codec import (decode_record_key, decode_row, encode_row,
                           record_key, record_prefix, record_prefix_end)
from ..types import dtypes as dt


def encode_table_row(table_id: int, handle: int, values, types) -> tuple[bytes, bytes]:
    return record_key(table_id, handle), encode_row(values, types)


def scan_table_rows(kv, table_id: int, ts: int,
                    types: Sequence[dt.DataType]) -> tuple[np.ndarray, list]:
    """Full-table snapshot scan -> (handles, python-value rows)."""
    handles = []
    rows = []
    for k, v in kv.scan(record_prefix(table_id), record_prefix_end(table_id), ts):
        _, h = decode_record_key(k)
        handles.append(h)
        rows.append(decode_row(v, types))
    return np.asarray(handles, dtype=np.int64), rows


__all__ = ["encode_table_row", "scan_table_rows"]
