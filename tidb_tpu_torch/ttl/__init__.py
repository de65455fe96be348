# ported from tidb_tpu/ttl/__init__.py @ 9be2bf6
"""Row TTL: scan-and-delete of expired rows, driven by the timer
framework.

Reference analog: pkg/ttl (18.2k LoC — ttlworker scan/delete task
pipeline over TTL tables, scheduled by pkg/timer).  A table declares
`TTL = col + INTERVAL n unit` at CREATE TABLE; the sweep deletes rows
whose TTL column is older than now - interval, in bounded batches so a
huge expired backlog cannot monopolize the store.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..types import dtypes as dt

BATCH_ROWS = 4096     # delete batch bound (ttlworker scan task size)


def ttl_cutoff_value(col_type, interval_sec: int,
                     now: Optional[float] = None):
    """Encoded threshold for the TTL column: rows with value < cutoff are
    expired."""
    now = time.time() if now is None else now
    cutoff = now - interval_sec
    if col_type.kind == dt.TypeKind.DATE:
        return int(cutoff // 86400)                   # days since epoch
    if col_type.kind == dt.TypeKind.DATETIME:
        return int(cutoff * 1_000_000)                # micros since epoch
    raise ValueError("TTL column must be DATE or DATETIME")


def sweep_table(tbl, now: Optional[float] = None) -> int:
    """Delete expired rows of one TTL table; returns rows deleted."""
    if not tbl.ttl_col or not tbl.ttl_enable:
        return 0
    ci = tbl.col_names.index(tbl.ttl_col)
    cutoff = ttl_cutoff_value(tbl.col_types[ci], tbl.ttl_interval_sec, now)
    deleted = 0
    while True:
        snap = tbl.snapshot()
        col = snap.columns[ci]
        expired = col.validity & (col.data < cutoff)
        idx = np.nonzero(expired)[0]
        if len(idx) == 0:
            return deleted
        batch = idx[:BATCH_ROWS]
        keep = np.ones(snap.num_rows, bool)
        keep[batch] = False
        deleted += tbl.delete_where(keep)
        if len(idx) <= BATCH_ROWS:
            return deleted


def run_ttl_sweep(domain, now: Optional[float] = None) -> dict:
    """One TTL job run over every TTL table (ttlworker JobManager run)."""
    out = {}
    for db, tables in list(domain.catalog.databases.items()):
        for name, tbl in list(tables.items()):
            if getattr(tbl, "ttl_col", None) and tbl.kv is not None:
                n = sweep_table(tbl, now)
                if n:
                    out[f"{db}.{name}"] = n
    return out


__all__ = ["sweep_table", "run_ttl_sweep", "ttl_cutoff_value"]
