# ported from tidb_tpu/session/autoid.py @ 3951242
"""Centralized AUTO_INCREMENT allocation service.

Reference analog: pkg/autoid_service/autoid.go — the AUTO_ID_CACHE=1
centralized allocator: one leader-elected service owns the counter per
table, persisted through the meta KV; clients fetch id RANGES and
consume them locally, so per-row allocation never crosses the service
(and a restart resumes past the last persisted range end — MySQL's
id-jump semantics, never a reuse).

Single-process deployment: the service runs in the Domain (the "owner"
node, consistent with the lease-based owner election the DDL uses); the
KV persistence makes ranges durable under data_dir domains.
"""

from __future__ import annotations

import struct
import threading
from typing import Optional, Tuple

DEFAULT_BATCH = 4000          # ids per client range (AUTO_ID_CACHE)

_KEY_PREFIX = b"m_autoid_"


def _key(table_id: int) -> bytes:
    return _KEY_PREFIX + str(int(table_id)).encode()


class AutoIDService:
    """Per-cluster allocator: alloc_range / bump over persisted counters."""

    def __init__(self, kv):
        self.kv = kv
        self._mu = threading.Lock()
        self._cache: dict[int, int] = {}       # table_id -> persisted max

    def _load(self, table_id: int) -> int:
        if table_id in self._cache:
            return self._cache[table_id]
        cur = 0
        if self.kv is not None:
            raw = self.kv.get(_key(table_id), self.kv.alloc_ts())
            if raw:
                cur = struct.unpack("<q", raw)[0]
        self._cache[table_id] = cur
        return cur

    def _store(self, table_id: int, val: int) -> None:
        self._cache[table_id] = val
        if self.kv is not None:
            t = self.kv.begin()
            t.put(_key(table_id), struct.pack("<q", val))
            t.commit()

    def alloc_range(self, table_id: int, n: int = DEFAULT_BATCH,
                    at_least: int = 0) -> Tuple[int, int]:
        """Reserve (start, end]: ids start+1 .. end inclusive.  at_least
        skips past explicitly-inserted values the client observed."""
        with self._mu:
            base = max(self._load(table_id), int(at_least))
            end = base + max(int(n), 1)
            self._store(table_id, end)
            return base, end

    def bump(self, table_id: int, val: int) -> None:
        """Raise the persisted counter past an explicit value (INSERT with
        a literal id beyond the current range)."""
        with self._mu:
            if int(val) > self._load(table_id):
                self._store(table_id, int(val))

    def current(self, table_id: int) -> int:
        with self._mu:
            return self._load(table_id)


__all__ = ["AutoIDService", "DEFAULT_BATCH"]
