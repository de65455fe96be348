# ported from tidb_tpu/planner/plan_cache.py @ 6233200
"""Instance plan cache.

Reference analog: pkg/planner/core/plan_cache.go + plan_cache_lru.go —
prepared & non-prepared plan cache keyed on statement + schema/stats
state.  Here the key is (sql text, db, per-table schema fingerprints,
plan-relevant sysvars); a table's fingerprint covers its column schema,
index set, and snapshot epoch, so any write or DDL on a referenced table
invalidates naturally (the reference instead checks schema version +
stats version at load time, plan_cache.go:49-61).

Caching the *physical plan object* is sound because executors re-resolve
table snapshots at Open/execute time — the tree holds no row data.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Optional

# sysvars that change planning decisions -> part of the key
_PLAN_SYSVARS = ("tidb_enable_vectorized_expression",
                 "tidb_opt_agg_push_down", "tidb_isolation_read_engines",
                 "tidb_enable_cascades_planner",
                 "tidb_opt_skew_distinct_agg")


class PlanCacheEntry:
    __slots__ = ("built", "phys", "table_keys")

    def __init__(self, built, phys, table_keys):
        self.built = built
        self.phys = phys
        self.table_keys = table_keys


def table_fingerprint(tbl) -> tuple:
    """Schema + data-epoch fingerprint of one referenced table."""
    return (tbl.table_id, tuple(tbl.col_names),
            tuple(str(t) for t in tbl.col_types),
            tuple((ix.name, tuple(ix.columns), ix.unique, ix.state)
                  for ix in tbl.indexes),
            tbl._epoch)


class PlanCache:
    """LRU over plan entries (plan_cache_lru.go LRUPlanCache analog)."""

    def __init__(self, capacity: int = 128):
        self.capacity = capacity
        self._lru: OrderedDict[tuple, PlanCacheEntry] = OrderedDict()
        self._mu = threading.Lock()   # one thread per server connection
        self.hits = 0
        self.misses = 0

    def _key(self, sql: str, db: str, sysvars: dict) -> tuple:
        return (sql, db, tuple(str(sysvars.get(k, "")) for k in _PLAN_SYSVARS))

    def get(self, sql: str, db: str, sysvars: dict,
            catalog) -> Optional[PlanCacheEntry]:
        key = self._key(sql, db, sysvars)
        with self._mu:
            e = self._lru.get(key)
            if e is None:
                self.misses += 1
                return None
        # validate table fingerprints outside the lock (catalog lookups)
        stale = False
        for (tdb, tname), fp in e.table_keys.items():
            try:
                tbl = catalog.get_table(tdb, tname)
            except Exception:
                tbl = None
            if tbl is None or table_fingerprint(tbl) != fp:
                stale = True
                break
        with self._mu:
            if stale:
                self._lru.pop(key, None)
                self.misses += 1
                return None
            if key in self._lru:
                self._lru.move_to_end(key)
            self.hits += 1
            return e

    def put(self, sql: str, db: str, sysvars: dict, entry: PlanCacheEntry):
        key = self._key(sql, db, sysvars)
        with self._mu:
            self._lru[key] = entry
            self._lru.move_to_end(key)
            while len(self._lru) > self.capacity:
                self._lru.popitem(last=False)


__all__ = ["PlanCache", "PlanCacheEntry", "table_fingerprint"]
