# ported from tidb_tpu/store/placement.py @ 9d319cb
"""Shard/region topology: placement map with epochs, splits, and store
exclusion.

Reference analog: the unistore mock cluster + region cache
(/root/reference/pkg/store/mockstore/unistore/cluster.go — region
split/merge and store topology faked in one process;
pkg/store/copr/region_cache.go — shard->store routing invalidated on
region errors; coprocessor.go:337 buildCopTasks re-splits tasks after a
RegionError instead of re-running the identical dispatch).

TPU mapping: a "region" is a row-range shard of a columnar snapshot; a
"store" is a home slot that the mesh maps onto devices (store % n_dev).
The placement map says which store owns each shard; healing a failure
mutates the map (split the mis-routed shard, move shards off a dead
store) and bumps the epoch, which invalidates the snapshot's device cache
so the next dispatch re-fans-out under the new topology — the exact
region-cache-invalidation path, without per-task RPCs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .backoff import (REGION_MISS, STALE_EPOCH, STORE_UNAVAILABLE,
                      RegionError)


@dataclass
class Shard:
    shard_id: int
    lo: int            # row range [lo, hi)
    hi: int
    store: int

    @property
    def num_rows(self) -> int:
        return self.hi - self.lo


@dataclass
class Placement:
    """shard -> store map for one table snapshot (mock-PD analog)."""
    num_rows: int
    shards: list = field(default_factory=list)
    epoch: int = 0
    excluded: set = field(default_factory=set)
    _next_id: int = 0
    on_change: Optional[object] = None   # callback(placement) on exclusion

    @classmethod
    def even(cls, num_rows: int, n_shards: int) -> "Placement":
        n_shards = max(n_shards, 1)
        per = -(-num_rows // n_shards) if num_rows else 0
        p = cls(num_rows)
        for i in range(n_shards):
            lo = min(i * per, num_rows)
            hi = min(lo + per, num_rows)
            p.shards.append(Shard(i, lo, hi, store=i))
        p._next_id = n_shards
        return p

    # ---------------- topology queries ---------------- #

    def live_stores(self) -> list[int]:
        return [s for s in sorted({sh.store for sh in self.shards})
                if s not in self.excluded]

    def device_slots(self, n_dev: int) -> list[list[Shard]]:
        """Per-device shard lists under the store->device mod mapping."""
        slots: list[list[Shard]] = [[] for _ in range(n_dev)]
        for s in self.shards:
            slots[s.store % n_dev].append(s)
        return slots

    # ---------------- mutations (all bump the epoch) ---------------- #

    def split_shard(self, shard_id: int) -> None:
        """Split one shard at its midpoint (SPLIT TABLE / re-split-on-
        region-error analog, coprocessor.go:337)."""
        for i, s in enumerate(self.shards):
            if s.shard_id == shard_id:
                if s.num_rows < 2:
                    break
                mid = s.lo + s.num_rows // 2
                a = Shard(s.shard_id, s.lo, mid, s.store)
                b = Shard(self._next_id, mid, s.hi, s.store)
                self._next_id += 1
                self.shards[i:i + 1] = [a, b]
                break
        self.epoch += 1

    def exclude_store(self, store: int) -> None:
        """Move every shard off a failed store, round-robin over the
        remaining live stores (store-unavailable healing: re-placement,
        not identical re-dispatch)."""
        self.excluded.add(store)
        live = [st for st in sorted({s.store for s in self.shards})
                if st not in self.excluded]
        if not live:  # last store: re-home everything to virtual store 0
            live = [min(self.excluded) + len(self.excluded)]
        k = 0
        for s in self.shards:
            if s.store in self.excluded:
                s.store = live[k % len(live)]
                k += 1
        self.epoch += 1
        if self.on_change is not None:
            self.on_change(self)

    def rebalance(self, n_stores: int) -> None:
        """Spread shards evenly over n stores (scatter analog)."""
        live = [s for s in range(n_stores) if s not in self.excluded]
        for i, s in enumerate(self.shards):
            s.store = live[i % len(live)]
        self.epoch += 1

    def heal(self, err: Exception) -> bool:
        """Mutate the placement so the retry dispatches DIFFERENT work.

        Returns True when the topology changed.  Mirrors copr handleTask:
        store-unavailable -> exclude + re-place; region-miss/stale-epoch
        -> re-split the named shard (finer tasks) or just bump the epoch
        (drop cached routing)."""
        if not isinstance(err, RegionError):
            return False
        store = getattr(err, "store", None)
        shard = getattr(err, "shard", None)
        if err.kind is STORE_UNAVAILABLE and store is not None:
            self.exclude_store(store)
            return True
        if err.kind in (REGION_MISS, STALE_EPOCH):
            if shard is not None:
                self.split_shard(shard)    # also bumps epoch
            else:
                self.epoch += 1
            return True
        return False


__all__ = ["Placement", "Shard"]
