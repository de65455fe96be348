# ported from tidb_tpu/pd/coordinator.py @ 9be2bf6
"""coplace: the per-Domain coordination loop.

Reference analog: the PD client embedded in every tidb-server —
owns the lease heartbeat and fans state both ways on a tick.  The
tick is STATEMENT-DRIVEN (session/_exec_ctx calls ``tick()`` on the
hot path), internally throttled, and deterministic: no background
thread, nothing to leak on Domain close, and tests force a tick
instead of sleeping.

One tick, when due:

1. ``pd.renew`` span — grant/renew the lease (pd/lease).  A failure
   here flips DEGRADED: quota falls to local slices
   (pd/quota.degrade_to_local_slice), caches go local-only, the
   ``tidb_tpu_pd_degraded_total`` counter bumps, the active trace is
   flagged ``pd_degraded`` — and the statement proceeds normally.
2. ``pd.sync`` span — quota rebalance (debt-weighted shares),
   calibration merge (observation-count-weighted EWMA through the
   ``calib`` key), registry gossip (publish persisted entries, adopt
   a bounded number of peer entries, apply quarantine tombstones).
   A rejoin after degradation forces this full resync immediately.
"""

from __future__ import annotations

import threading
import time

from .lease import PdMember
from .quota import QuotaPool
from .registry import ProgramRegistry
from .store import (PD_CALIB_TTL_S, PD_LEASE_TTL_S, PdError, PdStore)

# min seconds between sync rounds (renewal is additionally throttled
# to ~TTL/3 inside pd/lease); tests pass force=True instead of waiting
PD_SYNC_S = 0.5

CALIB_KEY = "calib"

# hard bound on the shared calibration document (the store holds the
# hot corpus, not an unbounded history); lowest-sample digests drop
CALIB_SHARED_CAP = 512


def _pd_metrics() -> dict:
    from ..utils.metrics import global_registry
    reg = global_registry()
    return {
        "renew": reg.counter("tidb_tpu_pd_renew_total",
                             "pd lease grants + renewals"),
        "sync": reg.counter("tidb_tpu_pd_sync_total",
                            "pd sync rounds completed"),
        "degraded": reg.counter("tidb_tpu_pd_degraded_total",
                                "transitions into degraded-local "
                                "operation (store loss / lease fence)"),
        "members": reg.gauge("tidb_tpu_pd_members",
                             "live members on the coordination store"),
        "share": reg.gauge("tidb_tpu_pd_quota_share_ru",
                           "leased RU/s refill share per resource "
                           "group", labels=("group",)),
        "peer_warm": reg.counter("tidb_tpu_pd_peer_warm_total",
                                 "compile-cache entries adopted from "
                                 "peers' registry publications"),
        "calib": reg.counter("tidb_tpu_pd_calib_merged_total",
                             "correction payloads merged from the "
                             "shared store"),
        "quarantine": reg.counter(
            "tidb_tpu_pd_quarantine_purged_total",
            "peer quarantine tombstones applied locally"),
    }


class PdCoordinator:
    """One Domain's membership: lease + quota + registry + calibration
    sync over one PdStore."""

    def __init__(self, store: PdStore, manager, member_id: str = "",
                 ttl_s: float = PD_LEASE_TTL_S, pd_dir: str = "",
                 calib=None, cache=None, backend_fp=None):
        self.store = store
        self.pd_dir = pd_dir
        self.member = PdMember(store, member_id, ttl_s)
        self.quota = QuotaPool(self.member, manager)
        self.registry = ProgramRegistry(self.member)
        self._calib = calib          # None = process correction_store()
        self._cache = cache          # None = process compile_cache()
        # the Domain's device fingerprint (analysis/compilekey
        # backend_fingerprint): peers' manifest entries of another card
        # or torch are not adopted; None = load_warm(entry_hex) alone
        self.backend_fp = backend_fp
        self._tick_mu = threading.Lock()   # leaf: throttle state only
        self._last_sync = 0.0
        self.sync_total = 0
        self.calib_merged = 0
        self._m = _pd_metrics()

    # test seams default to the process singletons
    def _calibration(self):
        if self._calib is not None:
            return self._calib
        from ..analysis.calibrate import correction_store
        return correction_store()

    def _compile_cache(self):
        if self._cache is not None:
            return self._cache
        from ..compilecache import compile_cache
        return compile_cache()

    def matches(self, pd_dir: str) -> bool:
        return self.pd_dir == pd_dir

    # ---- the tick ---------------------------------------------------- #

    def tick(self, now: float = 0.0, force: bool = False) -> None:
        """Statement-driven heartbeat.  Never raises, never blocks on
        a peer's tick (contended ticks are simply skipped — the next
        statement retries)."""
        if not self._tick_mu.acquire(blocking=False):
            return
        try:
            now = now or time.time()
            due = force or now - self._last_sync >= PD_SYNC_S
            if not due:
                return
            self._last_sync = now
            self._run_round(now)
        finally:
            self._tick_mu.release()

    def _run_round(self, now: float) -> None:
        from ..obs import trace
        was_degraded = self.member.degraded
        with trace.span("pd.renew", member=self.member.member_id):
            live = self.member.ensure(now)
        if live:
            self._m["renew"].inc()
        if not live:
            if not was_degraded:
                # the degradation EDGE: local quota slices, counter,
                # trace flag — statements keep flowing
                self.quota.degrade_to_local_slice()
                self._m["degraded"].inc()
                trace.flag("pd_degraded")
            return
        rejoined = self.member.consume_rejoin()
        with trace.span("pd.sync", rejoin=rejoined):
            try:
                self._sync_round(rejoined)
            except PdError:
                # the store died mid-sync: same edge as a failed renew
                self.member.degrade()
                self.quota.degrade_to_local_slice()
                self._m["degraded"].inc()
                trace.flag("pd_degraded")

    def _sync_round(self, rejoined: bool) -> None:
        self.quota.sync()
        merged = self._sync_calibration()
        cache = self._compile_cache()
        manifest = cache.manifest
        if manifest is not None:
            manifest.refresh()     # fold peers' persisted entries in
            self.registry.publish_manifest(manifest)
            adopted = self.registry.adopt_from_peers(
                cache, backend_fp=self.backend_fp)
            if adopted:
                self._m["peer_warm"].inc(adopted)
        purged = self.registry.sync_quarantine(cache)
        if purged:
            self._m["quarantine"].inc(purged)
        if merged:
            self._m["calib"].inc(merged)
        self.sync_total += 1
        self._m["sync"].inc()
        self._m["members"].set(len(self.store.members()))
        for group, share in sorted(self.quota.shares.items()):
            self._m["share"].set(share, group=group)

    # ---- calibration sync -------------------------------------------- #

    def _sync_calibration(self) -> int:
        """Two-way merge through the ``calib`` key: publish local
        payloads into the shared doc (observation-count-weighted EWMA
        merge, clamp preserved — analysis/calibrate owns the math),
        then fold the merged doc back into the local store.  Returns
        how many local entries moved."""
        from ..analysis.calibrate import merge_correction_payloads
        calib = self._calibration()
        local = calib.entries_payload()
        now = time.time()
        publish = {d: p for d, p in sorted(local.items())
                   if p.get("samples", 0) > 0
                   or p.get("mem_samples", 0) > 0
                   or p.get("oom_bumps", 0) > 0}

        def merge(cur):
            doc = cur if isinstance(cur, dict) else {}
            for d in sorted(publish):
                prev = doc.get(d)
                fresh = dict(publish[d])
                merged = merge_correction_payloads(
                    prev if isinstance(prev, dict) else None, fresh)
                merged["ts"] = now
                doc[d] = merged
            for d in sorted(doc):
                if now - doc[d].get("ts", 0.0) > PD_CALIB_TTL_S:
                    del doc[d]
            if len(doc) > CALIB_SHARED_CAP:
                keep = sorted(doc,
                              key=lambda k: (-doc[k].get("samples", 0),
                                             k))[:CALIB_SHARED_CAP]
                return {d: doc[d] for d in keep}
            return doc

        doc = self.store.txn_update(CALIB_KEY, merge,
                                    epoch=self.member.epoch)
        merged_n = 0
        for d in sorted(doc):
            if calib.merge_payload(d, doc[d]):
                merged_n += 1
        self.calib_merged += merged_n
        return merged_n

    # ---- lifecycle / introspection ----------------------------------- #

    def leave(self) -> None:
        """Graceful detach (pd disabled): release the lease, restore
        full single-process refill rates."""
        self.member.leave()
        self.quota.restore_full()

    def stats(self) -> dict:
        return {"enabled": True,
                "pd_dir": self.pd_dir or "(in-process)",
                "member": self.member.stats(),
                "quota": self.quota.stats(),
                "registry": self.registry.stats(),
                "sync_total": self.sync_total,
                "calib_merged": self.calib_merged}


__all__ = ["PdCoordinator", "PD_SYNC_S", "CALIB_KEY",
           "CALIB_SHARED_CAP"]
