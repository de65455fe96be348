# ported from tidb_tpu/pd/lease.py @ 9be2bf6
"""coplace: member leases with TTL + explicit failover semantics.

Reference analog: PD client leases.  Every tidb-tpu process holds ONE
lease on the coordination store; the lease epoch fences all its
writes (pd/store).  The failover contract this module owns:

- store unreachable (``PdUnavailable``) or lease expired
  (``PdLeaseExpired``) => the member flips to DEGRADED: local quota
  slice, local-only caches, no shared writes.  **Never an error a
  statement sees** — degradation is silent, counted
  (``tidb_tpu_pd_degraded_total``), and flagged on the active trace.
- the next successful renewal RE-JOINS: a fresh epoch is granted (the
  old one may have been fenced), and the coordinator runs a full
  resync (quota shares, calibration, registry) on the rejoin tick.

Renewal is statement-driven (the coordinator ticks from the session
hot path) and internally throttled to ~1/3 of the TTL, so a busy
process renews a handful of times per TTL and an idle one simply
lapses — exactly the semantics a crashed process would show.
"""

from __future__ import annotations

import itertools
import os
import socket
import time

from .store import PD_LEASE_TTL_S, PdError, PdLeaseExpired, PdStore

# distinguishes N Domains inside one process (tier-1 runs two members
# over one MemoryBackend in a single interpreter)
_MEMBER_SEQ = itertools.count(1)


def default_member_id() -> str:
    return (f"{socket.gethostname()}:{os.getpid()}"
            f":{next(_MEMBER_SEQ)}")


class PdMember:
    """One process's (strictly: one Domain's) lease on the plane."""

    def __init__(self, store: PdStore, member_id: str = "",
                 ttl_s: float = PD_LEASE_TTL_S):
        self.store = store
        self.member_id = member_id or default_member_id()
        self.ttl_s = ttl_s
        self.epoch = 0               # 0 = never joined
        self.degraded = False
        self._deadline = 0.0         # local view of our lease deadline
        self._rejoined = False       # set on recovery, consumed by
                                     # the coordinator's resync tick
        # lifetime counters (surfaced via coordinator.stats)
        self.renews = 0
        self.grants = 0
        self.rejoins = 0
        self.degraded_total = 0

    def joined(self) -> bool:
        return self.epoch > 0 and not self.degraded

    def consume_rejoin(self) -> bool:
        """True exactly once after a degraded->live transition — the
        coordinator forces a full quota/calibration/registry resync."""
        out = self._rejoined
        self._rejoined = False
        return out

    def ensure(self, now: float = 0.0) -> bool:
        """Grant or renew when due.  True = lease live (writes with
        ``self.epoch`` will validate); False = degraded.  Raises
        nothing — this IS the failover seam."""
        now = now or time.time()
        if self.joined() and now < self._deadline - self.ttl_s * (2.0 / 3.0):
            return True          # renewed recently; not due yet
        try:
            if self.epoch > 0 and not self.degraded:
                try:
                    self.store.renew(self.member_id, self.epoch,
                                     self.ttl_s)
                    self.renews += 1
                except PdLeaseExpired:
                    # fenced out (TTL lapsed between ticks): re-grant
                    # under a NEW epoch — old-epoch writes stay fenced
                    self.epoch = self.store.grant(self.member_id,
                                                  self.ttl_s)
                    self.grants += 1
                    self._rejoined = True
                    self.rejoins += 1
            else:
                was_degraded = self.degraded
                self.epoch = self.store.grant(self.member_id, self.ttl_s)
                self.grants += 1
                if was_degraded:
                    self._rejoined = True
                    self.rejoins += 1
            self.degraded = False
            self._deadline = now + self.ttl_s
            return True
        except PdError:
            self.degrade()
            return False

    def degrade(self) -> None:
        """Flip to degraded-local (idempotent).  The caller bumps the
        degraded counter/trace flag on the False edge it observes."""
        if not self.degraded:
            self.degraded = True
            self.degraded_total += 1

    def leave(self) -> None:
        """Graceful departure (pd disabled / Domain close): release
        the lease so peers reclaim our quota slice immediately."""
        if self.epoch > 0:
            try:
                self.store.release(self.member_id, self.epoch)
            except PdError:
                pass             # leaving a dead store is still leaving
        self.epoch = 0
        self.degraded = False
        self._deadline = 0.0

    def stats(self) -> dict:
        return {"member_id": self.member_id,
                "epoch": self.epoch,
                "ttl_s": self.ttl_s,
                "degraded": self.degraded,
                "renews": self.renews,
                "grants": self.grants,
                "rejoins": self.rejoins,
                "degraded_total": self.degraded_total}


__all__ = ["PdMember", "default_member_id"]
