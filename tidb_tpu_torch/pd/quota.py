# ported from tidb_tpu/pd/quota.py @ 9be2bf6
"""coplace: the global per-resource-group RU token pool.

Reference analog: the reference's resource-control token server —
RU_PER_SEC is a CLUSTER budget that PD leases out in refill shares to
each server's local token bucket (pkg/mcs/resourcemanager).  Before
this module, two tidb-tpu processes each refilled a group's
``TokenBucket`` at the full declared rate: N processes N-times
over-admit the group.

Mechanics, one renewal round per group:

- every member reports its bucket DEBT into ``quota/<group>``
  (txn_update under its lease epoch), prunes members whose reports
  are older than ``PD_QUOTA_TTL_S`` (crashed peers yield their slice),
  and reads the merged membership back.
- debt-weighted shares: ``w_i = 1 + debt_i``, ``share_i =
  RU_PER_SEC * w_i / sum(w)`` — a member whose sessions queued deeper
  refills faster next period, so the global budget chases demand
  instead of splitting evenly forever.  Sum of shares == the declared
  budget, always: ONE RU_PER_SEC holds across N processes.
- the share applies through ``TokenBucket.set_limit`` (balance and
  debt carry over — the rc drain's admission logic is untouched).

Failover (pd/lease contract): degraded members fall back to a LOCAL
SLICE — the declared rate divided by the last known member count — so
an isolated process can not spend the whole cluster budget, and a
fully partitioned fleet converges to the same split a live store
would give.  Disabling pd restores the full declared rate.
"""

from __future__ import annotations

import time

from .lease import PdMember
from .store import PD_QUOTA_TTL_S

QUOTA_PREFIX = "quota/"


class QuotaPool:
    """One member's view of the shared RU pools (one per limited
    resource group in its Domain's ResourceGroupManager)."""

    def __init__(self, member: PdMember, manager):
        self.member = member
        self.manager = manager            # rc ResourceGroupManager
        self.shares: dict[str, float] = {}       # group -> leased ru/s
        self._member_counts: dict[str, int] = {}  # last seen per group
        self.rebalances = 0
        self.local_slices = 0

    def _limited_groups(self) -> list:
        return [g for g in self.manager.groups_snapshot() if g.limited]

    # ---- the renewal round ------------------------------------------ #

    def sync(self, now: float = 0.0) -> None:
        """Report debt + rebalance every limited group.  Raises
        PdUnavailable/PdLeaseExpired — the coordinator catches and
        degrades (this module never decides failover policy)."""
        store = self.member.store
        epoch = self.member.epoch
        mid = self.member.member_id
        now = now or time.time()
        for group in self._limited_groups():
            debt = max(group.bucket.debt, 0.0)

            def merge(cur, _group=group, _debt=debt):
                doc = cur if isinstance(cur, dict) else {}
                doc["ru_per_sec"] = _group.ru_per_sec
                doc["burstable"] = _group.burstable
                members = doc.setdefault("members", {})
                members[mid] = {"debt": round(_debt, 3), "ts": now}
                for m in sorted(members):
                    if now - members[m].get("ts", 0.0) > PD_QUOTA_TTL_S:
                        del members[m]    # crashed peer: reclaim slice
                return doc

            doc = store.txn_update(QUOTA_PREFIX + group.name, merge,
                                   epoch=epoch)
            self._member_counts[group.name] = len(doc.get("members", {}))
            self._apply(group, self._share_of(doc, mid))
        self.rebalances += 1

    def _share_of(self, doc: dict, mid: str) -> float:
        """Debt-weighted refill share; shares over all members sum to
        the declared budget exactly (modulo float rounding)."""
        limit = max(doc.get("ru_per_sec", 0), 0)
        members = doc.get("members", {})
        if limit <= 0 or not members:
            return limit * 1.0
        weights = {m: 1.0 + max(info.get("debt", 0.0), 0.0)
                   for m, info in sorted(members.items())}
        total = sum(weights.values())
        return limit * weights.get(mid, 1.0) / max(total, 1e-9)

    def _apply(self, group, share: float) -> None:
        group.bucket.set_limit(share, group.burstable)
        self.shares[group.name] = round(share, 3)

    # ---- failover ---------------------------------------------------- #

    def degrade_to_local_slice(self) -> None:
        """Store lost / lease fenced: every limited group refills at
        ``declared / last_known_member_count`` — the conservative split
        that keeps the COMBINED spend of a fully partitioned fleet at
        the declared budget.  A never-synced member (count unknown)
        keeps the full rate: pd never makes a single process worse."""
        for group in self._limited_groups():
            n = max(self._member_counts.get(group.name, 1), 1)
            self._apply(group, group.ru_per_sec / n)
        self.local_slices += 1

    def restore_full(self) -> None:
        """pd disabled / member left: declared single-process rates."""
        for group in self._limited_groups():
            group.bucket.set_limit(group.ru_per_sec, group.burstable)
        self.shares.clear()
        self._member_counts.clear()

    def stats(self) -> dict:
        return {"shares": dict(sorted(self.shares.items())),
                "member_counts": dict(sorted(
                    self._member_counts.items())),
                "rebalances": self.rebalances,
                "local_slices": self.local_slices}


__all__ = ["QuotaPool", "QUOTA_PREFIX"]
