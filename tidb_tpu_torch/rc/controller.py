# ported from tidb_tpu/rc/controller.py @ 02e96d8
"""Resource control plane: group registry, budgeting, and statement
accounting.

Reference analog: pkg/resourcegroup + TiKV's unified read pool
(SURVEY §2.7).  The pre-rc port charged RUs AFTER execution from
``est_rows/100 + 1``, so an exhausted group still launched device
programs and only its next statement blocked.  This module owns the
other half of the fix (rc/pricing + rc/bucket are the first half):

- ``ResourceGroup`` couples the group meta (RU_PER_SEC, BURSTABLE,
  QUERY_LIMIT, PRIORITY, SWITCH_GROUP target) with its ``TokenBucket``
  and travels INTO the scheduler on every CopTask, so the weighted-fair
  drain can refuse to serve a group whose bucket (plus bounded
  overdraft) cannot cover the next task's priced RUs — admission-time
  enforcement, no head-of-line blocking across groups
  (sched/scheduler._pick consults ``bucket.can_cover``).
- ``charge_statement`` keeps the post-execution seam for what only the
  statement boundary knows: the runaway watch over queue+execution wall
  time (rc/runaway: KILL / COOLDOWN / SWITCH_GROUP) and the legacy
  row-count charge for HOST-only statements (device work is priced and
  debited pre-launch at the drain; charging it again here would double
  bill).
- ``ResourceExhaustedError`` is the MySQL-compatible failure the drain
  raises when a throttled task overstays its max-queue deadline (TiDB
  error space 8252, ErrResourceGroupRequestFailed analog).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from .bucket import TokenBucket
from .pricing import statement_rus
from .runaway import RunawayError, RunawayRing, is_runaway

# PRIORITY -> device-scheduler fair-share weight (stride scheduling in
# sched/scheduler.py; the reference's resource-group PRIORITY feeds
# tikv's unified read pool the same way)
PRIORITY_WEIGHTS = {"low": 1.0, "medium": 8.0, "high": 16.0}

# bounded overdraft the drain tolerates before throttling a group
# (engine default; tidb_tpu_rc_overdraft_ru overrides per deployment)
DEFAULT_OVERDRAFT_RU = 64.0
# how long a throttled task may queue before failing its waiter with
# ResourceExhaustedError (DeviceScheduler.rc_max_queue_s; tests shrink)
DEFAULT_MAX_QUEUE_S = 10.0


class ResourceExhaustedError(RuntimeError):
    """A resource group's RU bucket stayed exhausted past the max-queue
    deadline: the waiter fails instead of occupying the admission queue
    forever (tikv unified-read-pool deadline behavior).  MySQL/TiDB
    error number 8252 ('Exceeded resource group quota limitation')."""

    errno = 8252

    def __init__(self, group: str, waited_s: float, rus: float):
        super().__init__(
            f"Exceeded resource group quota limitation: group "
            f"{group!r} could not cover {rus:.1f} RU within "
            f"{waited_s:.1f}s (bucket exhausted; raise RU_PER_SEC or "
            "retry later)")


@dataclass
class ResourceGroup:
    """One group's meta + live RU bucket.  Every session of the group
    shares this object; the bucket serializes internally and
    ``runaway_count`` updates under ``_mu``."""

    name: str
    ru_per_sec: int = 0            # 0 = unlimited
    burstable: bool = False
    exec_elapsed_sec: float = 0.0  # 0 = no runaway watch
    runaway_action: str = "kill"   # kill | cooldown | switch_group
    priority: str = "medium"       # low | medium | high (sched weight)
    switch_target: str = ""        # SWITCH_GROUP(<name>) destination
    runaway_count: int = 0
    bucket: TokenBucket = None
    _mu: threading.Lock = field(default_factory=threading.Lock)

    def __post_init__(self):
        if self.bucket is None:
            self.bucket = TokenBucket(self.ru_per_sec, self.burstable)

    @property
    def sched_weight(self) -> float:
        return PRIORITY_WEIGHTS.get(self.priority, 8.0)

    @property
    def limited(self) -> bool:
        return self.ru_per_sec > 0

    def note_runaway(self) -> None:
        with self._mu:
            self.runaway_count += 1

    def consume(self, rus: float, max_wait_sec: float = 5.0) -> float:
        """Blocking post-paid charge for the HOST statement path (no
        device launch to gate): any positive balance admits the charge
        into bounded debt; an empty bucket sleeps OUTSIDE the lock until
        refill covers it or the wait budget runs out.  Returns seconds
        slept — the reference token client's throttle."""
        if not self.limited:
            return 0.0
        slept = 0.0
        while True:
            if self.bucket.try_postpaid(rus):
                return slept
            need = min(self.bucket.deficit(rus) / self.ru_per_sec,
                       max_wait_sec - slept)
            if need <= 0:
                self.bucket.debit(rus)   # waited long enough; take debt
                return slept
            step = min(need, 0.05)
            time.sleep(step)
            slept += step


class ResourceGroupManager:
    """Domain-level group registry (resource group meta + runaway
    settings; infoschema RESOURCE_GROUPS analog).  The group MAP is
    guarded by ``_lock``; per-group state by the group's own bucket/_mu
    leaf locks — ``_lock`` is never held across a bucket operation."""

    def __init__(self):
        self._groups: dict[str, ResourceGroup] = {
            "default": ResourceGroup("default")}
        self._lock = threading.Lock()
        self.runaway_ring = RunawayRing()

    def _validate(self, action: Optional[str],
                  switch_target: Optional[str],
                  priority: Optional[str]) -> None:
        if priority is not None and priority not in PRIORITY_WEIGHTS:
            raise ValueError(f"bad PRIORITY {priority!r}")
        if action == "switch_group":
            if not switch_target:
                raise ValueError("ACTION=SWITCH_GROUP needs a target "
                                 "group: SWITCH_GROUP(<name>)")
            if self.get(switch_target) is None:
                raise ValueError(
                    f"SWITCH_GROUP target {switch_target!r} does not "
                    "exist")

    def create(self, name: str, ru_per_sec: Optional[int],
               burstable: Optional[bool] = None,
               exec_elapsed_sec: Optional[float] = None,
               action: Optional[str] = None,
               if_not_exists: bool = False,
               priority: Optional[str] = None,
               switch_target: Optional[str] = None) -> ResourceGroup:
        self._validate(action, switch_target, priority)
        with self._lock:
            if name in self._groups:
                if if_not_exists:
                    return self._groups[name]    # no-op, keep the group
                raise ValueError(f"resource group {name!r} exists")
            g = ResourceGroup(name, ru_per_sec or 0, bool(burstable),
                              exec_elapsed_sec or 0.0, action or "kill",
                              priority or "medium", switch_target or "")
            self._groups[name] = g
            return g

    def alter(self, name: str, ru_per_sec: Optional[int],
              burstable: Optional[bool], exec_elapsed_sec: Optional[float],
              action: Optional[str],
              priority: Optional[str] = None,
              switch_target: Optional[str] = None) -> ResourceGroup:
        """Merge only the options named in the statement; state
        (bucket balance/debt, runaway counters) is preserved."""
        self._validate(action, switch_target, priority)
        with self._lock:
            g = self._groups.get(name)
            if g is None:
                raise ValueError(f"unknown resource group {name!r}")
            if ru_per_sec is not None:
                g.ru_per_sec = ru_per_sec
            if burstable is not None:
                g.burstable = burstable
            if exec_elapsed_sec is not None:
                g.exec_elapsed_sec = exec_elapsed_sec
            if action is not None:
                g.runaway_action = action
                g.switch_target = switch_target or ""
            if priority is not None:
                g.priority = priority
        if ru_per_sec is not None or burstable is not None:
            g.bucket.set_limit(g.ru_per_sec, g.burstable)
        return g

    def drop(self, name: str, if_exists: bool = False) -> None:
        with self._lock:
            if name == "default":
                raise ValueError("cannot drop the default resource group")
            if name not in self._groups:
                if if_exists:
                    return
                raise ValueError(f"unknown resource group {name!r}")
            for g in self._groups.values():
                if g.switch_target == name:
                    g.switch_target = ""     # orphaned target: disarm
                    if g.runaway_action == "switch_group":
                        g.runaway_action = "cooldown"
            del self._groups[name]

    def get(self, name: str) -> Optional[ResourceGroup]:
        with self._lock:
            return self._groups.get(name)

    def groups_snapshot(self) -> list:
        """Stable-ordered snapshot of the live groups (coplace: the pd
        quota pool iterates limited groups each renewal round without
        holding the registry lock across bucket operations)."""
        with self._lock:
            return [self._groups[name] for name in sorted(self._groups)]

    def rows(self) -> list[tuple]:
        with self._lock:
            groups = list(self._groups.values())
        out = []
        for g in groups:
            action = g.runaway_action.upper()
            if g.runaway_action == "switch_group" and g.switch_target:
                action = f"SWITCH_GROUP({g.switch_target})"
            out.append((g.name, g.ru_per_sec or None,
                        "YES" if g.burstable else "NO",
                        g.exec_elapsed_sec or None, action,
                        g.runaway_count, g.priority.upper()))
        return out

    def resource_stats(self) -> dict:
        """Per-group budget state for the /resource status route."""
        with self._lock:
            groups = list(self._groups.values())
        out = {}
        for g in groups:
            out[g.name] = {
                "ru_per_sec": g.ru_per_sec,
                "burstable": g.burstable,
                "priority": g.priority,
                "balance": round(g.bucket.balance, 2),
                "debt": round(g.bucket.debt, 2),
                "debited_ru": round(g.bucket.debited, 2),
                "runaway_count": g.runaway_count,
                "runaway_action": g.runaway_action,
                "switch_target": g.switch_target,
            }
        return out


def charge_statement(group: ResourceGroup, rows_touched: int,
                     elapsed_sec: float, *, sched_wait_sec: float = 0.0,
                     device_rus: float = 0.0,
                     manager: Optional[ResourceGroupManager] = None,
                     sql: str = "") -> str:
    """Post-execution accounting seam.

    Device work was priced from its LaunchCost and debited at the drain
    (``device_rus`` reports it); only HOST-only statements still charge
    the legacy row-count RU here, post-paid and blocking.  The runaway
    watch covers queue+execution wall time (``elapsed_sec`` includes
    the admission wait) and applies the group's action: KILL raises,
    COOLDOWN double-charges, SWITCH_GROUP moves the statement's debit
    to the target group.  Returns the name of the group that ended up
    paying (== group.name unless a runaway switch re-priced it)."""
    host_rus = statement_rus(rows_touched) if device_rus <= 0 else 0.0
    payer = group
    if is_runaway(group, elapsed_sec):
        group.note_runaway()
        action = group.runaway_action
        target = None
        if action == "switch_group" and manager is not None:
            target = manager.get(group.switch_target)
            if target is None or target is group:
                action, target = "cooldown", None   # disarmed target
        if manager is not None:
            manager.runaway_ring.add(
                group.name, action,
                target.name if target is not None else "", sql,
                elapsed_sec, sched_wait_sec)
        if action == "kill":
            raise RunawayError(
                f"query exceeded EXEC_ELAPSED "
                f"{group.exec_elapsed_sec}s (resource group "
                f"{group.name!r})")
        if action == "cooldown":
            # demotion = the statement pays double: device work debits
            # its priced RUs a second time (sanctioned debt), host work
            # doubles its row charge below
            if device_rus > 0:
                group.bucket.debit(device_rus)
            host_rus *= 2.0
        elif target is not None:
            # re-price against the target group: the pre-launch device
            # debit moves buckets, and any host charge pays there too
            if device_rus > 0:
                group.bucket.credit(device_rus)
                target.bucket.debit(device_rus)
            payer = target
    if host_rus > 0:
        payer.consume(host_rus)
    return payer.name


__all__ = ["ResourceGroup", "ResourceGroupManager", "RunawayError",
           "ResourceExhaustedError", "charge_statement",
           "PRIORITY_WEIGHTS", "DEFAULT_OVERDRAFT_RU",
           "DEFAULT_MAX_QUEUE_S"]
