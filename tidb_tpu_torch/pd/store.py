# ported from tidb_tpu/pd/store.py @ 9be2bf6
"""coplace: the PD coordination store — a tiny epoch/CAS KV service.

Reference analog: PD (placement driver) in the reference architecture
keeps cluster-wide state in etcd — leases, quota budgets, and shared
metadata — and every writer fences its writes with a lease so a
process that lost its lease (partitioned, paused, restarted) cannot
clobber state the survivors moved on from.  This module is that store
scaled to the repo's deployment unit: N tidb-tpu server processes on
one host sharing one GPU.

Two backends behind one transactional facade:

- ``MemoryBackend`` — in-process dict under a leaf lock; tier-1 tests
  and ``chip_smoke.py``'s phase 19a share one instance between Domains.
  A ``down`` test seam simulates store loss without monkeypatching.
- ``FileBackend`` — one JSON document per pd directory, every
  transaction under an advisory file lock (utils/filelock) with
  atomic temp-file + rename for the write, so real processes sharing
  ``tidb_tpu_pd_dir`` get the same CAS semantics.  Any OSError maps to
  ``PdUnavailable`` — store loss is a *degradation signal*, never an
  exception a statement sees (pd/lease owns that contract).

Write fencing: every mutation carries the writer's lease epoch and is
refused (``PdLeaseExpired``) unless that epoch belongs to a live,
unexpired lease in the same document.  Concurrency between two LIVE
members is resolved by per-key version CAS, not by epoch ordering —
epochs fence the dead, versions serialize the living.

Like copcost and calibrate, this module never imports torch: the
coordination plane is pure host-side bookkeeping.  Its JSON document
is the JAX package's, key for key, so a pd directory written by either
package is read by the other.
"""

from __future__ import annotations

import json
import os
import threading
import time
from copy import deepcopy
from dataclasses import dataclass
from typing import Callable, Optional

# lease TTL: a member that misses renewal for this long is fenced out
# (its epoch stops validating) and its quota share redistributes
PD_LEASE_TTL_S = 3.0
# an in-flight cross-process compile claim expires after this long —
# a crashed compiler must not block peers forever (pd/registry)
PD_CLAIM_TTL_S = 30.0
# shared program-registry entries and quarantine tombstones age out
# after this horizon (refreshed on every publish)
PD_PROGRAM_TTL_S = 7 * 24 * 3600.0
# merged calibration payloads older than this are dropped on merge
PD_CALIB_TTL_S = 3600.0
# quota member reports older than 2 lease TTLs are pruned from the
# share computation (the member is gone; its slice redistributes)
PD_QUOTA_TTL_S = 2.0 * PD_LEASE_TTL_S

# bounded CAS retries inside txn_update before reporting contention as
# unavailability (each backend transaction is globally serialized, so
# real contention resolves in one or two rounds)
_TXN_ATTEMPTS = 16

STORE_FILE = "pd.json"
LOCK_FILE = "pd.lock"


class PdError(RuntimeError):
    """Base class for coordination-plane failures.  NEVER escapes to a
    statement: pd/lease converts both subclasses into degraded-local
    operation."""


class PdUnavailable(PdError):
    """The store cannot be reached (file backend I/O failure, memory
    backend ``down`` seam, unresolvable CAS contention)."""


class PdLeaseExpired(PdError):
    """The writer's lease epoch no longer validates — the member was
    fenced out and must re-grant (new epoch) before writing again."""


@dataclass(frozen=True)
class KeyFamily:
    """One row of the shared-store schema (``--pd-report`` renders the
    table and the gate verifies every family names an owner + TTL)."""

    prefix: str     # key prefix ("calib" is a single fixed key)
    owner: str      # pd module that owns every write to the family
    ttl_s: float    # staleness horizon for entries of the family
    epoch_rule: str  # how the lease epoch fences writes
    desc: str


KEY_FAMILIES = (
    KeyFamily("lease/", "pd/lease.py", PD_LEASE_TTL_S,
              "grant assigns the epoch; renew validates it",
              "member leases: epoch + deadline per member id"),
    KeyFamily("quota/", "pd/quota.py", PD_QUOTA_TTL_S,
              "live-lease epoch fencing + version CAS",
              "per-resource-group RU pool: declared budget + per-member "
              "debt reports feeding debt-weighted refill shares"),
    KeyFamily("program/", "pd/registry.py", PD_PROGRAM_TTL_S,
              "live-lease epoch fencing + version CAS",
              "copforge digest registry: persisted entry anatomy peers "
              "adopt into their warm pools"),
    KeyFamily("claim/", "pd/registry.py", PD_CLAIM_TTL_S,
              "live-lease epoch fencing + version CAS",
              "TTL'd in-flight compile claims: first claimant compiles, "
              "peers poll the shared cache dir instead"),
    KeyFamily("quarantine/", "pd/registry.py", PD_PROGRAM_TTL_S,
              "live-lease epoch fencing + version CAS",
              "breaker tombstones: a quarantined digest purges from "
              "every peer's warm pool and correction store"),
    KeyFamily("calib", "pd/coordinator.py", PD_CALIB_TTL_S,
              "live-lease epoch fencing + version CAS",
              "merged CorrectionStore payloads (observation-count-"
              "weighted EWMA merge, clamp [1/8, 8] preserved)"),
)


def _fresh_state() -> dict:
    return {"seq": 0, "leases": {}, "keys": {}}


class MemoryBackend:
    """In-process backend: one dict, one leaf lock, shared by every
    Domain handed the same instance (tier-1 and chip_smoke's phase 19a
    model N processes this way).  ``down = True`` simulates killing
    the store mid-run."""

    def __init__(self):
        self._mu = threading.Lock()
        self._state = _fresh_state()
        self.down = False
        self.transactions = 0

    def transact(self, fn: Callable[[dict], object]):
        with self._mu:
            if self.down:
                raise PdUnavailable("memory backend down (test seam)")
            self.transactions += 1
            return fn(self._state)

    # reads share the write path: the state dict must not be observed
    # mid-mutation from another thread
    transact_read = transact


class FileBackend:
    """File backend: the whole store is one JSON document under the pd
    directory, every transaction serialized by an advisory lock and
    committed by atomic rename.  Deleting the directory mid-run is the
    cross-process equivalent of ``MemoryBackend.down``."""

    def __init__(self, pd_dir: str):
        self.pd_dir = pd_dir
        self._path = os.path.join(pd_dir, STORE_FILE)
        self._lock_path = os.path.join(pd_dir, LOCK_FILE)
        self.transactions = 0
        try:
            os.makedirs(pd_dir, exist_ok=True)
        except OSError:
            pass          # unusable dir surfaces as PdUnavailable on
                          # the first transaction (degraded, not fatal)

    def _read_locked(self) -> dict:
        try:
            with open(self._path, encoding="utf-8") as f:
                doc = json.load(f)
            if isinstance(doc, dict) and "keys" in doc:
                return doc
        except FileNotFoundError:
            pass
        except ValueError:
            # a corrupt document cannot happen via the atomic-rename
            # write path; treat external damage as a fresh store rather
            # than wedging every member permanently
            pass
        return _fresh_state()

    def _transact(self, fn: Callable[[dict], object], write: bool):
        from ..utils.filelock import locked_file
        try:
            with locked_file(self._lock_path):
                state = self._read_locked()
                out = fn(state)
                if write:
                    tmp = self._path + f".tmp{os.getpid()}"
                    with open(tmp, "w", encoding="utf-8") as f:
                        json.dump(state, f)
                    os.replace(tmp, self._path)
                # flock excludes same-process threads too (each call
                # opens its own fd), so this += never runs concurrently
                self.transactions += 1  # planlint: ok - flock-serialized
                return out
        except OSError as e:
            raise PdUnavailable(f"pd store I/O: {e}") from e

    def transact(self, fn: Callable[[dict], object]):
        return self._transact(fn, write=True)

    def transact_read(self, fn: Callable[[dict], object]):
        return self._transact(fn, write=False)


class PdStore:
    """The transactional facade every pd module writes through.

    API shape (all raise only PdUnavailable / PdLeaseExpired):

    - ``grant(member_id, ttl_s) -> epoch`` — new lease, new fencing
      epoch (monotonic per store via the ``seq`` counter).
    - ``renew(member_id, epoch, ttl_s)`` — extend a live lease;
      PdLeaseExpired when the lease lapsed or the epoch is stale.
    - ``cas(key, expect_ver, value, *, epoch) -> bool`` — versioned
      compare-and-swap, fenced by the writer's live lease epoch.
    - ``txn_update(key, fn, *, epoch) -> value`` — read-modify-write
      via a bounded CAS loop (fn gets a deep copy; absent key = None).
    - ``delete(key, *, epoch)`` / ``get`` / ``read_prefix`` /
      ``members`` / ``dump``.
    """

    def __init__(self, backend):
        self._b = backend

    @property
    def backend(self):
        return self._b

    # ---- leases ------------------------------------------------------ #

    def grant(self, member_id: str, ttl_s: float = PD_LEASE_TTL_S) -> int:
        def txn(state: dict) -> int:
            state["seq"] = state.get("seq", 0) + 1
            epoch = state["seq"]
            state.setdefault("leases", {})[member_id] = {
                "epoch": epoch, "deadline": time.time() + ttl_s}
            return epoch
        return self._b.transact(txn)

    def renew(self, member_id: str, epoch: int,
              ttl_s: float = PD_LEASE_TTL_S) -> None:
        def txn(state: dict) -> None:
            lease = state.get("leases", {}).get(member_id)
            now = time.time()
            if (lease is None or lease.get("epoch") != epoch
                    or lease.get("deadline", 0.0) < now):
                raise PdLeaseExpired(
                    f"lease {member_id!r} epoch {epoch} lapsed")
            lease["deadline"] = now + ttl_s
        self._b.transact(txn)

    def release(self, member_id: str, epoch: int) -> None:
        """Graceful leave: drop the lease iff it is still ours."""
        def txn(state: dict) -> None:
            lease = state.get("leases", {}).get(member_id)
            if lease is not None and lease.get("epoch") == epoch:
                del state["leases"][member_id]
        self._b.transact(txn)

    def members(self) -> dict:
        """Live (unexpired) leases: member id -> {epoch, deadline}."""
        def txn(state: dict) -> dict:
            now = time.time()
            return {m: dict(lease)
                    for m, lease in sorted(
                        state.get("leases", {}).items())
                    if lease.get("deadline", 0.0) >= now}
        return self._b.transact_read(txn)

    def _check_epoch_locked(self, state: dict, epoch: int) -> None:
        """Fencing: the writer's epoch must belong to a live lease.
        (Between two live members, per-key version CAS serializes —
        see module doc.)"""
        now = time.time()
        for _m, lease in sorted(state.get("leases", {}).items()):
            if (lease.get("epoch") == epoch
                    and lease.get("deadline", 0.0) >= now):
                return
        raise PdLeaseExpired(f"write epoch {epoch} has no live lease")

    # ---- keys -------------------------------------------------------- #

    def get(self, key: str) -> tuple:
        """(value, version); (None, 0) when absent.  Values are deep
        copies — callers never hold a live reference into the store."""
        def txn(state: dict) -> tuple:
            ent = state.get("keys", {}).get(key)
            if ent is None:
                return None, 0
            return deepcopy(ent.get("val")), ent.get("ver", 0)
        return self._b.transact_read(txn)

    def read_prefix(self, prefix: str) -> dict:
        """key -> (value, version) for every key under ``prefix``."""
        def txn(state: dict) -> dict:
            out = {}
            for key in sorted(state.get("keys", {})):
                if key.startswith(prefix):
                    ent = state["keys"][key]
                    out[key] = (deepcopy(ent.get("val")),
                                ent.get("ver", 0))
            return out
        return self._b.transact_read(txn)

    def cas(self, key: str, expect_ver: int, value,
            *, epoch: int) -> bool:
        def txn(state: dict) -> bool:
            self._check_epoch_locked(state, epoch)
            ent = state.get("keys", {}).get(key)
            ver = ent.get("ver", 0) if ent is not None else 0
            if ver != expect_ver:
                return False
            state.setdefault("keys", {})[key] = {
                "val": deepcopy(value), "ver": ver + 1, "epoch": epoch}
            return True
        return self._b.transact(txn)

    def txn_update(self, key: str, fn: Callable[[Optional[object]], object],
                   *, epoch: int):
        """Read-modify-write under the lease-epoch CAS check: ``fn``
        receives the current value (None when absent) and returns the
        replacement.  Bounded retries; sustained contention reports as
        PdUnavailable (degrade, don't spin)."""
        for _attempt in range(_TXN_ATTEMPTS):
            cur, ver = self.get(key)
            new = fn(cur)
            if self.cas(key, ver, new, epoch=epoch):
                return new
        raise PdUnavailable(f"txn contention on {key!r}")

    def delete(self, key: str, *, epoch: int) -> None:
        def txn(state: dict) -> None:
            self._check_epoch_locked(state, epoch)
            state.get("keys", {}).pop(key, None)
        self._b.transact(txn)

    # ---- introspection (the /pd route) ------------------------------- #

    def dump(self, max_keys: int = 64) -> dict:
        """Bounded snapshot for the status surface: live leases + key
        census per family + the first ``max_keys`` keys."""
        def txn(state: dict) -> dict:
            now = time.time()
            keys = state.get("keys", {})
            families = {}
            for fam in KEY_FAMILIES:
                if fam.prefix.endswith("/"):
                    n = sum(1 for k in keys if k.startswith(fam.prefix))
                else:
                    n = 1 if fam.prefix in keys else 0
                families[fam.prefix] = n
            return {
                "seq": state.get("seq", 0),
                "leases": {m: {"epoch": lease.get("epoch"),
                               "ttl_left_s": round(
                                   lease.get("deadline", 0.0) - now, 3)}
                           for m, lease in sorted(
                               state.get("leases", {}).items())},
                "families": families,
                "keys": {k: {"ver": keys[k].get("ver", 0),
                             "epoch": keys[k].get("epoch", 0)}
                         for k in sorted(keys)[:max_keys]},
                "n_keys": len(keys),
            }
        return self._b.transact_read(txn)


def verify_key_families() -> list:
    """``--pd-report`` gate check: every key family must declare an
    owner module, a positive TTL, and an epoch rule.  Returns the list
    of violations (empty = pass)."""
    bad = []
    seen = set()
    for fam in KEY_FAMILIES:
        if fam.prefix in seen:
            bad.append(f"duplicate family {fam.prefix!r}")
        seen.add(fam.prefix)
        if not fam.owner.startswith("pd/"):
            bad.append(f"{fam.prefix!r}: owner {fam.owner!r} not a pd "
                       "module")
        if fam.ttl_s <= 0:
            bad.append(f"{fam.prefix!r}: non-positive TTL")
        if "epoch" not in fam.epoch_rule and \
                "grant" not in fam.epoch_rule:
            bad.append(f"{fam.prefix!r}: no epoch rule")
        if not fam.desc:
            bad.append(f"{fam.prefix!r}: undocumented")
    return bad


def pd_report() -> str:
    """Human-readable shared-store schema (``--pd-report``): every key
    family with its owner module, TTL, and epoch-fencing rule, plus a
    live micro-simulation of the fence on a fresh in-memory store."""
    lines = ["coplace shared-store schema",
             "=" * 68, ""]
    for fam in KEY_FAMILIES:
        ttl = (f"{fam.ttl_s:g}s" if fam.ttl_s < 86400.0
               else f"{fam.ttl_s / 86400.0:g}d")
        lines.append(f"{fam.prefix:<12} owner {fam.owner:<20} ttl {ttl}")
        lines.append(f"{'':>12} fence: {fam.epoch_rule}")
        lines.append(f"{'':>12} {fam.desc}")
        lines.append("")
    bad = verify_key_families()
    # live fence check: a granted epoch writes, a released one is
    # refused, version CAS rejects stale writers
    store = PdStore(MemoryBackend())
    e1 = store.grant("report-a")
    e2 = store.grant("report-b")
    if not store.cas("quota/report", 0, {"v": 1}, epoch=e1):
        bad.append("live store refused a fresh epoch-carrying CAS")
    if store.cas("quota/report", 0, {"v": 2}, epoch=e2):
        bad.append("live store accepted a stale-version CAS")
    store.release("report-b", e2)
    try:
        store.cas("quota/report", 1, {"v": 3}, epoch=e2)
        bad.append("live store accepted a write from a dead epoch")
    except PdLeaseExpired:
        pass
    for v in bad:
        lines.append(f"VIOLATION {v}")
    lines.append(f"pd: {len(KEY_FAMILIES)} key families verified "
                 f"(owner+ttl+epoch), dead-epoch writes fenced, "
                 f"{len(bad)} violations")
    return "\n".join(lines)


__all__ = ["PdStore", "MemoryBackend", "FileBackend", "PdError",
           "PdUnavailable", "PdLeaseExpired", "KeyFamily",
           "KEY_FAMILIES", "verify_key_families", "pd_report",
           "PD_LEASE_TTL_S", "PD_CLAIM_TTL_S", "PD_PROGRAM_TTL_S",
           "PD_CALIB_TTL_S", "PD_QUOTA_TTL_S", "STORE_FILE",
           "LOCK_FILE"]
