# ported from tidb_tpu/pd/__init__.py @ 9be2bf6
"""coplace: a PD-style coordination plane for N tidb-tpu processes.

Reference analog: PD, the placement driver in the reference
architecture's layer map — the component that turns N servers into
one cluster.  Everything the repo built so far (RU admission, the
copforge program cache, closed-loop calibration) was per-process; this
package coordinates them through one tiny epoch/CAS store:

- ``pd/store.py``  — the store (in-process + file backends, lease-
  epoch write fencing).
- ``pd/lease.py``  — member leases; failover = graceful degradation
  to local quota slices + local-only caches, never errors.
- ``pd/quota.py``  — ONE ``RU_PER_SEC`` across processes via
  debt-weighted refill shares into each process's TokenBucket.
- ``pd/registry.py`` — compile-once claims, peer warm-pool adoption,
  cross-process quarantine tombstones.
- ``pd/coordinator.py`` — the per-Domain statement-driven tick.

This module owns the process-wide surfaces: the sysvar plumbing seam
(``configure_domain``), the default in-process shared backend (two
Domains in one interpreter = two servers sharing one card), the
compile-claim hooks the program cache calls on its miss path, and ``pd_status()`` for
``/pd`` + the scheduler's ``/sched`` section.

Enable with ``SET GLOBAL tidb_tpu_pd = 1`` (and point
``tidb_tpu_pd_dir`` at a shared directory for real multi-process
coordination; empty = the in-process backend).
"""

from __future__ import annotations

import threading
from typing import Optional

from .coordinator import PD_SYNC_S, PdCoordinator
from .lease import PdMember
from .quota import QuotaPool
from .registry import ProgramRegistry
from .store import (KEY_FAMILIES, FileBackend, KeyFamily, MemoryBackend,
                    PdError, PdLeaseExpired, PdStore, PdUnavailable,
                    pd_report, verify_key_families)

_MU = threading.Lock()
_COORDS: list = []                      # every attached coordinator
_SHARED_BACKEND: Optional[MemoryBackend] = None


def shared_memory_backend() -> MemoryBackend:
    """The process-default backend for ``tidb_tpu_pd_dir = ''``: every
    Domain in this interpreter joins the same in-process store."""
    global _SHARED_BACKEND
    with _MU:
        if _SHARED_BACKEND is None:
            _SHARED_BACKEND = MemoryBackend()
        return _SHARED_BACKEND


def configure_domain(domain, enable: bool, pd_dir: str = ""):
    """The sysvar seam (session/_exec_ctx): attach, retarget, or
    detach a Domain's coordinator.  Idempotent and cheap when nothing
    changed; returns the live coordinator (None when disabled)."""
    coord = getattr(domain, "pd", None)
    if not enable:
        if coord is not None:
            coord.leave()
            _detach(coord)
            domain.pd = None
        return None
    if coord is not None and coord.matches(pd_dir):
        return coord
    if coord is not None:
        coord.leave()
        _detach(coord)
    from ..analysis.compilekey import backend_fingerprint
    backend = FileBackend(pd_dir) if pd_dir else shared_memory_backend()
    coord = PdCoordinator(
        PdStore(backend), domain.resource_groups, pd_dir=pd_dir,
        backend_fp=backend_fingerprint(domain.client.devices))
    domain.pd = coord
    with _MU:
        _COORDS.append(coord)
    return coord


def _detach(coord) -> None:
    with _MU:
        if coord in _COORDS:
            _COORDS.remove(coord)


def coordinators() -> list:
    with _MU:
        return list(_COORDS)


def reset_pd() -> None:
    """Test seam: detach every coordinator and drop the shared
    in-process backend (fresh plane for the next test)."""
    global _SHARED_BACKEND
    with _MU:
        coords = list(_COORDS)
        _COORDS.clear()
        _SHARED_BACKEND = None
    for c in coords:
        c.leave()


# ---- compile-claim hooks (compilecache.cache miss path) ----------- #

def _live_coordinator():
    for c in coordinators():
        if c.member.joined():
            return c
    return None


def try_compile_claim(entry_hex: str) -> Optional[bool]:
    """None = pd off/degraded (build as usual); True = claim won
    (build, then release); False = a live peer is building this
    entry (the port's program cache builds it too: a build costs
    next to nothing, so nothing waits on the peer)."""
    coord = _live_coordinator()
    if coord is None:
        return None
    try:
        return coord.registry.try_claim(entry_hex)
    except PdError:
        return None          # store loss mid-claim: degraded-local

def release_compile_claim(entry_hex: str) -> None:
    coord = _live_coordinator()
    if coord is None:
        return
    try:
        coord.registry.release_claim(entry_hex)
    except PdError:
        pass


def broadcast_quarantine(digest: str) -> None:
    """Scheduler breaker hook: tombstone a quarantined digest for
    every peer.  No-op when pd is off or degraded."""
    coord = _live_coordinator()
    if coord is None:
        return
    try:
        coord.registry.broadcast_quarantine(digest)
    except PdError:
        pass


# ---- status surfaces ---------------------------------------------- #

def pd_status() -> dict:
    """The ``pd`` section of ``/sched`` + the backbone of ``/pd``."""
    coords = coordinators()
    if not coords:
        return {"enabled": False, "coordinators": 0}
    out = {"enabled": True,
           "coordinators": len(coords),
           "members": [c.stats() for c in coords]}
    try:
        out["store"] = coords[0].store.dump()
    except PdError:
        out["store"] = {"unavailable": True}
    return out


__all__ = ["PdStore", "MemoryBackend", "FileBackend", "PdError",
           "PdUnavailable", "PdLeaseExpired", "PdMember", "QuotaPool",
           "ProgramRegistry", "PdCoordinator", "KeyFamily",
           "KEY_FAMILIES", "verify_key_families", "pd_report",
           "PD_SYNC_S",
           "configure_domain", "coordinators", "reset_pd",
           "shared_memory_backend", "try_compile_claim",
           "release_compile_claim", "broadcast_quarantine",
           "pd_status"]
