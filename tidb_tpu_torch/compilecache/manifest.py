# ported from tidb_tpu/compilecache/manifest.py @ 02e96d8
"""Warm-pool manifest: the persisted record of the programs built.

Reference analog: the plan-cache eviction bookkeeping of the reference
(pkg/planner/core/plan_cache_lru.go) applied to program objects.  One
JSON file per cache directory lists every program the cache built with
its key anatomy (analysis/compilekey: digest, family, device
fingerprint, capacity signature, backend fingerprint), its capacity and
its measured build time; a restarted server replays it MRU-first
(compilecache/warmup.py), the client's regrow and paging loops read its
capacities by plan family (``capacities_for``), and the correction
store's payloads (analysis/calibrate) ride the same file.  The port
persists no executables: there is no ``.copforge`` payload beside an
entry.

Two hard rules:

- bounded by BYTES, LRU-evicted (``tidb_tpu_compile_warm_pool`` caps
  it).
- a QUARANTINED digest is never recorded and is purged on quarantine:
  a program the circuit breaker opened on must not launder its way back
  through a restart's warm replay.

Saves are safe under CONCURRENT WRITERS: N processes may share one
``tidb_tpu_compile_cache_dir``, so every save is an advisory-locked
read-MERGE-write (utils/filelock) committed by atomic temp-file +
rename — a concurrent save folds the other process's entries in
instead of clobbering them.  Locally dropped entries and purged digests
are remembered so a merge can never resurrect what eviction or
quarantine removed here.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1

# default byte bound when the sysvar leaves -1 in place
DEFAULT_CAP_BYTES = 256 << 20


class WarmManifest:
    """Thread-safe manifest of one cache directory (leaf lock only)."""

    def __init__(self, cache_dir: str, cap_bytes: int = DEFAULT_CAP_BYTES):
        self.cache_dir = cache_dir
        self.cap_bytes = cap_bytes
        self._mu = threading.Lock()
        self._entries: dict[str, dict] = {}       # entry_hex -> meta
        # copmeter (analysis/calibrate): per-digest measured cost
        # corrections ride the same file, so calibration survives
        # restarts exactly as far as the programs it describes
        self._calib: dict[str, dict] = {}         # stable digest -> payload
        # merge fences: what THIS process dropped must not come back
        # via a concurrent writer's copy (see module doc)
        self._dropped: set = set()                # entry hexes evicted here
        self._purged: set = set()                 # digests quarantined here
        self.evictions = 0
        self._load()

    # ---- persistence ------------------------------------------------ #

    def _path(self) -> str:
        return os.path.join(self.cache_dir, MANIFEST_NAME)

    def _load(self) -> None:
        try:
            with open(self._path(), encoding="utf-8") as f:
                doc = json.load(f)
            if doc.get("version") == MANIFEST_VERSION:
                self._entries = dict(doc.get("entries", {}))
                self._calib = dict(doc.get("calibration", {}))
        except (OSError, ValueError):
            self._entries = {}
            self._calib = {}

    def _read_disk(self) -> dict:
        try:
            with open(self._path(), encoding="utf-8") as f:
                doc = json.load(f)
            if isinstance(doc, dict) and \
                    doc.get("version") == MANIFEST_VERSION:
                return doc
        except (OSError, ValueError):
            pass
        return {}

    def _merge_disk_locked(self, doc: dict) -> int:
        """Fold a concurrent writer's document into the live view:
        unknown entries adopt, conflicts keep OURS (our copy carries
        this process's hits/last_used), and nothing this process
        dropped or quarantined may resurrect.  Returns adoptions."""
        n = 0
        for hx, meta in sorted(doc.get("entries", {}).items()):
            if hx in self._entries or hx in self._dropped:
                continue
            if meta.get("digest", "") in self._purged:
                continue
            self._entries[hx] = dict(meta)
            n += 1
        for d, payload in sorted(doc.get("calibration", {}).items()):
            if d in self._calib or d in self._purged:
                continue
            self._calib[d] = dict(payload)
        return n

    def refresh(self) -> int:
        """Fold entries other processes persisted since our last save
        into the live view WITHOUT writing — the pd sync tick's read
        channel (peer adoption then sees their regrow capacities, not
        just entry names)."""
        with self._mu:
            return self._merge_disk_locked(self._read_disk())

    def _save_locked(self) -> None:
        """Advisory-locked read-merge-write + atomic rename: safe
        against concurrent writers sharing the cache dir (see module
        doc).  Still never a failure — the manifest is an
        optimization."""
        from ..utils.filelock import locked_file
        try:
            os.makedirs(self.cache_dir, exist_ok=True)
            with locked_file(self._path() + ".lock"):
                self._merge_disk_locked(self._read_disk())
                self._evict_locked()
                tmp = self._path() + f".tmp{os.getpid()}"
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump({"version": MANIFEST_VERSION,
                               "entries": self._entries,
                               "calibration": self._calib}, f)
                os.replace(tmp, self._path())
        except OSError:
            pass          # manifest is an optimization, never a failure

    # ---- recording -------------------------------------------------- #

    def record(self, entry_hex: str, key_parts: dict, nbytes: int,
               compile_ms: float, quarantined: bool = False) -> None:
        """One built program: key anatomy + measured build time.  Quarantined digests are refused — see module doc."""
        if quarantined:
            return
        with self._mu:
            self._entries[entry_hex] = {
                "digest": key_parts.get("digest", ""),
                "family": key_parts.get("family", ""),
                "mesh_fp": key_parts.get("mesh_fp", ""),
                "capacity_sig": key_parts.get("capacity_sig", ""),
                "backend_fp": key_parts.get("backend_fp", ""),
                "capacity": key_parts.get("capacity", 0),
                "bytes": int(nbytes),
                "compile_ms": round(float(compile_ms), 3),
                "load_ms": 0.0,
                "hits": 0,
                "last_used": time.time(),
            }
            self._evict_locked()
            self._save_locked()

    def touch(self, entry_hex: str, load_ms: float = 0.0) -> None:
        with self._mu:
            e = self._entries.get(entry_hex)
            if e is not None:
                e["hits"] = e.get("hits", 0) + 1
                e["last_used"] = time.time()
                if load_ms:
                    e["load_ms"] = round(float(load_ms), 3)

    def purge_digest(self, digest: str) -> int:
        """Drop (and unlink) every entry of a quarantined digest — and
        its persisted cost corrections (analysis/calibrate): measured
        feedback from a poisoned program must not launder through a
        restart any more than its executable may."""
        with self._mu:
            self._purged.add(digest)     # merge fence: never readopt
            doomed = [hx for hx, e in sorted(self._entries.items())
                      if e.get("digest") == digest]
            for hx in doomed:
                self._drop_locked(hx)
            self._calib.pop(digest, None)
            self._save_locked()          # persist the purge even when
                                         # only the fence changed
            return len(doomed)

    # ---- calibration persistence (analysis/calibrate) ---------------- #

    def save_calibration(self, entries: dict) -> None:
        """Persist the correction store's per-digest payloads (keyed by
        the restart-stable dag digest — the same digest field the
        entries above carry and purge_digest matches on)."""
        with self._mu:
            self._calib = {str(d): dict(p)
                           for d, p in sorted(entries.items())}
            self._save_locked()

    def load_calibration(self) -> dict:
        with self._mu:
            return {d: dict(p) for d, p in self._calib.items()}

    def _drop_locked(self, entry_hex: str) -> None:
        self._dropped.add(entry_hex)     # merge fence: stay dropped
        self._entries.pop(entry_hex, None)

    def drop(self, entry_hex: str) -> None:
        """Drop one entry (the warm replay's stale-backend rejection)."""
        with self._mu:
            self._drop_locked(entry_hex)
            self._save_locked()

    def entry(self, entry_hex: str) -> Optional[dict]:
        with self._mu:
            e = self._entries.get(entry_hex)
            return dict(e) if e is not None else None

    def _evict_locked(self) -> None:
        """LRU by bytes: oldest-used entries (and their files) go first
        until the manifest fits the cap.  cap_bytes 0 = unbounded."""
        if self.cap_bytes <= 0:
            return
        total = sum(e.get("bytes", 0) for e in self._entries.values())
        while total > self.cap_bytes and len(self._entries) > 1:
            lru = min(sorted(self._entries.items()),
                      key=lambda kv: kv[1].get("last_used", 0.0))
            total -= lru[1].get("bytes", 0)
            self._drop_locked(lru[0])
            self.evictions += 1

    # ---- introspection ---------------------------------------------- #

    def entries_mru(self) -> list:
        """(entry_hex, meta) pairs, most-recently-used first — the warm
        replay order (hottest programs load before the long tail)."""
        with self._mu:
            return sorted(self._entries.items(),
                          key=lambda kv: -kv[1].get("last_used", 0.0))

    def has_program(self, digest: str) -> bool:
        """Is any entry of this (stable) dag digest warm-replayable?"""
        with self._mu:
            return any(e.get("digest") == digest
                       for e in self._entries.values())

    def capacities_for(self, family: str,
                       backend_fp: Optional[str] = None) -> list:
        """Recorded regrow capacities of one plan family (of one backend
        when ``backend_fp`` is given), ascending — the client's
        warm-capacity pick reads this on regrow re-entry."""
        with self._mu:
            caps = {int(e.get("capacity", 0))
                    for e in self._entries.values()
                    if e.get("family") == family and e.get("capacity")
                    and (backend_fp is None
                         or e.get("backend_fp") == backend_fp)}
        return sorted(caps)

    def stats(self) -> dict:
        with self._mu:
            return {"entries": len(self._entries),
                    "bytes": sum(e.get("bytes", 0)
                                 for e in self._entries.values()),
                    "cap_bytes": self.cap_bytes,
                    "evictions": self.evictions,
                    "calibration_entries": len(self._calib)}


__all__ = ["WarmManifest", "MANIFEST_NAME", "MANIFEST_VERSION",
           "DEFAULT_CAP_BYTES"]
