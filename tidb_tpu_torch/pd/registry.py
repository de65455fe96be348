# ported from tidb_tpu/pd/registry.py @ 9be2bf6
"""coplace: the shared copforge program-digest registry.

Reference analog: the reference's placement rules + the plan-cache
interaction with the stats/schema version — shared metadata that every
server consults before doing local work.  In the JAX package that work
is an AOT compile; the port compiles nothing (a program object is built
from its spec and its kernels were built once), so the registry keeps
the JAX package's three cross-process properties over what the port's
program cache holds:

- **compile-once**: before building, a process claims
  ``claim/<entry>`` (TTL'd — a crashed builder unblocks its peers in
  ``PD_CLAIM_TTL_S``).  A denied claimant builds anyway (a build costs
  the port next to nothing); the claim is kept at the program cache's
  miss path (compilecache.cache ``resolve``) so the counters match the
  JAX package's for the same calls.
- **warm-pool gossip**: each member publishes the entry anatomy of
  its manifest under ``program/<digest>``; peers adopt a bounded
  number per sync tick via ``CompileCache.load_warm`` — the port's
  warm replay of one manifest entry: its regrow capacity joins the
  pool's capacity index when the entry's backend fingerprint is the
  peer's own (the shared ``tidb_tpu_compile_cache_dir`` holds the
  manifest; the registry carries the *names*).
- **quarantine propagation**: a breaker-opened digest broadcasts a
  ``quarantine/<digest>`` tombstone; every peer purges it from its
  warm pool, manifest, and correction store on the next sync — a
  poisoned program cannot launder back through a peer any more than
  through a restart.
"""

from __future__ import annotations

import time
from typing import Optional

from .lease import PdMember
from .store import PD_CLAIM_TTL_S, PD_PROGRAM_TTL_S

PROGRAM_PREFIX = "program/"
CLAIM_PREFIX = "claim/"
QUARANTINE_PREFIX = "quarantine/"

# per-sync-tick bound on peer warm-pool adoptions: a manifest read is
# cheap but not free; the long tail trickles in over later ticks
ADOPT_PER_SYNC = 4
# per-sync-tick bound on published entries (MRU-first)
PUBLISH_PER_SYNC = 32


class ProgramRegistry:
    """One member's view of the shared digest registry."""

    def __init__(self, member: PdMember):
        self.member = member
        self._published: set = set()     # entry hexes we pushed
        self._adopt_tried: set = set()   # entry hexes we probed
        self._quarantine_seen: set = set()
        # lifetime counters (coordinator.stats + tidb_tpu_pd_* metrics)
        self.claims = 0                  # claims we won
        self.claim_denials = 0           # claims a live peer held
        self.peer_warm = 0               # entries adopted from peers
        self.quarantine_purged = 0       # tombstones applied locally
        self.published = 0

    # ---- in-flight compile claims ------------------------------------ #

    def try_claim(self, entry_hex: str) -> bool:
        """True = this member holds the claim (go build); False = a
        live peer holds it.  Raises
        PdUnavailable/PdLeaseExpired for the coordinator/caller to map
        to degraded-local (= just build)."""
        store = self.member.store
        key = CLAIM_PREFIX + entry_hex
        now = time.time()
        cur, ver = store.get(key)
        if (isinstance(cur, dict)
                and cur.get("member") != self.member.member_id
                and cur.get("deadline", 0.0) > now):
            self.claim_denials += 1
            return False
        won = store.cas(key, ver,
                        {"member": self.member.member_id,
                         "deadline": now + PD_CLAIM_TTL_S},
                        epoch=self.member.epoch)
        if won:
            self.claims += 1
        else:
            self.claim_denials += 1    # lost the CAS race to a peer
        return won

    def release_claim(self, entry_hex: str) -> None:
        """Drop our claim (build finished or failed) so peers stop
        waiting early instead of waiting out the TTL."""
        store = self.member.store
        key = CLAIM_PREFIX + entry_hex
        cur, _ver = store.get(key)
        if isinstance(cur, dict) and \
                cur.get("member") == self.member.member_id:
            store.delete(key, epoch=self.member.epoch)

    # ---- warm-pool gossip -------------------------------------------- #

    def publish_manifest(self, manifest, now: float = 0.0) -> int:
        """Push our persisted entries' anatomy (MRU-first, bounded) so
        peers can warm-load them by name from the shared cache dir."""
        store = self.member.store
        mid = self.member.member_id
        now = now or time.time()
        pushed = 0
        for entry_hex, meta in manifest.entries_mru()[:PUBLISH_PER_SYNC]:
            if entry_hex in self._published:
                continue
            digest = meta.get("digest", "")
            if not digest:
                continue

            def add(cur, _hex=entry_hex, _meta=meta):
                doc = cur if isinstance(cur, dict) else {}
                entries = doc.setdefault("entries", {})
                entries[_hex] = {"by": mid, "ts": now,
                                 "bytes": _meta.get("bytes", 0),
                                 "family": _meta.get("family", ""),
                                 "capacity": _meta.get("capacity", 0)}
                for hx in sorted(entries):
                    if now - entries[hx].get("ts", 0.0) > \
                            PD_PROGRAM_TTL_S:
                        del entries[hx]
                return doc

            store.txn_update(PROGRAM_PREFIX + digest, add,
                             epoch=self.member.epoch)
            self._published.add(entry_hex)
            self.published += 1
            pushed += 1
        return pushed

    def adopt_from_peers(self, cache, limit: int = ADOPT_PER_SYNC,
                         backend_fp: Optional[str] = None) -> int:
        """Warm-load entries peers published that we never resolved:
        the shared cache dir holds the manifest entry, so this joins its
        capacity to our index, never a build.  ``backend_fp`` is this
        member's device fingerprint (the port's ``load_warm`` keeps only
        entries of it); None calls ``load_warm(entry_hex)`` as the JAX
        package does.  Bounded per tick."""
        store = self.member.store
        mid = self.member.member_id
        adopted = 0
        docs = store.read_prefix(PROGRAM_PREFIX)
        for key in sorted(docs):
            doc, _ver = docs[key]
            entries = doc.get("entries", {}) if isinstance(doc, dict) \
                else {}
            for entry_hex in sorted(entries):
                info = entries[entry_hex]
                if info.get("by") == mid or \
                        entry_hex in self._adopt_tried:
                    continue
                self._adopt_tried.add(entry_hex)
                if (cache.load_warm(entry_hex) if backend_fp is None
                        else cache.load_warm(entry_hex, backend_fp)):
                    self.peer_warm += 1
                    adopted += 1
                if adopted >= limit:
                    return adopted
        return adopted

    # ---- quarantine propagation -------------------------------------- #

    def broadcast_quarantine(self, digest: str) -> None:
        """Our breaker opened on ``digest``: tombstone it for every
        peer (and drop its registry entries — nothing to adopt)."""
        store = self.member.store
        mid = self.member.member_id

        def put(_cur, _d=digest):
            return {"ts": time.time(), "by": mid}

        store.txn_update(QUARANTINE_PREFIX + digest, put,
                         epoch=self.member.epoch)
        store.delete(PROGRAM_PREFIX + digest, epoch=self.member.epoch)
        self._quarantine_seen.add(digest)

    def sync_quarantine(self, cache) -> int:
        """Apply unseen peer tombstones locally: quarantine the digest
        in the compile cache (purges warm pool records, manifest
        entries, and — via the cache — its cost corrections)."""
        store = self.member.store
        applied = 0
        docs = store.read_prefix(QUARANTINE_PREFIX)
        for key in sorted(docs):
            digest = key[len(QUARANTINE_PREFIX):]
            if digest in self._quarantine_seen:
                continue
            self._quarantine_seen.add(digest)
            cache.quarantine(digest)
            self.quarantine_purged += 1
            applied += 1
        return applied

    def stats(self) -> dict:
        return {"claims": self.claims,
                "claim_denials": self.claim_denials,
                "peer_warm": self.peer_warm,
                "published": self.published,
                "quarantine_purged": self.quarantine_purged}


__all__ = ["ProgramRegistry", "PROGRAM_PREFIX", "CLAIM_PREFIX",
           "QUARANTINE_PREFIX", "ADOPT_PER_SYNC", "PUBLISH_PER_SYNC"]
