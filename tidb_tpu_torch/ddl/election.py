# ported from tidb_tpu/ddl/election.py @ 3951242
"""Owner election: single-writer lease over the KV meta keyspace.

Reference analog: pkg/owner (etcd campaign/lease, ownerManager).  With
no etcd, the lease lives at a KV meta key as (owner_id, expires_at);
campaign is an atomic compare-and-claim through a KV transaction (the
engine's write-write conflict detection makes concurrent campaigns
serialize), renewal extends the expiry, and a crashed owner's lease
simply times out for the next campaigner — the same liveness contract,
one process or many.
"""

from __future__ import annotations

import json
import threading
import time
import uuid

LEASE_KEY = b"m_owner_"


class OwnerManager:
    def __init__(self, kv, key: str = "ddl", lease_sec: float = 3.0,
                 owner_id: str = ""):
        self.kv = kv
        self.key = LEASE_KEY + key.encode()
        self.lease_sec = lease_sec
        self.owner_id = owner_id or uuid.uuid4().hex[:12]
        self._renew_thread = None
        self._stop = threading.Event()

    # -- lease primitives --------------------------------------------- #

    def _read_lease(self):
        ts = self.kv.alloc_ts()
        raw = self.kv.get(self.key, ts)
        if raw is None:
            return None, 0.0
        d = json.loads(raw.decode())
        return d["id"], d["exp"]

    def _claim(self, require_held: bool) -> bool:
        """Atomic compare-and-claim: the lease READ and WRITE share one
        KV transaction, so two racing campaigns overlap on the key and
        write-write conflict detection aborts one — exactly one winner."""
        txn = self.kv.begin()
        try:
            raw = txn.get(self.key)
            if raw is not None:
                d = json.loads(raw.decode())
                held_by_me = d["id"] == self.owner_id
                live = d["exp"] > time.time()
                if require_held and not (held_by_me and live):
                    txn.rollback()
                    return False
                if not require_held and live and not held_by_me:
                    txn.rollback()
                    return False
            elif require_held:
                txn.rollback()
                return False
            txn.put(self.key, json.dumps(
                {"id": self.owner_id,
                 "exp": time.time() + self.lease_sec}).encode())
            txn.commit()
            return True
        except Exception:
            txn.rollback()
            return False

    # -- API ----------------------------------------------------------- #

    def campaign(self) -> bool:
        """Claim ownership if the lease is free or expired."""
        return self._claim(require_held=False)

    def is_owner(self) -> bool:
        holder, exp = self._read_lease()
        return holder == self.owner_id and exp > time.time()

    def renew(self) -> bool:
        return self._claim(require_held=True)

    def resign(self) -> None:
        """Atomic compare-and-delete: the ownership check and the delete
        share one txn, so resign can never remove a lease another node
        claimed after our check (same serialization as campaign)."""
        txn = self.kv.begin()
        try:
            raw = txn.get(self.key)
            if raw is None or json.loads(raw.decode())["id"] != self.owner_id:
                txn.rollback()
                return
            txn.delete(self.key)
            txn.commit()
        except Exception:
            txn.rollback()

    # -- background renewal (the etcd keepalive analog) ---------------- #

    def start_renewal(self) -> None:
        if self._renew_thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.lease_sec / 3):
                try:
                    self.renew()
                except Exception:
                    pass

        self._renew_thread = threading.Thread(target=loop, daemon=True)
        self._renew_thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._renew_thread is not None:
            self._renew_thread.join(timeout=2)
            self._renew_thread = None
        self.resign()


__all__ = ["OwnerManager"]
