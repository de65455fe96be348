# ported from tidb_tpu/utils/watch.py @ 6233200
"""etcd-style watch/broadcast plane over the KV store.

Reference analog: the etcd watch channels the reference hangs off
pkg/domain (domain.go GlobalVarsWatcher / bindinfo + privilege update
channels, owner/manager.go notifications).  PD's etcd is replaced here by
the MVCC store itself: each channel is a revisioned log under a meta key
prefix, writers bump the channel revision transactionally, and watchers
either receive the payload in-process (same Domain: immediate callback)
or poll the revision counter cheaply (~one KV get) from other processes
sharing the store — the same delivery model etcd gives the reference,
minus the gRPC stream.

Channels in use: "sysvar" (SET GLOBAL fan-out), "privilege"
(GRANT/REVOKE/CREATE USER cache invalidation).
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Optional

M_WATCH = b"m\x00watch\x00"        # <channel>\x00rev -> int; \x00log\x00<rev8> -> payload


def _rev_key(channel: str) -> bytes:
    return M_WATCH + channel.encode() + b"\x00rev"


def _log_key(channel: str, rev: int) -> bytes:
    return M_WATCH + channel.encode() + b"\x00log\x00" + rev.to_bytes(8, "big")


class WatchHub:
    """Per-Domain pub/sub with KV-persisted revision log."""

    def __init__(self, kv=None, origin: Optional[str] = None):
        self.kv = kv
        self.origin = origin or f"{id(self):x}.{time.time_ns():x}"
        self._subs: dict[str, list[Callable]] = defaultdict(list)
        self._seen: dict[str, int] = {}
        self._mu = threading.Lock()
        self._poller: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.poll_interval = 0.2

    # ---------------- write side ---------------- #

    def notify(self, channel: str, payload: dict) -> int:
        """Publish: persist to the channel log (new revision) and deliver
        to in-process subscribers immediately.  Returns the revision."""
        payload = dict(payload, _origin=self.origin)
        rev = 0
        if self.kv is not None:
            for _ in range(16):            # txn-conflict retry
                try:
                    txn = self.kv.begin()
                    cur = self.kv.get(_rev_key(channel), txn.start_ts)
                    rev = (int(cur) if cur else 0) + 1
                    txn.put(_rev_key(channel), str(rev).encode())
                    txn.put(_log_key(channel, rev),
                            json.dumps(payload, default=str).encode())
                    txn.commit()
                    break
                except Exception:
                    time.sleep(0.001)
            else:
                raise RuntimeError(f"watch notify on {channel} kept "
                                   "conflicting")
            with self._mu:
                self._seen[channel] = max(self._seen.get(channel, 0), rev)
        self._deliver(channel, payload)
        return rev

    # ---------------- read side ---------------- #

    def subscribe(self, channel: str, cb: Callable[[dict], Any]) -> None:
        with self._mu:
            self._subs[channel].append(cb)
            if channel not in self._seen:
                self._seen[channel] = self.revision(channel)
        if self.kv is not None:
            self._ensure_poller()

    def revision(self, channel: str) -> int:
        if self.kv is None:
            return 0
        cur = self.kv.get(_rev_key(channel), self.kv.alloc_ts())
        return int(cur) if cur else 0

    def poll(self, channel: str, since: int) -> tuple[int, list[dict]]:
        """(latest revision, payloads after `since`) — the cross-process
        read path; one cheap get when nothing changed."""
        rev = self.revision(channel)
        if rev <= since or self.kv is None:
            return rev, []
        lo = _log_key(channel, since + 1)
        hi = _log_key(channel, rev) + b"\xff"
        out = []
        for _k, v in self.kv.scan(lo, hi, self.kv.alloc_ts()):
            try:
                out.append(json.loads(v))
            except ValueError:
                pass
        return rev, out

    # ---------------- poller ---------------- #

    def _deliver(self, channel: str, payload: dict) -> None:
        for cb in list(self._subs.get(channel, ())):
            try:
                cb(payload)
            except Exception:
                pass

    def _ensure_poller(self) -> None:
        with self._mu:
            if self._poller is not None and self._poller.is_alive():
                return
            self._stop.clear()
            self._poller = threading.Thread(target=self._poll_loop,
                                            daemon=True,
                                            name="watch-poller")
            self._poller.start()
            # the store joins this poller BEFORE freeing its native
            # handle (KVStore.close closers), preventing use-after-free
            closers = getattr(self.kv, "_closers", None)
            if closers is not None and self._shutdown not in closers:
                closers.append(self._shutdown)

    def _shutdown(self) -> None:
        self._stop.set()
        p = self._poller
        if p is not None and p.is_alive() \
                and p is not threading.current_thread():
            p.join(timeout=5.0)

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            if not getattr(self.kv, "_h", None):
                return                 # store closed under us
            with self._mu:
                channels = list(self._subs)
            for ch in channels:
                try:
                    rev, payloads = self.poll(ch, self._seen.get(ch, 0))
                except Exception:
                    continue
                with self._mu:
                    self._seen[ch] = max(self._seen.get(ch, 0), rev)
                for p in payloads:
                    if p.get("_origin") == self.origin:
                        continue       # already delivered in-process
                    self._deliver(ch, p)

    def close(self) -> None:
        self._stop.set()


__all__ = ["WatchHub"]
