# ported from tidb_tpu/store/kv.py @ 3951242
"""ctypes bindings for the native C++ MVCC KV engine + txn client.

Reference analog: the client side of tikv/client-go/v2 (2PC committer, TSO) +
pkg/kv interfaces (kv.Storage / kv.Transaction / kv.Snapshot, kv/kv.go:218,
657, 693).  The engine itself is the port's copy of the JAX package's
``native/kvstore.cpp`` (``tidb_tpu_torch/native/kvstore.cpp``), built at
first use with g++ into ``tidb_tpu_torch/_build/`` under a name taken
from the hash of its source, as ``copr/cuda/build.py`` names the
kernels; this module is the Go-interface analog:

- KVStore: open/scan/get at a ts (kv.Snapshot)
- Txn: buffered writes (MemBuffer analog) + percolator 2PC commit
  (prewrite all keys primary-first, allocate commit ts, commit primary
  then secondaries — client-go twoPhaseCommitter analog)

The library is loaded with ``ctypes.CDLL`` in its default RTLD_LOCAL
mode: the JAX package's engine exports the same symbols, and a process
that loads both (the parity tests) must keep them apart.  A failed
build raises; nothing falls back to another library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, Optional

_SRC = Path(__file__).resolve().parents[1] / "native" / "kvstore.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# the JAX package's native/Makefile flags for the engine
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")
_build_lock = threading.Lock()
_lib = None


class KVError(RuntimeError):
    def __init__(self, code: int, msg: str = ""):
        super().__init__(f"kv error {code}: {msg or ERR_NAMES.get(code, '?')}")
        self.code = code


ERR_NAMES = {1: "locked", 2: "write conflict", 3: "not found",
             4: "txn mismatch", 5: "already rolled back",
             6: "deadlock", 7: "lock wait timeout", 8: "wal write failed"}
ERR_LOCKED, ERR_WRITE_CONFLICT, ERR_NOT_FOUND = 1, 2, 3
ERR_DEADLOCK, ERR_LOCK_WAIT_TIMEOUT = 6, 7


class DeadlockError(KVError):
    """Waits-for cycle: this transaction was chosen as the victim
    (unistore/tikv/detector.go analog)."""


class LockWaitTimeout(KVError):
    """innodb_lock_wait_timeout analog."""


def library_path() -> Path:
    """Where the engine built from this exact source lives."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libtpukv-{tag}.so"


def build_library() -> Path:
    """Compile the engine with g++ unless this source's library exists;
    the build writes a temporary file and renames it, so a concurrent
    build in another process never loads half a library."""
    so = library_path()
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    out = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed to build {_SRC.name} "
                           f"({out.returncode}):\n{out.stderr}")
    os.replace(tmp, so)
    return so


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
        lib.kv_open.restype = ctypes.c_void_p
        lib.kv_close.argtypes = [ctypes.c_void_p]
        lib.kv_alloc_ts.restype = ctypes.c_uint64
        lib.kv_alloc_ts.argtypes = [ctypes.c_void_p]
        lib.kv_prewrite.restype = ctypes.c_int32
        lib.kv_prewrite.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_uint8]
        lib.kv_commit.restype = ctypes.c_int32
        lib.kv_commit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int32, ctypes.c_uint64,
                                  ctypes.c_uint64]
        lib.kv_rollback.restype = ctypes.c_int32
        lib.kv_rollback.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int32, ctypes.c_uint64]
        lib.kv_get.restype = ctypes.c_int32
        lib.kv_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_int32, ctypes.c_uint64,
                               ctypes.POINTER(ctypes.c_char_p),
                               ctypes.POINTER(ctypes.c_int32)]
        lib.kv_scan.restype = ctypes.c_int32
        lib.kv_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_uint64, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8)]
        lib.kv_versions.restype = ctypes.c_int32
        lib.kv_versions.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8)]
        lib.kv_gc.restype = ctypes.c_int64
        lib.kv_gc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.kv_num_keys.restype = ctypes.c_int64
        lib.kv_num_keys.argtypes = [ctypes.c_void_p]
        lib.kv_flush.restype = ctypes.c_int64
        lib.kv_flush.argtypes = [ctypes.c_void_p]
        lib.kv_run_count.restype = ctypes.c_int64
        lib.kv_run_count.argtypes = [ctypes.c_void_p]
        lib.kv_set_flush_threshold.restype = None
        lib.kv_set_flush_threshold.argtypes = [ctypes.c_void_p,
                                               ctypes.c_int64]
        lib.kv_open_at.restype = ctypes.c_void_p
        lib.kv_open_at.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                   ctypes.c_uint8]
        lib.kv_checkpoint.restype = ctypes.c_int64
        lib.kv_checkpoint.argtypes = [ctypes.c_void_p]
        lib.kv_pessimistic_lock.restype = ctypes.c_int32
        lib.kv_pessimistic_lock.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_int32]
        lib.kv_pessimistic_rollback.restype = ctypes.c_int32
        lib.kv_pessimistic_rollback.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_uint64]
        _lib = lib
    return _lib


class KVStore:
    """kv.Storage analog over the native engine (embedded TSO).

    `path` (a file prefix, e.g. "<dir>/kv") makes the store durable:
    committed writes append to <path>.wal; checkpoint() compacts the state
    into <path>.snap and truncates the log; reopening the same path
    replays both.  `sync` fdatasyncs every commit record."""

    def __init__(self, path: Optional[str] = None, sync: bool = False,
                 keyspace: str = ""):
        self._lib = _load_lib()
        self.path = path
        self._ts_samples: list = []    # (wallclock, ts) for stale reads
        # leaf lock for the sample index: alloc_ts runs on every
        # statement thread, and the thinning pass is a read-modify-write
        # that would drop concurrent appends without it
        self._ts_mu = threading.Lock()
        # close() runs these FIRST (watch pollers etc. join their
        # threads) so no background caller holds the native handle when
        # it frees — a poller racing kv_close segfaulted in the C lib
        self._closers: list = []
        # keyspace (pkg/keyspace analog): a tenant prefix transparently
        # applied to every key, so tenants sharing one physical store
        # cannot observe each other's keys.  "" = the null keyspace.
        self._ks = (keyspace.encode() + b"\x00") if keyspace else b""
        if path is None:
            self._h = ctypes.c_void_p(self._lib.kv_open())
        else:
            p = os.fsencode(path)
            self._h = ctypes.c_void_p(
                self._lib.kv_open_at(p, len(p), 1 if sync else 0))
            if not self._h:
                raise KVError(0, f"cannot open WAL at {path!r} "
                                 "(unwritable directory?)")

    def checkpoint(self) -> int:
        """Compact to <path>.snap + truncate the WAL (BR snapshot-backup
        seam; -1 when in-memory)."""
        n = int(self._lib.kv_checkpoint(self._h))
        if n == -2:
            raise KVError(0, "checkpoint could not reopen the WAL; "
                             "store is no longer durable")
        return n

    def close(self):
        if self._h:
            for cb in list(self._closers):
                try:
                    cb()
                except Exception:
                    pass
            self._lib.kv_close(self._h)
            self._h = None

    def _require_open(self):
        if not self._h:
            raise KVError(-98, "store closed")

    def alloc_ts(self) -> int:
        """TSO allocation (PD analog).  Samples a coarse wallclock->ts
        index so stale reads (AS OF TIMESTAMP, sessiontxn/staleread) can
        map a datetime back to a logical snapshot ts."""
        import time as _time
        self._require_open()
        ts = int(self._lib.kv_alloc_ts(self._h))
        with self._ts_mu:
            self._ts_samples.append((_time.time(), ts))
            if len(self._ts_samples) > 200_000:
                # keep recency exact, thin the old half (staleness
                # windows that far back only need coarse resolution)
                old = self._ts_samples[:100_000:2]
                self._ts_samples = old + self._ts_samples[100_000:]
        return ts

    def ts_at_time(self, epoch_seconds: float) -> int:
        """Largest sampled ts allocated at or before the wallclock time
        (the TSO physical-time mapping of the reference, staleread
        processor.go).  Raises if the time predates the store.  The
        sample index is in-memory only: after reopening a persistent
        store, datetime staleness spans only the current process's
        lifetime (raw integer ts literals always work)."""
        import bisect
        with self._ts_mu:
            i = bisect.bisect_right(self._ts_samples,
                                    (epoch_seconds, float("inf")))
            if i == 0:
                raise KVError(0,
                              "requested staleness predates the store")
            return self._ts_samples[i - 1][1]

    def begin(self, pessimistic: bool = False) -> "Txn":
        return Txn(self, self.alloc_ts(), pessimistic=pessimistic)

    # -- keyspace (tenant prefix) -------------------------------------- #

    def with_keyspace(self, keyspace: str) -> "KVStore":
        """A VIEW of this store under a tenant keyspace: shares the
        engine handle and TSO, prefixes every key (pkg/keyspace)."""
        import copy as _copy
        view = _copy.copy(self)
        view._ks = (keyspace.encode() + b"\x00") if keyspace else b""
        return view

    def _pk(self, key: bytes) -> bytes:
        return self._ks + key if self._ks else key

    def _strip(self, key: bytes) -> bytes:
        return key[len(self._ks):] if self._ks else key

    def _ks_end(self) -> bytes:
        ba = bytearray(self._ks)
        for i in reversed(range(len(ba))):
            if ba[i] != 0xFF:
                ba[i] += 1
                return bytes(ba[: i + 1])
        return b""

    # -- snapshot reads ------------------------------------------------ #

    def get(self, key: bytes, ts: int) -> Optional[bytes]:
        self._require_open()
        key = self._pk(key)
        out = ctypes.c_char_p()
        out_len = ctypes.c_int32()
        rc = self._lib.kv_get(self._h, key, len(key), ts,
                              ctypes.byref(out), ctypes.byref(out_len))
        if rc == ERR_NOT_FOUND:
            return None
        if rc != 0:
            raise KVError(rc)
        return ctypes.string_at(out, out_len.value)

    def scan(self, start: bytes, end: bytes, ts: int,
             limit: int = 1 << 30, page_bytes: int = 1 << 20
             ) -> Iterator[tuple[bytes, bytes]]:
        """Paged snapshot scan (the kv paging analog, SURVEY.md §5.7)."""
        self._require_open()
        buf = ctypes.create_string_buffer(page_bytes)
        cur = self._pk(start)
        end = self._pk(end) if end else (self._ks_end() if self._ks else end)
        remaining = limit
        while remaining > 0:
            used = ctypes.c_int64()
            trunc = ctypes.c_uint8()
            rc = self._lib.kv_scan(self._h, cur, len(cur), end, len(end), ts,
                                   min(remaining, 1 << 20), buf, page_bytes,
                                   ctypes.byref(used), ctypes.byref(trunc))
            if rc < 0:
                raise KVError(-rc)
            if rc == 0 and trunc.value:
                # a single record exceeds the page: grow and retry
                page_bytes *= 4
                buf = ctypes.create_string_buffer(page_bytes)
                continue
            data = buf.raw[: used.value]
            off = 0
            last_key = None
            for _ in range(rc):
                klen = int.from_bytes(data[off:off + 4], "little"); off += 4
                k = data[off:off + klen]; off += klen
                vlen = int.from_bytes(data[off:off + 4], "little"); off += 4
                v = data[off:off + vlen]; off += vlen
                last_key = k
                yield self._strip(k), v
                remaining -= 1
            if not trunc.value or last_key is None:
                return
            cur = last_key + b"\x00"

    def versions(self, key: bytes, max_versions: int = 64
                 ) -> tuple[list[tuple[int, Optional[bytes]]], bool]:
        """MVCC history of one key, newest-first: [(commit_ts, value or
        None-for-delete)], plus a truncation flag.  Served straight from
        the native version chains (memtable + runs) — the status API's
        /mvcc handler reads this instead of probing every ts."""
        key = self._pk(key)
        buf = ctypes.create_string_buffer(1 << 20)
        used = ctypes.c_int64()
        trunc = ctypes.c_uint8()
        n = int(self._lib.kv_versions(self._h, key, len(key), max_versions,
                                      buf, len(buf), ctypes.byref(used),
                                      ctypes.byref(trunc)))
        out: list[tuple[int, Optional[bytes]]] = []
        raw = buf.raw[:used.value]
        off = 0
        import struct as _struct
        for _ in range(max(n, 0)):
            ts, op, vlen = _struct.unpack_from("<QBi", raw, off)
            off += 13
            val = raw[off:off + vlen] if op == 0 else None
            off += max(vlen, 0)
            out.append((ts, val))
        return out, bool(trunc.value)

    def gc(self, safepoint: int) -> int:
        return int(self._lib.kv_gc(self._h, safepoint))

    def num_keys(self) -> int:
        return int(self._lib.kv_num_keys(self._h))

    # ---------------- LSM controls (immutable sorted runs) ------------ #

    def flush(self) -> int:
        """Freeze unlocked memtable keys into an immutable sorted run
        (bloom-filtered, binary-searched); returns keys moved."""
        return int(self._lib.kv_flush(self._h))

    def run_count(self) -> int:
        return int(self._lib.kv_run_count(self._h))

    def set_flush_threshold(self, n: int) -> None:
        """Memtable key count that triggers an automatic flush at
        commit time (amortized check); n <= 0 disables auto-flush."""
        self._lib.kv_set_flush_threshold(self._h, int(n))


_UNSET = object()   # savepoint sentinel: key absent from the membuffer


@dataclass
class Txn:
    """Transaction: membuffer + percolator 2PC on commit (client-go
    twoPhaseCommitter analog).  Pessimistic mode locks every written key
    at DML time (KvPessimisticLock) so conflicting writers BLOCK instead
    of failing at commit; a waits-for cycle aborts the requester
    (DeadlockError)."""
    store: KVStore
    start_ts: int
    mutations: dict = field(default_factory=dict)  # key -> value|None(delete)
    committed: bool = False
    pessimistic: bool = False
    locked: set = field(default_factory=set)
    lock_wait_ms: int = 3000
    for_update_ts: int = 0       # latest lock acquisition ts
    _undo: Optional[dict] = None  # active statement savepoint (undo delta)

    def put(self, key: bytes, value: bytes):
        key = self.store._pk(key)
        if self.pessimistic:
            self._lock_raw([key])
        self._record_undo(key)
        self.mutations[key] = value

    def delete(self, key: bytes):
        key = self.store._pk(key)
        if self.pessimistic:
            self._lock_raw([key])
        self._record_undo(key)
        self.mutations[key] = None

    def lock_keys(self, keys, wait_ms: Optional[int] = None):
        self._lock_raw([self.store._pk(k) for k in keys], wait_ms)

    def _lock_raw(self, keys, wait_ms: Optional[int] = None):
        """Acquire pessimistic locks on PREFIXED keys (SELECT FOR UPDATE /
        DML locking).  for_update_ts is allocated fresh so commits between
        start_ts and now are tolerated — the pessimistic-mode contract."""
        lib = self.store._lib
        h = self.store._h
        wait = self.lock_wait_ms if wait_ms is None else wait_ms
        primary = next(iter(sorted(self.locked | set(keys))))
        for k in keys:
            if k in self.locked:
                continue
            # a commit can land between our for_update_ts and the wait's
            # end; the pessimistic protocol refreshes for_update_ts and
            # retries (client-go's WriteConflict handling)
            for _ in range(64):
                for_update_ts = self.store.alloc_ts()
                self.for_update_ts = max(self.for_update_ts, for_update_ts)
                rc = lib.kv_pessimistic_lock(h, k, len(k), primary,
                                             len(primary), self.start_ts,
                                             for_update_ts, wait)
                if rc != ERR_WRITE_CONFLICT:
                    break
            if rc == ERR_DEADLOCK:
                self.rollback()
                raise DeadlockError(rc, f"lock {k!r}")
            if rc == ERR_LOCK_WAIT_TIMEOUT:
                raise LockWaitTimeout(rc, f"lock {k!r}")
            if rc != 0:
                raise KVError(rc, f"pessimistic lock {k!r}")
            self.locked.add(k)

    @property
    def read_ts(self) -> int:
        """Pessimistic reads see everything up to the lock acquisition
        (for_update_ts); optimistic reads stay at the start snapshot."""
        return max(self.start_ts, self.for_update_ts)

    def get(self, key: bytes) -> Optional[bytes]:
        pk = self.store._pk(key)
        if pk in self.mutations:
            return self.mutations[pk]
        return self.store.get(key, self.read_ts)

    def scan(self, start: bytes, end: bytes, **kw):
        """Union-scan analog: merge membuffer over the snapshot.  Yields
        UNPREFIXED keys; the membuffer holds prefixed ones."""
        snap = dict(self.store.scan(start, end, self.read_ts, **kw))
        for pk, v in self.mutations.items():
            k = self.store._strip(pk)
            if start <= k < (end or k + b"\x00"):
                if v is None:
                    snap.pop(k, None)
                else:
                    snap[k] = v
        for k in sorted(snap):
            yield k, snap[k]

    def commit(self) -> int:
        if not self.mutations:
            self._release_unwritten_locks()
            self.committed = True
            return self.start_ts
        lib = self.store._lib
        h = self.store._h
        keys = sorted(self.mutations)
        primary = keys[0]
        prewritten = []
        for k in keys:
            v = self.mutations[k]
            op = 1 if v is None else 0
            rc = lib.kv_prewrite(h, k, len(k), v or b"", len(v or b""),
                                 primary, len(primary), self.start_ts, op)
            if rc != 0:
                for pk in prewritten:
                    lib.kv_rollback(h, pk, len(pk), self.start_ts)
                raise KVError(rc, f"prewrite {k!r}")
            prewritten.append(k)
        commit_ts = self.store.alloc_ts()
        # commit primary first: the txn is durable once the primary commits
        for k in [primary] + [k for k in keys if k != primary]:
            rc = lib.kv_commit(h, k, len(k), self.start_ts, commit_ts)
            if rc != 0:
                raise KVError(rc, f"commit {k!r}")
        self._release_unwritten_locks()
        self.committed = True
        return commit_ts

    def savepoint(self) -> dict:
        """Statement-level savepoint as an UNDO DELTA: put/delete record a
        key's prior membuffer state on first touch, so staging costs
        O(statement writes), not O(transaction writes) — the client-go
        memdb staging-checkpoint discipline.  Restoring with rollback_to()
        undoes every write since; release_savepoint() on statement success
        stops the recording."""
        self._undo = {}
        return self._undo

    def rollback_to(self, sp: dict):
        for k, prior in sp.items():
            if prior is _UNSET:
                self.mutations.pop(k, None)
            else:
                self.mutations[k] = prior
        self._undo = None

    def release_savepoint(self):
        self._undo = None

    def _record_undo(self, key: bytes):
        if self._undo is not None and key not in self._undo:
            self._undo[key] = self.mutations.get(key, _UNSET)

    def _release_unwritten_locks(self):
        """Pessimistic locks on keys that were locked but never written
        (e.g. SELECT FOR UPDATE rows left unchanged) release at commit."""
        lib = self.store._lib
        h = self.store._h
        for k in self.locked - set(self.mutations):
            lib.kv_pessimistic_rollback(h, k, len(k), self.start_ts)
        self.locked.clear()

    def rollback(self):
        lib = self.store._lib
        h = self.store._h
        for k in self.mutations:
            lib.kv_rollback(h, k, len(k), self.start_ts)
        for k in self.locked - set(self.mutations):
            lib.kv_pessimistic_rollback(h, k, len(k), self.start_ts)
        self.locked.clear()
        self.mutations.clear()


__all__ = ["KVStore", "Txn", "KVError", "DeadlockError", "LockWaitTimeout",
           "ERR_LOCKED", "ERR_WRITE_CONFLICT", "ERR_DEADLOCK",
           "ERR_LOCK_WAIT_TIMEOUT"]
