# ported from tidb_tpu/store/remote.py @ ba365f2
"""Distributed store client: SQL layer -> remote store processes.

Reference analog: pkg/kv/kv.go:316 — the kv.Client seam that lets the
SAME SQL/planner/executor stack run against an embedded store or remote
TiKV processes, with the region cache routing shards to stores and the
copIterator healing store failures (pkg/store/copr/region_cache.go,
coprocessor.go:337).  Here:

- ``RemoteCluster`` boots N ``tidb_tpu_torch.store.server`` processes
  (the store role: host engines over numpy, started with
  ``CUDA_VISIBLE_DEVICES=""`` so none creates a CUDA context — the JAX
  package starts them with ``JAX_PLATFORMS=cpu``) and replicates tables
  to each (replica placement);
- ``RemoteCopClient`` implements the CopClient surface: it ships the
  serialized DAG + row ranges to each store owning shards (framed-pickle
  RPC), merges the returned PARTIAL aggregation states with the same
  merge/finalize code the device path uses, and falls back to the inner
  local client (``inner``, a ``CopClient`` on the card unless asked for
  the CPU) for shapes outside the remote scope (shuffle joins, windows,
  device-only strategies) and when every store is dead;
- a dead store surfaces as RegionError(STORE_UNAVAILABLE) -> the
  placement heals (shards re-home to surviving replicas) and the dispatch
  retries — the kill-a-store-mid-query path proven in
  tests/test_remote_store.py (the port's: tests/test_torch_remote.py).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import weakref
from pathlib import Path
from typing import Optional

import numpy as np

from ..copr import dag as D
from ..copr.aggregate import (finalize, finalize_sorted,
                              merge_sorted_states, merge_states)
from .backoff import STORE_UNAVAILABLE, Backoffer, RegionError
from .client import CopClient, CopResult
from .placement import Placement
from .rpc import recv_msg, send_msg


class RemoteStore:
    """One store connection; socket failures surface as RegionErrors so
    the shared heal/retry discipline applies."""

    def __init__(self, store_id: int, port: int):
        self.store_id = store_id
        self.port = port
        self._sock: Optional[socket.socket] = None
        self._mu = threading.Lock()

    def _conn(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(("127.0.0.1", self.port),
                                         timeout=30)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def request(self, msg):
        with self._mu:
            try:
                sock = self._conn()
                send_msg(sock, msg)
                return recv_msg(sock)
            except (ConnectionError, OSError) as exc:
                self.close()
                err = RegionError(STORE_UNAVAILABLE)
                err.store = self.store_id
                raise err from exc

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


class RemoteCluster:
    """Boot + own N store server processes (mock-PD + store lifecycle)."""

    def __init__(self, n_stores: int = 2):
        self.procs: list = []
        self.stores: list[RemoteStore] = []
        # the store role is the host's: no store process may see a GPU
        root = str(Path(__file__).resolve().parents[2])
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.pathsep.join(
                       [root] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        # all started before any is waited for: each store process pays
        # its own `import torch` (the DAG classes it unpickles need it)
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tidb_tpu_torch.store.server"],
            stdout=subprocess.PIPE, env=env, text=True)
            for _ in range(n_stores)]
        for i, p in enumerate(self.procs):
            line = p.stdout.readline().strip()
            if not line.startswith("PORT "):
                self.close()
                raise RuntimeError(f"store {i} did not start: {line!r}")
            self.stores.append(RemoteStore(i, int(line.split()[1])))

    def kill_store(self, i: int) -> None:
        self.procs[i].kill()
        self.procs[i].wait()
        self.stores[i].close()

    def live_ids(self) -> list[int]:
        return [i for i, p in enumerate(self.procs) if p.poll() is None]

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for s in self.stores:
            s.close()


class _Unsupported(Exception):
    pass


class RemoteCopClient:
    """CopClient-compatible dispatcher against a RemoteCluster.

    Tables ship lazily: the first dispatch of a snapshot replicates its
    columns to every live store under a per-(snapshot, epoch) key; a
    remote placement (shards round-robined over store processes) routes
    each dispatch; anything the remote scope doesn't cover delegates to
    the inner local CopClient (`self.inner`)."""

    def __init__(self, cluster: RemoteCluster, device="cuda",
                 n_devices: int = 1):
        self.cluster = cluster
        self.inner = CopClient(device, n_devices)
        self._meta: dict = {}       # id(snap) -> _SnapMeta
        self._mu = threading.Lock()
        self.remote_dispatches = 0
        self.local_fallbacks = 0
        self.preflight_exclusions = 0
        self.n_shards = 4

    # attribute surface (result cache counters, device_mem_cap, ...)
    # delegates to the inner client so ExecContext wiring is unchanged
    def __getattr__(self, name):
        return getattr(self.inner, name)

    # ---------------- snapshot -> remote state ---------------- #

    def _snap_meta(self, snap):
        """Per-snapshot remote routing state.  The routing placement here
        is the remote region cache (shards -> store PROCESSES) and is
        private to this client; the snapshot's own placement stays the
        local device-slot map used by the inner fallback."""
        key = id(snap)
        with self._mu:
            ent = self._meta.get(key)
            if ent is not None and ent["ref"]() is snap \
                    and ent["epoch"] == snap.epoch:
                return ent
        table = f"t{key}_e{snap.epoch}"
        placement = Placement.even(snap.num_rows,
                                   max(self.n_shards,
                                       len(self.cluster.stores)))
        placement.rebalance(len(self.cluster.stores))
        ent = {"ref": weakref.ref(snap), "epoch": snap.epoch,
               "table": table, "placement": placement, "shipped": set()}
        with self._mu:
            self._meta[key] = ent
        return ent

    def _ship(self, ent, snap, store: RemoteStore):
        if store.store_id in ent["shipped"]:
            return
        store.request(("load", ent["table"], snap.epoch, snap.names,
                       snap.dtypes, snap.columns))
        ent["shipped"].add(store.store_id)

    def _store_ranges(self, placement: Placement):
        """store_id -> [(lo, hi), ...] over live shards."""
        by_store: dict = {}
        for sh in placement.shards:
            if sh.num_rows:
                by_store.setdefault(sh.store, []).append((sh.lo, sh.hi))
        return by_store

    # ---------------- dispatch ---------------- #

    def execute_agg(self, agg: D.Aggregation, snap, key_meta,
                    aux_cols=()) -> CopResult:
        if aux_cols:
            return self.inner.execute_agg(agg, snap, key_meta, aux_cols)
        try:
            return self._dispatch(
                snap, lambda ent, rc: self._agg_remote(agg, snap, ent,
                                                       key_meta, rc))
        except _Unsupported:
            with self._mu:
                self.local_fallbacks += 1
            return self.inner.execute_agg(agg, snap, key_meta, aux_cols)

    def execute_rows(self, root: D.CopNode, snap, out_dtypes,
                     dictionaries=None, aux_cols=()):
        if aux_cols:
            return self.inner.execute_rows(root, snap, out_dtypes,
                                           dictionaries, aux_cols)
        try:
            return self._dispatch(
                snap, lambda ent, rc: self._rows_remote(root, snap, ent,
                                                        out_dtypes,
                                                        dictionaries, rc))
        except _Unsupported:
            with self._mu:
                self.local_fallbacks += 1
            return self.inner.execute_rows(root, snap, out_dtypes,
                                           dictionaries, aux_cols)

    def _dispatch(self, snap, fn):
        from ..copr.coordinator import check_killed
        bo = Backoffer(max_sleep_ms=5000.0)
        # batch-cop partial retry (copr/batch_coprocessor.go): stores
        # whose batched task set already succeeded this round are not
        # re-executed after another store's failure heals the placement —
        # only moved/failed range sets re-dispatch
        round_cache: dict = {}
        while True:
            check_killed()
            ent = self._snap_meta(snap)
            self._preflight_liveness(ent)
            try:
                return fn(ent, round_cache)
            except RegionError as e:
                bo.backoff(e.kind, e)
                ent["placement"].heal(e)
                ent["shipped"].discard(getattr(e, "store", None))

    def _preflight_liveness(self, ent) -> None:
        """Store liveness probe BEFORE dispatch (copr/mpp_probe.go
        analog): a store whose process died is excluded from the routing
        placement up front, so the fan-out never pays a failed round
        against it."""
        live = set(self.cluster.live_ids())
        dead = {sh.store for sh in ent["placement"].shards
                if sh.num_rows and sh.store < len(self.cluster.stores)
                and sh.store not in live}
        for sid in dead:
            ent["placement"].exclude_store(sid)
            with self._mu:
                self.preflight_exclusions += 1

    def _per_store(self, ent, snap, build_msg, round_cache=None):
        """Fan a request out to every store owning live shards, ONE
        batched request per store covering all its ranges (the
        batch-coprocessor discipline, copr/batch_coprocessor.go).  A
        store failure mid-fan-out aborts this round with its RegionError
        (the retry loop heals and re-fans-out); `round_cache` carries the
        successful (store, ranges) results across those retries so only
        moved/failed task sets re-execute."""
        import concurrent.futures as cf
        by_store = self._store_ranges(ent["placement"])
        if not by_store:
            raise _Unsupported()

        def one(sid, ranges):
            key = (sid, tuple(map(tuple, ranges)))
            if round_cache is not None and key in round_cache:
                return round_cache[key]
            if sid >= len(self.cluster.stores):
                raise _Unsupported()   # every real store excluded
            store = self.cluster.stores[sid]
            self._ship(ent, snap, store)
            resp = store.request(build_msg(ent["table"], ranges))
            if resp[0] == "err":
                if resp[1] == "stale_epoch":
                    ent["shipped"].discard(sid)
                    err = RegionError(STORE_UNAVAILABLE)
                    err.store = sid
                    raise err
                raise _Unsupported()
            if round_cache is not None:
                round_cache[key] = resp[1]
            return resp[1]
        with self._mu:
            self.remote_dispatches += 1
        items = sorted(by_store.items())
        if len(items) == 1:
            return [one(*items[0])]
        with cf.ThreadPoolExecutor(max_workers=len(items)) as ex:
            futs = [ex.submit(one, sid, rngs) for sid, rngs in items]
            return [f.result() for f in futs]

    def _agg_remote(self, agg, snap, ent, key_meta,
                    round_cache=None) -> CopResult:
        per_store = self._per_store(
            ent, snap,
            lambda table, ranges: ("exec_agg", table, snap.epoch, agg,
                                   ranges), round_cache)
        if agg.strategy in D.HOST_MERGE_STRATEGIES:
            merged = merge_sorted_states(agg, per_store)
            key_cols, agg_cols = finalize_sorted(agg, merged, key_meta)
        else:
            merged = merge_states(per_store)
            key_cols, agg_cols = finalize(agg, merged, key_meta)
        return CopResult(agg_cols, key_cols)

    def _rows_remote(self, root, snap, ent, out_dtypes, dictionaries,
                     round_cache=None):
        from ..chunk.column import Column
        per_store = self._per_store(
            ent, snap,
            lambda table, ranges: ("exec_rows", table, snap.epoch, root,
                                   ranges, tuple(out_dtypes)), round_cache)
        cols = [Column.concat([st[j] for st in per_store])
                for j in range(len(out_dtypes))]
        if dictionaries:
            for j, d in dictionaries.items():
                if j < len(cols) and cols[j].dictionary is None:
                    cols[j].dictionary = d
        return cols


__all__ = ["RemoteCluster", "RemoteCopClient", "RemoteStore"]
