# ported from tidb_tpu/utils/poolmgr.py @ 9d319cb
"""Global CPU-aware worker-pool manager.

Reference analog: pkg/resourcemanager (resourcemanager.go GlobalResourceManager)
— one process-wide registry of named thread pools sized from the host's
core count, so components BORROW execution slots instead of each owning a
private pool (the reference's "pool of pools" discipline).  Pools are
created on first use, shared across queries/operators, resized live, and
export usage stats to metrics + information_schema (pool introspection).

numpy/XLA host kernels release the GIL, so thread pools scale the
vectorized per-chunk work across cores exactly like the reference's
goroutine pools scale its row-loop work.
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class PoolStats:
    name: str
    workers: int
    weight: float
    submitted: int = 0
    completed: int = 0
    busy: int = 0                  # tasks currently running
    total_wait_s: float = 0.0      # queue wait accumulated
    total_run_s: float = 0.0


@dataclass
class _Pool:
    executor: cf.ThreadPoolExecutor
    stats: PoolStats
    rank: int = 0                  # creation order (nesting DAG order)
    mu: threading.Lock = field(default_factory=threading.Lock)


class PoolManager:
    """Process singleton owning every named worker pool."""

    def __init__(self, cpu: Optional[int] = None,
                 retire_grace_s: float = 5.0):
        self.cpu = cpu or os.cpu_count() or 1
        self._pools: dict[str, _Pool] = {}
        self._retired: list = []       # resized-away executors (draining)
        self._mu = threading.Lock()
        # how long a replaced executor stays submittable before its idle
        # threads are released (covers submit() callers racing a resize)
        self.retire_grace_s = retire_grace_s

    # ---------------- pool lifecycle ---------------- #

    def pool(self, name: str, weight: float = 1.0,
             max_workers: Optional[int] = None) -> cf.ThreadPoolExecutor:
        """Get-or-create the shared pool `name`, sized
        ceil(cpu * weight) capped by max_workers.  Never shut down by
        callers — the manager owns lifecycle."""
        p = self._pools.get(name)
        if p is not None:
            return p.executor
        with self._mu:
            p = self._pools.get(name)
            if p is None:
                n = max(1, math.ceil(self.cpu * weight))
                if max_workers:
                    n = min(n, max_workers)
                ex = cf.ThreadPoolExecutor(
                    max_workers=n, thread_name_prefix=f"pool-{name}")
                p = self._pools[name] = _Pool(
                    ex, PoolStats(name, n, weight),
                    rank=len(self._pools))
            return p.executor

    def ensure(self, name: str, min_workers: int) -> None:
        """Grow (never shrink) a pool to at least `min_workers` — callers
        whose concurrency knob exceeds the default sizing."""
        self.pool(name)
        with self._mu:
            need = self._pools[name].stats.workers < min_workers
        if need:
            self.resize(name, min_workers)

    def resize(self, name: str, workers: int) -> None:
        """Live resize (the reference's pool.Tune): swap in a new
        executor.  The old one stays submittable for a grace window — a
        concurrent submit() that fetched it must not hit 'cannot
        schedule new futures after shutdown' — then a reaper drains it
        with shutdown(wait=False), which lets already-queued work finish
        while releasing the idle worker threads (the previous
        retain-forever policy leaked a full thread set per resize)."""
        workers = max(1, workers)
        with self._mu:
            p = self._pools.get(name)
            if p is None:
                return
            old = p.executor
            self._retired.append(old)
            p.executor = cf.ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix=f"pool-{name}")
            p.stats.workers = workers

        def _reap(ex=old, grace=self.retire_grace_s):
            time.sleep(grace)
            ex.shutdown(wait=False)
            with self._mu:
                try:
                    self._retired.remove(ex)
                except ValueError:
                    pass
        threading.Thread(target=_reap, name=f"pool-reap-{name}",
                         daemon=True).start()

    # ---------------- instrumented submission ---------------- #

    def submit(self, name: str, fn, /, *args, weight: float = 1.0,
               **kw) -> cf.Future:
        # deadlock-free nesting rule: a pool worker's submission QUEUES
        # only when the target pool ranks strictly higher (creation
        # order) — queued-and-awaited edges then form a DAG, so no
        # worker cycle (executor -> apply -> executor) can ever block on
        # itself; same-pool and downhill submissions run caller-inline.
        cur = threading.current_thread().name
        if cur.startswith("pool-"):
            cur_pool = cur[5:].rsplit("_", 1)[0]
            p_cur = self._pools.get(cur_pool)
            p_tgt = self._pools.get(name)
            uphill = (p_cur is not None and p_tgt is not None
                      and p_tgt.rank > p_cur.rank)
            if not uphill:
                f: cf.Future = cf.Future()
                try:
                    f.set_result(fn(*args, **kw))
                except BaseException as e:  # noqa: BLE001 future contract
                    f.set_exception(e)
                return f
        ex = self.pool(name, weight)
        p = self._pools[name]
        t0 = time.monotonic()
        with p.mu:
            p.stats.submitted += 1

        def run():
            t1 = time.monotonic()
            with p.mu:
                p.stats.busy += 1
                p.stats.total_wait_s += t1 - t0
            try:
                return fn(*args, **kw)
            finally:
                with p.mu:
                    p.stats.busy -= 1
                    p.stats.completed += 1
                    p.stats.total_run_s += time.monotonic() - t1
        try:
            return ex.submit(run)
        except RuntimeError:
            # raced a resize past the retire grace: the fetched executor
            # was reaped; the swapped-in one accepts the work
            return self._pools[name].executor.submit(run)

    # ---------------- introspection ---------------- #

    def stats_rows(self) -> list[tuple]:
        """(name, workers, submitted, completed, busy, wait_ms, run_ms)
        for information_schema / metrics."""
        out = []
        with self._mu:
            pools = list(self._pools.values())
        for p in pools:
            with p.mu:
                s = p.stats
                out.append((s.name, s.workers, s.submitted, s.completed,
                            s.busy, round(s.total_wait_s * 1e3, 1),
                            round(s.total_run_s * 1e3, 1)))
        return sorted(out)


MANAGER = PoolManager()

__all__ = ["PoolManager", "MANAGER", "PoolStats"]
