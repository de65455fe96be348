# ported from tidb_tpu/ddl/owner.py @ 3951242
# (the backfill's handle scan waits out a concurrent writer's prewrite
# lock under a Backoffer, where the JAX package's raises KVError: locked;
# the DXF multi-node backfill is left out)
"""Online DDL owner worker: F1 state machine + parallel index backfill.

Reference analog: pkg/ddl job_scheduler.go/job_worker.go (owner loop,
transitOneJobStep), index.go state machine none -> delete-only ->
write-only -> write-reorganization -> public (index.go:880-888), and the
DXF-style distributed backfill (backfilling_dist_*.go): the handle space
splits into subtask ranges executed by a worker pool, with progress
checkpointed per job so a restarted owner resumes mid-backfill.

Single-process adaptation: schema-version waits collapse (every session
sees the bumped version immediately — the <=1-lease F1 wait is a no-op
with one node), but state transitions, job persistence, checkpointing,
and the concurrent-write contract (write path honors index states) are
kept, because they are the correctness surface the tests exercise.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..session.catalog import DuplicateKeyError, IndexInfo
from ..store.backoff import TXN_LOCK, Backoffer
from ..store.kv import ERR_LOCKED, KVError
from .jobs import DDLJob, JobStorage

BATCH = 256          # rows per backfill txn (tidb_ddl_reorg_batch_size)
SUBTASK = 4096       # handles per subtask range (DXF subtask granularity)
LOCK_WAIT_MS = 20_000.0   # the handle scan's budget for waiting out locks


class DDLError(RuntimeError):
    pass


class DDLExecutor:
    """Owner-side DDL executor: one background worker drains the job
    queue; sessions block on their job (the reference's session wait on
    job done, ddl/executor.go doDDLJob)."""

    def __init__(self, domain):
        self.domain = domain
        self.storage = JobStorage(domain.kv)
        self._queue: "queue.Queue[DDLJob]" = queue.Queue()
        self._events: dict[int, threading.Event] = {}
        self._excs: dict[int, BaseException] = {}
        self._next_job_id = 0
        self._mu = threading.Lock()
        self._closed = False
        self._worker = threading.Thread(target=self._owner_loop,
                                        name="ddl-owner", daemon=True)
        self._worker.start()
        # owner-failover resume (reorg.go analog): re-queue jobs that were
        # queued/running when the previous owner stopped; their reorg
        # checkpoint makes the backfill skip completed subtask ranges
        for done_job in self.storage.history():
            self._next_job_id = max(self._next_job_id, done_job.job_id)
        for job in self.storage.pending():
            self._next_job_id = max(self._next_job_id, job.job_id)
            self._queue.put(job)

    def close(self):
        self._closed = True
        self._queue.put(None)

    # ---------------- enqueue + wait ---------------- #

    def run_job(self, job_type: str, db: str, table: str, args: dict,
                timeout: float = 120.0) -> DDLJob:
        with self._mu:
            self._next_job_id += 1
            job = DDLJob(self._next_job_id, job_type, db, table, args,
                         start_time=time.time())
            ev = self._events[job.job_id] = threading.Event()
        self.storage.save(job)
        self._queue.put(job)
        if not ev.wait(timeout):
            # deregister the waiter so the eventually-finishing job doesn't
            # leak _events/_excs entries; the job itself keeps running and
            # its completion lands in history (ADMIN SHOW DDL JOBS)
            with self._mu:
                self._events.pop(job.job_id, None)
                self._excs.pop(job.job_id, None)
            raise DDLError(f"DDL job {job.job_id} timed out")
        with self._mu:
            del self._events[job.job_id]
            exc = self._excs.pop(job.job_id, None)
        if job.state == "failed":
            if exc is not None:
                raise exc           # original type (e.g. DuplicateKeyError)
            raise DDLError(job.error)
        return job

    # ---------------- owner loop ---------------- #

    def _owner_loop(self):
        while not self._closed:
            job = self._queue.get()
            if job is None:
                return
            try:
                job.state = "running"
                self.storage.save(job)
                self._run_one(job)
                job.state = "done"
            except Exception as e:  # job failure -> error surfaced to waiter
                job.state = "failed"
                job.error = f"{type(e).__name__}: {e}"
                with self._mu:
                    if job.job_id in self._events:  # waiter still present
                        self._excs[job.job_id] = e
            job.finish_time = time.time()
            job.schema_state = ("public" if job.state == "done"
                                and job.job_type.startswith("add")
                                else job.schema_state)
            self.storage.archive(job)
            ev = self._events.get(job.job_id)
            if ev is not None:
                ev.set()

    def _bump_schema(self, job: DDLJob, state: str):
        """One F1 transition: set state, bump schema version.  (The
        multi-node wait-for-lease is a no-op in-process.)"""
        job.schema_state = state
        self.domain.schema_version += 1
        self.storage.save(job)
        try:
            tbl = self.domain.catalog.get_table(job.db, job.table)
        except Exception:
            tbl = None            # table dropped mid-job
        if tbl is not None:
            tbl.schema_ver += 1
            # MDL (pkg/ddl/mdl, F1 wait-for-version-ack): before running
            # under the NEW version, drain every open txn still using an
            # older version of THIS table.  On timeout the transition
            # proceeds and the straggler txn aborts at commit instead
            # (session._finish_txn per-table schema validation).
            timeout = float(self.domain.sysvars.get(
                "tidb_mdl_wait_timeout", 10.0) or 10.0)
            drained = self.domain.mdl.wait_drain(
                tbl.table_id, tbl.schema_ver, timeout_s=timeout)
            if not drained:
                # straggler txns are now >=2 versions behind: doomed to
                # abort at commit, so stop re-waiting on them
                self.domain.mdl.evict_below(tbl.table_id, tbl.schema_ver)
                job.mdl_timeouts = getattr(job, "mdl_timeouts", 0) + 1
            tbl._persist_meta()   # catalog-on-KV: index states survive
            # (persistence failures propagate — silently losing an index
            # state transition would corrupt the restart view)

    def _run_one(self, job: DDLJob):
        tbl = self.domain.catalog.get_table(job.db, job.table)
        if job.job_type == "add index":
            self._add_index(job, tbl)
        elif job.job_type == "drop index":
            self._drop_index(job, tbl)
        else:
            raise DDLError(f"unknown DDL job type {job.job_type!r}")

    # ---------------- ADD INDEX ---------------- #

    def _add_index(self, job: DDLJob, tbl):
        a = job.args
        if tbl.index_by_name(a["name"]) is not None:
            if a.get("if_not_exists"):
                return
            raise DDLError(f"index {a['name']!r} already exists")
        for c in a["columns"]:
            if c not in tbl.col_names:
                raise DDLError(f"unknown column {c!r} in index {a['name']!r}")
        if tbl.kv is None:
            raise DDLError("indexes require a KV-backed table")
        tbl._next_index_id += 1
        ix = IndexInfo(a["name"], tbl._next_index_id, list(a["columns"]),
                       a["unique"], state="none")
        tbl.indexes.append(ix)
        try:
            # F1 ladder: each transition drains in-flight writers via the
            # table's schema gate (the wait-all-nodes-ack analog), so no
            # statement straddles two states
            for state in ("delete only", "write only",
                          "write reorganization"):
                with tbl.schema_gate.write():
                    ix.state = state
                self._bump_schema(job, state)
            self._backfill(job, tbl, ix)
            with tbl.schema_gate.write():
                ix.state = "public"
            self._bump_schema(job, "public")
            tbl._invalidate()
        except Exception:
            # rollback under the write gate: writers iterating
            # tbl.indexes must not observe the removal mid-statement, and
            # none may still write entries when the wipe scans
            with tbl.schema_gate.write():
                tbl.indexes.remove(ix)
            self._wipe_index(tbl, ix)
            raise

    def _backfill(self, job: DDLJob, tbl, ix):
        """Write-reorg backfill: snapshot-scan existing rows, write index
        entries in parallel subtask ranges (DXF); the checkpoint only
        advances over the contiguous completed prefix of subtasks, so a
        resumed job never skips an unfinished range."""
        from ..store.codec import (decode_record_key, decode_row, record_key,
                                   record_prefix, record_prefix_end)
        kv = tbl.kv
        ts = kv.alloc_ts()
        # a concurrent writer's prewrite lock on a record key makes the
        # snapshot scan raise ERR_LOCKED until its 2PC ends: wait it out
        # and scan again at the same ts (the Backoffer's txnLock curve,
        # client-go's resolve-locks-then-retry of a snapshot read), so
        # the online DDL never fails on a writer it must tolerate
        bo = Backoffer(max_sleep_ms=LOCK_WAIT_MS)
        while True:
            try:
                handles = [decode_record_key(k)[1] for k, _ in kv.scan(
                    record_prefix(tbl.table_id),
                    record_prefix_end(tbl.table_id), ts)]
                break
            except KVError as e:
                if e.code != ERR_LOCKED:
                    raise
                bo.backoff(TXN_LOCK, e)
        start = job.reorg_handle          # resume point
        todo = [int(h) for h in handles if h > start]
        if not todo:
            return
        # the JAX package hands the subtasks to a DXF node pool when one
        # is attached (_backfill_distributed); the port has no DXF yet
        # (ROADMAP.md, Queue 1 item 9: slice 13), so it backfills locally
        workers = int(self.domain.sysvars.get(
            "tidb_ddl_reorg_worker_cnt", 4))
        subtasks = [todo[i:i + SUBTASK] for i in range(0, len(todo), SUBTASK)]

        def run_subtask(chunk):
            done = 0
            for off in range(0, len(chunk), BATCH):
                batch = chunk[off:off + BATCH]
                for attempt in range(12):
                    txn = kv.begin()
                    written = 0
                    try:
                        for h in batch:
                            # re-read the row at this txn's snapshot (not
                            # the stale scan): a concurrent DELETE must not
                            # leave an orphan entry, and a concurrent
                            # UPDATE's values must win.  Re-putting the
                            # record key forces a write-write conflict at
                            # commit with any racing row mutation (the
                            # reference locks the row key during backfill),
                            # so a mutation that lands between this read
                            # and commit aborts the batch instead of
                            # silently racing it.
                            rk = record_key(tbl.table_id, h)
                            rv = txn.get(rk)
                            if rv is None:
                                continue
                            txn.put(rk, rv)
                            row = decode_row(rv, tbl.col_types)
                            tbl._put_index_entry(txn, ix, tuple(row), h)
                            written += 1
                        txn.commit()
                        break
                    except DuplicateKeyError:
                        txn.rollback()
                        raise
                    except KVError:
                        # write conflict with a concurrent DML txn: the
                        # region-error/Backoffer retry analog.  Capped
                        # exponential backoff, same discipline as the
                        # session's _retry_write_conflict: a sustained
                        # DML stream over the batch's range can keep
                        # colliding for >20ms, which the old 5-attempt
                        # linear budget couldn't ride out.
                        txn.rollback()
                        if attempt == 11:
                            raise
                        time.sleep(min(0.002 * (2 ** attempt), 0.1))
                done += written
                with self._mu:
                    job.rows_backfilled += written
            return done

        with ThreadPoolExecutor(max_workers=max(workers, 1),
                                thread_name_prefix="ddl-backfill") as pool:
            # map() yields in submission order: after subtask k completes,
            # subtasks 0..k are all done -> checkpoint may advance to its
            # last handle (per-subtask durability, DXF subtask states)
            for k, _n in enumerate(pool.map(run_subtask, subtasks)):
                with self._mu:
                    job.reorg_handle = subtasks[k][-1]
                    self.storage.save(job)

    # ---------------- DROP INDEX ---------------- #

    def _drop_index(self, job: DDLJob, tbl):
        a = job.args
        ix = tbl.index_by_name(a["name"])
        if ix is None:
            if a.get("if_exists"):
                return
            raise DDLError(f"unknown index {a['name']!r}")
        # reverse ladder: public -> write only -> delete only -> none
        for state in ("write only", "delete only"):
            with tbl.schema_gate.write():
                ix.state = state
            self._bump_schema(job, state)
        with tbl.schema_gate.write():
            tbl.indexes.remove(ix)
        self._bump_schema(job, "none")
        self._wipe_index(tbl, ix)
        tbl._invalidate()

    def _wipe_index(self, tbl, ix):
        from ..store.codec import index_prefix, index_prefix_end
        kv = tbl.kv
        if kv is None:
            return
        txn = kv.begin()
        for k, _ in kv.scan(index_prefix(tbl.table_id, ix.index_id),
                            index_prefix_end(tbl.table_id, ix.index_id),
                            txn.start_ts):
            txn.delete(k)
        txn.commit()


__all__ = ["DDLExecutor", "DDLError"]
