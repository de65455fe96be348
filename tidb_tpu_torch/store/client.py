# ported from tidb_tpu/store/client.py @ 02e96d8
"""Coprocessor client: dispatches a pushed-down DAG to the devices and
merges what they return.

``execute_agg`` runs two routes of the JAX package's client:

- SCALAR and DENSE (``_execute_agg_once``): one launch of the device
  program, whose partial states merge across the devices on the card;
  one device-to-host transfer of the merged states; then
  ``merge_states`` and ``finalize`` on the host;
- the high-NDV SORT, SEGMENT and SCATTER strategies
  (``_execute_sort_agg``): for SEGMENT and SCATTER the key hash is
  computed once per statement and appended as a scan column (the prehash
  hoist); the per-device program runs at a state capacity (SORT's pow2
  ``group_capacity``, the radix strategies' pow2 ``num_buckets``) and is
  re-run at a larger one while a device observes more groups than that
  (the regrow loop), and the host merges the per-device group tables.

``execute_rows`` runs a row-returning DAG (Limit, TopN, a filtered
projection) with the paging loop of ``_execute_rows_once``: each device
compacts its live rows into a fixed row capacity, and the program is
re-run at a larger one while a device returns more rows than that; the
host concatenates each device's rows (``_assemble_rows``).  A TopN or
Limit root returns the union of the devices' first rows, for the caller
to re-trim, as the JAX package's does.

Both routes take ``aux_cols``, the build sides of a broadcast join
fused into the probe table's program (``copr/exec._exec_lookup_join``):
groups of tensors already on the card.  A program with an expanding
(m:n) join reports each device's true join output size, and the client
re-runs it at a larger join capacity while one exceeds it
(``_grown_join_dag``).

``execute_shuffle_agg`` and ``execute_shuffle_rows`` run the repartition
join (parallel/shuffle.py): both tables' scan chains, the hash exchange
between the logical devices, each device's build sort and join, then
the aggregation or the row compaction, re-run at larger exchange, join
or result capacities while a device reports more rows than one holds
(``_run_shuffle``).

Around those routes, as in the JAX package's client:

- **retries** (``_retry``): a ``RegionError`` (injected by
  ``inject_failures``, or a remote store's) or an injected transient
  fault at the ``dispatch`` or ``transfer`` seam (faults/) backs off
  under ``retry_budget_ms`` and retries; a RegionError naming a shard or
  a store first heals the snapshot's placement (split the shard, exclude
  the store), so the retry places and runs a different fan-out
  (``last_retries``, ``last_heals``);
- **the result cache** (``execute_agg`` without ``aux_cols``): an LRU of
  ``RESULT_CACHE_ENTRIES`` results up to 4 MiB each, keyed by the DAG's
  digest, the snapshot's and its placement's epochs and its layout, each
  entry holding a weakref to its snapshot (``result_cache_hits``,
  ``result_cache_misses``);
- **streaming**: a snapshot whose placed footprint exceeds
  ``device_mem_cap`` (env ``TIDB_TPU_DEVICE_MEM_CAP``; 0 = resident)
  runs as row-range batches that share one program shape, each placed
  outside the resident cache by ``device_put_uncached`` and reduced by
  the same kernels as the resident run.  A batch is stacked in pinned
  host memory and copied without blocking on the current stream, so
  the host stacks batch k+1 while the card copies and reduces batch k;
  the SORT, SEGMENT and SCATTER batches run with their regrow, and the
  rows route's batches concatenate their rows;
- **the OOM ladder**: an aggregation whose launch exhausts device memory
  (``faults.is_oom_error``: a ``torch.cuda.OutOfMemoryError`` or an
  injected ``MemoryFault``) runs again as half-size streamed batches on
  the card, counted in ``oom_recovered``.  Device-forced: before that
  rung the client drops the failed launch's traceback and the
  snapshot's resident placement and returns the freed blocks to the
  card (``torch.cuda.empty_cache``), which the JAX package leaves to
  XLA.  Its last rung, the host (``copr/hostagg``), runs only when
  ``host_fallback`` is on; otherwise the OOM propagates;
- **the quarantine ladder**: a ``LaunchQuarantinedError`` (the launch
  circuit breaker of the scheduler, raised at submit) is served by the
  host when ``host_fallback`` is on, counted in ``degraded``.

Every device launch goes through the device admission scheduler
(sched/), as in the JAX package, and it is on by default: ``_launch``
submits a structured ``CopTask`` (the scheduler resolves the program
through the program cache and may coalesce, batch or fuse it with other
sessions' tasks), ``_launch_opaque`` the hash, shuffle and window
programs as opaque tasks (fair-ordered, never coalesced).
``TIDB_TPU_SCHED_DISABLE=1`` or a queue depth of 0
(``tidb_tpu_sched_queue_depth``) launches directly.  The regrow and
paging loops enter at a capacity the program cache already holds for
the plan family (``_warm_cap``), and ``sched_stats()`` is the status
API's ``/sched``.

``host_fallback`` (``tidb_tpu_sched_host_fallback``) is off by default in
the port, where the JAX package's is on: a statement meant for the card
moves to the CPU only when the caller asks for it.

Any other error, a launch failure that is not an OOM among them,
propagates.  The retry and ladder counters change under ``_stat_mu``,
the result cache and its counters under ``_rc_mu``.  On the CPU the
client runs the same device programs through the plain kernel versions:
it keeps none of the JAX package's CPU engine choice (its CPU client
sends DENSE, SCALAR and the high-NDV strategies to ``host_dense_agg`` and
``host_sort_agg``).

``execute_window`` runs the window functions (parallel/window.py): each
device's scan chain, the hash exchange by PARTITION BY, each device's
sort and segment ops, re-run at a larger exchange capacity while a
device sends more rows to one bucket than it holds.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..chunk.column import Column
from ..copr import dag as D
from ..copr import radix
from ..copr.aggregate import (GroupKeyMeta, finalize, finalize_sorted,
                              merge_sorted_states, merge_states)
from ..copr.coordinator import check_killed
from ..copr.join import check_join_rows
from ..device import get_devices
from ..faults import plan as _faults
from ..faults.breaker import LaunchQuarantinedError
from ..obs.trace import flag as _obs_flag
from ..obs.trace import span as _obs_span
from ..parallel.shuffle import ShardedShuffleJoinProgram, ShuffleCaps
from ..parallel.spmd import get_sharded_program
from ..parallel.window import ShardedWindowProgram
from .columnar import ColumnarSnapshot, _pow2_at_least

DEFAULT_GROUP_CAPACITY = 4096
INITIAL_SELECTIVITY = 4  # row capacity = max(rows/shards/4, 1024)
PAGE_FEEDBACK_CAP = 512
RESULT_CACHE_ENTRIES = 64   # a new client's result-cache capacity


@dataclass
class CopResult:
    """Decoded result of one pushdown: agg groups."""
    columns: list[Column]
    key_columns: list[Column]


def _sync(devices) -> None:
    if devices[0].type == "cuda":
        torch.cuda.synchronize(devices[0])


class CopClient:
    """``device`` is ``"cuda"`` (the default) or ``"cpu"``;
    ``n_devices`` logical devices share it (see tidb_tpu_torch/device.py).

    ``timings`` holds the wall-clock seconds of the calling thread's last
    ``execute_agg`` or ``execute_rows`` by phase (one dict a statement
    thread: a server runs one thread a connection over one client), each ended by a device synchronize:
    ``place``, ``device``, ``transfer``, then ``merge`` (aggregations)
    or ``assemble`` (rows); SEGMENT and SCATTER add ``hash``.  The
    high-NDV strategies also record ``buckets``, the per-device state
    capacity of each device program run (the last one final); the rows
    route records ``pages``, the row capacity of each run; a program
    with an expanding join records ``joins``, the join capacity of each
    run; the repartition join records ``shuffles``, the ``(left, right,
    out, rows)`` capacities of each run; the window program records
    ``windows``, the exchange bucket capacity of each run.  A broadcast
    join's executor adds ``build``, the seconds of its build side (its
    own plan, the sort of its keys and the copy to the card).

    A streamed call records ``batches``: a dict a batch with its
    ``rows``, the host stacking ms (``stack_ms``) and, on a CUDA device,
    from CUDA events on the stream, its copy's ms (``h2d_ms``), its
    kernels' ms (``device_ms``) and the ms the stream waited for it
    after the batch before it (``wait_ms``: the host stacking the card
    did not hide).

    ``join_fallbacks`` counts the broadcast joins whose executor took
    its host plan instead of the device program (an empty build side,
    or a chain level with an empty or duplicate-keyed build): the JAX
    package's own plan branches, counted so a run can show that a join
    meant for the card ran there.  It, ``last_page_iters`` and the
    retry and ladder counters change under ``_stat_mu``, the paging
    feedback under ``_pf_mu``, as in the JAX package's client:
    connection threads share the client."""

    def __init__(self, device="cuda", n_devices: int = 1):
        self.devices = get_devices(device, n_devices)
        self._local = threading.local()
        # paging feedback: dag digest -> EWMA of the observed per-shard
        # live fraction, LRU-capped (digests embed predicate constants);
        # _pf_mu guards its get/assign/move_to_end/popitem sequence (a
        # concurrent eviction between get and move_to_end raises KeyError)
        self._page_feedback: OrderedDict[int, float] = OrderedDict()
        self._pf_mu = threading.Lock()
        self._stat_mu = threading.Lock()
        self.last_page_iters = 0
        self.join_fallbacks = 0
        # failure detection/recovery (copIterator backoff-and-retry):
        # transient dispatch errors retry under a typed backoff budget;
        # the failpoint queue is lock-guarded since the client is shared
        # by every connection thread
        self.retry_budget_ms = 5000.0
        self.last_retries = 0
        self.last_heals = 0    # topology mutations by the retry loop
        self._fp_mu = threading.Lock()
        self._failpoints: list = []    # injected RegionErrors (tests/chaos)
        # streaming threshold: tables whose stacked device footprint
        # exceeds this stream through device memory in batches (SURVEY.md
        # §5.7; 0 = never stream)
        self.device_mem_cap = int(
            os.environ.get("TIDB_TPU_DEVICE_MEM_CAP", "0") or 0)
        # coprocessor RESULT cache (copr/coprocessor_cache.go analog):
        # key = (dag digest, snapshot epoch, placement epoch, layout); a
        # table write creates a new snapshot + epoch, so stale entries
        # never hit and the LRU ages them out.  Entries hold a weakref
        # to their snapshot: a hit must come from the SAME snapshot
        # object (guards id()/epoch reuse).
        self._result_cache: OrderedDict = OrderedDict()
        self._result_cache_cap = RESULT_CACHE_ENTRIES
        self._rc_max_bytes = 4 << 20   # only small responses, like the ref
        self._rc_mu = threading.Lock()
        self.result_cache_hits = 0
        self.result_cache_misses = 0
        # graceful degradation (tidb_tpu_sched_host_fallback): a digest
        # quarantined by the launch circuit breaker, or an OOM that the
        # half-size stream did not answer, falls back to the host oracle
        # path when the plan has a host-executable shape.  Off unless
        # asked for: the port keeps a statement on the card
        self.host_fallback = False
        self.degraded = 0      # statements served by that fallback
        # OOM recovery (faults.is_oom_error): a launch that exhausted
        # device memory retries through the recovery ladder — streamed
        # half-size batches, then (host_fallback) the host oracle
        self.oom_recovered = 0
        # device admission scheduler (sched/): every launch onto the
        # devices goes through a bounded weighted-fair queue that
        # coalesces concurrent compatible tasks.  -1 = scheduler
        # defaults; queue depth 0 (or TIDB_TPU_SCHED_DISABLE=1) bypasses
        # admission.  The other knobs: None = keep the scheduler's state
        self.sched_enable = os.environ.get(
            "TIDB_TPU_SCHED_DISABLE", "") != "1"
        self.sched_queue_depth = -1
        self.sched_max_coalesce = -1
        self.sched_fusion = None       # tidb_tpu_sched_fusion
        self.sched_window_us = None    # tidb_tpu_sched_window_us
        self.sched_hbm_budget = None   # tidb_tpu_sched_hbm_budget
        self.rc_enable = None          # tidb_tpu_rc_enable
        self.rc_overdraft = None       # tidb_tpu_rc_overdraft_ru
        self.calibration = None        # tidb_tpu_cost_calibration
        self.hbm_ledger = None         # tidb_tpu_hbm_ledger
        self._sched_obj = None

    @property
    def timings(self) -> dict:
        t = getattr(self._local, "timings", None)
        if t is None:
            t = self._local.timings = {}
        return t

    @timings.setter
    def timings(self, value: dict) -> None:
        self._local.timings = value

    def count_join_fallback(self) -> None:
        with self._stat_mu:
            self.join_fallbacks += 1

    def _place(self, snap: ColumnarSnapshot):
        self.timings = {}
        t0 = time.perf_counter()
        cols, counts = snap.device_cols(self.devices)
        _sync(self.devices)
        self.timings["place"] = time.perf_counter() - t0
        return cols, counts

    # -- dispatch retry seam (pkg/store/copr backoff loop analog) ------ #

    def inject_failures(self, kind, n: int = 1, shard=None,
                        store=None) -> None:
        """Failpoint: the next n dispatches raise a RegionError of `kind`
        before touching the device (chaos/testing seam, the reference's
        failpoint.Inject on rpc errors).  `shard`/`store` name the failing
        topology element so the retry can heal it (re-split / exclude)."""
        from .backoff import RegionError
        with self._fp_mu:
            for _ in range(n):
                e = RegionError(kind)
                e.shard = shard
                e.store = store
                self._failpoints.append(e)

    def _next_failpoint(self):
        with self._fp_mu:
            return self._failpoints.pop(0) if self._failpoints else None

    def _retry(self, fn, snap: Optional[ColumnarSnapshot] = None):
        """Backoff loop that HEALS the topology before retrying: a
        RegionError naming a shard/store mutates the snapshot's placement
        (split the shard / exclude the store, placement.heal), bumping its
        epoch so the retry dispatches a DIFFERENT fan-out — the
        copr handleTask re-split discipline (coprocessor.go:337,:1308),
        not an identical re-run."""
        from .backoff import DEVICE_FAILED, Backoffer, RegionError
        bo = Backoffer(max_sleep_ms=self.retry_budget_ms)
        retries = 0
        while True:
            check_killed()    # KILL QUERY cancels in-flight dispatch loops
            try:
                fp = self._next_failpoint()
                if fp is not None:
                    raise fp
                _faults.check("dispatch")   # faultline store-dispatch seam
                with self._stat_mu:
                    self.last_retries = retries
                try:
                    res = fn()
                except BaseException:
                    # a failed attempt's launches: the drain's ring
                    # settles them at its next pickup
                    self._local.launches = []
                    raise
                # the result is on the host: every launch this thread
                # waited on has completed, so its device time is ready
                self._settle_launches()
                return res
            except RegionError as e:
                bo.backoff(e.kind, e)
                if snap is not None and snap.placement is not None:
                    healed = snap.placement.heal(e)
                    if healed:
                        with self._stat_mu:
                            self.last_heals += 1
                retries += 1
            except _faults.TransientFault as e:
                # injected retryable dispatch/transfer fault: same typed
                # budget, DEVICE_FAILED curve; poison faults propagate
                bo.backoff(DEVICE_FAILED, e)
                retries += 1

    def execute_agg(self, agg: D.Aggregation, snap: ColumnarSnapshot,
                    key_meta: list[GroupKeyMeta], aux_cols=()) -> CopResult:
        """The aggregation's result columns.  ``aux_cols`` are the build
        sides of the broadcast joins fused into ``agg``'s program."""
        key = None
        if not aux_cols:      # aux (join builds) = host inputs, not cacheable
            key = self._rc_key(agg, snap)
            hit = self._rc_get(key, snap)
            if hit is not None:
                return hit
        oom = None
        try:
            res = self._retry(lambda: self._execute_agg_once(
                agg, snap, key_meta, aux_cols), snap=snap)
        except LaunchQuarantinedError as err:
            # OPEN breaker: the device program keeps failing — degrade
            # to the host oracle where the plan shape allows it
            _obs_flag("quarantined")
            res = self._degraded_agg(agg, snap, key_meta, aux_cols, err)
        except Exception as err:
            # OOM recovery: a launch that exhausted device memory
            # (injected MemoryFault or a real CUDA OOM) walks the
            # recovery ladder; everything else re-raises
            if not _faults.is_oom_error(err):
                raise
            # device-forced: the traceback's frames hold the failed
            # launch's tensors (the placement, its temporaries); drop
            # them before the ladder asks the card for memory again
            oom = err.with_traceback(None)
        if oom is not None:
            res = self._oom_degraded_agg(agg, snap, key_meta, aux_cols, oom)
        if key is not None:
            self._rc_put(key, snap, res)
        return res

    def _oom_degraded_agg(self, agg: D.Aggregation, snap: ColumnarSnapshot,
                          key_meta, aux_cols, err) -> CopResult:
        """OOM recovery ladder: try streamed half-size batches first (the
        launch that OOM'd resident runs as >= 2 batches), then, with
        ``host_fallback`` on, the host oracle — results stay
        bit-identical to the uncontended run on every rung.  Otherwise,
        or for a plan with neither shape, the OOM propagates.  The rung
        taken is ``timings["oom_rung"]`` ("stream" or "host")."""
        _obs_flag("oom")
        if not aux_cols:
            # device-forced: the resident placement of the run that
            # failed still holds device memory; release it (and the
            # allocator's free blocks) so the half-size batches can fit
            snap._device_cache.clear()
            if self.devices[0].type == "cuda":
                torch.cuda.empty_cache()
            half = max(snap.device_bytes() // 2, 1)
            batches = snap.row_batches(half)
            if batches and len(batches) >= 2:
                try:
                    if agg.strategy in D.HOST_MERGE_STRATEGIES:
                        res = self._stream_sort_agg(agg, batches, key_meta)
                    else:
                        res = self._stream_dense_agg(agg, batches, key_meta)
                    self.timings["oom_rung"] = "stream"
                    with self._stat_mu:
                        self.oom_recovered += 1
                    return res
                except Exception as e:  # noqa: BLE001 - recovery ladder:
                    # a half-size stream may STILL exhaust memory (or
                    # trip the same injected fault) — fall through to
                    # the host oracle; anything non-OOM re-raises
                    if not _faults.is_oom_error(e):
                        raise
        if not self.host_fallback:
            raise err
        res = self._degraded_agg(agg, snap, key_meta, aux_cols, err)
        self.timings["oom_rung"] = "host"
        with self._stat_mu:
            self.oom_recovered += 1
        return res

    def _degraded_agg(self, agg: D.Aggregation, snap: ColumnarSnapshot,
                      key_meta, aux_cols, err) -> CopResult:
        """Graceful degradation for a quarantined program digest
        (faultline): serve the aggregation from the host oracle path
        (copr/hostagg) — slow-but-correct instead of unavailable, the
        Flare compiled-path-falls-back-to-interpreter pattern.  Plans
        without a host-executable shape re-raise the quarantine error
        so the client sees the structured failure."""
        res = None
        if self.host_fallback and not aux_cols:
            if agg.strategy in D.HOST_MERGE_STRATEGIES:
                res = self._host_sort_agg(agg, snap, key_meta)
            else:
                from ..copr.hostagg import host_dense_agg
                states = host_dense_agg(agg, snap)
                if states is not None:
                    merged = merge_states([states])
                    key_cols, agg_cols = finalize(agg, merged, key_meta)
                    res = CopResult(agg_cols, key_cols)
        if res is None:
            raise err
        _obs_flag("degraded")
        with self._stat_mu:
            self.degraded += 1
        from ..utils.metrics import global_registry
        global_registry().counter(
            "tidb_tpu_sched_degraded_total",
            "statements served by the host oracle after a launch "
            "quarantine").inc()
        from ..copr.coordinator import QUERY_HANDLE
        h = QUERY_HANDLE.get()
        if h is not None:
            h.note_degraded()
        return res

    def _host_sort_agg(self, agg: D.Aggregation, snap: ColumnarSnapshot,
                       key_meta) -> Optional[CopResult]:
        """The host group-by of the ladders' last rung: a host unique +
        segment reduction over the snapshot columns (copr/hostagg), or
        None when the DAG shape isn't the scan/filter/project chain that
        path handles."""
        from ..copr.hostagg import host_sort_agg
        states = host_sort_agg(agg, snap)
        if states is None:
            return None
        # single host table: groups are already unique — the cross-device
        # re-group of merge_sorted_states would be a no-op
        merged = {k: v for k, v in states.items() if k != "__ngroups__"}
        key_cols, agg_cols = finalize_sorted(agg, merged, key_meta)
        return CopResult(agg_cols, key_cols)

    # -- the result cache ------------------------------------------- #

    def _rc_key(self, dag, snap: ColumnarSnapshot):
        p_epoch = snap.placement.epoch if snap.placement is not None else -1
        return (D.dag_digest(dag), snap.epoch, p_epoch, snap.num_rows,
                snap.n_shards)

    def _rc_get(self, key, snap) -> Optional[CopResult]:
        with self._rc_mu:
            ent = self._result_cache.get(key)
            if ent is not None and ent[0]() is snap:
                self._result_cache.move_to_end(key)
                self.result_cache_hits += 1
                return ent[1]
            # miss counter bumps under the same lock: the client is
            # shared by every connection thread and an unguarded
            # read-modify-write here loses updates under load
            self.result_cache_misses += 1
        return None

    def _rc_put(self, key, snap, res: CopResult) -> None:
        nbytes = sum(c.data.nbytes for c in res.columns + res.key_columns
                     if hasattr(c.data, "nbytes"))
        if nbytes > self._rc_max_bytes:
            return
        with self._rc_mu:
            self._result_cache[key] = (weakref.ref(snap), res)
            self._result_cache.move_to_end(key)
            while len(self._result_cache) > self._result_cache_cap:
                self._result_cache.popitem(last=False)

    def _execute_agg_once(self, agg: D.Aggregation, snap: ColumnarSnapshot,
                          key_meta: list[GroupKeyMeta],
                          aux_cols=()) -> CopResult:
        batches = self._stream_batches(agg, snap, aux_cols)
        if agg.strategy in D.HOST_MERGE_STRATEGIES:
            # SORT, SEGMENT and SCATTER share one dispatch path:
            # per-device group tables, host final merge, capacity regrow
            if batches is not None:
                return self._stream_sort_agg(agg, batches, key_meta)
            cols, counts = self._place(snap)
            return self._execute_sort_agg(agg, cols, counts, key_meta,
                                          aux_cols)
        if batches is not None:
            return self._stream_dense_agg(agg, batches, key_meta)
        cols, counts = self._place(snap)
        return self._execute_dense_agg(agg, cols, counts, key_meta,
                                       aux_cols)

    # ------------------------------------------------------------- #
    # streaming: tables bigger than device memory (SURVEY.md §5.7)
    # ------------------------------------------------------------- #

    def _stream_batches(self, dag, snap: ColumnarSnapshot, aux_cols=()):
        """Row-range batch views when the snapshot exceeds the device
        memory cap; None = run resident.  Plans with fused joins keep the
        resident path (the build sides are device inputs of every batch,
        and an expanding join's regrow re-runs programs)."""
        if not self.device_mem_cap or aux_cols \
                or D.find_expand_join(dag) is not None:
            return None
        return snap.row_batches(self.device_mem_cap)

    def _put_batch(self, batch: ColumnarSnapshot) -> tuple:
        """Place one streamed batch: ``(cols, counts, rec)``, ``rec`` the
        batch's timing record (``device_put_uncached``'s, with ``rows``)."""
        rec = {"rows": batch.num_rows}
        cols, counts = batch.device_put_uncached(self.devices, rec)
        return cols, counts, rec

    def _end_batch(self, rec) -> None:
        """Mark the end of the batch's kernels on the stream."""
        if "h2d" in rec:
            rec["end"] = torch.cuda.Event(enable_timing=True)
            rec["end"].record(torch.cuda.current_stream(self.devices[0]))

    @staticmethod
    def _batch_times(recs) -> list:
        """Each batch's times: the host stacking ms and, from the CUDA
        events, its copy's ms, its kernels' ms and the ms the stream
        waited for its copy after the batch before it.  Waits for the
        last batch's end first: an event still queued behind other
        statements' kernels on the shared stream has no elapsed time."""
        if recs and "end" in recs[-1]:
            recs[-1]["end"].synchronize()
        out = []
        for k, rec in enumerate(recs):
            row = {"rows": rec["rows"], "stack_ms": rec["stack_s"] * 1e3}
            if "end" in rec:
                h0, h1 = rec["h2d"]
                row["h2d_ms"] = h0.elapsed_time(h1)
                row["device_ms"] = h1.elapsed_time(rec["end"])
                row["wait_ms"] = (recs[k - 1]["end"].elapsed_time(h0)
                                  if k else 0.0)
            out.append(row)
        return out

    def _stream_states(self, agg, batches) -> list:
        """Streamed dispatch: batch k's kernels are queued before batch
        k+1 is stacked, so the host stacks the next batch while the card
        copies and reduces this one.  The paging/double-buffer analog of
        kv.Request.Paging (SURVEY.md §5.7)."""
        t = self.timings = {}
        outs, recs = [], []
        t0 = time.perf_counter()
        for b in batches:
            check_killed()   # cancellation between streamed batches
            cols, counts, rec = self._put_batch(b)
            # uncached batch, launched exactly once: EPHEMERAL in the
            # lifetime taxonomy — the donating program releases the
            # batch to the caching allocator at its launch
            out, _grown = self._launch(agg, cols, counts, (), donate=True)
            self._end_batch(rec)
            outs.append(out)
            recs.append(rec)
            del cols, counts     # free the batch once its program consumed it
        t1 = time.perf_counter()
        with _obs_span("cop.transfer", batches=len(outs)):
            states = [_to_numpy(o) for o in outs]
        t["stream"] = t1 - t0
        t["transfer"] = time.perf_counter() - t1
        t["batches"] = self._batch_times(recs)
        return states

    def _stream_dense_agg(self, agg, batches, key_meta) -> CopResult:
        states_list = self._stream_states(agg, batches)
        t0 = time.perf_counter()
        merged = merge_states(states_list)
        key_cols, agg_cols = finalize(agg, merged, key_meta)
        self.timings["merge"] = time.perf_counter() - t0
        return CopResult(agg_cols, key_cols)

    def _stream_sort_agg(self, agg, batches, key_meta) -> CopResult:
        """The high-NDV strategies over streamed batches: each batch's
        per-device group tables, regrown while a device sees more groups
        than the capacity holds (the capacity carries over to the next
        batch), then one host merge of every batch's tables."""
        t = self.timings = {}
        t["buckets"] = []
        cap = self._warm_cap(agg, agg.state_capacity
                             or DEFAULT_GROUP_CAPACITY)
        per_dev_all, recs = [], []
        t0 = time.perf_counter()
        for b in batches:
            check_killed()
            cols, counts, rec = self._put_batch(b)
            for _ in range(10):
                sized = self._with_capacity(agg, cap)
                t["buckets"].append(sized.state_capacity)
                out, _grown = self._launch(sized, cols, counts, ())
                per_dev = self._split_devices(out)
                true_ng = max(int(st["__ngroups__"]) for st in per_dev)
                if true_ng <= sized.state_capacity:
                    break
                cap = self._warm_cap(agg, _pow2_at_least(true_ng))
            else:
                raise RuntimeError("group-capacity regrow did not converge")
            self._end_batch(rec)
            recs.append(rec)
            per_dev_all.extend(per_dev)
            del cols, counts
        t1 = time.perf_counter()
        t["stream"] = t1 - t0
        t["batches"] = self._batch_times(recs)
        sized = self._with_capacity(agg, cap)
        merged = merge_sorted_states(sized, per_dev_all)
        key_cols, agg_cols = finalize_sorted(sized, merged, key_meta)
        t["merge"] = time.perf_counter() - t1
        return CopResult(agg_cols, key_cols)

    # -- the device launch seam: the admission scheduler (sched/) ----- #

    def _scheduler(self):
        """This device tuple's admission scheduler; None = direct."""
        if not self.sched_enable or self.sched_queue_depth == 0:
            return None
        s = self._sched_obj
        if s is None:
            from ..sched import scheduler_for
            s = self._sched_obj = scheduler_for(self.devices)
        s.configure(
            self.sched_queue_depth if self.sched_queue_depth > 0 else None,
            self.sched_max_coalesce if self.sched_max_coalesce > 0
            else None,
            fusion=self.sched_fusion,
            window_us=self.sched_window_us,
            hbm_budget=self.sched_hbm_budget,
            rc_enable=self.rc_enable,
            rc_overdraft=self.rc_overdraft,
            calibration=self.calibration,
            hbm_ledger=self.hbm_ledger)
        return s

    def _client_stats(self) -> dict:
        with self._stat_mu:
            return {"last_page_iters": self.last_page_iters,
                    "last_retries": self.last_retries,
                    "last_heals": self.last_heals,
                    "degraded": self.degraded,
                    "oom_recovered": self.oom_recovered,
                    "host_fallback": self.host_fallback}

    def sched_stats(self) -> dict:
        """The status API's ``/sched``: the client's counters, the
        program cache's and, once a launch started it, the scheduler's."""
        with self._rc_mu:
            rc = {"result_cache_hits": self.result_cache_hits,
                  "result_cache_misses": self.result_cache_misses}
        client = {**self._client_stats(), **rc}
        from ..compilecache import compile_cache
        cc = {"compile_cache": compile_cache().stats()}
        if self._sched_obj is None:
            return {"enabled": self.sched_enable, "started": False,
                    "client": client, **cc}
        return {"enabled": self.sched_enable, "started": True,
                "client": client, **cc, **self._sched_obj.stats()}

    def _transfer_attrs(self) -> dict:
        """Per-link attrs for the NEXT transfer span on this statement
        thread (stashed by _note_sched from the served task's calibrated
        LaunchCost — the typed-link split)."""
        bd = getattr(self._local, "breakdown", None)
        self._local.breakdown = None
        if not bd or not (bd[0] or bd[1] or bd[2]):
            return {}
        return {"intra_bytes": bd[0], "ici_bytes": bd[1],
                "dci_bytes": bd[2]}

    def _settle_launches(self) -> None:
        """Read the device time of the launches this thread waited on
        (their CUDA events, sched/scheduler ``LaunchTiming``), once the
        results are on the host; what is still pending the drain reads
        at its next pickup."""
        pending = getattr(self._local, "launches", None)
        if pending:
            self._local.launches = []
            for timing in pending:
                timing.settle()

    def _note_sched(self, task) -> None:
        """The served task's queue wait, coalescing, RUs and build time,
        onto the statement's QueryHandle; its link split for the next
        transfer span and its device-time record for the settle."""
        if task.cost is not None:
            self._local.breakdown = task.cost.transfer_breakdown
        if task.timing is not None:
            pending = getattr(self._local, "launches", None)
            if pending is None:
                pending = self._local.launches = []
            pending.append(task.timing)
        from ..copr.coordinator import QUERY_HANDLE
        h = QUERY_HANDLE.get()
        if h is not None:
            h.note_sched(task.wait_ns, task.coalesced, task.fused,
                         rus=task.rus_charged, retried=task.retries,
                         compile_ns=task.compile_ns,
                         compile_miss=task.compile_miss,
                         hbm_predicted=task.hbm_predicted,
                         hbm_measured=task.hbm_measured)

    def _submit(self, dag, cols, counts, aux_cols, row_capacity: int = 0,
                donate: bool = False):
        """One run of ``dag``'s program over the devices through the
        admission queue: ``(program, out)``.  The scheduler resolves the
        program (so concurrent identical tasks share ONE call) and may
        coalesce, batch or fuse the task with other sessions' tasks.
        ``donate=True`` marks the inputs launch-unique (streamed
        batches): the DonationPlan-derived program releases them at the
        launch (analysis/lifetime) — never set it for snapshot residents
        or regrow-loop inputs."""
        sched = self._scheduler()
        if sched is None:
            prog = get_sharded_program(dag, self.devices, row_capacity,
                                       donate=donate)
            return prog, prog(cols, counts, aux_cols)
        from ..sched import CopTask
        est = 0
        if cols:
            s, c = cols[0][0].shape[:2]
            est = s * c
        # the dispatch span is the parent every scheduler-thread span
        # (queue/compile/launch/retry) stitches under — the CopTask
        # captures the child TraceCtx at construction
        with _obs_span("cop.dispatch"):
            t = sched.submit(CopTask.structured(
                dag, self.devices, row_capacity, cols, counts,
                tuple(aux_cols), est_rows=est, donate=donate))
            try:
                return t.wait()
            finally:
                self._note_sched(t)

    def _launch_opaque(self, fn, est_rows: int = 0):
        """Admission-controlled launch of a program with another
        signature (the key hash, shuffle and window programs):
        fair-ordered, never coalesced."""
        sched = self._scheduler()
        if sched is None:
            return fn()
        from ..sched import CopTask
        with _obs_span("cop.dispatch", opaque=True):
            t = sched.submit(CopTask.opaque(fn, self.devices,
                                            est_rows=est_rows))
            try:
                return t.wait()
            finally:
                self._note_sched(t)

    def _warm_cap(self, dag, needed: int) -> int:
        """The regrow and paging re-entry seam: prefer a capacity the
        program cache (or its manifest) already holds for this plan
        FAMILY over the minimal pow2 step, bounded at 4x the need."""
        from ..analysis.compilekey import backend_fingerprint, family_digest
        from ..compilecache import compile_cache
        warm = compile_cache().warm_capacity(
            family_digest(dag), needed, backend_fingerprint(self.devices))
        return warm if warm is not None else needed

    def _launch(self, dag, cols, counts, aux_cols, row_capacity: int = 0,
                donate: bool = False):
        """One run of ``dag``'s program over the devices: ``(out, grown)``,
        ``grown`` the DAG at a larger join capacity when an expanding
        join's output overflowed its capacity (``out`` is then stale),
        else None.  ``donate`` is for streamed batches only (``_submit``)."""
        prog, out = self._submit(dag, cols, counts, aux_cols, row_capacity,
                                 donate=donate)
        if not prog.has_extras:
            return out, None
        out, extras = out
        self.timings.setdefault("joins", []).append(
            D.find_expand_join(dag).out_capacity)
        return out, self._grown_join_dag(dag, extras)

    def _grown_join_dag(self, dag, extras):
        """The DAG rebuilt at a big enough join capacity when a device's
        expanding join overflowed it; None when it fits.  A device output
        past the reference's int32 join slots raises
        (``copr/join.check_join_rows``)."""
        need = int(extras["join_total"].max())
        check_join_rows(need)
        node = D.find_expand_join(dag)
        if node is not None and need > node.out_capacity:
            return D.rewrite_expand_capacity(dag, _pow2_at_least(need))
        return None

    def _execute_dense_agg(self, agg, cols, counts, key_meta,
                           aux_cols=()) -> CopResult:
        """One launch whose states merge across the devices on the card
        (re-run at a larger join capacity while an expanding join
        overflows), one transfer of the merged states, the host
        finalize."""
        t = self.timings
        t["device"] = 0.0
        for _ in range(8):
            t0 = time.perf_counter()
            out, grown = self._launch(agg, cols, counts, aux_cols)
            _sync(self.devices)
            t["device"] += time.perf_counter() - t0
            if grown is None:
                break
            agg = grown
        else:
            raise RuntimeError("join-capacity regrow did not converge")
        t1 = time.perf_counter()
        with _obs_span("cop.transfer", **self._transfer_attrs()):
            states = _to_numpy(out)
        # faultline transfer/host-merge seam, keyed by the digest
        _faults.check("transfer", D.dag_digest(agg))
        t2 = time.perf_counter()
        with _obs_span("cop.host_merge", kind="root"):
            merged = merge_states([states])
            key_cols, agg_cols = finalize(agg, merged, key_meta)
        t["transfer"] = t2 - t1
        t["merge"] = time.perf_counter() - t2
        return CopResult(agg_cols, key_cols)

    @staticmethod
    def _with_capacity(agg: D.Aggregation, cap: int) -> D.Aggregation:
        """The aggregation at a new per-device group-table capacity (the
        regrow knob): SORT sizes ``group_capacity``, SEGMENT and SCATTER
        their radix bucket space ``num_buckets``, each a power of two."""
        if agg.strategy in D.RADIX_STRATEGIES:
            return dataclasses.replace(agg, num_buckets=_pow2_at_least(cap))
        return dataclasses.replace(agg, group_capacity=_pow2_at_least(cap))

    @staticmethod
    def _split_devices(states) -> list:
        """Per-table numpy state dicts from states stacked on axis 0: one
        a device, more for a device whose batch ran in parts
        (parallel/spmd.py)."""
        host = _to_numpy(states)
        return [_index(host, d) for d in range(len(host["__ngroups__"]))]

    def _execute_sort_agg(self, agg, cols, counts, key_meta,
                          aux_cols=()) -> CopResult:
        """Per-device group tables (sort or partition, then segment
        reduce), regrown when a device sees more groups than the table
        holds (or an expanding join more rows than its capacity), then
        the host final merge."""
        t = self.timings
        t0 = time.perf_counter()
        pre = None if aux_cols else radix.prehash_plan(agg, len(cols))
        if pre is not None:
            hashed_dag, leaf_scan = pre
            hprog = radix.HashProgram(leaf_scan, agg.group_by)
            hv = self._launch_opaque(lambda: hprog(cols),
                                     est_rows=cols[0][0].numel())
            cols = list(cols) + [(hv, None)]
            agg = hashed_dag
            _sync(self.devices)
            t["hash"] = time.perf_counter() - t0
        t["device"] = t["transfer"] = 0.0
        t["buckets"] = []
        cap = self._warm_cap(agg, agg.state_capacity
                             or DEFAULT_GROUP_CAPACITY)
        for _ in range(10):
            sized = self._with_capacity(agg, cap)
            t["buckets"].append(sized.state_capacity)
            t0 = time.perf_counter()
            out, grown = self._launch(sized, cols, counts, aux_cols)
            _sync(self.devices)
            t1 = time.perf_counter()
            if grown is not None:
                t["device"] += t1 - t0
                agg = grown
                continue
            with _obs_span("cop.transfer", **self._transfer_attrs()):
                per_dev = self._split_devices(out)
            t["device"] += t1 - t0
            t["transfer"] += time.perf_counter() - t1
            true_ng = max(int(st["__ngroups__"]) for st in per_dev)
            if true_ng <= sized.state_capacity:
                break
            cap = self._warm_cap(agg, _pow2_at_least(true_ng))
        else:
            raise RuntimeError("group-capacity regrow did not converge")
        t0 = time.perf_counter()
        with _obs_span("cop.host_merge", kind="sorted"):
            merged = merge_sorted_states(sized, per_dev)
            key_cols, agg_cols = finalize_sorted(sized, merged, key_meta)
        t["merge"] = time.perf_counter() - t0
        return CopResult(agg_cols, key_cols)

    # ------------------------------------------------------------- #
    # row-returning programs
    # ------------------------------------------------------------- #

    def _initial_row_capacity(self, root: D.CopNode, fb_key: int,
                              per_shard: int) -> int:
        """``max(limit, 16)`` for a TopN or Limit root; else the page
        feedback's last observed live fraction with 50% headroom, or a
        quarter of a shard (``INITIAL_SELECTIVITY``), at least 1024,
        rounded up to a warm capacity (``_warm_cap``)."""
        if isinstance(root, (D.TopN, D.Limit)):
            return max(root.limit, 16)
        with self._pf_mu:
            fb = self._page_feedback.get(fb_key)
        if fb is not None:
            cap = _pow2_at_least(
                max(int(per_shard * min(fb * 1.5, 1.0)) + 1, 256))
        else:
            cap = max(_pow2_at_least(
                max(per_shard // INITIAL_SELECTIVITY, 1)), 1024)
        # a capacity whose program the cache already holds beats the
        # feedback guess
        return self._warm_cap(root, cap)

    def execute_rows(self, root: D.CopNode, snap: ColumnarSnapshot,
                     out_dtypes, dictionaries=None,
                     aux_cols=()) -> list[Column]:
        """The rows of a row-returning DAG, one ``Column`` per output,
        with the paging loop: re-run at a larger row capacity while a
        device returns more rows than the capacity holds (or an
        expanding join more rows than its capacity).  ``aux_cols`` as
        for ``execute_agg``.  A snapshot past ``device_mem_cap`` runs as
        streamed batches whose rows concatenate (a TopN or Limit root's
        candidates too: the caller re-trims them)."""
        return self._retry(lambda: self._execute_rows_once(
            root, snap, out_dtypes, dictionaries, aux_cols), snap=snap)

    def _execute_rows_once(self, root, snap, out_dtypes, dictionaries,
                           aux_cols) -> list[Column]:
        batches = self._stream_batches(root, snap, aux_cols)
        if batches is None:
            cols, counts = self._place(snap)
            return self._rows_program(root, snap, cols, counts, out_dtypes,
                                      dictionaries, aux_cols)
        self.timings = {}
        parts, recs = [], []
        t0 = time.perf_counter()
        for b in batches:
            check_killed()
            cols, counts, rec = self._put_batch(b)
            parts.append(self._rows_program(root, b, cols, counts,
                                            out_dtypes, dictionaries, ()))
            self._end_batch(rec)
            recs.append(rec)
            del cols, counts
        self.timings["stream"] = time.perf_counter() - t0
        self.timings["batches"] = self._batch_times(recs)
        return [Column.concat([p[j] for p in parts])
                for j in range(len(out_dtypes))]

    def _rows_program(self, root, snap, cols, counts, out_dtypes,
                      dictionaries, aux_cols) -> list[Column]:
        """The paging loop over one placement of ``snap``."""
        t = self.timings
        t["device"] = t["transfer"] = 0.0
        t["pages"] = []
        top = isinstance(root, (D.TopN, D.Limit))
        fb_key = D.dag_digest(root)
        per_shard = -(-snap.num_rows // max(snap.n_shards, 1)) \
            if snap.num_rows else 1
        cap = self._initial_row_capacity(root, fb_key, per_shard)
        for _ in range(10):
            t["pages"].append(cap)
            t0 = time.perf_counter()
            out, grown = self._launch(root, cols, counts, aux_cols, cap)
            _sync(self.devices)
            t1 = time.perf_counter()
            if grown is not None:
                t["device"] += t1 - t0
                root = grown
                continue
            out_cols, out_counts = out
            host_counts = out_counts.cpu().numpy()
            t["device"] += t1 - t0
            t["transfer"] += time.perf_counter() - t1
            if top or (host_counts <= cap).all():
                break
            cap = self._warm_cap(root,
                                 _pow2_at_least(int(host_counts.max())))
        else:
            raise RuntimeError("paging loop did not converge")
        with self._stat_mu:
            self.last_page_iters = len(t["pages"])
        if not top and per_shard > 0:
            frac = float(host_counts.max()) / per_shard
            with self._pf_mu:
                old = self._page_feedback.get(fb_key, frac)
                self._page_feedback[fb_key] = 0.5 * old + 0.5 * frac
                self._page_feedback.move_to_end(fb_key)
                while len(self._page_feedback) > PAGE_FEEDBACK_CAP:
                    self._page_feedback.popitem(last=False)
        return self._assemble_rows(out_cols, host_counts, cap, out_dtypes,
                                   dictionaries)

    def _assemble_rows(self, out_cols, host_counts, cap, out_dtypes,
                       dictionaries) -> list[Column]:
        """Each device's first ``min(count, cap)`` rows, concatenated on
        the card, moved to the host in one copy a column and decoded into
        host Columns."""
        _faults.check("transfer")   # faultline device->host seam
        t = self.timings
        t0 = time.perf_counter()
        take = np.minimum(host_counts, cap)
        parts = [(torch.cat([v[d, :take[d]] for d in range(len(take))]),
                  torch.cat([m[d, :take[d]] for d in range(len(take))]))
                 for v, m in out_cols]
        host = [(v.cpu().numpy(), m.cpu().numpy()) for v, m in parts]
        t1 = time.perf_counter()
        t["transfer"] += t1 - t0
        result = []
        for j, (ty, (data, valid)) in enumerate(zip(out_dtypes, host)):
            dic = dictionaries.get(j) if dictionaries else None
            result.append(Column(ty, data.astype(ty.np_dtype()), valid, dic))
        t["assemble"] = time.perf_counter() - t1
        return result

    # ------------------------------------------------------------- #
    # the repartition (shuffle) join: parallel/shuffle.py
    # ------------------------------------------------------------- #

    def _shuffle_initial_caps(self, lsnap, rsnap, row_cap: int):
        """Expected send-bucket rows under a uniform hash with 2x
        headroom, the join output at twice a device's left rows; each
        grown from the reported true maxima on overflow."""
        n_dev = len(self.devices)
        lcap = _pow2_at_least(
            max(2 * lsnap.num_rows // max(n_dev * n_dev, 1) + 1, 1024))
        rcap = _pow2_at_least(
            max(2 * rsnap.num_rows // max(n_dev * n_dev, 1) + 1, 1024))
        ocap = _pow2_at_least(max(2 * lsnap.num_rows // n_dev + 1, 1024))
        return ShuffleCaps(lcap, rcap, ocap, row_cap)

    def _run_shuffle(self, spec: D.ShuffleJoinSpec, lsnap, rsnap, aux_cols,
                     row_cap: int = 0):
        """Run the shuffle program, regrowing whichever static capacity
        (exchange buckets, join output, group table, row output) the
        extras report as overflowed; returns ``(program, out)``."""
        self.timings = {}
        t = self.timings
        t0 = time.perf_counter()
        lcols, lcounts = lsnap.device_cols(self.devices)
        rcols, rcounts = rsnap.device_cols(self.devices)
        _sync(self.devices)
        t["place"] = time.perf_counter() - t0
        t["device"] = t["transfer"] = 0.0
        t["shuffles"] = []
        caps = self._shuffle_initial_caps(lsnap, rsnap, row_cap)
        agg = spec.top if isinstance(spec.top, D.Aggregation) else None
        if agg is not None and agg.strategy in D.HOST_MERGE_STRATEGIES \
                and not agg.state_capacity:
            spec = dataclasses.replace(spec, top=self._with_capacity(
                agg, DEFAULT_GROUP_CAPACITY))
        for _ in range(12):
            t["shuffles"].append(dataclasses.astuple(caps))
            prog = ShardedShuffleJoinProgram(spec, self.devices, caps)
            t0 = time.perf_counter()
            out, extras = self._launch_opaque(
                lambda p=prog: p(lcols, lcounts, rcols, rcounts, aux_cols),
                est_rows=lsnap.num_rows + rsnap.num_rows)
            _sync(self.devices)
            t1 = time.perf_counter()
            extras = {k: v.cpu().numpy() for k, v in extras.items()}
            t["device"] += t1 - t0
            t["transfer"] += time.perf_counter() - t1
            grew = False
            need_l = int(extras["lmax"].max())
            if need_l > caps.left:
                caps = dataclasses.replace(caps,
                                           left=_pow2_at_least(need_l))
                grew = True
            need_r = int(extras["rmax"].max())
            if need_r > caps.right:
                caps = dataclasses.replace(caps,
                                           right=_pow2_at_least(need_r))
                grew = True
            need_j = int(extras["join_total"].max())
            if spec.kind in ("inner", "left"):
                check_join_rows(need_j)
                if need_j > caps.out:
                    caps = dataclasses.replace(caps,
                                               out=_pow2_at_least(need_j))
                    grew = True
            if grew:
                continue
            agg = spec.top if isinstance(spec.top, D.Aggregation) else None
            if agg is not None and agg.strategy in D.HOST_MERGE_STRATEGIES:
                true_ng = int(out["__ngroups__"].max())
                if true_ng > agg.state_capacity:
                    spec = dataclasses.replace(spec, top=self._with_capacity(
                        agg, _pow2_at_least(true_ng)))
                    continue
            if agg is None:
                counts = out[1].cpu().numpy()
                if (counts > caps.rows).any():
                    caps = dataclasses.replace(
                        caps, rows=_pow2_at_least(int(counts.max())))
                    continue
            return prog, out
        raise RuntimeError("shuffle capacity regrow did not converge")

    def execute_shuffle_agg(self, spec: D.ShuffleJoinSpec, lsnap, rsnap,
                            key_meta: list[GroupKeyMeta],
                            aux_cols=()) -> CopResult:
        """The aggregation over a repartition join of two tables."""
        return self._retry(lambda: self._execute_shuffle_agg_once(
            spec, lsnap, rsnap, key_meta, aux_cols))

    def _execute_shuffle_agg_once(self, spec, lsnap, rsnap, key_meta,
                                  aux_cols) -> CopResult:
        prog, out = self._run_shuffle(spec, lsnap, rsnap, aux_cols)
        agg = prog.spec.top
        t = self.timings
        t0 = time.perf_counter()
        states = _to_numpy(out)
        t1 = time.perf_counter()
        t["transfer"] += t1 - t0
        if prog.host_merge:
            per_dev = [_index(states, d)
                       for d in range(len(states["__ngroups__"]))]
            merged = merge_sorted_states(agg, per_dev)
            key_cols, agg_cols = finalize_sorted(agg, merged, key_meta)
        else:
            key_cols, agg_cols = finalize(agg, merge_states([states]),
                                          key_meta)
        t["merge"] = time.perf_counter() - t1
        return CopResult(agg_cols, key_cols)

    def execute_shuffle_rows(self, spec: D.ShuffleJoinSpec, lsnap, rsnap,
                             out_dtypes, dictionaries=None,
                             aux_cols=()) -> list[Column]:
        """The rows of a row-returning chain over a repartition join of
        two tables."""
        return self._retry(lambda: self._execute_shuffle_rows_once(
            spec, lsnap, rsnap, out_dtypes, dictionaries, aux_cols))

    def _execute_shuffle_rows_once(self, spec, lsnap, rsnap, out_dtypes,
                                   dictionaries, aux_cols) -> list[Column]:
        n_dev = len(self.devices)
        if isinstance(spec.top, (D.TopN, D.Limit)):
            row_cap = max(spec.top.limit, 16)
        else:
            row_cap = _pow2_at_least(
                max(2 * lsnap.num_rows // max(n_dev, 1) + 1, 1024))
        prog, (out_cols, out_counts) = self._run_shuffle(
            spec, lsnap, rsnap, aux_cols, row_cap)
        return self._assemble_rows(out_cols, out_counts.cpu().numpy(),
                                   prog.caps.rows, out_dtypes, dictionaries)

    # ------------------------------------------------------------- #
    # window functions: parallel/window.py
    # ------------------------------------------------------------- #

    def execute_window(self, spec: D.WindowShuffleSpec,
                       snap: ColumnarSnapshot, out_dtypes,
                       dictionaries=None, aux_cols=()) -> list[Column]:
        """The rows of the hash-repartitioned window program: the send
        bucket capacity starts at the rows a bucket expects under a
        uniform hash with 2x headroom, and is regrown from the reported
        largest bucket (``wmax``) and re-run while one overflows."""
        return self._retry(lambda: self._execute_window_once(
            spec, snap, out_dtypes, dictionaries, aux_cols))

    def _execute_window_once(self, spec, snap, out_dtypes, dictionaries,
                             aux_cols) -> list[Column]:
        cols, counts = self._place(snap)
        t = self.timings
        t["device"] = t["transfer"] = 0.0
        t["windows"] = []
        n_dev = len(self.devices)
        cap = _pow2_at_least(
            max(2 * snap.num_rows // max(n_dev * n_dev, 1) + 1, 1024))
        for _ in range(10):
            t["windows"].append(cap)
            prog = ShardedWindowProgram(spec, self.devices, cap)
            t0 = time.perf_counter()
            (out_cols, out_counts), extras = self._launch_opaque(
                lambda p=prog: p(cols, counts, aux_cols),
                est_rows=snap.num_rows)
            _sync(self.devices)
            t1 = time.perf_counter()
            need = int(extras["wmax"].max())
            t["device"] += t1 - t0
            t["transfer"] += time.perf_counter() - t1
            if need <= cap:
                break
            cap = _pow2_at_least(need)
        else:
            raise RuntimeError("window bucket regrow did not converge")
        return self._assemble_rows(out_cols, out_counts.cpu().numpy(),
                                   n_dev * cap, out_dtypes, dictionaries)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _to_numpy(tree: dict) -> dict:
    """The state dict on the host, by one device-to-host copy: the
    leaves are packed as bytes into one buffer (widest dtype first, so
    every leaf stays aligned) and unpacked as views of the host copy."""
    leaves = sorted(_leaves(tree), key=lambda kv: -kv[1].element_size())
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for _, t in leaves])
    host = flat.cpu().numpy()
    out: dict = {}
    off = 0
    for path, t in leaves:
        nbytes = t.numel() * t.element_size()
        np_dt = torch.empty(0, dtype=t.dtype).numpy().dtype
        arr = host[off:off + nbytes].view(np_dt).reshape(tuple(t.shape))
        off += nbytes
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out


def _index(tree, d: int):
    if isinstance(tree, dict):
        return {k: _index(v, d) for k, v in tree.items()}
    return tree[d]


__all__ = ["CopClient", "CopResult", "DEFAULT_GROUP_CAPACITY",
           "INITIAL_SELECTIVITY", "RESULT_CACHE_ENTRIES"]
