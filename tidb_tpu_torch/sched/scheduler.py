# ported from tidb_tpu/sched/scheduler.py @ 02e96d8
"""Per-device admission scheduler: continuous micro-batching of
concurrent cop tasks.

Reference analog: tikv's unified read pool (resource-group-aware
priority queue in front of the storage threads) combined with the
continuous-batching admission loop of inference servers.  One scheduler
owns all launches onto one device tuple (the port's mesh: a card and
its count of logical devices, sched/task ``mesh_fingerprint``):

- CopClient dispatch does not call the device directly; it submits
  ``CopTask``s to a BOUNDED admission queue tagged by (program digest,
  capacity shape, resource group).  Overflow raises the MySQL-compatible
  "server is busy" error (9003) instead of growing memory without bound.
- A drain loop serves queues in weighted-fair order (stride scheduling
  over per-resource-group virtual time).
- Compatible tasks COALESCE into one launch: identical inputs (the same
  snapshot residents) share a single program call; distinct inputs of
  the same program stack along a batch-slot dim and run as ONE batched
  program call (spmd.get_batched_program for SCALAR/DENSE aggregations:
  one ``group_reduce_lanes`` call a logical device over every slot;
  spmd.get_batched_rows_program for row outputs), with states and rows
  split back per task.
- Compatible-but-NON-identical tasks FUSE: queued tasks sharing a
  contract-aware fusion key (one snapshot scan, one device tuple, one
  capacity signature — analysis.contracts.fusion_signature) but
  differing in filters or aggregates run as ONE FusedCopProgram call
  over the shared resident tensors; results demux back to each waiter.
- An adaptive micro-batch WINDOW holds the drain briefly for
  stragglers: per key, an EWMA of arrival gaps predicts whether a
  matching task is about to arrive (only within ``WINDOW_CAP_US``), and
  the window's hit-rate feedback decays a key whose holds do not pay.
- The drain ENFORCES resource-group RU budgets (rc/): every task is
  priced from its static LaunchCost at submit, and a group whose token
  bucket (plus bounded overdraft) cannot cover its head task's RUs is
  SKIPPED; riders from an exhausted group may not hitch onto another
  group's launch; debits happen pre-launch; a throttled task that
  overstays the max-queue deadline fails with 8252.
- Launches are SUPERVISED: a transient launch failure retries through
  the store Backoffer's DEVICE_FAILED budget, on the same device; a
  failing fused or batched launch is DEMUXED and its members retried
  solo, so one poisoned plan cannot take down innocent riders; an OOM
  (faults.is_oom_error: a CUDA OOM) bumps the digests' memory
  corrections and retries a group at reduced width, and fails a solo
  launch to its waiter, whose client walks its OOM ladder; a
  per-program-digest circuit breaker (faults/breaker) fails repeat
  offenders fast at submit with LaunchQuarantinedError.  The drain
  never runs a task on the CPU and never swaps a plain kernel version
  in: it raises what the launch raised.
- On the card the drain launches on the lead task's stream, after every
  member's ``ready`` event, and records ``launched`` for the waiters
  (sched/task); the measured peak of a launch is
  ``torch.cuda.max_memory_allocated`` around it (when it rose), less
  what was allocated before, plus the task's resident inputs.

Queue-wait, launch, coalesce and fusion stats feed utils/metrics, the
/sched status route, the statement's QueryHandle (``note_sched``) and
the calibration store (analysis/calibrate).  For a traced task (its
statement's ``obs/trace`` context, captured at submit) the drain
records the ``sched.queue``, ``sched.launch`` (with ``sched.compile``
and ``sched.fusion`` children), ``sched.retry`` and marker spans into
the statement's tree BEFORE it finishes the task, so a waiter that
renders its tree right after ``wait()`` sees them.  Warm launches feed
the roofline store (obs/roofline).  On the card a launch's host wall is
its enqueue: the drain records a CUDA event on the lead stream before
the launch beside ``launched`` after it (``LaunchTiming``), and the
launch's device time is read from the two once both have completed —
at the drain's next pickup, or by the waiter after its transfer — and
then annotates ``device_ms`` on each traced ``sched.launch`` span and
feeds the roofline store; no synchronize on the drain.  On the CPU the
roofline reads the drain's wall, as in the JAX package.  The
calibration store keeps the drain's wall on both (an enqueue on the
card: ROADMAP.md, Queue 2).  The JAX package's drain also warms
predicted fused variants in the background (a port program costs no
compile to hide) and feeds the coordination plane (ROADMAP.md, Queue 1
entry 12).

The drain thread starts lazily on first submit, exits after
``IDLE_EXIT_S`` idle, and an ``atexit`` hook stops every drain (failing
anything still queued) and synchronizes the card before the interpreter
tears down, so a drain holding CUDA work cannot abort the exit.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import random
import threading
import time
from collections import deque
from typing import Optional

import torch

from ..faults import plan as _faults
from ..faults.breaker import CircuitBreaker, LaunchQuarantinedError
from ..rc.controller import (DEFAULT_MAX_QUEUE_S, DEFAULT_OVERDRAFT_RU,
                             ResourceExhaustedError)
from ..rc.pricing import split_device_time, task_rus
from .task import CopTask, ServerBusyError, TaskCancelledError, _shape_sig

DEFAULT_QUEUE_DEPTH = 256
DEFAULT_MAX_COALESCE = 8
# a submit that finds the queue full waits this long for a slot before
# the 9003 busy error, while a drain is serving (not paused or closing,
# and never on the drain's own thread).  A waiter sleeps on a condition
# until the drain frees a slot, FIFO among waiters; a client that retries
# on 9003 instead re-runs its statement's host path each time, and each
# eager op of a launch takes the GIL back behind those threads (the
# client-go ServerIsBusy backoff's first sleep is 1-2 s)
BUSY_WAIT_S = 2.0
IDLE_EXIT_S = 5.0
# adaptive micro-batch window: never hold a launch longer than this, and
# only hold at all when the key's EWMA arrival gap predicts a straggler
# inside the cap (2 * gap <= cap)
WINDOW_CAP_US = 1000
# arrival gaps beyond this clamp before feeding the EWMA so one long lull
# cannot poison the estimate forever (it recovers in a few arrivals)
WINDOW_GAP_CLAMP_NS = 50_000_000
WAIT_SAMPLES = 2048              # ring of recent task waits (p50/p99)
# window FEEDBACK: per-key EWMA of whether a hold actually yielded
# riders.  A key whose holds rarely pay decays its window toward zero
# (scale = min(1, hit/0.5)); below the floor the hold is skipped
# outright until a hit recovers the estimate.
WINDOW_HIT_INIT = 0.5            # optimistic prior: full window at start
WINDOW_HIT_ALPHA = 0.25          # EWMA step per observed hold outcome
WINDOW_HIT_FLOOR = 0.05          # scale cutoff: ~10 straight misses
# while every queued group is RU-throttled the drain sleeps this long
# between cover re-checks (bucket refill is time-driven; submits still
# notify the condition immediately)
RC_RETRY_S = 0.01
# per-program-digest device-time attribution map: bounded + LRU-evicted
RC_DIGEST_CAP = 64
# verified, costed task keys remembered for repeated statements
ADMIT_MEMO_CAP = 256
# the measured launch peak (torch.cuda.max_memory_allocated around a
# launch; each read builds the allocator's stats) is taken for at most
# one launch in this many seconds
MEM_SAMPLE_S = 0.5
# launches on the card whose device time is not read yet (CUDA events
# still pending): a bounded ring — an overflowing one drops its oldest
TIMING_PENDING_CAP = 256


class LaunchTiming:
    """The device time of one launch on the card: ``start``, a CUDA
    event the drain records on the lead stream before the launch, and
    ``end``, the ``launched`` event after it.  ``settle`` reads the time
    once both events have completed (``Event.query``, never a
    synchronize), then annotates ``device_ms`` on the traced tasks'
    ``sched.launch`` spans and hands the launch's members and the time,
    split by the drain's weights, to ``observe`` (the roofline feed).
    ``members`` are ``_RoofMember``s, not the tasks: a pending record
    must not keep a streamed batch's input tensors alive.  Idempotent
    and thread-safe: the drain and the waiter may both call it."""

    __slots__ = ("start", "end", "members", "weights", "spans", "observe",
                 "device_ns", "_mu")

    def __init__(self, start, end, members: list, weights: list, observe):
        self.start = start
        self.end = end
        self.members = members
        self.weights = weights
        self.spans: list = []        # (SpanTree, sched.launch span id)
        self.observe = observe
        self.device_ns = 0           # 0 until settled
        self._mu = threading.Lock()

    def settle(self) -> bool:
        """True once the device time is read (now or before)."""
        with self._mu:
            if self.device_ns:
                return True
            if not self.end.query():
                return False
            self.device_ns = max(
                int(self.start.elapsed_time(self.end) * 1e6), 1)
            spans, members = self.spans, self.members
            self.spans, self.members = [], []
        device_ms = round(self.device_ns / 1e6, 3)
        for tree, sid in spans:
            tree.annotate(sid, device_ms=device_ms)
        self.observe(members, split_device_time(self.weights,
                                                self.device_ns))
        return True


class _RoofMember:
    """What the roofline feed reads of one served task: its program, its
    static cost, its device tuple, its measured peak and whether its
    launch built the program."""

    __slots__ = ("dag", "cost_static", "mesh", "hbm_measured",
                 "compile_miss")

    def __init__(self, t):
        self.dag = t.dag
        self.cost_static = t.cost_static
        self.mesh = t.mesh
        self.hbm_measured = t.hbm_measured
        self.compile_miss = t.compile_miss
# deadline-aware early shedding: a submit whose corrected-cost backlog
# (sum of the queue's measured expected service times) already exceeds
# this is rejected 9003 at the queue head — and an rc-limited waiter
# whose backlog exceeds its own max-queue deadline is rejected 8252.
# Only measured digests contribute, so an uncalibrated process never
# sheds.
SHED_MAX_BACKLOG_S = 30.0
# supervised-launch transient retry: total Backoffer sleep budget the
# drain will spend re-launching one batch before classifying the
# failure as persistent (DEVICE_FAILED curve, store/backoff.py)
DEFAULT_LAUNCH_RETRY_MS = 2000.0
# seeded jitter for the drain's Backoffer when no FaultPlan is armed:
# retry histories stay reproducible either way
RETRY_JITTER_SEED = 0x5EED


def _verify_enabled() -> bool:
    """Admission-time plan-contract verification (analysis/contracts):
    on by default, TIDB_TPU_VERIFY_PLAN=0 disables (bisecting aid)."""
    return os.environ.get("TIDB_TPU_VERIFY_PLAN", "") != "0"


class _GroupQ:
    """One resource group's FIFO + stride-scheduler state."""

    __slots__ = ("name", "weight", "vtime", "seq", "queue",
                 "tasks", "wait_ns", "rus", "throttled", "device_ns")

    def __init__(self, name: str, weight: float, seq: int,
                 vtime: float = 0.0):
        self.name = name
        self.weight = max(weight, 1e-6)
        self.vtime = vtime        # accumulated service / weight
        self.seq = seq            # tie-break: registration order
        self.queue: deque = deque()
        self.tasks = 0            # served (lifetime)
        self.wait_ns = 0
        self.rus = 0.0            # priced RUs launched (rc/pricing)
        self.throttled = 0        # drain passes that skipped this group
        self.device_ns = 0        # attributed launch wall time


class DeviceScheduler:
    """Admission queue + weighted-fair drain loop for one device tuple."""

    def __init__(self, max_depth: int = DEFAULT_QUEUE_DEPTH,
                 max_coalesce: int = DEFAULT_MAX_COALESCE):
        self.max_depth = max_depth
        self.max_coalesce = max_coalesce
        self.fusion_enable = True         # tidb_tpu_sched_fusion
        self.window_us = -1               # tidb_tpu_sched_window_us
                                          # (-1 adaptive, 0 off, >0 fixed)
        # HBM admission budget (tidb_tpu_sched_hbm_budget): -1 = derive
        # from the card's memory on first structured submit (0 =
        # unlimited on the CPU), 0 = unlimited, >0 = bytes
        self.hbm_budget = -1
        self._auto_budget: Optional[int] = None
        # resource control (rc/): RU-bucket enforcement at the drain;
        # the max-queue deadline bounds how long a throttled waiter queues
        self.rc_enable = True
        self.rc_overdraft_ru = DEFAULT_OVERDRAFT_RU
        self.rc_max_queue_s = DEFAULT_MAX_QUEUE_S
        # closed-loop calibration (analysis/calibrate): corrected
        # LaunchCost feeds RU pricing, budget admission, fusion caps, the
        # window, and the shedding; off = the static model untouched
        self.calibration_enable = True
        # the live device-memory ledger (obs/hbm) and measured launch
        # peaks feeding mem_factor (tidb_tpu_hbm_ledger)
        self.hbm_enable = True
        self._ledger_obj = None
        self._mem_sampled = 0.0           # monotonic s of the last measure
        # launches on the card whose device time is still to be read
        # (drain thread only)
        self._timings: deque = deque(maxlen=TIMING_PENDING_CAP)
        # launch supervision: per-digest circuit breaker consulted at
        # submit, transient-retry budget spent at the drain;
        # _retry_sleep is the Backoffer sleep seam (tests)
        self.breaker = CircuitBreaker()
        self.launch_retry_ms = DEFAULT_LAUNCH_RETRY_MS
        self._retry_sleep = time.sleep
        self.busy_wait_s = BUSY_WAIT_S
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        # submits waiting for a slot of a full queue (BUSY_WAIT_S)
        self._room = threading.Condition(self._mu)
        self._groups: dict[str, _GroupQ] = {}
        self._depth = 0
        self._gvt = 0.0           # global virtual time (newcomer floor)
        self._thread: Optional[threading.Thread] = None
        self._paused = False
        self._closing = False
        # micro-batch window bookkeeping: key -> last arrival ns / EWMA
        # arrival gap ns / EWMA hold hit-rate (tiny dicts, cleared when
        # they grow)
        self._fk_last: dict = {}
        self._fk_gap: dict = {}
        self._fk_hit: dict = {}
        self._wait_ring: deque = deque(maxlen=WAIT_SAMPLES)
        # lifetime counters (read by /sched, tests; metrics mirror them)
        self.launches = 0
        self.coalesced_launches = 0       # launches serving >= 2 tasks
        self.coalesced_tasks = 0          # tasks that rode a shared launch
        self.batched_launches = 0         # stacked-slot launches
        self.batched_rows_launches = 0    # rows-kind stacked launches
        self.fused_launches = 0           # cross-query fused launches
        self.fused_tasks = 0              # tasks served by a fused launch
        self.window_waits = 0             # drains that held for stragglers
        self.window_hits = 0              # holds that actually gained riders
        self.busy_rejects = 0
        self.budget_admitted = 0          # structured tasks costed + admitted
        self.budget_rejects = 0           # solo programs over budget (CostError)
        self.budget_deferrals = 0         # riders left queued by footprint cap
        self.last_launch_bytes = 0        # footprint of the last served batch
        # per-link transfer attribution (shardflow, parallel/topology):
        # statically-priced collective bytes of served tasks, split by
        # link class under the declared host view
        self.transfer_ici_bytes = 0
        self.transfer_dci_bytes = 0
        # buffer-donation accounting (analysis/lifetime DonationPlan)
        self.donated_launches = 0         # launches with donated inputs
        self.donated_tasks = 0            # tasks that requested donation
        self.donated_bytes = 0            # priced input bytes released
        self.compile_ns_total = 0         # summed per-launch program builds
        self.retried_launches = 0         # serve attempts re-run after a
                                          # transient launch failure
        self.retried_tasks = 0            # member tasks those retries span
        self.bisected_launches = 0        # failed group launches demuxed
        self.quarantined = 0              # submits failed fast by an OPEN
                                          # breaker (LaunchQuarantinedError)
        self.value_drifts = 0             # admitted tasks whose observed
                                          # column watermarks escaped the
                                          # plan's declared value interval
                                          # (valueflow stats drift)
        self.rc_throttled = 0             # drain passes that skipped a group
        self.rc_exhausted = 0             # waiters failed at the deadline
        self.rc_debited_ru = 0.0          # priced RUs debited pre-launch
        from ..analysis.calibrate import BoundedLRU
        self._digest_ns = BoundedLRU(RC_DIGEST_CAP)
        # admission memo: task key + aux shapes -> (dag, static cost)
        self._admit_memo = BoundedLRU(ADMIT_MEMO_CAP)
        self.oom_faults = 0               # OOM-classified launch failures
        self.oom_demuxed = 0              # OOM group launches retried at
                                          # reduced fusion width
        self.shed_rejects = 0             # submits shed at the queue head
        self._backlog_ns = 0              # expected service ns queued
        self.tasks_done = 0
        from ..utils.metrics import Histogram, global_registry
        reg = global_registry()
        self._m_depth = reg.gauge("tidb_tpu_sched_queue_depth",
                                  "device admission queue depth")
        self._m_tasks = reg.counter("tidb_tpu_sched_tasks_total",
                                    "cop tasks admitted", labels=("group",))
        self._m_busy = reg.counter("tidb_tpu_sched_busy_total",
                                   "admission rejections (queue full)")
        self._m_launch = reg.counter("tidb_tpu_sched_launch_total",
                                     "device launches", labels=("mode",))
        self._m_coal = reg.counter("tidb_tpu_sched_coalesced_tasks_total",
                                   "tasks served by a shared launch")
        self._m_fused = reg.counter("tidb_tpu_sched_fused_tasks_total",
                                    "tasks served by a cross-query "
                                    "fused launch")
        self._m_wait = reg.histogram("tidb_tpu_sched_wait_seconds",
                                     "admission queue wait")
        self._m_ru = reg.counter("tidb_tpu_sched_ru_total",
                                 "request units launched", labels=("group",))
        self._m_budget = reg.gauge("tidb_tpu_sched_hbm_budget_bytes",
                                   "HBM admission budget")
        self._m_launch_bytes = reg.gauge(
            "tidb_tpu_sched_launch_bytes",
            "estimated device bytes of the last served launch")
        self._m_badmit = reg.counter(
            "tidb_tpu_sched_budget_admitted_total",
            "structured tasks admitted under the HBM budget")
        self._m_brej = reg.counter(
            "tidb_tpu_sched_budget_rejects_total",
            "tasks rejected before launch: footprint over the HBM budget")
        self._m_bdefer = reg.counter(
            "tidb_tpu_sched_budget_deferrals_total",
            "riders deferred from a launch by the summed-footprint cap")
        self._m_retried = reg.counter(
            "tidb_tpu_sched_retried_total",
            "tasks re-launched after a transient device failure")
        self._m_quar = reg.counter(
            "tidb_tpu_sched_quarantined_total",
            "submits failed fast by an OPEN program circuit breaker")
        self._m_bisect = reg.counter(
            "tidb_tpu_sched_bisected_total",
            "failed group launches demuxed for blast-radius isolation")
        self._m_rc_throttle = reg.counter(
            "tidb_tpu_rc_throttled_total",
            "drain passes that skipped an RU-exhausted group",
            labels=("group",))
        self._m_rc_exhaust = reg.counter(
            "tidb_tpu_rc_exhausted_total",
            "waiters failed at the rc max-queue deadline",
            labels=("group",))
        self._m_rc_debit = reg.counter(
            "tidb_tpu_rc_ru_debited_total",
            "priced RUs debited pre-launch", labels=("group",))
        self._m_rc_overdraft = reg.gauge(
            "tidb_tpu_rc_overdraft_ru",
            "bounded RU overdraft the drain tolerates per group")
        self._m_rc_overdraft.set(self.rc_overdraft_ru)
        self._m_oom = reg.counter(
            "tidb_tpu_sched_oom_total",
            "OOM-classified launch failures recovered without charging "
            "the circuit breaker")
        self._m_shed = reg.counter(
            "tidb_tpu_sched_shed_total",
            "submits shed at the queue head: corrected-cost backlog "
            "already exceeded the waiter's deadline")
        ms = Histogram.MS_BUCKETS
        self._m_wait_ms = reg.histogram(
            "tidb_tpu_sched_wait_ms",
            "admission queue wait per task (ms)", buckets=ms)
        self._m_launch_ms = reg.histogram(
            "tidb_tpu_sched_launch_ms",
            "device launch wall time per launch (ms)", buckets=ms)
        self._m_compile_ms = reg.histogram(
            "tidb_tpu_sched_compile_ms",
            "program build time per launch (ms)", buckets=ms)
        self._m_agg_ms = reg.histogram(
            "tidb_tpu_agg_launch_ms",
            "agg launch wall time by group strategy (ms)", buckets=ms,
            labels=("strategy",))

    # ------------------------------------------------------------- #
    # admission
    # ------------------------------------------------------------- #

    def configure(self, max_depth: Optional[int] = None,
                  max_coalesce: Optional[int] = None,
                  fusion: Optional[bool] = None,
                  window_us: Optional[int] = None,
                  hbm_budget: Optional[int] = None,
                  rc_enable: Optional[bool] = None,
                  rc_overdraft: Optional[float] = None,
                  calibration: Optional[bool] = None,
                  hbm_ledger: Optional[bool] = None) -> None:
        """Apply sysvar knobs; negative/None = keep current (window_us
        and hbm_budget are the exceptions: -1 means adaptive/auto,
        0 disables the hold / the budget)."""
        if max_depth is not None and max_depth > 0:
            self.max_depth = max_depth
        if max_coalesce is not None and max_coalesce > 0:
            self.max_coalesce = max_coalesce
        if fusion is not None:
            self.fusion_enable = bool(fusion)
        if window_us is not None and window_us >= -1:
            self.window_us = int(window_us)
        if hbm_budget is not None and hbm_budget >= -1:
            self.hbm_budget = int(hbm_budget)
        if rc_enable is not None:
            self.rc_enable = bool(rc_enable)
        if rc_overdraft is not None and rc_overdraft >= 0:
            self.rc_overdraft_ru = float(rc_overdraft)
            self._m_rc_overdraft.set(self.rc_overdraft_ru)
        if calibration is not None:
            self.calibration_enable = bool(calibration)
        if hbm_ledger is not None:
            self.hbm_enable = bool(hbm_ledger)

    # ---- HBM-budget admission (analysis/copcost) -------------------- #

    def effective_budget(self, mesh=None) -> int:
        """Resolved budget in bytes; 0 = unlimited.  -1 (auto) derives
        from the card's memory once (0 on the CPU)."""
        b = self.hbm_budget
        if b >= 0:
            return b
        if self._auto_budget is None:
            if mesh is None:
                return 0          # nothing to derive from yet
            from ..analysis.copcost import mesh_hbm_budget
            self._auto_budget = mesh_hbm_budget(mesh)
            self._m_budget.set(self._auto_budget)
        return self._auto_budget

    # ---- calibration (analysis/calibrate): measured-cost correction - #

    @staticmethod
    def _stable_digest(task) -> Optional[str]:
        """Restart-stable digest of a structured task's program — the
        key the correction store, the manifest and the quarantine purge
        share.  None for opaque tasks."""
        if task.dag is None:
            return None
        from ..analysis.compilekey import stable_digest
        return stable_digest(task.dag)

    def _calibrated_cost(self, task, cost):
        """Corrected LaunchCost for admission/pricing (clamped EWMA
        factors from the correction store); the static cost stays on
        ``task.cost_static`` so feedback never compounds on itself."""
        digest = self._stable_digest(task)
        if digest is None:
            return cost
        from ..analysis.calibrate import correction_store
        return correction_store().corrected_cost(digest, cost)

    def _expected_ns(self, task) -> int:
        """Measured expected service time of this task's program (EWMA,
        ns; 0 = never measured) — the shedding backlog unit."""
        if not self.calibration_enable:
            return 0
        digest = self._stable_digest(task)
        if digest is None:
            return 0
        from ..analysis.calibrate import correction_store
        return correction_store().expected_ns(digest)

    def _verified_cost(self, task: CopTask):
        """The contract check (analysis/contracts ``verify_task``) and the
        static LaunchCost of a structured task, memoized by its key and
        its aux shapes: both are functions of the DAG, the devices and
        the input shapes, which a repeated statement repeats."""
        from ..analysis.contracts import verify_task
        from ..analysis.copcost import task_cost
        mk = (task.key, tuple(_shape_sig(grp, None) for grp in task.aux))
        hit = self._admit_memo.get(mk)
        if hit is not None and (hit[0] is task.dag or hit[0] == task.dag):
            # what a repeat does not repeat: the proof registry's verdict
            # and the watermarks (valueflow) move with ANALYZE, and the
            # donation guard reads this task's own tensors (lifetime)
            from ..analysis.lifetime import verify_task_donation
            from ..analysis.valueflow import verify_task_values
            verify_task_values(task)
            if task.donate:
                verify_task_donation(task)
            return hit[1]
        verify_task(task)
        cost = task_cost(task)
        self._admit_memo.put(mk, (task.dag, cost))
        return cost

    def _admit_cost(self, task: CopTask, cost) -> None:
        """Static-footprint gate, run in the submitting thread BEFORE the
        drain could launch anything: the task's LaunchCost (tensor
        metadata only) must fit the budget, and every device node must
        have a statically derivable bound.  With calibration on, the
        budget comparison (and pricing, fusion caps, attribution weights
        downstream) uses the CORRECTED cost."""
        from ..analysis.copcost import CostError, format_bytes
        task.cost_static = task.cost = cost
        if cost is None:
            return
        if self.calibration_enable:
            cost = task.cost = self._calibrated_cost(task, cost)
        p = ("sched", type(task.dag).__name__)
        if cost.unbounded:
            raise CostError(
                "cost-unbounded", p,
                "no static device-footprint bound derivable for "
                f"{', '.join(cost.unbounded)}")
        if cost.dense_blowups:
            # degenerate DENSE at large NDV: reject before launch so
            # selection falls back to a radix strategy
            path, groups, rows = cost.dense_blowups[0]
            with self._mu:
                self.budget_rejects += 1
            self._m_brej.inc()
            raise CostError(
                "dense-blowup", p,
                f"DENSE aggregation at {path} holds {groups} group "
                f"states for {rows} per-device rows — degenerate "
                "large-NDV dense domain; use a radix strategy "
                "(GroupStrategy.SEGMENT/SCATTER)")
        budget = self.effective_budget(task.mesh)
        task.hbm_predicted = cost.peak_hbm_bytes
        if budget > 0 and cost.peak_hbm_bytes > budget:
            with self._mu:
                self.budget_rejects += 1
            self._m_brej.inc()
            raise CostError(
                "hbm-budget", p,
                f"estimated peak device bytes "
                f"{format_bytes(cost.peak_hbm_bytes)} exceed the "
                f"admission budget {format_bytes(budget)} "
                "(tidb_tpu_sched_hbm_budget)")
        with self._mu:
            self.budget_admitted += 1
        self._m_badmit.inc()

    def _shed_locked(self, task: CopTask) -> None:
        """Deadline-aware early shedding, called with _cv held BEFORE the
        task queues: when the corrected-cost backlog provably exceeds
        what this waiter can tolerate, fail it at the queue HEAD (rc
        waiters with 8252, others with the 9003 busy error).
        Conservative by construction: only MEASURED digests contribute
        to the backlog, so a cold process never sheds."""
        if not self.calibration_enable or self._backlog_ns <= 0:
            return
        deadline_ns = None
        if task.deadline_ns:
            deadline_ns = int(self.rc_max_queue_s * 1e9)
        elif self._backlog_ns > int(SHED_MAX_BACKLOG_S * 1e9):
            deadline_ns = int(SHED_MAX_BACKLOG_S * 1e9)
        if deadline_ns is None or self._backlog_ns <= deadline_ns:
            return
        self.shed_rejects += 1
        self._m_shed.inc()
        if task.key is not None:
            # a shed HALF_OPEN probe must release its probe slot
            self.breaker.abort_probe(task.key[0])
        if task.deadline_ns:
            raise ResourceExhaustedError(
                task.group, self._backlog_ns / 1e9, task.rus)
        raise ServerBusyError(self.max_depth)

    def _backlog_sub_locked(self, task: CopTask) -> None:
        """A queued task left the queue (served, expired, cancelled):
        release its expected-service contribution (clamped so
        bookkeeping drift can never wedge admission)."""
        self._backlog_ns = max(self._backlog_ns - task.svc_ns, 0)

    def _member_weights(self, tasks: list) -> list:
        """The weights a launch's time splits by across its members: the
        lead's peak (the shared scan is the lead's), each rider's
        marginal bytes."""
        lead = tasks[0]
        return [lead.cost.peak_hbm_bytes if lead.cost is not None else 0] \
            + [self._marginal_bytes(t, lead) for t in tasks[1:]]

    @staticmethod
    def _marginal_bytes(t: CopTask, lead: CopTask) -> int:
        """Bytes a rider ADDS to lead's launch: its payload only when it
        shares lead's resident scan (fusion / in-flight dedup), its full
        footprint when it brings distinct inputs (batch-slot stacking)."""
        if t.cost is None:
            return 0
        if t.input_token == lead.input_token:
            return t.cost.peak_hbm_bytes - t.cost.input_bytes
        return t.cost.peak_hbm_bytes

    def submit(self, task: CopTask) -> CopTask:
        """Enqueue; raises ServerBusyError when the bounded queue is
        full.  Structured tasks are contract-verified AND cost-gated on
        admission — a malformed task or an over-budget program is
        rejected with a structured PlanContractError/CostError HERE, in
        the submitting thread, before the drain would launch anything."""
        if task.key is not None and _verify_enabled():
            self._admit_cost(task, self._verified_cost(task))
            if task.value_drift:
                # valueflow watermark drift: the plan's declared value
                # interval no longer contains the observed ANALYZE
                # watermark — never wrong (proofs carry append
                # headroom), but the operator should re-ANALYZE
                with self._mu:
                    self.value_drifts += task.value_drift
        if task.key is not None:
            # circuit breaker: a digest whose launches keep failing is
            # quarantined HERE — fail fast with the structured error the
            # client's quarantine ladder understands
            try:
                self.breaker.admit(task.key[0])
            except LaunchQuarantinedError:
                with self._mu:
                    self.quarantined += 1
                self._m_quar.inc()
                self._trace_mark(task, "sched.quarantine",
                                 digest=f"{task.key[0] & ((1 << 64) - 1):016x}")
                if task.trace is not None:
                    task.trace.tree.flag("quarantined")
                raise
        # rc pricing in the submitting thread: structured tasks from the
        # LaunchCost the gate just computed, opaque ones from their row
        # estimate — the drain only compares and debits
        task.rus = task_rus(task)
        if self.rc_enable and task.rc_group is not None \
                and task.rc_group.limited:
            task.deadline_ns = task.submit_ns + \
                int(self.rc_max_queue_s * 1e9)
        task.svc_ns = self._expected_ns(task)
        with self._cv:
            if self._depth >= self.max_depth:
                self._wait_room_locked()
            if self._depth >= self.max_depth:
                self.busy_rejects += 1
                self._m_busy.inc()
                if task.key is not None:
                    # an admitted HALF_OPEN probe that never queues must
                    # release its slot or no probe could ever run
                    self.breaker.abort_probe(task.key[0])
                raise ServerBusyError(self.max_depth)
            self._shed_locked(task)
            g = self._groups.get(task.group)
            if g is None:
                g = self._groups[task.group] = _GroupQ(
                    task.group, task.weight, len(self._groups),
                    vtime=self._gvt)
            else:
                g.weight = max(task.weight, 1e-6)
                if not g.queue:
                    # re-activating group: forfeit banked idle time so it
                    # cannot starve others (stride newcomer rule)
                    g.vtime = max(g.vtime, self._gvt)
            g.queue.append(task)
            self._depth += 1
            self._backlog_ns += task.svc_ns
            self._note_arrival(task)
            self._m_depth.set(self._depth)
            self._m_tasks.inc(group=task.group)
            if self._thread is None:
                self._closing = False
                self._thread = threading.Thread(
                    target=self._loop, name="sched-drain", daemon=True)
                self._thread.start()
            self._cv.notify_all()
        return task

    def _wait_room_locked(self) -> None:
        """Wait up to ``busy_wait_s`` for a slot of the full queue while
        a drain serves it (called with _cv held); returns when a slot is
        free, or when the wait cannot be served (paused, closing, no
        drain, the drain's own thread) or has run out."""
        if self.busy_wait_s <= 0:
            return
        deadline = time.monotonic() + self.busy_wait_s
        while self._depth >= self.max_depth:
            if self._paused or self._closing or self._thread is None \
                    or self._thread is threading.current_thread():
                return
            left = deadline - time.monotonic()
            if left <= 0:
                return
            self._room.wait(left)

    def pause(self) -> None:
        """Hold the drain loop (tests / maintenance); submits still queue."""
        with self._cv:
            self._paused = True
            self._room.notify_all()

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop the drain: queued tasks fail (TaskCancelledError), the
        thread joins, and the card finishes the work already queued on
        it.  A later submit starts a new drain."""
        with self._cv:
            self._closing = True
            self._paused = False
            t = self._thread
            self._cv.notify_all()
            self._room.notify_all()
        if t is not None and t is not threading.current_thread():
            t.join(timeout)

    # ------------------------------------------------------------- #
    # drain loop
    # ------------------------------------------------------------- #

    def _pick(self) -> Optional[_GroupQ]:
        best = None
        for g in self._groups.values():
            if not g.queue:
                continue
            if self._rc_blocked(g):
                continue
            if best is None or (g.vtime, g.seq) < (best.vtime, best.seq):
                best = g
        return best

    # ---- resource-control enforcement (rc/: priced RU admission) ---- #

    def _task_bucket(self, t):
        """The RU bucket governing task ``t``; None = not enforced
        (rc disabled, no group attached, or the group is unlimited)."""
        if not self.rc_enable or t.rc_group is None:
            return None
        return t.rc_group.bucket if t.rc_group.limited else None

    def _rc_blocked(self, g: _GroupQ) -> bool:
        """May this group's HEAD task launch under its RU budget?  A
        blocked group is skipped by the fair pick; cancelled heads
        always pass so the drain can fail them out of the queue."""
        head = g.queue[0]
        if head.cancelled:
            return False
        b = self._task_bucket(head)
        if b is None or b.can_cover(head.rus, self.rc_overdraft_ru):
            return False
        g.throttled += 1
        self.rc_throttled += 1
        self._m_rc_throttle.inc(group=g.name)
        return True

    def _rc_covers(self, t, lead) -> bool:
        """May ``t`` ride lead's launch under t's OWN group budget?  A
        rider from an exhausted group must stay queued — otherwise
        fusion would be an RU-bypass."""
        b = self._task_bucket(t)
        return b is None or b.can_cover(task_rus(t, lead),
                                        self.rc_overdraft_ru)

    def _rc_debit(self, t, lead=None) -> None:
        """Pre-launch debit at batch admission: the task's priced RUs
        (marginal when it shares lead's resident scan) leave its group's
        bucket BEFORE anything launches."""
        rus = task_rus(t, lead)
        t.rus_charged = rus
        b = self._task_bucket(t)
        if b is not None:
            b.debit(rus)
            self.rc_debited_ru += rus
            self._m_rc_debit.inc(rus, group=t.group)

    def _rc_expire_locked(self) -> None:
        """Fail throttled waiters that overstayed the max-queue deadline
        with 8252 (called with _cv held).  Only tasks whose bucket STILL
        cannot cover them expire."""
        now = time.perf_counter_ns()
        expired = False
        for g in self._groups.values():
            if not g.queue:
                continue
            for t in list(g.queue):
                if not t.deadline_ns or now <= t.deadline_ns:
                    continue
                b = self._task_bucket(t)
                if b is not None and not b.can_cover(
                        t.rus, self.rc_overdraft_ru):
                    g.queue.remove(t)
                    self._depth -= 1
                    self._backlog_sub_locked(t)
                    self.rc_exhausted += 1
                    self._m_rc_exhaust.inc(group=g.name)
                    if t.trace is not None:
                        # the waiter never launched: its whole life was
                        # queue wait — record it with the expiry marked
                        t.trace.add("sched.queue", t.submit_ns, now,
                                    group=g.name, expired=True)
                    t.fail(ResourceExhaustedError(
                        t.group, (now - t.submit_ns) / 1e9, t.rus))
                    expired = True
        if expired:
            self._m_depth.set(self._depth)

    # ---- adaptive micro-batch window (EWMA of arrival gaps) --------- #

    def _note_arrival(self, task) -> None:
        """Track per-key arrival gaps (called with _cv held).  Plain
        coalescing benefits from the window too, so keyed tasks without
        a fusion key track under their task key."""
        fk = task.fusion_key if task.fusion_key is not None else task.key
        if fk is None:
            return
        if len(self._fk_last) > 256:      # hot keys are few; stay tiny
            self._fk_last.clear()
            self._fk_gap.clear()
            self._fk_hit.clear()
        last = self._fk_last.get(fk)
        self._fk_last[fk] = task.submit_ns
        if last is None:
            return
        gap = min(task.submit_ns - last, WINDOW_GAP_CLAMP_NS)
        prev = self._fk_gap.get(fk)
        self._fk_gap[fk] = gap if prev is None else \
            0.7 * prev + 0.3 * gap

    def _window_ns(self, lead) -> int:
        """How long the drain may hold ``lead`` waiting for stragglers.
        Fixed when the sysvar pins it; adaptive (-1) holds 2x the key's
        EWMA arrival gap SCALED by the key's observed hold hit-rate, and
        only when the base window fits the cap — a key whose matches
        arrive slowly never delays its own launch."""
        if lead.key is None:
            return 0
        if self.window_us == 0:
            return 0
        if self.window_us > 0:
            return self.window_us * 1000
        fk = lead.fusion_key if lead.fusion_key is not None else lead.key
        gap = self._fk_gap.get(fk)
        if gap is None:
            return 0
        w = int(2 * gap)
        if w > WINDOW_CAP_US * 1000:
            return 0
        scale = min(1.0, self._fk_hit.get(fk, WINDOW_HIT_INIT)
                    / WINDOW_HIT_INIT)
        if scale < WINDOW_HIT_FLOOR:
            return 0
        w = int(w * scale)
        if self.calibration_enable:
            # a hold only pays when it is small next to the launch it
            # delays: cap it at a quarter of the digest's MEASURED
            # launch time
            exp = self._expected_ns(lead)
            if exp:
                w = min(w, exp // 4)
        return w

    def _note_window_outcome(self, lead, hit: bool) -> None:
        """Feed one hold's outcome back into the key's hit-rate EWMA
        (called with _cv held, right after the hold resolves)."""
        fk = lead.fusion_key if lead.fusion_key is not None else lead.key
        if fk is None:
            return
        prev = self._fk_hit.get(fk, WINDOW_HIT_INIT)
        self._fk_hit[fk] = ((1.0 - WINDOW_HIT_ALPHA) * prev
                            + WINDOW_HIT_ALPHA * (1.0 if hit else 0.0))
        if hit:
            self.window_hits += 1

    # ---- batch assembly --------------------------------------------- #

    def _rides(self, t, lead) -> bool:
        """May ``t`` share lead's launch?  Same program (in-flight dedup
        / batch-slot stacking) or same fusion key with a different
        digest (cross-query fusion: one scan, many payloads)."""
        if t.cancelled:
            return False
        if (t.key == lead.key and t.mesh == lead.mesh
                and (t.dag is lead.dag or t.dag == lead.dag)):
            return True
        return (self.fusion_enable
                and lead.fusion_key is not None
                and t.fusion_key == lead.fusion_key
                and t.mesh == lead.mesh)

    def _collect_riders(self, lead, batch: list) -> None:
        """Pop every queued rider across ALL groups — coalescing and
        fusion are cross-session by design.  Each rider charges its own
        group's virtual time.  Group size is capped by SUMMED static
        footprint against the budget, with the member count cap
        (tidb_tpu_sched_max_coalesce) still the outer bound."""
        budget = self.effective_budget(lead.mesh)
        footprint = lead.cost.peak_hbm_bytes if lead.cost is not None else 0
        for og in self._groups.values():
            if len(batch) >= self.max_coalesce:
                break
            kept: deque = deque()
            while og.queue:
                t = og.queue.popleft()
                if len(batch) < self.max_coalesce \
                        and self._rides(t, lead) \
                        and self._rc_covers(t, lead):
                    add = self._marginal_bytes(t, lead)
                    if budget > 0 and footprint and \
                            footprint + add > budget:
                        # over the summed-footprint cap: defer — the
                        # rider stays queued and leads a later launch
                        self.budget_deferrals += 1
                        self._m_bdefer.inc()
                        kept.append(t)
                        continue
                    footprint += add
                    self._rc_debit(t, lead)
                    batch.append(t)
                    self._depth -= 1
                    self._backlog_sub_locked(t)
                    og.vtime += 1.0 / og.weight
                    og.tasks += 1
                else:
                    kept.append(t)
            og.queue = kept

    def _take_batch(self) -> list:
        """Pop the fair-ordered head task plus every compatible queued
        rider; optionally hold inside the micro-batch window so
        stragglers that are statistically about to arrive coalesce or
        fuse instead of launching apart."""
        self._rc_expire_locked()
        g = self._pick()
        if g is None:
            return []
        lead = g.queue.popleft()
        self._depth -= 1
        self._backlog_sub_locked(lead)
        g.vtime += 1.0 / g.weight
        self._gvt = g.vtime
        g.tasks += 1
        if lead.cancelled:
            self._m_depth.set(self._depth)
            lead.fail(TaskCancelledError())
            return [None]          # sentinel: retry pick
        self._rc_debit(lead)
        batch = [lead]
        if lead.key is not None:
            self._collect_riders(lead, batch)
            w_ns = self._window_ns(lead)
            if w_ns > 0 and len(batch) < self.max_coalesce:
                # wait-for-stragglers: _cv.wait releases the lock, so
                # submits land and notify; re-collect after each wake
                deadline = time.perf_counter_ns() + w_ns
                self.window_waits += 1
                held_at = len(batch)
                while len(batch) < self.max_coalesce:
                    rem_ns = deadline - time.perf_counter_ns()
                    if rem_ns <= 0:
                        break
                    self._cv.wait(rem_ns / 1e9)
                    self._collect_riders(lead, batch)
                self._note_window_outcome(lead, len(batch) > held_at)
        self._m_depth.set(self._depth)
        return batch

    def _fail_queued_locked(self, exc_type) -> None:
        """Fail every queued task (drain exit: shutdown, or a fault in
        the loop itself) — a waiter is never left blocked."""
        for g in self._groups.values():
            while g.queue:
                t = g.queue.popleft()
                self._backlog_sub_locked(t)
                t.fail(exc_type())
        self._depth = 0
        self._m_depth.set(0)
        self._room.notify_all()

    def _loop(self) -> None:
        try:
            self._drain()
        except BaseException:  # noqa: BLE001 - the drain must never
            # leave a waiter blocked: fail what is queued, then let the
            # next submit start a new drain
            with self._cv:
                self._fail_queued_locked(TaskCancelledError)
                self._thread = None
            raise

    def _drain(self) -> None:
        idle_since = time.monotonic()
        while True:
            with self._cv:
                while self._paused or self._depth == 0 or self._closing:
                    if self._closing:
                        self._fail_queued_locked(TaskCancelledError)
                        self._thread = None
                        return
                    if self._depth == 0 and not self._paused and \
                            time.monotonic() - idle_since > IDLE_EXIT_S:
                        self._thread = None
                        return
                    self._cv.wait(timeout=0.5)
                batch = self._take_batch()
                self._room.notify(self.max_depth - self._depth)
                if not batch and self._depth > 0:
                    # every queued group is RU-throttled: their waiters
                    # stay queued until a refill covers a head task or the
                    # max-queue deadline expires them; sleep briefly —
                    # submits still notify the condition
                    self._cv.wait(timeout=RC_RETRY_S)
            idle_since = time.monotonic()
            if self._timings:
                self._settle_timings()
            if not batch or batch == [None]:
                continue
            now = time.perf_counter_ns()
            for t in batch:
                t.start_ns = now
                t.wait_ns = now - t.submit_ns
            led = None
            eph = 0
            try:
                self._note_launch_bytes(batch)
                led = self._ledger(batch[0].mesh)
                if led is not None:
                    eph = self._launch_ephemeral_bytes(batch)
                    led.launch_begin(eph)
                with self._on_stream(batch):
                    self._serve_supervised(batch)
                # the waiters are finished: hand them the interpreter
                # before the drain's bookkeeping below
                time.sleep(0)
            except BaseException as e:  # noqa: BLE001 supervisor safety
                for t in batch:         # net: the drain must never die
                    t.fail(e)
            finally:
                if led is not None:
                    led.launch_end(eph)
                    measured = max(
                        (t.hbm_measured for t in batch), default=0)
                    if measured > 0:
                        led.note_measured(measured)
            try:
                self._attribute_launch(batch,
                                       time.perf_counter_ns() - now)
                self._account(batch)
            except Exception:   # noqa: BLE001 - accounting is
                pass            # observability; never kills the drain

    # ------------------------------------------------------------- #
    # streams, memory ledger, build attribution
    # ------------------------------------------------------------- #

    @staticmethod
    @contextlib.contextmanager
    def _on_stream(batch: list):
        """Launch on the lead's stream after every member's ``ready``
        event (sched/task); a no-op off the card."""
        lead = batch[0]
        if lead.stream is None:
            yield
            return
        for t in batch:
            if t.ready is not None and t.stream != lead.stream:
                lead.stream.wait_event(t.ready)
        with torch.cuda.stream(lead.stream):
            yield

    @staticmethod
    def _device_mark(lead):
        """A CUDA event recorded on the current (the lead's) stream just
        before a launch, the start of its device time; None off the
        card."""
        if lead.stream is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(lead.mesh[0]))
        return ev

    @staticmethod
    def _mark_launched(tasks: list):
        """Record the launch's end on the current (the lead's) stream for
        the waiters, BEFORE they are finished; returns the event (None
        off the card)."""
        lead = tasks[0]
        if lead.stream is None:
            return None
        stream = torch.cuda.current_stream(lead.mesh[0])
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        for t in tasks:
            t.launched = (ev, stream)
        return ev

    def _launch_timing(self, tasks: list, start, end):
        """The device-time record of a launch on the card (``start``
        before it, ``end`` after it), stamped on its tasks and queued
        for the drain's next pickup; None off the card."""
        if start is None or end is None:
            return None
        timing = LaunchTiming(start, end, [_RoofMember(t) for t in tasks],
                              self._member_weights(tasks),
                              self._observe_roofline_safe)
        for t in tasks:
            t.timing = timing
        self._timings.append(timing)
        return timing

    def _settle_timings(self) -> None:
        """Read the device time of every pending launch whose events have
        completed (drain thread, at pickup; never a synchronize)."""
        keep = [t for t in self._timings if not t.settle()]
        self._timings.clear()
        self._timings.extend(keep)

    def _ledger(self, mesh):
        """This device tuple's live HBM ledger; None when it is off."""
        if not self.hbm_enable or mesh is None:
            return None
        led = self._ledger_obj
        if led is None:
            from ..obs.hbm import ledger_for
            from .task import mesh_fingerprint
            led = self._ledger_obj = ledger_for(mesh_fingerprint(mesh))
        return led

    def _launch_ephemeral_bytes(self, batch: list) -> int:
        """Bytes this launch adds ON TOP of the resident inputs: the
        lead's peak minus its scan inputs, plus each rider's marginal
        bytes."""
        lead = batch[0]
        if lead.cost is None:
            return 0
        n = lead.cost.peak_hbm_bytes
        from ..analysis.lifetime import is_resident
        if is_resident(lead.counts):
            # live snapshot-cache inputs are already on the ledger's
            # persistent side; donated bytes are credited at dispatch
            # by construction (``peak_hbm_bytes`` subtracts them)
            n -= lead.cost.input_bytes
        n += sum(self._marginal_bytes(t, lead) for t in batch[1:])
        return max(n, 0)

    def _mem_mark(self, tasks: list) -> tuple:
        """What the card has allocated now and its peak so far, before a
        launch that is measured (one in ``MEM_SAMPLE_S``); ``(0, 0)``
        for one that is not, off the card or with the ledger off.  The
        peak counter is never reset: other readers of it keep theirs."""
        lead = tasks[0]
        if not self.hbm_enable or lead.mesh is None \
                or lead.mesh[0].type != "cuda":
            return (0, 0)
        now = time.monotonic()
        if now - self._mem_sampled < MEM_SAMPLE_S:
            return (0, 0)
        self._mem_sampled = now
        dev = lead.mesh[0]
        return (torch.cuda.memory_allocated(dev),
                torch.cuda.max_memory_allocated(dev))

    def _mem_note(self, tasks: list, before: tuple) -> int:
        """Measured peak of the launch that just ran, stamped onto every
        task BEFORE finish: when the card's peak allocation
        (``torch.cuda.max_memory_allocated``) rose during the launch, the
        new peak over what was allocated before it, plus the lead's
        resident inputs; 0 (not measured) for a launch ``_mem_mark`` did
        not sample, or when an earlier peak hides the launch's."""
        lead = tasks[0]
        if before == (0, 0):
            return 0
        peak = torch.cuda.max_memory_allocated(lead.mesh[0])
        if peak <= before[1]:
            return 0
        inputs = lead.cost_static.input_bytes \
            if lead.cost_static is not None else 0
        measured = peak - before[0] + inputs
        for t in tasks:
            t.hbm_measured = measured
        return measured

    @staticmethod
    def _cc_mark() -> tuple:
        """Drain-thread snapshot of the program cache's per-thread build
        totals (ns, misses, hits)."""
        from ..compilecache import compile_cache
        return compile_cache().thread_snapshot()

    def _cc_note(self, tasks: list, mark: tuple) -> None:
        """Attribute the program build time since ``mark`` to every task
        of the launch BEFORE it finishes."""
        from ..compilecache import compile_cache
        ns, misses, _hits = compile_cache().thread_snapshot()
        dns, dmiss = ns - mark[0], misses - mark[1]
        if dns <= 0 and dmiss <= 0:
            return
        self.compile_ns_total += dns
        if dns > 0:
            self._m_compile_ms.observe(dns / 1e6)
        for t in tasks:
            t.compile_ns += dns
            if dmiss:
                t.compile_miss = True

    @staticmethod
    def _strategy_of(dag) -> Optional[str]:
        s = getattr(dag, "strategy", None)
        return getattr(s, "value", None) if s is not None else None

    @staticmethod
    def _err_label(e: BaseException) -> str:
        return f"{type(e).__name__}: {str(e)[:80]}"

    @staticmethod
    def _trace_mark(t, name: str, **attrs) -> None:
        """Zero-duration marker span on one task's trace (oom / bisect
        / quarantine / fail seams); no-op when untraced."""
        if t.trace is not None:
            now = time.perf_counter_ns()
            t.trace.add(name, now, now, **attrs)

    def _trace_launch(self, tasks: list, start_ns: int, end_ns: int,
                      mode: str, fused: int = 0, timing=None) -> None:
        """Record one physical launch's scheduler-side span tree +
        latency histograms, on the DRAIN thread BEFORE the tasks
        finish — a waiter rendering its trace right after wait()
        always sees these spans (no post-finish race).

        Per traced task: a ``sched.queue`` span (submit -> drain
        pickup; rc debit rides it as the ``ru`` attr) and a
        ``sched.launch`` span (resolve + launch) carrying predicted_ms
        (calibrated LaunchCost) vs measured_ms (the drain's wall: on the
        card the enqueue) and device_ms (on the card annotated from the
        launch's CUDA events once ``timing`` settles; on the CPU the
        wall), the memory axis, and — as children — the ``sched.compile``
        span (hit/miss) and the ``sched.fusion`` assembly span with the
        member count and this member's attributed share."""
        wall_ms = (end_ns - start_ns) / 1e6
        self._m_launch_ms.observe(wall_ms)
        for strat in {self._strategy_of(t.dag) for t in tasks} - {None}:
            self._m_agg_ms.observe(wall_ms, strategy=strat)
        if all(t.trace is None for t in tasks):
            return
        shares = None
        if fused > 1 or len(tasks) > 1:
            shares = split_device_time(self._member_weights(tasks),
                                       end_ns - start_ns)
        from ..analysis.calibrate import predict_ms
        for i, t in enumerate(tasks):
            ctx = t.trace
            if ctx is None:
                continue
            attrs = {"mode": mode, "measured_ms": round(wall_ms, 3)}
            if timing is None:
                attrs["device_ms"] = round(wall_ms, 3)
            if t.cost is not None:
                attrs["predicted_ms"] = round(predict_ms(t.cost), 3)
                bd = t.cost.transfer_breakdown or (0, 0, 0)
                if bd[1] or bd[2]:
                    attrs["ici_bytes"], attrs["dci_bytes"] = bd[1], bd[2]
            # the memory axis of the launch span — the admission
            # prediction next to the measured peak
            if t.hbm_predicted:
                attrs["hbm_predicted"] = t.hbm_predicted
            if t.hbm_measured:
                attrs["hbm_measured"] = t.hbm_measured
            if t.value_drift:
                # valueflow: declared interval no longer contains the
                # observed watermark (stats drift, not a wrong result)
                attrs["value_drift"] = t.value_drift
            strat = self._strategy_of(t.dag)
            if strat is not None:
                attrs["strategy"] = strat
            if t.retries:
                attrs["retries"] = t.retries
            items = [
                ("sched.queue", t.submit_ns, t.start_ns, ctx.span_id,
                 {"group": t.group, "ru": round(t.rus_charged, 2)}),
                ("sched.launch", start_ns, end_ns, ctx.span_id, attrs),
            ]
            if t.compile_ns:
                items.append((
                    "sched.compile", start_ns, start_ns + t.compile_ns,
                    ("rel", 1),
                    {"result": "miss" if t.compile_miss else "hit"}))
            if fused > 1:
                fat = {"members": fused}
                if shares is not None:
                    fat["share_ms"] = round(shares[i] / 1e6, 3)
                items.append(("sched.fusion", t.start_ns, start_ns,
                              ("rel", 1), fat))
            sids = ctx.tree.add_batch(items)
            if timing is not None:
                timing.spans.append((ctx.tree, sids[1]))

    def _trace_retry(self, tasks: list, err: BaseException,
                     start_ns: int, end_ns: int) -> None:
        """One transient-failure backoff cycle: a real span covering
        the retry sleep, per affected waiter."""
        label = self._err_label(err)
        for t in tasks:
            if t.trace is not None:
                t.trace.add("sched.retry", start_ns, end_ns,
                            attempt=t.retries, error=label)

    # ------------------------------------------------------------- #
    # launch supervision
    # ------------------------------------------------------------- #

    @staticmethod
    def _digests(tasks: list) -> set:
        return {t.key[0] for t in tasks if t.key is not None}

    @staticmethod
    def _is_transient(e: BaseException) -> bool:
        """Retry-worthy launch failures: injected transient faults and
        typed retryable dispatch errors.  Everything else is treated as
        persistent: retrying an identical program would fail again, so
        it fails (and charges the breaker) instead."""
        from ..store.backoff import RegionError
        return isinstance(e, (_faults.TransientFault, RegionError))

    @staticmethod
    def _is_fatal(e: BaseException) -> bool:
        """Never retried, never breaker-charged: cancellation and
        interpreter teardown."""
        from ..copr.coordinator import QueryInterrupted
        return isinstance(e, (TaskCancelledError, QueryInterrupted,
                              KeyboardInterrupt, SystemExit))

    def _launch_backoffer(self):
        from ..store.backoff import Backoffer
        fp = _faults.active()
        rng = fp.backoff_rng() if fp is not None \
            else random.Random(RETRY_JITTER_SEED)
        return Backoffer(max_sleep_ms=self.launch_retry_ms,
                         sleep_fn=self._retry_sleep, rng=rng)

    def _serve_supervised(self, batch: list) -> None:
        """Serve a batch under the retry/breaker contract: transient
        failures re-launch through the DEVICE_FAILED backoff budget
        (already-finished members are never re-run), persistent failures
        go to blast-radius isolation, cancelled waiters fail typed and
        are never retried.  Successful launches clear their digests'
        breaker state."""
        from ..store.backoff import DEVICE_FAILED, RetryBudgetExceeded
        bo = None
        while True:
            live = []
            for t in batch:
                if t.done:
                    continue
                if t.cancelled:
                    t.fail(TaskCancelledError())
                    continue
                live.append(t)
            if not live:
                return
            try:
                _faults.check("drain")
                self._serve(live)
            except BaseException as e:  # noqa: BLE001 classified below
                if self._is_fatal(e):
                    for t in live:
                        t.fail(e)
                    return
                if _faults.is_oom_error(e):
                    # memory exhaustion is its own class: a healthy
                    # program outgrew the memory — recover by shrinking
                    # the launch, never by charging the poison breaker
                    self._handle_oom([t for t in batch if not t.done], e)
                    return
                if self._is_transient(e):
                    if bo is None:
                        bo = self._launch_backoffer()
                    retry_t0 = time.perf_counter_ns()
                    try:
                        bo.backoff(DEVICE_FAILED, e)
                    except RetryBudgetExceeded as budget:
                        self._isolate(
                            [t for t in batch if not t.done], budget)
                        return
                    self.retried_launches += 1
                    self.retried_tasks += len(live)
                    self._m_retried.inc(len(live))
                    for t in live:
                        t.retries += 1
                    self._trace_retry(live, e, retry_t0,
                                      time.perf_counter_ns())
                    continue
                self._isolate([t for t in batch if not t.done], e)
                return
            else:
                for d in self._digests(live):
                    self.breaker.record_success(d)
                return

    @staticmethod
    def _members(live: list) -> list:
        """The tasks grouped by (program, input): the solo launches a
        group launch demuxes into."""
        subs: list = []
        by_member: dict = {}
        for t in live:
            k = (t.key, t.input_token)
            g = by_member.get(k)
            if g is None:
                g = by_member[k] = []
                subs.append(g)
            g.append(t)
        return subs

    def _handle_oom(self, live: list, err: BaseException) -> None:
        """OOM-classified launch failure (a CUDA OOM): a healthy program
        whose modeled footprint was too small, NOT a poisoned kernel.
        Bump every member digest's memory correction (so future
        admission sees the bigger footprint), retry group launches at
        reduced fusion width (the members relaunch solo), and fail a
        solo launch to its waiter — whose CopClient recovers through its
        OOM ladder (streamed batches).  The breaker is NEVER charged."""
        self.oom_faults += 1
        self._m_oom.inc()
        for t in live:
            self._trace_mark(t, "sched.oom", error=self._err_label(err))
            if t.trace is not None:
                t.trace.tree.flag("oom")
        if self.calibration_enable:
            from ..analysis.calibrate import correction_store
            store = correction_store()
            for digest in sorted({d for d in map(self._stable_digest,
                                                 live) if d is not None}):
                store.observe_oom(digest)
            store.sync_manifest()
        subs = self._members(live)
        if len(subs) <= 1:
            for t in live:
                t.fail(err)
            return
        self.oom_demuxed += 1
        for sub in subs:
            # reduced fusion width: each member relaunches alone; a
            # member that STILL OOMs solo lands in the fail branch above
            self._serve_supervised(sub)

    def _isolate(self, live: list, err: BaseException) -> None:
        """Blast-radius isolation: a failed GROUP launch (fused members
        and/or batched slots) is demuxed into its (program, input)
        members and each retried SOLO — innocent riders complete, only
        the poisoned member fails its waiter and charges its digest's
        breaker.  A launch that was already solo is the base case: fail
        and charge."""
        subs = self._members(live)
        if len(subs) <= 1:
            for d in self._digests(live):
                self.breaker.record_failure(d)
                if self.breaker.state(d) == "OPEN":
                    # an OPEN breaker must not warm-replay after a
                    # restart: purge the digest's manifest entries
                    self._cc_quarantine(d, live)
            for t in live:
                self._trace_mark(t, "sched.fail",
                                 error=self._err_label(err))
                t.fail(err)
            return
        self.bisected_launches += 1
        self._m_bisect.inc()
        for t in live:
            self._trace_mark(t, "sched.bisect", members=len(subs))
        for sub in subs:
            self._serve_supervised(sub)

    @staticmethod
    def _cc_quarantine(digest: int, live: list) -> None:
        """Map the breaker's process-local digest to the restart-stable
        one and purge it from the program cache's manifest."""
        from ..analysis.compilekey import stable_digest
        from ..compilecache import compile_cache
        for t in live:
            if t.key is not None and t.key[0] == digest \
                    and t.dag is not None:
                sd = stable_digest(t.dag)
                compile_cache().quarantine(sd)
                # coplace: tombstone the digest for every peer so a
                # breaker-opened program is not laundered back through
                # a peer's warm pool (pd/registry); a no-op unless a
                # Domain of this process has a live coordinator
                from ..pd import broadcast_quarantine
                broadcast_quarantine(sd)
                return

    # ------------------------------------------------------------- #
    # launch
    # ------------------------------------------------------------- #

    def _note_launch_bytes(self, batch: list) -> None:
        """Static footprint of the batch about to launch (scan counted
        once per distinct input, payloads summed)."""
        lead = batch[0]
        if lead.cost is None:
            return
        est = lead.cost.peak_hbm_bytes + sum(
            self._marginal_bytes(t, lead) for t in batch[1:])
        self.last_launch_bytes = est
        self._m_launch_bytes.set(est)

    def _finish(self, tasks: list, value_of, t_l0: int,
                before: tuple, mode: str, start=None,
                fused: int = 0) -> None:
        """Stamp a launch's measured peak, ``launched`` event, device-time
        record (``start``: the event before the launch) and spans on its
        tasks, then finish each with ``value_of(task)``."""
        self._mem_note(tasks, before)
        end = self._mark_launched(tasks)
        timing = self._launch_timing(tasks, start, end)
        self._trace_launch(tasks, t_l0, time.perf_counter_ns(), mode,
                           fused=fused, timing=timing)
        for t in tasks:
            t.finish(value_of(t))

    def _serve(self, batch: list) -> None:
        lead = batch[0]
        if lead.fn is not None:                     # opaque launch
            # failures PROPAGATE so the supervisor classifies them
            _faults.check("launch")
            before = self._mem_mark([lead])
            t_l0 = time.perf_counter_ns()
            start = self._device_mark(lead)
            val = lead.fn()
            self._finish([lead], lambda _t: val, t_l0, before, "opaque",
                         start)
            self.launches += 1
            self._m_launch.inc(mode="single")
            return
        # partition by task key: a fusion batch carries several distinct
        # programs over one shared scan
        programs: list[list] = []
        by_key: dict = {}
        for t in batch:
            grp = by_key.get(t.key)
            if grp is None:
                grp = by_key[t.key] = []
                programs.append(grp)
            grp.append(t)
        if len(programs) > 1 and self._serve_fused(programs):
            return
        for grp in programs:
            self._serve_program(grp)
            self._note_coalesce(grp)

    def _serve_fused(self, programs: list) -> bool:
        """ONE program call computing every member program's payload
        over the shared resident tensors; False = refused by the
        contract check, the caller launches the programs apart.  Agg
        member groups run as a FusedCopProgram, rows groups as a
        FusedRowsProgram with per-member output capacities."""
        from ..analysis.contracts import (PlanContractError,
                                          verify_fusion_group)
        from ..copr import dag as D
        from ..parallel.spmd import (get_fused_program,
                                     get_fused_rows_program,
                                     get_sharded_program)
        members = [grp[0] for grp in programs]
        lead = members[0]
        try:
            # EVERY task (riders too): a same-key rider carrying a
            # different input token must refuse the fused scan — its
            # result would come from the wrong snapshot residents
            verify_fusion_group([t for grp in programs for t in grp])
        except PlanContractError:
            return False
        # the launch seam is consulted once PER MEMBER digest: a
        # poisoned member fails the fused launch, whose supervision
        # demuxes it into solo launches where the guilty member fails
        # ALONE
        for m in members:
            _faults.check("launch", m.key[0])
        cc0 = self._cc_mark()
        before = self._mem_mark(members)
        t_l0 = time.perf_counter_ns()
        fused = D.FusedDag(tuple(t.dag for t in members))
        if isinstance(lead.dag, D.Aggregation):
            fprog = get_fused_program(fused, lead.mesh,
                                      donate=lead.donate)
        else:
            fprog = get_fused_rows_program(
                fused, lead.mesh, tuple(t.row_capacity for t in members))
        start = self._device_mark(lead)
        outs = fprog(lead.cols, lead.counts)
        total = sum(len(grp) for grp in programs)
        all_tasks = [t for grp in programs for t in grp]
        self._cc_note(all_tasks, cc0)
        # fused/coalesced attrs are set BEFORE finish(): the waiter's
        # _note_sched reads them right after wait() returns
        out_of = {}
        for grp, out in zip(programs, outs):
            sprog = get_sharded_program(grp[0].dag, grp[0].mesh,
                                        grp[0].row_capacity)
            for t in grp:
                t.fused = len(programs)
                t.coalesced = total
                out_of[id(t)] = (sprog, out)
        self._finish(all_tasks, lambda t: out_of[id(t)], t_l0, before,
                     "fused", start, fused=len(programs))
        self.launches += 1
        if fprog._donate_argnums:
            self.donated_launches += 1
        self.fused_launches += 1
        self.fused_tasks += total
        self._m_launch.inc(mode="fused")
        self._m_fused.inc(total)
        return True

    def _serve_program(self, batch: list) -> None:
        """Launch ONE program's tasks: in-flight dedup by input token,
        batch-slot stacking for distinct inputs (SCALAR/DENSE aggs and
        extras-free row chains), per-slot launches otherwise."""
        lead = batch[0]
        from ..parallel.spmd import (batchable, get_batched_program,
                                     get_batched_rows_program,
                                     get_sharded_program)
        digest = lead.key[0] if lead.key is not None else None
        cc0 = self._cc_mark()
        t_l0 = time.perf_counter_ns()
        _faults.check("build", digest)
        prog = get_sharded_program(lead.dag, lead.mesh, lead.row_capacity,
                                   donate=lead.donate)
        _faults.check("launch", digest)
        # group riders by input identity: same-token tasks share ONE
        # program call (in-flight dedup)
        slots: list[list] = []
        by_token: dict = {}
        for t in batch:
            s = by_token.get(t.input_token)
            if s is None:
                s = by_token[t.input_token] = []
                slots.append(s)
            s.append(t)
        if len(slots) > 1 and batchable(prog) \
                and all(s[0].aux == () for s in slots):
            # distinct inputs, one program: stack along the batch-slot
            # dim, ONE batched call, split states/rows per task
            if prog.kind == "agg":
                bprog = get_batched_program(lead.dag, lead.mesh,
                                            len(slots))
            else:
                bprog = get_batched_rows_program(
                    lead.dag, lead.mesh, lead.row_capacity, len(slots))
            before = self._mem_mark(batch)
            start = self._device_mark(lead)
            outs = bprog([s[0].cols for s in slots],
                         [s[0].counts for s in slots])
            self._cc_note(batch, cc0)
            out_of = {}
            for s, out in zip(slots, outs):
                for t in s:
                    t.coalesced = len(batch)
                    out_of[id(t)] = (prog, out)
            self._finish(batch, lambda t: out_of[id(t)], t_l0, before,
                         "batched", start)
            self.launches += 1
            if bprog._donate_argnums:
                # the per-launch stacked copies were donated (the
                # lifetime plan's batched class), whatever the member
                # tensors' own lifetime
                self.donated_launches += 1
            self.batched_launches += 1
            if prog.kind == "rows":
                self.batched_rows_launches += 1
            self._m_launch.inc(mode="batched")
            return
        first = True
        for s in slots:
            t_s0 = t_l0 if first else time.perf_counter_ns()
            first = False
            before = self._mem_mark(s)
            start = self._device_mark(lead)
            out = prog(s[0].cols, s[0].counts, s[0].aux)
            # cumulative from the group's entry: a later slot DID wait
            # on the earlier slots' (and the lead's) program build
            self._cc_note(s, cc0)
            if len(batch) > 1:
                for t in s:
                    t.coalesced = len(batch)
            self._finish(s, lambda _t, out=out: (prog, out), t_s0, before,
                         "coalesced" if len(s) > 1 else "single", start)
            self.launches += 1
            if prog._donate_argnums:
                self.donated_launches += 1
            self._m_launch.inc(
                mode="coalesced" if len(s) > 1 else "single")

    def _note_coalesce(self, batch: list) -> None:
        if len(batch) > 1:
            self.coalesced_launches += 1
            self.coalesced_tasks += len(batch)
            self._m_coal.inc(len(batch))

    def _attribute_launch(self, batch: list, wall_ns: int) -> None:
        """Split one launch's measured wall time across its members by
        marginal bytes — the shared scan belongs to the lead, each rider
        weighs what it ADDED — so per-group and per-digest device time
        stays honest under fusion and coalescing."""
        lead = batch[0]
        for t, ns in zip(batch, split_device_time(
                self._member_weights(batch), wall_ns)):
            t.device_ns = ns
        if self.calibration_enable:
            self._observe_launch(batch)
        if lead.stream is None:
            # off the card the wall is the device's time (the JAX
            # package's feed); on the card LaunchTiming feeds the
            # roofline the launch's CUDA-event time once it settles
            self._observe_roofline_safe(
                [_RoofMember(t) for t in batch if not t.failed],
                [t.device_ns for t in batch if not t.failed])

    def _observe_roofline_safe(self, members: list, times_ns: list) -> None:
        """Roofline feedback: each warm member's attributed device time
        and static work terms land in the per-digest utilization store
        (obs/roofline), classifying the digest memory-/compute-/launch-
        bound against the device's peak table."""
        if not self.hbm_enable:
            return
        try:
            self._observe_roofline(members, times_ns)
        except Exception:   # noqa: BLE001 - pure observability: a
            # failed attribution must never kill the drain or a waiter
            pass

    def _observe_roofline(self, members: list, times_ns: list) -> None:
        from ..obs.roofline import peaks_for_mesh, roofline_store
        roof = roofline_store()
        for t, ns in zip(members, times_ns):
            if ns <= 0 or t.cost_static is None or t.compile_miss:
                # a launch that built its program measured the build
                continue
            digest = self._stable_digest(t)
            if digest is None:
                continue
            roof.observe(digest, t.cost_static, ns,
                         peaks_for_mesh(t.mesh),
                         measured_hbm=t.hbm_measured)

    def _observe_launch(self, batch: list) -> None:
        """Calibration feedback: each SERVED member's attributed wall
        time EWMAs into its digest's correction against the STATIC cost
        (never the corrected one: feedback must not compound on itself),
        then throttle-persists through the manifest."""
        from ..analysis.calibrate import correction_store
        store = correction_store()
        fed = False
        for t in batch:
            if t.failed or t.device_ns <= 0 or t.cost_static is None \
                    or t.compile_miss:
                # a launch that built its program measured the build,
                # not the program: only warm launches feed the loop
                continue
            digest = self._stable_digest(t)
            if digest is None:
                continue
            store.observe(digest, t.cost_static, t.device_ns)
            fed = True
        # the measured launch peak EWMAs the digest's mem_factor — only
        # for one-program launches, where the measured peak IS the
        # digest's program's
        lead = batch[0]
        if self.hbm_enable and lead.hbm_measured \
                and not lead.failed and lead.cost_static is not None \
                and all(t.key == lead.key for t in batch):
            digest = self._stable_digest(lead)
            if digest is not None:
                store.observe_mem(digest, lead.cost_static,
                                  lead.hbm_measured)
                fed = True
        if fed:
            store.sync_manifest()

    def _account(self, batch: list) -> None:
        """Post-launch bookkeeping.  RUs were PRICED at submit and
        DEBITED at batch admission; this mirrors them into the per-group
        stat and the tidb_tpu_sched_ru_total counter."""
        with self._mu:
            for t in batch:
                self.tasks_done += 1
                if t.cost is not None:
                    self.transfer_ici_bytes += t.cost.ici_bytes
                    self.transfer_dci_bytes += t.cost.dci_bytes
                if t.donate:
                    self.donated_tasks += 1
                    if t.cost is not None:
                        self.donated_bytes += t.cost.donated_bytes
                g = self._groups.get(t.group)
                if g is not None:
                    g.wait_ns += t.wait_ns
                    g.rus += t.rus_charged
                    g.device_ns += t.device_ns
                if t.key is not None and t.device_ns:
                    dk = f"{t.key[0] & 0xffffffffffffffff:016x}"
                    self._digest_ns.bump(dk, t.device_ns)
                self._wait_ring.append(t.wait_ns)
                self._m_wait.observe(t.wait_ns / 1e9)
                self._m_wait_ms.observe(t.wait_ns / 1e6)
                self._m_ru.inc(t.rus_charged, group=t.group)

    # ------------------------------------------------------------- #
    # introspection
    # ------------------------------------------------------------- #

    @property
    def depth(self) -> int:
        return self._depth

    def _calibration_stats(self) -> dict:
        from ..analysis.calibrate import correction_store
        return {"enabled": self.calibration_enable,
                **correction_store().stats()}

    def _pd_stats(self) -> dict:
        """coplace: the /sched ``pd`` section — membership + quota
        shares per attached coordinator (the full store dump lives on
        /pd).  Pure local state, no store I/O from the stats path."""
        from ..pd import coordinators
        coords = coordinators()
        if not coords:
            return {"enabled": False}
        out = {"enabled": True, "members": []}
        for c in coords:
            out["members"].append({
                "member_id": c.member.member_id,
                "epoch": c.member.epoch,
                "degraded": c.member.degraded,
                "degraded_total": c.member.degraded_total,
                "sync_total": c.sync_total,
                "quota_shares": dict(sorted(c.quota.shares.items())),
                "peer_warm": c.registry.peer_warm,
                "claim_denials": c.registry.claim_denials,
            })
        return out

    def _hbm_stats(self) -> dict:
        out = {"enabled": self.hbm_enable}
        led = self._ledger_obj
        if led is not None:
            out.update(led.stats())
        return out

    @staticmethod
    def _pct(samples: list, q: float) -> float:
        if not samples:
            return 0.0
        i = min(int(q * len(samples)), len(samples) - 1)
        return samples[i]

    def stats(self) -> dict:
        with self._mu:
            waits = sorted(self._wait_ring)
            return {
                "queue_depth": self._depth,
                "max_depth": self.max_depth,
                "max_coalesce": self.max_coalesce,
                "fusion": self.fusion_enable,
                "window_us": self.window_us,
                "launches": self.launches,
                "coalesced_launches": self.coalesced_launches,
                "coalesced_tasks": self.coalesced_tasks,
                "batched_launches": self.batched_launches,
                "batched_rows_launches": self.batched_rows_launches,
                "fused_launches": self.fused_launches,
                "fused_tasks": self.fused_tasks,
                "window_waits": self.window_waits,
                "window_hits": self.window_hits,
                "busy_rejects": self.busy_rejects,
                "hbm_budget": self.effective_budget(),
                "budget_admitted": self.budget_admitted,
                "budget_rejects": self.budget_rejects,
                "budget_deferrals": self.budget_deferrals,
                "last_launch_bytes": self.last_launch_bytes,
                "transfer_ici_bytes": self.transfer_ici_bytes,
                "transfer_dci_bytes": self.transfer_dci_bytes,
                "donated_launches": self.donated_launches,
                "donated_tasks": self.donated_tasks,
                "donated_bytes": self.donated_bytes,
                "compile_ms_total": round(self.compile_ns_total / 1e6, 3),
                "retried_launches": self.retried_launches,
                "retried_tasks": self.retried_tasks,
                "bisected_launches": self.bisected_launches,
                "quarantined": self.quarantined,
                "value_drifts": self.value_drifts,
                "breaker": self.breaker.snapshot(),
                "faults": _faults.stats(),   # None when unarmed
                "rc_enable": self.rc_enable,
                "rc_overdraft_ru": self.rc_overdraft_ru,
                "rc_throttled": self.rc_throttled,
                "rc_exhausted": self.rc_exhausted,
                "rc_debited_ru": round(self.rc_debited_ru, 2),
                "calibration": self._calibration_stats(),
                "hbm": self._hbm_stats(),
                # coplace (pd/): coordination-plane membership
                "pd": self._pd_stats(),
                "oom_faults": self.oom_faults,
                "oom_demuxed": self.oom_demuxed,
                "shed_rejects": self.shed_rejects,
                "backlog_ms": round(self._backlog_ns / 1e6, 3),
                "digest_device_ms": {
                    dk: round(ns / 1e6, 3) for dk, ns in sorted(
                        self._digest_ns.items(),
                        key=lambda kv: -kv[1])[:8]},
                "tasks_done": self.tasks_done,
                "wait_p50_ms": round(self._pct(waits, 0.50) / 1e6, 3),
                "wait_p99_ms": round(self._pct(waits, 0.99) / 1e6, 3),
                "groups": {
                    g.name: {"weight": g.weight, "tasks": g.tasks,
                             "queued": len(g.queue),
                             "wait_ms": round(g.wait_ns / 1e6, 3),
                             "rus": round(g.rus, 2),
                             "throttled": g.throttled,
                             "device_ms": round(g.device_ns / 1e6, 3)}
                    for g in self._groups.values()},
            }


# --------------------------------------------------------------------- #
# per-device registry: the scheduler is the device tuple's one executor
# --------------------------------------------------------------------- #

_REGISTRY: dict = {}
_REG_MU = threading.Lock()


def scheduler_for(devices) -> DeviceScheduler:
    """The (process-wide) scheduler owning launches onto ``devices``,
    keyed by their fingerprint (type, index, count of logical devices):
    every client over the same card and count shares one queue."""
    from .task import mesh_fingerprint
    fp = mesh_fingerprint(devices)
    with _REG_MU:
        s = _REGISTRY.get(fp)
        if s is None:
            s = _REGISTRY[fp] = DeviceScheduler()
        return s


def shutdown_all(timeout: float = 5.0) -> None:
    """Stop every drain and let the card finish what they queued on it:
    the interpreter's exit hook, so no drain holds CUDA work while the
    interpreter tears down."""
    with _REG_MU:
        scheds = list(_REGISTRY.values())
    for s in scheds:
        s.shutdown(timeout)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


atexit.register(shutdown_all)


__all__ = ["DeviceScheduler", "scheduler_for", "shutdown_all",
           "DEFAULT_QUEUE_DEPTH", "DEFAULT_MAX_COALESCE",
           "WINDOW_CAP_US", "DEFAULT_LAUNCH_RETRY_MS", "IDLE_EXIT_S"]
