# ported from tidb_tpu/sched/task.py @ 02e96d8
"""CopTask: one admission unit of device work.

Reference analog: the request level of tikv's unified read pool +
tidb's copr task queue — every coprocessor launch becomes a queued,
taggable unit instead of an ad-hoc device call.  A task is either

- *structured*: carries (dag, devices, row_capacity, device inputs) so
  the scheduler itself resolves the program (parallel/spmd's cache) and
  may COALESCE it with compatible tasks from other sessions — the
  continuous-batching admission unit, or
- *opaque*: a zero-arg launch closure (the hash, shuffle and window
  programs, whose signatures differ); still admission-controlled and
  fair-ordered, never coalesced.

The task key tags (program digest, device fingerprint, row capacity,
capacity shape) — the key ``spmd.get_sharded_program`` caches programs
on — so the scheduler can recognize "same program in flight" across
sessions.

Streams: the port's kernels launch on the current CUDA stream of the
calling thread (``copr/cuda/build.stream_of``), and the drain launches
on another thread.  A task on the card therefore captures its
submitting thread's current stream and records ``ready``, an event on
it, at submission; the drain launches under the lead's stream after
waiting on every member's ``ready``, records ``launched`` after the
launch, and a waiter whose stream differs waits on ``launched`` and
marks the output tensors with ``record_stream`` before it reads them.

Tracing: a task captures its submitting statement's trace context
(``obs/trace.TRACE_CTX``) at construction, as it captures the resource
group, so the drain thread records the queue, launch, compile, fusion
and retry spans under the statement's ``cop.dispatch`` span; an untraced
statement's task carries None and the drain records nothing for it.  A
launch on the card also carries ``timing``: the drain's CUDA events
around it, from which the launch's device time is read once both have
completed (sched/scheduler ``LaunchTiming``).
"""

from __future__ import annotations

import contextvars
import threading
import time
from typing import Any, Callable, Optional

import torch

from ..obs.trace import TRACE_CTX as _TRACE_CTX

# the submitting statement's (resource group name, fair-share weight,
# rc ResourceGroup-or-None) — bound by Session.execute around each
# statement; the live group object lets the drain consult the group's
# RU bucket (rc/controller) without a registry lookup
SCHED_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "sched_group", default=None)

DEFAULT_GROUP = "default"
DEFAULT_WEIGHT = 8.0


class ServerBusyError(RuntimeError):
    """Admission queue overflow: the MySQL-compatible "server is busy"
    backpressure error (TiDB error space 9003, ErrTiKVServerBusy) — the
    client should back off and retry instead of piling work onto an
    already-saturated device."""

    errno = 9003

    def __init__(self, depth: int):
        super().__init__(
            f"TiKV server is busy (device admission queue full, "
            f"depth={depth}); retry later")


class TaskCancelledError(RuntimeError):
    """The waiter was killed (KILL QUERY / connection teardown) while
    its task queued: the drain fails the task with THIS typed error so
    the supervised retry layer — and clients — can tell cancellation
    from device failure.  Cancellation is never retried and never
    charges the program's circuit breaker."""

    def __init__(self):
        super().__init__("cop task cancelled before launch")


def current_group() -> tuple:
    """(group name, weight, rc group-or-None) of the calling statement
    context; 2-tuple bindings gain a None."""
    g = SCHED_GROUP.get()
    if not g:
        return DEFAULT_GROUP, DEFAULT_WEIGHT, None
    if len(g) == 2:
        return g[0], g[1], None
    return g


def _shape_sig(cols, counts) -> tuple:
    """Capacity-shape signature of the stacked device inputs: coalescing
    requires identical program input shapes (the capacity half of the
    task key)."""
    sig = []
    for v, m in cols:
        sig.append((tuple(v.shape), str(v.dtype), m is None))
    return tuple(sig) + ((tuple(counts.shape),) if counts is not None
                         else ())


def mesh_fingerprint(devices) -> tuple:
    """Stable identity of the port's device tuple: the device type, its
    index and the count of logical devices.  Two tuples over the same
    card and count fingerprint identically, so task keys and the
    scheduler registry survive a client re-creating its tuple."""
    d0 = devices[0]
    return (d0.type, -1 if d0.index is None else int(d0.index),
            len(devices))


def _cuda_stream(devices):
    """The calling thread's current stream on the card, or None."""
    if devices and devices[0].type == "cuda":
        return torch.cuda.current_stream(devices[0])
    return None


def adopt(value, stream) -> None:
    """Mark every tensor of ``value`` (a launch's output tree) as used on
    ``stream``, so the caching allocator does not hand its memory to the
    drain's stream while ``stream`` still reads it."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            value.record_stream(stream)
    elif isinstance(value, dict):
        for v in value.values():
            adopt(v, stream)
    elif isinstance(value, (list, tuple)):
        for v in value:
            adopt(v, stream)


class CopTask:
    """One queued device launch; resolved to (program, out) on wait()."""

    __slots__ = ("key", "dag", "mesh", "row_capacity", "cols", "counts",
                 "aux", "input_token", "fn", "group", "weight",
                 "submit_ns", "start_ns", "wait_ns", "coalesced", "fused",
                 "fusion_key", "cancelled", "_done", "_value", "_exc",
                 "est_rows", "cost", "cost_static", "rc_group", "rus",
                 "rus_charged", "device_ns", "deadline_ns", "svc_ns",
                 "retries", "compile_ns", "compile_miss",
                 "hbm_predicted", "hbm_measured", "trace", "stream",
                 "ready", "launched", "timing", "donate", "value_drift")

    def __init__(self, *, key=None, dag=None, devices=None,
                 row_capacity=0, cols=None, counts=None, aux=(),
                 input_token=None, fusion_key=None,
                 fn: Optional[Callable[[], Any]] = None,
                 group: Optional[str] = None,
                 weight: Optional[float] = None, est_rows: int = 0,
                 rc_group=None, donate: bool = False):
        if group is None:
            group, gw, rcg = current_group()
            if weight is None:
                weight = gw
            if rc_group is None:
                rc_group = rcg
        self.key = key
        self.dag = dag
        self.mesh = tuple(devices) if devices is not None else None
        self.row_capacity = row_capacity
        self.cols = cols
        self.counts = counts
        self.aux = aux
        self.input_token = input_token
        self.fusion_key = fusion_key
        self.fn = fn
        self.group = group
        self.weight = float(weight or DEFAULT_WEIGHT)
        self.est_rows = est_rows
        self.donate = bool(donate)  # launch-unique inputs: donate them
        self.submit_ns = time.perf_counter_ns()
        self.start_ns = 0
        self.wait_ns = 0
        self.coalesced = 1        # tasks served by this task's launch
        self.fused = 0            # member programs in this task's launch
        self.cost = None          # LaunchCost set at admission (copcost;
                                  # calibration-corrected when enabled)
        self.cost_static = None   # the uncorrected LaunchCost — the
                                  # calibration feedback baseline
        self.rc_group = rc_group  # live rc ResourceGroup (bucket owner)
        self.rus = 1.0            # priced RUs, set at submit (rc/pricing)
        self.rus_charged = 0.0    # RUs actually debited at the drain
        self.device_ns = 0        # attributed share of launch wall time
        self.deadline_ns = 0      # rc max-queue deadline (0 = none)
        self.svc_ns = 0           # measured expected service time the
                                  # shedding backlog accounts
        self.retries = 0          # transient-failure re-launches (drain)
        self.compile_ns = 0       # program build time this task's launch
                                  # paid (compilecache; 0 = pooled)
        self.compile_miss = False  # launch built its program
        self.hbm_predicted = 0    # admission HBM prediction (the
                                  # calibrated peak the budget enforced)
        self.hbm_measured = 0     # measured launch peak bytes, set by
                                  # the drain BEFORE finish (0 = none)
        self.value_drift = 0      # columns whose observed ANALYZE
                                  # watermark escaped the plan's declared
                                  # value interval (valueflow, admission)
        # copscope trace propagation (obs/): the submitting statement's
        # TraceCtx rides the task like SCHED_GROUP does, so the drain
        # thread records queue/compile/launch/retry spans under the
        # statement's dispatch span — None = untraced, zero overhead
        self.trace = _TRACE_CTX.get()
        self.stream = _cuda_stream(self.mesh)
        self.ready = None
        if self.stream is not None:
            self.ready = torch.cuda.Event()
            self.ready.record(self.stream)
        self.launched = None      # event after the launch (drain)
        self.timing = None        # the launch's CUDA-event device time
                                  # (drain; None off the card)
        self.cancelled = False
        self._done = threading.Event()
        self._value = None
        self._exc = None

    # -------- factory helpers -------- #

    @classmethod
    def structured(cls, dag, devices, row_capacity, cols, counts, aux,
                   est_rows: int = 0, donate: bool = False) -> "CopTask":
        from ..copr.dag import dag_digest
        fp = mesh_fingerprint(devices)
        sig = _shape_sig(cols, counts)
        # a donating launch releases its inputs (analysis/lifetime), so
        # the donating variant keys (and fuses) apart — a donating and a
        # non-donating task must never dedup together
        key = (dag_digest(dag), fp, int(row_capacity), sig, bool(donate))
        # input identity for in-flight dedup: the snapshot's resident
        # device cache returns the SAME tensor objects per epoch, so two
        # sessions over one snapshot share ids; the task pins the refs.
        # Identity is the POINT here (same buffers = one launch serves
        # both), so id() is correct, unlike in the persistent key above.
        token = (id(cols), id(counts), id(aux))
        # cross-query fusion key (contract-aware): tasks sharing one
        # snapshot scan (same resident tensors), one device tuple and one
        # capacity signature, whose chains are in a fusable contract
        # class, may compute their payloads in ONE program call even
        # when their digests differ
        fusion_key = None
        if aux == ():
            from ..analysis.contracts import fusion_signature
            fsig = fusion_signature(dag)
            if fsig is not None:
                fusion_key = (token, fp, sig, fsig, bool(donate))
        return cls(key=key, dag=dag, devices=devices,
                   row_capacity=row_capacity, cols=cols, counts=counts,
                   aux=aux, input_token=token, fusion_key=fusion_key,
                   est_rows=est_rows, donate=donate)

    @classmethod
    def opaque(cls, fn: Callable[[], Any], devices=None,
               est_rows: int = 0) -> "CopTask":
        return cls(fn=fn, devices=devices, est_rows=est_rows)

    # -------- completion -------- #

    @property
    def done(self) -> bool:
        """Resolved (served or failed) — the supervised drain filters
        already-finished members out of a retried batch."""
        return self._done.is_set()

    @property
    def failed(self) -> bool:
        """Resolved WITH an error — failed launches must not feed the
        calibration loop (their wall time measures the failure path)."""
        return self._done.is_set() and self._exc is not None

    def finish(self, value) -> None:
        if self._done.is_set():
            return
        self._value = value
        self._done.set()

    def fail(self, exc: BaseException) -> None:
        if self._done.is_set():      # a served task keeps its result
            return
        self._exc = exc
        self._done.set()

    def wait(self):
        """Block until the scheduler serves this task.  Cooperative with
        KILL QUERY: polls the caller's kill event between waits; a killed
        waiter marks itself cancelled so the drain loop skips it.  On the
        card, a waiter on another stream than the launch's orders its
        stream after the launch (``launched``) and adopts the outputs."""
        from ..copr.coordinator import QueryInterrupted, check_killed
        while not self._done.wait(0.05):
            try:
                check_killed()
            except QueryInterrupted:
                self.cancelled = True
                raise
        if self._exc is not None:
            raise self._exc
        if self.launched is not None and self.stream is not None:
            mine = torch.cuda.current_stream(self.mesh[0])
            ev, launch_stream = self.launched
            if mine != launch_stream:
                mine.wait_event(ev)
                adopt(self._value, mine)
        return self._value


__all__ = ["CopTask", "ServerBusyError", "TaskCancelledError",
           "SCHED_GROUP", "current_group", "DEFAULT_GROUP",
           "DEFAULT_WEIGHT", "mesh_fingerprint", "adopt"]
