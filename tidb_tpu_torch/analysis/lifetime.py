# ported from tidb_tpu/analysis/lifetime.py @ 1fb41ee
"""Buffer lifetime: static donation-safety analysis of program inputs.

Reference analog: the compiler-first memory discipline of Flare (decide
buffer behavior statically, keep the runtime path dumb) applied to
buffer donation.  The JAX package donates launch inputs to XLA
(``donate_argnums``), which aliases them into outputs and marks them
deleted.  The port's counterpart: a donating launch hands a
launch-unique input's device memory back to the caching allocator at
the launch (``parallel/spmd.release_donated``, after ``record_stream``
on the kernels' stream), not at the end of its streamed batch.
Donating the WRONG input is as catastrophic here as there: a released
snapshot-cache column poisons every later query over that snapshot,
and a released regrow-loop input breaks the client's re-launch.

This module classifies every device-program input slot from the
contract DAG alone (no launch, no device touch):

- ``PERSISTENT``  — snapshot-cache residents (``ColumnarSnapshot.
  device_cols`` returns the same tensors across queries and pages; the
  sched input token pins that identity).  Never donatable; a live
  resident registry backs the static class with a runtime guard.
- ``LOOP_CARRIED`` — inputs the client feeds back into the next launch
  of the same program (store/client.py regrow disciplines: the rows
  paging loop, SORT/SEGMENT group-capacity regrow, expanding-join
  capacity regrow).  Donating one would free the tensor the next
  iteration re-reads.
- ``EPHEMERAL``   — dead after the launch: streamed device batches
  (``device_put_uncached``, dropped after dispatch), the fresh stacked
  copies ``spmd._stack_slots`` builds per batched launch, one-shot aux
  build sides of extras-free in-program aggregations.

The result is a per-program-shape :class:`DonationPlan` — the ONLY
legitimate source of ``donate_argnums`` for the spmd program kinds —
consumed by:

- ``parallel/spmd.py``: all five program kinds derive their
  ``donate_argnums`` from the plan; explicit overrides are re-verified
  before any launch (``verify_donation`` raises ``DonationError`` on a
  PERSISTENT/LOOP-CARRIED slot),
- sched admission: a donating task over a live snapshot resident or a
  non-EPHEMERAL program class is rejected before any launch
  (``verify_task_donation`` via ``analysis.contracts.verify_task``),
- ``analysis/copcost``: ``LaunchCost.donated_bytes`` tightens
  ``peak_hbm_bytes`` from in+out+temp toward max(in, out)+temp for
  donation-eligible launches,
- the compile key (``analysis/compilekey.variant_key``'s
  ``donation_sig``), EXPLAIN's ``donate:`` footer and the gate's
  DONATE-UNSAFE / DONATE-MISSED findings.
"""

from __future__ import annotations

import enum
import functools
import weakref
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from ..copr import dag as D
from .contracts import PlanContractError

# DONATE-MISSED floor: an EPHEMERAL scan slot smaller than this is not
# worth a finding (donation saves at most min(in, out) bytes; tiny
# inputs churn nothing)
DONATE_MISSED_MIN_BYTES = 1 << 20          # 1 MiB

# the call signature of every spmd program kind: (cols, counts, aux)
ARG_COLS, ARG_COUNTS, ARG_AUX = 0, 1, 2

# program shapes of parallel/spmd (one DonationPlan each)
PROGRAMS = ("solo", "batched", "batched-rows", "fused", "fused-rows")


class DonationError(PlanContractError):
    """A donation plan (or an explicit ``donate_argnums`` override)
    would donate a PERSISTENT or LOOP-CARRIED input slot.  Raised
    BEFORE any launch — a released snapshot resident or regrow input
    surfaces later as an opaque storage error five layers deep; this
    failure carries the slot and the lifetime class instead."""


class BufferClass(enum.Enum):
    PERSISTENT = "persistent"
    LOOP_CARRIED = "loop-carried"
    EPHEMERAL = "ephemeral"


@dataclass(frozen=True)
class SlotLife:
    """Lifetime of one argument slot of a device program."""
    name: str                  # cols | counts | aux
    argnum: int                # position in the program's call signature
    cls: BufferClass
    reason: str


@dataclass(frozen=True)
class DonationPlan:
    """Donation-safety verdict for ONE program shape over one DAG.

    ``donate_argnums`` is the set of call positions that are safe to
    donate WHEN the caller's tensors are launch-unique (not snapshot
    residents) — the spmd programs apply it only to a donating launch,
    and sched admission re-checks residency at runtime.  An empty tuple means the program class forbids donation
    outright (loop-carried regrow state)."""
    program: str
    slots: Tuple[SlotLife, ...]
    donate_argnums: Tuple[int, ...]

    @property
    def donatable(self) -> bool:
        return bool(self.donate_argnums)

    def slot(self, argnum: int) -> Optional[SlotLife]:
        for s in self.slots:
            if s.argnum == argnum:
                return s
        return None

    def describe(self) -> str:
        return ", ".join(f"{s.name}={s.cls.value}" for s in self.slots)


# ------------------------------------------------------------------ #
# DAG classification
# ------------------------------------------------------------------ #

def _lookup_joins(node: D.CopNode) -> list:
    return [n for n in D.iter_nodes(node)
            if isinstance(n, D.LookupJoin)]


def scan_lifetime(dag: D.CopNode) -> Tuple[BufferClass, str]:
    """Lifetime class of a program's scan inputs (cols + counts),
    derived from the regrow disciplines in store/client.py: any DAG the
    client may re-launch over the SAME input arrays is loop-carried."""
    if isinstance(dag, D.FusedDag):
        worst = (BufferClass.EPHEMERAL, "every member one-shot")
        for m in dag.members:
            cls, why = scan_lifetime(m)
            if cls is not BufferClass.EPHEMERAL:
                worst = (cls, f"member {type(m).__name__}: {why}")
        return worst
    if D.find_expand_join(dag) is not None:
        return (BufferClass.LOOP_CARRIED,
                "expanding-join capacity regrow re-feeds the inputs "
                "(store/client._grown_join_dag loop)")
    if not isinstance(dag, D.Aggregation):
        return (BufferClass.LOOP_CARRIED,
                "rows paging loop re-feeds the inputs on overflow "
                "(store/client._execute_rows_once)")
    if dag.strategy in D.HOST_MERGE_STRATEGIES:
        return (BufferClass.LOOP_CARRIED,
                "group-capacity regrow re-feeds the inputs "
                "(store/client._execute_sort_agg)")
    return (BufferClass.EPHEMERAL,
            "in-program aggregation launches once; inputs dead after")


def aux_lifetime(dag: D.CopNode) -> Tuple[BufferClass, str]:
    """Lifetime of the aux (host-materialized build sides) slot.  Aux
    arrays are built fresh per statement (executor/physical), so they
    share the scan's class — EXCEPT in a fused program where two
    members reading one aux slot must keep it alive for the unfused
    fallback (the scheduler serves refused groups as SEQUENTIAL solo
    launches over the same aux objects)."""
    if isinstance(dag, D.FusedDag):
        seen: set = set()
        for m in dag.members:
            for j in _lookup_joins(m):
                if j.aux_slot in seen:
                    return (BufferClass.PERSISTENT,
                            f"aux slot {j.aux_slot} shared by >= 2 fused "
                            "members: the unfused fallback re-reads it")
                seen.add(j.aux_slot)
    return scan_lifetime(dag)


@functools.lru_cache(maxsize=1024)
def donation_plan(dag: D.CopNode, program: str = "solo") -> DonationPlan:
    """The per-program-shape DonationPlan of a pushed cop DAG.  Frozen
    DAG nodes key the memo exactly like the program cache.

    - ``solo`` / ``fused``:   class follows the DAG's regrow discipline.
    - ``batched`` / ``batched-rows``: the stacked (S, K, C) slot copies
      are built FRESH per launch by ``spmd._stack_slots`` (torch.stack
      of the member inputs), so cols/counts are ephemeral by construction
      regardless of where the member arrays live — the stack is the
      copy that dies.
    - ``fused-rows``: members keep per-member paging loops; loop-carried.
    """
    if program not in PROGRAMS:
        raise ValueError(f"unknown program shape {program!r}")
    if program in ("batched", "batched-rows"):
        cls, why = (BufferClass.EPHEMERAL,
                    "slot-stacked copies built per launch "
                    "(spmd._stack_slots); the stack dies with the launch")
        aux_cls, aux_why = (BufferClass.EPHEMERAL,
                            "batched launches carry no aux")
    elif program == "fused-rows":
        cls, why = (BufferClass.LOOP_CARRIED,
                    "fused rows members keep per-member paging loops")
        aux_cls, aux_why = cls, why
    else:
        cls, why = scan_lifetime(dag)
        aux_cls, aux_why = aux_lifetime(dag)
    slots = (SlotLife("cols", ARG_COLS, cls, why),
             SlotLife("counts", ARG_COUNTS, cls, why),
             SlotLife("aux", ARG_AUX, aux_cls, aux_why))
    argnums = tuple(s.argnum for s in slots
                    if s.cls is BufferClass.EPHEMERAL)
    return DonationPlan(program, slots, argnums)


def verify_donation(dag: D.CopNode, donate_argnums: Sequence[int],
                    program: str = "solo") -> None:
    """Pre-launch donation-safety check: every donated position must be
    an EPHEMERAL slot of the program's DonationPlan.  The spmd programs
    run this on any explicit ``donate_argnums`` override, so a seeded
    unsafe plan is rejected BEFORE a launch could release an input."""
    plan = donation_plan(dag, program)
    p = ("donation", program, type(dag).__name__)
    for a in donate_argnums:
        s = plan.slot(int(a))
        if s is None:
            raise DonationError(
                "donate-unsafe", p,
                f"donate_argnums names position {a}, not an input slot "
                f"of the {program} program signature (cols, counts, aux)")
        if s.cls is not BufferClass.EPHEMERAL:
            raise DonationError(
                "donate-unsafe", p,
                f"donating {s.name} (arg {a}) which is "
                f"{s.cls.value}: {s.reason}")


# ------------------------------------------------------------------ #
# live snapshot-resident registry (runtime backstop for PERSISTENT)
# ------------------------------------------------------------------ #

# id(counts tensor) -> weakref; a hit is valid only while the exact
# tensor object is alive (the result-cache weakref discipline), so a
# recycled id() can never false-positive.  The counts tensor is the
# registry token because every device_cols() result carries exactly one.
_RESIDENT: dict = {}
_RESIDENT_CAP = 128


def _sweep_residents() -> None:
    """Drop dead refs.  Runs on EVERY registration, so the ledger and
    ``/hbm`` never count dead entries between donations."""
    dead = [k for k, r in _RESIDENT.items() if r() is None]
    for k in dead:
        del _RESIDENT[k]


def register_resident(counts, nbytes: int = 0,
                      fingerprint=None) -> None:
    """Mark one snapshot's device-resident counts tensor as PERSISTENT
    (called by ``ColumnarSnapshot.device_cols`` on cache fill).  With
    ``nbytes``/``fingerprint`` the registration also credits the live
    HBM ledger (obs/hbm): the weakref registry is the ledger's
    register/unregister event source — the ledger's own weakref death
    callback is the unregister half."""
    if counts is None:
        return
    try:
        ref = weakref.ref(counts)
    except TypeError:
        return
    _sweep_residents()
    _RESIDENT[id(counts)] = ref       # planlint: ok - weakref-guarded slot
    if nbytes > 0 and fingerprint is not None:
        from ..obs.hbm import ledger_for
        ledger_for(fingerprint).add_resident(counts, nbytes)


def residents() -> list:
    """The LIVE registered resident tensors (dead refs swept first) —
    the view the ledger and ``/hbm`` consume; never returns an entry
    whose tensor was collected."""
    _sweep_residents()
    return [r() for r in _RESIDENT.values() if r() is not None]


def is_resident(counts) -> bool:
    """Is this exact tensor object a live snapshot-cache resident?"""
    if counts is None:
        return False
    r = _RESIDENT.get(id(counts))     # planlint: ok - weakref-guarded slot
    return r is not None and r() is counts


def verify_task_donation(task) -> None:
    """Admission-time donation check for a structured CopTask (called
    from ``analysis.contracts.verify_task``): a donating task must be
    in an EPHEMERAL program class AND its input tensors must not be live
    snapshot residents.  Runs in the submitting thread, before any
    launch."""
    if not getattr(task, "donate", False) or task.dag is None:
        return
    plan = donation_plan(task.dag, "solo")
    verify_donation(task.dag, plan.donate_argnums or (ARG_COLS,), "solo")
    if is_resident(task.counts):
        raise DonationError(
            "donate-unsafe", ("sched", type(task.dag).__name__),
            "task requests donation but its input token is a LIVE "
            "snapshot-cache resident (ColumnarSnapshot.device_cols "
            "reuses those arrays across queries and pages)")


# ------------------------------------------------------------------ #
# gate rules + reports over the TPC-H plan corpus
# ------------------------------------------------------------------ #

def _plan_cop_ops(phys) -> list:
    """(op, dag) pairs of every broadcast/solo cop exec in a built
    physical plan (shuffle/window programs are opaque to donation:
    their capacities are owned by the client's regrow loop)."""
    out = []
    stack = [phys]
    while stack:
        op = stack.pop()
        if type(op).__name__ in ("CopTaskExec", "CopJoinTaskExec"):
            out.append((op, op.dag))
        for c in getattr(op, "children", []) or []:
            if c is not None:
                stack.append(c)
        fb = getattr(op, "fallback", None)
        if fb is not None:
            stack.append(fb)
    return out


def _op_donation_cost(op, n_devices: int):
    """LaunchCost of one cop exec under its DonationPlan — the
    ephemeral-feed view: what the streaming/uncached path would save."""
    from .copcost import _cop_exec_cost
    return _cop_exec_cost(op, n_devices,
                          donation=donation_plan(op.dag, "solo"))


def donation_findings(plans, n_devices: int = 8) -> list:
    """DONATE-* findings over (sql, built-plan) pairs — the lifetime
    half of the analysis gate.  Keys are corpus-stable (position +
    rule) so they baseline exactly like lint/cost findings.

    - DONATE-UNSAFE: a derived plan donates a PERSISTENT/LOOP-CARRIED
      slot (only fires if plan derivation itself rots — the spmd programs
      re-verify at construction time too).
    - DONATE-MISSED: an EPHEMERAL scan slot above the size floor left
      undonated by the derived plan (baseline-able: a deliberate
      opt-out gets a reviewed baseline.txt entry)."""
    from .copcost import snapshot_input_bytes, snapshot_layout
    from .lint import Finding
    out = []
    for idx, (sql, phys) in enumerate(plans):
        qid = f"corpus/q{idx:02d}"
        one_line = " ".join(sql.split())[:60]
        for op, dag in _plan_cop_ops(phys):
            plan = donation_plan(dag, "solo")
            try:
                verify_donation(dag, plan.donate_argnums, "solo")
            except DonationError as e:
                out.append(Finding(
                    "DONATE-UNSAFE", qid, 0, type(dag).__name__,
                    f"{e.detail} ({one_line})"))
                continue
            cls, _why = scan_lifetime(dag)
            if cls is not BufferClass.EPHEMERAL \
                    or ARG_COLS in plan.donate_argnums:
                continue
            try:
                from .copcost import _op_snapshot
                snap = _op_snapshot(op)
                layout = snapshot_layout(snap, n_devices)
                in_bytes = snapshot_input_bytes(snap, layout)
            except (AttributeError, TypeError):
                continue
            if in_bytes >= DONATE_MISSED_MIN_BYTES:
                out.append(Finding(
                    "DONATE-MISSED", qid, 0, type(dag).__name__,
                    f"EPHEMERAL scan input ({in_bytes} bytes) left "
                    f"undonated by the derived plan ({one_line})"))
    return out


def plan_donation(phys, n_devices: int = 8) -> Tuple[int, int]:
    """(donatable buffer count, donatable bytes) of every cop launch a
    built plan implies, under the ephemeral-feed view — the EXPLAIN
    ``donate:`` footer and the ``--donation-report`` table both read
    this.  Buffers count array leaves: one per shipped column, one per
    validity mask, one counts vector."""
    from .copcost import snapshot_scan_widths
    bufs = saved = 0
    for op, dag in _plan_cop_ops(phys):
        plan = donation_plan(dag, "solo")
        if not plan.donatable:
            continue
        don = _op_donation_cost(op, n_devices)
        saved += don.donated_bytes
        if don.donated_bytes <= 0:
            continue
        if ARG_COLS in plan.donate_argnums:
            try:
                from .copcost import _op_snapshot
                widths = snapshot_scan_widths(_op_snapshot(op))
                bufs += len(widths) + sum(1 for _w, m in widths if m)
            except (AttributeError, TypeError):
                bufs += 1
        if ARG_COUNTS in plan.donate_argnums:
            bufs += 1
    return bufs, saved


def donation_report(plans, n_devices: int = 8) -> str:
    """Per-corpus-query donation table (``--donation-report``): the
    scan-slot lifetime class, donated slot count, donatable bytes, and
    the donated peak next to the undonated one."""
    from .copcost import format_bytes, plan_cost
    lines = [f"{'query':<44} {'class':>12} {'bufs':>5} "
             f"{'donated':>10} {'peak':>10} {'peak(d)':>10}"]
    planned = 0
    for idx, (sql, phys) in enumerate(plans):
        one_line = " ".join(sql.split())
        label = f"q{idx:02d} {one_line[:39]}"
        ops = _plan_cop_ops(phys)
        classes = {scan_lifetime(dag)[0].value for _op, dag in ops}
        cls = ("host-only" if not ops
               else sorted(classes)[0] if len(classes) == 1 else "mixed")
        bufs, saved = plan_donation(phys, n_devices)
        cost = plan_cost(phys, n_devices)
        planned += 1
        lines.append(
            f"{label:<44} {cls:>12} {bufs:>5} "
            f"{format_bytes(saved):>10} "
            f"{format_bytes(cost.peak_hbm_bytes):>10} "
            f"{format_bytes(cost.peak_hbm_bytes - saved):>10}")
    lines.append(f"donation: {planned}/{len(plans)} corpus plans "
                 "planned finite")
    return "\n".join(lines)


__all__ = ["BufferClass", "DonationError", "DonationPlan", "SlotLife",
           "donation_plan", "scan_lifetime", "aux_lifetime",
           "verify_donation", "verify_task_donation",
           "register_resident", "residents", "is_resident",
           "donation_findings",
           "donation_report", "plan_donation",
           "DONATE_MISSED_MIN_BYTES", "ARG_COLS", "ARG_COUNTS", "ARG_AUX"]
