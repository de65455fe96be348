# ported from tidb_tpu/analysis/shardflow.py @ 1fb41ee
"""shardflow: sharding-layout & collective-transfer abstract interpreter.

Reference analog: TiFlash's MPP exchange discipline (PAPER.md) — a plan
fragment is only well-formed against the cluster it runs on: every
ExchangeSender's partition column set, schema, and target topology are
checked when the fragment tree is cut, not discovered mid-stream.  Here
the "cluster" is the port's logical device list (plus the declared host
factorization of parallel/topology), the fragments are cop DAGs /
shuffle / window specs, and the exchanges are the merges across the
devices and the exchange programs — so the checks move BEFORE a launch,
the same no-device-touch discipline as copcost (shape/memory) and
lifetime (buffer lifetime).  DrJAX (PAPERS.md) is the reference for
keeping the MapReduce-style collective decomposition visible to static
analysis instead of burying it in the compiled program.

The interpreter walks built cop/exchange DAGs edge-by-edge carrying an
abstract ``Layout`` per buffer (which mesh axes partition its rows,
which it is replicated over, how much shard padding it carries) and
verifies every collective against the topology:

- ``SHARD-AXIS-UNKNOWN``      a collective's mesh axis does not exist on
                              the topology the program will launch onto,
- ``SHARD-IMPLICIT-RESHARD``  an operator consumes a layout other than
                              the one its child produced (e.g. a
                              row-wise operator over post-psum
                              replicated states) — the hidden
                              all-to-all the JAX package's XLA would
                              silently insert,
- ``SHARD-MERGE-COORDINATOR`` a host-merged group table routed through
                              ONE coordinator host on a multi-host
                              topology instead of per host,
- ``SHARD-SPLIT-INDIVISIBLE`` the all_to_all split/concat factorization
                              does not divide the device space evenly,
- ``SHARD-PSUM-FENCE``        an in-program (hi, lo) limb psum whose
                              global row capacity exceeds the 2^31
                              int64-exactness bound — the runtime
                              OverflowError fence, proven pre-trace,
- ``COST-DCI-BLOWUP``         a shuffle exchange whose statically
                              priced cross-host bytes dwarf the data it
                              repartitions (an Expand/blow-up in an
                              exchange chain ships the table across DCI
                              many times over).

All rules raise structured ``PlanContractError``s, so the session plan
path (``_plan_select``) and sched admission (``submit`` ->
``contracts.verify_task``) reject violating plans exactly like every
other contract violation — before any launch.  The same walk rolls
transfer bytes up PER LINK CLASS (intra / ici / dci) through
``copcost.LaunchCost.transfer_breakdown``, which makes HBM admission,
RU pricing (rc/pricing's DCI rate), fusion caps, and calibration
topology-aware with no runtime change.

The shuffle-spec exchange-boundary checks (side schema vs top-chain
leaf scan) moved here from contracts.py as the single source — the
verify_plan pass delegates, so the two passes cannot drift.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

from ..copr import dag as D
from ..parallel.topology import (MERGE_COORDINATOR, MERGE_PER_HOST,
                                 SHARD_AXIS, MeshTopology,
                                 TransferBreakdown, _as_int, topology_for)
from ..types import dtypes as dt
from .contracts import PlanContractError, _compatible, _fail
from . import copcost as C

# ------------------------------------------------------------------ #
# rule ids (doubling as gate finding rules — the COST-* discipline)
# ------------------------------------------------------------------ #

RULE_AXIS_UNKNOWN = "SHARD-AXIS-UNKNOWN"
RULE_IMPLICIT_RESHARD = "SHARD-IMPLICIT-RESHARD"
RULE_MERGE_COORDINATOR = "SHARD-MERGE-COORDINATOR"
RULE_SPLIT_INDIVISIBLE = "SHARD-SPLIT-INDIVISIBLE"
RULE_PSUM_FENCE = "SHARD-PSUM-FENCE"
RULE_DCI_BLOWUP = "COST-DCI-BLOWUP"

# a shuffle whose cross-host exchange bytes exceed this multiple of the
# resident bytes it repartitions ships the table across DCI many times
# over — a repartition storm, not a join (gate finding + pre-trace
# rejection; baseline-able like every COST- rule)
DCI_BLOWUP_MAX = 16.0

# the (hi, lo) limb psum stays int64-exact only below this many global
# contributing rows — the runtime fence (spmd/shuffle OverflowError)
# proven statically when the layout's global capacity is known
PSUM_LIMB_ROWS = 2 ** 31

# validated prediction band: predicted per-link exchange bytes of the
# shuffle-join path vs the program's live send buffers on 8 logical
# devices (the copcost exact-resident-bytes precedent, loosened for
# capacity regrow)
SHARD_TOLERANCE = 4.0

# the fake multi-host factorization the tests and the gate analyze
# under: a reshaped (host=2, device=4) view of 8 logical devices
GATE_VIEW_HOSTS = 2


# ------------------------------------------------------------------ #
# the abstract layout
# ------------------------------------------------------------------ #

@dataclass(frozen=True)
class Layout:
    """Abstract device layout of one buffer while it flows through a
    program: ``axes`` are the mesh axes partitioning its rows (empty =
    every device holds the whole buffer), ``replicated`` the axes it is
    replicated over (post-psum states), ``shard_pad`` the
    pad-to-divide rows placement added."""
    axes: Tuple[str, ...] = (SHARD_AXIS,)
    replicated: Tuple[str, ...] = ()
    shard_pad: int = 0

    @property
    def row_sharded(self) -> bool:
        return SHARD_AXIS in self.axes


ROW_SHARDED = Layout()
REPLICATED = Layout(axes=(), replicated=(SHARD_AXIS,))


def _layout_str(layout: Layout) -> str:
    if layout.row_sharded:
        return f"sharded({','.join(layout.axes)})"
    if layout.replicated:
        return f"replicated({','.join(layout.replicated)})"
    return "unpartitioned"


# ------------------------------------------------------------------ #
# DAG flow (memoized on the frozen dag + topology)
# ------------------------------------------------------------------ #

def _agg_needs_limb_fence(agg: D.Aggregation) -> bool:
    """Mirror of the spmd/shuffle program predicate: an in-program psum
    of (hi, lo) SUM limb states needs the 2^31 global-capacity fence;
    float sums, counts, host-merged programs, and valueflow-proven
    narrow SUMs (whole-table no-wrap proof subsumes the row fence) are
    exempt."""
    if agg.strategy in D.HOST_MERGE_STRATEGIES:
        return False
    K = dt.TypeKind
    return any(a.func == D.AggFunc.SUM and a.arg is not None
               and a.arg.dtype is not None
               and a.arg.dtype.kind not in (K.FLOAT64, K.FLOAT32)
               and i not in agg.narrow_sums
               for i, a in enumerate(agg.aggs))


def _flow(node: D.CopNode, topo: MeshTopology, path: tuple,
          merge_route: str, global_rows: int) -> Layout:
    """Flow one node: verify its consumed layout against what its child
    produced, return the layout it emits."""
    p = path + (type(node).__name__,)

    if isinstance(node, D.TableScan):
        # the scan aliases the stacked resident upload: row-sharded
        return ROW_SHARDED

    if isinstance(node, D.FusedDag):
        out = ROW_SHARDED
        for m in node.members:
            out = _flow(m, topo, p, merge_route, global_rows)
        return out

    kids = node.children()
    child_layout = (_flow(kids[0], topo, p, merge_route, global_rows)
                    if kids else ROW_SHARDED)

    # every cop operator below computes row-wise over the sharded flat
    # batch; consuming anything else is a hidden reshard (in the JAX
    # package XLA would silently lower it to an all-to-all/all-gather
    # behind the plan's back)
    if not child_layout.row_sharded:
        _fail(RULE_IMPLICIT_RESHARD, p,
              f"operator consumes a row-sharded({SHARD_AXIS}) batch but "
              f"its child produces {_layout_str(child_layout)} — an "
              "undeclared reshard XLA would insert as a hidden "
              "collective; route the exchange explicitly")

    if isinstance(node, D.Aggregation):
        if node.strategy in D.HOST_MERGE_STRATEGIES:
            # per-device group tables leave the device for the host
            # merge: on a multi-host topology the merge must route per
            # host — one coordinator host pulling every remote device's
            # states over DCI recreates the single-coordinator
            # bottleneck the MPP exchange layer exists to avoid
            if topo.multi_host and merge_route == MERGE_COORDINATOR:
                _fail(RULE_MERGE_COORDINATOR, p,
                      f"host-merged {node.strategy.value} group table "
                      f"routed through one coordinator host on a "
                      f"{topo.n_hosts}-host topology: "
                      f"{topo.n_devices - topo.devices_per_host} of "
                      f"{topo.n_devices} device states would cross DCI "
                      "— route the merge per host")
            return Layout(axes=(SHARD_AXIS,))   # (D, ...) state tables
        # in-program merge: a psum collective over the shard axis
        if not topo.has_axis(SHARD_AXIS):
            _fail(RULE_AXIS_UNKNOWN, p,
                  f"aggregate merge collective runs over mesh axis "
                  f"{SHARD_AXIS!r} but the target topology only has "
                  f"axes {topo.axis_names} — the program would fail "
                  "at trace (or bind the wrong axis) on this mesh")
        if _agg_needs_limb_fence(node) and global_rows >= PSUM_LIMB_ROWS:
            _fail(RULE_PSUM_FENCE, p,
                  f"in-program (hi, lo) limb psum over {global_rows} "
                  f"global rows exceeds the {PSUM_LIMB_ROWS} "
                  "int64-exactness bound — the runtime fence would "
                  "refuse this launch; repartition or host-merge")
        return REPLICATED

    return child_layout


@functools.lru_cache(maxsize=1024)
def _flow_cached(dag: D.CopNode, topo: MeshTopology, merge_route: str,
                 global_rows: int, path: tuple) -> Layout:
    return _flow(dag, topo, path, merge_route, global_rows)


def verify_dag_sharding(dag: D.CopNode, topo: MeshTopology, *,
                        merge_route: str = MERGE_PER_HOST,
                        global_rows: int = 0, path: tuple = ()) -> Layout:
    """Flow one cop DAG against a topology; raises PlanContractError
    with a SHARD-* rule on the first violation, returns the DAG's
    output Layout.  Memoized on the frozen (dag, topo) pair — repeated
    admission of one program costs a dict hit."""
    _verify_topology(topo, path)
    return _flow_cached(dag, topo, merge_route, _as_int(global_rows), path)


def _verify_topology(topo: MeshTopology, path: tuple) -> None:
    if topo.n_devices % topo.n_hosts != 0:
        # MeshTopology's ctor refuses this; the check stays for
        # hand-built views that bypassed it
        _fail(RULE_SPLIT_INDIVISIBLE, path,
              f"{topo.n_devices} devices do not divide over "
              f"{topo.n_hosts} hosts: all_to_all split/concat would "
              "mis-route whole buckets")
    if not topo.has_axis(SHARD_AXIS):
        _fail(RULE_AXIS_UNKNOWN, path,
              f"programs exchange over mesh axis {SHARD_AXIS!r} but "
              f"the target topology only has axes {topo.axis_names}")


# ------------------------------------------------------------------ #
# exchange-boundary agreement (single source; contracts delegates)
# ------------------------------------------------------------------ #

def verify_shuffle_boundary(spec: D.ShuffleJoinSpec, path: tuple) -> None:
    """Exchange-boundary agreement of a shuffle-join spec: both sides'
    declared schemas must match their chains' outputs, and the
    post-exchange ``top`` chain's leaf scan must read the joined schema
    — the mesh handshake of an MPP shuffle.  Moved here from
    contracts._verify_shuffle_spec as the single source; the
    plan-contract pass delegates, so the two passes report the same
    ``exchange-mismatch`` rule and can never drift."""
    p = path + ("ShuffleJoinSpec",)
    ls, rs = D.output_dtypes(spec.left), D.output_dtypes(spec.right)
    if tuple(spec.left_dtypes) != tuple(ls):
        _fail("exchange-mismatch", p,
              f"declared left exchange schema ({len(spec.left_dtypes)} "
              f"cols) != left chain output ({len(ls)} cols)")
    if tuple(spec.right_dtypes) != tuple(rs):
        _fail("exchange-mismatch", p,
              f"declared right exchange schema ({len(spec.right_dtypes)} "
              f"cols) != right chain output ({len(rs)} cols)")
    joined = ls + rs if spec.kind in ("inner", "left") else ls
    top_leaf = spec.top
    while top_leaf.children():
        top_leaf = top_leaf.children()[0]
    if isinstance(top_leaf, D.TableScan):
        for off, t in zip(top_leaf.col_offsets, top_leaf.col_dtypes):
            if off >= len(joined):
                _fail("exchange-mismatch", p,
                      f"post-join chain reads column {off} of a "
                      f"{len(joined)}-column joined schema")
            if not _compatible(t, joined[off]):
                _fail("exchange-mismatch", p,
                      f"post-join chain reads column {off} as {t} but "
                      f"the exchange produces {joined[off]}")


# ------------------------------------------------------------------ #
# exchange transfer attribution (shared size algebra with copcost)
# ------------------------------------------------------------------ #

def _scan_of(node: D.CopNode) -> Optional[D.TableScan]:
    for n in D.iter_nodes(node):
        if isinstance(n, D.TableScan):
            return n
    return None


def shuffle_transfer(spec: D.ShuffleJoinSpec, llayout, rlayout,
                     lwidths, rwidths,
                     topo: MeshTopology) -> TransferBreakdown:
    """Per-link bytes of the two all_to_all exchange edges of one
    shuffle join, from contracts alone: each side ships its CHAIN
    OUTPUT rows (an Expand in the chain multiplies what the scan read),
    bucketed by the client's capacity formula so the prediction matches
    the runtime send buffers (SHARD_TOLERANCE-validated)."""
    lb, rb = C.shuffle_exchange_buckets(spec, llayout, rlayout,
                                        lwidths, rwidths, topo.n_devices)
    return topo.split_all_to_all(lb).combined(topo.split_all_to_all(rb))


def _resident_bytes(spec: D.ShuffleJoinSpec, llayout, rlayout) -> int:
    """Resident scan bytes of both shuffle sides — the denominator of
    the DCI-blowup ratio (how many times over does the exchange ship
    the data it repartitions?)."""
    total = 0
    for chain, layout in ((spec.left, llayout), (spec.right, rlayout)):
        scan = _scan_of(chain)
        w = C._schema_width(scan.col_dtypes) if scan is not None else 8
        total += layout.padded_rows * w
    return total


def verify_spec_sharding(spec: D.ShuffleJoinSpec, topo: MeshTopology, *,
                         llayout=None, rlayout=None,
                         lwidths=None, rwidths=None,
                         merge_route: str = MERGE_PER_HOST,
                         path: tuple = ()) -> TransferBreakdown:
    """Flow a shuffle-join spec: boundary agreement, both chains, the
    exchange edges (axis + divisibility), the post-exchange top chain
    (incl. its merge routing), and — when the side layouts are known —
    the DCI-blowup ratio.  Returns the exchange's per-link bytes."""
    p = path + ("ShuffleJoinSpec",)
    _verify_topology(topo, p)
    verify_shuffle_boundary(spec, path)
    for side in (spec.left, spec.right):
        _flow_cached(side, topo, merge_route, 0, p)
    # the exchange re-shards rows by hash(key): the top chain consumes
    # a row-sharded partition whatever the sides produced
    _flow_cached(spec.top, topo, merge_route, 0, p)
    if llayout is None or rlayout is None:
        return TransferBreakdown()
    bd = shuffle_transfer(spec, llayout, rlayout, lwidths, rwidths, topo)
    resident = _resident_bytes(spec, llayout, rlayout)
    if topo.multi_host and bd.dci > DCI_BLOWUP_MAX * max(resident, 1):
        _fail(RULE_DCI_BLOWUP, p,
              f"shuffle exchange ships {bd.dci} cross-host bytes for "
              f"{resident} resident bytes "
              f"({bd.dci / max(resident, 1):.0f}x > "
              f"{DCI_BLOWUP_MAX:.0f}x): the repartition crosses DCI "
              "many times over the data it moves — broadcast the small "
              "side or pre-aggregate before the exchange")
    return bd


def verify_window_sharding(spec: D.WindowShuffleSpec, topo: MeshTopology,
                           *, merge_route: str = MERGE_PER_HOST,
                           path: tuple = ()) -> None:
    """Flow a window-repartition spec: the child chain feeds an
    all_to_all keyed on PARTITION BY; the post-exchange sort/segment
    work is device-local row-sharded output."""
    p = path + ("WindowShuffleSpec",)
    _verify_topology(topo, p)
    _flow_cached(spec.child, topo, merge_route, 0, p)


# ------------------------------------------------------------------ #
# admission-time verification (sched submit, via contracts.verify_task)
# ------------------------------------------------------------------ #

def verify_task_sharding(task) -> None:
    """Admission-time shardflow check of a structured CopTask: the
    task's device list must carry the exchange axis, and its DAG must
    flow clean against its topology (declared host view included) —
    before the drain could resolve (launch) a program.  Cheap: one
    memoized flow walk."""
    if task.dag is None or task.mesh is None:
        return
    topo = topology_for(task.mesh)
    global_rows = 0
    for v, _m in task.cols or ():
        if getattr(v, "ndim", 0) >= 2:
            # tensor METADATA only — shapes are host ints, no sync
            global_rows = v.shape[0] * v.shape[1]
            break
    verify_dag_sharding(task.dag, topo, global_rows=global_rows,
                        path=("sched",))


# ------------------------------------------------------------------ #
# plan-level verification + transfer rollup (session / gate / EXPLAIN)
# ------------------------------------------------------------------ #

def verify_plan_sharding(phys, topo: Optional[MeshTopology] = None,
                         n_devices: int = 8,
                         merge_route: str = MERGE_PER_HOST) -> int:
    """Flow every device-program operator of a built physical plan
    against ``topo`` (default: the declared host view over
    ``n_devices``).  Returns the number of device operators flowed;
    raises PlanContractError on the first violation.  Host-only plans
    flow zero operators and always pass."""
    if topo is None:
        topo = topology_for(n_devices=n_devices)
    flowed = 0
    stack = [phys]
    while stack:
        op = stack.pop()
        name = type(op).__name__
        p = (name,)
        if name in ("CopTaskExec", "CopJoinTaskExec"):
            # layout sizing is best-effort (a snapshot may not be
            # materializable at plan time); the structural flow checks
            # never depend on it
            try:
                snap = C._op_snapshot(op)
                rows = C.snapshot_layout(snap, topo.n_devices).padded_rows
            except (AttributeError, TypeError, KeyError):
                rows = 0
            verify_dag_sharding(op.dag, topo, merge_route=merge_route,
                                global_rows=rows, path=p)
            flowed += 1
        elif name == "CopShuffleJoinExec":
            try:
                lsnap = op.left_table.snapshot()
                rsnap = op.right_table.snapshot()
                layouts = dict(
                    llayout=C.snapshot_layout(lsnap, topo.n_devices),
                    rlayout=C.snapshot_layout(rsnap, topo.n_devices),
                    lwidths=C.snapshot_scan_widths(lsnap),
                    rwidths=C.snapshot_scan_widths(rsnap))
            except (AttributeError, TypeError, KeyError):
                layouts = {}
            verify_spec_sharding(op.spec, topo, merge_route=merge_route,
                                 path=p, **layouts)
            flowed += 1
        elif name == "CopWindowExec":
            verify_window_sharding(op.spec, topo,
                                   merge_route=merge_route, path=p)
            flowed += 1
        for c in getattr(op, "children", []) or []:
            if c is not None:
                stack.append(c)
        fb = getattr(op, "fallback", None)
        if fb is not None:
            stack.append(fb)
    return flowed


def plan_transfer(phys, topo: Optional[MeshTopology] = None,
                  n_devices: int = 8) -> TransferBreakdown:
    """Per-link transfer bytes of a whole built plan under ``topo`` —
    the rollup the EXPLAIN footer, --transfer-report, and the bench
    attribution read."""
    if topo is None:
        topo = topology_for(n_devices=n_devices)
    cost = C.plan_cost(phys, topo.n_devices, topology=topo)
    return TransferBreakdown.from_tuple(cost.transfer_breakdown)


# ------------------------------------------------------------------ #
# gate pass + report
# ------------------------------------------------------------------ #

def _gate_topologies(n_devices: int):
    """The single-host view plus the fake multi-host view the gate and
    the tests analyze under (host=2 over 8 logical devices)."""
    views = [MeshTopology((SHARD_AXIS,), n_devices, 1)]
    if n_devices % GATE_VIEW_HOSTS == 0:
        views.append(MeshTopology((SHARD_AXIS,), n_devices,
                                  GATE_VIEW_HOSTS))
    return views


def shard_findings(plans, n_devices: int = 8) -> list:
    """SHARD-*/COST-DCI-BLOWUP findings over (sql, built-plan) pairs —
    the shardflow half of the analysis gate, under both the native
    single-host view and the host=2 view.  Finding keys are stable
    (corpus position + rule) so they baseline exactly like lint/cost
    findings."""
    from .lint import Finding
    out = []
    for idx, (sql, phys) in enumerate(plans):
        qid = f"corpus/q{idx:02d}"
        one_line = " ".join(sql.split())[:60]
        for topo in _gate_topologies(n_devices):
            try:
                verify_plan_sharding(phys, topo)
            except PlanContractError as e:
                sym = e.path[-1] if e.path else "plan"
                out.append(Finding(
                    e.rule, qid, 0, sym,
                    f"[hosts={topo.n_hosts}] {e.detail} ({one_line})"))
                break
    return out


def transfer_report(plans, n_devices: int = 8) -> str:
    """Per-corpus-query per-link transfer table (``--transfer-report``)
    under the host=2 view — the static half of the ROADMAP multi-host
    success metric (per-link transfer attribution)."""
    topo = MeshTopology((SHARD_AXIS,), n_devices,
                        GATE_VIEW_HOSTS
                        if n_devices % GATE_VIEW_HOSTS == 0 else 1)
    fmt = C.format_bytes
    lines = [f"per-link transfer under a (host={topo.n_hosts}, "
             f"device={topo.devices_per_host}) view of {n_devices} "
             "devices",
             f"{'query':<44} {'intra':>10} {'ici':>10} {'dci':>10}"]
    for idx, (sql, phys) in enumerate(plans):
        bd = plan_transfer(phys, topo)
        one_line = " ".join(sql.split())
        label = f"q{idx:02d} {one_line[:39]}"
        lines.append(f"{label:<44} {fmt(bd.intra):>10} "
                     f"{fmt(bd.ici):>10} {fmt(bd.dci):>10}")
    return "\n".join(lines)


__all__ = ["Layout", "ROW_SHARDED", "REPLICATED",
           "verify_dag_sharding", "verify_spec_sharding",
           "verify_window_sharding", "verify_task_sharding",
           "verify_plan_sharding", "verify_shuffle_boundary",
           "shuffle_transfer", "plan_transfer", "shard_findings",
           "transfer_report",
           "RULE_AXIS_UNKNOWN", "RULE_IMPLICIT_RESHARD",
           "RULE_MERGE_COORDINATOR", "RULE_SPLIT_INDIVISIBLE",
           "RULE_PSUM_FENCE", "RULE_DCI_BLOWUP",
           "DCI_BLOWUP_MAX", "PSUM_LIMB_ROWS", "SHARD_TOLERANCE",
           "GATE_VIEW_HOSTS"]
