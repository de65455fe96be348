# ported from tidb_tpu/analysis/copcost.py @ 6298005
"""copcost: static shape/memory abstract interpreter over cop contracts.

Reference analog: the cost-transparent mapped primitives of DrJAX
(arXiv:2403.07128) and the size/shape algebra linear-algebra query
processors run before execution (LAQP, arXiv:2306.08367).  With
XLA-compiled coprocessor programs the classic "this plan is slow"
failure mode becomes "this launch OOMs the device" or "this launch
silently pads 100x" — and on TPU those must be caught BEFORE
trace/compile, because the trace itself allocates and a compile takes
tens of seconds.

This module walks a built cop DAG using only the information the
plan contracts (analysis/contracts) already pinned down — declared dtypes, DENSE
domain_sizes, SORT capacities, join out_capacities, the mesh
fingerprint — and computes, with NO tracing and NO device touch:

- per-node abstract buffers: padded device shape (the (S, C) stacked
  shard layout times the flattened per-device batch), physical dtype
  width, per-shard extent under the mesh,
- a per-launch ``LaunchCost`` rollup: peak HBM bytes (resident inputs +
  replicated aux + a no-fusion upper bound on intermediates + outputs),
  host<->device transfer bytes, a FLOP estimate, and the padded/live
  padding-waste ratio.

Consumers:

- the analysis gate (``python -m tidb_tpu.analysis``): COST-PAD-WASTE /
  COST-CAP-BLOWUP / COST-UNBOUNDED findings over the TPC-H plan corpus,
- sched admission: ``DeviceScheduler.submit`` rejects programs whose
  ``peak_hbm_bytes`` exceed the per-mesh budget with a structured
  ``CostError`` (a PlanContractError, so sessions surface it like any
  planner rejection) — pre-trace; the fusion drain caps groups by
  summed footprint,
- EXPLAIN (``est. device bytes`` footer) and ``--cost-report``,
- tests validate predictions against live device buffers and
  ``jax.stages.Compiled`` memory analysis on the 8-vdev CPU mesh.

Like contracts.py this module never imports jax: costs are pure
arithmetic over frozen DAG nodes and array *metadata* (shape/dtype/
nbytes attributes never force a device sync).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple

import numpy as np

from ..copr import dag as D
from ..expr.ir import Expr, Func
from ..types import dtypes as dt
from .contracts import PlanContractError

# ------------------------------------------------------------------ #
# gate thresholds + validated tolerance (pinned by tests/test_copcost)
# ------------------------------------------------------------------ #

# COST-PAD-WASTE: padded/live row ratio above this on a corpus plan is a
# finding.  The floor capacity (min_capacity=1024) alone puts toy corpus
# tables around 16x, so the gate threshold targets genuine blow-ups.
PAD_WASTE_MAX = 64.0
# COST-CAP-BLOWUP: an expanding join whose out_capacity exceeds this
# multiple of its per-device probe rows is a capacity-product blow-up.
CAP_BLOWUP_MAX = 64.0
# COST-DENSE-BLOWUP: a DENSE aggregation whose group-state rows exceed
# this multiple of its per-device input rows AND the planner's dense
# ceiling (DENSE_BLOWUP_MIN_GROUPS mirrors executor/plan
# MAX_DENSE_GROUPS, so a planner-selected DENSE plan can never trip
# the rule) is the degenerate large-NDV dense plan — state vectors
# dwarf the data; the strategy that 1000x-cliffed and then crashed the
# real-TPU hndv rung at sf>=10.  A gate finding on corpus plans and a
# CostError at sched admission, so selection falls back to the SEGMENT
# strategy instead of faulting the device.
DENSE_BLOWUP_MAX = 16.0
DENSE_BLOWUP_MIN_GROUPS = 1_000_000
# Validated prediction band: on the 8-vdev CPU mesh, peak_hbm_bytes
# stays within this factor of (measured resident input buffers + D x
# compiled per-device output+temp sizes); measured ratios on the corpus
# run 0.8-1.6x (tests/test_copcost.py pins the band).
COST_TOLERANCE = 4.0

# per-mesh HBM budget defaults: fraction of the device-reported limit,
# CPU fallback when the backend reports no memory stats
HBM_BUDGET_FRACTION = 0.8
DEFAULT_CPU_HBM_BUDGET = 16 << 30     # 16 GiB of host "HBM" per mesh

_VALIDITY_BYTES = 1                   # bool mask lane per nullable column


class CostError(PlanContractError):
    """A launch's statically-derived device footprint violates the
    admission budget, or no static bound is derivable for one of its
    nodes.  Raised by sched admission BEFORE any trace/compile; a
    PlanError via PlanContractError, so it surfaces like a planner
    rejection with (rule, path, detail) intact."""


# ------------------------------------------------------------------ #
# layout + cost dataclasses
# ------------------------------------------------------------------ #

@dataclass(frozen=True)
class Layout:
    """Stacked-shard device layout of one scan input: S shards of pow2
    capacity C sharded over D devices (S padded to divide D, exactly as
    ColumnarSnapshot._put pads), with the statically-known live row
    count behind the padding."""
    n_shards: int
    capacity: int
    n_devices: int
    live_rows: int

    @property
    def rows_per_device(self) -> int:
        d = max(self.n_devices, 1)
        return (self.n_shards // d) * self.capacity

    @property
    def padded_rows(self) -> int:
        return self.n_shards * self.capacity


@dataclass(frozen=True)
class LaunchCost:
    """Static footprint of ONE device launch, all devices combined.

    ``peak_hbm_bytes`` = resident inputs + replicated aux + intermediate
    high-water (a no-fusion upper bound: every operator output counted)
    + output leaves, minus ``donated_bytes`` when a DonationPlan
    (analysis/lifetime) lets the launch alias its ephemeral inputs into
    outputs — in+out+temp drops toward max(in, out)+temp.
    ``transfer_bytes`` = H2D inputs/aux + D2H outputs.
    ``padding_waste`` = padded/live row ratio of the scan inputs."""
    input_bytes: int = 0
    aux_bytes: int = 0
    inter_bytes: int = 0
    output_bytes: int = 0
    flops: int = 0
    padded_cells: int = 0
    live_cells: int = 0
    # ((path, out_capacity, probe_rows_per_device), ...) per expanding join
    expanding_joins: tuple = ()
    # ((path, num_groups, rows_per_device), ...) per degenerate DENSE agg
    # (group states > DENSE_BLOWUP_MAX x the per-device input rows)
    dense_blowups: tuple = ()
    # ((path, passes, num_buckets), ...) per SCATTER agg whose priced
    # radix pass count exceeds MAX_RADIX_PASSES (COST-RADIX-PASSES)
    radix_blowups: tuple = ()
    # node paths for which no static bound could be derived
    unbounded: tuple = ()
    # ((label, bytes), ...) largest-first, for reports/EXPLAIN
    breakdown: tuple = ()
    # bytes a DonationPlan lets this launch alias input->output
    # (min(donated inputs, outputs): the donated buffer backs the
    # output instead of coexisting with it)
    donated_bytes: int = 0
    # per-link-class bytes (intra, ici, dci) — parallel/topology's
    # typed-link classification of this launch's traffic: intra carries
    # the host<->device transfer plus on-chip copies, ici/dci the
    # inter-chip collective payload (psum merges, all_to_all exchanges)
    # split by whether each hop crosses a host boundary.  Single-host
    # topologies price dci identically zero.
    transfer_breakdown: tuple = (0, 0, 0)

    @property
    def peak_hbm_bytes(self) -> int:
        return (self.input_bytes + self.aux_bytes + self.inter_bytes
                + self.output_bytes - self.donated_bytes)

    @property
    def transfer_bytes(self) -> int:
        return self.input_bytes + self.aux_bytes + self.output_bytes

    @property
    def ici_bytes(self) -> int:
        return self.transfer_breakdown[1] if self.transfer_breakdown else 0

    @property
    def dci_bytes(self) -> int:
        return self.transfer_breakdown[2] if self.transfer_breakdown else 0

    @property
    def padding_waste(self) -> float:
        return self.padded_cells / max(self.live_cells, 1)

    def combined(self, other: "LaunchCost") -> "LaunchCost":
        """Sum of two independent launches (plan-level rollup)."""
        a, b = self.transfer_breakdown or (0, 0, 0), \
            other.transfer_breakdown or (0, 0, 0)
        return LaunchCost(
            self.input_bytes + other.input_bytes,
            self.aux_bytes + other.aux_bytes,
            self.inter_bytes + other.inter_bytes,
            self.output_bytes + other.output_bytes,
            self.flops + other.flops,
            self.padded_cells + other.padded_cells,
            self.live_cells + other.live_cells,
            self.expanding_joins + other.expanding_joins,
            self.dense_blowups + other.dense_blowups,
            self.radix_blowups + other.radix_blowups,
            self.unbounded + other.unbounded,
            self.breakdown + other.breakdown,
            self.donated_bytes + other.donated_bytes,
            (a[0] + b[0], a[1] + b[1], a[2] + b[2]))


def format_bytes(n: int) -> str:
    f = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if f < 1024 or unit == "GiB":
            return f"{f:.1f}{unit}" if unit != "B" else f"{int(f)}B"
        f /= 1024
    return f"{int(n)}B"


# ------------------------------------------------------------------ #
# widths
# ------------------------------------------------------------------ #

def _width(t: Optional[dt.DataType]) -> int:
    """Logical on-device byte width of a value of type ``t`` — what an
    expression intermediate occupies after the compiler re-widens the
    narrowed scan representation (expr/compile._iwiden)."""
    if t is None:
        return 8
    try:
        return int(np.dtype(t.np_dtype()).itemsize)
    except TypeError:
        return 8        # host-object widths never ship; placeholder slot


def _schema_width(schema: Sequence[dt.DataType]) -> int:
    return sum(_width(t) + _VALIDITY_BYTES for t in schema)


def snapshot_scan_widths(snap) -> tuple:
    """Per stored column: (physical byte width as placed on device,
    mask lanes present) — mirrors ColumnarSnapshot._stacked_ranges
    (narrowed dtype, validity omitted when all rows are valid)."""
    out = []
    for c in snap.columns:
        if c.data.dtype == object:
            out.append((1, False))      # 1-byte placeholder upload
            continue
        out.append((int(c.narrowed().dtype.itemsize), not c.all_valid()))
    return tuple(out)


def snapshot_layout(snap, n_devices: int) -> Layout:
    """Device layout the snapshot's stacked upload will have on a mesh
    of ``n_devices`` — including the pad-to-divide shard padding."""
    s, cap, _counts = snap.shard_layout()
    d = max(int(n_devices), 1)
    s_pad = -(-s // d) * d
    return Layout(s_pad, cap, d, snap.num_rows)


def snapshot_input_bytes(snap, layout: Layout,
                         widths: Optional[tuple] = None) -> int:
    """Resident stacked bytes of the snapshot on device: every stored
    column ships (device_cols uploads the full snapshot, not just the
    scanned offsets), plus the per-shard live counts vector."""
    widths = snapshot_scan_widths(snap) if widths is None else widths
    per_row = sum(w + (_VALIDITY_BYTES if mask else 0) for w, mask in widths)
    return layout.padded_rows * per_row + layout.n_shards * 8


# ------------------------------------------------------------------ #
# the abstract interpreter (DAG walk)
# ------------------------------------------------------------------ #

def _expr_flops(e: Optional[Expr]) -> int:
    """Per-row op count of one expression tree (every Func node is one
    vector op lane; good enough for relative cost)."""
    if e is None or not isinstance(e, Func):
        return 0
    return 1 + sum(_expr_flops(a) for a in e.args)


class _Acc:
    """Per-device walk accumulator; totals multiply by D at rollup."""

    __slots__ = ("inter", "flops", "joins", "dense_blowups",
                 "radix_blowups", "unbounded", "breakdown")

    def __init__(self):
        self.inter = 0
        self.flops = 0
        self.joins = []         # (path, out_capacity, probe_rows)
        self.dense_blowups = []  # (path, num_groups, rows)
        self.radix_blowups = []  # (path, passes, num_buckets)
        self.unbounded = []
        self.breakdown = []     # (label, per-device bytes)

    def buf(self, label: str, nbytes: int) -> None:
        if nbytes > 0:
            self.inter += int(nbytes)
            self.breakdown.append((label, int(nbytes)))


# per-agg accumulator state width in bytes (the (hi, lo) limb split of
# int/decimal SUM doubles its state; a valueflow-proven narrow SUM keeps
# a single int64 word; MIN/MAX/FIRST carry a valid lane)
def _agg_state_width(a: D.AggDesc, narrow: bool = False) -> int:
    if a.func == D.AggFunc.SUM:
        k = a.arg.dtype.kind if a.arg is not None and a.arg.dtype else None
        if k in (dt.TypeKind.FLOAT64, dt.TypeKind.FLOAT32):
            return 8
        return 8 if narrow else 16
    if a.func == D.AggFunc.COUNT:
        return 8
    return 8 + _VALIDITY_BYTES      # MIN / MAX / FIRST: value + valid


def _agg_groups(agg: D.Aggregation, rows: int) -> int:
    """Static bound on the per-device group-state rows.  SORT/SEGMENT
    capacity 0 means "client starts at its default and regrows" — the
    static bound is the per-device row count itself (distinct groups
    cannot exceed contributing rows), so every corpus shape stays
    boundable."""
    if agg.strategy == D.GroupStrategy.SCALAR:
        return 1
    if agg.strategy == D.GroupStrategy.DENSE:
        return max(agg.num_groups, 1)
    cap = agg.state_capacity
    return cap if cap > 0 else max(min(rows, _default_group_capacity()), 1)


def _default_group_capacity() -> int:
    from ..store.client import DEFAULT_GROUP_CAPACITY
    return DEFAULT_GROUP_CAPACITY


def _log2(n: int) -> int:
    return max(int(n - 1).bit_length(), 1)


def _walk(node: D.CopNode, path: tuple, rows: int, layout: Layout,
          widths: Optional[tuple], acc: _Acc) -> Tuple[int, int]:
    """Abstract-interpret one node; returns (rows_out, width_out) of its
    per-device output batch.  ``rows`` is the per-device row count the
    node consumes; buffers are recorded per-device in ``acc``."""
    p = path + (type(node).__name__,)

    if isinstance(node, D.TableScan):
        # the flattened (S/D*C,) view aliases the resident upload — no
        # new buffer, but it fixes the chain's schema width
        if widths is not None:
            w = sum(widths[o][0] + (_VALIDITY_BYTES if widths[o][1] else 0)
                    for o in node.col_offsets if o < len(widths))
        else:
            w = _schema_width(node.col_dtypes)
        return rows, w

    kids = node.children()
    rows_in, w_in = (_walk(kids[0], p, rows, layout, widths, acc)
                     if kids else (rows, 0))

    if isinstance(node, D.Selection):
        for cond in node.conditions:
            acc.flops += _expr_flops(cond) * rows_in
        acc.buf("/".join(p) + ":mask", rows_in * _VALIDITY_BYTES)
        return rows_in, w_in

    if isinstance(node, D.Projection):
        w_out = _schema_width([e.dtype for e in node.exprs])
        for e in node.exprs:
            acc.flops += _expr_flops(e) * rows_in
        acc.buf("/".join(p), rows_in * w_out)
        return rows_in, w_out

    if isinstance(node, D.Expand):
        w_out = _schema_width(D.output_dtypes(node))
        rows_out = rows_in * max(node.levels, 1)
        acc.flops += rows_out
        acc.buf("/".join(p), rows_out * w_out)
        return rows_out, w_out

    if isinstance(node, D.Aggregation):
        groups = _agg_groups(node, rows_in)
        swidth = sum(_agg_state_width(a, narrow=(i in node.narrow_sums))
                     for i, a in enumerate(node.aggs))
        has_minmax = any(a.func in (D.AggFunc.MIN, D.AggFunc.MAX,
                                    D.AggFunc.FIRST) for a in node.aggs)
        for g in node.group_by:
            acc.flops += _expr_flops(g) * rows_in
        for a in node.aggs:
            acc.flops += (_expr_flops(a.arg) + 1) * rows_in
        if node.strategy == D.GroupStrategy.SORT:
            swidth += len(node.group_by) * 8 + 8       # keys + __ngroups__
            # device sort of (dead, nullflag/code per key, payload
            # index): the comparator carries 1 + 2*k lanes, and every
            # lane rides every compare-exchange stage — the cost the
            # radix strategies exist to shed (SURVEY.md §7)
            acc.buf("/".join(p) + ":sort",
                    rows_in * (len(node.group_by) + 1) * 8)
            acc.flops += rows_in * _log2(rows_in) * (
                1 + 2 * len(node.group_by))
        elif node.strategy == D.GroupStrategy.SEGMENT:
            swidth += len(node.group_by) * 8 + 8       # keys + __ngroups__
            # avalanche hash (constant lanes per key) + ONE single-key
            # radix partition pass of (hash, payload-index)
            acc.buf("/".join(p) + ":radix", rows_in * 2 * 8)
            acc.flops += rows_in * (6 * max(len(node.group_by), 1)
                                    + _log2(rows_in))
        elif node.strategy == D.GroupStrategy.SCATTER:
            swidth += len(node.group_by) * 8 + 8       # keys + __ngroups__
            passes = D.radix_passes(node.num_buckets
                                    or max(rows_in, 2))
            n_digits = 1 << D.RADIX_BITS
            n_tiles = max(rows_in // D.RADIX_TILE, 1)
            # per pass: a per-tile digit histogram, the tiny exclusive
            # cumsum of bucket offsets, and the gather/scatter reorder
            # of the int32 index permutation — O(passes * n) streaming
            # data movement, NO comparator lanes.  Buffers (reused
            # across passes, priced once): per-tile histograms +
            # offsets + the int32 permutation ping-pong — under half of
            # SEGMENT's (hash, index) int64 sort operands per row, the
            # bytes half of the acceptance comparison (flops being the
            # other: 3*passes streaming ops vs n*log2(n) comparator
            # stages).
            acc.buf("/".join(p) + ":radix-hist", n_tiles * n_digits * 4)
            acc.buf("/".join(p) + ":radix-cumsum",
                    n_tiles * n_digits * 4)
            acc.buf("/".join(p) + ":radix-scatter", rows_in * 2 * 4)
            # hash (6 lanes/key, as SEGMENT) + per pass: digit extract,
            # histogram add, scatter store (3 ops/row)
            acc.flops += rows_in * (6 * max(len(node.group_by), 1)
                                    + 3 * passes)
            if passes > D.MAX_RADIX_PASSES:
                acc.radix_blowups.append(
                    ("/".join(p), passes, node.num_buckets))
        acc.buf("/".join(p) + ":states", groups * swidth)
        if node.strategy == D.GroupStrategy.DENSE \
                and groups > DENSE_BLOWUP_MIN_GROUPS \
                and groups > DENSE_BLOWUP_MAX * max(rows_in, 1):
            # degenerate dense domain: the state vector dwarfs the data
            # it aggregates — large-NDV keys must take SEGMENT instead
            acc.dense_blowups.append(("/".join(p), groups, rows_in))
        if node.strategy not in D.HOST_MERGE_STRATEGIES:
            # psum-merged states come back replicated; MIN/MAX ride the
            # psum-gather trick whose slot array is Dx the state
            acc.buf("/".join(p) + ":merged", groups * swidth)
            if has_minmax:
                acc.buf("/".join(p) + ":psum-gather",
                        layout.n_devices * groups * swidth)
            acc.flops += groups * max(len(node.aggs), 1) * layout.n_devices
        return groups, swidth

    if isinstance(node, (D.TopN,)):
        keys = node.sort_keys or (((node.sort_key, node.desc),)
                                  if node.sort_key is not None else ())
        nk = max(len(keys), 1)
        for e, _desc in keys:
            acc.flops += _expr_flops(e) * rows_in
        acc.buf("/".join(p) + ":sort", rows_in * (nk + 1) * 8)
        acc.flops += rows_in * _log2(rows_in) * nk
        return min(max(node.limit, 0), rows_in), w_in

    if isinstance(node, D.Limit):
        return min(max(node.limit, 0), rows_in), w_in

    if isinstance(node, D.LookupJoin):
        build_w = _schema_width(node.build_dtypes)
        acc.flops += (_expr_flops(node.probe_key) + _log2(rows_in)) * rows_in
        if node.kind in ("semi", "anti"):
            acc.buf("/".join(p) + ":mask", rows_in * _VALIDITY_BYTES)
            return rows_in, w_in
        if node.unique:
            acc.buf("/".join(p) + ":gather", rows_in * build_w)
            return rows_in, w_in + build_w
        cap = max(node.out_capacity, 0)
        acc.joins.append(("/".join(p), cap, rows_in))
        acc.buf("/".join(p) + ":expand", cap * (w_in + build_w))
        return cap, w_in + build_w

    if isinstance(node, D.FusedDag):
        last = (rows_in, w_in)
        for m in node.members:
            last = _walk(m, p, rows, layout, widths, acc)
        return last

    # a device node this interpreter has no size algebra for: no static
    # bound derivable -> COST-UNBOUNDED (and a CostError at admission)
    acc.unbounded.append("/".join(p))
    return rows_in, w_in


@functools.lru_cache(maxsize=1024)
def _dag_walk_cached(dag: D.CopNode, layout: Layout,
                     widths: Optional[tuple]):
    """Memoized per-device walk result; DAG nodes are frozen (they
    already key the jit-program cache), so repeated admission of one
    program costs a dict hit."""
    acc = _Acc()
    rows0 = layout.rows_per_device
    # flatten preamble: the live-row mask every program materializes
    acc.buf("flatten:base_sel", rows0 * _VALIDITY_BYTES)
    rows_out, w_out = _walk(dag, (), rows0, layout, widths, acc)
    return (acc.inter, acc.flops, tuple(acc.joins),
            tuple(acc.dense_blowups), tuple(acc.radix_blowups),
            tuple(acc.unbounded), tuple(acc.breakdown), rows_out, w_out)


def chain_rows(dag: D.CopNode, layout: Layout,
               widths: Optional[tuple] = None) -> Tuple[int, int]:
    """(per-device output rows, output row width in bytes) of one cop
    chain — the size half shardflow's exchange attribution reuses so
    the verifier and the cost model cannot drift."""
    out = _dag_walk_cached(dag, layout, widths)
    return out[-2], out[-1]


def _default_topology(n_devices: int):
    from ..parallel.topology import single_host
    return single_host(n_devices)


def _collective_breakdown(dag: D.CopNode, layout: Layout,
                          widths: Optional[tuple], topology,
                          merge_route: str):
    """Inter-chip bytes of a program's merge collectives, classified
    per link (parallel/topology).  In-program psum merges (SCALAR/DENSE
    incl. the psum-gather MIN/MAX trick, whose constant factor
    calibration absorbs per digest) exchange each member's state table
    across the mesh; host-merged group tables (SORT/SEGMENT/SCATTER)
    leave the device over PCIe — their D2H bytes already ride
    ``output_bytes``, so per-host routing adds nothing here, while the
    coordinator anti-route is priced as DCI so reports can show what
    SHARD-MERGE-COORDINATOR saves."""
    from ..parallel import topology as T
    bd = T.TransferBreakdown()
    members = dag.members if isinstance(dag, D.FusedDag) else (dag,)
    for m in members:
        if not isinstance(m, D.Aggregation):
            continue
        rows_out, w_out = chain_rows(m, layout, widths)
        state_bytes = rows_out * w_out
        if m.strategy in D.HOST_MERGE_STRATEGIES:
            if merge_route == T.MERGE_COORDINATOR and topology.multi_host:
                bd = bd.combined(T.TransferBreakdown(
                    dci=(topology.n_devices - topology.devices_per_host)
                    * state_bytes))
            continue
        bd = bd.combined(topology.split_psum(state_bytes))
    return bd


def _rows_kind_capacity(dag: D.CopNode, layout: Layout,
                        row_capacity: int) -> int:
    """Per-device output capacity of a row-returning program: the
    caller-pinned capacity when given, else the client's first paging
    guess (store.client INITIAL_SELECTIVITY discipline)."""
    if row_capacity > 0:
        return row_capacity
    if isinstance(dag, (D.TopN, D.Limit)):
        return max(dag.limit, 16)
    from ..store.client import INITIAL_SELECTIVITY
    from ..store.columnar import _pow2_at_least
    per_shard = layout.capacity
    return max(_pow2_at_least(max(per_shard // INITIAL_SELECTIVITY, 1)),
               1024)


def dag_cost(dag: D.CopNode, layout: Layout,
             widths: Optional[tuple] = None, *, input_bytes: int = 0,
             aux_bytes: int = 0, row_capacity: int = 0,
             donation=None, topology=None,
             merge_route: str = "per_host") -> LaunchCost:
    """LaunchCost of one program over one stacked scan input.

    ``input_bytes`` is the resident upload (exact at admission, modeled
    via snapshot_input_bytes at plan time); ``aux_bytes`` the host-
    materialized replicated inputs PER DEVICE COPY (totals multiply by
    the mesh size here).  ``donation`` is an optional
    ``analysis.lifetime.DonationPlan``: donated input bytes alias into
    the output allocation, so the peak drops by min(donated, output).
    ``topology`` (parallel/topology.MeshTopology, default the
    single-host all-ICI view of the layout's mesh) classifies the
    launch's merge-collective bytes per link into
    ``transfer_breakdown`` — the seam that makes admission, pricing and
    fusion caps topology-aware with no runtime change."""
    d = max(layout.n_devices, 1)
    topo = topology if topology is not None else _default_topology(d)
    (inter_pd, flops_pd, joins, dense_blowups, radix_blowups, unbounded,
     breakdown, rows_out, w_out) = _dag_walk_cached(dag, layout, widths)
    root = dag.members[-1] if isinstance(dag, D.FusedDag) and dag.members \
        else dag
    if isinstance(root, D.Aggregation):
        if root.strategy in D.HOST_MERGE_STRATEGIES:
            out_bytes = d * rows_out * w_out      # per-device host merge
        else:
            out_bytes = rows_out * w_out          # replicated, one D2H copy
    else:
        cap = _rows_kind_capacity(root, layout, row_capacity)
        out_bytes = d * (cap * (w_out + _VALIDITY_BYTES) + 8)
    aux_total = int(aux_bytes) * d
    donated = 0
    if donation is not None and donation.donate_argnums:
        from .lifetime import ARG_AUX, ARG_COLS
        donatable = 0
        if ARG_COLS in donation.donate_argnums:
            donatable += int(input_bytes)         # cols + counts upload
        if ARG_AUX in donation.donate_argnums:
            donatable += aux_total
        donated = min(donatable, int(out_bytes))
    coll = _collective_breakdown(dag, layout, widths, topo, merge_route)
    transfer = int(input_bytes) + aux_total + int(out_bytes)
    return LaunchCost(
        input_bytes=int(input_bytes),
        aux_bytes=aux_total,
        inter_bytes=inter_pd * d,
        output_bytes=int(out_bytes),
        flops=flops_pd * d,
        padded_cells=layout.padded_rows,
        live_cells=min(layout.live_rows, layout.padded_rows)
        or layout.padded_rows,
        expanding_joins=joins,
        dense_blowups=dense_blowups,
        radix_blowups=radix_blowups,
        unbounded=unbounded,
        breakdown=tuple(sorted(breakdown, key=lambda kv: -kv[1])[:8]),
        donated_bytes=donated,
        transfer_breakdown=(transfer + coll.intra, coll.ici, coll.dci))


# ------------------------------------------------------------------ #
# admission-time cost (exact input metadata from the stacked tensors)
# ------------------------------------------------------------------ #

def _nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def task_cost(task) -> Optional[LaunchCost]:
    """LaunchCost of a structured CopTask (sched/task), computed from
    tensor METADATA only (shape, dtype, size: never a device sync) plus
    the memoized DAG walk.  None for opaque tasks (shuffle and window
    closures: their capacities are owned by the client's regrow loop)."""
    if task.dag is None or task.cols is None:
        return None
    s = c = 0
    input_bytes = 0
    widths = []
    for v, m in task.cols:
        if v.dim() >= 2 and not s:
            s, c = int(v.shape[0]), int(v.shape[1])
        input_bytes += _nbytes(v)
        widths.append((int(v.element_size()), m is not None))
        if m is not None:
            input_bytes += _nbytes(m)
    if task.counts is not None:
        input_bytes += _nbytes(task.counts)
    aux_bytes = 0
    for grp in task.aux or ():
        for v, m in grp:
            aux_bytes += _nbytes(v)
            if m is not None:
                aux_bytes += _nbytes(m)
    n_dev = len(task.mesh) if task.mesh is not None else 1
    # live rows are a device-resident count; the padded extent is the
    # honest static bound (waste reads 1.0x at admission by design)
    layout = Layout(s or 1, c or 1, n_dev, (s or 1) * (c or 1))
    donation = None
    if getattr(task, "donate", False):
        # donating task: the lifetime plan's release tightens the
        # admission bound (verify_task_donation already vetted safety)
        from .lifetime import donation_plan
        donation = donation_plan(task.dag, "solo")
    # typed-link classification of the merge collectives: the declared
    # host view (tidb_tpu_topology_hosts) splits ici/dci here, making
    # RU pricing and the HBM/fusion caps topology-aware at admission
    from ..parallel.topology import topology_for
    topo = topology_for(task.mesh) if task.mesh is not None else None
    return dag_cost(task.dag, layout, tuple(widths),
                    input_bytes=input_bytes, aux_bytes=aux_bytes,
                    row_capacity=task.row_capacity, donation=donation,
                    topology=topo)


def mesh_hbm_budget(devices) -> int:
    """Default HBM admission budget of a device tuple: a fraction of the
    card's memory (``torch.cuda.get_device_properties().total_memory``;
    the logical devices share the one card, so not times their count),
    or 0 = unlimited on the CPU, which reports no device memory — as the
    JAX package's budget is without device memory stats."""
    from ..obs.hbm import device_memory_stats
    stats = device_memory_stats(devices)
    limit = int((stats or {}).get("bytes_limit", 0) or 0)
    if limit > 0:
        return int(HBM_BUDGET_FRACTION * limit)
    return 0


# ------------------------------------------------------------------ #
# plan-level cost (EXPLAIN footer + the analysis gate's corpus pass)
# ------------------------------------------------------------------ #

def _est_rows(op) -> int:
    """Rough row estimate of a host build-side subtree: the first table
    snapshot found below it (filters only shrink it — an upper bound),
    else a small default."""
    tbl = getattr(op, "table", None)
    if tbl is not None:
        try:
            return int(tbl.snapshot().num_rows)
        except (AttributeError, TypeError):
            return 1024
    for c in getattr(op, "children", []) or []:
        if c is not None:
            n = _est_rows(c)
            if n:
                return n
    return 1024


def _op_snapshot(op):
    tbl = op.table
    if getattr(op, "as_of_snap", None) is not None:
        return op.as_of_snap
    if getattr(tbl, "partition", None) is not None and \
            hasattr(tbl, "partition_snapshot"):
        return tbl.partition_snapshot(getattr(op, "partitions", None))
    return tbl.snapshot()


def _cop_exec_cost(op, n_devices: int, donation=None,
                   topology=None) -> LaunchCost:
    snap = _op_snapshot(op)
    layout = snapshot_layout(snap, n_devices)
    widths = snapshot_scan_widths(snap)
    input_bytes = snapshot_input_bytes(snap, layout, widths)
    aux = 0
    dag = op.dag
    if type(op).__name__ == "CopJoinTaskExec":
        builds = (op.builds if op.builds
                  else [{"exec": op.build_exec}])
        joins = []

        def collect(n):
            if isinstance(n, D.LookupJoin):
                joins.append(n)
            for k in n.children():
                collect(k)
        collect(dag)
        for i, b in enumerate(builds):
            bx = b.get("exec")
            rows = _est_rows(bx) if bx is not None else 1024
            j = joins[i] if i < len(joins) else None
            bw = _schema_width(j.build_dtypes) if j is not None else 8
            aux += rows * (16 + bw)       # sorted keys + perm + columns
    return dag_cost(dag, layout, widths, input_bytes=input_bytes,
                    aux_bytes=aux, donation=donation, topology=topology)


def exchange_bucket_rows(rows_total: int, n_devices: int) -> int:
    """Per-(device, destination) send-bucket row capacity of one
    all_to_all exchange side — the client's initial formula (2x
    headroom over a uniform hash, pow2; store/client
    ``_shuffle_initial_caps``).  Shared with shardflow so the verifier's
    per-link prediction and the runtime caps agree by construction."""
    from ..store.columnar import _pow2_at_least
    d = max(n_devices, 1)
    return _pow2_at_least(max(2 * rows_total // max(d * d, 1) + 1, 1024))


def _exchange_cost(rows_side: int, width: int, layout: Layout) -> int:
    """Per-device all_to_all send-bucket bytes of one shuffle side."""
    d = max(layout.n_devices, 1)
    cap = exchange_bucket_rows(rows_side, d)
    return d * cap * (width + _VALIDITY_BYTES)


def shuffle_exchange_buckets(spec, llayout: Layout, rlayout: Layout,
                             lwidths, rwidths, n_devices: int) -> tuple:
    """Per-(device, destination) send-bucket BYTES of each exchange
    side of a shuffle join, from the CHAIN-output rows (an Expand in an
    exchange chain multiplies what the scan read — the COST-DCI-BLOWUP
    seam).  Row payload mirrors what _side actually ships: the chain's
    columns, the int64 key lane, and the key-ok + valid mask lanes.
    Shared by the plan cost model and shardflow's per-link attribution
    so prediction and verification cannot drift."""
    d = max(n_devices, 1)
    lrows, lwidth = chain_rows(spec.left, llayout, lwidths)
    rrows, rwidth = chain_rows(spec.right, rlayout, rwidths)
    return (exchange_bucket_rows(lrows * d, d)
            * (lwidth + 8 + 2 * _VALIDITY_BYTES),
            exchange_bucket_rows(rrows * d, d)
            * (rwidth + 8 + 2 * _VALIDITY_BYTES))


def _with_exchange(cost: LaunchCost, topo, bucket_bytes_sides) -> tuple:
    """Per-link split of one or more all_to_all exchange edges, summed
    onto a cost's transfer_breakdown tuple."""
    bd = cost.transfer_breakdown or (0, 0, 0)
    intra, ici, dci = bd
    for bucket_bytes in bucket_bytes_sides:
        s = topo.split_all_to_all(bucket_bytes)
        intra += s.intra
        ici += s.ici
        dci += s.dci
    return (intra, ici, dci)


def _shuffle_exec_cost(op, n_devices: int, topology=None) -> LaunchCost:
    spec = op.spec
    topo = topology if topology is not None \
        else _default_topology(n_devices)
    lsnap, rsnap = op.left_table.snapshot(), op.right_table.snapshot()
    llay = snapshot_layout(lsnap, n_devices)
    rlay = snapshot_layout(rsnap, n_devices)
    lw, rw = snapshot_scan_widths(lsnap), snapshot_scan_widths(rsnap)
    cost = dag_cost(spec.left, llay, lw, topology=topo,
                    input_bytes=snapshot_input_bytes(lsnap, llay, lw))
    cost = cost.combined(dag_cost(
        spec.right, rlay, rw, topology=topo,
        input_bytes=snapshot_input_bytes(rsnap, rlay, rw)))
    # exchange buckets + the joined partition the top chain consumes
    d = max(n_devices, 1)
    wl = _schema_width(spec.left_dtypes)
    wr = _schema_width(spec.right_dtypes)
    from ..store.columnar import _pow2_at_least
    ocap = _pow2_at_least(max(2 * lsnap.num_rows // d + 1, 1024))
    exch = (_exchange_cost(lsnap.num_rows, wl, llay)
            + _exchange_cost(rsnap.num_rows, wr, rlay)
            + ocap * (wl + wr))
    top_layout = Layout(d, ocap, d, min(lsnap.num_rows, d * ocap))
    top = dag_cost(spec.top, top_layout, None, topology=topo)
    cost = cost.combined(replace(top, input_bytes=0,
                                 inter_bytes=top.inter_bytes + exch * d,
                                 padded_cells=0, live_cells=0))
    # per-link exchange attribution, from the shared bucket algebra
    sides = shuffle_exchange_buckets(spec, llay, rlay, lw, rw, d)
    return replace(cost,
                   transfer_breakdown=_with_exchange(cost, topo, sides))


def _window_exec_cost(op, n_devices: int, topology=None) -> LaunchCost:
    snap = op.table.snapshot()
    topo = topology if topology is not None \
        else _default_topology(n_devices)
    layout = snapshot_layout(snap, n_devices)
    widths = snapshot_scan_widths(snap)
    spec = op.spec
    cost = dag_cost(spec.child, layout, widths, topology=topo,
                    input_bytes=snapshot_input_bytes(snap, layout, widths))
    d = max(n_devices, 1)
    wcap = exchange_bucket_rows(snap.num_rows, d)
    w_out = _schema_width(op.out_dtypes)
    # partition buckets + one multi-key sort + per-item segment tables
    extra = d * (d * wcap * w_out + d * wcap * 8 * 2
                 + d * wcap * 8 * max(len(spec.items), 1))
    cost = replace(cost, inter_bytes=cost.inter_bytes + extra)
    # the repartition ships child cols + partition/order/arg lanes
    return replace(cost, transfer_breakdown=_with_exchange(
        cost, topo, (wcap * (w_out + _VALIDITY_BYTES),)))


def plan_cost(phys, n_devices: int = 8, topology=None) -> LaunchCost:
    """Roll up the static device footprint of every launch a built
    physical plan implies.  Walks the operator tree (no execution, no
    trace); host operators contribute nothing — their working memory is
    governed by the statement quota, not HBM.  ``topology`` classifies
    transfer per link class (default: the single-host all-ICI view)."""
    total = LaunchCost()
    stack = [phys]
    while stack:
        op = stack.pop()
        name = type(op).__name__
        if name == "CopTaskExec" or name == "CopJoinTaskExec":
            total = total.combined(
                _cop_exec_cost(op, n_devices, topology=topology))
        elif name == "CopShuffleJoinExec":
            total = total.combined(
                _shuffle_exec_cost(op, n_devices, topology=topology))
        elif name == "CopWindowExec":
            total = total.combined(
                _window_exec_cost(op, n_devices, topology=topology))
        for c in getattr(op, "children", []) or []:
            if c is not None:
                stack.append(c)
        fb = getattr(op, "fallback", None)
        if fb is not None:
            stack.append(fb)
    return total


__all__ = ["CostError", "LaunchCost", "Layout", "dag_cost",
           "plan_cost", "format_bytes", "task_cost", "mesh_hbm_budget",
           "snapshot_layout", "snapshot_scan_widths",
           "snapshot_input_bytes", "chain_rows", "exchange_bucket_rows",
           "shuffle_exchange_buckets",
           "PAD_WASTE_MAX", "CAP_BLOWUP_MAX",
           "DENSE_BLOWUP_MAX", "DENSE_BLOWUP_MIN_GROUPS", "COST_TOLERANCE",
           "DEFAULT_CPU_HBM_BUDGET", "HBM_BUDGET_FRACTION"]
