# ported from tidb_tpu/executor/plan.py @ 9d319cb
"""Logical plan -> physical plan with pushdown split.

Reference analog: the engine-choice half of physicalOptimize
(core/find_best_task.go deciding cop vs root) + executorBuilder
(executor/builder.go).  A maximal
DataSource-[Selection]-[Projection]-[Agg|TopN|Limit] suffix that passes the
capability checks becomes a single CopTaskExec (fused device program);
anything else lowers to host operators whose children are recursively
planned — so the scan/filter still runs on TPU under a host join/sort.
"""

from __future__ import annotations

from typing import Optional

from ..copr import dag as D
from ..copr.aggregate import GroupKeyMeta
from ..expr.ir import ColumnRef, Expr
from ..expr.lower_strings import expr_out_dict, lower_strings
from ..planner.build import DualSource
from ..planner.logical import (DataSource, LogicalAggregate, LogicalCTEScan,
                               LogicalJoin, LogicalLimit, LogicalPlan,
                               LogicalProjection, LogicalSelection,
                               LogicalSetOp, LogicalSort, LogicalTopN,
                               LogicalWindow)
from ..types import dtypes as dt
from .. import ANALYSIS, unported
from ..planner.ranger import LogicalIndexScan
from .physical import (CopTaskExec, CTEScanExec, DualExec, HostAgg,
                       HostHashJoin, HostLimit, HostProjection, HostSelection,
                       HostSetOp, HostSort, HostTopN, HostWindow,
                       IndexLookUpExec, PhysOp, _device_supported)

K = dt.TypeKind

MAX_DENSE_GROUPS = 1_000_000

# NDV threshold between the two unbounded-domain device strategies: at or
# above this estimated distinct-group capacity the planner picks SEGMENT
# (hash -> radix bucket partition, ONE single-key sort lane, copcost-
# derived pow2 bucket space) over SORT (multi-key comparator, 1 + 2*k
# lanes) — the multi-operand sort is what turned the real-TPU 2M-group
# bench rung into a 1000x cliff (BENCH_TPU.json hndv_vs_numpy 0.05x).
SEGMENT_MIN_NDV = 1 << 15

# stats handle for the CURRENT planning pass (set by the session around
# to_physical — the SUBQUERY_EXECUTOR contextvar precedent); consumers:
# SORT-agg group-table capacity from column NDV, so fresh auto-analyze
# stats skip the grow-from-default regrow round-trips
import contextvars

STATS_HANDLE: contextvars.ContextVar = contextvars.ContextVar(
    "stats_handle", default=None)

# host-only planning mode (set by HostApplyExec around inner-plan builds):
# correlated subqueries re-plan per distinct outer key with the key baked
# in as a constant — device fusion would compile a fresh XLA program per
# key, so the inner plan runs entirely on host executors instead
# (pkg/executor/parallel_apply.go runs plain executors the same way)
HOST_ONLY: contextvars.ContextVar = contextvars.ContextVar(
    "host_only", default=False)


def to_physical(p: LogicalPlan, no_device_join: bool = False) -> PhysOp:
    if isinstance(p, LogicalProjection) and isinstance(p.child, DualSource):
        return DualExec(list(p.exprs), out_names=p.schema.names())

    if isinstance(p, LogicalTopN) and p.limit + p.offset <= 4096:
        # order property first (find_best_task): a small ORDER BY+LIMIT
        # through an index walk reads ~limit rows; the device TopN scan
        # reads the whole table
        ordered = _try_index_ordered_topn(p)
        if ordered is not None:
            return ordered

    cop = _try_cop(p, no_device_join)
    if cop is not None:
        return cop

    ndj = no_device_join
    from ..planner.ranger import LogicalIndexMerge
    if isinstance(p, LogicalIndexMerge):
        from .physical import IndexMergeExec
        return IndexMergeExec(p.ds.table, list(p.accesses),
                              list(p.ds.col_offsets),
                              conditions=list(p.conditions),
                              out_names=p.schema.names(),
                              out_dtypes=[c.dtype for c in p.schema.cols])
    if isinstance(p, LogicalIndexScan):
        return IndexLookUpExec(p.ds.table, p.access, list(p.ds.col_offsets),
                               out_names=p.schema.names(),
                               out_dtypes=[c.dtype for c in p.schema.cols])
    if isinstance(p, LogicalSelection) and isinstance(p.children[0],
                                                      LogicalIndexScan):
        # fuse residual filters into the lookup so string consts lower
        # against the freshly built per-query dictionaries
        s = p.children[0]
        return IndexLookUpExec(s.ds.table, s.access, list(s.ds.col_offsets),
                               conditions=list(p.conditions),
                               out_names=s.schema.names(),
                               out_dtypes=[c.dtype for c in s.schema.cols])
    if isinstance(p, LogicalSelection):
        return HostSelection(to_physical(p.child, ndj), list(p.conditions))
    if isinstance(p, LogicalProjection):
        return HostProjection(to_physical(p.child, ndj), list(p.exprs),
                              out_names=p.schema.names())
    if isinstance(p, LogicalAggregate):
        return HostAgg(to_physical(p.child, ndj), list(p.group_exprs),
                       list(p.aggs), out_names=p.schema.names(),
                       out_dtypes=[c.dtype for c in p.schema.cols])
    from ..planner.logical import LogicalExpand
    if isinstance(p, LogicalExpand):
        from .physical import HostExpandExec
        return HostExpandExec(to_physical(p.child, ndj), list(p.keys),
                              p.levels, out_names=p.schema.names(),
                              out_dtypes=[c.dtype for c in p.schema.cols])
    if isinstance(p, LogicalJoin):
        method = _join_method_hint(p)
        if method == "merge":
            from .physical import HostMergeJoin
            return HostMergeJoin(p.kind, to_physical(p.left, ndj),
                                 to_physical(p.right, ndj),
                                 list(p.eq_keys), list(p.other_conds),
                                 out_names=p.schema.names(),
                                 out_dtypes=[c.dtype for c in p.schema.cols],
                                 null_aware=p.null_aware)
        if method == "inl":
            inl = _try_inl_join(p, ndj)
            if inl is not None:
                return inl
        return HostHashJoin(p.kind, to_physical(p.left, ndj),
                            to_physical(p.right, ndj),
                            list(p.eq_keys), list(p.other_conds),
                            out_names=p.schema.names(),
                            out_dtypes=[c.dtype for c in p.schema.cols],
                            null_aware=p.null_aware)
    if isinstance(p, LogicalSort):
        return HostSort(to_physical(p.child, ndj), list(p.keys))
    if isinstance(p, LogicalTopN):
        return HostTopN(to_physical(p.child, ndj), list(p.keys), p.limit,
                        p.offset)
    if isinstance(p, LogicalLimit):
        return HostLimit(to_physical(p.child, ndj), p.limit, p.offset)
    if isinstance(p, LogicalSetOp):
        # read children[0/1], not left/right: predicate pushdown may have
        # wrapped a child in a Selection via the generic children list
        return HostSetOp(p.kind, p.all,
                         to_physical(p.children[0], ndj),
                         to_physical(p.children[1], ndj),
                         out_names=p.schema.names(),
                         out_dtypes=[c.dtype for c in p.schema.cols])
    if isinstance(p, LogicalWindow):
        dev = _try_cop_window(p)
        if dev is not None:
            return dev
        return HostWindow(to_physical(p.children[0], ndj), list(p.items),
                          out_names=p.schema.names(),
                          out_dtypes=[c.dtype for c in p.schema.cols])
    from ..planner.logical import LogicalApply
    if isinstance(p, LogicalApply):
        from .physical import HostApplyExec
        inner = p.children[0]
        return HostApplyExec(to_physical(inner, ndj),
                             list(p.subqueries), p.catalog, p.default_db,
                             outer_quals=[(c.name.lower(),
                                           (c.qualifier or "").lower())
                                          for c in inner.schema.cols],
                             out_names=p.schema.names(),
                             out_dtypes=[c.dtype for c in p.schema.cols])
    if isinstance(p, LogicalCTEScan):
        return CTEScanExec(p.storage, p.role,
                           out_names=p.schema.names(),
                           out_dtypes=[c.dtype for c in p.schema.cols])
    if isinstance(p, DataSource):
        if getattr(p.table, "is_memtable", False):
            from .physical import MemTableExec
            return MemTableExec(p.table, list(p.col_offsets),
                                out_names=p.schema.names(),
                                out_dtypes=[c.dtype for c in p.schema.cols])
        if HOST_ONLY.get() or not _scan_device_ok(p):
            if getattr(p, "as_of_ts", None) is not None:
                from ..planner.build import PlanError
                if HOST_ONLY.get():
                    raise PlanError("AS OF TIMESTAMP is not supported "
                                    "inside correlated subqueries")
                raise PlanError("AS OF TIMESTAMP is not supported on "
                                "tables with wide DECIMAL columns")
            from .physical import HostTableScanExec
            return HostTableScanExec(p.table, list(p.col_offsets),
                                     out_names=p.schema.names(),
                                     out_dtypes=[c.dtype
                                                 for c in p.schema.cols])
        raise AssertionError("DataSource should fuse into a CopTask")
    raise NotImplementedError(type(p).__name__)


# --------------------------------------------------------------------- #

def _try_index_ordered_topn(p) -> Optional[PhysOp]:
    """Order-property physical choice (find_best_task keep-order analog,
    core/optimizer.go:1080): ORDER BY <index prefix> LIMIT n over a
    KV-backed table is served by walking the index in key order (or
    backward for DESC) with an early-stop handle fetch — no sort operator
    in the plan.  Requires: plain ColumnRef keys forming a prefix of one
    index, uniform direction, child = DataSource or Selection(DataSource)
    with row-evaluable residuals."""
    from ..expr.ir import ColumnRef
    from ..planner.ranger import IndexAccess
    child = p.child
    conds: list = []
    proj = None
    keys = list(p.keys)
    if isinstance(child, LogicalProjection) \
            and all(isinstance(e, ColumnRef) for e in child.exprs):
        # see through a pure column projection: remap keys into the
        # source schema; the projection re-applies above the ordered scan
        proj = child
        remapped = []
        for e, d in keys:
            if not isinstance(e, ColumnRef) \
                    or e.index >= len(proj.exprs):
                return None
            remapped.append((proj.exprs[e.index], d))
        keys = remapped
        child = child.children[0]
    if isinstance(child, LogicalSelection):
        conds = list(child.conditions)
        child = child.children[0]
    if not isinstance(child, DataSource) or child.table.kv is None \
            or getattr(child.table, "partition", None) is not None \
            or getattr(child, "as_of_ts", None) is not None \
            or getattr(child.table, "is_memtable", False):
        return None
    if not keys:
        return None
    descs = {d for _, d in keys}
    if len(descs) != 1:
        return None                     # mixed ASC/DESC: order not native
    desc = descs.pop()
    key_cols = []
    for e, _d in keys:
        if not isinstance(e, ColumnRef):
            return None
        key_cols.append(child.table.col_names[
            child.col_offsets[e.index]].lower()
            if e.index < len(child.col_offsets) else None)
    if None in key_cols:
        return None
    ignore = {n.lower() for n in (child.hint_ignore or [])}
    for ix in child.table.indexes:
        if ix.state != "public" or ix.name.lower() in ignore:
            continue
        if [c.lower() for c in ix.columns[:len(key_cols)]] == key_cols:
            acc = IndexAccess(ix)       # full-range ordered walk
            scan = IndexLookUpExec(
                child.table, acc, list(child.col_offsets),
                conditions=conds,
                out_names=child.schema.names(),
                out_dtypes=[c.dtype for c in child.schema.cols],
                keep_order=True, reverse=desc,
                limit=p.limit, offset=p.offset)
            if proj is None:
                return scan
            return HostProjection(scan, list(proj.exprs),
                                  out_names=proj.schema.names())
    return None



def _scan_device_ok(ds) -> bool:
    """Wide (19-65 digit) decimal and VECTOR columns are host object
    arrays and can never be stacked into device shards."""
    return not any(getattr(c.dtype, "is_host_object", False)
                   for c in ds.schema.cols)

def _try_cop(p: LogicalPlan, no_device_join: bool = False) -> Optional[PhysOp]:
    """Fuse the subtree rooted at p into one CopTask if possible."""
    if HOST_ONLY.get():
        return None
    top = None          # Aggregation | TopN | Limit at the root
    mids: list = []     # Selection / Projection chain
    cur = p
    if isinstance(cur, (LogicalAggregate, LogicalTopN, LogicalLimit)):
        top = cur
        cur = cur.child
    from ..planner.logical import LogicalExpand
    expand_l = None     # rollup Expand between the agg and its scan chain
    if isinstance(top, LogicalAggregate) and isinstance(cur, LogicalExpand):
        expand_l = cur
        cur = cur.child
    while isinstance(cur, (LogicalSelection, LogicalProjection)):
        mids.append(cur)
        cur = cur.child
    if isinstance(cur, LogicalJoin) and not no_device_join:
        if expand_l is not None:
            return None      # rollup-over-join: host Expand above the join
        if _join_method_hint(cur):
            return None      # join-method hint overrides device fusion
        return _try_cop_join(p, top, mids, cur)
    if not isinstance(cur, DataSource):
        return None
    ds = cur
    if getattr(ds.table, "is_memtable", False):
        return None     # infoschema memtables read host state, never device

    # partition pruning (rule_partition_processor.go analog): predicates
    # directly on the scan narrow the partition id list BEFORE fusing
    pruned = None
    if getattr(ds.table, "partition", None) is not None:
        spec = ds.table.partition
        try:
            scan_ix = list(ds.col_offsets).index(
                ds.table.col_names.index(spec.column))
        except ValueError:
            scan_ix = None
        if scan_ix is not None:
            conds = []
            for m in reversed(mids):
                if not isinstance(m, LogicalSelection):
                    break
                conds.extend(m.conditions)
            from ..planner.partition_prune import prune_partitions
            pruned = prune_partitions(spec, scan_ix, conds)

    # stale reads bind against the HISTORICAL snapshot: its string
    # dictionaries (and data) differ from the current epoch's
    as_of = getattr(ds, "as_of_ts", None)
    snap = (ds.table.snapshot_at(as_of) if as_of is not None
            else ds.table.snapshot())
    dicts = {}
    for i, off in enumerate(ds.col_offsets):
        c = snap.columns[off]
        if c.dictionary is not None:
            dicts[i] = c.dictionary

    # bind + lower the chain bottom-up
    if not _scan_device_ok(ds):
        return None
    node: D.CopNode = D.TableScan(tuple(ds.col_offsets),
                                  tuple(c.dtype for c in ds.schema.cols))
    cur_dicts = dict(dicts)
    out_dtypes = [c.dtype for c in ds.schema.cols]
    out_names = ds.schema.names()
    out_dicts = dict(cur_dicts)
    for m in reversed(mids):
        if isinstance(m, LogicalSelection):
            conds = tuple(lower_strings(c, cur_dicts) for c in m.conditions)
            if not all(_device_supported(c) for c in conds):
                return None
            node = D.Selection(node, conds)
        else:
            exprs = tuple(lower_strings(e, cur_dicts) for e in m.exprs)
            if not all(_device_supported(e) for e in exprs):
                return None
            node = D.Projection(node, exprs)
            new_dicts = {}
            for j, e in enumerate(exprs):
                d = expr_out_dict(e, cur_dicts)
                if d is not None:
                    new_dicts[j] = d
            cur_dicts = new_dicts
            out_dicts = dict(new_dicts)
            out_dtypes = [e.dtype for e in exprs]
            out_names = m.schema.names()

    if expand_l is not None:
        # fuse the rollup Expand into the device program: appended key
        # columns join the scan schema (dicts follow), gid is plain int64
        ex_keys = tuple(lower_strings(k, cur_dicts) for k in expand_l.keys)
        if not all(_device_supported(k) for k in ex_keys):
            return None
        base = len(out_dtypes)
        node = D.Expand(node, ex_keys, expand_l.levels)
        new_dicts = dict(cur_dicts)
        for j, k in enumerate(ex_keys):
            dct = expr_out_dict(k, cur_dicts)
            if dct is not None:
                new_dicts[base + j] = dct
        cur_dicts = new_dicts
        out_dtypes = (list(out_dtypes)
                      + [c.dtype for c in expand_l.schema.cols[base:]])
        out_names = (list(out_names)
                     + [c.name for c in expand_l.schema.cols[base:]])
        out_dicts = dict(cur_dicts)

    key_meta: list[GroupKeyMeta] = []
    if top is None:
        pass
    elif isinstance(top, LogicalAggregate):
        agg_dicts: dict[int, object] = {}
        # NDV capacity seeding only resolves group keys against the SCAN
        # schema; a Projection in the chain remaps indices —
        # drop the seed there and let the client regrow from observed
        has_proj = any(isinstance(m, LogicalProjection) for m in mids)
        bounded = None
        if expand_l is not None:
            # the Expand's gid column has domain [0, levels)
            gid_ix = len(out_dtypes) - 1
            bounded = {gid_ix: expand_l.levels}
        agg_node = _bind_agg(top, node, cur_dicts, key_meta, agg_dicts,
                              ds=None if has_proj else ds,
                              bounded_ints=bounded,
                              # narrow proofs remap indices through any
                              # Projection themselves — keep the table
                              narrow_ds=ds)
        if agg_node is None:
            # aggregation itself not pushable: fuse the scan part only and
            # aggregate on host
            child_exec = CopTaskExec(node, ds.table, out_names=out_names,
                                     out_dtypes=out_dtypes,
                                     out_dicts=out_dicts,
                                     partitions=pruned, as_of_ts=as_of,
                                     as_of_snap=snap if as_of is not None
                                     else None)
            return HostAgg(child_exec, list(top.group_exprs), list(top.aggs),
                           out_names=top.schema.names(),
                           out_dtypes=[c.dtype for c in top.schema.cols])
        node = agg_node
        out_names = top.schema.names()
        out_dtypes = [c.dtype for c in top.schema.cols]
        out_dicts = {i: m.dictionary for i, m in enumerate(key_meta)
                     if m.dictionary is not None}
        for i, d in agg_dicts.items():   # MIN/MAX over dict-encoded strings
            out_dicts[len(key_meta) + i] = d
    elif isinstance(top, LogicalTopN):
        from ..utils.collate import is_binary, rank_table
        keys = []
        for key, desc in top.keys:
            key = lower_strings(key, cur_dicts)
            if not _device_supported(key):
                return None
            if key.dtype.is_string and not is_binary(key.dtype.collation):
                # ci collation: sort by rank LUT, not raw code
                d = (cur_dicts.get(key.index)
                     if isinstance(key, ColumnRef) else None)
                if d is None:
                    return None
                from ..expr import builders as B
                key = B.dict_map(
                    key, rank_table(d, key.dtype.collation).ranks)
            keys.append((key, desc))
        if not keys:
            return None
        node = D.TopN(node, sort_key=keys[0][0], desc=keys[0][1],
                      limit=top.limit + top.offset,
                      sort_keys=tuple(keys) if len(keys) > 1 else ())
        exec_ = CopTaskExec(node, ds.table, out_names=out_names,
                            out_dtypes=out_dtypes, out_dicts=out_dicts,
                            partitions=pruned, as_of_ts=as_of,
                            as_of_snap=snap if as_of is not None else None)
        # root merge of per-device tops
        return HostTopN(exec_, list(top.keys), top.limit, top.offset)
    elif isinstance(top, LogicalLimit):
        node = D.Limit(node, limit=top.limit + top.offset)
        exec_ = CopTaskExec(node, ds.table, out_names=out_names,
                            out_dtypes=out_dtypes, out_dicts=out_dicts,
                            partitions=pruned, as_of_ts=as_of,
                            as_of_snap=snap if as_of is not None else None)
        return HostLimit(exec_, top.limit, top.offset)

    return CopTaskExec(node, ds.table, partitions=pruned, as_of_ts=as_of,
                       as_of_snap=snap if as_of is not None else None,
                       out_names=out_names,
                       out_dtypes=out_dtypes, key_meta=key_meta,
                       out_dicts=out_dicts)


_WIN_RANK_FUNCS = ("row_number", "rank", "dense_rank")
_WIN_AGG_FUNCS = ("count", "sum", "min", "max", "avg")


def _try_cop_window(p) -> Optional[PhysOp]:
    """Push window functions to device (TiFlash MPP window analog): a
    hash-repartition by PARTITION BY co-locates each partition, then one
    per-device sort + segment ops compute every item.  Requirements:
    every item shares one PARTITION BY (non-empty) and ORDER BY, no
    explicit frames, rank-family or whole-partition aggregates only, and
    every key/arg lowers to a device expression."""
    if HOST_ONLY.get():
        return None
    from ..utils.collate import is_binary
    from .physical import CopWindowExec
    items = p.items
    if not items:
        return None
    part, order = items[0].partition, items[0].order
    if not part:
        return None      # global windows need a total order: host
    for it in items:
        if it.partition != part or it.order != order \
                or it.frame is not None:
            return None
        if it.func in _WIN_RANK_FUNCS:
            if not order and it.func != "row_number":
                return None
        elif it.func in _WIN_AGG_FUNCS:
            if order:
                return None      # ordered agg = moving frame: host
            if it.func != "count" and not it.args:
                return None
        else:
            return None
    builds: list = []
    bound = _bind_scan_chain(p.child)
    if bound is not None:
        node, cur_dicts, ds = bound
    else:
        # window-over-join (fragment.go: windows consume exchange
        # output): bind the join subtree as a broadcast fragment chain
        # feeding the repartition, with a host fallback for runtime
        # anomalies (empty/duplicate-keyed builds)
        jb = _bind_probe_side(p.child, builds)
        if jb is None or not builds:
            return None
        node, cur_dicts, ds = jb

    def low(e):
        e2 = lower_strings(e, cur_dicts)
        if not _device_supported(e2):
            return None
        if e2.dtype.np_dtype() == object:
            return None
        if e2.dtype.is_string and not is_binary(e2.dtype.collation):
            return None              # ci keys: code order != collation
        return e2

    pkeys = tuple(low(e) for e in part)
    if any(k is None for k in pkeys):
        return None
    okeys = []
    for e, desc in order:
        k = low(e)
        if k is None:
            return None
        okeys.append((k, desc))
    spec_items = []
    arg_dicts = {}
    for i, it in enumerate(items):
        arg = None
        if it.func in _WIN_AGG_FUNCS and it.args:
            arg = low(it.args[0])
            if arg is None:
                return None
            if it.func in ("min", "max"):
                d = expr_out_dict(arg, cur_dicts)
                if d is not None:
                    arg_dicts[i] = d
        spec_items.append((it.func, arg, it.out_dtype))
    spec = D.WindowShuffleSpec(node, pkeys, tuple(okeys),
                               tuple(spec_items))
    n_child = len(p.schema) - len(items)
    out_dicts = {i: d for i, d in cur_dicts.items() if i < n_child}
    for i, d in arg_dicts.items():
        out_dicts[n_child + i] = d
    fallback = None
    if builds:
        fallback = HostWindow(to_physical(p.children[0], True),
                              list(p.items),
                              out_names=p.schema.names(),
                              out_dtypes=[c.dtype
                                          for c in p.schema.cols])
    return CopWindowExec(spec, ds.table,
                         out_names=p.schema.names(),
                         out_dtypes=[c.dtype for c in p.schema.cols],
                         out_dicts=out_dicts,
                         builds=builds or None, fallback=fallback)


def _join_method_hint(p: LogicalJoin) -> str:
    """Effective join-method hint: the node's own annotation, or a leaf
    marker on a table attached DIRECTLY to this join (not through a
    nested join) — leaf markers survive join-reorder rebuilds."""
    if p.hint_method:
        return p.hint_method

    def direct(n):
        if n is None or isinstance(n, LogicalJoin):
            return ""
        if isinstance(n, DataSource):
            return getattr(n, "hint_join", "")
        for c in getattr(n, "children", []):
            m = direct(c)
            if m:
                return m
        return ""
    return direct(p.left) or direct(p.right)


def _inl_inner_ds(side):
    """Unwrap a Selection chain to a bare stored-table DataSource."""
    conds: list = []
    cur = side
    while isinstance(cur, LogicalSelection):
        conds.extend(cur.conditions)
        cur = cur.child
    if not isinstance(cur, DataSource) or getattr(cur.table, "kv", None) \
            is None or getattr(cur.table, "is_memtable", False):
        return None, None
    return cur, conds


def _try_inl_join(p: LogicalJoin, ndj: bool) -> Optional[PhysOp]:
    """INL_JOIN hint: the hinted side must reduce to a (possibly filtered)
    bare DataSource with a public index led by the join key column and a
    type-compatible outer key.  If join-reorder left the hinted table on
    the LEFT of an inner join, the sides swap (with an output
    permutation); otherwise fall back to hash join."""
    from ..utils.collate import is_binary
    from .physical import HostIndexLookupJoin
    if p.kind not in ("inner", "left", "semi", "anti") \
            or len(p.eq_keys) != 1:
        return None
    if p.kind == "anti" and p.null_aware:
        # NOT IN: a NULL inner key empties the whole result, but index
        # lookups never observe NULL inner rows — hash join handles it
        return None
    li, ri = p.eq_keys[0]

    def build(outer, inner, ok, ik, swapped):
        ds, conds = _inl_inner_ds(inner)
        if ds is None:
            return None
        key_name = ds.schema.cols[ik].name.lower()
        ot = outer.schema.cols[ok].dtype
        it = ds.schema.cols[ik].dtype
        if ot.kind != it.kind or ot.scale != it.scale:
            return None
        if it.is_string and not is_binary(it.collation):
            return None      # ci keys: index bytes are binary-exact
        ix = next((x for x in getattr(ds.table, "indexes", [])
                   if x.state == "public"
                   and x.columns[0].lower() == key_name), None)
        if ix is None:
            return None
        n_out = len(outer.schema)
        if swapped:
            # physical output is outer++inner = right++left; permute back
            n_in = len(ds.schema)
            perm = list(range(n_out, n_out + n_in)) + list(range(n_out))
        else:
            perm = None
        return HostIndexLookupJoin(
            p.kind, to_physical(outer, ndj), to_physical(inner, ndj),
            [(ok, ik)], list(p.other_conds),
            out_names=p.schema.names(),
            out_dtypes=[c.dtype for c in p.schema.cols],
            null_aware=p.null_aware,
            inner_table=ds.table, inner_index=ix,
            inner_offsets=list(ds.col_offsets), inner_conds=conds,
            inner_names=ds.schema.names(),
            inner_dtypes=[c.dtype for c in ds.schema.cols],
            out_perm=perm)

    # honor WHICH table the hint named as the lookup inner: prefer the
    # side carrying the 'inl' leaf marker
    lds, _ = _inl_inner_ds(p.left)
    rds, _ = _inl_inner_ds(p.right)
    left_hinted = (lds is not None
                   and getattr(lds, "hint_join", "") == "inl"
                   and not (rds is not None
                            and getattr(rds, "hint_join", "") == "inl"))
    tries = [(p.left, p.right, li, ri, False),
             (p.right, p.left, ri, li, True)]
    if left_hinted:
        tries.reverse()
    for outer, inner, ok, ik, swapped in tries:
        if swapped and (p.kind != "inner" or p.other_conds):
            continue     # only inner joins without residuals commute
        built = build(outer, inner, ok, ik, swapped)
        if built is not None:
            return built
    return None


BROADCAST_BUILD_MAX_ROWS = 1 << 22     # broadcast-join build-side cap


def _try_cop_join(p: LogicalPlan, top, mids, join: LogicalJoin) -> Optional[PhysOp]:
    """Device broadcast-lookup join: probe chain (left) stays sharded on
    device; a small build side (right) materializes host-side, replicates,
    and joins via sorted-lookup gather inside the SAME fused program as the
    downstream selection/projection/aggregation (MPP broadcast-join analog,
    SURVEY.md P3/P7).  Falls back to the host hash join at runtime when the
    build keys turn out non-unique."""
    from .physical import CopJoinTaskExec

    if join.kind not in ("inner", "left", "semi", "anti") \
            or len(join.eq_keys) != 1:
        return None
    li, ri = join.eq_keys[0]
    from ..utils.collate import is_binary
    for side, k in ((join.left, li), (join.right, ri)):
        kt = side.schema.cols[k].dtype
        if kt.is_string and not is_binary(kt.collation):
            # ci join keys: code/rank remap differs per side; the host hash
            # join compares through merged collation ranks
            return None

    # build side: any Selection/Projection/Join subtree over DataSources
    # whose base rows fit the broadcast budget — a join-shaped build is a
    # host-materialized FRAGMENT (fragment.go cut: the build subtree's
    # root is a Broadcast exchange).  Oversized single-table builds take
    # the cross-device repartition join instead.
    if not _broadcastable(join.right):
        bcur = join.right
        while isinstance(bcur, (LogicalSelection, LogicalProjection)):
            bcur = bcur.child
        if isinstance(bcur, DataSource):
            return _try_shuffle_join(p, top, mids, join)
        return None

    # probe = left subtree: Selection/Projection chain over a DataSource,
    # OR a nested broadcast-joinable join tree (the fragment chain —
    # physicalop/fragment.go cut at broadcast exchanges; each nested
    # level's build lands in its own aux group)
    builds: list = []
    lchain = _bind_probe_side(join.left, builds)
    if lchain is None:
        return None
    node, cur_dicts, ds = lchain
    n_probe = len(join.left.schema)

    # build side: its own (recursive) physical plan, host-materialized
    build_exec = to_physical(join.right)
    bsch = join.right.schema
    build_out_dicts = _subtree_output_dicts(join.right)

    probe_key = lower_strings(join.left.schema.ref(li), cur_dicts)
    if not _device_supported(probe_key):
        return None
    key_dict = cur_dicts.get(li) if probe_key.dtype.is_string else None
    semi = join.kind in ("semi", "anti")
    if builds and semi:
        # nested chains skip the runtime null-aware/empty-build special
        # cases semi/anti depend on — keep those single-level
        return None
    top_slot = len(builds)
    jnode = D.LookupJoin(node, probe_key=probe_key, kind=join.kind,
                         build_dtypes=() if semi else tuple(
                             c.dtype.with_nullable(True) if join.kind == "left"
                             else c.dtype for c in bsch.cols),
                         null_aware=join.null_aware, aux_slot=top_slot)

    # post-join conds/projections + optional top over the output schema
    # (probe ++ build; probe only for semi/anti)
    all_dicts = dict(cur_dicts)
    if not semi:
        for j, d in (build_out_dicts or {}).items():
            all_dicts[n_probe + j] = d
    bound = _bind_post_join(top, mids, join, jnode, all_dicts)
    if bound is None:
        return None  # generic path handles host agg over host join
    nodew, out_names, out_dtypes, out_dicts, key_meta, host_top = bound

    if builds and not semi:
        # chain mode has no runtime dictionary reattachment: every string
        # build column must carry a plan-time dictionary
        for j, c in enumerate(bsch.cols):
            if c.dtype.is_string and j not in (build_out_dicts or {}):
                return None
    fallback = to_physical(p, no_device_join=True)
    if builds:
        # fragment chain: nested builds + this join's own build, in aux
        # slot order; runtime anomalies fall back to the host plan whole
        builds.append({"exec": build_exec, "key_index": ri,
                       "key_dict": key_dict,
                       "probe_key_dtype": probe_key.dtype})
        exec_ = CopJoinTaskExec(
            nodew, ds.table, join_kind=join.kind, n_probe=n_probe,
            out_names=out_names, out_dtypes=out_dtypes, key_meta=key_meta,
            out_dicts=out_dicts, fallback=fallback, builds=builds)
    else:
        exec_ = CopJoinTaskExec(
            nodew, ds.table, build_exec=build_exec, build_key_index=ri,
            build_key_dict=key_dict, probe_key_dtype=probe_key.dtype,
            join_kind=join.kind, null_aware=join.null_aware, n_probe=n_probe,
            out_names=out_names, out_dtypes=out_dtypes, key_meta=key_meta,
            out_dicts=out_dicts, fallback=fallback)
    if host_top is not None and host_top[0] == "topn":
        return HostTopN(exec_, list(host_top[1].keys), host_top[1].limit,
                        host_top[1].offset)
    if host_top is not None:
        return HostLimit(exec_, host_top[1].limit, host_top[1].offset)
    return exec_


def _bind_probe_side(plan: LogicalPlan, builds: list):
    """Bind a probe subtree: Selection/Projection chain over a DataSource
    OR over a nested broadcast-joinable join (fragment chain).  Nested
    builds append to `builds` in aux-slot order.  Returns
    (node, output_dicts, base_datasource) or None."""
    mids: list = []
    cur = plan
    while isinstance(cur, (LogicalSelection, LogicalProjection)):
        mids.append(cur)
        cur = cur.child
    if isinstance(cur, LogicalJoin):
        if _join_method_hint(cur):
            return None
        sub = _bind_join_tree(cur, builds)
        if sub is None:
            return None
        node, cur_dicts, ds = sub
    else:
        sc = _bind_scan_chain(cur)
        if sc is None:
            return None
        node, cur_dicts, ds = sc
    for m in reversed(mids):
        if isinstance(m, LogicalSelection):
            conds = tuple(lower_strings(c, cur_dicts) for c in m.conditions)
            if not all(_device_supported(c) for c in conds):
                return None
            node = D.Selection(node, conds)
        else:
            exprs = tuple(lower_strings(e, cur_dicts) for e in m.exprs)
            if not all(_device_supported(e) for e in exprs):
                return None
            node = D.Projection(node, exprs)
            cur_dicts = {j: d for j, e in enumerate(exprs)
                         if (d := expr_out_dict(e, cur_dicts)) is not None}
    return node, cur_dicts, ds


def _bind_join_tree(join: LogicalJoin, builds: list):
    """Bind one NESTED join level of a broadcast fragment chain
    (inner/left, single equality key, unique-keyed small build — runtime
    anomalies make the whole chain fall back to host).  Appends this
    level's build spec and returns (node, joined_dicts, ds) or None."""
    from ..utils.collate import is_binary
    if join.kind not in ("inner", "left") or len(join.eq_keys) != 1:
        return None
    li, ri = join.eq_keys[0]
    for side, k in ((join.left, li), (join.right, ri)):
        kt = side.schema.cols[k].dtype
        if kt.is_string and not is_binary(kt.collation):
            return None
    if not _broadcastable(join.right):
        return None
    probe = _bind_probe_side(join.left, builds)
    if probe is None:
        return None
    node, cur_dicts, ds = probe
    n_probe = len(join.left.schema)
    probe_key = lower_strings(join.left.schema.ref(li), cur_dicts)
    if not _device_supported(probe_key):
        return None
    key_dict = cur_dicts.get(li) if probe_key.dtype.is_string else None
    bsch = join.right.schema
    bdicts = _subtree_output_dicts(join.right) or {}
    for j, c in enumerate(bsch.cols):
        if c.dtype.is_string and j not in bdicts:
            # chained joins skip the runtime dictionary reattachment a
            # single-level join performs: computed-string build columns
            # (fresh runtime dicts) must take the host path
            return None
    slot = len(builds)
    jnode = D.LookupJoin(node, probe_key=probe_key, kind=join.kind,
                         build_dtypes=tuple(
                             c.dtype.with_nullable(True)
                             if join.kind == "left" else c.dtype
                             for c in bsch.cols),
                         aux_slot=slot)
    builds.append({"exec": to_physical(join.right), "key_index": ri,
                   "key_dict": key_dict,
                   "probe_key_dtype": probe_key.dtype})
    all_dicts = dict(cur_dicts)
    for j, d in (_subtree_output_dicts(join.right) or {}).items():
        all_dicts[n_probe + j] = d
    out_node: D.CopNode = jnode
    if join.other_conds:
        if join.kind != "inner":
            return None
        conds = tuple(lower_strings(c, all_dicts)
                      for c in join.other_conds)
        if not all(_device_supported(c) for c in conds):
            return None
        out_node = D.Selection(out_node, conds)
    return out_node, all_dicts, ds


def _bind_post_join(top, mids, join: LogicalJoin, start: D.CopNode,
                    all_dicts: dict):
    """Bind the post-join chain — ON-residue Selection, mid
    Selection/Projections, and the top Agg/TopN/Limit — over the joined
    schema, shared by the broadcast and repartition join planners.
    Returns (node, out_names, out_dtypes, out_dicts, key_meta, host_top)
    or None when something must stay on host."""
    all_dicts = dict(all_dicts)
    out_names = join.schema.names()
    out_dtypes = [c.dtype for c in join.schema.cols]
    out_dicts = dict(all_dicts)
    nodew: D.CopNode = start
    if join.other_conds:
        if join.kind != "inner":
            # residual conditions on outer/semi/anti joins are per-pair
            # MATCH conditions, not filters: the host join evaluates them
            # per candidate pair; a fused device Selection would wrongly
            # drop (left) or mis-classify (semi/anti) probe rows.
            return None
        conds = tuple(lower_strings(c, all_dicts) for c in join.other_conds)
        if not all(_device_supported(c) for c in conds):
            return None
        nodew = D.Selection(nodew, conds)
    for m in reversed(mids):
        if isinstance(m, LogicalSelection):
            conds = tuple(lower_strings(c, all_dicts) for c in m.conditions)
            if not all(_device_supported(c) for c in conds):
                return None
            nodew = D.Selection(nodew, conds)
        else:
            exprs = tuple(lower_strings(e, all_dicts) for e in m.exprs)
            if not all(_device_supported(e) for e in exprs):
                return None
            nodew = D.Projection(nodew, exprs)
            all_dicts = {j: d for j, e in enumerate(exprs)
                         if (d := expr_out_dict(e, all_dicts)) is not None}
            out_names = m.schema.names()
            out_dtypes = [e.dtype for e in exprs]
            out_dicts = dict(all_dicts)

    key_meta: list[GroupKeyMeta] = []
    host_top = None
    if top is not None:
        if isinstance(top, LogicalAggregate):
            agg_dicts: dict[int, object] = {}
            agg_node = _bind_agg(top, nodew, all_dicts, key_meta,
                                  agg_dicts)
            if agg_node is None:
                return None
            nodew = agg_node
            out_names = top.schema.names()
            out_dtypes = [c.dtype for c in top.schema.cols]
            out_dicts = {i: m.dictionary for i, m in enumerate(key_meta)
                         if m.dictionary is not None}
            for i, d in agg_dicts.items():
                out_dicts[len(key_meta) + i] = d
        elif isinstance(top, LogicalTopN) and len(top.keys) == 1:
            key, desc = top.keys[0]
            key = lower_strings(key, all_dicts)
            if not _device_supported(key):
                return None
            nodew = D.TopN(nodew, sort_key=key, desc=desc,
                           limit=top.limit + top.offset)
            host_top = ("topn", top)
        elif isinstance(top, LogicalLimit):
            nodew = D.Limit(nodew, limit=top.limit + top.offset)
            host_top = ("limit", top)
        else:
            return None
    return nodew, out_names, out_dtypes, out_dicts, key_meta, host_top


def _bind_scan_chain(plan: LogicalPlan):
    """Bind a Selection/Projection chain over a DataSource into a device
    CopNode chain.  Returns (node, output_dicts, datasource) or None."""
    mids: list = []
    cur = plan
    while isinstance(cur, (LogicalSelection, LogicalProjection)):
        mids.append(cur)
        cur = cur.child
    if not isinstance(cur, DataSource):
        return None
    ds = cur
    if getattr(ds.table, "is_memtable", False):
        return None     # infoschema memtables never bind a device scan
    if getattr(ds, "as_of_ts", None) is not None:
        return None     # stale reads bind only through the plain CopTask
    snap = ds.table.snapshot()
    cur_dicts = {}
    for i, off in enumerate(ds.col_offsets):
        c = snap.columns[off]
        if c.dictionary is not None:
            cur_dicts[i] = c.dictionary
    if not _scan_device_ok(ds):
        return None
    node: D.CopNode = D.TableScan(tuple(ds.col_offsets),
                                  tuple(c.dtype for c in ds.schema.cols))
    for m in reversed(mids):
        if isinstance(m, LogicalSelection):
            conds = tuple(lower_strings(c, cur_dicts) for c in m.conditions)
            if not all(_device_supported(c) for c in conds):
                return None
            node = D.Selection(node, conds)
        else:
            exprs = tuple(lower_strings(e, cur_dicts) for e in m.exprs)
            if not all(_device_supported(e) for e in exprs):
                return None
            node = D.Projection(node, exprs)
            cur_dicts = {j: d for j, e in enumerate(exprs)
                         if (d := expr_out_dict(e, cur_dicts)) is not None}
    return node, cur_dicts, ds


# int64-comparable key kinds for the repartition join (equality compare +
# hash partition over raw int64 representation is exact for these)
_SHUFFLE_KEY_KINDS = {K.INT64, K.UINT64, K.DATE, K.DATETIME, K.TIME}


def _try_shuffle_join(p: LogicalPlan, top, mids,
                      join: LogicalJoin) -> Optional[PhysOp]:
    """Cross-device repartition hash join: both sides' scan chains stay
    sharded; rows hash-partition over the mesh (lax.all_to_all) and each
    device joins its partition, with the post-join chain fused in the same
    program (parallel/shuffle.py).  The MPP HashPartition exchange analog
    (physical_exchange_sender.go:109)."""
    import numpy as np

    from ..expr import builders as B
    from .physical import CopShuffleJoinExec

    if join.kind not in ("inner", "left", "semi", "anti"):
        return None
    if join.null_aware:
        return None   # NOT IN needs the host-side build-NULL check
    li, ri = join.eq_keys[0]
    lchain = _bind_scan_chain(join.left)
    rchain = _bind_scan_chain(join.right)
    if lchain is None or rchain is None:
        return None
    lnode, ldicts, lds = lchain
    rnode, rdicts, rds = rchain

    left_key = lower_strings(join.left.schema.ref(li), ldicts)
    right_key = lower_strings(join.right.schema.ref(ri), rdicts)
    if not (_device_supported(left_key) and _device_supported(right_key)):
        return None
    lt, rt = left_key.dtype, right_key.dtype
    if lt.is_string or rt.is_string:
        if not (lt.is_string and rt.is_string):
            return None
        ld, rd = ldicts.get(li), rdicts.get(ri)
        if ld is None or rd is None:
            return None
        # remap build codes into the probe dictionary's code space; values
        # absent from the probe dict map to -1 and can never match
        mapping = np.fromiter((ld.code_of(v) for v in rd.values),
                              np.int64, count=len(rd)) \
            if len(rd) else np.zeros(1, np.int64)
        right_key = B.dict_map(right_key, mapping)
    elif lt.kind == K.DECIMAL or rt.kind == K.DECIMAL:
        if lt.kind != K.DECIMAL or rt.kind != K.DECIMAL \
                or lt.scale != rt.scale:
            return None
    elif lt.kind not in _SHUFFLE_KEY_KINDS or rt.kind not in _SHUFFLE_KEY_KINDS:
        return None

    n_l = len(join.left.schema)
    joined_dtypes = tuple(c.dtype for c in join.schema.cols)
    all_dicts = dict(ldicts)
    if join.kind not in ("semi", "anti"):
        for j, d in rdicts.items():
            all_dicts[n_l + j] = d

    leaf: D.CopNode = D.TableScan(tuple(range(len(joined_dtypes))),
                                  joined_dtypes)
    bound = _bind_post_join(top, mids, join, leaf, all_dicts)
    if bound is None:
        return None
    nodew, out_names, out_dtypes, out_dicts, key_meta, host_top = bound

    spec = D.ShuffleJoinSpec(
        left=lnode, right=rnode, left_key=left_key, right_key=right_key,
        kind=join.kind,
        left_dtypes=tuple(c.dtype for c in join.left.schema.cols),
        right_dtypes=tuple(c.dtype for c in join.right.schema.cols),
        top=nodew)
    exec_ = CopShuffleJoinExec(spec, lds.table, rds.table,
                               out_names=out_names, out_dtypes=out_dtypes,
                               key_meta=key_meta, out_dicts=out_dicts)
    if host_top is not None and host_top[0] == "topn":
        return HostTopN(exec_, list(host_top[1].keys), host_top[1].limit,
                        host_top[1].offset)
    if host_top is not None:
        return HostLimit(exec_, host_top[1].limit, host_top[1].offset)
    return exec_


def _broadcastable(plan: LogicalPlan) -> bool:
    """True when the subtree is Selection/Projection/Join over DataSources
    whose TOTAL base rows fit the broadcast budget (upper bound on a
    unique-key join chain's output; m:n blowups are caught at runtime by
    the non-unique build-key check)."""
    total = 0
    stack = [plan]
    while stack:
        cur = stack.pop()
        if isinstance(cur, DataSource):
            if getattr(cur.table, "is_memtable", False):
                return False
            total += cur.table.num_rows
            if total > BROADCAST_BUILD_MAX_ROWS:
                return False
        elif isinstance(cur, (LogicalSelection, LogicalProjection,
                              LogicalJoin)):
            stack.extend(cur.children)
        else:
            return False
    return True


def _subtree_output_dicts(plan: LogicalPlan) -> dict:
    """Output-position -> StringDict through Selection/Projection/Join
    subtrees (generalizes _chain_output_dicts: a join concatenates left
    dicts with right dicts shifted by the left width).  Only ColumnRef
    projections pass a dictionary through — computed strings get fresh
    runtime dicts the device constants were not lowered against."""
    if isinstance(plan, DataSource):
        if getattr(plan.table, "is_memtable", False):
            return {}
        snap = plan.table.snapshot()
        return {i: c.dictionary
                for i, c in ((i, snap.columns[off])
                             for i, off in enumerate(plan.col_offsets))
                if c.dictionary is not None}
    if isinstance(plan, LogicalSelection):
        return _subtree_output_dicts(plan.child)
    if isinstance(plan, LogicalProjection):
        child = _subtree_output_dicts(plan.child)
        out = {}
        for j, e in enumerate(plan.exprs):
            if isinstance(e, ColumnRef) and e.index in child:
                out[j] = child[e.index]
        return out
    if isinstance(plan, LogicalJoin):
        if plan.kind in ("semi", "anti"):
            return _subtree_output_dicts(plan.children[0])
        left = _subtree_output_dicts(plan.children[0])
        right = _subtree_output_dicts(plan.children[1])
        n_left = len(plan.children[0].schema)
        out = dict(left)
        out.update({n_left + j: d for j, d in right.items()})
        return out
    return {}


def _chain_output_dicts(plan: LogicalPlan) -> dict:
    """Output-position -> StringDict for a Selection/Projection chain over a
    DataSource (identity for Selection; ColumnRef passthrough for
    Projection)."""
    chain = []
    cur = plan
    while isinstance(cur, (LogicalSelection, LogicalProjection)):
        chain.append(cur)
        cur = cur.child
    if not isinstance(cur, DataSource):
        return {}
    snap = cur.table.snapshot()
    dicts = {}
    for i, off in enumerate(cur.col_offsets):
        c = snap.columns[off]
        if c.dictionary is not None:
            dicts[i] = c.dictionary
    for m in reversed(chain):
        if isinstance(m, LogicalProjection):
            dicts = {j: d for j, e in enumerate(m.exprs)
                     if (d := expr_out_dict(e, dicts)) is not None}
    return dicts


def _maybe_narrow(agg_node: D.Aggregation, ds) -> D.Aggregation:
    """The aggregation unchanged.  The JAX package stamps valueflow-proven
    single-word SUM slots here, which needs ANALYZEd column intervals
    (slice 9) and the valueflow pass (slice 11); without a stats handle
    its own planner leaves the aggregation as it is, and so does the
    port's, which has none."""
    return agg_node


def _bind_agg(agg: LogicalAggregate, child: D.CopNode, dicts,
              key_meta_out: list, agg_dicts_out: dict,
              ds=None, bounded_ints=None,
              narrow_ds=None) -> Optional[D.Aggregation]:
    """Bind a LogicalAggregate to a device Aggregation (DENSE/SCALAR), or
    None if it must stay on host (generic keys / distinct).

    `bounded_ints` maps schema index -> finite domain size for planner-
    bounded integer keys (the rollup Expand's gid column), letting
    ROLLUP aggregations take the DENSE strategy — which is also what the
    TPU per-level Expand execution (copr/exec.py agg_states) keys on."""
    if any(a.distinct for a in agg.aggs):
        return None
    from ..utils.collate import is_binary
    if any(g.dtype.is_string and not is_binary(g.dtype.collation)
           for g in agg.group_exprs):
        return None      # ci group keys: host groups by collation rank
    descs = []
    for i, a in enumerate(agg.aggs):
        if (a.arg is not None and a.arg.dtype.is_string
                and not is_binary(a.arg.dtype.collation)
                and a.func in (D.AggFunc.MIN, D.AggFunc.MAX)):
            return None  # ci MIN/MAX: rank order != code order
        arg = lower_strings(a.arg, dicts) if a.arg is not None else None
        if arg is not None and not _device_supported(arg):
            return None
        if a.func not in (D.AggFunc.SUM, D.AggFunc.COUNT, D.AggFunc.MIN,
                          D.AggFunc.MAX):
            return None
        if (a.func in (D.AggFunc.MIN, D.AggFunc.MAX)
                and isinstance(arg, ColumnRef) and arg.index in dicts):
            agg_dicts_out[i] = dicts[arg.index]
        descs.append(D.AggDesc(a.func, arg, a.out_dtype))

    if not agg.group_exprs:
        return _maybe_narrow(
            D.Aggregation(child, (), tuple(descs), D.GroupStrategy.SCALAR),
            narrow_ds if narrow_ds is not None else ds)

    # DENSE when every key has a known finite domain — small dict-encoded
    # strings, or planner-bounded ints (rollup gid): the psum seam merges
    # aligned state vectors in-program (SURVEY.md §2.10 P2)
    bounded_ints = bounded_ints or {}

    def _key_domain(g):
        if not isinstance(g, ColumnRef):
            return None, None
        if g.dtype.is_string and g.index in dicts:
            d = dicts[g.index]
            return max(len(d) + (1 if g.dtype.nullable else 0), 1), d
        if g.index in bounded_ints and not g.dtype.is_string:
            return max(bounded_ints[g.index]
                       + (1 if g.dtype.nullable else 0), 1), None
        return None, None

    domains = [_key_domain(g) for g in agg.group_exprs]
    known_total = 0
    if all(size is not None for size, _d in domains):
        sizes = []
        metas = []
        total = 1
        for g, (size, d) in zip(agg.group_exprs, domains):
            sizes.append(size)
            metas.append(GroupKeyMeta(g.dtype, size, d))
            total *= size
        if total <= MAX_DENSE_GROUPS:
            key_meta_out.extend(metas)
            return _maybe_narrow(
                D.Aggregation(child, tuple(agg.group_exprs), tuple(descs),
                              D.GroupStrategy.DENSE,
                              domain_sizes=tuple(sizes)),
                narrow_ds if narrow_ds is not None else ds)
        # dense fell through on domain size: the known key-domain product
        # still bounds NDV when stats are absent
        known_total = total

    # SORT / SEGMENT / SCATTER for everything else orderable: device
    # partition + segment-reduce handles arbitrary NDV (the reference's
    # high-NDV parallel HashAgg, agg_hash_executor.go:94, re-designed for
    # TPU — SURVEY.md §7 hard part 4: sort-based group-by beats hashing
    # on TPU).  Above SEGMENT_MIN_NDV estimated groups the radix-
    # partitioned strategies win (one single-key partition lane instead
    # of the SORT comparator's 1 + 2*k); between them — and SORT —
    # selection is ARBITRATED per digest: the static copcost model
    # prices each candidate and the calibration store bends each
    # prediction by its measured time_factor, so a digest measured fast
    # on real hardware flips selection with no code change.
    metas = []
    lowered = []
    for g in agg.group_exprs:
        lg = lower_strings(g, dicts)
        if not _device_supported(lg):
            return None
        d = None
        if lg.dtype.is_string:
            # only dict-coded column refs can decode back to strings
            if isinstance(g, ColumnRef) and g.index in dicts:
                d = dicts[g.index]
            else:
                return None
        metas.append(GroupKeyMeta(g.dtype, 0, d))
        lowered.append(lg)
    key_meta_out.extend(metas)
    cap = _ndv_capacity(agg, ds)
    if cap == 0 and known_total:
        cap = _cap_pow2(known_total)
    if cap >= SEGMENT_MIN_NDV:
        candidates = (
            D.Aggregation(child, tuple(lowered), tuple(descs),
                          D.GroupStrategy.SCATTER, num_buckets=cap),
            D.Aggregation(child, tuple(lowered), tuple(descs),
                          D.GroupStrategy.SEGMENT, num_buckets=cap),
            D.Aggregation(child, tuple(lowered), tuple(descs),
                          D.GroupStrategy.SORT, group_capacity=cap),
        )
        return _arbitrate_strategy(candidates, ds)
    return D.Aggregation(child, tuple(lowered), tuple(descs),
                         D.GroupStrategy.SORT,
                         group_capacity=cap)


def _arbitrate_strategy(candidates, ds) -> D.Aggregation:
    """The JAX package prices SCATTER, SEGMENT and SORT with its cost
    model and picks the cheapest.  The port has no cost model yet, so it
    raises rather than pick a plan the JAX package might not pick."""
    raise unported("the high-NDV strategy choice by the cost model",
                   ANALYSIS)


def _cap_pow2(total: int) -> int:
    """25% headroom, pow2-rounded, bounded to [1024, 2^22] — the shape
    every group-table capacity / bucket count takes."""
    cap = 1 << (int(total * 1.25) - 1).bit_length()
    return max(1024, min(cap, 1 << 22))


def _ndv_capacity(agg, ds) -> int:
    """Initial SORT/SEGMENT group-table capacity from stats NDV (the
    consumer half of auto-analyze): product of per-key
    NDVs with 25% headroom, pow2-rounded, bounded — 0 when stats are
    absent (the client then starts at its default and regrows from
    observed __ngroups__).  Doubles as the strategy-selection NDV
    estimate (SEGMENT above SEGMENT_MIN_NDV)."""
    handle = STATS_HANDLE.get()
    if handle is None or ds is None:
        return 0
    st = handle.get(ds.table)
    if st is None:
        return 0
    total = 1
    for g in agg.group_exprs:
        if not isinstance(g, ColumnRef):
            return 0
        try:
            name = ds.schema.cols[g.index].name.lower()
        except (IndexError, AttributeError):
            return 0     # pruned/derived column: no stats to consult
        cs = st.col(name)
        if cs is None or not getattr(cs, "ndv", 0):
            return 0
        total *= max(int(cs.ndv), 1)
        if total > MAX_DENSE_GROUPS:
            break
    return _cap_pow2(total)


__all__ = ["to_physical"]
