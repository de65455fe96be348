# ported from tidb_tpu/copr/dag.py @ a9e9482
"""Coprocessor DAG — the serialized pushdown plan.

Reference analog: tipb.DAGRequest / tipb.Executor (the protobuf executor
tree TiDB ships to TiKV/TiFlash coprocessors; see SURVEY.md §A.1 for the
exact node set the in-repo engine handles: TableScan, Selection, Projection,
Aggregation, StreamAgg, TopN, Limit, ExchangeSender/Receiver...).

The TPU build keeps the same tree shape as the unit of pushdown, but the
"coprocessor" compiles the whole tree into ONE fused XLA program per plan
digest (the closure-executor analog, unistore/cophandler/closure_exec.go:468)
instead of interpreting operators row-batch by row-batch.  Nodes are frozen
dataclasses so a DAG hashes to a jit-cache key (analog of the cop cache,
pkg/store/copr/coprocessor_cache.go).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple

from ..expr.ir import Expr
from ..types import dtypes as dt


class AggFunc(enum.Enum):
    COUNT = "count"          # COUNT(expr): non-null count; arg None = COUNT(*)
    SUM = "sum"
    MIN = "min"
    MAX = "max"
    FIRST = "first"          # group key passthrough
    # AVG never reaches the coprocessor: the planner splits it into
    # SUM + COUNT exactly like the reference (SURVEY.md §A.4).  The
    # variance/stddev family is likewise rewritten to SUM/SUM(x^2)/COUNT.
    # Host-side aggregates (aggfuncs breadth; _bind_agg keeps them off the
    # device program):
    BIT_AND = "bit_and"
    BIT_OR = "bit_or"
    BIT_XOR = "bit_xor"
    GROUP_CONCAT = "group_concat"
    ANY_VALUE = "any_value"
    JSON_ARRAYAGG = "json_arrayagg"


@dataclass(frozen=True)
class AggDesc:
    """Aggregate function descriptor (expression/aggregation analog)."""
    func: AggFunc
    arg: Optional[Expr]          # None only for COUNT(*)
    out_dtype: dt.DataType

    def __str__(self) -> str:
        return f"{self.func.value}({self.arg if self.arg is not None else '*'})"


@dataclass(frozen=True)
class CopNode:
    def children(self) -> Tuple["CopNode", ...]:
        return ()

    def __getstate__(self):
        # the cached hash (``_cache_hash``) is salted by the process: a
        # copy made in another process hashes anew
        state = dict(self.__dict__)
        state.pop("_hash", None)
        return state


def _cache_hash(cls):
    """Memoize the dataclass field hash of a frozen node on the instance:
    a DAG is hashed at every launch it keys (the task key, the program
    cache, the contract and cost memos), and its fields never change."""
    field_hash = cls.__hash__

    def __hash__(self):
        h = self.__dict__.get("_hash")
        if h is None:
            h = field_hash(self)
            object.__setattr__(self, "_hash", h)
        return h
    cls.__hash__ = __hash__
    return cls


@dataclass(frozen=True)
class TableScan(CopNode):
    """Reads columns of one shard (region analog).  `col_offsets` index into
    the shard's stored column order; the scan's output schema is exactly
    these columns in this order (tipb.TableScan carries ColumnInfos)."""
    col_offsets: Tuple[int, ...]
    col_dtypes: Tuple[dt.DataType, ...]


@dataclass(frozen=True)
class Selection(CopNode):
    child: CopNode = None  # type: ignore[assignment]
    conditions: Tuple[Expr, ...] = ()

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class Projection(CopNode):
    child: CopNode = None  # type: ignore[assignment]
    exprs: Tuple[Expr, ...] = ()

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class Expand(CopNode):
    """Grouping-sets row replication (GROUP BY ... WITH ROLLUP).

    Reference analog: tipb ExecType_TypeExpand executed at
    unistore/cophandler/mpp.go:638, planned by logical_expand.go:32.
    Output schema: child columns ++ one nullable column per rollup key ++
    gid (int64).  Level l of `levels` replicates every live row keeping
    the first len(keys)-l keys (rolled keys masked NULL); gid = l, so
    GROUPING() lowers to bit tests over gid and rolled NULLs stay
    distinguishable from natural NULLs.
    """
    child: CopNode = None  # type: ignore[assignment]
    keys: Tuple[Expr, ...] = ()
    levels: int = 0

    def children(self):
        return (self.child,)


class GroupStrategy(enum.Enum):
    SCALAR = "scalar"    # no GROUP BY: one output row
    DENSE = "dense"      # small known key domain -> dense group ids
    SORT = "sort"        # device multi-key sort + segment reduce
    SEGMENT = "segment"  # hash -> radix bucket partition + segment reduce
                         # (high NDV: one single-key sort regardless of key
                         # arity, bucket count from stats/copcost)
    SCATTER = "scatter"  # hash -> MULTI-PASS scatter radix partition +
                         # segment reduce (copr/radix.py): per-pass bucket
                         # histogram + exclusive-cumsum offsets + stable
                         # gather/scatter reorder, O(passes*n) data
                         # movement instead of lax.sort's O(n log n)
                         # comparator lanes; optional Pallas TPU kernel
                         # for the fused histogram+scatter inner loop


# strategies whose per-device group tables merge HOST-side (per-device
# group sets are not aligned, so there is no elementwise collective
# merge); consumers: spmd/shuffle host_merge policy, the client's
# regrow loop, contracts/fusion classes
HOST_MERGE_STRATEGIES = (GroupStrategy.SORT, GroupStrategy.SEGMENT,
                         GroupStrategy.SCATTER)

# strategies whose per-device group table is a pow2 `num_buckets` radix
# space regrown from observed __ngroups__ (the hash-partitioned pair)
RADIX_STRATEGIES = (GroupStrategy.SEGMENT, GroupStrategy.SCATTER)

# SCATTER radix geometry (jax-free so contracts/copcost can price passes
# without importing the kernel module): each pass orders RADIX_BITS of
# the partition key — the Pallas kernel as one 2^RADIX_BITS-digit
# histogram+scatter counting sort, the XLA lowering as RADIX_BITS 1-bit
# stable partition subpasses (identical stable permutation either way).
RADIX_BITS = 8
# residual hash bits ordered BELOW the log2(B) bucket bits: two groups
# colliding in the bucket bits alone would interleave into per-run
# duplicate segments (the table overflows toward O(rows) at modest
# NDV); eight residual bits cut that collision space 256x for under one
# extra pass, so observed __ngroups__ stays ~NDV like SEGMENT's
# full-hash ordering.  Remaining collisions are the usual duplicates,
# merged host-side by true key equality.
RADIX_RESIDUAL_BITS = 8
# the partition key must fit int32 (kernel lanes): bucket + residual
# bits clamp to 30, plus one dead-row tail bit above them
RADIX_KEY_BITS_MAX = 30
# rows per kernel grid step (copr/pallas/radix_kernel.TILE reads this):
# sizes the per-tile histogram/offset arrays both on device and in the
# copcost pricing, so the model and the kernel agree by construction
RADIX_TILE = 512
# contract ceiling on the pass count: above this the partition does more
# full-data passes than the comparator sort it replaces would ever pay —
# a malformed (astronomically regrown) bucket space, rejected pre-trace
# and surfaced as a COST-RADIX-PASSES gate finding
MAX_RADIX_PASSES = 8


def radix_key_bits(num_buckets: int) -> int:
    """Ordered partition-key bits for a pow2 bucket space: log2(B)
    bucket bits + residual bits (int32-clamped) + the dead-row tail
    bit.  Shared by the kernels, copcost pricing, and contracts."""
    log2b = max(int(num_buckets - 1).bit_length(), 0)
    return min(log2b + RADIX_RESIDUAL_BITS, RADIX_KEY_BITS_MAX) + 1


def radix_passes(num_buckets: int) -> int:
    """Scatter-partition pass count, RADIX_BITS digit bits per pass.
    The copcost pricing, the contract ceiling, the fusion signature,
    and the kernels all share this one formula.  Computed from the raw
    (unclamped) bit span so an absurd bucket space PRICES absurd —
    the COST-RADIX-PASSES / capacity-shape seam."""
    log2b = max(int(num_buckets - 1).bit_length(), 0)
    return -(-(log2b + RADIX_RESIDUAL_BITS + 1) // RADIX_BITS)


@dataclass(frozen=True)
class Aggregation(CopNode):
    """Partial (per-shard) hash aggregation.

    DENSE strategy: every group-by item must have a known finite code domain
    (dict-encoded string column, or planner-bounded int).  `domain_sizes[i]`
    is that size **including** a NULL slot when nullable; the fused kernel
    reduces into a dense (prod(domain_sizes),) state vector — the psum seam.
    SORT strategy handles unbounded domains via multi-key sort +
    segment-reduce into a fixed-capacity group table.
    SEGMENT strategy is the high-NDV device path: group keys avalanche-hash
    to a power-of-two `num_buckets` radix space whose top bits are the
    bucket id, ONE single-key partition pass orders rows bucket-major
    (residual hash ordering inside each bucket comes free), and each
    bucket's runs segment-reduce into a (num_buckets,) state table
    (copr/segment.py).
    SCATTER strategy replaces that single giant sort with a multi-pass
    scatter radix partition (copr/radix.py): radix_passes(num_buckets)
    stable counting-sort passes (histogram + exclusive cumsum + scatter
    reorder) order rows bucket-major in O(passes*n) data movement.
    `prehashed` (SEGMENT/SCATTER): the LAST scan column carries the
    precomputed per-row key hash, so bucket-space regrow re-entries skip
    re-hashing the key tuple (store/client hoists it once per statement).
    `narrow_sums` (SCALAR/DENSE): agg indexes whose int/decimal SUM the
    planner PROVED (analysis/valueflow, from ANALYZEd column stats) can
    never escape int64 across the whole table — those states accumulate
    a single int64 word instead of (hi, lo) limbs.  Part of the frozen
    hash, so narrow and limb programs key, cache, and fuse apart.
    """
    child: CopNode = None  # type: ignore[assignment]
    group_by: Tuple[Expr, ...] = ()
    aggs: Tuple[AggDesc, ...] = ()
    strategy: GroupStrategy = GroupStrategy.SCALAR
    domain_sizes: Tuple[int, ...] = ()   # DENSE only, aligned with group_by
    group_capacity: int = 0              # SORT only: max distinct groups/shard
    num_buckets: int = 0                 # SEGMENT/SCATTER: pow2 radix space
                                         # = state-table capacity per device
    prehashed: bool = False              # SEGMENT/SCATTER: last scan column
                                         # is the hoisted int64 key hash
    narrow_sums: Tuple[int, ...] = ()    # SCALAR/DENSE: agg indexes with a
                                         # valueflow-proven single-word SUM

    def children(self):
        return (self.child,)

    @property
    def num_groups(self) -> int:
        n = 1
        for s in self.domain_sizes:
            n *= s
        return n

    @property
    def state_capacity(self) -> int:
        """Per-device group-table capacity of a host-merged strategy."""
        return (self.num_buckets
                if self.strategy in RADIX_STRATEGIES
                else self.group_capacity)


@dataclass(frozen=True)
class TopN(CopNode):
    """Per-shard TopN (root merges shard tops, reference cophandler/topn.go).
    `sort_key`/`desc` is the single-key form; `sort_keys` (a tuple of
    (expr, desc) pairs, priority order) carries multi-column ORDER BY —
    the device sorts all keys in one lax.sort (cophandler/topn.go
    multi-ByItem analog)."""
    child: CopNode = None  # type: ignore[assignment]
    sort_key: Expr = None  # type: ignore[assignment]
    desc: bool = False
    limit: int = 0
    nulls_last: bool = False  # MySQL: NULLs first ASC, last DESC
    sort_keys: Tuple = ()     # ((Expr, desc), ...): overrides sort_key/desc

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class Limit(CopNode):
    child: CopNode = None  # type: ignore[assignment]
    limit: int = 0

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class LookupJoin(CopNode):
    """Broadcast lookup join against a host-materialized build side.

    Reference analog: the MPP broadcast join (ExchangeType_Broadcast +
    HashJoinProbeExec, cophandler/mpp_exec.go).  Two device strategies:

    - `unique=True` (FK->unique-PK): each probe row matches at most one
      build row, so the join is a sorted-lookup gather with NO output
      expansion — static shapes, MXU/VPU-friendly (SURVEY.md §2.10 P3).
    - `unique=False` (m:n): sorted-range lookup (lo/hi searchsorted) +
      cumsum slot assignment expands matches into an `out_capacity`-row
      batch; the true output size is reported in the program's extras so
      the dispatcher can regrow and retry (the paging discipline,
      SURVEY.md §5.7).  This replaces the reference's multi-match hash
      probe (join/hash_join_v2.go) — range-gather beats hash tables on TPU.

    The build side arrives as auxiliary program inputs (host-materialized,
    replicated to every device): aux[0] = sorted build keys (int64),
    aux[1] = permutation into build rows, aux[2:] = build columns.
    Output schema = probe schema ++ build columns (probe schema only for
    semi/anti); `kind` inner|left|semi|anti."""
    child: CopNode = None  # type: ignore[assignment]
    probe_key: Expr = None  # type: ignore[assignment]
    kind: str = "inner"
    build_dtypes: Tuple[dt.DataType, ...] = ()
    unique: bool = True
    out_capacity: int = 0          # unique=False only
    null_aware: bool = False       # anti only: NOT IN semantics
    # which aux GROUP carries this join's build side: a fused program may
    # chain several broadcast joins (the fragment tree cut at broadcast
    # exchanges, physicalop/fragment.go analog) — each join level reads
    # its own (sorted keys, perm, build columns) group
    aux_slot: int = 0

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class FusedDag(CopNode):
    """Multi-payload device program root: N member chains sharing one scan.

    Reference analog: shared-scan / multi-query optimization in compiled
    engines (Flare compiles shared work into one native kernel instead of
    re-executing it per query).  The admission scheduler groups queued
    cop tasks whose chains read the SAME snapshot scan (identical stacked
    device inputs, same mesh) but differ in filters/aggregates, and fuses
    them into ONE program whose output is a tuple with one leaf per
    member — the scan's HBM pass is paid once and XLA CSEs the shared
    subtrees (flatten, masks, common predicates) across members.

    Members must each be fully in-program aggregation chains (the
    contract class checked by analysis.contracts.fusion_signature); the
    node is frozen so the fused program caches on its digest exactly
    like any other cop DAG."""
    members: Tuple[CopNode, ...] = ()

    def children(self):
        return self.members


@dataclass(frozen=True)
class WindowShuffleSpec:
    """Device window-function program spec.

    Reference analog: TiFlash's MPP window execution — an exchange hash-
    partitioned on PARTITION BY feeds per-node sort + window operators
    (cophandler/mpp_exec.go window path, executor/window.go semantics).
    TPU redesign: the scan chain runs per device, rows hash-partition
    over the mesh by PARTITION BY keys via lax.all_to_all, each device
    multi-key-sorts its partitions once and computes every window item
    with segment ops — ONE shard_map program, exchange bytes on ICI.

    `items` is a tuple of (func, arg_expr_or_None, out_dtype);
    supported funcs: row_number | rank | dense_rank (need ORDER BY) and
    count | sum | min | max | avg over the WHOLE partition (no ORDER BY,
    default unbounded frame).  Output schema: child columns ++ one
    column per item (row order unspecified, like any unordered SELECT)."""
    child: CopNode
    partition_keys: Tuple = ()      # (Expr, ...) over child output
    order_keys: Tuple = ()          # ((Expr, desc), ...)
    items: Tuple = ()               # ((func, arg, out_dtype), ...)


@dataclass(frozen=True)
class ShuffleJoinSpec:
    """Cross-device repartition (shuffle) hash join program spec.

    Reference analog: the MPP HashPartition exchange + hash join
    (physicalop/physical_exchange_sender.go:109, executor/shuffle.go:86).
    TPU redesign: both sides' scan chains run per device, rows hash-
    partition over the mesh via lax.all_to_all (parallel/exchange.py), then
    each device runs the sorted-range expand join on its partition and the
    `top` chain (selection/projection/agg/topn/limit) over the join output
    — all inside ONE shard_map program, so exchange bytes ride ICI.

    `left`/`right` are CopNode chains rooted at their own TableScans;
    `left_key`/`right_key` are int64-comparable exprs over each chain's
    output.  `top`'s leaf TableScan reads the joined schema
    (left_dtypes ++ right_dtypes; probe side only for semi/anti)."""
    left: CopNode
    right: CopNode
    left_key: Expr
    right_key: Expr
    kind: str                       # inner | left | semi | anti
    left_dtypes: Tuple[dt.DataType, ...]
    right_dtypes: Tuple[dt.DataType, ...]
    top: CopNode


def output_dtypes(node: CopNode) -> Tuple[dt.DataType, ...]:
    """Schema of a node's output batch/states."""
    if isinstance(node, TableScan):
        return node.col_dtypes
    if isinstance(node, (Selection, Limit)):
        return output_dtypes(node.child)
    if isinstance(node, TopN):
        return output_dtypes(node.child)
    if isinstance(node, Expand):
        return (output_dtypes(node.child)
                + tuple(k.dtype.with_nullable(True) for k in node.keys)
                + (dt.bigint(False),))
    if isinstance(node, Projection):
        return tuple(e.dtype for e in node.exprs)
    if isinstance(node, Aggregation):
        return tuple(a.out_dtype for a in node.aggs)
    if isinstance(node, LookupJoin):
        if node.kind in ("semi", "anti"):
            return output_dtypes(node.child)
        return output_dtypes(node.child) + node.build_dtypes
    if isinstance(node, FusedDag):
        # one payload per member; the scheduler demuxes leaves, nothing
        # downstream consumes a concatenated schema
        return tuple(t for m in node.members for t in output_dtypes(m))
    raise TypeError(node)


def iter_nodes(node: CopNode):
    """Every node of a pushed DAG, root first (pre-order).  The static
    passes (analysis/contracts, copcost, lifetime) walk DAGs constantly;
    one shared iterator keeps their traversal order identical."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        stack.extend(n.children())


def find_expand_join(node: CopNode):
    """The (at most one) non-unique LookupJoin in a pushed DAG, or None —
    programs containing one report true join output size via extras."""
    if isinstance(node, LookupJoin) and not node.unique \
            and node.kind in ("inner", "left"):
        return node
    for c in node.children():
        found = find_expand_join(c)
        if found is not None:
            return found
    return None


def to_multimatch(node: CopNode, out_capacity: int) -> CopNode:
    """Rebuild the DAG with its LookupJoin switched to the non-unique
    (expanding) strategy — the dispatcher's runtime answer to discovering
    duplicate build keys (the reference decides hash-probe shape from NDV
    the same way, join/hash_join_v2.go build-side stats)."""
    import dataclasses
    if isinstance(node, LookupJoin):
        return dataclasses.replace(node, unique=False,
                                   out_capacity=out_capacity)
    if not node.children():
        return node
    kids = tuple(to_multimatch(c, out_capacity) for c in node.children())
    if isinstance(node, (Selection, Projection, Expand, Limit, TopN,
                         Aggregation)):
        return dataclasses.replace(node, child=kids[0])
    return node


def rewrite_lookup(node: CopNode, pred=None, **changes) -> CopNode:
    """Rebuild the DAG with the (pred-matching) LookupJoin's fields
    replaced (runtime strategy switches: multi-match regrow etc.)."""
    import dataclasses
    if isinstance(node, LookupJoin) and (pred is None or pred(node)):
        return dataclasses.replace(node, **changes)
    if not node.children():
        return node
    kids = tuple(rewrite_lookup(c, pred, **changes)
                 for c in node.children())
    if isinstance(node, (Selection, Projection, Expand, Limit, TopN,
                         Aggregation, LookupJoin)):
        return dataclasses.replace(node, child=kids[0])
    return node


def drop_lookup(node: CopNode, keep: bool) -> CopNode:
    """Replace the semi/anti LookupJoin with its probe chain outright:
    `keep=True` passes every probe row (anti vs an empty build),
    `keep=False` passes none (NOT IN with a NULL build key) via a
    constant-false Selection.  Exact — no sentinel keys that could
    collide with real data."""
    import dataclasses

    from ..expr.ir import Const
    if isinstance(node, LookupJoin):
        if keep:
            return node.child
        return Selection(node.child, (Const(dt.bigint(False), 0),))
    if not node.children():
        return node
    kids = tuple(drop_lookup(c, keep) for c in node.children())
    if isinstance(node, (Selection, Projection, Expand, Limit, TopN,
                         Aggregation, LookupJoin)):
        return dataclasses.replace(node, child=kids[0])
    return node


def rewrite_expand_capacity(node: CopNode, new_cap: int) -> CopNode:
    """Rebuild the DAG with the non-unique LookupJoin's out_capacity
    replaced (the dispatcher's regrow-and-retry step)."""
    return rewrite_lookup(node, pred=lambda j: not j.unique,
                          out_capacity=new_cap)


def chain_str(node: CopNode) -> str:
    """Compact fragment chain for EXPLAIN, leaf first:
    'TableScan>Selection>Expand>Aggregation[sort]'."""
    parts = []
    cur = node
    while cur is not None:
        name = type(cur).__name__
        if isinstance(cur, Aggregation):
            name += f"[{cur.strategy.value}]"
        parts.append(name)
        kids = cur.children()
        cur = kids[0] if kids else None
    return ">".join(reversed(parts))


for _cls in (TableScan, Selection, Projection, Expand, Aggregation, TopN,
             Limit, LookupJoin, FusedDag):
    _cache_hash(_cls)


def dag_digest(node: CopNode) -> int:
    """Stable-ish digest used as the jit-compile cache key together with the
    shard capacity bucket (SURVEY.md §A.6)."""
    return hash(node)


__all__ = [
    "AggFunc", "AggDesc", "CopNode", "TableScan", "Selection", "Projection",
    "Expand", "GroupStrategy", "HOST_MERGE_STRATEGIES", "RADIX_STRATEGIES",
    "RADIX_BITS", "RADIX_RESIDUAL_BITS", "MAX_RADIX_PASSES",
    "radix_passes", "radix_key_bits", "Aggregation",
    "TopN", "Limit", "LookupJoin",
    "FusedDag", "ShuffleJoinSpec", "output_dtypes", "dag_digest",
    "iter_nodes", "find_expand_join", "rewrite_lookup", "drop_lookup",
    "chain_str", "rewrite_expand_capacity",
]
