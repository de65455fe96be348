# ported from tidb_tpu/executor/physical.py @ 3951242
"""Physical planning (pushdown split) + host root executors.

Reference analog: pkg/planner/core physicalOptimize's engine split (what
goes to the coprocessor vs stays in root executors, SURVEY.md §A.1
pushdown contract + capability registry) and pkg/executor's root operators
(HashAgg final, Sort, HashJoin, Projection, Limit).

Design: a maximal DataSource-[Selection]-[Projection]-[Agg|TopN|Limit]
chain over one table becomes a CopTask — ONE fused XLA program fanned out
via shard_map (parallel/spmd.py).  Everything else (joins, generic group
keys, HAVING residue, multi-key sorts) runs here on host numpy chunks —
the root-executor role.  Each host operator materializes its whole input
(tables are memory-resident columnar snapshots; streaming chunks come with
the paging/spill work).
"""

from __future__ import annotations

import contextvars
import time
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np

from ..chunk.column import Column, StringDict
from ..copr import dag as D
from ..copr.aggregate import GroupKeyMeta, sum_out_dtype
from ..expr.host_eval import eval_expr
from ..expr.ir import ColumnRef, Const, Expr, Func, referenced_columns
from ..expr.lower_strings import lower_strings
from ..planner.logical import (AggItem, DataSource, LogicalAggregate,
                               LogicalJoin, LogicalLimit, LogicalPlan,
                               LogicalProjection, LogicalSelection,
                               LogicalSort, LogicalTopN)
from ..planner.build import DualSource
from ..types import dtypes as dt

K = dt.TypeKind

# the device type ("cuda" or "cpu") the session's client runs cop tasks
# on; the session sets it while it builds the physical plan, so EXPLAIN
# names the device each Cop* operator dispatches to
COP_DEVICE: contextvars.ContextVar = contextvars.ContextVar(
    "cop_device", default="cuda")


def _cop_device() -> str:
    return COP_DEVICE.get()

# capability registry: ops the device evaluator implements — the analog of
# scalarExprSupportedByTiKV/Flash whitelists (expression/infer_pushdown.go).
# String functions (upper/concat/substring/...) are NOT here: they lower to
# dict_map/dict_lut at plan binding (expr/lower_strings.py); one left
# unlowered is exactly a pushdown-blacklist hit and stays on host.
DEVICE_OPS = {
    "add", "sub", "mul", "div", "intdiv", "mod", "neg", "abs",
    "eq", "ne", "lt", "le", "gt", "ge", "and", "or", "xor", "not",
    "isnull", "if", "case", "coalesce", "in", "dict_lut", "dict_map",
    "cast",
    # math (builtin_math_vec.go analogs)
    "ceil", "floor", "round", "truncate", "sqrt", "pow", "exp", "ln",
    "log", "log2", "log10", "sign", "greatest", "least", "sin", "cos",
    "tan", "cot", "asin", "acos", "atan", "atan2", "radians", "degrees",
    # temporal (builtin_time_vec.go analogs)
    "year", "month", "dayofmonth", "dayofweek", "weekday", "dayofyear",
    "quarter", "hour", "minute", "second", "microsecond", "datediff",
    "dateadd_days", "dateadd_months", "dateadd_micros", "last_day",
    "to_days", "from_days", "unix_timestamp", "week", "from_unixtime",
    "makedate",
}


def _device_supported(e: Expr) -> bool:
    if e.dtype is not None and getattr(e.dtype, "is_host_object", False):
        return False     # wide decimals / vectors are host object arrays
    if isinstance(e, Func):
        if e.op not in DEVICE_OPS:
            return False
        if e.op == "cast" and (e.dtype.is_string
                               or e.args[0].dtype.is_string):
            # a surviving string cast means dictionary lowering did not
            # apply (non-dict source); it must stay on host
            return False
        return all(_device_supported(a) for a in e.args)
    if isinstance(e, Const):
        # raw string consts must have been lowered to codes/LUTs
        return not isinstance(e.value, str)
    return True


# --------------------------------------------------------------------- #
# execution context + result chunks
# --------------------------------------------------------------------- #

@dataclass
class ExecContext:
    client: Any            # store.CopClient
    sysvars: Any = None
    mem_tracker: Any = None    # utils.memory.Tracker (statement root)
    spills: int = 0            # spill events this statement
    _kv_ts: dict = None        # engine id -> statement KV read snapshot

    def kv_read_ts(self, kv) -> int:
        """ONE KV read snapshot per statement and engine: every index/row
        lookup an executor tree performs reads the same commit state, the
        statement-snapshot discipline of the reference's snapshot ts
        (sessiontxn).  Allocated lazily on first KV access."""
        if self._kv_ts is None:
            self._kv_ts = {}
        ts = self._kv_ts.get(id(kv))
        if ts is None:
            ts = self._kv_ts[id(kv)] = kv.alloc_ts()
        return ts

    def track(self, nbytes: int):
        """Charge bytes to the statement quota (may raise
        MemoryExceededError through the tracker's action chain)."""
        if self.mem_tracker is not None:
            self.mem_tracker.consume(nbytes)

    def release(self, nbytes: int):
        """Return an operator's transient working-set charge (the
        reference releases on executor Close)."""
        if self.mem_tracker is not None:
            self.mem_tracker.release(nbytes)

    def remaining_quota(self):
        """Bytes left before tidb_mem_quota_query, or None if unlimited."""
        t = self.mem_tracker
        if t is None or t.limit < 0:
            return None
        return max(t.limit - t.consumed, 0)

    @property
    def spill_enabled(self) -> bool:
        from ..utils.memory import sysvar_bool
        sv = self.sysvars or {}
        return sysvar_bool(sv.get("tidb_enable_tmp_storage_on_oom"), True)


@dataclass
class ResultChunk:
    names: list[str]
    columns: list[Column]

    @property
    def num_rows(self):
        return len(self.columns[0]) if self.columns else 0

    def col_pairs(self):
        return [(c.data, (True if c.validity.all() else c.validity))
                for c in self.columns]

    def nbytes(self):
        return sum(c.data.nbytes + c.validity.nbytes for c in self.columns)


# Host streaming block: the Next()/required-rows protocol's chunk unit.
# The reference streams 1024-row Go chunks (exec/executor.go MaxChunkSize);
# numpy wants bigger vector blocks, so the host protocol streams 64K-row
# slices — same bounded-memory contract, amortized interpreter overhead.
STREAM_ROWS = 64 * 1024


def _empty_column(t: dt.DataType) -> Column:
    npdt = t.np_dtype()
    return Column(t, np.empty(0, npdt), np.empty(0, bool))


def _unify_string_columns(cols: list[Column]) -> list[Column]:
    """Remap string columns with differing dictionaries into one merged
    code space (per-chunk dictionaries arise from string-producing
    projections; scan chunks share the table dictionary)."""
    dicts = [c.dictionary for c in cols]
    first = dicts[0]
    if all(d is first for d in dicts):
        return cols
    merged = StringDict(
        [v for d in dicts if d is not None for v in d.values])
    out = []
    for c in cols:
        if c.dictionary is None or not len(c.dictionary):
            out.append(Column(c.dtype, np.zeros(len(c), c.data.dtype),
                              np.zeros(len(c), bool)
                              if c.dictionary is None else c.validity,
                              merged))
            continue
        m = np.fromiter((merged.code_of(v) for v in c.dictionary.values),
                        np.int64, count=len(c.dictionary))
        codes = m[np.clip(c.data, 0, len(m) - 1)].astype(c.data.dtype)
        out.append(Column(c.dtype, codes, c.validity, merged))
    return out


def concat_result_chunks(chunks: Sequence[ResultChunk], names,
                         dtypes=None) -> ResultChunk:
    """Concatenate streamed chunks, unifying per-chunk string dictionaries."""
    chunks = [c for c in chunks if c is not None]
    if not chunks:
        return ResultChunk(list(names),
                           [_empty_column(t) for t in (dtypes or [])])
    if len(chunks) == 1:
        return chunks[0]
    out = []
    for i in range(len(chunks[0].columns)):
        cols = [ch.columns[i] for ch in chunks]
        if cols[0].dtype.is_string:
            cols = _unify_string_columns(cols)
        out.append(Column.concat(cols))
    return ResultChunk(chunks[0].names, out)


def _slice_stream(chunk: ResultChunk):
    n = chunk.num_rows
    if n <= STREAM_ROWS:
        yield chunk
        return
    for lo in range(0, n, STREAM_ROWS):
        hi = min(lo + STREAM_ROWS, n)
        yield ResultChunk(chunk.names,
                          [c.slice(lo, hi) for c in chunk.columns])


def _parallel_map_chunks(ctx, source, fn):
    """Ordered parallel map over streamed chunks — the worker-pool seam of
    the reference's ProjectionExec (projection.go:205 parallelExecute) and
    hash-join probe workers (P10).  numpy kernels release the GIL, so the
    vectorized per-chunk work scales across threads; output order is
    preserved and at most 2x concurrency chunks are in flight (bounded
    memory).  fn returning None drops the chunk."""
    import os
    from collections import deque
    try:
        n = int((ctx.sysvars or {}).get("tidb_executor_concurrency", 5))
    except (TypeError, ValueError):
        n = 5
    # threads beyond physical cores only add pool overhead (the GIL-free
    # portion is the numpy kernels); a 1-core host runs the direct path
    n = min(n, os.cpu_count() or 1)
    if n <= 1:
        from ..copr.coordinator import check_killed
        for ch in source:
            check_killed()
            out = fn(ch)
            if out is not None:
                yield out
        return
    import contextvars

    from ..copr.coordinator import check_killed
    from ..utils.poolmgr import MANAGER

    # slots come from the global CPU-aware pool manager
    # (pkg/resourcemanager analog) — shared across queries/operators;
    # per-operator parallelism stays bounded by the 2n in-flight window
    MANAGER.ensure("executor", n)
    pending: deque = deque()
    for ch in source:
        check_killed()
        # workers must see the submitter's contextvars (HOST_ONLY,
        # SUBQUERY_EXECUTOR, OUTER_RESOLVER set by Apply/plan seams)
        ctx_copy = contextvars.copy_context()
        pending.append(MANAGER.submit("executor", ctx_copy.run, fn, ch))
        if len(pending) >= 2 * n:
            out = pending.popleft().result()
            if out is not None:
                yield out
    while pending:
        out = pending.popleft().result()
        if out is not None:
            yield out


class PhysOp:
    """Host operator. Implement EITHER `execute` (materializing) OR
    `chunks` (streaming); the base class derives the other.  `chunks` is
    the Volcano Next()-with-required-rows analog
    (pkg/executor/internal/exec/executor.go:51): a generator of bounded
    ResultChunks; `required_rows` hints that the consumer needs at most
    that many total rows (Limit/TopN early stop)."""
    out_names: list[str]
    out_dtypes: list[dt.DataType]

    # contract declaration (analysis/contracts verifier input): host ops
    # run over numpy chunks; Cop* ops override with "device" — their DAG
    # must be traceable-dense (static shapes, no host objects)
    locality = "host"
    sharding = ""          # device ops: "shard" (stacked columns) etc.

    def contract(self) -> dict:
        """Declared operator contract: output schema + locality +
        sharding, checked edge-by-edge by analysis.verify_plan BEFORE
        tracing.  Plain dict so the executor layer stays import-light."""
        return {
            "op": type(self).__name__,
            "out_names": tuple(getattr(self, "out_names", ()) or ()),
            "out_dtypes": tuple(getattr(self, "out_dtypes", ()) or ()),
            "locality": self.locality,
            "sharding": self.sharding,
        }

    def execute(self, ctx: ExecContext) -> ResultChunk:
        if type(self).chunks is PhysOp.chunks:
            raise NotImplementedError(type(self).__name__)
        return concat_result_chunks(list(self.chunks(ctx)),
                                    self.out_names, self.out_dtypes)

    def chunks(self, ctx: ExecContext, required_rows: Optional[int] = None):
        if type(self).execute is PhysOp.execute:
            raise NotImplementedError(type(self).__name__)
        yield from _slice_stream(self.execute(ctx))

    def explain(self, indent=0):
        pad = "  " * indent
        lines = [pad + self.describe()]
        for c in getattr(self, "children", []):
            lines.append(c.explain(indent + 1))
        return "\n".join(lines)

    def describe(self):
        return type(self).__name__


# --------------------------------------------------------------------- #
# CopTask: the pushed program
# --------------------------------------------------------------------- #

@dataclass
class CopTaskExec(PhysOp):
    """Fan one fused DAG out over the table's shards (TableReader analog,
    executor/table_reader.go + distsql fan-out collapsed into SPMD)."""
    locality = "device"
    sharding = "shard"
    dag: D.CopNode
    table: Any
    out_names: list[str] = field(default_factory=list)
    out_dtypes: list = field(default_factory=list)
    key_meta: list = field(default_factory=list)
    out_dicts: dict = field(default_factory=dict)
    children: list = field(default_factory=list)
    # pruned partition ids (None = all / table not partitioned) —
    # rule_partition_processor.go output carried on the reader
    partitions: Any = None
    # stale read: historical MVCC ts (sessiontxn/staleread); the planner
    # pins the snapshot it bound dictionaries against so execute doesn't
    # pay a second full historical scan
    as_of_ts: Any = None
    as_of_snap: Any = None
    device: str = field(default_factory=_cop_device)

    def describe(self):
        kind = "agg" if isinstance(self.dag, D.Aggregation) else "rows"
        part = ""
        if getattr(self.table, "partition", None) is not None:
            names = self.table.partition_names()
            shown = (names if self.partitions is None
                     else [names[i] for i in self.partitions])
            part = f" partitions={','.join(shown)}/{len(names)}"
        cached = " [cop-cache hit]" if getattr(self, "_cache_hit", False) \
            else ""
        return (f"CopTask[{kind}] table={self.table.name}{part} "
                f"dag={D.chain_str(self.dag)} -> {self.device}{cached}")

    def execute(self, ctx: ExecContext) -> ResultChunk:
        from ..copr.coordinator import QUERY_HANDLE, check_killed
        check_killed()
        handle = QUERY_HANDLE.get()
        if handle is not None:
            handle.note_fragment(self.describe())
        if self.as_of_ts is not None:
            snap = self.as_of_snap
            if snap is None:
                snap = self.as_of_snap = \
                    self.table.snapshot_at(self.as_of_ts)
        elif getattr(self.table, "partition", None) is not None:
            snap = self.table.partition_snapshot(self.partitions)
        else:
            snap = self.table.snapshot()
        if isinstance(self.dag, D.Aggregation):
            h0 = getattr(ctx.client, "result_cache_hits", 0)
            res = ctx.client.execute_agg(self.dag, snap, self.key_meta)
            # EXPLAIN ANALYZE surfacing (coprocessor_cache.go hit counter)
            self._cache_hit = \
                getattr(ctx.client, "result_cache_hits", 0) > h0
            cols = res.key_columns + res.columns
            for j, d in self.out_dicts.items():
                if cols[j].dictionary is None:
                    cols[j].dictionary = d
        else:
            cols = ctx.client.execute_rows(self.dag, snap,
                                           tuple(self.out_dtypes),
                                           self.out_dicts)
        # NOTE: scan output is NOT charged to the statement quota — the
        # columns are the device-resident data plane; the quota governs
        # host-side operator working memory.
        return ResultChunk(list(self.out_names), cols)


@dataclass
class HostTableScanExec(PhysOp):
    """Plain host scan of the columnar snapshot — used where device
    dispatch would be a pessimization: inner plans under a correlated
    Apply re-plan per distinct outer key, and baking the key into a
    device DAG would compile a fresh XLA program every time (TPC-H Q2's
    pathology: 100 keys x ~7s compile).  The reference's inner side of
    parallel_apply likewise runs plain executors."""
    table: Any
    col_offsets: list = field(default_factory=list)
    out_names: list = field(default_factory=list)
    out_dtypes: list = field(default_factory=list)
    children: list = field(default_factory=list)

    def describe(self):
        return f"HostTableScan table={self.table.name}"

    def chunks(self, ctx, required_rows=None):
        snap = self.table.snapshot()
        cols = [snap.columns[o] for o in self.col_offsets]
        yield from _slice_stream(ResultChunk(list(self.out_names), cols))


@dataclass
class CopJoinTaskExec(PhysOp):
    """Broadcast lookup join fused into the device program.

    Materializes the (small) build side host-side via its own physical
    plan, prepares sorted-key/permutation/column aux arrays, and runs the
    probe-side fused DAG (which contains a D.LookupJoin) over the sharded
    probe table with the aux inputs replicated to every device — the MPP
    broadcast-join analog.  When build keys turn out non-unique (decided at
    runtime, like the reference's NDV-based join choice), the DAG is
    rewritten to the expanding multi-match strategy (copr/join.py) and the
    m:n join still runs on device; the host fallback remains only for the
    empty-build edge."""
    locality = "device"
    sharding = "shard+replicated-build"
    dag: Any
    table: Any                     # probe-side TableInfo
    build_exec: PhysOp = None
    build_key_index: int = 0
    build_key_dict: Any = None     # probe-side StringDict for string keys
    probe_key_dtype: Any = None    # for decimal scale alignment
    join_kind: str = "inner"
    null_aware: bool = False
    n_probe: int = 0
    out_names: list = field(default_factory=list)
    out_dtypes: list = field(default_factory=list)
    key_meta: list = field(default_factory=list)
    out_dicts: dict = field(default_factory=dict)
    fallback: PhysOp = None
    children: list = field(default_factory=list)
    # fragment-tree mode (physicalop/fragment.go analog): a CHAIN of
    # broadcast joins fused into one program.  Each entry is a dict
    # {exec, key_index, key_dict, probe_key_dtype}; entry i feeds aux
    # group i (LookupJoin.aux_slot).  None = legacy single-join fields.
    builds: list = None
    device: str = field(default_factory=_cop_device)

    def __post_init__(self):
        self.children = ([b["exec"] for b in self.builds] if self.builds
                         else [self.build_exec])

    def describe(self):
        kind = "agg" if isinstance(self.dag, D.Aggregation) else "rows"
        lvl = f" x{len(self.builds)} levels" if self.builds else ""
        return (f"CopJoinTask[{kind},{self.join_kind}] probe={self.table.name}"
                f" broadcast-build{lvl} -> {self.device}")

    def execute(self, ctx: ExecContext) -> ResultChunk:
        if self.builds:
            return self._execute_tree(ctx)
        return self._execute_single(ctx)

    def _execute_tree(self, ctx: ExecContext) -> ResultChunk:
        """Chained broadcast joins: every level's build must be non-empty
        with unique keys (the planner only emits inner/left levels); any
        runtime anomaly falls back to the host plan whole."""
        t0 = time.perf_counter()
        groups = _prep_build_groups(ctx, self.builds, self._keys_for)
        if groups is None:
            return _join_fallback(ctx, self.fallback)
        build_s = _synced_since(ctx, t0)
        chunk = self._run(ctx, self.dag, groups)
        ctx.client.timings["build"] = build_s
        return chunk

    def _execute_single(self, ctx: ExecContext) -> ResultChunk:
        t0 = time.perf_counter()
        bchunk = self.build_exec.execute(ctx)
        kcol = bchunk.columns[self.build_key_index]
        keys, ok = self._build_keys(kcol)
        rows_idx = np.nonzero(ok)[0]           # NULL keys never join
        keys = keys[rows_idx]
        dag = self.dag
        semi = self.join_kind in ("semi", "anti")
        if self.null_aware and not kcol.validity.all():
            # NOT IN with a NULL build key: NO probe row qualifies.  Keep
            # the fused program shape (incl. any aggregation over zero
            # joined rows): the join node becomes a constant-false filter.
            return self._run(ctx, D.drop_lookup(dag, keep=False), ())
        if len(keys) == 0:
            if not semi:
                return self._empty_build_result(ctx, bchunk)
            # empty build side: semi matches nothing; anti keeps every
            # probe row (NOT IN of an empty set is TRUE even for NULL
            # probe keys, so no null-aware filtering either)
            return self._run(ctx, D.drop_lookup(
                dag, keep=(self.join_kind == "anti")), ())
        n_uniq = len(np.unique(keys))
        if not semi and n_uniq != len(keys):
            # duplicate build keys: switch to the expanding multi-match
            # strategy on device (reference: NDV-driven join shape choice).
            # Initial capacity: per-device probe rows x average duplication,
            # grown by the dispatcher if the real output overflows.
            snap0 = self.table.snapshot()
            n_dev = len(ctx.client.devices)
            per_dev = -(-max(snap0.num_rows, 1) // n_dev)
            avg_dup = len(keys) / max(n_uniq, 1)
            from ..store.columnar import _pow2_at_least
            cap = _pow2_at_least(max(int(per_dev * avg_dup), 1024))
            dag = D.to_multimatch(dag, cap)
        order = np.argsort(keys, kind="stable")
        sorted_keys = keys[order]
        perm = np.arange(len(keys), dtype=np.int64)[order]
        card = _to_card(ctx)
        aux = [(card(sorted_keys), None), (card(perm), None)]
        if not semi:   # semi/anti never read build columns on device
            for c in bchunk.columns:
                data = c.data[rows_idx]
                valid = c.validity[rows_idx]
                aux.append((card(data),
                            None if valid.all() else card(valid)))
        build_s = _synced_since(ctx, t0)
        chunk = self._run(ctx, dag, (tuple(aux),))   # one aux group
        ctx.client.timings["build"] = build_s
        # build-side output columns keep their own dictionaries
        if not isinstance(self.dag, D.Aggregation):
            for j, c in enumerate(chunk.columns):
                if c.dtype.is_string and c.dictionary is None:
                    bj = j - self.n_probe
                    if 0 <= bj < len(bchunk.columns):
                        c.dictionary = bchunk.columns[bj].dictionary
        return chunk

    def _run(self, ctx, dag, aux) -> ResultChunk:
        """Dispatch the fused program and decode with output dicts."""
        snap = self.table.snapshot()
        if isinstance(dag, D.Aggregation):
            res = ctx.client.execute_agg(dag, snap, self.key_meta,
                                         aux_cols=aux)
            cols = res.key_columns + res.columns
        else:
            cols = ctx.client.execute_rows(dag, snap,
                                           tuple(self.out_dtypes),
                                           self.out_dicts, aux_cols=aux)
        for j, d in self.out_dicts.items():
            if j < len(cols) and cols[j].dictionary is None:
                cols[j].dictionary = d
        return ResultChunk(list(self.out_names), cols)

    def _build_keys(self, kcol: Column) -> tuple[np.ndarray, np.ndarray]:
        return self._keys_for(kcol, self.build_key_dict,
                              self.probe_key_dtype)

    def _keys_for(self, kcol: Column, key_dict,
                  probe_key_dtype) -> tuple[np.ndarray, np.ndarray]:
        """Build-side key column -> (int64 keys comparable with the probe
        key expr, validity)."""
        ok = kcol.validity.copy()
        if kcol.dtype.is_string:
            # remap build codes into the probe dictionary's code space
            if key_dict is None or kcol.dictionary is None:
                return kcol.data.astype(np.int64), ok
            mapping = np.fromiter(
                (key_dict.code_of(v) for v in kcol.dictionary.values),
                np.int64, count=len(kcol.dictionary)) \
                if len(kcol.dictionary) else np.zeros(1, np.int64)
            keys = mapping[np.clip(kcol.data, 0, len(mapping) - 1)]
            ok = ok & (keys >= 0)          # absent from probe dict: no match
            return keys, ok
        keys = kcol.data.astype(np.int64)
        pt = probe_key_dtype
        if pt is not None and (kcol.dtype.kind == K.DECIMAL
                               or pt.kind == K.DECIMAL):
            sb = kcol.dtype.scale if kcol.dtype.kind == K.DECIMAL else 0
            sp = pt.scale if pt.kind == K.DECIMAL else 0
            if sp > sb:
                keys = keys * 10 ** (sp - sb)
            elif sb > sp:
                q, r = np.divmod(keys, 10 ** (sb - sp))
                ok = ok & (r == 0)     # non-representable: can't match
                keys = q
        return keys, ok

    def _empty_build_result(self, ctx, bchunk) -> ResultChunk:
        # empty build side: inner join produces nothing; left join keeps all
        # probe rows with NULL build cols — both simplest via the fallback
        return _join_fallback(ctx, self.fallback)


@dataclass
class CopShuffleJoinExec(PhysOp):
    """Cross-device repartition (shuffle) hash join — both sides stay
    sharded on device; rows hash-partition over the mesh via all_to_all
    and each device joins its partition (parallel/shuffle.py).  The MPP
    HashPartition-exchange join analog
    (physicalop/physical_exchange_sender.go:109, executor/shuffle.go:86):
    chosen when the build side is too big to broadcast."""
    locality = "device"
    sharding = "all_to_all"
    spec: Any                      # D.ShuffleJoinSpec
    left_table: Any
    right_table: Any
    out_names: list = field(default_factory=list)
    out_dtypes: list = field(default_factory=list)
    key_meta: list = field(default_factory=list)
    out_dicts: dict = field(default_factory=dict)
    children: list = field(default_factory=list)
    device: str = field(default_factory=_cop_device)

    def describe(self):
        kind = "agg" if isinstance(self.spec.top, D.Aggregation) else "rows"
        return (f"CopShuffleJoin[{kind},{self.spec.kind}] "
                f"{self.left_table.name} x {self.right_table.name} "
                f"all_to_all -> {self.device}")

    def execute(self, ctx: ExecContext) -> ResultChunk:
        lsnap = self.left_table.snapshot()
        rsnap = self.right_table.snapshot()
        if isinstance(self.spec.top, D.Aggregation):
            res = ctx.client.execute_shuffle_agg(self.spec, lsnap, rsnap,
                                                 self.key_meta)
            cols = res.key_columns + res.columns
        else:
            cols = ctx.client.execute_shuffle_rows(
                self.spec, lsnap, rsnap, tuple(self.out_dtypes),
                self.out_dicts)
        for j, d in self.out_dicts.items():
            if j < len(cols) and cols[j].dictionary is None:
                cols[j].dictionary = d
        return ResultChunk(list(self.out_names), cols)


# --------------------------------------------------------------------- #
# host operators
# --------------------------------------------------------------------- #

def _chunk_dicts(chunk: ResultChunk) -> dict:
    return {i: c.dictionary for i, c in enumerate(chunk.columns)
            if c.dictionary is not None}


def _eval_to_column(e: Expr, chunk: ResultChunk) -> Column:
    n = chunk.num_rows
    # lower string predicates/functions onto the chunk's dictionaries so
    # host residue evaluates the same code-space ops as the device
    dicts = _chunk_dicts(chunk)
    e = lower_strings(e, dicts)
    v, m = eval_expr(np, e, chunk.col_pairs(), dicts)
    if getattr(e.dtype, "is_vector", False):
        v = np.asarray(v)
        if v.dtype != object:       # one constant vector: replicate
            single = v.astype(np.float32)
            v = np.empty(n, object)
            for i in range(n):
                v[i] = single
    else:
        v = np.broadcast_to(np.asarray(v), (n,)).copy() if np.ndim(v) == 0 \
            else np.asarray(v)
    if v.dtype == bool:
        v = v.astype(np.int64)
    if m is True:
        mv = np.ones(n, bool)
    elif m is False:
        mv = np.zeros(n, bool)
    else:
        mv = np.broadcast_to(np.asarray(m), (n,)).copy()
    dic = _expr_dict(e, chunk)
    if e.dtype.is_string and v.dtype.kind in ("U", "S", "O"):
        # string-literal-producing expression (e.g. CASE ... THEN 'x'):
        # dictionary-encode the result values host-side
        vals = [str(x) for x in v]
        d = StringDict(sorted({x for x, ok in zip(vals, mv) if ok}))
        codes = np.fromiter((d.code_of(x) if ok else 0
                             for x, ok in zip(vals, mv)), np.int32, count=n)
        return Column(e.dtype, codes, mv, d)
    return Column(e.dtype, v.astype(e.dtype.np_dtype()), mv, dic)


def _expr_dict(e: Expr, chunk: ResultChunk) -> Optional[StringDict]:
    """Propagate the dictionary for passthrough string columns and for
    derived dictionaries from string-function lowering."""
    if isinstance(e, ColumnRef) and e.dtype.is_string:
        return chunk.columns[e.index].dictionary
    return getattr(e, "_derived_dict", None)


@dataclass
class HostSelection(PhysOp):
    child: PhysOp
    conditions: list[Expr]

    def __post_init__(self):
        self.children = [self.child]
        self.out_names = self.child.out_names
        self.out_dtypes = self.child.out_dtypes

    def chunks(self, ctx, required_rows=None):
        def filt(chunk):
            idx = np.nonzero(_conds_mask(chunk, self.conditions))[0]
            if len(idx) or chunk.num_rows == 0:
                return ResultChunk(chunk.names,
                                   [c.take(idx) for c in chunk.columns])
            return None
        yield from _parallel_map_chunks(ctx, self.child.chunks(ctx), filt)


@dataclass
class HostProjection(PhysOp):
    child: PhysOp
    exprs: list[Expr]
    out_names: list[str] = field(default_factory=list)

    def __post_init__(self):
        self.children = [self.child]
        self.out_dtypes = [e.dtype for e in self.exprs]

    def chunks(self, ctx, required_rows=None):
        def project(chunk):
            cols = [_eval_to_column(e, chunk) for e in self.exprs]
            return ResultChunk(list(self.out_names), cols)
        yield from _parallel_map_chunks(
            ctx, self.child.chunks(ctx, required_rows), project)


@dataclass
class HostExpandExec(PhysOp):
    """Grouping-sets row replication (WITH ROLLUP) on the host path.

    Reference analog: the Expand executor at unistore/cophandler/mpp.go:638.
    Output: child columns ++ nullable rollup key columns ++ gid; level l
    keeps the first len(keys)-l keys."""
    child: PhysOp
    keys: list
    levels: int
    out_names: list = field(default_factory=list)
    out_dtypes: list = field(default_factory=list)

    def __post_init__(self):
        self.children = [self.child]

    def describe(self):
        return f"HostExpand levels={self.levels}"

    def chunks(self, ctx, required_rows=None):
        L = len(self.keys)
        LV = self.levels

        def expand(chunk):
            n = chunk.num_rows
            kcols = [_eval_to_column(k, chunk) for k in self.keys]
            lvl = np.repeat(np.arange(LV, dtype=np.int64), n)
            cols = [Column(c.dtype, np.tile(c.data, LV),
                           np.tile(c.validity, LV), c.dictionary)
                    for c in chunk.columns]
            for j, c in enumerate(kcols):
                keep = (lvl + j) < L
                cols.append(Column(c.dtype.with_nullable(True),
                                   np.tile(c.data, LV),
                                   np.tile(c.validity, LV) & keep,
                                   c.dictionary))
            cols.append(Column(dt.bigint(False), lvl,
                               np.ones(n * LV, bool), None))
            return ResultChunk(list(self.out_names), cols)
        yield from _parallel_map_chunks(ctx, self.child.chunks(ctx), expand)


@dataclass
class HostLimit(PhysOp):
    child: PhysOp
    limit: int
    offset: int = 0

    def __post_init__(self):
        self.children = [self.child]
        self.out_names = self.child.out_names
        self.out_dtypes = self.child.out_dtypes

    def chunks(self, ctx, required_rows=None):
        """Early-stop pull: stops drawing child chunks once offset+limit
        rows passed through (the required-rows protocol's payoff)."""
        need = self.offset + self.limit
        seen = 0
        for chunk in self.child.chunks(ctx, required_rows=need):
            lo = min(max(self.offset - seen, 0), chunk.num_rows)
            hi = min(max(need - seen, 0), chunk.num_rows)
            seen += chunk.num_rows
            if hi > lo:
                yield ResultChunk(chunk.names,
                                  [c.slice(lo, hi) for c in chunk.columns])
            if seen >= need:
                return


def _ci_ranks(c: Column) -> Optional[np.ndarray]:
    """Collation rank array for a ci string column, else None."""
    from ..utils.collate import is_binary, rank_table
    if (c.dtype.is_string and c.dictionary is not None
            and not is_binary(c.dtype.collation)):
        lut = rank_table(c.dictionary, c.dtype.collation).ranks
        return lut[np.clip(c.data, 0, len(lut) - 1)].astype(np.int64)
    return None


def _sort_keys_matrix(chunk: ResultChunk, keys) -> list[np.ndarray]:
    """Per key: (null_rank, value_rank) arrays for lexsort; MySQL NULLs
    sort first ASC / last DESC.  Ci-collated string columns sort by
    collation rank, not raw code."""
    out = []
    for e, desc in keys:
        if isinstance(e, ColumnRef) and e.index < len(chunk.columns):
            ci = _ci_ranks(chunk.columns[e.index])
            if ci is not None:
                rank = np.where(chunk.columns[e.index].validity, ci,
                                np.iinfo(np.int64).min)
                if desc:
                    rank = np.where(chunk.columns[e.index].validity, -ci,
                                    np.iinfo(np.int64).max)
                out.append(rank)
                continue
        v, m = eval_expr(np, e, chunk.col_pairs())
        v = np.broadcast_to(np.asarray(v), (chunk.num_rows,))
        if v.dtype == bool:
            v = v.astype(np.int64)
        if v.dtype == np.float64 or v.dtype == np.float32:
            rank = v.astype(np.float64)
            nullv = -np.inf
        elif v.dtype == object:
            # wide-decimal values: exact dense ranks via python-int sort
            # (values may exceed int64)
            uniq = {x: i for i, x in enumerate(sorted({int(x) for x in v}))}
            rank = np.array([uniq[int(x)] for x in v], dtype=np.int64)
            nullv = np.iinfo(np.int64).min
        else:
            rank = v.astype(np.int64)
            nullv = np.iinfo(np.int64).min
        if m is not True:
            m = np.broadcast_to(np.asarray(m), (chunk.num_rows,))
            rank = np.where(m, rank, nullv)
        if desc:
            rank = -rank if rank.dtype != np.float64 else -rank
            if m is not True:
                rank = np.where(m, rank, np.inf if rank.dtype == np.float64
                                else np.iinfo(np.int64).max)
        out.append(rank)
    return out


@dataclass
class HostSort(PhysOp):
    """Streaming external sort: buffers child chunks up to a quota-derived
    block size, spills each block as a SORTED RUN (rows + rank matrix),
    then streams the k-way merge (sortexec external sort analog).  When
    the whole input fits, it sorts in memory and streams slices."""
    child: PhysOp
    keys: list  # [(Expr, desc)]

    def __post_init__(self):
        self.children = [self.child]
        self.out_names = self.child.out_names
        self.out_dtypes = self.child.out_dtypes

    def _can_spill_streaming(self, first: ResultChunk) -> bool:
        # cross-run rank comparability: wide-decimal keys use per-block
        # dense ranks (object dtype) and cannot spill as streaming runs
        for e, _ in self.keys:
            if e.dtype.kind == K.DECIMAL and e.dtype.np_dtype() == object:
                return False
        # object-backed PAYLOAD columns (wide-decimal SUM outputs) cannot
        # be memory-mapped back by merge_sorted_runs either
        for c in first.columns:
            if c.data.dtype == object:
                return False
        return True

    def _dict_compatible(self, first: ResultChunk, ch: ResultChunk) -> bool:
        return all(a.dictionary is b.dictionary
                   for a, b in zip(first.columns, ch.columns)
                   if a.dtype.is_string)

    def chunks(self, ctx, required_rows=None):
        if not self.keys:
            yield from self.child.chunks(ctx, required_rows)
            return
        remaining = ctx.remaining_quota()
        # spill threshold: half the remaining statement quota (the other
        # half covers rank matrices + merge buffers), floor 1 MiB
        block_bytes = None
        if remaining is not None and ctx.spill_enabled:
            block_bytes = max(remaining // 2, 1 << 20)
        buf: list[ResultChunk] = []
        buf_bytes = 0
        runs = []
        d = None
        first = None
        try:
            it = self.child.chunks(ctx)
            for ch in it:
                if ch.num_rows == 0:
                    continue
                if first is None:
                    first = ch
                elif not self._dict_compatible(first, ch):
                    # per-chunk dictionaries: runs would not share a code
                    # space; fall back to materialize + unify
                    buf.append(ch)
                    buf.extend(c for c in it)
                    merged = concat_result_chunks(
                        ([self._runs_to_chunk(runs)] + buf)
                        if runs else buf, self.out_names, self.out_dtypes)
                    runs = []
                    yield from _slice_stream(self._sorted_full(ctx, merged))
                    return
                buf.append(ch)
                buf_bytes += ch.nbytes()
                if block_bytes is not None and buf_bytes >= block_bytes \
                        and self._can_spill_streaming(first):
                    if d is None:
                        from ..utils.rowcontainer import spill_dir
                        d = spill_dir()
                        ctx.spills += 1
                    runs.append(self._flush_run(d.name, len(runs), buf))
                    buf, buf_bytes = [], 0
            if not runs:
                chunk = concat_result_chunks(buf, self.out_names,
                                             self.out_dtypes)
                yield from _slice_stream(self._sorted_full(ctx, chunk))
                return
            if buf:
                runs.append(self._flush_run(d.name, len(runs), buf))
            from ..utils.rowcontainer import merge_sorted_runs
            for cols in merge_sorted_runs(runs, STREAM_ROWS):
                yield ResultChunk(list(self.out_names), cols)
        finally:
            if d is not None:
                d.cleanup()

    def _flush_run(self, tmpdir, tag, buf):
        from ..utils.rowcontainer import SortedRun
        chunk = concat_result_chunks(buf, self.out_names, self.out_dtypes)
        ranks = _sort_keys_matrix(chunk, self.keys)
        return SortedRun.write(tmpdir, f"run-{tag}", chunk.columns, ranks)

    def _runs_to_chunk(self, runs):
        from ..utils.rowcontainer import merge_sorted_runs
        pieces = [ResultChunk(list(self.out_names), cols)
                  for cols in merge_sorted_runs(runs, STREAM_ROWS)]
        return concat_result_chunks(pieces, self.out_names, self.out_dtypes)

    def _sorted_full(self, ctx, chunk: ResultChunk) -> ResultChunk:
        ranks = _sort_keys_matrix(chunk, self.keys)
        if not ranks:
            return chunk
        n = chunk.num_rows
        extra = sum(r.nbytes for r in ranks) + 8 * n
        remaining = ctx.remaining_quota()
        if (remaining is not None and extra > remaining
                and ctx.spill_enabled and n > 1):
            # external index sort over materialized input (wide-decimal /
            # per-chunk-dict inputs that could not spill streaming runs)
            from ..utils.rowcontainer import external_sort_index, spill_dir
            ctx.spills += 1
            with spill_dir() as sd:
                idx = external_sort_index(ranks, sd, max(n // 8, 1024))
        else:
            ctx.track(extra)
            idx = np.lexsort(tuple(reversed(ranks)))
            ctx.release(extra)
        return ResultChunk(chunk.names, [c.take(idx) for c in chunk.columns])


@dataclass
class HostTopN(PhysOp):
    """Streaming TopN: consumes child chunks keeping a bounded candidate
    buffer of at most max(4*(offset+limit), STREAM_ROWS) rows, pruned by
    a full lexsort of the buffer (executor TopNExec heap analog — the
    buffer IS the heap, vectorized)."""
    child: PhysOp
    keys: list
    limit: int
    offset: int = 0

    def __post_init__(self):
        self.children = [self.child]
        self.out_names = self.child.out_names
        self.out_dtypes = self.child.out_dtypes

    def chunks(self, ctx, required_rows=None):
        k = self.offset + self.limit
        if k == 0:
            return
        cap = max(4 * k, STREAM_ROWS)
        buf = None
        for ch in self.child.chunks(ctx):
            if ch.num_rows == 0:
                continue
            buf = ch if buf is None else concat_result_chunks(
                [buf, ch], self.out_names, self.out_dtypes)
            if buf.num_rows > cap:
                buf = self._top(buf, k)
        if buf is None:
            return
        buf = self._top(buf, k)       # final exact sort of survivors
        lo = min(self.offset, buf.num_rows)
        hi = min(k, buf.num_rows)
        if hi > lo:
            yield ResultChunk(buf.names,
                              [c.slice(lo, hi) for c in buf.columns])

    def _top(self, chunk: ResultChunk, k: int) -> ResultChunk:
        ranks = _sort_keys_matrix(chunk, self.keys)
        idx = np.lexsort(tuple(reversed(ranks)))[:k]
        return ResultChunk(chunk.names, [c.take(idx) for c in chunk.columns])


@dataclass
class HostHashJoin(PhysOp):
    """Host hash join (join/hash_join_v2.go analog, numpy build+probe).
    kinds: inner | left | right | cross | semi | anti (anti optionally
    null-aware for NOT IN semantics, the reference's null-aware anti
    join in executor/join/)."""
    kind: str
    left: PhysOp = None
    right: PhysOp = None
    eq_keys: list = field(default_factory=list)
    other_conds: list = field(default_factory=list)
    out_names: list = field(default_factory=list)
    out_dtypes: list = field(default_factory=list)
    null_aware: bool = False

    def __post_init__(self):
        self.children = [self.left, self.right]

    def describe(self):
        na = ",null-aware" if self.null_aware else ""
        return f"HostHashJoin[{self.kind}{na}] keys={len(self.eq_keys)}"

    def _na_filter(self, lc: ResultChunk) -> ResultChunk:
        """NOT IN probe-side: NULL probe keys never pass (non-empty set)."""
        keep = np.ones(lc.num_rows, bool)
        for lk, _ in self.eq_keys:
            keep &= lc.columns[lk].validity
        if keep.all():
            return lc
        idx = np.nonzero(keep)[0]
        return ResultChunk(lc.names, [c.take(idx) for c in lc.columns])

    def chunks(self, ctx, required_rows=None):
        """Build side materialized; probe side STREAMED chunk-at-a-time
        (the bounded-memory probe of hash_join_v2.go).  The partition-
        spill path engages only when the build side alone strains the
        quota (it must materialize the probe to co-partition it)."""
        rc = self.right.execute(ctx)
        na = self.null_aware and self.eq_keys and rc.num_rows
        if na:
            # NOT IN (non-empty set): one NULL build key empties the whole
            # result.  (An EMPTY build set is TRUE for every probe row,
            # NULLs included — skip both checks.)
            for _, rk in self.eq_keys:
                if not rc.columns[rk].validity.all():
                    return
        from ..utils.memory import nbytes_of
        rbytes = nbytes_of(rc.columns)
        remaining = ctx.remaining_quota()
        left_materializes = type(self.left).chunks is PhysOp.chunks
        if (self.eq_keys and rc.num_rows > 1 and remaining is not None
                and ctx.spill_enabled
                and (2 * rbytes > remaining or left_materializes)):
            # build side alone strains the quota, OR the probe child is a
            # materializing op (its full output exists regardless, so the
            # old combined lc+rc quota/spill discipline still applies)
            lc = concat_result_chunks(
                list(self.left.chunks(ctx)), self.left.out_names,
                self.left.out_dtypes)
            if na:
                lc = self._na_filter(lc)
            extra = nbytes_of(lc.columns) + rbytes
            if extra > remaining:
                yield self._execute_spilled(ctx, lc, rc)
                return
            ctx.track(extra)
            try:
                yield self._join(lc, rc)
                return
            finally:
                ctx.release(extra)
        ctx.track(rbytes)
        try:
            if self.kind == "right":
                yield from self._stream_right(ctx, rc, na)
                return
            def probe(lch):
                if na:
                    lch = self._na_filter(lch)
                cb = lch.nbytes()
                ctx.track(cb)     # probe chunks charge transiently
                try:
                    out = self._join(lch, rc)
                finally:
                    ctx.release(cb)
                return out if (out.num_rows or lch.num_rows == 0) else None
            yield from _parallel_map_chunks(ctx, self.left.chunks(ctx),
                                            probe)
        finally:
            ctx.release(rbytes)

    def _stream_right(self, ctx, rc: ResultChunk, na: bool):
        """Right join with a streamed left side: emit matched pairs per
        probe chunk while tracking build-row match bits; null-extend the
        unmatched build rows at end-of-stream."""
        matched = np.zeros(rc.num_rows, bool)
        last_lc = None
        for lch in self.left.chunks(ctx):
            if na:
                lch = self._na_filter(lch)
            last_lc = lch
            li, ri = self._match_pairs(lch, rc)
            if self.other_conds:
                cand = ResultChunk(lch.names + rc.names,
                                   [c.take(li) for c in lch.columns]
                                   + [c.take(ri) for c in rc.columns])
                keep = _conds_mask(cand, self.other_conds)
                li, ri = li[keep], ri[keep]
            matched[ri] = True
            if len(li):
                yield ResultChunk(lch.names + rc.names,
                                  [c.take(li) for c in lch.columns]
                                  + [c.take(ri) for c in rc.columns])
        miss = np.nonzero(~matched)[0]
        if len(miss):
            neg = np.full(len(miss), -1, np.int64)
            if last_lc is not None:
                lcols = [_take_nullable(c, neg) for c in last_lc.columns]
                lnames = last_lc.names
            else:
                lnames = list(self.left.out_names)
                lcols = [Column(t.with_nullable(True),
                                np.zeros(len(miss), t.np_dtype()),
                                np.zeros(len(miss), bool))
                         for t in self.left.out_dtypes]
            yield ResultChunk(lnames + rc.names,
                              lcols + [c.take(miss) for c in rc.columns])

    def _execute_spilled(self, ctx, lc, rc):
        """hash_join_spill.go analog: partition both sides by join-key
        hash to disk; equal keys meet in the same partition, so the join
        is the concatenation of P independent sub-joins."""
        from ..utils.rowcontainer import partition_to_disk, spill_dir
        ctx.spills += 1
        P = 8

        def part_of(keys):
            h = np.zeros(len(keys[0]), np.uint64)
            for k in keys:
                h = h * np.uint64(0x9E3779B97F4A7C15) + k.astype(np.uint64)
            return (h % np.uint64(P)).astype(np.int64)

        lkeys, rkeys = self._key_arrays(lc, rc)
        lpart, rpart = part_of(lkeys), part_of(rkeys)
        pieces = []
        with spill_dir() as d:
            lps = partition_to_disk(lc.columns, lpart, P, d, "jl")
            rps = partition_to_disk(rc.columns, rpart, P, d, "jr")
            for p in range(P):
                # inner joins skip one-sided partitions; outer joins must
                # keep the preserved side's unmatched rows
                if lps[p] is None and rps[p] is None:
                    continue
                if lps[p] is None and self.kind != "right":
                    continue
                # empty right partition: left/anti joins must still emit
                # the (unmatched) left rows
                if rps[p] is None and self.kind not in ("left", "anti"):
                    continue
                lcols = lps[p].read() if lps[p] is not None else \
                    [c.slice(0, 0) for c in lc.columns]
                rcols = rps[p].read() if rps[p] is not None else \
                    [c.slice(0, 0) for c in rc.columns]
                pieces.append(self._join(ResultChunk(lc.names, lcols),
                                         ResultChunk(rc.names, rcols)))
        if not pieces:
            return self._join(ResultChunk(lc.names,
                                          [c.slice(0, 0) for c in lc.columns]),
                              ResultChunk(rc.names,
                                          [c.slice(0, 0) for c in rc.columns]))
        out = [Column.concat([p.columns[i] for p in pieces])
               for i in range(len(pieces[0].columns))]
        return ResultChunk(pieces[0].names, out)

    def _join(self, lc, rc):
        nl, nr = lc.num_rows, rc.num_rows
        li, ri = self._match_pairs(lc, rc)
        if self.other_conds:
            # ON residual conditions filter the CANDIDATE pairs before
            # null-extension: an outer-join row whose pairs all fail the ON
            # clause is kept null-extended, not dropped (ON != WHERE).
            cand = ResultChunk(lc.names + rc.names,
                               [c.take(li) for c in lc.columns]
                               + [c.take(ri) for c in rc.columns])
            keep = _conds_mask(cand, self.other_conds)
            li, ri = li[keep], ri[keep]
        if self.kind in ("semi", "anti"):
            matched = np.zeros(nl, bool)
            matched[li] = True
            keep = matched if self.kind == "semi" else ~matched
            # (null-aware probe/build filtering happened in execute())
            idx = np.nonzero(keep)[0]
            return ResultChunk(lc.names, [c.take(idx) for c in lc.columns])
        # outer null-extension for probe rows with no surviving pair
        if self.kind == "left":
            matched = np.zeros(nl, bool)
            matched[li] = True
            miss = np.nonzero(~matched)[0]
            li = np.concatenate([li, miss])
            ri = np.concatenate([ri, np.full(len(miss), -1, np.int64)])
        elif self.kind == "right":
            matched = np.zeros(nr, bool)
            matched[ri] = True
            miss = np.nonzero(~matched)[0]
            li = np.concatenate([li, np.full(len(miss), -1, np.int64)])
            ri = np.concatenate([ri, miss])
        lcols = ([_take_nullable(c, li) for c in lc.columns]
                 if self.kind == "right" else [c.take(li) for c in lc.columns])
        rcols = ([_take_nullable(c, ri) for c in rc.columns]
                 if self.kind == "left" else [c.take(ri) for c in rc.columns])
        return ResultChunk(lc.names + rc.names, lcols + rcols)

    def _key_arrays(self, lc: ResultChunk, rc: ResultChunk):
        lkeys, rkeys = [], []
        for lk, rk in self.eq_keys:
            a, b = _join_key_arrays(lc.columns[lk], rc.columns[rk])
            lkeys.append(a)
            rkeys.append(b)
        return lkeys, rkeys

    def _packed_keys(self, lc: ResultChunk, rc: ResultChunk):
        lkeys, rkeys = self._key_arrays(lc, rc)
        return _pack_rows(lkeys), _pack_rows(rkeys)

    def _match_pairs(self, lc: ResultChunk, rc: ResultChunk):
        """All key-equal candidate pairs (no outer extension)."""
        nl, nr = lc.num_rows, rc.num_rows
        if not self.eq_keys:  # cartesian
            return (np.repeat(np.arange(nl), nr),
                    np.tile(np.arange(nr), nl))
        lpack, rpack = self._packed_keys(lc, rc)
        # build on right, probe left (numpy sort-merge on packed keys)
        order = np.argsort(rpack, kind="stable")
        rsorted = rpack[order]
        lo = np.searchsorted(rsorted, lpack, "left")
        hi = np.searchsorted(rsorted, lpack, "right")
        counts = hi - lo
        li = np.repeat(np.arange(nl), counts)
        ri = order[_ragged_ranges(lo, counts)]
        return li, ri


@dataclass
class HostMergeJoin(HostHashJoin):
    """Sort-merge join (join/merge_join.go analog): both sides sort by the
    join key, matches stream out in key order — chosen via the MERGE_JOIN
    hint (and valuable when a downstream ORDER BY rides the same key).
    Matching reuses the packed-key searchsorted core; the defining
    property delivered here is key-ordered output."""

    def describe(self):
        return f"HostMergeJoin[{self.kind}] keys={len(self.eq_keys)}"

    def chunks(self, ctx, required_rows=None):
        lc = concat_result_chunks(list(self.left.chunks(ctx)),
                                  self.left.out_names, self.left.out_dtypes)
        rc = concat_result_chunks(list(self.right.chunks(ctx)),
                                  self.right.out_names,
                                  self.right.out_dtypes)
        if self.null_aware and self.eq_keys and rc.num_rows:
            for _, rk in self.eq_keys:
                if not rc.columns[rk].validity.all():
                    return
            lc = self._na_filter(lc)
        from ..utils.memory import nbytes_of
        extra = nbytes_of(lc.columns) + nbytes_of(rc.columns)
        remaining = ctx.remaining_quota()
        if (remaining is not None and extra > remaining
                and ctx.spill_enabled and self.eq_keys
                and min(lc.num_rows, rc.num_rows) > 1):
            # over quota: fall back to the partition-spill hash join
            # (bounded memory beats preserving merge order)
            yield self._execute_spilled(ctx, lc, rc)
            return
        ctx.track(extra)
        try:
            if self.eq_keys and lc.num_rows:
                lkeys, rkeys = self._key_arrays(lc, rc)
                lorder = np.argsort(_pack_rows(lkeys), kind="stable")
                lc = ResultChunk(lc.names,
                                 [c.take(lorder) for c in lc.columns])
                if rc.num_rows:
                    rorder = np.argsort(_pack_rows(rkeys), kind="stable")
                    rc = ResultChunk(rc.names,
                                     [c.take(rorder) for c in rc.columns])
            yield from _slice_stream(self._join(lc, rc))
        finally:
            ctx.release(extra)


@dataclass
class HostIndexLookupJoin(HostHashJoin):
    """Index nested-loop join (join/index_lookup_join.go analog): streams
    the outer side and, per chunk, fetches ONLY the matching inner rows
    through the inner table's index — no inner-side scan.  Chosen via the
    INL_JOIN hint when the inner side is an indexed bare table."""
    inner_table: Any = None        # catalog.TableInfo
    inner_index: Any = None        # IndexInfo whose first column is the key
    inner_offsets: list = field(default_factory=list)
    inner_conds: list = field(default_factory=list)   # residual filters
    inner_names: list = field(default_factory=list)
    inner_dtypes: list = field(default_factory=list)
    out_perm: list = None          # column permutation (swapped sides)

    def describe(self):
        return (f"HostIndexLookupJoin[{self.kind}] inner="
                f"{self.inner_table.name} index={self.inner_index.name}")

    def chunks(self, ctx, required_rows=None):
        # one read ts for the WHOLE statement (shared with every other KV
        # reader in the tree): per-chunk ts would let a concurrent commit
        # land between outer chunks and make the inner lookups
        # non-repeatable within one statement
        ts = ctx.kv_read_ts(self.inner_table.kv)
        for och in self.left.chunks(ctx):
            if self.null_aware:
                och = self._na_filter(och)
            rc = self._fetch_inner(och, ts)
            out = self._join(och, rc)
            if self.out_perm is not None:
                out = ResultChunk(list(self.out_names),
                                  [out.columns[j] for j in self.out_perm])
            if out.num_rows or och.num_rows == 0:
                yield out

    def _fetch_inner(self, och: ResultChunk, ts: int) -> ResultChunk:
        """Distinct outer keys -> index range reads -> inner ResultChunk."""
        from ..store.codec import (decode_index_handle, decode_row,
                                   encode_index_value, index_key,
                                   record_key)
        lk = self.eq_keys[0][0]
        kcol = och.columns[lk]
        keys = set()
        vals = kcol.to_python()
        for v, ok in zip(vals, kcol.validity):
            if ok:
                keys.add(v)
        tbl = self.inner_table
        kt = tbl.col_types[tbl.col_names.index(self.inner_index.columns[0])]
        rows = []
        for v in sorted(keys, key=lambda x: (str(type(x)), str(x))):
            try:
                part = encode_index_value(v, kt)
            except (ValueError, TypeError):
                continue
            prefix = index_key(tbl.table_id, self.inner_index.index_id,
                               part)
            end = prefix + b"\xff"
            for k, val in tbl.kv.scan(prefix, end, ts):
                h = decode_index_handle(k, val)
                data = tbl.kv.get(record_key(tbl.table_id, h), ts)
                if data is not None:
                    rows.append(decode_row(data, tbl.col_types))
        cols = []
        for out_i, off in enumerate(self.inner_offsets):
            t = self.inner_dtypes[out_i]
            cols.append(Column.from_values(
                t.with_nullable(True), [r[off] for r in rows]))
        rc = ResultChunk(list(self.inner_names), cols)
        if self.inner_conds:
            keep = np.nonzero(_conds_mask(rc, self.inner_conds))[0]
            rc = ResultChunk(rc.names, [c.take(keep) for c in rc.columns])
        return rc


def _join_key_arrays(a: Column, b: Column):
    """Key columns as comparable int64 arrays; cross-dictionary strings are
    remapped into a merged code space; NULL keys get a sentinel that never
    matches (inner-join semantics for NULL = NULL)."""
    av, bv = a.data.astype(np.int64, copy=True), b.data.astype(np.int64, copy=True)
    if a.dtype.is_string and b.dtype.is_string:
        from ..utils.collate import is_binary, merged_rank_maps
        coll = next((t.collation for t in (a.dtype, b.dtype)
                     if not is_binary(t.collation)), "binary")
        if a.dictionary is not b.dictionary or coll != "binary":
            # None dictionaries arise from empty streamed results
            from ..chunk.column import StringDict
            da = a.dictionary if a.dictionary is not None else StringDict()
            db = b.dictionary if b.dictionary is not None else StringDict()
            am, bm = merged_rank_maps(da, db, coll)
            av = am[np.clip(a.data, 0, max(len(am) - 1, 0))].astype(np.int64)
            bv = bm[np.clip(b.data, 0, max(len(bm) - 1, 0))].astype(np.int64)
    if a.dtype.kind == K.DECIMAL or b.dtype.kind == K.DECIMAL:
        sa = a.dtype.scale if a.dtype.kind == K.DECIMAL else 0
        sb = b.dtype.scale if b.dtype.kind == K.DECIMAL else 0
        s = max(sa, sb)
        av *= 10 ** (s - sa)
        bv *= 10 ** (s - sb)
    if a.dtype.is_float or b.dtype.is_float:
        raise NotImplementedError("float join keys")
    av = np.where(a.validity, av, np.iinfo(np.int64).min)
    bv = np.where(b.validity, bv, np.iinfo(np.int64).min + 1)
    return av, bv


def _pack_rows(keys: list[np.ndarray]) -> np.ndarray:
    if len(keys) == 1:
        return keys[0]
    # stable structured pack via void view
    m = np.stack(keys, axis=1)
    return np.ascontiguousarray(m).view([("", np.int64)] * m.shape[1]).reshape(-1)


def _ragged_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate [starts[i], ..., starts[i]+counts[i]-1] for all i."""
    total = int(counts.sum())
    if total == 0:
        return np.array([], np.int64)
    rep_starts = np.repeat(starts, counts)
    begins = np.cumsum(counts) - counts
    offsets = np.arange(total) - np.repeat(begins, counts)
    return rep_starts + offsets


def _take_nullable(c: Column, idx: np.ndarray) -> Column:
    """take() that maps index -1 to NULL (outer-join padding)."""
    if len(c) == 0:
        return Column(c.dtype.with_nullable(True),
                      np.zeros(len(idx), c.data.dtype),
                      np.zeros(len(idx), bool), c.dictionary)
    safe = np.where(idx >= 0, idx, 0)
    out = c.take(safe)
    out.validity = np.where(idx >= 0, out.validity, False)
    out.dtype = out.dtype.with_nullable(True)
    return out


def _conds_mask(chunk: ResultChunk, conds, dicts=None) -> np.ndarray:
    """AND of conditions over a chunk (NULL = false) — the one shared
    filter-semantics implementation.  `dicts` lowers string consts onto
    the chunk's dictionaries first."""
    pairs = chunk.col_pairs()
    keep = np.ones(chunk.num_rows, bool)
    if dicts is None:
        dicts = _chunk_dicts(chunk)
    for c in conds:
        c = lower_strings(c, dicts)
        v, m = eval_expr(np, c, pairs, dicts)
        v = np.broadcast_to(np.asarray(v), (chunk.num_rows,))
        if v.dtype != bool:
            v = v != 0
        if m is not True:
            v = v & np.broadcast_to(np.asarray(m), (chunk.num_rows,))
        keep &= v
    return keep


@dataclass
class HostAgg(PhysOp):
    """Generic host aggregation (root HashAgg analog) for group keys the
    dense device path can't bound; uses np.unique group ids."""
    child: PhysOp
    group_exprs: list
    aggs: list  # AggItem
    out_names: list = field(default_factory=list)
    out_dtypes: list = field(default_factory=list)

    def __post_init__(self):
        self.children = [self.child]

    # -- streaming partial/final split (agg_hash_executor.go partial and
    # -- final worker roles, collapsed into one chunk loop) ------------- #

    _STREAMABLE = (D.AggFunc.COUNT, D.AggFunc.SUM, D.AggFunc.MIN,
                   D.AggFunc.MAX, D.AggFunc.BIT_AND, D.AggFunc.BIT_OR,
                   D.AggFunc.BIT_XOR)

    def _must_materialize(self, a) -> bool:
        if a.distinct or a.func not in self._STREAMABLE:
            return True
        if a.func in (D.AggFunc.MIN, D.AggFunc.MAX) \
                and a.arg is not None and a.arg.dtype.is_string:
            from ..utils.collate import is_binary
            return not is_binary(a.arg.dtype.collation)  # rank != code order
        return False

    def chunks(self, ctx, required_rows=None):
        if any(self._must_materialize(a)
               for a in self.aggs):
            # DISTINCT partial states are value SETS (and GROUP_CONCAT /
            # ANY_VALUE carry row order), not fixed-width mergeable rows:
            # materialize (the hash-partition spill path bounds memory)
            yield from _slice_stream(self._execute_full(ctx))
            return
        acc = None
        pending: list[ResultChunk] = []
        pending_rows = 0
        pnames = self._partial_names()
        for ch in self.child.chunks(ctx):
            if ch.num_rows == 0 and self.group_exprs:
                continue
            part = self._partial_chunk(ch)
            pending.append(part)
            pending_rows += part.num_rows
            if pending_rows >= STREAM_ROWS:
                acc = self._reduce_partials(concat_result_chunks(
                    ([acc] if acc is not None else []) + pending,
                    pnames))
                pending, pending_rows = [], 0
        if pending or acc is None:
            if not pending and acc is None:
                # zero input chunks: scalar agg still emits its one row
                empty = ResultChunk(
                    list(self.child.out_names),
                    [_empty_column(t) for t in self.child.out_dtypes])
                pending = [self._partial_chunk(empty)]
            acc = self._reduce_partials(concat_result_chunks(
                ([acc] if acc is not None else []) + pending, pnames))
        yield from _slice_stream(self._finalize_partials(acc))

    def _partial_names(self):
        names = [f"g{i}" for i in range(len(self.group_exprs))]
        for i, a in enumerate(self.aggs):
            for tag in self._pspec(a):
                names.append(f"a{i}_{tag}")
        return names

    def _pspec(self, a) -> tuple:
        """Partial-state slots per agg (SURVEY §A.4 partial-state layout):
        merge kind per slot drives _reduce_partials."""
        if a.func == D.AggFunc.COUNT:
            return ("cnt",)
        if a.func == D.AggFunc.SUM:
            isf = a.arg.dtype.kind in (K.FLOAT64, K.FLOAT32)
            return ("sumf" if isf else "sumo", "cnt")
        if a.func == D.AggFunc.MIN:
            return ("min", "cnt")
        if a.func == D.AggFunc.MAX:
            return ("max", "cnt")
        if a.func == D.AggFunc.BIT_AND:
            return ("band",)
        if a.func == D.AggFunc.BIT_OR:
            return ("bor",)
        if a.func == D.AggFunc.BIT_XOR:
            return ("bxor",)
        raise NotImplementedError(a.func)

    def _partial_chunk(self, ch: ResultChunk) -> ResultChunk:
        """Group-reduce one input chunk to partial-state rows."""
        n = ch.num_rows
        gcols = [_eval_to_column(g, ch) for g in self.group_exprs]
        if gcols:
            uniq_g, inverse, first = _group_ids(gcols, n)
            g = uniq_g
            key_cols = [c.take(first) for c in gcols]
        else:
            g = 1
            inverse = np.zeros(n, np.int64)
            key_cols = []
        pcols: list[Column] = []
        for a in self.aggs:
            if a.arg is None:
                cnt = np.bincount(inverse, minlength=g).astype(np.int64)
                pcols.append(Column(dt.bigint(False), cnt, np.ones(g, bool)))
                continue
            c = _eval_to_column(a.arg, ch)
            valid = c.validity
            cnt = np.bincount(inverse[valid], minlength=g).astype(np.int64)
            cnt_col = Column(dt.bigint(False), cnt, np.ones(g, bool))
            if a.func == D.AggFunc.COUNT:
                pcols.append(cnt_col)
            elif a.func == D.AggFunc.SUM:
                if a.arg.dtype.kind in (K.FLOAT64, K.FLOAT32):
                    out = np.zeros(g, np.float64)
                    np.add.at(out, inverse[valid],
                              c.data[valid].astype(np.float64))
                    pcols.append(Column(a.out_dtype, out, cnt > 0))
                else:
                    out = np.zeros(g, object)
                    np.add.at(out, inverse[valid],
                              c.data[valid].astype(object))
                    pcols.append(Column(a.out_dtype, out, cnt > 0))
                pcols.append(cnt_col)
            elif a.func in (D.AggFunc.MIN, D.AggFunc.MAX):
                isf = a.arg.dtype.is_float
                iso = c.data.dtype == np.dtype(object)
                init = self._mm_init(a, isf or iso)
                # partials accumulate in WIDE (int64/float64/object) space:
                # the ±extreme init values do not fit narrow code dtypes
                # (int32 string/date codes would wrap to -1); wide decimals
                # keep python ints with ±inf float sentinels
                out = np.full(g, init,
                              object if iso else
                              (np.float64 if isf else np.int64))
                op = np.minimum if a.func == D.AggFunc.MIN else np.maximum
                vals = c.data[valid] if iso \
                    else c.data[valid].astype(out.dtype)
                op.at(out, inverse[valid], vals)
                # invalid rows keep the ±inf init so merges stay neutral
                pcols.append(Column(c.dtype, out, cnt > 0, c.dictionary))
                pcols.append(cnt_col)
            elif a.func in (D.AggFunc.BIT_AND, D.AggFunc.BIT_OR,
                            D.AggFunc.BIT_XOR):
                pcols.append(_bit_agg(a.func, a.out_dtype, g,
                                      inverse[valid], c.data[valid]))
            else:
                raise NotImplementedError(a.func)
        return ResultChunk(self._partial_names(), key_cols + pcols)

    @staticmethod
    def _mm_init(a, isf):
        lo = -np.inf if isf else np.iinfo(np.int64).min
        hi = np.inf if isf else np.iinfo(np.int64).max
        return hi if a.func == D.AggFunc.MIN else lo

    def _reduce_partials(self, chunk: ResultChunk) -> ResultChunk:
        """Merge partial-state rows that share a group key."""
        nk = len(self.group_exprs)
        key_cols = chunk.columns[:nk]
        pcols = chunk.columns[nk:]
        n = chunk.num_rows
        if nk:
            g, inverse, first = _group_ids(key_cols, n)
            out_keys = [c.take(first) for c in key_cols]
        else:
            g, inverse, out_keys = 1, np.zeros(n, np.int64), []
        out_p: list[Column] = []
        i = 0
        for a in self.aggs:
            for tag in self._pspec(a):
                c = pcols[i]
                i += 1
                if tag == "cnt":
                    out = np.zeros(g, np.int64)
                    np.add.at(out, inverse, c.data.astype(np.int64))
                    out_p.append(Column(c.dtype, out, np.ones(g, bool)))
                elif tag == "sumf":
                    out = np.zeros(g, np.float64)
                    np.add.at(out, inverse, np.asarray(c.data, np.float64))
                    out_p.append(Column(c.dtype, out, np.ones(g, bool)))
                elif tag == "sumo":
                    out = np.zeros(g, object)
                    np.add.at(out, inverse, c.data.astype(object))
                    out_p.append(Column(c.dtype, out, np.ones(g, bool)))
                elif tag in ("band", "bor", "bxor"):
                    out_p.append(_bit_agg(a.func, c.dtype, g, inverse,
                                          c.data))
                else:   # min / max
                    isf = c.data.dtype.kind == "f"
                    init = self._mm_init(a, isf
                                         or c.data.dtype.kind == "O")
                    out = np.full(g, init, c.data.dtype)
                    op = (np.minimum if a.func == D.AggFunc.MIN
                          else np.maximum)
                    # cnt==0 rows carry the ±extreme sentinel, but dict
                    # unification (_unify_string_columns) clips codes into
                    # the merged dictionary's range — restore the neutral
                    # from validity before merging
                    data = np.where(c.validity, c.data, init)
                    op.at(out, inverse, data)
                    # acc is itself re-concatenated with later partials, so
                    # its validity must mark sentinel rows too
                    vout = np.zeros(g, bool)
                    np.logical_or.at(vout, inverse, c.validity)
                    out_p.append(Column(c.dtype, out, vout, c.dictionary))
        return ResultChunk(chunk.names, out_keys + out_p)

    def _finalize_partials(self, acc: ResultChunk) -> ResultChunk:
        nk = len(self.group_exprs)
        key_cols = acc.columns[:nk]
        pcols = acc.columns[nk:]
        g = acc.num_rows
        out_cols: list[Column] = []
        i = 0
        for a in self.aggs:
            spec = self._pspec(a)
            if a.func == D.AggFunc.COUNT:
                cnt = pcols[i].data.astype(np.int64)
                out_cols.append(Column(a.out_dtype, cnt, np.ones(g, bool)))
            elif a.func == D.AggFunc.SUM:
                s, cnt = pcols[i], pcols[i + 1].data
                if spec[0] == "sumf":
                    out_cols.append(Column(
                        a.out_dtype,
                        np.where(cnt > 0, np.asarray(s.data, np.float64),
                                 0.0),
                        cnt > 0))
                else:
                    out_cols.append(_sum_col(a, s.data, cnt))
            elif a.func in (D.AggFunc.BIT_AND, D.AggFunc.BIT_OR,
                            D.AggFunc.BIT_XOR):
                out_cols.append(Column(a.out_dtype,
                                       pcols[i].data.astype(np.uint64),
                                       np.ones(g, bool)))
            else:   # MIN / MAX
                v, cnt = pcols[i], pcols[i + 1].data
                data = np.where(cnt > 0, v.data, 0)
                out_cols.append(Column(
                    a.out_dtype, data.astype(a.out_dtype.np_dtype()),
                    cnt > 0, v.dictionary))
            i += len(spec)
        return ResultChunk(list(self.out_names), key_cols + out_cols)

    # -- materializing path (DISTINCT aggs) ---------------------------- #

    def _execute_full(self, ctx):
        chunk = self.child.execute(ctx)
        n = chunk.num_rows
        if self.group_exprs and n > 1:
            remaining = ctx.remaining_quota()
            # group-by working set ~ packed keys + inverse + outputs
            extra = n * 8 * (2 * len(self.group_exprs) + 2)
            if (remaining is not None and extra > remaining
                    and ctx.spill_enabled):
                return self._execute_spilled(ctx, chunk)
            ctx.track(extra)
            try:
                return self._agg_chunk(chunk)
            finally:
                ctx.release(extra)
        return self._agg_chunk(chunk)

    def _execute_spilled(self, ctx, chunk):
        """agg_spill.go analog: hash-partition rows by group key to disk,
        aggregate each partition independently, concatenate results —
        peak memory = 1/P of the input's group working set."""
        from ..utils.rowcontainer import partition_to_disk, spill_dir
        ctx.spills += 1
        P = 8
        gcols = [_eval_to_column(g, chunk) for g in self.group_exprs]
        h = np.zeros(chunk.num_rows, np.uint64)
        for c in gcols:
            v = np.where(c.validity, c.data.astype(np.int64),
                         np.iinfo(np.int64).min).astype(np.uint64)
            h = h * np.uint64(0x9E3779B97F4A7C15) + v
        part_of = (h % np.uint64(P)).astype(np.int64)
        pieces = []
        with spill_dir() as d:
            parts = partition_to_disk(chunk.columns, part_of, P, d, "agg")
            for sp in parts:
                if sp is None:
                    continue
                sub = ResultChunk(chunk.names, sp.read())
                sp.delete()
                pieces.append(self._agg_chunk(sub))
        if not pieces:
            return self._agg_chunk(chunk)     # all-empty: fall through
        out_cols = [Column.concat([p.columns[i] for p in pieces])
                    for i in range(len(pieces[0].columns))]
        return ResultChunk(list(self.out_names), out_cols)

    def _agg_chunk(self, chunk):
        n = chunk.num_rows
        gcols = [_eval_to_column(g, chunk) for g in self.group_exprs]
        if gcols:
            g, inverse, first = _group_ids(gcols, n)
            key_cols = [c.take(first) for c in gcols]
        else:
            g = 1
            inverse = np.zeros(n, np.int64)
            key_cols = []
            if n == 0:
                # SQL: aggregate over empty input with no GROUP BY = 1 row
                pass
        agg_cols = [self._agg_one(a, chunk, inverse, g, n) for a in self.aggs]
        return ResultChunk(list(self.out_names), key_cols + agg_cols)

    def _agg_one(self, a: AggItem, chunk, inverse, g, n) -> Column:
        if a.arg is None:   # COUNT(*)
            cnt = np.bincount(inverse, minlength=g).astype(np.int64)
            return Column(a.out_dtype, cnt, np.ones(g, bool))
        c = _eval_to_column(a.arg, chunk)
        valid = c.validity
        if a.distinct and a.func != D.AggFunc.GROUP_CONCAT:
            vals64 = c.data[valid].astype(np.int64)
            ci = _ci_ranks(c) if n else None
            if ci is not None:
                vals64 = ci[valid]      # ci: case variants are one value
            pack = np.stack([inverse[valid], vals64],
                            axis=1)
            uniq = np.unique(pack, axis=0)
            if a.func == D.AggFunc.COUNT:
                cnt = np.bincount(uniq[:, 0], minlength=g).astype(np.int64)
                return Column(a.out_dtype, cnt, np.ones(g, bool))
            if a.func == D.AggFunc.SUM:
                out = np.zeros(g, dtype=object)
                np.add.at(out, uniq[:, 0], uniq[:, 1].astype(object))
                cnt = np.bincount(uniq[:, 0], minlength=g)
                return _sum_col(a, out, cnt)
            raise NotImplementedError("DISTINCT " + a.func.value)
        if a.func == D.AggFunc.COUNT:
            cnt = np.bincount(inverse[valid], minlength=g).astype(np.int64)
            return Column(a.out_dtype, cnt, np.ones(g, bool))
        cnt = np.bincount(inverse[valid], minlength=g)
        if a.func == D.AggFunc.SUM:
            if a.arg.dtype.kind in (K.FLOAT64, K.FLOAT32):
                out = np.zeros(g, np.float64)
                np.add.at(out, inverse[valid], c.data[valid].astype(np.float64))
                return Column(a.out_dtype, np.where(cnt > 0, out, 0.0),
                              cnt > 0)
            out = np.zeros(g, dtype=object)
            np.add.at(out, inverse[valid], c.data[valid].astype(object))
            return _sum_col(a, out, cnt)
        if a.func in (D.AggFunc.MIN, D.AggFunc.MAX):
            ci = _ci_ranks(c) if n else None
            if ci is not None:
                # ci collation: extremum by RANK, output the original value
                # (argmin via rank*n+row packing)
                m = max(n, 1)
                r = ci if a.func == D.AggFunc.MIN else (ci.max() - ci)
                key = r * m + np.arange(n, dtype=np.int64)
                best = np.full(g, np.iinfo(np.int64).max, np.int64)
                np.minimum.at(best, inverse[valid], key[valid])
                rows = np.where(cnt > 0, best % m, 0)
                col = c.take(rows)
                col.validity = cnt > 0
                col.dtype = a.out_dtype
                return col
            isf = a.arg.dtype.is_float
            ninf = -np.inf if isf else np.iinfo(np.int64).min
            pinf = np.inf if isf else np.iinfo(np.int64).max
            init = pinf if a.func == D.AggFunc.MIN else ninf
            out = np.full(g, init, np.float64 if isf else np.int64)
            op = np.minimum if a.func == D.AggFunc.MIN else np.maximum
            op.at(out, inverse[valid], c.data[valid].astype(out.dtype))
            col = Column(a.out_dtype,
                         np.where(cnt > 0, out, 0).astype(a.out_dtype.np_dtype()),
                         cnt > 0, c.dictionary)
            return col
        if a.func in (D.AggFunc.BIT_AND, D.AggFunc.BIT_OR,
                      D.AggFunc.BIT_XOR):
            return _bit_agg(a.func, a.out_dtype, g, inverse[valid],
                            c.data[valid])
        if a.func == D.AggFunc.ANY_VALUE:
            # first non-NULL value per group; NULL when the group has none
            if n == 0:
                return Column(a.out_dtype, np.zeros(g, c.data.dtype),
                              np.zeros(g, bool), c.dictionary)
            has = np.zeros(g, bool)
            has[inverse[valid]] = True
            first_valid = np.full(g, n, np.int64)
            np.minimum.at(first_valid, inverse[valid],
                          np.arange(n)[valid])
            out = c.take(np.where(has, first_valid, 0))
            out.validity = has
            out.dtype = a.out_dtype
            return out
        if a.func == D.AggFunc.GROUP_CONCAT:
            # MySQL semantics: comma separator, NULLs skipped, NULL result
            # for all-NULL groups; DISTINCT dedupes keeping first occurrence
            vals = c.to_python()
            from ..utils.collate import is_binary, sortkey
            coll = c.dtype.collation if c.dtype.is_string else "binary"
            parts: list[list[str]] = [[] for _ in range(g)]
            seen: list[set] = [set() for _ in range(g)] if a.distinct else []
            for row in range(n):
                if not valid[row]:
                    continue
                sv = _gc_str(vals[row])
                gi = int(inverse[row])
                if a.distinct:
                    key = sv if is_binary(coll) else sortkey(sv, coll)
                    if key in seen[gi]:
                        continue
                    seen[gi].add(key)
                parts[gi].append(sv)
            strs = [",".join(p) if p else None for p in parts]
            return Column.from_values(a.out_dtype, strs)
        if a.func == D.AggFunc.JSON_ARRAYAGG:
            # MySQL: one JSON array per group, NULL column values kept as
            # JSON null, NULL result only for an empty group
            import json as _json
            vals = c.to_python()
            items: list[list] = [[] for _ in range(g)]
            seenrow = np.zeros(g, bool)
            for row in range(n):
                gi = int(inverse[row])
                seenrow[gi] = True
                if not valid[row]:
                    items[gi].append(None)
                    continue
                v = vals[row]
                if not isinstance(v, (int, float, bool, str)):
                    v = str(v)      # dates/decimals render as strings
                items[gi].append(v)
            strs = [(_json.dumps(it, separators=(", ", ": "),
                                 ensure_ascii=False, default=str)
                     if seenrow[gi] else None)
                    for gi, it in enumerate(items)]
            return Column.from_values(a.out_dtype, strs)
        raise NotImplementedError(a.func)


def _gc_str(v) -> str:
    """GROUP_CONCAT value rendering (ints/decimals/strings/dates)."""
    return str(v)


def _bit_agg(func, out_dtype, g: int, inverse: np.ndarray,
             data: np.ndarray) -> Column:
    """BIT_AND/OR/XOR partial over uint64 bit patterns (aggfuncs
    bit_and.go family); neutral inits make partials directly mergeable."""
    op, neutral = {
        D.AggFunc.BIT_AND: (np.bitwise_and, np.uint64(0xFFFFFFFFFFFFFFFF)),
        D.AggFunc.BIT_OR: (np.bitwise_or, np.uint64(0)),
        D.AggFunc.BIT_XOR: (np.bitwise_xor, np.uint64(0)),
    }[func]
    out = np.full(g, neutral, np.uint64)
    op.at(out, inverse, data.astype(np.int64).astype(np.uint64))
    return Column(out_dtype, out, np.ones(g, bool))


def _group_ids(gcols: list[Column], n: int):
    """(num_groups, inverse, first-row-index) for a set of key columns:
    NULL-distinct packed int64 grouping (HashAgg's group-key encoding)."""
    mats = []
    for c in gcols:
        ci = _ci_ranks(c)
        if ci is not None:
            key = ci                 # ci collation: group by rank
        elif c.data.dtype.kind == "f":
            # exact float grouping: bit pattern, with -0.0 folded into 0.0
            d = np.asarray(c.data, np.float64)
            key = np.where(d == 0.0, 0.0, d).view(np.int64)
        else:
            key = c.data.astype(np.int64)
        mats.append(np.where(c.validity, key, np.iinfo(np.int64).min))
        mats.append((~c.validity).astype(np.int64))
    packed = np.stack(mats, axis=1)
    uniq, inverse = np.unique(packed, axis=0, return_inverse=True)
    g = len(uniq)
    first = np.full(g, max(n - 1, 0), np.int64)
    np.minimum.at(first, inverse, np.arange(n))
    return g, inverse, first


def _sum_col(a: AggItem, out_obj: np.ndarray, cnt: np.ndarray) -> Column:
    wide = a.out_dtype.np_dtype() == object
    vals = np.array([int(x) for x in out_obj],
                    dtype=object if wide else np.int64)
    return Column(a.out_dtype, vals, cnt > 0)


@dataclass
class HostApplyExec(PhysOp):
    """Correlated scalar subqueries (LogicalApply executor; the P8
    parallel-apply seam).  For each DISTINCT combination of the outer
    values a subquery references, the subquery is planned with those
    values bound as constants and executed once — the apply cache
    (join/apply_cache.go analog) collapses duplicate outer rows."""
    child: PhysOp
    subqueries: list        # [(sub_ast, out_dtype, name)]
    catalog: Any = None
    default_db: str = ""
    outer_quals: list = field(default_factory=list)  # [(name, qualifier)]
    out_names: list = field(default_factory=list)
    out_dtypes: list = field(default_factory=list)

    def __post_init__(self):
        self.children = [self.child]

    def describe(self):
        return f"HostApply[{len(self.subqueries)} subqueries] (cached)"

    def chunks(self, ctx, required_rows=None):
        # cache/used-cols live for the WHOLE scan (per subquery), so
        # duplicate outer values across chunks evaluate once; this
        # operator is row-preserving, so required_rows forwards
        states = [{"cache": {}, "used": []} for _ in self.subqueries]
        for chunk in self.child.chunks(ctx, required_rows):
            cols = list(chunk.columns)
            for (sub_ast, out_t, _name), st in zip(self.subqueries,
                                                   states):
                cols.append(self._apply_one(ctx, chunk, sub_ast, out_t,
                                            st))
            yield ResultChunk(list(self.out_names), cols)

    def _apply_one(self, ctx, chunk: ResultChunk, sub_ast,
                   out_t, state: dict) -> Column:
        from ..planner.build import (OUTER_RESOLVER, PlanError,
                                     build_query)
        from ..planner.optimize import optimize_plan
        from ..sql import ast as A
        n = chunk.num_rows
        # decoded outer values per row, resolved lazily by name
        decoded: dict[int, list] = {}

        def col_values(i):
            if i not in decoded:
                decoded[i] = chunk.columns[i].to_python()
            return decoded[i]

        quals = self.outer_quals or [(nm.lower(), "")
                                     for nm in chunk.names]

        def find_outer(ident) -> Optional[int]:
            """Qualifier-aware outer resolution (no silent misbinding):
            a qualified miss returns None (-> unknown column error from
            the subquery build); bare ambiguity raises."""
            from ..planner.build import PlanError
            if len(ident.parts) >= 2:
                q, name = ident.parts[-2].lower(), ident.parts[-1].lower()
                hits = [i for i, (nm, qu) in enumerate(quals)
                        if nm == name and qu == q]
            else:
                name = ident.parts[0].lower()
                hits = [i for i, (nm, _qu) in enumerate(quals)
                        if nm == name]
            if len(hits) > 1:
                raise PlanError(f"ambiguous outer column {name!r} in "
                                "correlated subquery")
            return hits[0] if hits else None

        from .plan import to_physical
        cache: dict = state["cache"]
        out_vals: list = []
        used_cols: list = state["used"]   # discovered on the first row

        def run_row(row: int):
            def resolver(ident: A.Ident):
                i = find_outer(ident)
                if i is None:
                    return None
                if i not in used_cols:
                    used_cols.append(i)
                v = col_values(i)[row]
                from ..session.catalog import plainify
                from ..expr import builders as B
                return B.lit(plainify(v))

            import copy as _copy

            from ..planner.build import SUBQUERY_EXECUTOR

            def nested_eval(ast2):
                """Eager executor for subqueries NESTED inside the apply
                (the session's hook is out of scope at executor time)."""
                from ..expr import builders as B
                from ..session.catalog import plainify
                b2 = build_query(ast2, self.catalog, self.default_db, {})
                if len(b2.plan.schema) != 1:
                    raise PlanError(
                        "scalar subquery must return one column")
                c2 = to_physical(optimize_plan(b2.plan)).execute(ctx)
                if c2.num_rows > 1:
                    raise PlanError(
                        "scalar subquery returned more than one row")
                if c2.num_rows == 0 or not c2.columns[0].validity[0]:
                    return B.lit(None)
                return B.lit(plainify(c2.columns[0].to_python()[0]))

            from .plan import HOST_ONLY
            tok = OUTER_RESOLVER.set(resolver)
            tok2 = SUBQUERY_EXECUTOR.set(nested_eval)
            # per-key plans bake the outer value in as a constant: device
            # fusion would compile one XLA program per distinct key, so
            # the inner plan stays on host executors (parallel_apply.go
            # runs plain executors the same way)
            tok3 = HOST_ONLY.set(True)
            try:
                built = build_query(_copy.deepcopy(sub_ast), self.catalog,
                                    self.default_db, {})
                plan = optimize_plan(built.plan)
                sub = to_physical(plan).execute(ctx)
            finally:
                HOST_ONLY.reset(tok3)
                SUBQUERY_EXECUTOR.reset(tok2)
                OUTER_RESOLVER.reset(tok)
            if sub.num_rows > 1:
                raise PlanError(
                    "scalar subquery returned more than one row")
            if sub.num_rows == 0 or not sub.columns[0].validity[0]:
                return None
            return sub.columns[0].to_python()[0]

        # Batched apply (parallel_apply.go): probe row 0 serially to
        # DISCOVER the referenced outer columns, then collect the
        # chunk's distinct missing keys and execute their subplans on a
        # worker pool (contextvars-copied so OUTER_RESOLVER/HOST_ONLY
        # travel); rows then map through the cache.
        self.last_inner_runs = getattr(self, "last_inner_runs", 0)
        if n == 0:
            return Column.from_values(out_t, [])
        if not used_cols:
            v0 = run_row(0)
            self.last_inner_runs += 1
            if not used_cols:
                # uncorrelated: one execution serves every row
                return Column.from_values(out_t, [v0] * n)
            cache[tuple(col_values(i)[0] for i in used_cols)] = v0
        keys = [tuple(col_values(i)[row] for i in used_cols)
                for row in range(n)]
        missing: dict = {}
        for row, key in enumerate(keys):
            if key not in cache and key not in missing:
                missing[key] = row
        if missing:
            import os as _os
            items = list(missing.items())
            self.last_inner_runs += len(items)
            workers = min(len(items), _os.cpu_count() or 1, 8)
            if workers > 1:
                import contextvars as _cv

                from ..utils.poolmgr import MANAGER
                futs = [(key, MANAGER.submit("apply",
                                             _cv.copy_context().run,
                                             run_row, row))
                        for key, row in items]
                for key, f in futs:
                    cache[key] = f.result()
            else:
                for key, row in items:
                    cache[key] = run_row(row)
        out_vals = [cache[key] for key in keys]
        return Column.from_values(out_t, out_vals)


def _prep_build_groups(ctx, builds, keys_for):
    """Materialize broadcast-join build sides into device aux groups
    (sorted keys + permutation + columns).  None = runtime anomaly
    (empty build / duplicate keys): the caller's host fallback runs —
    shared by CopJoinTaskExec chains and window-over-join fragments."""
    card = _to_card(ctx)
    groups = []
    for b in builds:
        bchunk = b["exec"].execute(ctx)
        kcol = bchunk.columns[b["key_index"]]
        keys, ok = keys_for(kcol, b["key_dict"], b["probe_key_dtype"])
        rows_idx = np.nonzero(ok)[0]
        keys = keys[rows_idx]
        if len(keys) == 0 or len(np.unique(keys)) != len(keys):
            return None
        order = np.argsort(keys, kind="stable")
        grp = [(card(keys[order]), None),
               (card(np.arange(len(keys), dtype=np.int64)[order]), None)]
        for c in bchunk.columns:
            data = c.data[rows_idx]
            valid = c.validity[rows_idx]
            grp.append((card(data), None if valid.all() else card(valid)))
        groups.append(tuple(grp))
    return tuple(groups)


def _to_card(ctx):
    """``np -> tensor`` on the client's device: a broadcast join's build
    side, one copy read by every logical device."""
    import torch
    dev = ctx.client.devices[0]
    return lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)


def _synced_since(ctx, t0: float) -> float:
    """Seconds since ``t0`` once the client's device has finished."""
    import torch
    if ctx.client.devices[0].type == "cuda":
        torch.cuda.synchronize(ctx.client.devices[0])
    return time.perf_counter() - t0


def _join_fallback(ctx, fallback: PhysOp) -> ResultChunk:
    """A broadcast join's host plan, counted on the client
    (``CopClient.join_fallbacks``)."""
    ctx.client.join_fallbacks += 1
    return fallback.execute(ctx)


@dataclass
class CopWindowExec(PhysOp):
    """Device window functions (TiFlash MPP window analog): rows
    hash-repartition by PARTITION BY over the mesh, each device sorts its
    partitions once and computes every window item with segment ops —
    one fused shard_map program (parallel/window.py)."""
    locality = "device"
    sharding = "all_to_all"
    spec: Any                      # D.WindowShuffleSpec
    table: Any
    out_names: list = field(default_factory=list)
    out_dtypes: list = field(default_factory=list)
    out_dicts: dict = field(default_factory=dict)
    children: list = field(default_factory=list)
    # window-over-join: broadcast build specs feeding the LookupJoin
    # levels inside spec.child, with a host fallback for runtime
    # anomalies (fragment.go: windows consume exchange output)
    builds: list = None
    fallback: PhysOp = None
    device: str = field(default_factory=_cop_device)

    def __post_init__(self):
        if self.builds:
            self.children = [b["exec"] for b in self.builds]

    def describe(self):
        funcs = ",".join(f for f, _a, _t in self.spec.items)
        over = f" over-join x{len(self.builds)}" if self.builds else ""
        return (f"CopWindow[{funcs}] table={self.table.name}{over} "
                f"-> {self.device}")

    def execute(self, ctx: ExecContext) -> ResultChunk:
        aux = ()
        if self.builds:
            aux = _prep_build_groups(
                ctx, self.builds,
                lambda kcol, kd, pt: CopJoinTaskExec._keys_for(
                    None, kcol, kd, pt))
            if aux is None:
                return _join_fallback(ctx, self.fallback)
        # dictionaries attach inside the client's _assemble_rows
        cols = ctx.client.execute_window(
            self.spec, self.table.snapshot(), tuple(self.out_dtypes),
            self.out_dicts, aux_cols=aux)
        return ResultChunk(list(self.out_names), cols)


@dataclass
class MemTableExec(PhysOp):
    """information_schema / performance_schema memtable reader
    (pkg/executor/infoschema_reader.go retriever analog): materializes the
    virtual table's rows from live Domain state at execute time."""
    table: Any                    # infoschema.MemTableInfo
    col_offsets: list
    out_names: list = field(default_factory=list)
    out_dtypes: list = field(default_factory=list)
    children: list = field(default_factory=list)

    def describe(self):
        return f"MemTableScan {self.table.name}"

    def execute(self, ctx: ExecContext) -> ResultChunk:
        rows = self.table.producer(self.table.domain)
        cols = []
        for out_i, off in enumerate(self.col_offsets):
            t = self.out_dtypes[out_i]
            vals = [r[off] for r in rows]
            cols.append(Column.from_values(t.with_nullable(True), vals))
        return ResultChunk(list(self.out_names), cols)


@dataclass
class DualExec(PhysOp):
    exprs: list = field(default_factory=list)
    out_names: list = field(default_factory=list)

    def __post_init__(self):
        self.out_dtypes = [e.dtype for e in self.exprs]
        self.children = []

    def execute(self, ctx):
        cols = []
        for e in self.exprs:
            v, m = eval_expr(np, e, [])
            val = v.item() if hasattr(v, "item") else v
            valid = bool(m) if isinstance(m, bool) else True
            if e.dtype.is_string:
                d = StringDict([str(val)] if valid else [])
                cols.append(Column(e.dtype,
                                   np.zeros(1, np.int32),
                                   np.asarray([valid]), d))
                continue
            vals = np.asarray([int(val) if isinstance(val, bool) else
                               (val if valid else 0)])
            cols.append(Column(e.dtype, vals.astype(e.dtype.np_dtype()),
                               np.asarray([valid])))
        return ResultChunk(list(self.out_names), cols)


# --------------------------------------------------------------------- #
# index access (PointGet / IndexLookUp)
# --------------------------------------------------------------------- #

def _prefix_succ(b: bytes) -> bytes:
    """Smallest key strictly greater than every key with prefix b."""
    ba = bytearray(b)
    for i in reversed(range(len(ba))):
        if ba[i] != 0xFF:
            ba[i] += 1
            return bytes(ba[: i + 1])
    return bytes(b) + b"\xff"


@dataclass
class IndexLookUpExec(PhysOp):
    """Serve a query from a secondary index: scan the pinned-prefix key
    range, decode handles, fetch + decode rows, filter residuals.

    Reference analog: PointGetExec (executor/point_get.go) when the access
    pins a full unique prefix, IndexLookUpExecutor (executor/distsql.go:457
    indexWorker/tableWorker pipeline) otherwise — collapsed to a
    synchronous scan+batchget against the native MVCC engine."""
    table: Any
    access: Any                    # planner.ranger.IndexAccess
    col_offsets: list = field(default_factory=list)
    conditions: list = field(default_factory=list)   # residual (unlowered)
    out_names: list = field(default_factory=list)
    out_dtypes: list = field(default_factory=list)
    children: list = field(default_factory=list)
    # order property (find_best_task keep-order analog): the index scan's
    # native key order SATISFIES a required ORDER BY, so the plan carries
    # no sort; `reverse` walks the index backward (DESC), `limit`/`offset`
    # stop the handle walk early (ORDER BY ... LIMIT through the index)
    keep_order: bool = False
    reverse: bool = False
    limit: Any = None
    offset: int = 0

    def describe(self):
        ix = self.access.index
        kind = "PointGet" if self.access.is_point else "IndexLookUp"
        rng = f" range[{self.access.range_col}]" if self.access.range_col else ""
        ko = ""
        if self.keep_order:
            ko = ", keep-order" + (" desc" if self.reverse else "")
            if self.limit is not None:
                ko += f", limit={self.limit}"
        return (f"{kind}[{self.table.name}.{ix.name}] "
                f"eq={self.access.eq_values}{rng}{ko}")

    def execute(self, ctx):
        tbl = self.table
        kv = tbl.kv
        ts = ctx.kv_read_ts(kv)
        handles = _index_handles(tbl, self.access, kv, ts)
        if self.reverse:
            handles = list(reversed(handles))
        if self.limit is None:
            return _fetch_filter_rows(tbl, kv, ts, handles,
                                      self.col_offsets, self.out_names,
                                      self.conditions)
        # early-stop walk: fetch/filter in handle batches until
        # offset+limit surviving rows are found, preserving index order
        need = self.limit + self.offset
        out = None
        for lo in range(0, len(handles), 256):
            chunk = _fetch_filter_rows(tbl, kv, ts,
                                       handles[lo:lo + 256],
                                       self.col_offsets, self.out_names,
                                       self.conditions)
            out = chunk if out is None else ResultChunk(
                out.names, [Column.concat([a, b]) for a, b in
                            zip(out.columns, chunk.columns)])
            if out.num_rows >= need:
                break
        if out is None:
            return _fetch_filter_rows(tbl, kv, ts, [], self.col_offsets,
                                      self.out_names, self.conditions)
        lo, hi = self.offset, need
        return ResultChunk(out.names,
                           [c.slice(lo, min(hi, out.num_rows))
                            for c in out.columns])


def _index_handles(tbl, acc, kv, ts: int) -> list:
    """Row handles matched by one IndexAccess (index-side half of the
    IndexLookUp pipeline; shared with IndexMergeExec)."""
    from ..store import codec as C
    ix = acc.index
    offs = [tbl.col_names.index(c) for c in ix.columns]
    types = [tbl.col_types[i] for i in offs]
    parts = [C.encode_index_value(v, t)
             for v, t in zip(acc.eq_values, types)]
    handles: list[int] = []
    if acc.is_point:
        key = C.index_key(tbl.table_id, ix.index_id, *parts)
        val = kv.get(key, ts)
        if val is not None:
            handles = [C.decode_index_handle(key, val)]
        return handles
    base = C.index_key(tbl.table_id, ix.index_id, *parts)
    start, end = base, _prefix_succ(base)
    if acc.range_col is not None:
        rt = types[len(acc.eq_values)]
        if acc.low is not None:
            lo = base + C.encode_index_value(acc.low, rt)
            start = lo if acc.low_incl else _prefix_succ(lo)
        else:
            # bounded above only: skip NULL entries (flag 0x00) —
            # col < x is never true for NULL
            start = base + b"\x01"
        if acc.high is not None:
            hi = base + C.encode_index_value(acc.high, rt)
            end = _prefix_succ(hi) if acc.high_incl else hi
    for k, v in kv.scan(start, end, ts):
        handles.append(C.decode_index_handle(k, v))
    return handles


def _fetch_filter_rows(tbl, kv, ts, handles, col_offsets, out_names,
                      conditions) -> ResultChunk:
    """Table-side half of the IndexLookUp pipeline: fetch + decode rows
    by handle, project, apply residual filters."""
    from ..store import codec as C
    rows = []
    for h in handles:
        rv = kv.get(C.record_key(tbl.table_id, h), ts)
        if rv is not None:
            rows.append(C.decode_row(rv, tbl.col_types))
    cols = [Column.from_values(tbl.col_types[off], [r[off] for r in rows])
            for off in col_offsets]
    chunk = ResultChunk(list(out_names), cols)
    if not conditions or chunk.num_rows == 0:
        return chunk
    dicts = {i: c.dictionary for i, c in enumerate(cols)
             if c.dictionary is not None}
    idx = np.nonzero(_conds_mask(chunk, conditions, dicts))[0]
    return ResultChunk(chunk.names, [c.take(idx) for c in chunk.columns])


@dataclass
class IndexMergeExec(PhysOp):
    """Union-type IndexMerge (executor/index_merge_reader.go analog): one
    handle set per index access — one access per OR disjunct — unioned,
    rows fetched once per distinct handle, then filtered by the FULL
    disjunction (each access may over-approximate its disjunct)."""
    table: Any
    accesses: list = field(default_factory=list)
    col_offsets: list = field(default_factory=list)
    conditions: list = field(default_factory=list)   # the whole OR
    out_names: list = field(default_factory=list)
    out_dtypes: list = field(default_factory=list)
    children: list = field(default_factory=list)

    def describe(self):
        parts = ", ".join(
            f"{a.index.name} eq={a.eq_values}" for a in self.accesses)
        return f"IndexMerge[{self.table.name}: {parts}]"

    def execute(self, ctx):
        tbl = self.table
        kv = tbl.kv
        ts = ctx.kv_read_ts(kv)
        handles: dict = {}            # ordered de-dup
        for acc in self.accesses:
            for h in _index_handles(tbl, acc, kv, ts):
                handles[h] = None
        return _fetch_filter_rows(tbl, kv, ts, list(handles),
                                  self.col_offsets, self.out_names,
                                  self.conditions)


# --------------------------------------------------------------------- #
# set operations (UNION / EXCEPT / INTERSECT)
# --------------------------------------------------------------------- #

def _canon_val(v, t: dt.DataType):
    """Python value -> canonical hashable value matching the column's
    internal representation (scaled int for DECIMAL, days for DATE, ...)."""
    from ..types import decimal as dec, temporal as tmp
    if v is None:
        return None
    k = t.kind
    if k == K.DECIMAL:
        return dec.encode(v, t.scale)
    if k == K.DATE:
        return v if isinstance(v, (int, np.integer)) \
            else tmp.parse_date(str(v))
    if k == K.DATETIME:
        return v if isinstance(v, (int, np.integer)) \
            else tmp.parse_datetime(str(v))
    if k in (K.FLOAT64, K.FLOAT32):
        return float(v)
    if k == K.STRING:
        return str(v)
    return int(v)


def _canon_rows(chunk: ResultChunk, dtypes) -> list[tuple]:
    cols = []
    for c, t in zip(chunk.columns[:len(dtypes)], dtypes):
        cols.append([_canon_val(v, t) for v in c.to_python()])
    return list(zip(*cols)) if cols else []


def _chunk_from_canon(rows: list[tuple], dtypes, names) -> ResultChunk:
    cols = []
    for i, t in enumerate(dtypes):
        vals = [r[i] for r in rows]
        if t.kind == K.STRING:
            cols.append(Column.from_values(t, vals))
        else:
            data = np.array([0 if v is None else v for v in vals],
                            dtype=t.np_dtype())
            valid = np.array([v is not None for v in vals], bool)
            cols.append(Column(t, data, valid))
    return ResultChunk(list(names), cols)


@dataclass
class HostSetOp(PhysOp):
    """UNION/EXCEPT/INTERSECT over canonicalized row tuples (reference:
    UnionExec executor/union… + set-op rewrites).  Both inputs convert to
    the unified output dtypes first."""
    kind: str
    all: bool = False
    left: PhysOp = None
    right: PhysOp = None
    out_names: list = field(default_factory=list)
    out_dtypes: list = field(default_factory=list)

    def __post_init__(self):
        self.children = [self.left, self.right]

    def describe(self):
        return f"HostSetOp[{self.kind}{' all' if self.all else ''}]"

    def execute(self, ctx):
        from collections import Counter
        lrows = _canon_rows(self.left.execute(ctx), self.out_dtypes)
        rrows = _canon_rows(self.right.execute(ctx), self.out_dtypes)
        if self.kind == "union":
            rows = lrows + rrows if self.all \
                else list(dict.fromkeys(lrows + rrows))
        elif self.kind == "except":
            if self.all:
                rcnt = Counter(rrows)
                rows = []
                for r in lrows:
                    if rcnt[r] > 0:
                        rcnt[r] -= 1
                    else:
                        rows.append(r)
            else:
                rset = set(rrows)
                rows = list(dict.fromkeys(r for r in lrows if r not in rset))
        else:  # intersect
            if self.all:
                rcnt = Counter(rrows)
                rows = []
                for r in lrows:
                    if rcnt[r] > 0:
                        rcnt[r] -= 1
                        rows.append(r)
            else:
                rset = set(rrows)
                rows = list(dict.fromkeys(r for r in lrows if r in rset))
        return _chunk_from_canon(rows, self.out_dtypes, self.out_names)


# --------------------------------------------------------------------- #
# window functions
# --------------------------------------------------------------------- #

@dataclass
class HostWindow(PhysOp):
    """Window functions (reference: executor/window.go WindowExec +
    pipelined_window.go).  Output = child columns + one column per item,
    in the CHILD's row order (values computed in partition/order-sorted
    space, scattered back)."""
    child: PhysOp
    items: list = field(default_factory=list)   # planner WindowItem
    out_names: list = field(default_factory=list)
    out_dtypes: list = field(default_factory=list)

    def __post_init__(self):
        self.children = [self.child]

    def describe(self):
        return "HostWindow[" + ",".join(i.func for i in self.items) + "]"

    def execute(self, ctx):
        chunk = self.child.execute(ctx)
        cols = list(chunk.columns)
        for item in self.items:
            cols.append(_window_column(item, chunk))
        return ResultChunk(list(self.out_names), cols)


def _window_column(item, chunk: ResultChunk) -> Column:
    n = chunk.num_rows
    t = item.out_dtype
    if n == 0:
        return Column(t, np.zeros(0, t.np_dtype()), np.zeros(0, bool))

    # sort by (partition, order); boundary detection reuses the same rank
    # arrays — equality of ranks is invariant under the desc sign flip
    sort_keys = [(e, False) for e in item.partition] + list(item.order)
    ranks = _sort_keys_matrix(chunk, sort_keys)
    sidx = (np.lexsort(tuple(reversed(ranks))) if ranks
            else np.arange(n))

    n_part = len(item.partition)
    new_part = np.zeros(n, bool)
    new_part[0] = True
    for r in ranks[:n_part]:
        rs = r[sidx]
        new_part[1:] |= rs[1:] != rs[:-1]
    new_peer = new_part.copy()
    for r in ranks[n_part:]:
        rs = r[sidx]
        new_peer[1:] |= rs[1:] != rs[:-1]

    idx = np.arange(n)
    part_id = np.cumsum(new_part) - 1
    ps = np.maximum.accumulate(np.where(new_part, idx, 0))      # part start
    starts = np.flatnonzero(new_part)
    sizes = np.diff(np.append(starts, n))
    sz = sizes[part_id]
    pe = ps + sz - 1                                            # part end
    pos = idx - ps
    pstart = np.maximum.accumulate(np.where(new_peer, idx, 0))  # peer start
    peer_id = np.cumsum(new_peer) - 1
    peer_starts = np.flatnonzero(new_peer)
    peer_sizes = np.diff(np.append(peer_starts, n))
    peer_end = peer_starts[peer_id] + peer_sizes[peer_id] - 1

    f = item.func
    if f in ("row_number", "rank", "dense_rank", "ntile"):
        if f == "row_number":
            vals = pos + 1
        elif f == "rank":
            vals = pstart - ps + 1
        elif f == "dense_rank":
            d = np.cumsum(new_peer)
            vals = d - d[ps] + 1
        else:  # ntile(k)
            k = int(item.args[0].value)
            if k <= 0:
                raise ValueError("NTILE argument must be positive")
            q, r = sz // k, sz % k
            big = r * (q + 1)
            vals = np.where(pos < big, pos // np.maximum(q + 1, 1),
                            r + (pos - big) // np.maximum(q, 1)) + 1
        out = np.empty(n, np.int64)
        out[sidx] = vals
        return Column(t, out.astype(t.np_dtype()), np.ones(n, bool))

    if f in ("percent_rank", "cume_dist"):
        # percent_rank = (rank-1)/(rows-1); cume_dist = peer_end+1 relative
        # to the partition (executor/window.go percentRank/cumeDist)
        rank = (pstart - ps + 1).astype(np.float64)
        if f == "percent_rank":
            vals = np.where(sz > 1, (rank - 1) / np.maximum(sz - 1, 1), 0.0)
        else:
            vals = (peer_end - ps + 1).astype(np.float64) / sz
        out = np.empty(n, np.float64)
        out[sidx] = vals
        return Column(t, out, np.ones(n, bool))

    # value-bearing functions
    src = _eval_to_column(item.args[0], chunk) if item.args else None
    v = src.data[sidx] if src is not None else np.zeros(n, np.int64)
    m = src.validity[sidx] if src is not None else np.ones(n, bool)
    dictionary = src.dictionary if src is not None else None

    if f in ("lag", "lead"):
        off = int(item.args[1].value) if len(item.args) > 1 else 1
        default = item.args[2].value if len(item.args) > 2 else None
        srcpos = idx - off if f == "lag" else idx + off
        inside = (srcpos >= ps) & (srcpos <= pe)
        srcpos = np.clip(srcpos, 0, n - 1)
        vals = v[srcpos]
        valid = m[srcpos] & inside
        if default is not None:
            if t.is_string:
                # rebuild the dictionary with the default and remap codes
                # (codes are sorted-order-preserving, so insertion shifts)
                nd = StringDict(list(dictionary.values) + [str(default)])
                remap = np.array([nd.code_of(x) for x in dictionary.values]
                                 or [0], np.int32)
                vals = remap[np.clip(vals, 0, max(len(dictionary) - 1, 0))]
                dval = nd.code_of(str(default))
                dictionary = nd
            else:
                dval = _canon_val(default, t)
            vals = np.where(inside, vals, dval)
            valid = valid | ~inside
        out = np.empty(n, vals.dtype)
        out[sidx] = vals
        ov = np.empty(n, bool)
        ov[sidx] = valid
        return Column(t, out.astype(t.np_dtype()), ov, dictionary)

    # frame computation (sorted coordinates, inclusive [flo, fhi])
    flo, fhi, empty = _frame_bounds(item, idx, ps, pe, pstart, peer_end,
                                    bool(item.order))

    if f == "first_value" or f == "last_value":
        at = np.clip(np.where(f == "first_value", flo, fhi), 0, n - 1)
        vals = v[at]
        valid = m[at] & ~empty
        out = np.empty(n, vals.dtype)
        out[sidx] = vals
        ov = np.empty(n, bool)
        ov[sidx] = valid
        return Column(t, out.astype(t.np_dtype()), ov, dictionary)

    is_float = src is not None and src.dtype.kind in (K.FLOAT64, K.FLOAT32)
    cm = np.concatenate([[0], np.cumsum(m.astype(np.int64))])
    cnt = cm[np.clip(fhi + 1, 0, n)] - cm[np.clip(flo, 0, n)]
    cnt = np.where(empty, 0, cnt)

    if f == "count":
        if src is None:                      # COUNT(*)
            cnt = np.where(empty, 0, fhi - flo + 1)
        out = np.empty(n, np.int64)
        out[sidx] = cnt
        return Column(t, out, np.ones(n, bool))

    if f in ("sum", "avg"):
        acc = np.where(m, v, 0).astype(np.float64 if is_float or f == "avg"
                                       else np.int64)
        if f == "avg" and src.dtype.kind == K.DECIMAL:
            acc = acc / (10 ** src.dtype.scale)
        cs = np.concatenate([[0], np.cumsum(acc)])
        s = cs[np.clip(fhi + 1, 0, n)] - cs[np.clip(flo, 0, n)]
        if f == "avg":
            vals = np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)
        else:
            vals = s
        valid = cnt > 0
        out = np.empty(n, vals.dtype)
        out[sidx] = vals
        ov = np.empty(n, bool)
        ov[sidx] = valid
        return Column(t, out.astype(t.np_dtype()), ov)

    # min / max over the frame: int64 sentinel path for exact integer /
    # decimal / temporal values (float64 would corrupt > 2^53)
    assert f in ("min", "max")
    if is_float:
        fv = v.astype(np.float64)
        pad = np.inf if f == "min" else -np.inf
    else:
        fv = v.astype(np.int64)
        pad = np.iinfo(np.int64).max if f == "min" else np.iinfo(np.int64).min
    fv = np.where(m, fv, pad)
    if (flo == ps).all():
        run = np.empty(n, fv.dtype)
        ends = np.append(starts[1:], n)
        for s0, e0 in zip(starts, ends):
            seg = fv[s0:e0]
            run[s0:e0] = (np.minimum.accumulate(seg) if f == "min"
                          else np.maximum.accumulate(seg))
        vals = run[np.clip(fhi, 0, n - 1)]
    else:
        vals = np.empty(n, fv.dtype)
        for i in range(n):
            if empty[i]:
                vals[i] = pad
                continue
            seg = fv[flo[i]:fhi[i] + 1]
            vals[i] = seg.min() if f == "min" else seg.max()
    valid = cnt > 0
    vals = np.where(valid, vals, 0)
    out = np.empty(n, vals.dtype)
    out[sidx] = vals
    ov = np.empty(n, bool)
    ov[sidx] = valid
    # min/max over a dict-encoded string returns a CODE: keep its dict
    return Column(t, out.astype(t.np_dtype()), ov, dictionary)


def _frame_bounds(item, idx, ps, pe, pstart, peer_end, has_order):
    """Per-row inclusive frame [lo, hi] in sorted coordinates plus an
    `empty` mask.  Emptiness is decided on the UNCLAMPED bounds — a frame
    entirely outside the partition (e.g. ROWS BETWEEN UNBOUNDED PRECEDING
    AND 1 PRECEDING on the first row) is empty, not one-row.  Default
    frame: RANGE UNBOUNDED PRECEDING..CURRENT ROW with ORDER BY (peers
    included), whole partition without."""
    n = len(idx)
    if item.frame is None:
        none_empty = np.zeros(n, bool)
        if has_order:
            return ps, peer_end, none_empty
        return ps, pe, none_empty
    unit, (lok, lon), (hik, hin) = item.frame

    def bound(kind, nv, is_lo):
        if kind == "unbounded_preceding":
            return ps
        if kind == "unbounded_following":
            return pe
        if kind == "current":
            if unit == "range":
                return pstart if is_lo else peer_end
            return idx
        if kind == "preceding":
            return idx - nv
        return idx + nv     # following

    lo_raw = bound(lok, lon, True)
    hi_raw = bound(hik, hin, False)
    empty = (lo_raw > hi_raw) | (lo_raw > pe) | (hi_raw < ps)
    lo = np.clip(lo_raw, ps, pe)
    hi = np.clip(hi_raw, ps, pe)
    return lo, hi, empty


# --------------------------------------------------------------------- #
# recursive CTEs
# --------------------------------------------------------------------- #

@dataclass
class CTEScanExec(PhysOp):
    """Scan of a recursive CTE's working table (inside the recursive part)
    or materialized result (reference: executor/cte.go CTEExec +
    CTETableReaderExec)."""
    storage: Any
    role: str
    out_names: list = field(default_factory=list)
    out_dtypes: list = field(default_factory=list)
    children: list = field(default_factory=list)

    def describe(self):
        return f"CTEScan[{self.storage.name},{self.role}]"

    def execute(self, ctx):
        st = self.storage
        if self.role == "working":
            ch = st.working
            if ch is None:
                return _chunk_from_canon([], self.out_dtypes, self.out_names)
            return ResultChunk(list(self.out_names), list(ch.columns))
        if st.result is None:
            _compute_recursive_cte(st, ctx)
        return ResultChunk(list(self.out_names), list(st.result.columns))


def _compute_recursive_cte(st, ctx):
    """Iterate seed -> recursive parts until no new rows (UNION DISTINCT)
    or an empty delta (UNION ALL); cap at st.max_depth like
    cte_max_recursion_depth."""
    from .plan import to_physical
    if st.seed_phys is None:
        st.seed_phys = to_physical(st.seed_logical)
        st.rec_phys = [to_physical(r) for r in st.rec_logicals]
    dtypes = [c.dtype for c in st.schema.cols]
    names = st.schema.names()
    rows = _canon_rows(st.seed_phys.execute(ctx), dtypes)
    if st.distinct:
        rows = list(dict.fromkeys(rows))
    seen = set(rows)
    all_rows = list(rows)
    working = rows
    depth = 0
    while working:
        depth += 1
        if depth > st.max_depth:
            raise RuntimeError(
                f"recursive CTE {st.name!r} exceeded max recursion depth "
                f"{st.max_depth} (cte_max_recursion_depth)")
        st.working = _chunk_from_canon(working, dtypes, names)
        new = []
        for p in st.rec_phys:
            new.extend(_canon_rows(p.execute(ctx), dtypes))
        if st.distinct:
            fresh = []
            for r in new:
                if r not in seen:
                    seen.add(r)
                    fresh.append(r)
            working = fresh
        else:
            working = new
        all_rows.extend(working)
    st.working = None
    st.result = _chunk_from_canon(all_rows, dtypes, names)


__all__ = [
    "ExecContext", "ResultChunk", "PhysOp", "CopTaskExec", "HostSelection",
    "HostProjection", "HostLimit", "HostSort", "HostTopN", "HostHashJoin",
    "HostAgg", "DualExec", "HostSetOp", "HostWindow", "CTEScanExec",
    "IndexLookUpExec", "DEVICE_OPS",
]
