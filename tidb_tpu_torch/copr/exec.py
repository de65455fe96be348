# ported from tidb_tpu/copr/exec.py @ 02e96d8
"""Coprocessor execution on torch: DAG nodes over one device's batch.

The JAX package traces a DAG into one fused XLA program; the port runs
the same nodes eagerly with torch ops on the device that holds the
batch.  Static shapes carry over: a shard is a fixed-capacity batch of
columns and live rows ride a selection mask ``sel`` instead of being
compacted.

It runs every node of the JAX package's: the TableScan, Selection,
Projection, Expand (WITH ROLLUP), Limit and TopN nodes, the LookupJoin
node (a broadcast join against build sides passed
in as ``aux`` groups, copr/join.py), the device-side compaction of a
row-returning program (``compact``), and the partial states of the
SCALAR, DENSE, SORT, SEGMENT and SCATTER aggregations.  Every state
table of an aggregation is one ``group_reduce_lanes`` call over all its
lanes (``reduce_states``): one launch of the hand-written
``group_reduce`` kernel on a CUDA tensor, its plain version on a CPU
tensor (copr/cuda/group_reduce.py); every device sort (SORT, SEGMENT,
TopN) goes through ``stable_argsort`` (ops/sort.py), the counting-sort
kernels' multi-key LSD radix sort, in place of the JAX package's stable
``lax.sort``.  Out-of-range scatter indices raise in torch where XLA
drops them (``mode="drop"``), so a grouped reduction parks dead and
overflowing rows at index ``num_groups`` and a compaction its rows past
the capacity at index ``capacity``: the sink slot, which is sliced off.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import torch

from ..expr.compile import Evaluator
from ..ops import sort as _sort
from ..ops.sort import stable_argsort
from ..ops.sortkeys import as_int64_bits, sortable_int64
from ..types import dtypes as dt
from . import dag as D
from .cuda import group_reduce as _gr
from .cuda.group_reduce import Lane, group_reduce, group_reduce_lanes

K = dt.TypeKind

# (hi, lo) limb SUMs stay int64-exact below this many rows a batch
LIMB_SUM_ROWS = 2 ** 31


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} arrives with a later slice of the port (ROADMAP.md, "
        "Queue 1)")


@dataclass(frozen=True)
class Slots:
    """The batch-slot ids of a stacked batch (parallel/spmd
    ``BatchedCopProgram``): row r belongs to slot ``ids[r]`` of ``k``.
    A SCALAR or DENSE aggregation over it offsets each row's group id by
    its slot times the plan's group count G (G = 1 for SCALAR), so ONE
    reduction over K·G groups holds every slot's states; the (hi, lo)
    limb bound holds per slot, at the batch's rows / k."""
    ids: Any      # (n,) int32 tensor
    k: int


@dataclass
class DeviceBatch:
    """Columns + live-row selection mask flowing between operators.

    ``extras`` carries named device scalars that must reach the client:
    ``join_total``, the true output size of an expanding join, so the
    client can regrow its capacity."""
    cols: list  # list[(value, valid)]
    sel: Any    # bool tensor | True
    extras: dict = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.extras is None:
            self.extras = {}


def _ensure_array(v, n: int, device) -> torch.Tensor:
    """A length-``n`` tensor for a column value that may be a scalar."""
    if isinstance(v, torch.Tensor):
        if v.dim():
            return v
        return v.reshape(1).expand(n)
    if isinstance(v, bool):
        return torch.full((n,), v, dtype=torch.bool, device=device)
    dtype = torch.float64 if isinstance(v, float) else torch.int64
    return torch.full((n,), v, dtype=dtype, device=device)


def _sel_array(sel, n: int, device) -> torch.Tensor:
    """A selection or validity mask as a length-``n`` bool tensor (a
    projected NULL literal's mask is the scalar False)."""
    if sel is True:
        return torch.ones((n,), dtype=torch.bool, device=device)
    return _ensure_array(sel, n, device)


# --------------------------------------------------------------------- #
# Aggregation partial states
# --------------------------------------------------------------------- #

def _reduce(vals: torch.Tensor, mask: torch.Tensor, gids, num_groups: int,
            how: str) -> torch.Tensor:
    """Masked (optionally grouped) reduction.

    how: 'sum' | 'min' | 'max'.  ``gids`` None => the SCALAR reduction,
    a 0-d tensor; a narrow integer sum then comes back as int64, as
    ``jnp.sum`` promotes it.  Grouped: the dense ``(num_groups,)`` table;
    ``gids`` lie in ``[0, num_groups]`` and ``num_groups``, the sink
    slot, is dropped."""
    if gids is None:
        if how == "sum" and Evaluator._is_narrow(vals):
            vals = vals.to(torch.int64)
        return group_reduce(vals, mask, None, 1, how).reshape(())
    return group_reduce(vals, mask, gids, num_groups, how)


def _lane_mask(sel, am, masks: dict):
    """The rows an aggregate over a value of validity ``am`` reduces:
    ``sel`` itself for a value that is never NULL, else ``sel & am``,
    made once per validity mask (``masks``, by identity) so that the
    aggregates of one argument share one mask, and their counts one
    lane."""
    if am is True:
        return sel
    if id(am) not in masks:
        masks[id(am)] = (am, sel & am)
    return masks[id(am)][1]


def _agg_lanes(a: D.AggDesc, av, am, sel, n, masks: dict,
               narrow: bool = False, group_rows: int = -1) -> dict:
    """The state lanes of one AggDesc over (possibly grouped) rows, as
    ``{field: Lane}``; ``reduce_states`` reduces them.

    Layout: count -> {count}; int/decimal sum -> {hi, lo, cnt} (int64
    limbs, exact when recombined on the host); proven-narrow int/decimal
    sum (``agg.narrow_sums``) -> {sum, cnt}, one int64 word; float sum
    -> {sum, cnt}; min -> {min, cnt}; max -> {max, cnt}.  Every lane
    reads ``av`` at its own dtype: the count, the widening and the limb
    split are the lanes' kinds, applied where the rows are reduced."""
    av = _ensure_array(av, n, sel.device)
    mask = _lane_mask(sel, am, masks)
    cnt = Lane("count", None, mask)
    if a.func == D.AggFunc.COUNT:
        return {"count": cnt}
    if a.func == D.AggFunc.SUM:
        if a.arg.dtype.kind in (K.FLOAT64, K.FLOAT32):
            src = av if av.is_floating_point() else av.to(torch.float64)
            return {"sum": Lane("fsum", src, mask), "cnt": cnt}
        if narrow:
            # valueflow proved the whole table's sum stays inside int64,
            # so one word per group cannot wrap: bit-identical to the
            # limbs (sum(hi) << 32 + sum(lo) == sum(v) in two's complement)
            return {"sum": Lane("sum", av, mask), "cnt": cnt}
        # (hi, lo) int64 limbs: per row |hi| < 2^32 and lo < 2^32, so with
        # n < 2^31 rows per batch neither limb sum can wrap int64
        if (n if group_rows < 0 else group_rows) >= LIMB_SUM_ROWS:
            raise OverflowError(
                f"shard batch of {n} rows exceeds the 2^31 limb-exact "
                "SUM bound; use more/smaller shards")
        return {"hi": Lane("sum_hi32", av, mask),
                "lo": Lane("sum_lo32", av, mask), "cnt": cnt}
    if a.func in (D.AggFunc.MIN, D.AggFunc.MAX):
        how = "min" if a.func == D.AggFunc.MIN else "max"
        kind = ("f" + how) if av.is_floating_point() else how
        return {how: Lane(kind, av, mask), "cnt": cnt}
    raise _unported(f"device aggregate {a.func.value}")


def reduce_states(plan: dict, gids, num_groups: int) -> dict:
    """One ``group_reduce_lanes`` call over every lane of a state table.
    ``plan`` maps each state to a Lane or to a ``{field: Lane}`` dict;
    the result has the same layout with the lanes' tables, 0-d for the
    SCALAR reduction (``gids`` None)."""
    flat = []
    for k, v in plan.items():
        flat += [(k, None, v)] if isinstance(v, Lane) \
            else [(k, f, ln) for f, ln in v.items()]
    lanes, flipped = _signed_lanes([ln for *_, ln in flat])
    tables = _reduce_lanes(gids, num_groups, lanes)
    for j in flipped:
        tables[j] = (tables[j] ^ _I64_MIN).view(torch.uint64)
    states: dict[str, Any] = {}
    for (k, f, _), t in zip(flat, tables):
        t = t.reshape(()) if gids is None else t
        if f is None:
            states[k] = t
        else:
            states.setdefault(k, {})[f] = t
    return states


_I64_MIN = -2 ** 63


def minmax(t: torch.Tensor, how: str, dim: int = 0) -> torch.Tensor:
    """``amin``/``amax`` along ``dim``, a uint64 tensor in unsigned order
    (torch has no uint64 min or max): through its bits with the sign bit
    flipped, and back."""
    if t.dtype != torch.uint64:
        return t.amin(dim) if how == "min" else t.amax(dim)
    k = as_int64_bits(t) ^ _I64_MIN
    k = k.amin(dim) if how == "min" else k.amax(dim)
    return (k ^ _I64_MIN).view(torch.uint64)


def _signed_lanes(lanes: list) -> tuple[list, list]:
    """The lanes with every BIGINT UNSIGNED source as int64, which
    ``group_reduce`` reduces: a sum reads the bits (the JAX package sums
    ``astype(int64)``), a MIN or MAX the bits with the sign bit flipped,
    whose signed order is the unsigned one; the indexes of those lanes
    come back too, their tables to flip back.  One tensor a source, so
    the lanes of one column still share it."""
    out, flipped, cache = [], [], {}
    for j, ln in enumerate(lanes):
        if ln.src is None or ln.src.dtype != torch.uint64:
            out.append(ln)
            continue
        flip = ln.kind in ("min", "max")
        key = (id(ln.src), flip)
        if key not in cache:
            bits = as_int64_bits(ln.src)
            cache[key] = bits ^ _I64_MIN if flip else bits
        out.append(Lane(ln.kind, cache[key], ln.mask))
        if flip:
            flipped.append(j)
    return out, flipped


_COMBINE = {"count": torch.add, "sum": torch.add, "sum_hi32": torch.add,
            "sum_lo32": torch.add, "fsum": torch.add, "min": torch.minimum,
            "fmin": torch.minimum, "max": torch.maximum,
            "fmax": torch.maximum}


def _reduce_lanes(gids, num_groups: int, lanes: list) -> list:
    """``group_reduce_lanes`` over the rows; a table with a float-sum
    lane over ``MAX_FLOAT_SUM_ROWS`` rows or more (past its exact limbs)
    is reduced in consecutive chunks under that, and the chunks' tables
    combine lane by lane: sums and counts add, min and max take the
    smaller and the larger (a NaN wins, as in one reduction)."""
    n = lanes[0].mask.shape[0]
    step = _gr.MAX_FLOAT_SUM_ROWS - 1
    if n <= step or not any(ln.kind == "fsum" for ln in lanes):
        return group_reduce_lanes(gids, num_groups, lanes)
    out = None
    for lo in range(0, n, step):
        cut: dict = {}      # one slice a tensor keeps the lanes' identity

        def part(t):
            return None if t is None else \
                cut.setdefault(id(t), t[lo:lo + step])
        tables = group_reduce_lanes(
            part(gids), num_groups,
            [Lane(ln.kind, part(ln.src), part(ln.mask)) for ln in lanes])
        out = tables if out is None else [
            _COMBINE[ln.kind](a, b) for ln, a, b in zip(lanes, out, tables)]
    return out


def agg_states(agg: D.Aggregation, scan_cols, row_count, ev: Evaluator,
               aux=(), slots: Slots | None = None) -> tuple:
    """Execute agg.child and build its partial states.  Returns
    ``(states, child batch)``: the batch's extras reach the client.

    A DENSE aggregation over an Expand (WITH ROLLUP) aggregates level by
    level over the un-expanded batch: each grouping-set level builds its
    key and gid columns over the same n-row batch, reduces them in one
    ``group_reduce_lanes`` call, and the levels' tables merge with the
    shard-merge combiners (``_MERGE``), so the peak memory is one level,
    not the ``levels x n`` replication.  The JAX package takes this
    branch on the TPU only (its CPU fuses the replication into one pass);
    the port takes it on the card and on the CPU alike, the same program
    wherever it runs.  SORT, SEGMENT and SCATTER read the materialized
    Expand node, as in the JAX package.  ``slots`` (a SCALAR or DENSE
    plan over a stacked batch) offsets the group ids by batch slot."""
    ch = agg.child
    if isinstance(ch, D.Expand) and agg.strategy == D.GroupStrategy.DENSE:
        base = _exec_node(ch.child, scan_cols, row_count, ev, aux)
        return _expand_level_states(agg, ch, base, ev, slots), base
    batch = _exec_node(ch, scan_cols, row_count, ev, aux)
    return _agg_partial_states(agg, batch, ev, {}, slots), batch


def _expand_level_states(agg: D.Aggregation, exp: D.Expand,
                         base: DeviceBatch, ev: Evaluator,
                         slots: Slots | None = None) -> dict:
    """The DENSE states of ``agg`` over ``exp``'s levels, one level at a
    time: level ``l`` keeps the first ``len(keys) - l`` rollup keys, the
    others NULL on every row, and appends the level as the gid column."""
    from .aggregate import _MERGE
    n = len(base.cols[0][0]) if base.cols else 0
    L = len(exp.keys)
    memo: dict = {}
    child_cols = [(_ensure_array(v, n, ev.device), m) for v, m in base.cols]
    keyvals = []
    for k in exp.keys:
        v, m = ev.eval(k, base.cols, memo)
        keyvals.append((_ensure_array(v, n, ev.device), m))
    rolled = torch.zeros(n, dtype=torch.bool, device=ev.device)

    def combine(name, a, b):
        how = _MERGE[name]
        if how == "sum":
            return a + b
        return minmax(torch.stack([a, b]), how)

    merged: dict = {}
    for lvl in range(exp.levels):
        cols = list(child_cols)
        for j, (v, m) in enumerate(keyvals):
            # key j is live on the levels below L - j, NULL above
            cols.append((v, m) if lvl + j < L else (v, rolled))
        cols.append((torch.full((n,), lvl, dtype=torch.int64,
                                device=ev.device), True))
        st = _agg_partial_states(
            agg, DeviceBatch(cols, base.sel, base.extras), ev, {}, slots)
        if not merged:
            merged = st
            continue
        for k, v in st.items():
            if isinstance(v, dict):
                merged[k] = {f: combine(f, merged[k][f], a)
                             for f, a in v.items()}
            else:
                merged[k] = combine(k, merged[k], v)
    return merged


def _agg_partial_states(agg: D.Aggregation, batch: DeviceBatch,
                        ev: Evaluator, memo: dict,
                        slots: Slots | None = None) -> dict:
    """Per-device partial-state dict of an Aggregation node.

    SCALAR/DENSE: a fixed group domain (one group, or the mixed-radix
    dense gid), merged across devices by sum/min/max.  The high-NDV
    strategies build a per-device group table, merged on the host: SORT
    sorts the rows by the key tuple (``_agg_sort_states``), SEGMENT by
    the key hash (copr/segment.py), SCATTER partitions them by the
    hash's top bits (copr/radix.py), and each segment-reduces.  Adds
    ``__rows__`` (COUNT(*) per group) for occupancy; a COUNT(*)
    aggregate reuses it.  With ``slots`` (SCALAR and DENSE only) every
    table holds K·G groups, slot-major."""
    if slots is not None and agg.strategy in D.HOST_MERGE_STRATEGIES:
        raise ValueError("only SCALAR and DENSE states batch by slot")
    if agg.strategy == D.GroupStrategy.SCATTER:
        from .radix import agg_scatter_states
        return agg_scatter_states(agg, batch, ev, memo)
    if agg.strategy == D.GroupStrategy.SEGMENT:
        from .segment import agg_segment_states
        return agg_segment_states(agg, batch, ev, memo)
    if agg.strategy == D.GroupStrategy.SORT:
        return _agg_sort_states(agg, batch, ev, memo)

    n = len(batch.cols[0][0]) if batch.cols else 0
    sel = _sel_array(batch.sel, n, ev.device)

    gids = None
    num_groups = 1
    if agg.strategy == D.GroupStrategy.DENSE:
        gids = _dense_group_ids(agg, batch, ev, memo, slots)
        num_groups = agg.num_groups
    group_rows = n
    if slots is not None:
        if gids is None:
            gids = slots.ids
        num_groups *= slots.k
        group_rows = n // slots.k

    rows = Lane("count", None, sel)
    plan: dict[str, Any] = {"__rows__": rows}
    masks: dict = {}
    for i, a in enumerate(agg.aggs):
        if a.func == D.AggFunc.COUNT and a.arg is None:
            plan[f"a{i}"] = {"count": rows}
            continue
        av, am = ev.eval(a.arg, batch.cols, memo)
        plan[f"a{i}"] = _agg_lanes(a, av, am, sel, n, masks,
                                   narrow=(i in agg.narrow_sums),
                                   group_rows=group_rows)
    return reduce_states(plan, gids, num_groups)


def _dense_group_ids(agg: D.Aggregation, batch: DeviceBatch, ev: Evaluator,
                     memo: dict, slots: Slots | None = None) -> torch.Tensor:
    """Mixed-radix dense group id from the group-by key codes, int32.

    Key domain [0, size_i); nullable keys get slot 0 for NULL and codes
    shifted by one (domain_sizes already include the NULL slot).  With
    ``slots``, offset by each row's slot times ``num_groups``."""
    n = len(batch.cols[0][0])
    gid = torch.zeros((n,), dtype=torch.int32, device=ev.device)
    for e, size in zip(agg.group_by, agg.domain_sizes):
        v, m = ev.eval(e, batch.cols, memo)
        # a DENSE key domain is at most MAX_DENSE_GROUPS < 2^31
        v = _ensure_array(v, n, ev.device).to(torch.int32)
        if e.dtype.nullable:
            code = v + 1 if m is True else torch.where(m, v + 1, 0)
        else:
            code = v
        gid = gid * size + code
    if slots is not None:
        gid = slots.ids * agg.num_groups + gid
    return gid


def group_keyinfo(agg: D.Aggregation, batch: DeviceBatch, ev: Evaluator,
                  memo: dict, n: int) -> list:
    """Canonical per-group-key (zeroed value, mask, null flag, order-
    preserving int64 code) tuples, the key representation of the
    high-NDV strategies.  NULL values are zeroed so all NULLs share one
    group; -0.0 groups with +0.0 (SQL equality, not bit equality).  A
    uint64 key keeps its dtype, and is zeroed on its int64 bits."""
    keyinfo = []
    for e in agg.group_by:
        v, m = ev.eval(e, batch.cols, memo)
        v = _ensure_array(v, n, ev.device)
        if v.dtype == torch.bool:
            v = v.to(torch.int64)
        nullf = (torch.zeros(n, dtype=torch.int32, device=v.device)
                 if m is True else (~m).to(torch.int32))
        bits = as_int64_bits(v)
        zero = torch.zeros((), dtype=bits.dtype, device=v.device)
        vz = v if m is True else torch.where(m, bits, zero).view(v.dtype)
        if e.dtype.is_float:
            vz = torch.where(vz == 0, torch.zeros((), dtype=vz.dtype,
                                                  device=v.device), vz)
        code = sortable_int64(vz, e.dtype.is_float,
                              e.dtype.kind == K.UINT64)
        keyinfo.append((vz, m, nullf, code))
    return keyinfo


def _agg_sort_states(agg: D.Aggregation, batch: DeviceBatch, ev: Evaluator,
                     memo: dict) -> dict:
    """SORT-strategy grouped aggregation: one stable multi-key sort of
    the rows by (dead flag, then per key its null flag and code), then
    the shared segment reduce (copr/segment.py) into a (group_capacity,)
    state table.  ``__ngroups__`` is the true distinct-group count, so
    the client can regrow the capacity and re-run when it exceeds
    ``group_capacity``; the live rows of groups past the table park at
    the sink slot with the dead rows."""
    from .segment import states_from_partition
    G = agg.group_capacity
    if G <= 0:
        raise ValueError(f"SORT aggregation needs a group_capacity, got {G}")
    n = len(batch.cols[0][0]) if batch.cols else 0
    sel = _sel_array(batch.sel, n, ev.device)
    keyinfo = group_keyinfo(agg, batch, ev, memo, n)
    keys = [(~sel).to(torch.int32)]
    for _vz, _m, nullf, code in keyinfo:
        keys += [nullf, code]
    idx = stable_argsort(keys)
    return states_from_partition(agg, batch, ev, keyinfo, None, idx,
                                 sel[idx], n)


# --------------------------------------------------------------------- #
# Row output: device-side compaction (the paging analog)
# --------------------------------------------------------------------- #

def _tile(v: torch.Tensor, reps: int) -> torch.Tensor:
    """``jnp.tile`` of a 1-d column, a uint64 one through its bits."""
    return as_int64_bits(v).repeat(reps).view(v.dtype)


def _gather(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``v[idx]``, a uint64 column through its int64 bits."""
    return as_int64_bits(v)[idx].view(v.dtype)


def compact(batch: DeviceBatch, capacity: int) -> tuple[list, torch.Tensor]:
    """Pack live rows to the front of fixed-size ``capacity`` buffers by
    a cumsum and a scatter.  Returns ``(cols, count)``, every column
    ``(data, valid)``; rows past ``capacity`` park at the sink slot and
    are dropped, and callers compare ``count`` with ``capacity`` and
    re-run bigger."""
    n = len(batch.cols[0][0]) if batch.cols else 0
    dev = batch.cols[0][0].device if batch.cols else None
    sel = _sel_array(batch.sel, n, dev)
    pos = torch.cumsum(sel, 0) - 1
    idx = torch.where(sel & (pos < capacity), pos, capacity)
    out_cols = []
    for v, m in batch.cols:
        v = _ensure_array(v, n, dev)
        if v.dtype == torch.bool:
            v = v.to(torch.int64)
        bits = as_int64_bits(v)
        data = torch.zeros((capacity + 1,), dtype=bits.dtype, device=dev)
        data.index_put_((idx,), bits)
        valid = torch.zeros((capacity + 1,), dtype=torch.bool, device=dev)
        valid.index_put_((idx,), _sel_array(m, n, dev))
        out_cols.append((data[:capacity].view(v.dtype), valid[:capacity]))
    return out_cols, sel.sum(dtype=torch.int64)


def _first_rows(keys: list, k: int) -> torch.Tensor:
    """The first ``k`` rows of the stable sort of the rows by ``keys``.
    A batch past ``stable_argsort``'s int32 permutation
    (``ops/sort._MAX_ROWS`` rows) is cut into consecutive chunks under
    it: each row of the top ``k`` is in its chunk's top ``k``, and the
    candidates, each chunk's put back in row order, sort stably (in
    chunks again while there are too many) into the top ``k`` that one
    sort of every row gives, ties in row order."""
    n, lim = keys[0].numel(), _sort._MAX_ROWS
    if n <= lim:
        return stable_argsort(keys)[:k]
    if 2 * k > lim:
        raise ValueError(f"a TopN of {k} rows over {n} exceeds the int32 "
                         "permutation of one sort")
    cand = []
    for lo in range(0, n, lim):
        top = stable_argsort([key[lo:lo + lim] for key in keys])[:k]
        cand.append(lo + top[stable_argsort([top])])
    cand = torch.cat(cand)
    return cand[_first_rows([key[cand] for key in keys], k)]


def _exec_topn(node: D.TopN, batch: DeviceBatch, ev: Evaluator
               ) -> DeviceBatch:
    """Per-shard TopN: a stable multi-key sort, then the first k rows.

    Sort keys, ascending, in priority order: (1) the dead-row flag, so
    filtered rows sort last; then per ORDER BY key (2) the NULL flag in
    MySQL order (NULLs first ASC, last DESC) and (3) the order-preserving
    int64 key, bitwise-NOT for DESC (an exact reversal with no
    overflow)."""
    memo: dict = {}
    n = len(batch.cols[0][0])
    sel = _sel_array(batch.sel, n, ev.device)
    keys = [(~sel).to(torch.int32)]
    for e, desc in (node.sort_keys or ((node.sort_key, node.desc),)):
        v, m = ev.eval(e, batch.cols, memo)
        v = _ensure_array(v, n, ev.device)
        key = sortable_int64(v, e.dtype.is_float, e.dtype.kind == K.UINT64)
        if desc:
            key = ~key
        if m is True:
            nullflag = torch.zeros(n, dtype=torch.int32, device=ev.device)
        else:
            valid = _sel_array(m, n, ev.device)
            nullflag = (~valid if desc else valid).to(torch.int32)
        keys += [nullflag, key]
    k = min(node.limit, n)
    idx = _first_rows(keys, k)
    live = sel.sum(dtype=torch.int64)
    out_sel = torch.arange(k, device=ev.device) < torch.clamp(live, max=k)
    cols = []
    for cv, cm in batch.cols:
        cv = _ensure_array(cv, n, ev.device)
        cols.append((_gather(cv, idx), True if cm is True
                     else _sel_array(cm, n, ev.device)[idx]))
    return DeviceBatch(cols, out_sel, batch.extras)


# --------------------------------------------------------------------- #
# Node execution
# --------------------------------------------------------------------- #

def _exec_node(node: D.CopNode, scan_cols: Sequence, row_count,
               ev: Evaluator, aux: Sequence = ()) -> DeviceBatch:
    if isinstance(node, D.TableScan):
        cols = [scan_cols[off] for off in node.col_offsets]
        n = len(cols[0][0]) if cols else 0
        if row_count.dim() == 0:
            sel = torch.arange(n, device=row_count.device) < row_count
        else:
            # a precomputed live-row mask (several flattened shards with
            # per-shard row counts, parallel/spmd.py)
            sel = row_count
        return DeviceBatch(list(cols), sel)

    if isinstance(node, D.Selection):
        batch = _exec_node(node.child, scan_cols, row_count, ev, aux)
        memo: dict = {}
        sel = batch.sel
        n = len(batch.cols[0][0])
        for cond in node.conditions:
            v, m = ev.eval(cond, batch.cols, memo)
            v = _ensure_array(v, n, ev.device)
            if v.dtype != torch.bool:
                v = v != 0
            keep = v if m is True else (v & m)  # NULL -> filtered out
            sel = keep if sel is True else (sel & keep)
        return DeviceBatch(batch.cols, sel, batch.extras)

    if isinstance(node, D.Projection):
        batch = _exec_node(node.child, scan_cols, row_count, ev, aux)
        memo = {}
        n = len(batch.cols[0][0])
        cols = []
        for e in node.exprs:
            v, m = ev.eval(e, batch.cols, memo)
            cols.append((_ensure_array(v, n, ev.device), m))
        return DeviceBatch(cols, batch.sel, batch.extras)

    if isinstance(node, D.Expand):
        # grouping-set replication: every column tiled ``levels`` times,
        # then one column a rollup key (NULL on the levels that roll it
        # up) and the level as the gid column
        batch = _exec_node(node.child, scan_cols, row_count, ev, aux)
        n = len(batch.cols[0][0]) if batch.cols else 0
        L, LV = len(node.keys), node.levels
        memo = {}
        sel = _sel_array(batch.sel, n, ev.device)
        out_cols = []
        for v, m in batch.cols:
            v = _ensure_array(v, n, ev.device)
            out_cols.append((_tile(v, LV), True if m is True
                             else _tile(_sel_array(m, n, ev.device), LV)))
        lvl = torch.arange(LV, dtype=torch.int64,
                           device=ev.device).repeat_interleave(n)
        for j, k in enumerate(node.keys):
            v, m = ev.eval(k, batch.cols, memo)
            v = _tile(_ensure_array(v, n, ev.device), LV)
            keep = (lvl + j) < L       # key j live on levels l < L - j
            mj = keep if m is True \
                else (_tile(_sel_array(m, n, ev.device), LV) & keep)
            out_cols.append((v, mj))
        out_cols.append((lvl, True))
        return DeviceBatch(out_cols, _tile(sel, LV), batch.extras)

    if isinstance(node, D.Limit):
        batch = _exec_node(node.child, scan_cols, row_count, ev, aux)
        n = len(batch.cols[0][0])
        sel = _sel_array(batch.sel, n, ev.device)
        return DeviceBatch(batch.cols,
                           sel & (torch.cumsum(sel, 0) <= node.limit),
                           batch.extras)

    if isinstance(node, D.TopN):
        batch = _exec_node(node.child, scan_cols, row_count, ev, aux)
        return _exec_topn(node, batch, ev)

    if isinstance(node, D.LookupJoin):
        batch = _exec_node(node.child, scan_cols, row_count, ev, aux)
        return _exec_lookup_join(node, batch, ev, aux)

    raise TypeError(node)


def _exec_lookup_join(node: D.LookupJoin, batch: DeviceBatch, ev: Evaluator,
                      aux) -> DeviceBatch:
    """Sorted-lookup join (see dag.LookupJoin).  ``aux`` is a tuple of
    GROUPS, one per chained join level; a group is ``[0] = (sorted build
    keys,)``, ``[1] = (perm,)``, ``[2:]`` = build columns, each ``(value,
    mask | True)``.  Unique inner/left: one ``searchsorted`` and a
    gather; semi/anti: the match counts as a filter (NOT IN drops NULL
    probe keys); m:n inner/left: the expansion of copr/join.py, its true
    size in ``extras["join_total"]``."""
    from .join import gather_expand, match_ranges
    n = len(batch.cols[0][0])
    dev = ev.device
    grp = aux[node.aux_slot]
    sorted_keys = grp[0][0]
    perm = grp[1][0]
    build_cols = grp[2:]
    kv, km = ev.eval(node.probe_key, batch.cols, {})
    kv = as_int64_bits(_ensure_array(kv, n, dev)).to(torch.int64)
    if km is not True:
        km = _sel_array(km, n, dev)

    if node.unique and node.kind in ("inner", "left"):
        idx = torch.searchsorted(sorted_keys, kv)
        # XLA clamps an out-of-range gather index; torch raises
        idxc = idx.clamp(0, sorted_keys.shape[0] - 1)
        matched = sorted_keys[idxc] == kv
        if km is not True:
            matched = matched & km
        brow = perm[idxc]
        out_cols = list(batch.cols)
        for bv, bm in build_cols:
            out_cols.append((_gather(bv, brow), matched if bm is True
                             else (bm[brow] & matched)))
        sel = batch.sel
        if node.kind == "inner":
            sel = matched if sel is True else (sel & matched)
        return DeviceBatch(out_cols, sel, batch.extras)

    sel = _sel_array(batch.sel, n, dev)
    key_ok = sel if km is True else (sel & km)
    lo, _hi, cnt = match_ranges(sorted_keys, sorted_keys.shape[0], kv,
                                key_ok)

    if node.kind in ("semi", "anti"):
        keep = (cnt > 0) if node.kind == "semi" else (cnt == 0)
        if node.kind == "anti" and node.null_aware and km is not True:
            keep = keep & km       # NOT IN: a NULL probe key is filtered
        return DeviceBatch(batch.cols, sel & keep, batch.extras)

    oc = node.out_capacity
    if oc <= 0:
        raise ValueError("a non-unique LookupJoin needs out_capacity")
    probe = [(_ensure_array(v, n, dev),
              m if m is True else _sel_array(m, n, dev))
             for v, m in batch.cols]
    out_cols, out_sel, total = gather_expand(
        probe, sel, key_ok, list(build_cols), perm, lo, cnt, node.kind, oc)
    extras = dict(batch.extras)
    extras["join_total"] = total
    return DeviceBatch(out_cols, out_sel, extras)


__all__ = ["DeviceBatch", "agg_states", "group_keyinfo", "compact"]
