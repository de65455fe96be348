# ported from tidb_tpu/copr/exec.py @ a9e9482
"""Coprocessor execution on torch: DAG nodes over one device's batch.

The JAX package traces a DAG into one fused XLA program; the port runs
the same nodes eagerly with torch ops on the device that holds the
batch.  Static shapes carry over: a shard is a fixed-capacity batch of
columns and live rows ride a selection mask ``sel`` instead of being
compacted.

Ported so far: the TableScan, Selection and Projection nodes, and the
partial states of the SCALAR, DENSE and SCATTER aggregations.  Every
grouped reduction goes through ``_reduce``, which is the hand-written
``group_reduce`` kernel on a CUDA tensor and its plain version on a CPU
tensor (copr/cuda/group_reduce.py).  Out-of-range scatter indices raise
in torch where XLA drops them (``mode="drop"``), so a grouped reduction
parks dead and overflowing rows at index ``num_groups``, the sink slot,
which the reduction drops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import torch

from ..expr.compile import Evaluator
from ..ops.sortkeys import sortable_int64
from ..types import dtypes as dt
from . import dag as D
from .cuda.group_reduce import group_reduce

K = dt.TypeKind


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} arrives with a later slice of the port (ROADMAP.md, "
        "Queue 1)")


@dataclass
class DeviceBatch:
    """Columns + live-row selection mask flowing between operators."""
    cols: list  # list[(value, valid)]
    sel: Any    # bool tensor | True


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
    if sel is True:
        return torch.ones((n,), dtype=torch.bool, device=device)
    return sel


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


def _one_agg_state(a: D.AggDesc, av, am, sel, gids, num_groups, n,
                   narrow: bool = False) -> dict:
    """Partial state for one AggDesc over (possibly grouped) rows.

    Layout: count -> {count}; int/decimal sum -> {hi, lo, cnt} (int64
    limbs, exact when recombined on the host); proven-narrow int/decimal
    sum (``agg.narrow_sums``) -> {sum, cnt}, one int64 word; float sum
    -> {sum, cnt}; min -> {min, cnt}; max -> {max, cnt}."""
    av = _ensure_array(av, n, sel.device)
    mask = sel if am is True else (sel & am)
    cnt = _reduce(mask.to(torch.int64), mask, gids, num_groups, "sum")
    if a.func == D.AggFunc.COUNT:
        return {"count": cnt}
    if a.func == D.AggFunc.SUM:
        if a.arg.dtype.kind in (K.FLOAT64, K.FLOAT32):
            return {"sum": _reduce(av.to(torch.float64), mask, gids,
                                   num_groups, "sum"), "cnt": cnt}
        if narrow:
            # valueflow proved the whole table's sum stays inside int64,
            # so one word per group cannot wrap: bit-identical to the
            # limbs (sum(hi) << 32 + sum(lo) == sum(v) in two's complement)
            return {"sum": _reduce(av.to(torch.int64), mask, gids,
                                   num_groups, "sum"), "cnt": cnt}
        # (hi, lo) int64 limbs: per row |hi| < 2^32 and lo < 2^32, so with
        # n < 2^31 rows per batch neither limb sum can wrap int64
        if n >= 2 ** 31:
            raise OverflowError(
                f"shard batch of {n} rows exceeds the 2^31 limb-exact "
                "SUM bound; use more/smaller shards")
        v = av.to(torch.int64)
        hi = _reduce(v >> 32, mask, gids, num_groups, "sum")
        lo = _reduce(v & 0xFFFFFFFF, mask, gids, num_groups, "sum")
        return {"hi": hi, "lo": lo, "cnt": cnt}
    if a.func == D.AggFunc.MIN:
        return {"min": _reduce(av, mask, gids, num_groups, "min"),
                "cnt": cnt}
    if a.func == D.AggFunc.MAX:
        return {"max": _reduce(av, mask, gids, num_groups, "max"),
                "cnt": cnt}
    raise _unported(f"device aggregate {a.func.value}")


def agg_states(agg: D.Aggregation, scan_cols, row_count,
               ev: Evaluator) -> dict:
    """Execute agg.child and build its partial states."""
    batch = _exec_node(agg.child, scan_cols, row_count, ev)
    return _agg_partial_states(agg, batch, ev, {})


def _agg_partial_states(agg: D.Aggregation, batch: DeviceBatch,
                        ev: Evaluator, memo: dict) -> dict:
    """Per-device partial-state dict of an Aggregation node.

    SCALAR/DENSE: a fixed group domain (one group, or the mixed-radix
    dense gid), merged across devices by sum/min/max.  SCATTER: hash,
    multi-pass radix partition, segment reduce (copr/radix.py), merged
    on the host.  Adds ``__rows__`` (COUNT(*) per group) for occupancy;
    a COUNT(*) aggregate reuses it."""
    if agg.strategy == D.GroupStrategy.SCATTER:
        from .radix import agg_scatter_states
        return agg_scatter_states(agg, batch, ev, memo)
    if agg.strategy not in (D.GroupStrategy.SCALAR, D.GroupStrategy.DENSE):
        raise _unported(
            f"the {agg.strategy.value.upper()} aggregation strategy")

    n = len(batch.cols[0][0]) if batch.cols else 0
    sel = _sel_array(batch.sel, n, ev.device)

    gids = None
    num_groups = 1
    if agg.strategy == D.GroupStrategy.DENSE:
        gids = _dense_group_ids(agg, batch, ev, memo)
        num_groups = agg.num_groups

    states: dict[str, Any] = {}
    states["__rows__"] = _reduce(sel.to(torch.int64), sel, gids, num_groups,
                                 "sum")
    for i, a in enumerate(agg.aggs):
        if a.func == D.AggFunc.COUNT and a.arg is None:
            states[f"a{i}"] = {"count": states["__rows__"]}
            continue
        av, am = ev.eval(a.arg, batch.cols, memo)
        states[f"a{i}"] = _one_agg_state(a, av, am, sel, gids, num_groups, n,
                                         narrow=(i in agg.narrow_sums))
    return states


def _dense_group_ids(agg: D.Aggregation, batch: DeviceBatch, ev: Evaluator,
                     memo: dict) -> torch.Tensor:
    """Mixed-radix dense group id from the group-by key codes, int32.

    Key domain [0, size_i); nullable keys get slot 0 for NULL and codes
    shifted by one (domain_sizes already include the NULL slot)."""
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
    return gid


def group_keyinfo(agg: D.Aggregation, batch: DeviceBatch, ev: Evaluator,
                  memo: dict, n: int) -> list:
    """Canonical per-group-key (zeroed value, mask, null flag, order-
    preserving int64 code) tuples.  NULL values are zeroed so all NULLs
    share one group."""
    keyinfo = []
    for e in agg.group_by:
        v, m = ev.eval(e, batch.cols, memo)
        v = _ensure_array(v, n, ev.device)
        if v.dtype == torch.bool:
            v = v.to(torch.int64)
        nullf = (torch.zeros(n, dtype=torch.int32, device=v.device)
                 if m is True else (~m).to(torch.int32))
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        vz = v if m is True else torch.where(m, v, zero)
        code = sortable_int64(vz, e.dtype.is_float,
                              e.dtype.kind == K.UINT64)
        keyinfo.append((vz, m, nullf, code))
    return keyinfo


# --------------------------------------------------------------------- #
# Node execution
# --------------------------------------------------------------------- #

def _exec_node(node: D.CopNode, scan_cols: Sequence, row_count,
               ev: Evaluator) -> DeviceBatch:
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
        batch = _exec_node(node.child, scan_cols, row_count, ev)
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
        return DeviceBatch(batch.cols, sel)

    if isinstance(node, D.Projection):
        batch = _exec_node(node.child, scan_cols, row_count, ev)
        memo = {}
        n = len(batch.cols[0][0])
        cols = []
        for e in node.exprs:
            v, m = ev.eval(e, batch.cols, memo)
            cols.append((_ensure_array(v, n, ev.device), m))
        return DeviceBatch(cols, batch.sel)

    raise _unported(f"the {type(node).__name__} node")


__all__ = ["DeviceBatch", "agg_states", "group_keyinfo"]
