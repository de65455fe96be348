# ported from tidb_tpu/planner/partition_prune.py @ 70ba47f
"""Partition pruning: conjunctive scan predicates -> surviving partition
ids.

Reference analog: pkg/planner/core/rule/rule_partition_processor.go — the
rule that rewrites a partitioned DataSource into a union of per-partition
scans minus the ones the predicates exclude.  Here partitions are logical
row sets of one columnar snapshot, so "pruning" simply narrows the id
list the CopTask hands to TableInfo.partition_snapshot.

Soundness: predicates are conjunctive; any condition this walker does not
recognize is IGNORED, which can only keep extra partitions — never drop a
live one.
"""

from __future__ import annotations

from typing import Optional

from ..expr.ir import ColumnRef, Const, Func

_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}


def _match_cmp(cond, scan_ix: int):
    """cond as (op, int_value) on the partition column, or None."""
    if not isinstance(cond, Func) or cond.op not in _FLIP:
        return None
    a, b = cond.args if len(cond.args) == 2 else (None, None)
    if isinstance(a, ColumnRef) and a.index == scan_ix \
            and isinstance(b, Const):
        op, v = cond.op, b.value
    elif isinstance(b, ColumnRef) and b.index == scan_ix \
            and isinstance(a, Const):
        op, v = _FLIP[cond.op], a.value
    else:
        return None
    if v is None or isinstance(v, str):
        return None
    try:
        return op, int(v)
    except (TypeError, ValueError):
        return None


def _in_values(cond, scan_ix: int):
    """col IN (c1, c2, ...) -> [ints] (lowered either to an 'in' func or
    an OR-of-eq chain), or None."""
    if not isinstance(cond, Func):
        return None
    if cond.op == "in" and cond.args \
            and isinstance(cond.args[0], ColumnRef) \
            and cond.args[0].index == scan_ix:
        vals = []
        for c in cond.args[1:]:
            if not isinstance(c, Const) or c.value is None \
                    or isinstance(c.value, str):
                return None
            vals.append(int(c.value))
        return vals
    if cond.op == "or":
        vals = []
        for sub in cond.args:
            m = _match_cmp(sub, scan_ix)
            if m is None or m[0] != "eq":
                return None
            vals.append(m[1])
        return vals
    return None


def prune_partitions(spec, scan_ix: int, conds) -> Optional[list]:
    """Surviving partition ids for the conjunction `conds`, or None when
    nothing prunes (all partitions survive)."""
    lo = None   # inclusive lower bound on the partition column
    hi = None   # inclusive upper bound
    eqs: Optional[set] = None
    for cond in conds or ():
        m = _match_cmp(cond, scan_ix)
        if m is not None:
            op, v = m
            if op == "eq":
                eqs = {v} if eqs is None else (eqs & {v})
            elif op == "gt":
                lo = v + 1 if lo is None else max(lo, v + 1)
            elif op == "ge":
                lo = v if lo is None else max(lo, v)
            elif op == "lt":
                hi = v - 1 if hi is None else min(hi, v - 1)
            elif op == "le":
                hi = v if hi is None else min(hi, v)
            continue
        vals = _in_values(cond, scan_ix)
        if vals is not None:
            eqs = set(vals) if eqs is None else (eqs & set(vals))
    if eqs is not None:
        eqs = {v for v in eqs
               if (lo is None or v >= lo) and (hi is None or v <= hi)}
        return sorted({_locate(spec, v) for v in eqs})
    if lo is None and hi is None:
        return None
    n = len(spec.parts)
    if spec.kind == "hash":
        # a narrow interval still prunes hash partitions by enumeration
        if lo is not None and hi is not None and hi - lo < n:
            return sorted({_locate(spec, v) for v in range(lo, hi + 1)})
        return None
    ids = []
    prev = None
    for i, (_, bound) in enumerate(spec.parts):
        p_lo = prev                       # inclusive (None = -inf)
        p_hi = None if bound is None else bound - 1
        prev = bound
        if lo is not None and p_hi is not None and p_hi < lo:
            continue
        if hi is not None and p_lo is not None and p_lo > hi:
            continue
        ids.append(i)
    return ids


def _locate(spec, v: int) -> int:
    if spec.kind == "hash":
        return abs(v) % spec.num
    for i, (_, bound) in enumerate(spec.parts):
        if bound is None or v < bound:
            return i
    return len(spec.parts) - 1


__all__ = ["prune_partitions"]
