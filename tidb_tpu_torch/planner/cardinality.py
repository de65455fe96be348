# ported from tidb_tpu/planner/cardinality.py @ 6298005
"""Cardinality estimation: predicate selectivity from table statistics.

Reference analog: pkg/planner/cardinality/ (selectivity.go, row_count_*.go)
with the pseudo-stats fallbacks of pseudoEqualRate/pseudoLessRate/
pseudoBetweenRate.  Works over the CNF condition lists the optimizer
collects at each DataSource; values are compared in the column's
order-preserving int64 encoding (stats/build.py).
"""

from __future__ import annotations

from typing import Optional

from ..expr.ir import Expr
from ..stats.handle import TableStats, encode_value
from .ranger import _cmp_parts

# reference: pkg/planner/cardinality/pseudo.go
PSEUDO_LESS_RATE = 3.0
PSEUDO_EQUAL_RATE = 1000.0
PSEUDO_BETWEEN_RATE = 40.0


def _col_meta(ds, ci: int):
    """(name, col_type, dictionary) for schema column ci of a DataSource."""
    name = ds.schema.cols[ci].name
    tbl = ds.table
    ti = tbl.col_names.index(name) if name in tbl.col_names else -1
    if ti < 0:
        return name, None, None
    col_type = tbl.col_types[ti]
    dictionary = None
    if col_type.is_string:
        try:
            dictionary = tbl.snapshot().columns[ti].dictionary
        except Exception:
            dictionary = None
    return name, col_type, dictionary


def cond_selectivity(stats: Optional[TableStats], cond: Expr, ds) -> float:
    """Selectivity in (0, 1] of a single CNF conjunct."""
    p = _cmp_parts(cond)
    if p is None:
        return 0.8           # reference selectionFactor for opaque filters
    op, ci, cst = p
    name, col_type, dictionary = _col_meta(ds, ci)
    cs = stats.col(name) if stats is not None else None
    total = cs.count + cs.null_count if cs is not None else 0
    if cs is None or total == 0 or col_type is None:
        return (1.0 / PSEUDO_EQUAL_RATE if op == "eq"
                else 1.0 / PSEUDO_LESS_RATE)
    enc = encode_value(col_type, cst.value, dictionary)
    if enc is None:
        return 1.0 / PSEUDO_LESS_RATE
    if op == "eq":
        rows = cs.equal_rows(enc)
    elif op in ("lt", "le"):
        rows = cs.range_rows(None, False, enc, op == "le")
    else:
        rows = cs.range_rows(enc, op == "ge", None, False)
    return min(max(rows / total, 1e-9), 1.0)


def conds_selectivity(stats: Optional[TableStats], conds, ds) -> float:
    """Combined selectivity of a CNF list (independence assumption,
    like the reference before its exponential-backoff correlation fix)."""
    s = 1.0
    for c in conds:
        s *= cond_selectivity(stats, c, ds)
    return s


def est_scan_rows(stats: Optional[TableStats], conds, ds) -> float:
    n = ds.table.num_rows
    return n * conds_selectivity(stats, conds, ds)
