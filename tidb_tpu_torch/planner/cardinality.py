# ported from tidb_tpu/planner/cardinality.py @ e08c981
"""Cardinality estimation: predicate selectivity from table statistics.

Reference analog: pkg/planner/cardinality/ (selectivity.go, row_count_*.go)
with the pseudo-stats fallbacks of pseudoEqualRate/pseudoLessRate/
pseudoBetweenRate.  Works over the CNF condition lists the optimizer
collects at each DataSource.

The port has no statistics yet: ``stats`` is None, and a conjunct's
selectivity is the pseudo rate the JAX package gives a column without
statistics.  Table statistics arrive with ANALYZE (ROADMAP.md, Queue 1
item 5) and raise until then.
"""

from __future__ import annotations

from .. import STATS, unported
from ..expr.ir import Expr
from .ranger import _cmp_parts

# reference: pkg/planner/cardinality/pseudo.go
PSEUDO_LESS_RATE = 3.0
PSEUDO_EQUAL_RATE = 1000.0
PSEUDO_BETWEEN_RATE = 40.0


def cond_selectivity(stats, cond: Expr, ds) -> float:
    """Selectivity in (0, 1] of a single CNF conjunct."""
    if stats is not None:
        raise unported("selectivity from table statistics", STATS)
    p = _cmp_parts(cond)
    if p is None:
        return 0.8           # reference selectionFactor for opaque filters
    op, _ci, _cst = p
    return (1.0 / PSEUDO_EQUAL_RATE if op == "eq"
            else 1.0 / PSEUDO_LESS_RATE)


def conds_selectivity(stats, conds, ds) -> float:
    """Combined selectivity of a CNF list (independence assumption,
    like the reference before its exponential-backoff correlation fix)."""
    s = 1.0
    for c in conds:
        s *= cond_selectivity(stats, c, ds)
    return s


def est_scan_rows(stats, conds, ds) -> float:
    n = ds.table.num_rows
    return n * conds_selectivity(stats, conds, ds)
