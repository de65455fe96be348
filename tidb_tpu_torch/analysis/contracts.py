# ported from tidb_tpu/analysis/contracts.py @ 6298005
"""Plan-contract errors.

The JAX package's module verifies a built plan edge by edge before
tracing (column references against the child's declared schema, casts,
device-dense DAG nodes, capacity shapes, exchange specs) and rejects an
inconsistency with a structured ``PlanContractError``.  The port holds
only the error, which copcost's ``CostError`` derives from.  The
verifiers (``verify_dag``, ``verify_plan``) and the scheduler's
admission and fusion checks come with the slice that calls them: the
scheduler (ROADMAP.md, Queue 1 entry 10) and the analysis gates
(entry 11).
"""

from __future__ import annotations

from typing import Sequence

from ..planner.build import PlanError


class PlanContractError(PlanError):
    """A built plan violates an operator contract.

    Carries the violated rule, the operator path from the plan root, and
    a detail message so tests and EXPLAIN can assert on structure, not
    text."""

    def __init__(self, rule: str, path: Sequence[str], detail: str):
        self.rule = rule
        self.path = tuple(path)
        self.detail = detail
        super().__init__(
            f"plan contract violation [{rule}] at "
            f"{' > '.join(self.path) or '<root>'}: {detail}")


__all__ = ["PlanContractError"]
